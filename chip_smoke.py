#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # on a machine with one NVIDIA H100

Phases, each fatal on failure (the script exits nonzero and prints no
result):

1. the card: ``nvidia-smi`` name and power limit, torch and device names;
2. the build: every CUDA kernel of the serving and training paths (flash
   attention forward and backward, paged-attention decode, the
   Newton–Schulz chain and matmul, the RWKV6 WKV recurrence and its
   backward, the Mamba selective scan and its backward), compiled from
   the sources in this checkout at once, one ``nvcc`` per kernel package,
   with ``-Xptxas -v`` register/shared-memory use; every flash entry
   function's registers and spill bytes, none of the 18 spilling (forward
   and the backward's two, x f32/bf16 x hd 64/128/256), and the same for
   the 72 paged-decode entry functions (q dtype x page dtype x head dim
   64/128/256 x one query head per kv head, 2..8, or more in head blocks
   of 8), the hd-256 ones printed apart, the 24 WKV entry functions
   (forward, its chunk-saving twin and the backward x dtype x head dim)
   and the 12 selective-scan ones (the same x dtype x state dim);
3. kernel parity: the flash-attention kernel against its plain PyTorch
   version on the card over dtype x causal x window x softcap x MHA/GQA x
   head dim x ragged lengths, plus jamba's attention shape and the serving
   prefill's exact shape; at those two shapes the f32 kernel within
   ``FA_F64_TOL`` of an f64 plain version (the plain f32 version's own
   error printed beside it), and bit-identical on repeat;
4. paged parity: the paged-attention decode kernel against its plain
   version over (q, pages) dtypes (f32/bf16 q over f32, bf16, int8 and fp8
   pages, the 1-byte pages with their f32 scale pages) x head dim x
   MHA, G = 4 and G in {9, 12, 16} x block size x cursors (zero, ragged,
   bs-1, bs, last slot; the softcap at ragged cursors), with permuted pages, garbage past every
   cursor (random 1-byte values under large scales in the quantized
   pools) and an all-trash row, plus the timing shape per page dtype and
   starcoder2-3b's decode shape;
5. the contiguous main path: ``repro_torch.launch.serve.main`` serves
   ``gpt2-12l`` at full width (batch 8, prompt 512, 64 tokens, random
   weights from seed 0) with the launch counters set to 0 just before and
   read just after;
6. the continuous paged main path: ``serve.main`` with ``--continuous
   --paged``, 32 requests (prompts 128-512, budgets 16-64) into 8 slots,
   counters from 0: every request ends at its budget, the pool gets every
   page back, the paged kernel ran 12 times per masked decode step and
   flash attention never; then the same over int8 pages, over fp8 pages
   and with the prefix cache over int8 pages (counters from 0 before
   each; the pool's bytes per token (hd + 4) / (4 hd) of f32, the radix
   tree's pins audited, and the prefix run must hit);
7. card against CPU: the same weights, a greedy B=1 P=128 8-token
   contiguous generation, and three requests through the paged scheduler,
   on the card against the port's plain CPU path fed the same tokens; and
   four requests (the longest prompt twice, the second a full hit with a
   copy-on-write clone) through the int8 prefix-cache scheduler on the
   card and on the CPU, token agreement at least 0.9;
8. one ``torch.profiler`` process (after each reading's control kernel)
   reads the device kernels of the paged, WKV and scan calls that phases
   8, 17 and 21 check; times, with CUDA events: each kernel, its plain version and a PyTorch
   yardstick the port never calls (``scaled_dot_product_attention``, under
   the one backend PyTorch's dispatch picks, named), at the main paths'
   shapes, beside the bound (for the flash kernels both the 3xTF32
   route's and the f32 FMA one); the paged kernel over f32,
   int8 and fp8 pages, with the L2 flushed and warm and back to back with
   its host wrapper, and over f32 pages at starcoder2-3b's decode shape
   (B=8, H=24, KV=2, hd=128: G = 12; SDPA with ``enable_gqa``), after a
   ``torch.profiler`` reading that one call as
   the main path makes it (an int64 cursor) runs exactly one device kernel
   and a check that repeated calls give the same bits (f32 and int8
   pages), and the cluster size it chose at the timing shape;
9. training parity: the Newton–Schulz chain (``ns_fused``) and ``matmul``
   against their plain versions over stack sizes, aspects, ragged dims,
   dtypes and the exact ``gpt2-12l`` shapes (the tied embedding's too),
   ``llama3-0.3b``'s stacks and ``mixtral-0.3b``'s routers (n = 8) and
   expert stacks, plus the orthogonality check; ``matmul``'s symmetric
   route (x @ x.T and G G^T, split-K, exactly symmetric, the same bits
   twice; the embedding's Gram within 1e-5 of an f64 product) and the
   large route's fused updates; the flash-attention backward's dq, dk,
   dv against autograd of the plain version over the forward's grid and
   at the training shape, there also within ``FA_F64_TOL`` (relative) of
   autograd of an f64 plain version, and bit-identical on repeat;
10. the training main path: ``repro_torch.launch.train.main`` trains
   ``gpt2-12l`` at full width from a one-layer source (batch 16, 256
   tokens), expands to 12 layers mid-run and checkpoints, with every
   counter at 0 just before: the expansion step, finite losses, the
   boundary and final checkpoints, and each kernel's launches against
   the count the run implies;
11. serving that checkpoint: ``serve.main --checkpoint`` at 12 layers;
12. card against CPU: one train step at full width (``gpt2-12l`` at depth
   1, ``llama3-0.3b`` and ``mixtral-0.3b`` at depth 2; batch 2, 128
   tokens) from the same params and batch, loss and updated params;
13. training times: the Newton–Schulz chain, matmul (the Gram, G G^T and
   P X) and the flash backward (and the forward with lse, beside SDPA's
   forward) against their plain versions and a PyTorch yardstick, beside
   the bound (for the Newton–Schulz kernels both the f32
   FMA bound and their route's, 3xTF32 on the tensor cores over the
   symmetric half), and the Newton–Schulz share of a training step at 1
   and 12 layers;
14. WKV parity: the RWKV6 WKV kernel against both plain forms (per-step and
   chunked) over head dim x sequence length x batch·heads x zero/random
   initial state x dtype x decays near 0.69, near 0.9975 and near 0 (a
   tenth exactly 0, some below the reference's 1e-30 floor), y and the
   final state, finite; then 3 repeats bit-identical at the main shape;
15. the RWKV6 main path: the ``ServeEngine`` that ``serve.main`` builds
   serves ``rwkv6-7b`` at full width and depth as the CLI runs it (batch
   4, prompt 1024, 32 tokens after a two-token warm-up; random weights
   drawn once on the card from seed 0 for phases 15-17 and 27), every
   counter at 0 just before: one WKV launch per layer per prefill and no other kernel;
16. card against CPU: ``rwkv6-7b`` at full width and depth 2, a greedy
   B=2 P=80 8-token generation on the card against the CPU's prefill
   (chunked WKV form) and decode fed the same tokens;
17. WKV times at the main path's prefill shape, L2 flushed: the kernel with
   f32 and with bf16 r/k/v, each beside its bound, and both plain forms;
   the device kernels of three warm calls (phase 8's ``torch.profiler``
   reading, exactly three: one a call); the kernel's share of the prefill;
18. scan parity: the Mamba selective-scan kernel against both plain forms
   (per-step and chunked; at S 1000 and 1024 the per-step one only at 16
   channels, B 1, and at the main shape) over channels (16, 256, 1000, 8192) x state
   dim (4, 16) x sequence length (1, 63, 64, 1000, 1024) x batch (1, 4) x
   zero/random initial state x f32/bf16 x decays near 1 and large
   dt * A, each with and without the final state, y and the final state,
   and the model's dt and A at a few shapes, plus the main path's exact
   shape; then 3 repeats bit-identical there;
19. the jamba main path: ``jamba-v0.1-52b`` at full width and depth 8 (one
   period; random weights drawn on the card from seed 0),
   ``ServeEngine.generate`` at batch 4, prompt 1024, 32 greedy tokens (a
   warm-up and a timed run, as ``serve.main`` runs them), then one
   ``ModelApi.loss`` forward at batch 4 x 1024, every counter at 0 just
   before: 21 scan and 3 flash launches, no other kernel;
20. card against CPU: the same weights copied to the host, a greedy B=1
   P=128 2-token generation and one B=1 x 128 loss forward;
21. scan times at the main path's prefill shape, L2 flushed: the kernel in
   f32 and bf16, each beside its bound, and the SFU's floor on the busiest
   SM (its exps at 16 a clock at the SM clock ``nvidia-smi`` reads) beside
   the byte bound; the device kernels of three warm calls (one a call);
   both plain forms; the kernel's share of the prefill;
   the flash-attention forward at jamba's attention shape, beside SDPA and
   both bounds;
22. the speculative main path: ``serve.main`` with ``--continuous --paged
   --spec-depth 2 --gamma 4`` over phase 6's traffic, counters from 0:
   every request at its budget, the pool returned, flash attention once per
   draft layer per admission (the draft's B=1 prefill), the paged kernel
   never (speculation rounds replace the masked decode); acceptance, mean
   accepted length and aggregate tokens/s beside phase 6's; the same with
   the prefix cache over int8 pages (16 requests drawn as phase 6 draws
   its 32), which must hit; the paper's draft (a
   random one-layer ``gpt2-12l`` expanded by ``copying_zeroL`` to 3
   (``GPT2_ZEROL_DEPTH``, cut from 12 for time),
   served with its depth-1 truncation): acceptance at least 0.99; and each
   spec stream equal to phase 6's f32 stream, or first different at a
   near-tie (the target's top-2 gap below 1e-4);
23. the paper's ``llama3-0.3b`` (RoPE, GQA 16/8, untied head) trained
   with the launcher's defaults at full width from a one-layer source to
   24 layers at τ = 0.5 of 12 steps: the expansion, finite losses, the
   checkpoints, flash forward and backward at G = 2, ``ns_fused`` and
   ``matmul`` launches against the count the run implies (the untied head
   on the large route beside the embedding), tokens/s at 1 and 24 layers;
24. ``qwen3-0.3b`` (qk-norm, tied) at full width over phase 6's traffic on
   paged KV, f32 and then int8 pages (the paged kernel at G = 2, hd 64),
   at 4 layers (``SERVE_CUT``, reduced from 24); then the paper's draft:
   a one-layer ``qwen3-0.3b`` expanded by ``copying_zeroL`` to 3
   (``QWEN3_ZEROL_DEPTH``, reduced from 24), served with its depth-1
   truncation, acceptance at least 0.99;
25. ``mixtral-0.3b``: 6 training steps through one expansion (expert
   stacks and routers through the Newton–Schulz kernel), then phase 6's
   traffic on paged KV at 2 layers (reduced from 24);
26. ``starcoder2-3b`` at full width, 2 of its 30 layers (reduced) over
   phase 6's traffic on paged KV: the paged kernel at G = 12, hd 128; then
   card against CPU at depth 2 (the B=1 P=128 generation, whose prefill
   runs flash at G = 12, and three paged requests);
27. ``rwkv6-7b`` at full width and 2 layers (``RWKV_CONT_DEPTH``, cut
   from 32 for time) in continuous serving (run right after phase 17, on
   the first layers of phase 15's weights), over phase 6's traffic
   through ``ServeEngine`` and ``ContinuousScheduler`` as ``serve.main
   --continuous --paged`` builds and warms them (every request at its
   budget, the pool returned, aggregate tokens/s and TTFT p50/p95), then
   on the same weights the
   prefix cache over the shared-prefix traffic with its last 8 requests
   sent again (it must hit; each repeat's stream equals its first run's),
   ``--spec-depth 2 --gamma 4`` over the first 8 requests (acceptance,
   mean accepted length, each stream equal to the paged run's or first
   different at a near-tie) and
   the paper's draft, a one-layer ``rwkv6-7b`` expanded by
   ``copying_zeroL`` to 4 layers and drafted at depth 1 (acceptance at
   least 0.99); every WKV launch count derived from the requests with this
   script's own binary decomposition (plus the snapshot edge of the prefix
   cache): one a layer per prefill chunk, 2 per draft prefill;
28. jamba at full width and depth 8 on phase 19's weights (run right after
   phase 21) over the first 8 of phase 6's requests through
   ``ContinuousScheduler``: paged
   over f32 and then int8 pages (the scan 7 times a prefill chunk, the
   paged kernel once a masked decode step, flash never), contiguous (flash
   once and the scan 7 times an admission) and with the zero-layer draft;
   tokens/s, TTFT and peak memory of each;
29. card against CPU through the port's plain CPU serving path fed the
   card's tokens over the same chunks: jamba at depth 8, three short paged
   requests of 2 tokens (run after phase 28), and ``rwkv6-7b`` at full width and depth
   2, three paged requests and a prefix hit (which also equals its cold
   run), tokens equal where the CPU's top-2 margin allows;
30. fault tolerance in serving over phase 6's traffic (``gpt2-12l``, 32
   requests into 8 slots, pages of 16): ``serve.main --faults
   storm:0.02:0 --retries 2`` (every request ends with one finish reason,
   each completed stream equal to phase 6's f32 stream and each failed
   one equal to its first tokens, or first different at a near-tie); the
   prefix cache over int8 pages with a tape that faults each serving site
   once (pool.evict aside: full provisioning never evicts), every stream
   held to phase 6's prefix-cache run; ``--spec-depth 2 --gamma 4`` with
   ``engine.draft_prefill:1``, held to phase 22's streams;
   ``sched.iter:60:crash`` under ``snapshot_every=1`` through
   ``ContinuousScheduler``, the snapshot restored on a fresh engine over
   the same weights (the re-prefill's share of the restore printed), the
   merged streams held to phase 6's; ``--queue-limit 8 --deadline-s
   0.001`` with every request arrived before the first iteration: 24 shed
   and 8 past their deadline, as derived; ``rwkv6-7b`` at full width and
   depth 2 (6 requests) crashed and restored, the WKV kernel running the
   re-prefill from fresh carries, chunk counts derived from the snapshot;
   paged, flash and WKV launches derived from the successful calls;
31. fault tolerance in training, phase 13's run (``gpt2-12l``, batch 16
   x 256, Muon-NSGD, WSD, 1 -> 12 layers at step 6 of 12) through
   ``train.loop.train`` with a checkpoint every 3 steps: the clean run;
   a ``train.iter:8`` crash and a ``ckpt.write:2`` crash in the
   asynchronous writer, each resumed bit-identical to the clean run
   (losses, params, momenta);
   ``nan:8`` under ``skip`` with a ``train.step`` fault retried (the bad
   step leaves params and momenta bit for bit, earlier losses equal the
   clean run's); a hang deadline at half the 12-layer step time (hangs
   at exactly the steps past it, the run bit-identical to the clean one);
   the sentinel step's and a retry's time, and the asynchronous save
   against the synchronous one around a 12-layer step.  Each run's
   kernel launches are derived from the steps it ran;
32. the hd-256 kernels (run right after phase 4): flash forward and
   backward at gemma2-9b's prefill shape (B 1, S 5120, 16/8 heads, window
   4096, softcap 50, q scaled so that the logits reach the cap) and
   gemma3-12b's (B 2, S 2048, window 1024), f32 and bf16, entry by entry
   against their plain versions (bf16 within 2^-8 of each entry plus
   2^-10 of its sum of magnitudes), a rule that must reject the plain
   version without the softcap and without the window; finite and
   bit-identical on repeat, timed beside SDPA's best call (causal,
   without the window and softcap) and the card's bound (bf16 at its
   bf16 peak); the paged decode at G = 2, hd 256,
   softcap 50 and 0, f32/bf16 q over f32, bf16, int8 and fp8 pages at
   contexts past 4096, held by phase 4's rule and timed per page dtype;
33. ``gemma2-9b`` at full width and 4 layers (``GEMMA2_SERVE_DEPTH``,
   cut from 42 for time; drawn on the card) in paged
   continuous serving, f32: 8 requests into 4 slots,
   prompts 4160-6144 (past the 4096 window), 32 tokens, pages of 16,
   counters from 0: the paged kernel once per global layer per decode
   step, flash never, the pool returned; each stream held to solo
   ``generate`` (flash prefill at hd 256 with the window and softcap)
   under phase 22's near-tie rule; then card against CPU at depth 2;
34. ``gemma3-12b`` at full width and 12 layers (two 5:1 periods; cut from
   48 for time), 16 requests into 8 slots, prompts of 1280-2000 tokens
   over a 1280-token shared prefix, 32 tokens: paged over f32 and int8
   pages (agreement at least 0.9), the prefix cache (hits restore the
   bare prefix's ring snapshot) and ``--spec-depth 6 --gamma 4`` (flash
   once per draft layer per admission), streams held to the f32 run's
   under the near-tie rule, launches derived;
35. training: ``gemma2-9b`` at full width through ``ProgressiveTrainer``,
   2 -> 4 layers, one 5120-token sequence a step, AdamW, remat at its
   ``REMAT_DEFAULTS`` policy (the windowed, softcapped backward at hd
   256; flash forward twice a layer a step under remat), peak memory; and
   ``gpt2-12l`` at phase 13's settings for 6 steps under AdamW, NSGD and
   SGD, then AdamW under remat 'nothing' and 'dots', whose losses and
   params are bit for bit those of remat off and whose own peak memory
   is below remat off's;
36. the flash kernels at S_k != S_q (run right after phase 32): whisper's
   cross-attention (B 4, 448 queries over 1500 frames, 8 heads of 64),
   the encoder's S = 1500 self-attention and a GQA case (300 queries over
   1000 keys, 8/2 heads of 128), non-causal, f32 and bf16, forward and
   backward held entry by entry to the plain version by phase 32's rule,
   finite and bit-identical on repeat, timed beside SDPA's best
   non-causal call and the bound; causal attention at S_k != S_q refused;
37. ``deepseekv3-0.3b`` (MLA) at full width and 4 of its 24 layers
   (``DSV3_DEPTH``, cut for time): ``launch/train.py`` 1 -> 4 layers at
   step 3 of 6 (flash at hd 64, G = 2 on the up-projected K/V;
   Newton–Schulz over the latent projections and the expert stacks), the
   4-layer checkpoint served over latent pages (f32, int8, the prefix
   cache; no kernel launches: the latent read is plain, as in the
   reference) held to solo ``generate`` under the near-tie rule, MoE
   routed dropless for it; the run's 1-layer checkpoint expanded by
   ``copying_zeroL`` as the draft (acceptance >= 0.99); card against CPU
   at depth 2 (a generation, int8 prefix-cache serving, a train step);
38. ``qwen2-vl-2b`` (M-RoPE) at full width and 4 of its 28 layers
   (``QWEN2VL_DEPTH``, cut for time): text-only paged
   serving over f32 and int8 pages (the paged kernel at G = 6, hd 128)
   held to solo ``generate``, one training step with 256 frontend embeds
   prepended, card against CPU at depth 2;
39. ``whisper-base`` at full size: Muon steps on batches of frames (the
   flash kernels on the encoder's S = 1500, the decoder's causal
   self-attention and the cross-attention at S_k = 1500), 2 -> 6 decoder
   layers with the encoder scaled, greedy decoding through
   ``encdec_decode_step`` equal to the teacher-forced argmax;
40. the paper's expansion-timing recipe (run last): ``core/recipe.
   calibrate_tau`` on ``gpt2-12l`` at full width through
   ``train.loop.train``, two probes of 40 steps at the launcher's batch
   (16 x 256, Muon-NSGD, WSD): the probe steps, the ``MixingReport``, τ and
   the production plan, the probes' launches against the count they
   imply; then ``examples/quickstart_torch.py``'s savings line for it;
41. the WKV backward (run right after phase 27, on phase 15's weights):
   ``wkv_bwd.cu`` through ``wkv``'s autograd Function against the plain
   reverse recurrence (``ref.wkv_bwd_ref``) over head dim (16-128) x S
   (1, 15, 16, 17, 63, 64, 100, 1024) x decays near 0.69, 0.9975 and 0 x
   zero/random S_0 x f32/bf16, every gradient entry by entry and finite,
   bit-identical on repeat at the serving shape; timed there (L2 flushed)
   beside its bound and the plain version; one loss and backward of
   ``rwkv6-7b`` at depth 1 on the card against the CPU (the loss and every
   gradient); then ``rwkv6-7b`` at full width trained 2 -> 4 of its 32
   layers (``copying_stack``) through the trainer, Muon-NSGD, 4 x 1024
   tokens a step, every launch derived;
42. the scan backward (run right after phase 29's jamba half, on phase
   19's weights): ``selective_scan_bwd.cu`` through both entry points
   (h0 and the final state's gradient) against
   ``ref.selective_scan_bwd_ref`` over N (4, 16) x S (1, 15, 64, 100,
   1024) x d (16, 200, 1000) x decays near 1 and large dt * A x f32/bf16,
   bit-identical on repeat at jamba's shape; timed there beside its bound
   and SFU floor; one loss and backward at depth 1 (jamba's dense Mamba
   layer) against the CPU; then jamba's first two layers (dense Mamba,
   Mamba + the 16-expert MoE; 3.57 B params) trained 3 steps under NSGD;
43. the mesh: ``gpt2-12l`` at full width, 1 -> 2 layers at step 4
   of 8, 16 x 256, Muon-NSGD under WSD, through the trainer on a
   ``single`` mesh (one NCCL rank) against ``mesh=None`` (losses and
   final params bit for bit), then on two ranks that share the card over
   gloo (``launch.mesh.spawn``, one spawn running ``tests/mesh_runs.py``'
   scenarios): 2x1 (FSDP/DP) and 1x2 (TP, the flash kernels on 6 heads a
   rank) each step within 1e-4 of the single mesh with the same
   expansion step and each rank's flash, ``ns_fused`` and ``matmul``
   launches derived; the flash kernel at the 6-head shape against its
   plain version; the 1x2 run's checkpoint restored under 2x1 and
   ``mesh=None`` bit for bit, the next step's loss of each; the grown
   checkpoint served greedily on 2x1 and 1x2 against solo ``generate``;
   then (e) continuous serving of that checkpoint on the two ranks, 8
   requests (prompts of 32-160 tokens, half opening with one shared
   64-token prefix; 16-32 new tokens, greedy) into 4 slots over pages of
   16: at 2x1 over f32 pages, over int8 pages with the prefix cache and
   with speculation (``spec_depth`` 1, ``gamma`` 4), at 1x2 over f32
   pages and with speculation, each against ``mesh=None``'s run of the
   same traffic in this process (streams under phase 22's near-tie rule,
   prefix hits, skipped tokens, acceptance, every rank alike), each
   rank's launches those of ``mesh=None``'s (the paged kernel on the
   rank's rows or heads), the radix tree's int8 pages and scales hashing
   alike on both 2x1 ranks, and the paged kernel at the 1x2 local shape
   (6 heads of 64, f32 and int8 pages) against its plain version; then,
   in the same spawn, (f) that traffic over f32 pages under a seeded
   storm (``storm:0.05:0``, snapshots at every boundary) at 2x1 and 1x2,
   every rank's finish reasons, retries, site hits and paged launches
   ``mesh=None``'s under the same storm, its streams (near-tie rule) the
   clean run's; (g) a ``sched.iter`` crash at 2x1, over f32 pages and
   with speculation, rank 0's snapshot restored on a fresh scheduler on
   each rank to the clean streams (paged launches in the restore's
   decode, flash in its draft prefills); (h) the placement knobs:
   ``fsdp=True`` at 2x1 and ``layout="fsdp"`` at 1x2, each serving
   ``generate`` (against solo) and the f32 paged run (against
   ``mesh=None``'s), with each rank's resident parameter bytes beside
   ``mesh=None``'s;

44. expert parallelism and tensor-parallel Mamba, RWKV6 and MLA (run
   last): on two ranks that share the card over gloo at 1x2, against
   ``mesh=None`` in this process (weights drawn on the card from seed 0
   in every process): jamba's first two layers at full width (Mamba, and
   Mamba + the 16-expert MoE; 8 experts and 4096 of 8192 channels a rank)
   2 Muon-NSGD steps of 4 x 1024 and greedy ``generate`` (4 prompts of
   64, 8 tokens; near-tie rule); ``rwkv6-7b`` at 2 layers (32 of 64 heads
   a rank) 2 steps and ``generate`` (tokens equal, logits 1e-4);
   ``deepseekv3-0.3b`` at 2 layers (MLA on 4 of 8 heads, 4 of 8 experts,
   half the shared expert's d_ff) 3 steps of 16 x 256, then 8 of phase
   43's requests served dropless over latent pages (near-tie rule):
   losses within 1e-4 of ``mesh=None``'s, every rank alike, each rank's
   launches derived (a rank's Newton-Schulz GEMMs on its experts), each
   rank's peak beside ``mesh=None``'s and the gather path's (reckoned on
   the meta device); (e) ``rwkv6-7b``'s 4 of those requests over f32
   pages crashed at a ``sched.iter`` boundary and restored from rank 0's
   snapshot on each rank (WKV on the rank's 32 heads in the re-prefill),
   its WKV launches a rank ``mesh=None``'s crash-restore's, its streams
   ``mesh=None``'s clean run's (near-tie rule); then the scan and WKV
   forward and backward (WKV forward also at the restore's B=1 chunk),
   ``ns_fused`` and the flash forward and backward at their rank-local
   shapes against their plain versions;
45. the roofline (run right after phase 13): ``gpt2-12l``'s 12-layer
   training step at the launcher's shape (16 x 256, f32, Muon-NSGD,
   ``mesh=None``) counted on meta by ``roofline.torch_cost.StepCounter``
   (FLOPs by unit, bytes, kernel bytes, the predicted peak: arguments +
   the counter's temp), then on the card under the counter after a
   warm-up (FLOPs equal to meta's, each kernel region's entries equal to
   its launch counter, bytes within 1%), then timed (5 steps after 2
   warm-ups, CUDA events: median, spread, achieved FLOP/s, ``mfu``,
   max_memory_allocated within 15% of the predicted peak); last, one
   production cell of the dry run (``starcoder2-3b`` x ``train_4k`` on
   16x16) through its CLI in a child process and ``roofline.report``.
   Every bound this script prints is a work function's of
   ``roofline.torch_cost`` at the card's peaks (``configs.base.HW_*``);
46. attention on a rank's query heads over one KV head, and the
   tensor-parallel encoder-decoder (run after phase 44): four ranks that
   share the card over gloo at 1x4 hold ``starcoder2-3b`` at full width
   and 2 of its 30 layers (6 of 24 query heads and 1 of 2 KV heads a
   rank) against ``mesh=None`` in this process: 2 AdamW steps of 4 x 512
   (losses within 1e-4, launches a rank ``mesh=None``'s), greedy
   ``generate`` (4 prompts of 64, 8 tokens) against solo ``generate``,
   and those prompts served continuously into 2 slots over f32 pages
   (streams against solo ``generate``) and int8 pages (against
   ``mesh=None``'s), near-tie rule, paged launches a rank
   ``mesh=None``'s, a rank's pool half of ``mesh=None``'s; at once two
   ranks at 1x2 hold ``whisper-base`` (6 + 6 layers; 4 of 8 heads, half
   the MLPs' d_ff a rank): 2 Muon-NSGD steps on batches of 2 x 64 tokens
   over 1500 frames (losses within 1e-4), greedy decoding of 8 tokens
   through ``encdec_decode_step`` against ``mesh=None``'s; then flash
   forward and backward at a 1x4 rank's (4, 512, 6 heads over 1, hd 128)
   and at whisper's cross-attention on 4 heads (64 queries over 1500
   frames), and the paged decode at G = 6 over f32 and int8 pages,
   against their plain versions, flash and paged timed beside their
   bounds, plain versions and SDPA.

``--only 36,...,46`` runs the card, the build and the named phases of
36-46 alone (41 and 42 on weights drawn on the card for them), prints
their readings and no closing line.

Every main path (5, 6, 10, 11, 15, 19, 22-28, 30, 31, 33-35, 37-46) starts
with every kernel's launch counter at 0 and checks every counter after
it, the kernels it must not launch included.  Each phase prints its
seconds.

The line before the last is the kernels' JSON record (the paged row's
launches and times at G = 12, starcoder2-3b's, its gpt2-12l ones under
``gpt2_12l``; the hd-256 readings and launches of the flash, backward and
paged rows under ``hd_256``); the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the kernel against its plain version on the same inputs.
# f32: both sum in f32 in another order (~1e-6 seen in practice);
# bf16: the output is rounded to bf16 (a relative step of 2^-8) on both
# sides, after sums in another order.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Card against CPU, each generated step's logits: cuBLAS, MKL and the
# kernel sum in other orders through 12 layers of float32 (TF32 off).
LOGIT_TOL = 1e-3

# The card's peaks (``repro_torch.configs.base.HW_*``) and each kernel's
# work (``repro_torch.roofline.torch_cost``: FLOPs by unit, bytes with each
# input read once and each output written once) give every bound below.

MAIN_ARGV = ["--arch", "gpt2-12l", "--batch", "8", "--prompt-len", "512",
             "--gen", "64", "--seed", "0"]
PAGED_ARGV = ["--arch", "gpt2-12l", "--continuous", "--paged", "--max-batch",
              "8", "--requests", "32", "--prompt-len", "512", "--gen", "64",
              "--block-size", "16", "--rate", "1000", "--seed", "0"]
MAIN_SHAPE = (8, 512, 12, 64)       # (B, S, H, hd) of the main path's prefill

# The training main path: the launcher's defaults (batch 16 of 256 tokens,
# a one-layer source, Muon-NSGD under WSD) with τ at half of 12 steps.
TRAIN_STEPS, TRAIN_TAU = 12, 0.5
TRAIN_ARGV = ["--arch", "gpt2-12l", "--source-layers", "1", "--tau",
              str(TRAIN_TAU), "--steps", str(TRAIN_STEPS), "--batch", "16",
              "--seq-len", "256", "--init", "random", "--seed", "0"]
TRAIN_SHAPE = (16, 256, 12, 64)     # (B, S, H, hd) of its attention
# Newton–Schulz against its plain version, relative to the largest output
# entry: f32 sums in another order (cuBLAS or CPU against the kernel's
# k-order), which five quintic steps amplify along small singular
# directions (~1e-5 seen at the gpt2 shapes); with bf16 input and output
# the result is rounded to bf16 (a relative step of 2^-8) on both sides.
NS_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The embedding's Gram against an f64 product, relative to its largest
# entry.  The tensor cores truncate as they accumulate: over 50304 terms of
# one sign (the diagonal) that biases a running sum by ~1e-4, within
# NS_TOL; summing each k-slice afresh and adding it in IEEE f32 keeps the
# kernel near cuBLAS's f32 error (~1e-6).  The limit lies between the two.
GRAM_F64_TOL = 1e-5
# The flash kernels' f32 results against an f64 plain version: the forward
# as max abs error, the backward's dq, dk, dv relative to max(1, the
# largest gradient entry).  Their 3xTF32 products keep them about as close
# to f64 as the plain f32 version is (~1e-6); one TF32 pass is ~7e-4 off
# (the CPU emulation in tests/test_torch_flash_attention.py), past TOL.
FA_F64_TOL = 1e-5
# The backward against autograd of the plain version, relative to
# max(1, the largest gradient entry): f32 sums in another order; bf16
# gradients are rounded to bf16 once on each side (2^-8 relative).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# One train step, card against CPU: the loss (about 11 at random init) to
# 1e-4, every updated param to 1e-5 absolute (the update is lr = 0.01
# times an orthogonalized or normalized direction of O(0.1) entries, so a
# 1e-3 relative difference of that direction moves a weight by ~1e-6).
TRAIN_LOSS_TOL, TRAIN_PARAM_TOL = 1e-4, 1e-5

# RWKV6 serving at full width and depth: 4 prompts of 1024 tokens, 32
# greedy tokens each.  serve.main runs a warm-up and a timed generation,
# so the prefill runs twice.
RWKV_ARGV = ["--arch", "rwkv6-7b", "--batch", "4", "--prompt-len", "1024",
             "--gen", "32", "--seed", "0"]
RWKV_SHAPE = (4, 1024, 64, 64)      # (B, S, H, hd) of its WKV launches
# The WKV kernel against its plain forms, relative to max(1, max|y|) and
# max(1, max|state|): f32 sums in other orders, to the reference's own bar
# for its chunked kernel against its per-step form; with bf16 r/k/v both
# sides round y to bf16 once (2^-8 relative), the state stays f32.
WKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# jamba at full width and depth 8 (one period of the layer pattern; full
# depth does not fit one card): 4 prompts of 1024 tokens, 32 greedy tokens
# each, then one loss forward at 4 x 1024.
JAMBA_DEPTH, JAMBA_B, JAMBA_P, JAMBA_G = 8, 4, 1024, 32
JAMBA_SCAN_SHAPE = (4, 1024, 8192, 16)   # (B, S, d_inner, N) of its scans
# The scan kernel against its plain forms, relative to max(1, max|y|) and
# max(1, max|h|): f32 sums and decay products in other orders, the
# kernel's exp on the SFU (2 ulp), to the reference's own 1e-4 bar for its
# kernel; with bf16 inputs both sides round y to bf16 once (2^-8
# relative), the state stays f32.
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# jamba card against CPU: logits relative to max(1, max|logit|), the loss
# relative to itself (f32 through 8 layers; the CPU takes the chunked
# scan, the card its kernel).
JAMBA_LOGIT_TOL, JAMBA_LOSS_TOL = 1e-4, 1e-5
# Cut to make room for phases 43-44: every CPU decode step of jamba at
# depth 8 reads the whole 51 GB, so phase 20's greedy generation keeps 2
# of its 8 tokens (the prefill and one decode step) and phase 29's jamba
# requests 2 of their 4; phase 28 serves the first 8 of phase 6's 32
# requests (each request runs the same steps, and the counts are derived
# from the requests served).
JAMBA_CPU_TOKENS, JAMBA_PAGED_CPU_TOKENS, JAMBA_CONT_REQUESTS = 2, 2, 8

# Each kernel wrapper's launch counter (``repro_torch.kernels.
# LAUNCH_COUNTERS``: kernel -> (ops package, attribute)), set in main.
COUNTERS = {}
OPS = {}                            # ops module key -> module, set in main


_T0 = time.perf_counter()


def _mark(phase: str):
    """The seconds since the script started, before ``phase``."""
    print(f"[{time.perf_counter() - _T0:.1f} s] phase {phase}")


def zero_counts():
    from repro_torch.kernels import zero_launch_counts
    zero_launch_counts()


def read_counts() -> dict:
    from repro_torch.kernels import launch_counts
    return launch_counts()


def expect_counts(phase: str, **want):
    """Every counter equals ``want``, 0 where not named."""
    got = read_counts()
    full = {name: want.get(name, 0) for name in COUNTERS}
    if got != full:
        _fail(f"{phase}: launches {got}, expected {full}")
    return got


def _fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _inputs(B, S, H, KV, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, S, n, hd), generator=g, device="cuda",
                             dtype=torch.float32).to(dtype)
                 for n in (H, KV, KV))


def attention_f64(q, k, v, causal=True):
    """Causal attention in f64 on (B, S, heads, hd) inputs, GQA by repeated
    K/V: the plain version the f64 checks hold the kernels to."""
    q, k, v = (t.double() for t in (q, k, v))
    G = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(G, dim=2) for t in (k, v))
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                     device=q.device).triu(1), -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def fa_f64_and_repeats(fa_ops) -> dict:
    """The f32 forward at the serving prefill's and jamba's shapes against
    ``attention_f64`` (max abs, within ``FA_F64_TOL``), beside the plain
    f32 version's own error; and two launches on the same inputs give the
    same bits.  Returns the kernel's f64 error per shape."""
    errs = {}
    for name, (B, S, H, KV, hd) in (("gpt2 prefill", MAIN_SHAPE[:3] + (
            MAIN_SHAPE[2], MAIN_SHAPE[3])), ("jamba", (JAMBA_B, JAMBA_P, 32, 8,
                                                       128))):
        q, k, v = _inputs(B, S, H, KV, hd, torch.float32, 31)
        got = fa_ops.flash_attention(q, k, v, force="kernel")
        again = fa_ops.flash_attention(q, k, v, force="kernel")
        plain = fa_ops.flash_attention(q, k, v, force="ref")
        want = attention_f64(q, k, v)
        err = (got.double() - want).abs().max().item()
        plain_err = (plain.double() - want).abs().max().item()
        same = torch.equal(got, again)
        print(f"fa f64 at {name} B{B} S{S} H{H}/{KV} hd{hd}: kernel {err:.2e}, "
              f"plain f32 {plain_err:.2e} (tol {FA_F64_TOL:.0e}); repeat "
              f"bit-identical {same}")
        if err > FA_F64_TOL or not same:
            _fail(f"flash forward at {name}: f64 error {err:.2e} (tol "
                  f"{FA_F64_TOL:.0e}), repeat equal {same}")
        errs[name] = err
        del q, k, v, got, again, plain, want
    return errs


def parity(fa_ops) -> float:
    """Kernel against plain version over the grid; returns the max abs
    error at the main path's shape."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for H, KV in ((12, 12), (8, 2)):
                for S in (77, 512, 1000):
                    for causal in (True, False):
                        for window in (0, 64):
                            for cap in (0.0, 30.0):
                                cases.append((2, S, H, KV, hd, dtype, causal,
                                              window, cap))
    # jamba's attention layer: GQA 32/8 at head dim 128, its prefill batch.
    cases.append((JAMBA_B, JAMBA_P, 32, 8, 128, torch.float32, True, 0, 0.0))
    cases.append(MAIN_SHAPE[:3] + (MAIN_SHAPE[2], MAIN_SHAPE[3],
                                   torch.float32, True, 0, 0.0))
    bad = 0
    err = 0.0
    for n, (B, S, H, KV, hd, dtype, causal, window, cap) in enumerate(cases):
        q, k, v = _inputs(B, S, H, KV, hd, dtype, n)
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        got = fa_ops.flash_attention(q, k, v, force="kernel", **kw)
        want = fa_ops.flash_attention(q, k, v, force="ref", **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= TOL[dtype] and bool(torch.isfinite(got).all())
        bad += not ok
        print(f"  fa {str(dtype)[6:]:8s} B{B} S{S:<4d} H{H}/{KV} hd{hd} "
              f"c{int(causal)} w{window:<2d} cap{cap:<4g} err={err:.2e} "
              f"tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
    if bad:
        _fail(f"{bad} of {len(cases)} flash-attention parity cases")
    print(f"parity: {len(cases)} cases within tolerance")
    return err                                   # the last case: MAIN_SHAPE


# The paged decode's timing shape: the continuous main path's batch and
# widths at its longest context (prompt 512 + 64 generated = 576 tokens).
PAGED_SHAPE = dict(B=8, H=12, KV=12, hd=64, bs=16, NB=37, cursor=575)
# starcoder2-3b's decode at the same batch and cursors: 24 query heads over
# 2 kv heads (G = 12, head blocks of 8 in the kernel), hd 128.
G12_SHAPE = dict(B=8, H=24, KV=2, hd=128, bs=16, NB=37, cursor=575)
GARBAGE = 1e3            # scale of the finite garbage past every cursor


def _garbage_bytes(shape, dtype, g):
    """Random finite 1-byte values of ``dtype``: every int8, every fp8 e4m3
    code but the two NaNs (0x7F and 0xFF become ±448)."""
    raw = torch.randint(0, 256, shape, generator=g, device="cuda",
                        dtype=torch.int32)
    if dtype == torch.int8:
        return (raw - 128).to(torch.int8)
    raw = raw.to(torch.uint8)
    raw = torch.where((raw & 0x7F) == 0x7F, raw ^ 1, raw)
    return raw.view(dtype)


def paged_case(B, H, KV, hd, bs, NB, q_dtype, kv_dtype, cursors, seed,
               trash_row=True):
    """A pool with permuted physical pages, spare pages and every slot past
    a row's cursor filled with large finite garbage; with ``trash_row`` the
    last row's table is all trash (the pool's last page, garbage too).
    Quantized pools (int8/fp8) hold random 1-byte garbage with scales of
    ``GARBAGE`` scale, and each live slot its N(0, 1) values quantized per
    head.  Returns (q, k_pages, v_pages, table int32, index int32,
    k_scales, v_scales), the scales None for float pools."""
    from repro_torch.core import quant
    g = torch.Generator(device="cuda").manual_seed(seed)
    NP = B * NB + 3 + 1                         # rows' pages, spares, trash
    trash = NP - 1
    quantized = quant.is_quantized(kv_dtype)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    q = randn(B, 1, H, hd).to(q_dtype)
    scales = (None, None)
    if quantized:
        kp, vp = (_garbage_bytes((NP, bs, KV, hd), kv_dtype, g)
                  for _ in range(2))
        scales = tuple(GARBAGE * (1 + torch.rand(
            (NP, bs, KV, 1), generator=g, device="cuda")) for _ in range(2))
    else:
        kp, vp = (GARBAGE * randn(NP, bs, KV, hd) for _ in range(2))
    perm = torch.randperm(NP - 1, generator=g, device="cuda")[:B * NB]
    table = perm.reshape(B, NB).to(torch.int32)
    if trash_row:
        table[-1] = trash
    index = torch.as_tensor(cursors, dtype=torch.int32, device="cuda")
    slot = torch.arange(NB * bs, device="cuda")
    for b in range(B - 1 if trash_row else B):  # live slots get N(0, 1)
        live = slot[slot <= int(index[b])]
        pages, offs = table[b, live // bs].long(), live % bs
        for pool, sc in zip((kp, vp), scales):
            x = randn(len(live), KV, hd)
            if quantized:
                xq, xs = quant.quantize(x, axis=-1, dtype=kv_dtype)
                pool[pages, offs] = xq
                sc[pages, offs] = xs
            else:
                pool[pages, offs] = x
    if not quantized:
        kp, vp = kp.to(kv_dtype), vp.to(kv_dtype)
    return (q, kp, vp, table, index) + scales


def paged_parity(pa_ops) -> dict:
    """Paged kernel against its plain version over the grid, float pages
    and int8/fp8 pages with their scales; returns the max abs error at the
    timing shape per page dtype.  The all-trash row must be finite; every
    other row must agree within the tolerance.  Both sides read bf16 pages
    exactly into f32 and dequantize 1-byte pages by the same f32 product,
    so only sum orders differ: with f32 q, float pages are held to
    ``TOL[f32]`` absolute, quantized pages to ``TOL[f32]`` relative to
    peak = max(1, max|plain|).  With bf16 q the plain version rounds the
    scores and the probabilities to bf16 where the kernel keeps them in
    f32 (a score of 10 moves by 2^-5, its probability by 3%), so the
    kernel is held instead to the plain version run on f32 copies of the
    same values (bf16 -> f32 is exact), i.e. to its own arithmetic and
    one bf16 rounding of each output: element by element within
    2^-8 |plain| + ``TOL[f32]`` peak."""
    f32, bf16 = torch.float32, torch.bfloat16
    i8, f8 = torch.int8, torch.float8_e4m3fn
    cases = []
    for q_dt, kv_dt in ((f32, f32), (bf16, bf16), (f32, bf16), (f32, i8),
                        (bf16, i8), (f32, f8), (bf16, f8)):
        for hd in (64, 128):
            # MHA, G = 4, and G > 8 (head blocks of 8; starcoder2's 12)
            for H, KV in ((12, 12), (8, 2), (18, 2), (24, 2), (32, 2)):
                for bs in (16, 64) if H // KV <= 8 else (16,):
                    # the softcap at ragged cursors alone (its other cursor
                    # patterns cut for time: the cap acts on each score,
                    # the cursors on which scores exist)
                    for cap, mode in [(0.0, m) for m in (
                            "zero", "ragged", "bs-1", "bs", "last")] + [
                            (30.0, "ragged")]:
                        cases.append((4, H, KV, hd, bs, 256 // bs, q_dt,
                                      kv_dt, cap, mode))
    s = PAGED_SHAPE
    for kv_dt in (f32, i8, f8):
        cases.append((s["B"], s["H"], s["KV"], s["hd"], s["bs"], s["NB"],
                      f32, kv_dt, 0.0, "timing"))
    g = G12_SHAPE
    cases.append((g["B"], g["H"], g["KV"], g["hd"], g["bs"], g["NB"], f32,
                  f32, 0.0, "timing"))
    bad, worst, timing = 0, {}, {}
    for n, (B, H, KV, hd, bs, NB, q_dt, kv_dt, cap, mode) in enumerate(cases):
        top = NB * bs - 1
        cursors = {"zero": [0] * B, "bs-1": [bs - 1] * B, "bs": [bs] * B,
                   "last": [top] * B, "timing": [s["cursor"]] * B,
                   "ragged": np.random.default_rng(n).integers(
                       0, top + 1, B).tolist()}[mode]
        q, kp, vp, tbl, idx, ks, vs = paged_case(
            B, H, KV, hd, bs, NB, q_dt, kv_dt, cursors, seed=1000 + n,
            trash_row=mode != "timing")
        kw = dict(k_scales=ks, v_scales=vs, logit_softcap=cap)
        got = pa_ops.paged_attention(q, kp, vp, tbl, idx, force="kernel",
                                     **kw)
        want = pa_ops.paged_attention(q.float(), kp, vp, tbl, idx,
                                      force="ref", **kw)
        torch.cuda.synchronize()
        live = slice(None) if mode == "timing" else slice(0, B - 1)
        want_l = want[live].float()
        peak = max(1.0, want_l.abs().max().item())
        tol = TOL[f32] * (peak if ks is not None or q_dt == bf16 else 1.0)
        diff = (got[live].float() - want_l).abs()
        # err: the largest difference; ok: every element within its bound
        err = diff.max().item()
        room = tol + (2.0 ** -8 * want_l.abs() if q_dt == bf16 else 0.0)
        ok = bool((diff <= room).all()) and bool(torch.isfinite(got).all())
        bad += not ok
        name = str(kv_dt)[6:]
        worst[name] = max(worst.get(name, 0.0), err)
        if mode == "timing":
            timing[name if H == s["H"] else f"{name} G{H // KV}"] = err
        print(f"  pa q {str(q_dt)[6:]:8s} kv {name:13s} B{B} "
              f"H{H}/{KV} hd{hd} bs{bs} NB{NB} cap{cap:<4g} {mode:6s} "
              f"err={err:.2e} tol={tol:.1e}"
              f"{' + 2^-8|plain|' if q_dt == bf16 else ''} "
              f"{'ok' if ok else 'FAIL'}")
    if bad:
        _fail(f"{bad} of {len(cases)} paged-attention parity cases")
    print(f"paged parity: {len(cases)} cases within tolerance; worst error "
          f"per page dtype {worst}")
    return timing


def card_vs_cpu(cfglib, registry, ServeEngine, fa_ops, arch="gpt2-12l",
                depth=None, dropless=False):
    """Greedy B=1 P=128 8-token generation on the card, held against the
    port's plain path on the CPU fed the same tokens (teacher forcing: one
    CPU forward over prompt + generated tokens gives each step's logits,
    so a near-tie cannot send the two runs down different paths).
    ``arch`` at ``depth`` layers (default: its full depth); an MoE model
    ``dropless`` (``_dropless``) where prefill and teacher forcing group
    tokens otherwise."""
    cfg = cfglib.get_config(arch)
    cfg = cfg if depth is None else cfg.with_depth(depth)
    cfg = _dropless(cfg) if dropless else cfg
    api = registry.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    P, G = 128, 8
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, P)).astype(np.int32)
    fa_ops.KERNEL_LAUNCHES = 0
    card = ServeEngine(cfg, params, device="cuda", max_len=P + G).generate(
        prompts, G, return_logits=True)
    launches = fa_ops.KERNEL_LAUNCHES
    if launches != cfg.num_layers:
        _fail(f"B=1 generation launched the kernel {launches} times, "
              f"expected {cfg.num_layers} (one prefill, none in decode)")
    with torch.inference_mode():
        cpu_logits, _ = api.apply(params, cfg,
                                  torch.from_numpy(card.tokens[:, :-1]).long())
    want = cpu_logits[0, P - 1:].numpy()                   # (G, V)
    worst = 0.0
    for t in range(G):
        top2 = np.sort(want[t])[-2:]
        margin = float(top2[1] - top2[0])
        diff = float(np.abs(card.logits[0, t] - want[t]).max())
        worst = max(worst, diff)
        tok, cpu_tok = int(card.tokens[0, P + t]), int(np.argmax(want[t]))
        print(f"  step {t}: max|logit diff|={diff:.2e} top-2 margin="
              f"{margin:.4f} token card={tok} cpu={cpu_tok}")
        if diff > LOGIT_TOL:
            _fail(f"step {t} logits differ by {diff:.2e} > {LOGIT_TOL:.0e}")
        if tok != cpu_tok and margin > LOGIT_TOL:
            _fail(f"step {t} tokens differ with top-2 margin {margin:.4f}")
    print(f"card vs cpu ({cfg.name}, {cfg.num_layers} layers): logits "
          f"within {LOGIT_TOL:.0e} over {G} steps (worst {worst:.2e}), "
          f"tokens equal where the margin allows; {launches} flash launches")


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sdpa_yardstick(q, k, v, causal=True):
    """(time it, backend) for ``scaled_dot_product_attention`` on (B, S,
    heads, hd) inputs, causal (or not, over S_k keys), as PyTorch's
    dispatch serves them: the backend ``torch._fused_sdp_choice`` picks,
    then enabled alone while the caller times the call, so the reading
    names what it timed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=gqa))

    def timed(timer, *args):
        with sdpa_kernel([backend]):
            return timer(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=gqa), *args)
    return timed, backend.name


def _entry_registers(build_log: str, name_of) -> list:
    """(name, registers, spill bytes stored + loaded) of every entry
    function in ``-Xptxas -v`` output that ``name_of`` (mangled name ->
    name or None) names."""
    import re
    rows, name, spill = [], None, 0
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = name_of(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name, spill = None, 0
    return rows


def flash_registers(build_log: str) -> list:
    """(entry, registers, spill bytes) of every flash entry function."""
    import re

    def name_of(mangled):
        k = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkdv)_kernel)ILi(\d+)E"
                      r"(f|13__nv_bfloat16)", mangled)
        return (f"{k.group(1)}<{k.group(2)}, "
                f"{'float' if k.group(3) == 'f' else 'bf16'}>" if k else None)
    return _entry_registers(build_log, name_of)


_PAGE_NAMES = {"0": "f32", "1": "bf16", "2": "int8", "3": "fp8"}


def paged_registers(build_log: str) -> list:
    """(entry, registers, spill bytes) of every paged decode entry function
    (q dtype, page dtype, head dim, GM: the query heads a head block
    carries, 1 or 8, and MB: head blocks of 8 over each tile, for G > 8)."""
    import re

    def name_of(mangled):
        k = re.search(r"paged_decode_kernelI(f|13__nv_bfloat16)Li(\d)ELi"
                      r"(\d+)ELi(\d)ELb([01])E", mangled)
        return (f"paged<{'f32' if k.group(1) == 'f' else 'bf16'} q, "
                f"{_PAGE_NAMES[k.group(2)]} pages, hd {k.group(3)}, "
                f"GM {k.group(4)}{', MB' if k.group(5) == '1' else ''}>"
                if k else None)
    return _entry_registers(build_log, name_of)


def wkv_registers(build_log: str) -> list:
    """(entry, registers, spill bytes) of every WKV entry function, forward
    and backward (r/k/v dtype, head dim)."""
    import re

    def name_of(mangled):
        k = re.search(r"(wkv|wkv_bwd)_kernelI(f|13__nv_bfloat16)Li(\d+)E"
                      r"(Lb1E)?", mangled)
        return (f"{k.group(1)}{'_save' if k.group(4) else ''}<"
                f"{'f32' if k.group(2) == 'f' else 'bf16'}, hd {k.group(3)}>"
                if k else None)
    return _entry_registers(build_log, name_of)


def scan_registers(build_log: str) -> list:
    """(entry, registers, spill bytes) of every selective-scan entry
    function, forward and backward (input dtype, state dim)."""
    import re

    def name_of(mangled):
        k = re.search(r"(scan|scan_bwd)_kernelI(f|13__nv_bfloat16)Li(\d+)E"
                      r"(Lb1E)?", mangled)
        return (f"{k.group(1)}{'_save' if k.group(4) else ''}<"
                f"{'f32' if k.group(2) == 'f' else 'bf16'}, N {k.group(3)}>"
                if k else None)
    return _entry_registers(build_log, name_of)


def times(fa_ops):
    B, S, H, hd = MAIN_SHAPE
    q, k, v = _inputs(B, S, H, H, hd, torch.float32, 12345)
    kernel_ms = _time_ms(lambda: fa_ops.flash_attention(q, k, v,
                                                        force="kernel"), 50)
    plain_ms = _time_ms(lambda: fa_ops.flash_attention(q, k, v, force="ref"),
                        10)
    sdpa, backend = sdpa_yardstick(q, k, v)
    library_ms = sdpa(_time_ms, 50)
    from repro_torch.roofline import torch_cost
    work = torch_cost.flash_attention(B, S, S, H, H, hd)  # causal pairs only
    flops, nbytes, bound = work.flops, work.bytes, work.bounds()
    print(f"times at B={B} S={S} H={H} hd={hd} causal f32: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa ({backend}) "
          f"{library_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}; 3xTF32 on {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB), f32 FMA bound "
          f"{bound['f32_bound_ms']:.4f} ms")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_backend=backend, **bound)


def _drawn_traffic(cfg, argv):
    """[(prompt, budget)] of the requests ``serve.main(argv)`` draws with
    ``--continuous``, in the reference's rng order (the shared prefix,
    lengths, budgets, arrivals, then each prompt); the prefix cache adds a
    shared prefix of max(prompt_len // 2, block_size) tokens to every
    prompt."""
    arg = {k: float(v) for k, v in zip(argv, argv[1:])
           if k in ("--prompt-len", "--gen", "--requests", "--seed",
                    "--block-size", "--rate")}
    P, G, n = int(arg["--prompt-len"]), int(arg["--gen"]), \
        int(arg["--requests"])
    shared_len = max(P // 2, int(arg["--block-size"])) \
        if "--prefix-cache" in argv else 0
    rng = np.random.default_rng(int(arg["--seed"]))
    shared = rng.integers(0, cfg.vocab_size, (shared_len,)).astype(np.int32)
    lens = rng.integers(max(2, P // 4), P + 1, n)
    gens = rng.integers(max(2, G // 4), max(G, 2) + 1, n)
    rng.exponential(1.0 / arg["--rate"], n)
    return [(np.concatenate([shared, rng.integers(
                0, cfg.vocab_size, (int(p),)).astype(np.int32)]), int(g))
            for p, g in zip(lens, gens)]


def _drawn_requests(cfg, argv):
    """(prompt lengths, budgets) of ``_drawn_traffic(cfg, argv)``."""
    traffic = _drawn_traffic(cfg, argv)
    return (np.array([len(p) for p, _ in traffic]),
            np.array([g for _, g in traffic]))


def _serve_counted(serve, argv, counted):
    """``serve.main(argv)`` with every launch counter at 0 just before and
    each ``ServeEngine`` method named in ``counted`` counted where it
    returns (a call an injected fault stops fires before it launches
    anything).  Returns (the results, the timed run's scheduler, its
    ``summarize`` record, the calls of each counted method)."""
    from repro_torch.train import serve_scheduler
    from repro_torch.train.serve_engine import ServeEngine
    calls = {name: 0 for name in counted}
    scheds, stats = [], []
    saved = {name: getattr(ServeEngine, name) for name in counted}
    run, summ = serve_scheduler.ContinuousScheduler.run, serve.summarize

    def counting(name):
        def method(self, *a, **kw):
            out = saved[name](self, *a, **kw)
            calls[name] += 1           # a call that raised launched nothing
            return out
        return method

    def kept_run(self, *a, **kw):
        scheds.append(self)
        return run(self, *a, **kw)

    def kept_summary(*a, **kw):
        stats.append(summ(*a, **kw))
        return stats[-1]
    for name in counted:
        setattr(ServeEngine, name, counting(name))
    serve_scheduler.ContinuousScheduler.run = kept_run
    serve.summarize = kept_summary
    zero_counts()
    try:
        results = serve.main(argv)
    finally:
        for name in counted:
            setattr(ServeEngine, name, saved[name])
        serve_scheduler.ContinuousScheduler.run = run
        serve.summarize = summ
    return results, scheds[-1], stats[-1], calls


def _check_served(label, cfg, lens, gens, results, sched):
    """Every request ended at its budget with in-vocabulary tokens, and
    the pool got every page back (pages the radix tree still pins stay
    allocated, evictable, referenced by no row).  Returns the pinned
    page count."""
    n = len(lens)
    if len(results) != n:
        _fail(f"{label} returned {len(results)} results")
    for r, p, g in zip(results, lens, gens):
        if r.finish_reason != "limit" or len(r.new_tokens) != g \
                or len(r.prompt) != p:
            _fail(f"{label}, request {r.uid}: {r.finish_reason} with "
                  f"{len(r.new_tokens)} of {g} tokens (prompt {len(r.prompt)} "
                  f"of {p})")
        if r.new_tokens.min() < 0 or r.new_tokens.max() >= cfg.vocab_size:
            _fail(f"{label}, request {r.uid} produced tokens outside the "
                  "vocabulary")
    state = sched.last_state
    pool = state.pool
    pool.check_invariants()
    if state.radix is not None:
        state.radix.check_invariants()
    # With the prefix cache, pages the radix tree still pins stay allocated
    # (evictable, referenced by no row) after every request finished.
    pinned = len(state.radix.pinned_pages()) if state.radix is not None \
        else 0
    if pool.free_blocks + pinned != pool.num_blocks or pool.committed_blocks \
            or pool.evictable_blocks != pinned:
        _fail(f"{label}: pool not returned: {pool.free_blocks} of "
              f"{pool.num_blocks} pages free, {pinned} pinned by the tree, "
              f"{pool.evictable_blocks} evictable, {pool.committed_blocks} "
              "committed")
    return pinned


def _with_arch(argv, arch):
    """``argv`` with ``--arch`` set to ``arch``."""
    out = list(argv)
    out[out.index("--arch") + 1] = arch
    return out


def paged_main_path(cfg, serve, fa_ops, pa_ops, extra=()):
    """``serve.main(PAGED_ARGV + extra)`` for ``cfg``'s architecture, with
    every launch counter at 0 just before.  Returns (paged-kernel
    launches, the scheduler, the results, their TTFT p50 and p95 in
    seconds, the timed run's ``summarize`` record).  The CLI prints the
    aggregate tokens/s too."""
    argv = _with_arch(PAGED_ARGV, cfg.name) + list(extra)
    label = f"paged main path {cfg.name}" + (f" {' '.join(extra)}"
                                             if extra else "")
    results, sched, stats, calls = _serve_counted(serve, argv,
                                                  ("decode_masked",))
    launches, flash = pa_ops.KERNEL_LAUNCHES, fa_ops.KERNEL_LAUNCHES
    expect_counts(label, paged_attention=launches, flash_attention=flash)
    lens, gens = _drawn_requests(cfg, argv)
    pinned = _check_served(label, cfg, lens, gens, results, sched)
    pool, n, steps = sched.last_state.pool, len(lens), calls["decode_masked"]
    if launches != steps * cfg.num_layers or launches == 0:
        _fail(f"{label}: paged kernel launched {launches} times for "
              f"{steps} masked decode steps x {cfg.num_layers} layers")
    if flash != 0:
        _fail(f"{label} launched flash attention {flash} times")
    print(f"{label}: {n} requests at their budgets, pool "
          f"{pool.free_blocks}/{pool.num_blocks} pages free (+{pinned} "
          f"pinned by the radix tree), {launches} paged-kernel launches = "
          f"{steps} decode steps x {cfg.num_layers} layers, 0 "
          "flash-attention launches")
    ttft = [r.ttft_s for r in results]
    return (launches, sched, results,
            (float(np.percentile(ttft, 50)), float(np.percentile(ttft, 95))),
            stats)


def quant_main_paths(cfg, serve, fa_ops, pa_ops):
    """The continuous paged main path with int8 pages, with fp8 pages, and
    with the prefix cache over int8 pages, each with every counter at 0
    just before.  Returns the paged launches of each run and the results
    of each run."""
    out, stats, served = {}, {}, {}
    for key, extra in (("int8", ("--kv-dtype", "int8")),
                       ("fp8", ("--kv-dtype", "fp8")),
                       ("prefix+int8", ("--prefix-cache", "--kv-dtype",
                                        "int8"))):
        launches, sched, results, st, _ = paged_main_path(cfg, serve, fa_ops,
                                                          pa_ops, extra)
        ks = sched.kv_stats()
        ratio = (cfg.head_dim + 4) / (4 * cfg.head_dim)
        print(f"  kv storage {key}: dtype={ks['kv_dtype']} bytes/token="
              f"{ks['kv_bytes_per_token']} (f32: "
              f"{ks['kv_bytes_per_token_f32']}), ratio "
              f"{ks['kv_bytes_ratio']} (expected {ratio})")
        if ks["kv_bytes_ratio"] != ratio:
            _fail(f"{key}: kv bytes ratio {ks['kv_bytes_ratio']} != {ratio}")
        print(f"  {key}: ttft p50 {st[0] * 1e3:.1f} ms, p95 "
              f"{st[1] * 1e3:.1f} ms")
        out[key], stats[key], served[key] = launches, st, results
        if key == "prefix+int8":
            ps = sched.prefix_stats()
            if ps["prefix_hits"] < 1:
                _fail(f"the prefix-cache run had no hit: {ps}")
            hit = [r.ttft_s for r in results if r.prefix_tokens]
            cold = [r.ttft_s for r in results if not r.prefix_tokens]
            print(f"  prefix cache: hits {ps['prefix_hits']}/"
                  f"{ps['prefix_requests']} (rate "
                  f"{ps['prefix_hit_rate']:.4f}), skipped tokens "
                  f"{ps['prefix_skipped_tokens']}; ttft p50/p95 "
                  f"{st[0] * 1e3:.1f}/{st[1] * 1e3:.1f} ms against the "
                  f"int8 run's {stats['int8'][0] * 1e3:.1f}/"
                  f"{stats['int8'][1] * 1e3:.1f} ms (whose "
                  f"prompts lack the shared prefix); within this run hits {np.median(hit) * 1e3:.1f} ms median over "
                  f"{len(hit)}, misses "
                  + (f"{np.median(cold) * 1e3:.1f} ms median over "
                     f"{len(cold)}" if cold else "none"))
    return out, served


def paged_card_vs_cpu(cfglib, registry, arch="gpt2-12l", depth=None):
    """Three requests (prompts 100, 37, 128; 8 tokens each; 2 slots; pages
    of 16) through the paged scheduler on the card, each stream held
    against the port's plain CPU forward fed the same tokens (teacher
    forcing): tokens equal wherever the CPU top-2 margin exceeds
    ``LOGIT_TOL``.  ``arch`` at ``depth`` layers (default: full depth)."""
    from repro_torch.train.serve_engine import ServeEngine
    from repro_torch.train.serve_scheduler import ContinuousScheduler, Request
    cfg = cfglib.get_config(arch)
    cfg = cfg if depth is None else cfg.with_depth(depth)
    api = registry.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(2)
    G = 8
    prompts = [rng.integers(0, cfg.vocab_size, (P,)).astype(np.int32)
               for P in (100, 37, 128)]
    eng = ServeEngine(cfg, params, device="cuda", max_len=128 + G + 1,
                      paged=True, block_size=16)
    results = ContinuousScheduler(eng, max_batch=2).run(
        [Request(prompt=p, max_new_tokens=G) for p in prompts])
    worst = np.inf
    for res, prompt in zip(results, prompts):
        P = len(prompt)
        with torch.inference_mode():
            logits, _ = api.apply(params, cfg, torch.from_numpy(
                res.tokens[None, :-1]).long())
        want = logits[0, P - 1:].numpy()                       # (G, V)
        for t in range(G):
            top2 = np.sort(want[t])[-2:]
            margin = float(top2[1] - top2[0])
            tok, cpu_tok = int(res.new_tokens[t]), int(np.argmax(want[t]))
            if tok != cpu_tok and margin > LOGIT_TOL:
                _fail(f"paged request {res.uid} step {t}: card {tok} cpu "
                      f"{cpu_tok}, top-2 margin {margin:.4f}")
            worst = min(worst, margin)
        print(f"  paged request {res.uid}: P={P} tokens "
              f"{res.new_tokens.tolist()} equal the CPU argmax")
    print(f"paged card vs cpu ({cfg.name}, {cfg.num_layers} layers): 3 "
          f"requests x {G} tokens equal where the margin allows (smallest "
          f"top-2 margin {worst:.4f})")


# Card against CPU over int8 pages with the prefix cache: per-token greedy
# agreement at least the reference's int8 lane (TestQuantizedTolerance).
QUANT_AGREEMENT = 0.9


def _agreement(res_a, res_b):
    """(equal tokens, compared tokens): position by position over each
    pair of streams, the longer stream's length counted."""
    tot = hit = 0
    for a, b in zip(res_a, res_b):
        n = min(len(a.new_tokens), len(b.new_tokens))
        hit += int((a.new_tokens[:n] == b.new_tokens[:n]).sum())
        tot += max(len(a.new_tokens), len(b.new_tokens))
    return hit, tot


def quant_card_vs_cpu(cfglib, registry, arch="gpt2-12l", depth=None,
                      dropless=False):
    """The three prompts of ``paged_card_vs_cpu`` (the longest first) and a
    second arrival of the longest, 8 tokens each, through the int8
    prefix-cache scheduler (2 slots, pages of 16) on the card and on the
    CPU from the same weights.  The second 128-token prompt is a full
    8-page hit on an exact page boundary: the copy-on-write clone and the
    one-token rerun.  Token agreement must reach ``QUANT_AGREEMENT``;
    agreement with the card's f32 pool is printed as a finding.  ``arch``
    at ``depth`` layers (default: full depth), an MoE model ``dropless``
    as in ``card_vs_cpu``."""
    from repro_torch.train.serve_engine import ServeEngine
    from repro_torch.train.serve_scheduler import ContinuousScheduler, Request
    cfg = cfglib.get_config(arch)
    cfg = cfg if depth is None else cfg.with_depth(depth)
    cfg = _dropless(cfg) if dropless else cfg
    params = registry.get_model(cfg).init(torch.Generator().manual_seed(0),
                                          cfg, device="cpu")
    rng = np.random.default_rng(2)
    G = 8
    p100, p37, p128 = (rng.integers(0, cfg.vocab_size, (P,)).astype(np.int32)
                       for P in (100, 37, 128))
    reqs = [Request(prompt=p, max_new_tokens=G)
            for p in (p128, p100, p37, p128)]
    out = {}
    for device, kv, prefix in (("cuda", "int8", True), ("cpu", "int8", True),
                               ("cuda", "f32", False)):
        eng = ServeEngine(cfg, params, device=device, max_len=128 + G + 1,
                          paged=True, block_size=16, kv_dtype=kv,
                          prefix_cache=prefix)
        sched = ContinuousScheduler(eng, max_batch=2, invariant_every=1)
        out[device, kv] = sched.run(reqs)
        if prefix:
            hits = [r.prefix_tokens for r in out[device, kv]]
            if hits != [0, 0, 0, 127]:
                _fail(f"int8 prefix run on {device}: prefix tokens {hits}, "
                      "expected [0, 0, 0, 127]")
            sched.last_state.radix.check_invariants()
    hit, tot = _agreement(out["cuda", "int8"], out["cpu", "int8"])
    for r_card, r_cpu in zip(out["cuda", "int8"], out["cpu", "int8"]):
        print(f"  int8 request {r_card.uid}: P={len(r_card.prompt)} prefix "
              f"{r_card.prefix_tokens} card {r_card.new_tokens.tolist()} "
              f"cpu {r_cpu.new_tokens.tolist()}")
    f_hit, f_tot = _agreement(out["cuda", "int8"], out["cuda", "f32"])
    print(f"quant card vs cpu ({cfg.name}, {cfg.num_layers} layers): int8 + "
          f"prefix cache, {hit}/{tot} tokens equal "
          f"(agreement {hit / tot:.4f}, bar {QUANT_AGREEMENT}); against the "
          f"card's f32 pool {f_hit}/{f_tot} ({f_hit / f_tot:.4f}, a finding)")
    if hit / tot < QUANT_AGREEMENT:
        _fail(f"int8 card vs cpu agreement {hit}/{tot} < {QUANT_AGREEMENT}")


def _time_device_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each bracketed by
    its own CUDA events.  Before each launch the stream spins ~0.5 ms in a
    kernel that touches no memory (``torch.cuda._sleep``), so the host has
    queued ``fn``'s launches before the start event fires and the Python
    wrapper's host time stays out of the reading.  ``flush``, when given,
    first evicts the 50 MB L2 (the decode finds its pages cold: the other
    layers' pages pass through L2 in between); without it each launch finds
    the L2 as the previous launch left it."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _flusher():
    """A callable that evicts the 50 MB L2 by writing 256 MB."""
    junk = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    return junk.zero_


def paged_times(pa_ops, kv_dtype=torch.float32, s=PAGED_SHAPE, cap=0.0):
    """The paged kernel, its plain version and the SDPA yardstick at the
    timing shape ``s`` over ``kv_dtype`` pages (int8/fp8 with their
    scales), device time with the L2 flushed before each launch; the
    kernel and its plain version with softcap ``cap``, SDPA without.  The
    yardstick is ``scaled_dot_product_attention`` over the already gathered
    (and, for quantized pages, dequantized) contiguous (B, H, 576, hd) f32
    context, its kv heads repeated for GQA (``enable_gqa``): at uniform
    cursors the same function, but it reads no block table."""
    from repro_torch.kernels.paged_attention import ref
    B, H, KV, hd, bs, NB = (s[k] for k in ("B", "H", "KV", "hd", "bs", "NB"))
    q, kp, vp, tbl, idx, ks, vs = paged_case(
        B, H, KV, hd, bs, NB, torch.float32, kv_dtype, [s["cursor"]] * B,
        seed=4242, trash_row=False)
    kw = dict(k_scales=ks, v_scales=vs, logit_softcap=cap)
    flush = _flusher()
    kernel_ms = _time_device_ms(lambda: pa_ops.paged_attention(
        q, kp, vp, tbl, idx, force="kernel", **kw), 50, flush)
    plain_ms = _time_device_ms(lambda: pa_ops.paged_attention(
        q, kp, vp, tbl, idx, force="ref", **kw), 20, flush)
    S = s["cursor"] + 1
    kt, vt = (ref.gather_dequant(t, sc, tbl, torch.float32)[:, :S]
              .transpose(1, 2).contiguous() for t, sc in ((kp, ks), (vp, vs)))
    qt = q.transpose(1, 2).contiguous()
    gqa = dict(enable_gqa=True) if H != KV else {}
    library_ms = _time_device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, **gqa), 50, flush)
    from repro_torch.configs.base import HW_HBM_BW
    from repro_torch.roofline import torch_cost
    live = int((idx.long() + 1).sum())
    pages = int(((idx.long() + 1 + bs - 1) // bs).sum())
    # K and V of the live slots (and their scales), q in and out, the
    # table's live entries and the cursors
    work = torch_cost.paged_attention(
        B, H, KV, hd, live, pages, q_itemsize=q.element_size(),
        page_itemsize=kp.element_size(), quantized=ks is not None)
    flops, nbytes = work.flops, work.bytes
    op_ms = torch_cost.unit_seconds(work.by_unit) * 1e3
    byte_ms = nbytes / HW_HBM_BW * 1e3
    name = str(kv_dtype)[6:]
    print(f"paged times at B={B} H={H} KV={KV} hd={hd} bs={bs} cursors "
          f"{s['cursor']} softcap {cap:g} q f32, {name} pages, L2 flushed: "
          f"kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa on the "
          f"gathered context {library_ms:.4f} ms; bound "
          f"{max(op_ms, byte_ms):.4f} ms ({flops / 1e6:.1f} MFLOP -> "
          f"{op_ms:.4f} ms, {nbytes / 1e6:.3f} MB -> {byte_ms:.4f} ms)")
    warm_ms = _time_device_ms(lambda: pa_ops.paged_attention(
        q, kp, vp, tbl, idx, force="kernel", **kw), 50)
    back_ms = _time_ms(lambda: pa_ops.paged_attention(
        q, kp, vp, tbl, idx, force="kernel", **kw), 50)
    print(f"paged kernel ({name}) with a warm L2: {warm_ms:.4f} ms; back to "
          f"back, host wrapper included: {back_ms:.4f} ms per call")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(op_ms, byte_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes")


PAGED_PROFILE_DTYPES = (torch.float32, torch.int8)


def paged_one_kernel(pa_ops, readings) -> dict:
    """One call of the paged kernel as the main path makes it (an int64
    cursor, the engine's; an int32 table): the device kernels it ran,
    ``readings`` (``profiler_readings``' "paged", over f32 and int8
    pages), which must be exactly one (no workspace, no cursor cast); and
    the same call repeated gives the same bits over both.  Returns
    {"device_kernels": [names], "n_split": ...}."""
    s = PAGED_SHAPE
    B, H, KV, hd, bs, NB = (s[k] for k in ("B", "H", "KV", "hd", "bs", "NB"))
    n_split = pa_ops.split_plan(B, KV, NB)
    for kv, kernels in zip(PAGED_PROFILE_DTYPES, readings):
        q, kp, vp, tbl, idx, ks, vs = paged_case(
            B, H, KV, hd, bs, NB, torch.float32, kv, [s["cursor"]] * B,
            seed=77, trash_row=False)
        cursor = idx.long()
        kw = dict(k_scales=ks, v_scales=vs, force="kernel")
        first = pa_ops.paged_attention(q, kp, vp, tbl, cursor, **kw)
        same = all(torch.equal(first, pa_ops.paged_attention(
            q, kp, vp, tbl, cursor, **kw)) for _ in range(3))
        print(f"paged kernel ({str(kv)[6:]} pages, int64 cursor): one call "
              f"ran {len(kernels)} device kernel(s) {kernels}; n_split "
              f"{n_split} at the timing shape ({B * KV * n_split} CTAs); "
              f"4 calls {'bit-identical' if same else 'DIFFER'}")
        if len(kernels) != 1:
            _fail(f"one paged call ran {len(kernels)} device kernels: "
                  f"{kernels}")
        if not same:
            _fail(f"paged kernel repeats over {kv} pages differ")
    return {"device_kernels": kernels, "n_split": n_split}


# ---------------------------------------------------------------------------
# Training: Newton–Schulz, matmul and the flash-attention backward
# ---------------------------------------------------------------------------


def _rel_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def ns_parity(ns_ops) -> float:
    """The Newton–Schulz route (``ns_fused`` for the per-layer stacks,
    ``matmul`` for the embedding) against ``newton_schulz_ref`` per matrix,
    at small ragged shapes and at the stacks the training paths give it
    (gpt2-12l's, llama3-0.3b's, mixtral-0.3b's routers and expert stacks),
    plus the orthogonality check.  Returns the max abs error at gpt2-12l's
    largest stack (12 x 768 x 3072, f32)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dtype in (f32, bf16):
        for L in (1, 3, 12):
            for n, m in ((64, 192), (128, 128), (192, 64), (100, 300),
                         (300, 100)):
                cases.append((L, n, m, dtype))
    cases += [(12, 768, 768, f32), (12, 3072, 768, f32), (1, 50304, 768, f32),
              (12, 768, 3072, f32)]
    # llama3-0.3b's stacks at 24 layers; mixtral-0.3b's routers at 1 and 24
    # layers (n = 8) and its expert stacks at 24 layers of 8 experts
    cases += [(24, 1024, 512, f32), (24, 2048, 1024, f32),
              (24, 1024, 2048, f32), (1, 512, 8, f32), (24, 512, 8, f32),
              (192, 1024, 512, f32), (192, 512, 1024, f32)]
    g = torch.Generator(device="cuda").manual_seed(7)
    bad, err = 0, 0.0
    for L, n, m, dtype in cases:
        x = (torch.randn((L, n, m), generator=g, device="cuda") * 0.02).to(
            dtype)
        got = ns_ops.newton_schulz(x, force="kernel")
        want = ns_ops.newton_schulz(x, force="ref")
        torch.cuda.synchronize()
        rel = _rel_err(got, want)
        abs_err = (got.float() - want.float()).abs().max().item()
        if (L, n, m, dtype) == (12, 768, 3072, f32):
            err = abs_err
        ok = rel <= NS_TOL[dtype] and bool(torch.isfinite(got).all()) \
            and got.shape == x.shape and got.dtype == x.dtype
        bad += not ok
        print(f"  ns {str(dtype)[6:]:8s} L{L:<2d} {n}x{m} route "
              f"{ns_ops.route(n, m)} rel={rel:.2e} abs={abs_err:.2e} "
              f"tol={NS_TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
    y = ns_ops.newton_schulz(torch.randn((64, 128), generator=g,
                                         device="cuda"), force="kernel")
    s = torch.linalg.svdvals(y)
    orth = float(s.max()) < 1.35 and float(s.min()) > 0.3
    print(f"  ns orthogonality: singular values in [{float(s.min()):.3f}, "
          f"{float(s.max()):.3f}] {'ok' if orth else 'FAIL'}")
    if bad or not orth:
        _fail(f"{bad} of {len(cases)} Newton-Schulz parity cases, "
              f"orthogonality {'ok' if orth else 'FAILED'}")
    print(f"ns parity: {len(cases)} cases within tolerance")
    return err


# The embedding's three products per iteration, and ragged and bf16 cases.
MATMUL_CASES = [(100, 300, 77, False, torch.float32),
                (100, 300, 77, True, torch.float32),
                (37, 200, 45, False, torch.bfloat16),
                (768, 768, 768, False, torch.float32),
                (768, 768, 50304, False, torch.float32),
                (768, 50304, 768, True, torch.float32)]


def matmul_parity(ns_ops) -> float:
    """``matmul`` against the plain product, then the symmetric route and
    the large route's fused updates; returns the max abs error at the
    embedding's Gram (768 x 50304 @ its transpose, the symmetric route the
    main path takes)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    bad, err = 0, 0.0
    for M, K, N, trans_b, dtype in MATMUL_CASES:
        x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
        y = torch.randn((N, K) if trans_b else (K, N), generator=g,
                        device="cuda").to(dtype)
        got = ns_ops.matmul(x, y, trans_b=trans_b, force="kernel")
        want = ns_ops.matmul(x, y, trans_b=trans_b, force="ref")
        torch.cuda.synchronize()
        rel = _rel_err(got, want)
        err = (got.float() - want.float()).abs().max().item()
        ok = rel <= NS_TOL[dtype] and got.dtype == dtype
        bad += not ok
        print(f"  matmul {str(dtype)[6:]:8s} ({M},{K})@"
              f"{'T' if trans_b else ''}({K},{N}) rel={rel:.2e} "
              f"abs={err:.2e} tol={NS_TOL[dtype]:.0e} "
              f"{'ok' if ok else 'FAIL'}")
    if bad:
        _fail(f"{bad} of {len(MATMUL_CASES)} matmul parity cases")
    print(f"matmul parity: {len(MATMUL_CASES)} cases within tolerance")
    return sym_parity(ns_ops)


# The symmetric route (y is x, or G G^T with G symmetric): the embedding's
# Gram (normalized as Newton–Schulz feeds it), G G^T at 768^3, and ragged
# and bf16 ones; then the large route's products with their updates fused.
SYM_CASES = [(768, 50304, torch.float32), (100, 20000, torch.float32),
             (300, 77, torch.float32), (130, 64, torch.bfloat16)]


def sym_parity(ns_ops) -> float:
    """Each symmetric product against the plain one, exactly symmetric and
    the same bits on a second call; the embedding's Gram, and the plain f32
    one (cuBLAS) beside it, against an f64 product; then c G G^T + b G and
    P X + a X through the GEMM's epilogue.  Returns the max abs error at
    the embedding's Gram."""
    from repro_torch.kernels.newton_schulz.ref import NS_COEFFS
    a, b, c = NS_COEFFS
    g = torch.Generator(device="cuda").manual_seed(9)
    rows, bad, gram_err, f64_ok = [], 0, 0.0, True
    for M, K, dtype in SYM_CASES:
        x = torch.randn((M, K), generator=g, device="cuda")
        x = (x / torch.linalg.norm(x)).to(dtype)
        gram = ns_ops.matmul(x, x, trans_b=True, force="kernel")
        rows.append((f"({M},{K})@T", dtype, gram,
                     ns_ops.matmul(x, x, trans_b=True, force="ref"),
                     ns_ops.matmul(x, x, trans_b=True, force="kernel")))
        if M == 768:
            gram_err = (gram.float() - rows[-1][3].float()).abs().max().item()
            f64 = x.double() @ x.double().T
            k_rel, lib_rel = (((p.double() - f64).abs().max()
                               / f64.abs().max()).item()
                              for p in (gram, rows[-1][3]))
            f64_ok = k_rel <= GRAM_F64_TOL
            print(f"  matmul sym ({M},{K})@T against f64: kernel "
                  f"rel={k_rel:.2e} (cuBLAS f32 {lib_rel:.2e}) "
                  f"tol={GRAM_F64_TOL:.0e} {'ok' if f64_ok else 'FAIL'}")
            gg = ns_ops.matmul(gram, gram, trans_b=True, force="kernel")
            rows.append((f"G G^T ({M},{M})", dtype, gg,
                         ns_ops.matmul(gram, gram, trans_b=True, force="ref"),
                         ns_ops.matmul(gram, gram, trans_b=True,
                                       force="kernel")))
            poly = ns_ops._gemm(gram, gram, trans_b=True, d=gram, alpha=c,
                                beta=b)
            rows.append(("c G G^T + b G", dtype, poly,
                         c * (gram @ gram.T) + b * gram,
                         ns_ops._gemm(gram, gram, trans_b=True, d=gram,
                                      alpha=c, beta=b)))
            upd = ns_ops._gemm(poly, x, d=x, beta=a)
            rows.append(("P X + a X", dtype, upd, poly @ x + a * x,
                         ns_ops._gemm(poly, x, d=x, beta=a)))
    torch.cuda.synchronize()
    for name, dtype, got, want, again in rows:
        rel = _rel_err(got, want)
        square = got.shape[0] == got.shape[1]
        sym = bool(torch.equal(got, got.T)) if square else None
        same = bool(torch.equal(got, again))
        ok = rel <= NS_TOL[dtype] and sym is not False and same
        bad += not ok
        print(f"  matmul sym {str(dtype)[6:]:8s} {name:14s} rel={rel:.2e} "
              f"tol={NS_TOL[dtype]:.0e} symmetric={sym} repeat-equal={same} "
              f"{'ok' if ok else 'FAIL'}")
    if bad or not f64_ok:
        _fail(f"{bad} of {len(rows)} symmetric and fused matmul cases, "
              f"the Gram against f64 {'ok' if f64_ok else 'FAILED'}")
    print(f"matmul symmetric route: {len(rows)} cases within tolerance, "
          f"exactly symmetric, bit-identical on repeat; the Gram within "
          f"{GRAM_F64_TOL:.0e} of f64")
    return gram_err


def _bwd_pair(fa_ops, q, k, v, do, kw, force):
    """(dq, dk, dv) of attention on ``force``'s path for upstream ``do``."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, force=force, **kw)
    return torch.autograd.grad(out, leaves, do)


def bwd_parity(fa_ops) -> float:
    """The CUDA backward (through ``FlashAttentionFn``) against autograd of
    the plain version over the forward's grid and the training shape;
    returns the max abs error over dq, dk, dv at the training shape."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for H, KV in ((12, 12), (8, 2)):
                for S in (77, 512, 1000):
                    for causal in (True, False):
                        for window in (0, 64):
                            for cap in (0.0, 30.0):
                                cases.append((2, S, H, KV, hd, dtype, causal,
                                              window, cap))
    B, S, H, hd = TRAIN_SHAPE
    cases.append((B, S, H, H, hd, torch.float32, True, 0, 0.0))
    bad, err = 0, 0.0
    for n, (B, S, H, KV, hd, dtype, causal, window, cap) in enumerate(cases):
        q, k, v = _inputs(B, S, H, KV, hd, dtype, 5000 + n)
        do = _inputs(B, S, H, H, hd, dtype, 9000 + n)[0]
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        before = fa_ops.BWD_LAUNCHES
        got = _bwd_pair(fa_ops, q, k, v, do, kw, "kernel")
        want = _bwd_pair(fa_ops, q, k, v, do, kw, "ref")
        torch.cuda.synchronize()
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want)]
        scale = max(1.0, max(b.float().abs().max().item() for b in want))
        err = max(errs)
        ok = (err <= BWD_TOL[dtype] * scale
              and fa_ops.BWD_LAUNCHES == before + 1
              and all(bool(torch.isfinite(a).all()) for a in got))
        bad += not ok
        print(f"  fa-bwd {str(dtype)[6:]:8s} B{B} S{S:<4d} H{H}/{KV} hd{hd} "
              f"c{int(causal)} w{window:<2d} cap{cap:<4g} dq/dk/dv err="
              f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} scale={scale:.2f} "
              f"{'ok' if ok else 'FAIL'}")
    if bad:
        _fail(f"{bad} of {len(cases)} flash-attention backward parity cases")
    print(f"backward parity: {len(cases)} cases within tolerance")
    return err                                   # the last case: training


def bwd_f64_and_repeats(fa_ops) -> float:
    """dq, dk, dv at the training shape against autograd of
    ``attention_f64`` (relative to max(1, max|grad|), within
    ``FA_F64_TOL``), beside the plain f32 version's own error; and two
    backward calls on the same inputs give the same bits.  Returns the
    kernel's largest f64 error."""
    B, S, H, hd = TRAIN_SHAPE
    q, k, v = _inputs(B, S, H, H, hd, torch.float32, 41)
    do = _inputs(B, S, H, H, hd, torch.float32, 42)[0]
    got = _bwd_pair(fa_ops, q, k, v, do, {}, "kernel")
    again = _bwd_pair(fa_ops, q, k, v, do, {}, "kernel")
    plain = _bwd_pair(fa_ops, q, k, v, do, {}, "ref")
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_f64(*leaves), leaves, do.double())
    errs, plain_errs = [], []
    for a, p, w in zip(got, plain, want):
        scale = max(1.0, w.abs().max().item())
        errs.append((a.double() - w).abs().max().item() / scale)
        plain_errs.append((p.double() - w).abs().max().item() / scale)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"fa-bwd f64 at B{B} S{S} H{H} hd{hd}: kernel dq/dk/dv "
          f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e}, plain f32 "
          f"{plain_errs[0]:.2e}/{plain_errs[1]:.2e}/{plain_errs[2]:.2e} "
          f"(tol {FA_F64_TOL:.0e}); repeat bit-identical {same}")
    if max(errs) > FA_F64_TOL or not same:
        _fail(f"flash backward: f64 error {max(errs):.2e} (tol "
              f"{FA_F64_TOL:.0e}), repeat equal {same}")
    return max(errs)


# The route each Muon matrix leaf of a trained architecture takes, written
# out: every per-layer stack (attention, MLP, and the MoE's routers and
# expert stacks, an (L, E, n, m) stack being one chain) is one ns_fused
# chain; the embedding and an untied head take the large route, 3 GEMMs
# for each of 5 Newton–Schulz steps.
NS_ROUTES = {
    "gpt2-12l": {"fused": ("wq", "wk", "wv", "wo", "w_up", "w_down"),
                 "large": ("embed",)},
    "llama3-0.3b": {"fused": ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                              "w_down"),
                    "large": ("embed", "lm_head")},
    "mixtral-0.3b": {"fused": ("wq", "wk", "wv", "wo", "router", "w_gate",
                               "w_up", "w_down"),
                     "large": ("embed", "lm_head")},
    # MLA's latent projections; the shared expert's three and the expert
    # stacks' three.
    "deepseekv3-0.3b": {"fused": ("wq", "wkv_a", "wkv_b", "wo", "router",
                                  "w_gate", "w_up", "w_down", "w_gate",
                                  "w_up", "w_down"),
                        "large": ("embed", "lm_head")},
    # its feed-forward's (1536, 8960) matrices take the large route, one
    # chain a layer
    "qwen2-vl-2b": {"fused": ("wq", "wk", "wv", "wo"),
                    "large": ("embed", "w_gate", "w_up", "w_down")},
    # the decoder's self- and cross-attention, the encoder's attention, and
    # both stacks' feed-forwards (the position tables are not matrices to
    # Muon)
    "whisper-base": {"fused": ("wq", "wk", "wv", "wo") * 3
                     + ("w_up", "w_down") * 2,
                     "large": ("embed",)},
    # the decay's low-rank pair takes the fused route; the 4096-wide
    # projections, the channel mix and both vocabulary matrices the large
    "rwkv6-7b": {"fused": ("w_a", "w_b"),
                 "large": ("w_r", "w_k", "w_v", "w_g", "w_o", "cm_r",
                           "cm_k", "cm_v", "embed", "lm_head")},
}


def _ns_launches(cfg):
    """(ns_fused, matmul) launches of one Muon update at ``cfg``'s depth,
    from ``NS_ROUTES``: one ``ns_fused`` a fused leaf (its whole stack),
    15 GEMMs (5 steps of 3) a matrix of a large-route leaf (each matrix of
    a stacked one); fails unless its leaves are the model's matrix leaves
    (the optimizer's own selection)."""
    from repro_torch.models import registry
    from repro_torch.optim import muon
    from repro_torch.tree import leaves_with_path
    routes = NS_ROUTES[cfg.name]
    params = registry.get_model(cfg).init(None, cfg, device="meta")
    mats = [(path[-1], x) for path, x in leaves_with_path(params)
            if muon._is_matrix(path, x)]
    if sorted(n for n, _ in mats) != sorted(routes["fused"]
                                           + routes["large"]):
        _fail(f"{cfg.name} Muon matrix leaves {sorted(n for n, _ in mats)}, "
              f"NS_ROUTES lists {routes}")
    large = sum(math.prod(x.shape[:-2]) for n, x in mats
                if n in routes["large"])
    return len(routes["fused"]), 3 * 5 * large


def train_main_path(cfg, train, ckpt_dir, argv=TRAIN_ARGV):
    """``train.main(argv)`` for ``cfg``'s architecture with every launch
    counter at 0 just before; checks the expansion, the losses, the
    checkpoints and each kernel's launches.  Returns (result, {kernel:
    launches})."""
    from repro_torch.checkpoint import checkpointer as ckpt
    argv = _with_arch(argv, cfg.name)
    arg = dict(zip(argv, argv[1:]))
    n_steps, tau = int(arg["--steps"]), int(float(arg["--tau"])
                                            * int(arg["--steps"]))
    zero_counts()
    res = train.main(argv + ["--ckpt-dir", ckpt_dir])
    counts = read_counts()
    layers = [1] * tau + [cfg.num_layers] * (n_steps - tau)
    h = res.history
    if h["expansion_steps"] != [tau] or res.final_layers != cfg.num_layers:
        _fail(f"expansion at {h['expansion_steps']} to {res.final_layers} "
              f"layers, expected [{tau}] to {cfg.num_layers}")
    if h["layers"][-1] != cfg.num_layers or \
            not all(np.isfinite(h["loss"])) or not h["loss"]:
        _fail(f"training losses {h['loss']} at layers {h['layers']}")
    from repro_torch.configs.base import TrainConfig
    tc = TrainConfig()                 # the launcher's eval cadence
    evals = [s for s in range(1, n_steps) if s % tc.eval_every == 0]
    fused, large = _ns_launches(cfg)
    want = {name: 0 for name in COUNTERS}      # the kernels it never runs
    want.update(flash_attention=sum(layers)
                + tc.eval_batches * sum(layers[s] for s in evals),
                flash_attention_bwd=sum(layers),
                ns_fused=fused * n_steps, matmul=large * n_steps)
    if counts != want:
        _fail(f"{cfg.name} training launches {counts}, expected {want}")
    saved = ckpt.all_steps(ckpt_dir)
    if saved != [tau, n_steps]:
        _fail(f"checkpoints {saved}, expected [{tau}, {n_steps}]")
    if ckpt.load_metadata(ckpt_dir, tau)["num_layers"] != 1 or \
            ckpt.load_metadata(ckpt_dir, n_steps)["num_layers"] != \
            cfg.num_layers:
        _fail("checkpoint depths do not follow the expansion")
    print(f"training main path {cfg.name}: {n_steps} steps, expansion at "
          f"step {tau} to {cfg.num_layers} layers, losses "
          f"{h['loss'][0]:.4f} -> {h['loss'][-1]:.4f}, checkpoints {saved}; "
          f"launches {counts}")
    return res, counts


def serve_trained(serve, ckpt_dir, layers):
    """``serve.main --checkpoint`` on the grown checkpoint: one prefill per
    generation through flash attention, at the checkpoint's depth."""
    zero_counts()
    res = serve.main(["--arch", "gpt2-12l", "--checkpoint", ckpt_dir,
                      "--batch", "4", "--prompt-len", "128", "--gen", "16"])
    expect_counts("serving the checkpoint", flash_attention=2 * layers)
    if res.tokens.shape != (4, 128 + 16) or res.tokens.min() < 0 \
            or res.tokens.max() >= 50304:
        _fail(f"serving the checkpoint returned tokens {res.tokens.shape}")
    print(f"served the trained checkpoint at {layers} layers: "
          f"{2 * layers} flash-attention launches")


def train_card_vs_cpu(cfglib, registry, arch="gpt2-12l", depth=1):
    """One train step of ``arch`` at full width (``depth`` layers, batch 2,
    128 tokens) from the same params and batch on the card and on the
    CPU."""
    from repro_torch import bridge
    from repro_torch.configs.base import OptimizerConfig, ScheduleConfig
    from repro_torch.core.schedules import make_schedule
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.optim.base import make_optimizer
    from repro_torch.train import steps
    cfg = cfglib.get_config(arch).with_depth(depth)
    opt = make_optimizer(OptimizerConfig())
    step = steps.make_train_step(cfg, opt, make_schedule(
        ScheduleConfig(), 0.01, 100))
    host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=2, seed=0)).batch(0)
    out = {}
    for dev in ("cuda", "cpu"):
        params = registry.get_model(cfg).init(
            torch.Generator().manual_seed(0), cfg, device=dev)
        batch = {k: torch.from_numpy(v).long().to(dev)
                 for k, v in host.items()}
        t0 = time.perf_counter()
        params, _, m = step(params, opt.init(params), batch, 0)
        out[dev] = (float(m["loss"]), bridge.flatten(
            bridge.params_to_numpy(params)), time.perf_counter() - t0)
    loss_diff = abs(out["cuda"][0] - out["cpu"][0])
    worst, worst_key = 0.0, ""
    for key, want in out["cpu"][1].items():
        d = float(np.abs(out["cuda"][1][key] - want).max())
        if d > worst:
            worst, worst_key = d, key
    print(f"train card vs cpu ({cfg.name}, {depth} layers): loss "
          f"{out['cuda'][0]:.6f} vs "
          f"{out['cpu'][0]:.6f} (diff {loss_diff:.2e}, tol "
          f"{TRAIN_LOSS_TOL:.0e}); worst param diff {worst:.2e} at "
          f"{worst_key} (tol {TRAIN_PARAM_TOL:.0e}); CPU step "
          f"{out['cpu'][2]:.1f} s")
    if loss_diff > TRAIN_LOSS_TOL or worst > TRAIN_PARAM_TOL:
        _fail("one train step differs between the card and the CPU")


def _library_ns(x, steps=5, eps=1e-7):
    """The same Newton–Schulz chain as batched PyTorch calls (bmm and
    baddbmm over the stack): the yardstick, never called by the port."""
    from repro_torch.kernels.newton_schulz.ref import NS_COEFFS
    a, b, c = NS_COEFFS
    x = x / (torch.linalg.norm(x.flatten(1), dim=1)[:, None, None] + eps)
    for _ in range(steps):
        g = torch.bmm(x, x.transpose(1, 2))
        p = torch.baddbmm(g, g, g, beta=b, alpha=c)
        x = torch.baddbmm(x, p, x, beta=a, alpha=1.0)
    return x


def train_times(ns_ops, fa_ops, res, cfg):
    """ns_fused at the main path's largest stack, matmul at the
    embedding's Gram, the flash backward at the training shape, each
    against its plain version and a PyTorch yardstick, beside its bound;
    then the Newton–Schulz share of a training step per depth."""
    from repro_torch.configs.base import HW_PEAK_TF32_FLOPS
    from repro_torch.roofline import torch_cost
    L, n, m = 12, 768, 3072
    x = torch.randn((L, n, m), device="cuda") * 0.02
    # the bounds: 3xTF32 over the Grams' symmetric halves, and f32 FMA
    ns = dict(ms=_time_ms(lambda: ns_ops.ns_fused(x, force="kernel"), 10),
              plain_ms=_time_ms(lambda: ns_ops.ns_fused(x, force="ref"), 5),
              library_ms=_time_ms(lambda: _library_ns(x), 10),
              **torch_cost.ns_fused(L, n, m, 5).bounds())
    print(f"ns_fused at L={L} {n}x{m} f32, 5 steps: kernel {ns['ms']:.4f} ms, "
          f"plain {ns['plain_ms']:.4f} ms, batched torch "
          f"{ns['library_ms']:.4f} ms; bound {ns['bound_ms']:.4f} ms "
          f"({ns['bound_by']}; 3xTF32 at {HW_PEAK_TF32_FLOPS / 1e12:.0f} "
          f"TFLOP/s, Grams over the symmetric half), f32 bound "
          f"{ns['f32_bound_ms']:.4f} ms")
    for shape in ((12, 768, 768), (12, 3072, 768)):
        y = torch.randn(shape, device="cuda") * 0.02
        print(f"  newton_schulz at {shape}: kernel route "
              f"{_time_ms(lambda: ns_ops.newton_schulz(y), 10):.4f} ms")

    M, K = 768, 50304
    a = torch.randn((M, K), device="cuda")
    mm = dict(ms=_time_ms(lambda: ns_ops.matmul(a, a, trans_b=True,
                                                force="kernel"), 10),
              plain_ms=_time_ms(lambda: ns_ops.matmul(a, a, trans_b=True,
                                                      force="ref"), 10),
              library_ms=_time_ms(lambda: torch.matmul(a, a.T), 10),
              **torch_cost.matmul(M, M, K, symmetric=True).bounds())
    p = torch.randn((M, M), device="cuda")
    mm_x = _time_ms(lambda: ns_ops.matmul(p, a, force="kernel"), 10)
    px_lib = _time_ms(lambda: torch.matmul(p, a), 10)
    px_bound = torch_cost.matmul(M, K, M).bounds()
    gram = ns_ops.matmul(a, a, trans_b=True) / K
    gg_ms = _time_ms(lambda: ns_ops.matmul(gram, gram, trans_b=True,
                                           force="kernel"), 50)
    gg_lib = _time_ms(lambda: torch.matmul(gram, gram), 50)
    gg_bound = torch_cost.matmul(M, M, M, symmetric=True).bounds()
    mm.update(gg_ms=gg_ms, gg_library_ms=gg_lib,
              gg_bound_ms=gg_bound["bound_ms"],
              gg_f32_bound_ms=gg_bound["f32_bound_ms"], px_ms=mm_x,
              px_library_ms=px_lib, px_bound_ms=px_bound["bound_ms"],
              px_f32_bound_ms=px_bound["f32_bound_ms"])
    print(f"matmul at ({M},{K})@T: kernel {mm['ms']:.4f} ms, plain "
          f"{mm['plain_ms']:.4f} ms, torch.matmul {mm['library_ms']:.4f} ms; "
          f"bound {mm['bound_ms']:.4f} ms ({mm['bound_by']}; 3xTF32, the "
          f"symmetric half), f32 bound {mm['f32_bound_ms']:.4f} ms")
    print(f"  G G^T at ({M},{M}): kernel {gg_ms:.4f} ms, torch.matmul "
          f"{gg_lib:.4f} ms; bound {gg_bound['bound_ms']:.4f} ms, f32 bound "
          f"{gg_bound['f32_bound_ms']:.4f} ms")
    print(f"  P X ({M},{M})@({M},{K}): kernel {mm_x:.4f} ms, torch.matmul "
          f"{px_lib:.4f} ms; bound {px_bound['bound_ms']:.4f} ms, f32 bound "
          f"{px_bound['f32_bound_ms']:.4f} ms")

    B, S, H, hd = TRAIN_SHAPE
    q, k, v = _inputs(B, S, H, H, hd, torch.float32, 777)
    do = _inputs(B, S, H, H, hd, torch.float32, 778)[0]
    out, lse = fa_ops.flash_attention_cuda(q, k, v, with_lse=True)
    bwd_ms = _time_device_ms(lambda: fa_ops.flash_attention_bwd_cuda(
        q, k, v, out, lse, do), 50)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_out = fa_ops.flash_attention(*leaves, force="ref")
    plain_ms = _time_device_ms(lambda: torch.autograd.grad(
        ref_out, leaves, do, retain_graph=True), 10)
    from torch.nn.attention import sdpa_kernel
    _, backend = sdpa_yardstick(q, k, v)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    with sdpa_kernel([getattr(torch.nn.attention.SDPBackend, backend)]):
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
        lib_ms = _time_device_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True), 50)
    bwd_again = _time_device_ms(lambda: fa_ops.flash_attention_bwd_cuda(
        q, k, v, out, lse, do), 50)
    pairs = B * H * S * (S + 1) // 2
    bwd_work = torch_cost.flash_attention_bwd(B, S, S, H, H, hd)
    bwd = dict(ms=bwd_ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_backend=backend, **bwd_work.bounds())
    seven = torch_cost.bound({"tf32x3": 14 * hd * pairs},
                             bwd_work.bytes)["bound_ms"]
    print(f"flash backward at B={B} S={S} H={H} hd={hd} causal f32: kernel "
          f"{bwd_ms:.4f} ms (again {bwd_again:.4f}), plain (autograd) "
          f"{plain_ms:.4f} ms, sdpa ({backend}) backward {lib_ms:.4f} ms; "
          f"bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']}; 3xTF32, five "
          f"products a pair; the seven this design runs {seven:.4f}), f32 "
          f"FMA bound {bwd['f32_bound_ms']:.4f} ms")
    fwd_ms = _time_device_ms(lambda: fa_ops.flash_attention_cuda(
        q, k, v, with_lse=True), 50)
    sdpa, backend = sdpa_yardstick(q, k, v)
    fwd_lib = sdpa(_time_device_ms, 50)
    fwd_bound = torch_cost.flash_attention(B, S, S, H, H, hd,
                                           with_lse=True).bounds()
    bwd.update(fwd_lse_ms=fwd_ms, fwd_library_ms=fwd_lib,
               fwd_bound_ms=fwd_bound["bound_ms"],
               fwd_f32_bound_ms=fwd_bound["f32_bound_ms"])
    print(f"flash forward with lse at B={B} S={S}: kernel {fwd_ms:.4f} ms, "
          f"sdpa ({backend}) {fwd_lib:.4f} ms; bound "
          f"{fwd_bound['bound_ms']:.4f} ms ({fwd_bound['bound_by']}), f32 FMA "
          f"bound {fwd_bound['f32_bound_ms']:.4f} ms")

    # Newton–Schulz per training step at each depth: every Muon leaf,
    # through the port's route, against the measured step time.
    from repro_torch.models import registry
    from repro_torch.optim import muon
    from repro_torch.tree import leaves_with_path
    for layers in (1, cfg.num_layers):
        dcfg = cfg.with_depth(layers)
        mats = [torch.randn(x.shape, device="cuda") * 0.02
                for p, x in leaves_with_path(registry.get_model(dcfg).init(
                    None, dcfg, device="meta")) if muon._is_matrix(p, x)]

        def all_ns():
            for mat in mats:
                muon.orthogonalize(mat)
        ns_step = _time_ms(all_ns, 3)
        dts = [dt for Ld, dt in res.step_times if Ld == layers][1:]
        step_ms = 1e3 * sum(dts) / len(dts)
        tok_s = TRAIN_SHAPE[0] * TRAIN_SHAPE[1] / (step_ms / 1e3)
        print(f"training at {layers} layers: {tok_s:.1f} tokens/s "
              f"({step_ms:.2f} ms per step over {len(dts)} steps); "
              f"Newton-Schulz {ns_step:.2f} ms per step = "
              f"{100 * ns_step / step_ms:.1f}% of the step")
    return ns, mm, bwd


# ---------------------------------------------------------------------------
# RWKV6 serving: the WKV recurrence
# ---------------------------------------------------------------------------


def wkv_case(B, S, H, hd, dtype, state, decay, seed, zeros=False):
    """r, k, v ~ N(0, 1) in ``dtype``; w float32 uniform in ``decay``, with
    ``zeros`` a tenth of it exactly 0 and a twentieth in [1e-37, 1e-31]
    (below the reference's 1e-30 floor); u ~ 0.1 N(0, 1); a zero or N(0, 1)
    initial state."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (randn(B, S, H, hd).to(dtype) for _ in range(3))
    lo, hi = decay
    w = lo + (hi - lo) * torch.rand((B, S, H, hd), generator=g,
                                    device="cuda")
    if zeros:
        pick = torch.rand(w.shape, generator=g, device="cuda")
        tiny = 10.0 ** (-37 + 6 * torch.rand(w.shape, generator=g,
                                              device="cuda"))
        w = torch.where(pick < 0.1, 0.0, torch.where(pick < 0.15, tiny, w))
    u = 0.1 * randn(H, hd)
    s0 = randn(B, H, hd, hd) if state else torch.zeros(
        (B, H, hd, hd), device="cuda")
    return r, k, v, w, u, s0


def _rel_floor(got, want) -> float:
    want = want.float()
    scale = max(1.0, want.abs().max().item())
    return (got.float() - want).abs().max().item() / scale


# Decays at rwkv_init: w = exp(-exp(w_base)) with w_base in [-6, -1] spans
# about [0.69, 0.9975]; the grid takes each end, and decays near 0 (a
# trained w_base > 2), where a tenth are exactly 0 and some below the
# reference's 1e-30 floor: a kernel that factored the scores across a chunk
# would overflow there.
WKV_DECAYS = {"near 0.69": (0.69, 0.72), "near 0.9975": (0.995, 0.9975),
              "near 0": (1e-4, 0.05)}


def wkv_parity_cases() -> list:
    """Phase 14's grid, (B, S, H, hd, dtype, state, decay) a case, the main
    path's prefill shape last (``tools/kernel_bits_compare.py`` runs it
    too).  At S = 1024 the grid takes B 1 x 2 heads alone (4 x 64 heads
    there cut for time: taken at every shorter length and at the main
    path's shape)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dtype in (f32, bf16):
        for hd in (16, 32, 64, 128):
            for S in (1, 7, 63, 64, 100, 1024):
                for B, H in ((1, 2), (4, 64)) if S < 1024 else ((1, 2),):
                    for state in (False, True):
                        for decay in WKV_DECAYS:
                            cases.append((B, S, H, hd, dtype, state, decay))
    B, S, H, hd = RWKV_SHAPE
    cases.append((B, S, H, hd, f32, False, "near 0.69"))
    return cases


def wkv_parity(wkv_ops) -> float:
    """The WKV kernel against its per-step and chunked plain forms over
    the grid; y and the final state.  Returns the max abs error of y at the
    main path's prefill shape (f32, zero state) against the chunked form,
    the one the CPU takes there."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = wkv_parity_cases()
    B, S, H, hd = RWKV_SHAPE
    bad, err = 0, 0.0
    worst = {}
    for n, (B, S, H, hd, dtype, state, decay) in enumerate(cases):
        args = wkv_case(B, S, H, hd, dtype, state, WKV_DECAYS[decay],
                        seed=3000 + n, zeros=decay == "near 0")
        y, s = wkv_ops.wkv(*args, force="kernel")
        errs = []
        for form in ("ref", "chunked"):
            want_y, want_s = wkv_ops.wkv(*args, force=form)
            errs.append((_rel_floor(y, want_y), _rel_floor(s, want_s)))
        torch.cuda.synchronize()
        err = (y.float() - want_y.float()).abs().max().item()
        ey = max(e[0] for e in errs)
        es = max(e[1] for e in errs)
        ok = (ey <= WKV_TOL[dtype] and es <= WKV_TOL[f32]
              and y.dtype == dtype and s.dtype == f32
              and bool(torch.isfinite(y).all() and torch.isfinite(s).all()))
        bad += not ok
        label = (f"{str(dtype)[6:]:8s} B{B} S{S:<4d} H{H:<2d} hd{hd:<3d} "
                 f"state {'rand' if state else 'zero'} decay {decay}")
        if dtype not in worst or ey > worst[dtype][0]:
            worst[dtype] = (ey, es, label)
        if not ok:
            print(f"  wkv {label} y rel={ey:.2e} state rel={es:.2e} FAIL")
    for dtype, (ey, es, label) in worst.items():
        print(f"  wkv worst {str(dtype)[6:]}: y rel={ey:.2e} (tol "
              f"{WKV_TOL[dtype]:.0e}), state rel={es:.2e} at {label}")
    if bad:
        _fail(f"{bad} of {len(cases)} WKV parity cases")
    print(f"wkv parity: {len(cases)} cases within tolerance against both "
          "plain forms")
    for dtype in (f32, bf16):
        args = wkv_case(B, S, H, hd, dtype, True, WKV_DECAYS["near 0.69"], 7)
        first = wkv_ops.wkv(*args, force="kernel")
        if not all(all(torch.equal(a, b) for a, b in zip(
                first, wkv_ops.wkv(*args, force="kernel"))) for _ in range(3)):
            _fail(f"wkv kernel repeats differ ({dtype})")
    print("wkv kernel: 3 repeats bit-identical at the main shape, f32 and "
          "bf16 (y and the state)")
    return err                                   # the last case: main shape


def draw_on_card(registry, cfg, seed=0):
    """``cfg``'s random weights drawn on the card from ``seed`` (seconds,
    where a host draw of a 7 B model takes about a minute)."""
    t0 = time.perf_counter()
    params = registry.get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(seed), cfg, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"  {cfg.name} at {cfg.num_layers} layers: {n} params "
          f"({4 * n / 1e9:.2f} GB f32) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    return params


def rwkv_main_path(cfglib, params):
    """``RWKV_ARGV``'s run on ``params`` (drawn once on the card for phases
    15-17 and 27) through the ``ServeEngine`` that ``serve.main`` builds,
    as it runs it: a two-token warm-up, then the timed generation of the
    same prompts (``--seed``'s draw).  Every counter at 0 just before:
    exactly one WKV launch per layer per prefill (warm-up and timed), no
    other kernel.  Returns (result, WKV launches, peak device bytes)."""
    from repro_torch.train.serve_engine import ServeEngine
    cfg = cfglib.get_config("rwkv6-7b")
    arg = {k: int(v) for k, v in zip(RWKV_ARGV, RWKV_ARGV[1:])
           if k in ("--batch", "--prompt-len", "--gen", "--seed")}
    B, P, G = arg["--batch"], arg["--prompt-len"], arg["--gen"]
    prompts = np.random.default_rng(arg["--seed"]).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, device="cuda", max_len=P + G + 1)
    zero_counts()
    eng.generate(prompts, 2)
    res = eng.generate(prompts, G, seed=arg["--seed"])
    launches = expect_counts("rwkv6 main path", wkv=2 * cfg.num_layers)["wkv"]
    peak = torch.cuda.max_memory_allocated()
    del eng
    shape = (B, P + G)
    if res.tokens.shape != shape:
        _fail(f"rwkv6 main path returned tokens {res.tokens.shape}, "
              f"expected {shape}")
    if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
        _fail("rwkv6 main path produced tokens outside the vocabulary")
    print(f"rwkv6 main path: {launches} WKV launches (2 prefills x "
          f"{cfg.num_layers} layers, 0 in decode), no other kernel; peak "
          f"device memory {peak / 2 ** 30:.2f} GiB; prefill "
          f"{res.prefill_s * 1e3:.1f} ms, decode {res.decode_s * 1e3:.1f} ms;"
          f" phase {time.perf_counter() - t0:.1f} s")
    return res, launches, peak


def rwkv_card_vs_cpu(cfglib, registry):
    """``rwkv6-7b`` at full width and depth 2: greedy B=2, P=80, 8 tokens
    on the card, against the CPU's prefill (P=80: the chunked WKV form,
    chunks of 16) and plain decode fed the card's tokens.  Logits agree per
    step to ``LOGIT_TOL``; tokens are equal wherever the CPU's top-2 margin
    exceeds it."""
    from repro_torch.models import transformer as tr
    from repro_torch.train.serve_engine import ServeEngine
    cfg = cfglib.get_config("rwkv6-7b").with_depth(2)
    api = registry.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, P, G = 2, 80, 8
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    card = ServeEngine(cfg, params, device="cuda", max_len=P + G).generate(
        prompts, G, return_logits=True)
    toks = torch.from_numpy(card.tokens).long()
    want = []
    with torch.inference_mode():
        cache = tr.lm_init_cache(params, cfg, B, P + G, torch.float32,
                                 device="cpu")
        logits, cache = tr.lm_prefill(params, cfg, toks[:, :P], cache,
                                      last_only=True)
        want.append(logits[:, 0])
        for t in range(1, G):
            logits, cache = tr.lm_decode_step(
                params, cfg, toks[:, P + t - 1:P + t], cache, P + t - 1)
            want.append(logits[:, 0])
    want = torch.stack(want, dim=1).numpy()               # (B, G, V)
    worst = 0.0
    for t in range(G):
        diff = float(np.abs(card.logits[:, t] - want[:, t]).max())
        worst = max(worst, diff)
        top2 = np.sort(want[:, t], axis=-1)[:, -2:]
        margins = top2[:, 1] - top2[:, 0]
        tok, cpu_tok = card.tokens[:, P + t], want[:, t].argmax(-1)
        print(f"  rwkv step {t}: max|logit diff|={diff:.2e} top-2 margins="
              f"{np.round(margins, 4).tolist()} tokens card={tok.tolist()} "
              f"cpu={cpu_tok.tolist()}")
        if diff > LOGIT_TOL:
            _fail(f"rwkv step {t} logits differ by {diff:.2e}")
        if np.any((tok != cpu_tok) & (margins > LOGIT_TOL)):
            _fail(f"rwkv step {t} tokens differ beyond the margin")
    print(f"rwkv card vs cpu: logits within {LOGIT_TOL:.0e} over {G} steps "
          f"(worst {worst:.2e}), tokens equal where the margin allows")


_PROFILE_CHILD = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
control = torch.zeros(1, dtype=torch.int64, device="cuda")
readings = [{readings}]
for fn, _ in readings:
    fn()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    for fn, calls in readings:
        control.add_(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
names = [e.name for e in sorted((e for e in p.events()
                                 if e.device_type == DeviceType.CUDA),
                                key=lambda e: e.time_range.start)]
out = []
for name in names:
    if name == names[0]:
        out.append([])
    else:
        out[-1].append(name)
print(json.dumps(out))
"""

PROFILE_ATTEMPTS = 3


def device_kernels(*readings: tuple) -> list:
    """For each ``(expr, calls)`` (``expr`` a callable in Python source over
    chip_smoke as ``cs`` and the paged, WKV and scan ops modules), the
    names of the device kernels that ``calls`` warm calls of it run, read
    with ``torch.profiler`` (CUPTI) in one session in a process of its
    own: in this one, after the earlier phases, CUPTI was seen to report
    no device activity at all.  Each reading opens with a control kernel
    (one int64 ``add_`` on the card, synchronized before the calls), the
    session's first device kernel, whose name splits the readings and is
    dropped from them: a session that lacks a control saw nothing (or
    not all), and counts as the profiler's failure, not as a count of
    launches.  Such a process is run again, ``PROFILE_ATTEMPTS`` times in
    all."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        out = subprocess.run(
            [sys.executable, "-c", _PROFILE_CHILD.format(
                src=os.path.join(ROOT, "src"), root=ROOT,
                readings=", ".join(f"({e}, {n})" for e, n in readings))],
            capture_output=True, text=True, timeout=600)
        if out.returncode:
            _fail(f"the profiler's process failed:\n{out.stdout}"
                  f"{out.stderr}")
        got = json.loads(out.stdout.strip().splitlines()[-1])
        if len(got) == len(readings):
            return got
        print(f"profiler process {attempt} of {PROFILE_ATTEMPTS}: "
              f"{len(got)} control kernels seen for {len(readings)} "
              f"readings ({sum(map(len, got))} other device kernels)")
    _fail(f"torch.profiler saw {len(got)} control kernels for "
          f"{len(readings)} readings in each of {PROFILE_ATTEMPTS} processes")


def profiler_readings() -> dict:
    """The device kernels of the three kernels whose launches must each
    be one device kernel, read in one profiler process (``device_kernels``)
    at phase 8: one paged call as the main path makes it (an int64
    cursor, the engine's; an int32 table) over f32 and over int8 pages,
    and three warm calls each of WKV and of the scan (f32) at their main
    paths' prefill shapes."""
    s = PAGED_SHAPE
    B, H, KV, hd, bs, NB = (s[k] for k in ("B", "H", "KV", "hd", "bs", "NB"))
    paged = [(
        "(lambda q, kp, vp, tbl, idx, ks, vs: (lambda c: lambda: "
        "pa_ops.paged_attention(q, kp, vp, tbl, c, k_scales=ks, "
        "v_scales=vs, force='kernel'))(idx.long()))(*cs.paged_case("
        f"{B}, {H}, {KV}, {hd}, {bs}, {NB}, torch.float32, {kv}, "
        f"[{s['cursor']}] * {B}, seed=77, trash_row=False))", 1)
        for kv in PAGED_PROFILE_DTYPES]
    rB, rS, rH, rhd = RWKV_SHAPE
    wkv = ("(lambda a: lambda: wkv_ops.wkv(*a, force='kernel'))(cs.wkv_case("
           f"{rB}, {rS}, {rH}, {rhd}, torch.float32, False, (0.69, 0.9975), "
           "99))", 3)
    jB, jS, jd, jN = JAMBA_SCAN_SHAPE
    scan = ("(lambda c: lambda: scan_ops.selective_scan_with_state(*c[:-1], "
            f"h0=c[-1], force='kernel'))(cs.scan_case({jB}, {jS}, {jd}, "
            f"{jN}, torch.float32, False, 'model', 77))", 3)
    *got_paged, got_wkv, got_scan = device_kernels(*paged, wkv, scan)
    return {"paged": got_paged, "wkv": got_wkv, "scan": got_scan}


def wkv_times(wkv_ops, res, layers, kernels):
    """The kernel, f32 and bf16 r/k/v, L2 flushed, each beside its route's
    bound (its products run on the tensor cores in 3xTF32) and the f32 FMA
    bound, and both plain forms (f32) at the main path's prefill shape
    (CUDA events); the device kernels of three warm calls, ``kernels``
    (``profiler_readings``' "wkv"); then the WKV launches' share of the
    timed prefill."""
    from repro_torch.roofline import torch_cost
    B, S, H, hd = RWKV_SHAPE
    flush = _flusher()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = wkv_case(B, S, H, hd, dtype, False, (0.69, 0.9975), 99)
        ms = _time_device_ms(lambda: wkv_ops.wkv(*args, force="kernel"), 20,
                             flush)
        r, k, v, w, u, s0 = args
        # The function's products, 4 operations per state entry a step
        # (the kernel's chunked form runs them as 3xTF32 products); r, k,
        # v, w, u in, y out, the state in and out.
        work = torch_cost.wkv(B, S, H, hd, itemsize=r.element_size(),
                              u_itemsize=u.element_size())
        flops, nbytes, bound = work.flops, work.bytes, work.bounds()
        name = str(dtype)[6:]
        print(f"wkv kernel at B={B} S={S} H={H} hd={hd} {name} r/k/v, L2 "
              f"flushed: {ms:.4f} ms; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP x3 TF32), "
              f"{ms / bound['bound_ms']:.2f}x; f32 FMA bound "
              f"{bound['f32_bound_ms']:.4f} ms ({bound['f32_bound_by']})")
        out[name] = (ms, bound, args)
    kernel_ms, bound, args = out["float32"]
    print(f"wkv kernel: 3 calls ran {len(kernels)} device kernel(s) "
          f"{sorted(set(kernels))}")
    if len(kernels) != 3:
        _fail(f"3 wkv calls ran {len(kernels)} device kernels: {kernels}")
    chunked_ms = _time_ms(lambda: wkv_ops.wkv(*args, force="chunked"), 3)
    step_ms = _time_ms(lambda: wkv_ops.wkv(*args, force="ref"), 3)
    share = layers * kernel_ms / (res.prefill_s * 1e3)
    print(f"wkv times at B={B} S={S} H={H} hd={hd} f32: kernel "
          f"{kernel_ms:.4f} ms, plain chunked {chunked_ms:.4f} ms, plain "
          f"per-step {step_ms:.4f} ms, library none; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    print(f"rwkv6 prefill {res.prefill_s * 1e3:.1f} ms of which {layers} "
          f"WKV launches ~{layers * kernel_ms:.1f} ms ({100 * share:.1f}%)")
    bf16_ms, bf16_bound, _ = out["bfloat16"]
    return dict(ms=kernel_ms, plain_ms=chunked_ms, library_ms=None, **bound,
                bf16_ms=bf16_ms, bf16_bound_ms=bf16_bound["bound_ms"],
                device_kernels=sorted(set(kernels)),
                device_kernels_per_call=len(kernels) / 3)


# ---------------------------------------------------------------------------
# jamba: the Mamba selective scan, the MoE feed-forward, the hybrid stack
# ---------------------------------------------------------------------------

# dt and -A ranges of the scan grid: decays near 1 (dt * A in [-1e-3,
# -1e-5], the state grows over long S) and large dt * A (down to -80: it
# forgets within a step, and exp underflows to 0).
SCAN_REGIMES = {"near 1": ((0.01, 0.1), (1e-3, 1e-2)),
                "large": ((1.0, 5.0), (1.0, 16.0))}


def scan_case(B, S, d, N, dtype, h0, regime, seed):
    """u, Bm, Cm ~ N(0, 1) and dt in ``dtype``, A float32 by ``regime``
    (``"model"``: dt = softplus(N(0, 1)) and A = -(1..N), as mamba_init
    makes them); D ~ 1 + 0.1 N(0, 1); h0 zero or N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def rand(lo_hi, *shape):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(shape, generator=g, device="cuda")
    u, Bm, Cm = randn(B, S, d), randn(B, S, N), randn(B, S, N)
    if regime == "model":
        dt = torch.nn.functional.softplus(randn(B, S, d))
        A = -torch.arange(1, N + 1, device="cuda",
                          dtype=torch.float32).repeat(d, 1)
    else:
        dts, As = SCAN_REGIMES[regime]
        dt, A = rand(dts, B, S, d), -rand(As, d, N)
    Dp = 1.0 + 0.1 * randn(d)
    state = randn(B, d, N) if h0 else torch.zeros((B, d, N), device="cuda")
    return ([t.to(dtype) for t in (u, dt)] + [A]
            + [t.to(dtype) for t in (Bm, Cm)] + [Dp, state])


def scan_parity_cases() -> list:
    """Phase 18's grid, (B, S, d, N, dtype, h0, regime) an input set, the
    main path's prefill shape last (``tools/kernel_bits_compare.py`` runs
    it too).  At 8192 channels the grid takes B = 1 and S in (1, 64,
    1024) alone (B = 4 and S 63, 1000 there cut for time: the batch is a
    grid dim of its own and the ragged lengths a chunk boundary, each
    taken at every smaller width, and B = 4 at the main path's shape)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(B, S, d, N, dtype, h0, regime)
             for dtype in (f32, bf16) for d in (16, 256, 1000, 8192)
             for N in (4, 16)
             for S in ((1, 63, 64, 1000, 1024) if d < 8192 else (1, 64, 1024))
             for B in ((1, 4) if d < 8192 else (1,))
             for h0 in (False, True) for regime in SCAN_REGIMES]
    # The model's dt and A (the timing inputs' regime) at a few shapes.
    cases += [(B, S, d, 16, dtype, h0, "model")
              for dtype in (f32, bf16) for d in (256, 1000)
              for S in (63, 1024) for B in (1, 4) for h0 in (False, True)]
    B, S, d, N = JAMBA_SCAN_SHAPE
    cases.append((B, S, d, N, f32, False, "model"))
    return cases


def scan_per_step_form(case, last: bool) -> bool:
    """Whether phase 18 holds ``case`` to the per-step plain form as well
    as the chunked one: below S = 1000 always, at S 1000 and 1024 only at
    16 channels and B = 1 and at the main path's shape (``last``).  The
    per-step form runs a step at a time, ~0.17 s a long case on the card,
    and took 38 of the phase's 51 s; the chunked form, held to it in the
    CPU tests, checks every case."""
    B, S, d = case[:3]
    return S < 1000 or (d == 16 and B == 1) or last


def scan_parity(scan_ops) -> float:
    """The scan kernel against its per-step and chunked plain forms over
    the grid (the per-step one where ``scan_per_step_form`` says), with
    and without the final state (y and h_final).  Returns
    the max abs error of y at the main path's prefill shape (f32, zero
    state) against the chunked form, the one the CPU takes there."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = scan_parity_cases()
    B, S, d, N = JAMBA_SCAN_SHAPE
    bad, err, worst, n_step = 0, 0.0, {}, 0
    for n, (B, S, d, N, dtype, h0, regime) in enumerate(cases):
        *args, state = scan_case(B, S, d, N, dtype, h0, regime, 5000 + n)
        forms = (("ref", "chunked") if scan_per_step_form(
            cases[n], n == len(cases) - 1) else ("chunked",))
        n_step += len(forms) == 2
        y, h = scan_ops.selective_scan_with_state(*args, h0=state,
                                                  force="kernel")
        y_only = scan_ops.selective_scan(*args, force="kernel") \
            if not h0 else None
        errs = []
        for form in forms:
            want_y, want_h = scan_ops.selective_scan_with_state(
                *args, h0=state, force=form)
            e = [_rel_floor(y, want_y), _rel_floor(h, want_h)]
            if y_only is not None:
                e[0] = max(e[0], _rel_floor(y_only, want_y))
            errs.append(e)
        torch.cuda.synchronize()
        err = (y.float() - want_y.float()).abs().max().item()
        ey = max(e[0] for e in errs)
        eh = max(e[1] for e in errs)
        ok = (ey <= SCAN_TOL[dtype] and eh <= SCAN_TOL[f32]
              and y.dtype == dtype and h.dtype == f32
              and bool(torch.isfinite(y).all() and torch.isfinite(h).all()))
        bad += not ok
        label = (f"{str(dtype)[6:]:8s} B{B} S{S:<4d} d{d:<4d} N{N:<2d} "
                 f"h0 {'rand' if h0 else 'zero'} dtA {regime}")
        if dtype not in worst or ey > worst[dtype][0]:
            worst[dtype] = (ey, eh, label)
        if not ok:
            print(f"  scan {label} y rel={ey:.2e} h rel={eh:.2e} FAIL")
    for dtype, (ey, eh, label) in worst.items():
        print(f"  scan worst {str(dtype)[6:]}: y rel={ey:.2e} (tol "
              f"{SCAN_TOL[dtype]:.0e}), h rel={eh:.2e} at {label}")
    if bad:
        _fail(f"{bad} of {len(cases)} selective-scan parity cases")
    n_zero = sum(not c[5] for c in cases)
    print(f"scan parity: {len(cases)} input sets ({len(cases) + n_zero} "
          "kernel calls, with and without the final state) within "
          f"tolerance against the chunked plain form, {n_step} of them "
          "against the per-step form too")
    for dtype in (f32, bf16):
        *args, state = scan_case(B, S, d, N, dtype, True, "model", 11)
        first = scan_ops.selective_scan_with_state(*args, h0=state,
                                                   force="kernel")
        if not all(all(torch.equal(a, b) for a, b in zip(
                first, scan_ops.selective_scan_with_state(
                    *args, h0=state, force="kernel"))) for _ in range(3)):
            _fail(f"scan kernel repeats differ ({dtype})")
    print("scan kernel: 3 repeats bit-identical at the main shape, f32 and "
          "bf16 (y and the final state)")
    return err                                   # the last case: main shape


def jamba_main_path(cfglib, registry, ServeEngine):
    """jamba at full width and depth 8: weights drawn on the card from
    seed 0, ``generate`` (warm-up and timed, as ``serve.main``) and one
    ``ModelApi.loss`` forward, with every counter at 0 just before.
    Returns (cfg, engine, timed result, launch counts, peak device
    bytes)."""
    from repro_torch.tree import tree_leaves
    cfg = cfglib.get_config("jamba-v0.1-52b").with_depth(JAMBA_DEPTH)
    api = registry.get_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"jamba init on the card: {time.perf_counter() - t0:.1f} s for "
          f"{n_params} params ({n_params * 4 / 1e9:.2f} GB f32)")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (JAMBA_B, JAMBA_P)).astype(np.int32)
    engine = ServeEngine(cfg, params, device="cuda",
                         max_len=JAMBA_P + JAMBA_G + 1)
    del params
    zero_counts()
    engine.generate(prompts, min(2, JAMBA_G))                  # warm-up
    res = engine.generate(prompts, JAMBA_G, seed=0)
    seq = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (JAMBA_B, JAMBA_P + 1))).long().cuda()
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        loss, parts = api.loss(engine.params, cfg, batch)
    torch.cuda.synchronize()
    loss_ms = (time.perf_counter() - t1) * 1e3
    n_mamba = sum(cfg.layer_kind(i) == "mamba" for i in range(JAMBA_DEPTH))
    n_attn = JAMBA_DEPTH - n_mamba
    counts = expect_counts("jamba main path",
                           selective_scan=3 * n_mamba,
                           flash_attention=3 * n_attn)
    peak = torch.cuda.max_memory_allocated()
    if res.tokens.shape != (JAMBA_B, JAMBA_P + JAMBA_G):
        _fail(f"jamba main path returned tokens {res.tokens.shape}")
    if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
        _fail("jamba main path produced tokens outside the vocabulary")
    if not (torch.isfinite(loss) and torch.isfinite(parts["aux"])):
        _fail(f"jamba loss {loss.item()} aux {parts['aux'].item()}")
    pf = JAMBA_B * JAMBA_P / res.prefill_s
    dec = JAMBA_B * (res.steps - 1) / res.decode_s
    print(f"jamba main path: {counts['selective_scan']} scan launches (2 "
          f"prefills + 1 loss forward x {n_mamba} Mamba layers) and "
          f"{counts['flash_attention']} flash launches, no other kernel")
    print(f"jamba prefill {res.prefill_s * 1e3:.1f} ms ({pf:.1f} tokens/s), "
          f"decode {res.decode_s * 1e3:.1f} ms for {res.steps - 1} steps "
          f"({res.decode_s * 1e3 / (res.steps - 1):.2f} ms per step, "
          f"{dec:.1f} tokens/s); loss forward {loss_ms:.1f} ms (loss "
          f"{loss.item():.4f}, ce {parts['ce'].item():.4f}, aux "
          f"{parts['aux'].item():.4f}); peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; phase {time.perf_counter() - t0:.1f} s")
    print("jamba sample:", res.tokens[0, JAMBA_P:JAMBA_P + 16].tolist())
    return cfg, engine, res, counts, peak


def jamba_card_vs_cpu(cfg, engine, registry):
    """The main path's weights copied to the host: a greedy B=1, P=128,
    ``JAMBA_CPU_TOKENS``-token generation on the card against the CPU's
    prefill (P=128: the
    chunked scan) and plain decode fed the card's tokens, and one B=1 x
    128 loss forward on each.  Logits agree per step within
    ``JAMBA_LOGIT_TOL`` of max(1, max|logit|), tokens wherever the CPU's
    top-2 margin exceeds that, the loss within ``JAMBA_LOSS_TOL``.
    Returns the host copy (phase 29 serves it on the CPU)."""
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    host = tree_map(lambda t: t.detach().cpu(), engine.params)
    print(f"jamba weights to the host: {time.perf_counter() - t0:.1f} s")
    api = registry.get_model(cfg)
    rng = np.random.default_rng(3)
    B, P, G = 1, 128, JAMBA_CPU_TOKENS
    prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    card = engine.generate(prompts, G, return_logits=True)
    toks = torch.from_numpy(card.tokens).long()
    want = []
    with torch.inference_mode():
        cache = tr.lm_init_cache(host, cfg, B, P + G, torch.float32,
                                 device="cpu")
        logits, cache = tr.lm_prefill(host, cfg, toks[:, :P], cache,
                                      last_only=True)
        want.append(logits[:, 0])
        for t in range(1, G):
            logits, cache = tr.lm_decode_step(
                host, cfg, toks[:, P + t - 1:P + t], cache, P + t - 1)
            want.append(logits[:, 0])
    want = torch.stack(want, dim=1).numpy()               # (B, G, V)
    scale = max(1.0, float(np.abs(want).max()))
    worst = 0.0
    for t in range(G):
        rel = float(np.abs(card.logits[:, t] - want[:, t]).max()) / scale
        worst = max(worst, rel)
        top2 = np.sort(want[:, t], axis=-1)[:, -2:]
        margins = top2[:, 1] - top2[:, 0]
        tok, cpu_tok = card.tokens[:, P + t], want[:, t].argmax(-1)
        print(f"  jamba step {t}: logits rel diff={rel:.2e} top-2 margin="
              f"{np.round(margins, 4).tolist()} tokens card={tok.tolist()} "
              f"cpu={cpu_tok.tolist()}")
        if rel > JAMBA_LOGIT_TOL:
            _fail(f"jamba step {t} logits differ by {rel:.2e} relative")
        if np.any((tok != cpu_tok) & (margins > JAMBA_LOGIT_TOL * scale)):
            _fail(f"jamba step {t} tokens differ beyond the margin")
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (B, P + 1))).long()
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    with torch.no_grad():
        card_loss = api.loss(engine.params, cfg,
                             {k: v.cuda() for k, v in batch.items()})[0]
        cpu_loss = api.loss(host, cfg, batch)[0]
    rel_loss = abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    print(f"jamba loss card {card_loss.item():.6f} cpu {cpu_loss.item():.6f}"
          f" rel diff {rel_loss:.2e}")
    if rel_loss > JAMBA_LOSS_TOL:
        _fail(f"jamba loss differs by {rel_loss:.2e} relative")
    print(f"jamba card vs cpu: logits within {JAMBA_LOGIT_TOL:.0e} relative "
          f"over {G} steps (worst {worst:.2e}), tokens equal where the "
          f"margin allows, loss within {JAMBA_LOSS_TOL:.0e}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return host


def jamba_times(scan_ops, fa_ops, res, n_mamba, kernels):
    """The scan kernel and both plain forms at the main path's prefill
    shape (CUDA events), beside the bound; the device kernels of three warm
    calls, ``kernels`` (``profiler_readings``' "scan"); the scan launches'
    share of the timed prefill; and the flash-attention forward at jamba's attention
    shape beside its plain version, SDPA and both bounds.  Returns the
    scan's record and the flash forward's readings there."""
    import re
    from repro_torch.roofline import torch_cost
    B, S, d, N = JAMBA_SCAN_SHAPE
    flush = _flusher()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        *args, state = scan_case(B, S, d, N, dtype, False, "model", 77)
        ms = _time_device_ms(lambda: scan_ops.selective_scan_with_state(
            *args, h0=state, force="kernel"), 20, flush)
        u, dt, A, Bm, Cm, Dp = args
        # Per state update: dt * A, (dt u) * B_n, the update FMA and the y
        # FMA; u, dt, A, B, C, D in, y out, h0 in and h out.
        work = torch_cost.selective_scan(B, S, d, N,
                                         itemsize=u.element_size())
        flops, nbytes, bound = work.flops, work.bytes, work.bound()
        name = str(dtype)[6:]
        print(f"scan kernel at B={B} S={S} d={d} N={N} {name}, L2 flushed: "
              f"{ms:.4f} ms; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP), {ms / bound['bound_ms']:.2f}x")
        out[name] = (ms, bound, args, state)
    kernel_ms, bound, args, state = out["float32"]
    # The SFU's floor if every exp ran there: the busiest SM's share of
    # the CTAs (all resident at once; CPB channels a CTA, as the kernel's
    # source sets it), 16 exps a clock, at the SM clock nvidia-smi reads
    # right after the timing.
    with open(os.path.join(ROOT, "src", "repro_torch", "kernels", "mamba_scan",
                           "csrc", "selective_scan.cu")) as f:
        cpb = int(re.search(r"constexpr int CPB = (\d+);", f.read()).group(1))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = -(-d // cpb) * B
    busiest = -(-ctas // n_sm) * cpb * S * N
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split(",")
    sm_mhz, max_mhz = (float(c) for c in clocks[:2])
    sfu_ms = busiest / 16 / (sm_mhz * 1e6) * 1e3
    print(f"scan SFU floor: {busiest / 1e6:.2f} M exps on the busiest SM "
          f"({ctas} CTAs on {n_sm} SMs) / 16 a clock at {sm_mhz:.0f} MHz "
          f"(clocks.sm; max {max_mhz:.0f}) = {sfu_ms:.4f} ms, beside the "
          f"byte bound {bound['bound_ms']:.4f} ms")
    print(f"scan kernel: 3 calls ran {len(kernels)} device kernel(s) "
          f"{sorted(set(kernels))}")
    if len(kernels) != 3:
        _fail(f"3 scan calls ran {len(kernels)} device kernels: {kernels}")
    chunked_ms = _time_ms(lambda: scan_ops.selective_scan_with_state(
        *args, h0=state, force="chunked"), 3)
    step_ms = _time_ms(lambda: scan_ops.selective_scan_with_state(
        *args, h0=state, force="ref"), 2)
    share = n_mamba * kernel_ms / (res.prefill_s * 1e3)
    print(f"scan times at B={B} S={S} d={d} N={N} f32: kernel "
          f"{kernel_ms:.4f} ms, plain chunked {chunked_ms:.4f} ms, plain "
          f"per-step {step_ms:.4f} ms, library none; bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
          f"{B * S * d * N / 1e6:.0f} M exps)")
    print(f"jamba prefill {res.prefill_s * 1e3:.1f} ms of which {n_mamba} "
          f"scan launches ~{n_mamba * kernel_ms:.2f} ms "
          f"({100 * share:.2f}%)")
    H, KV, hd = 32, 8, 128
    q, k, v = _inputs(JAMBA_B, JAMBA_P, H, KV, hd, torch.float32, 4321)
    fa_ms = _time_ms(lambda: fa_ops.flash_attention(q, k, v, force="kernel"),
                     50)
    fa_plain = _time_ms(lambda: fa_ops.flash_attention(q, k, v, force="ref"),
                        10)
    sdpa, backend = sdpa_yardstick(q, k, v)
    fa_lib = sdpa(_time_ms, 50)
    fa_bound = torch_cost.flash_attention(JAMBA_B, JAMBA_P, JAMBA_P, H, KV,
                                          hd).bounds()
    print(f"flash at jamba's B={JAMBA_B} S={JAMBA_P} H={H}/{KV} hd={hd} "
          f"causal f32: kernel {fa_ms:.4f} ms, plain {fa_plain:.4f} ms, sdpa "
          f"({backend}) {fa_lib:.4f} ms; bound {fa_bound['bound_ms']:.4f} ms "
          f"({fa_bound['bound_by']}), f32 FMA bound "
          f"{fa_bound['f32_bound_ms']:.4f} ms")
    fa = dict(jamba_ms=fa_ms, jamba_plain_ms=fa_plain,
              jamba_library_ms=fa_lib, jamba_library_backend=backend,
              jamba_bound_ms=fa_bound["bound_ms"],
              jamba_f32_bound_ms=fa_bound["f32_bound_ms"])
    bf16_ms, bf16_bound, _, _ = out["bfloat16"]
    return dict(ms=kernel_ms, plain_ms=chunked_ms, library_ms=None, **bound,
                bf16_ms=bf16_ms, bf16_bound_ms=bf16_bound["bound_ms"],
                sfu_floor_ms=sfu_ms, device_kernels=sorted(set(kernels)),
                device_kernels_per_call=len(kernels) / 3), fa


# Phase 22: self-speculative decoding over phase 6's traffic, the draft the
# served model's first SPEC_DEPTH layers proposing SPEC_GAMMA tokens a round.
SPEC_DEPTH, SPEC_GAMMA = 2, 4
# The speculative prefix-cache run over int8 pages serves 16 requests
# drawn as phase 6 draws its 32 (cut to make room for phase 43's
# continuous serving; the hits and counts are derived from its own).
SPEC_PREFIX_REQUESTS = 16
SPEC_ARGV = ["--spec-depth", str(SPEC_DEPTH), "--gamma", str(SPEC_GAMMA)]
# The paper's draft (a copying_zeroL expansion truncated to its source
# depth) proposes what the target emits; on the card the draft's decode and
# the target's verify sum in other orders, so only near-ties flip an argmax.
SPEC_ZEROL_ACCEPTANCE = 0.99
# Phase 22's draft of gpt2-12l: a one-layer source expanded to this many
# layers (cut from 12 to make room for phases 40-43: the acceptance does
# not depend on the depth, the run's time does).
GPT2_ZEROL_DEPTH = 3
# A spec stream may leave phase 6's f32 stream only where the target's
# top-2 logit gap at the first differing position is below this: the
# verify's gathered f32 context and the decode kernel sum in other orders
# (~1e-6 apart, LOGIT_TOL's lane), and a gap that small flips the argmax.
SPEC_TIE_GAP = 1e-4


def spec_main_path(cfg, serve, fa_ops, extra=()):
    """``serve.main(PAGED_ARGV + SPEC_ARGV + extra)`` with every launch
    counter at 0 just before: every request at its budget, the pool
    returned, flash attention launched once per draft layer per admission
    (the draft's B=1 prefill) and no other kernel (spec rounds replace the
    masked decode; the verify's attention is the plain gather).  Returns
    (the results, the scheduler, the ``summarize`` record, launches)."""
    argv = PAGED_ARGV + SPEC_ARGV + list(extra)
    label = "spec main path" + (f" {' '.join(extra)}" if extra else "")
    results, sched, stats, calls = _serve_counted(serve, argv,
                                                  ("admit_paged",))
    admitted = calls["admit_paged"]
    launches = expect_counts(label, flash_attention=SPEC_DEPTH * admitted)[
        "flash_attention"]
    if admitted == 0:
        _fail(f"{label} admitted nothing")
    lens, gens = _drawn_requests(cfg, argv)
    pinned = _check_served(label, cfg, lens, gens, results, sched)
    ss = sched.spec_stats()
    mal = float(np.mean([r.mean_accepted_len for r in results]))
    print(f"{label}: {len(lens)} requests at their budgets, pool returned "
          f"(+{pinned} pinned by the radix tree), {launches} flash launches "
          f"= {admitted} admissions x {SPEC_DEPTH} draft layers, 0 paged; "
          f"{ss['spec_rounds']} rounds, acceptance "
          f"{ss['acceptance_rate']:.4f}, mean accepted length {mal:.4f}, "
          f"aggregate tokens/s {stats['tokens_per_s']:.1f}")
    return results, sched, stats, launches


def spec_zerol(cfglib, registry, arch="gpt2-12l", depth=None):
    """The paper's draft on the card: a random one-layer ``arch`` expanded
    by ``copying_zeroL`` to ``depth`` layers (default: its full depth),
    served over phase 6's lengths and budgets with its depth-1 truncation
    as the draft, every counter at 0 just before: acceptance at least
    ``SPEC_ZEROL_ACCEPTANCE``, one flash launch per admission (the draft's
    prefill), or for ``rwkv6-7b`` one WKV launch per admission and one per
    target layer per prefill chunk."""
    from repro_torch.core import expansion
    from repro_torch.train.serve_engine import ServeEngine
    from repro_torch.train.serve_scheduler import ContinuousScheduler, Request
    cfg = cfglib.get_config(arch)
    if depth is not None:
        cfg = cfg.with_depth(depth)
    cfg1 = cfg.with_depth(1)
    p1 = registry.get_model(cfg1).init(torch.Generator().manual_seed(0),
                                       cfg1, device="cpu")
    p12 = expansion.expand_params(p1, cfg1, cfg.num_layers, "copying_zeroL")
    lens, gens = _drawn_requests(cfg, PAGED_ARGV)
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        (int(p),)).astype(np.int32),
                    max_new_tokens=int(g)) for p, g in zip(lens, gens)]
    eng = ServeEngine(cfg, p12, device="cuda", max_len=int(max(lens + gens)),
                      paged=True, block_size=16, spec_decode=True,
                      gamma=SPEC_GAMMA, draft_depth=1)
    sched = ContinuousScheduler(eng, max_batch=8)
    zero_counts()
    t0 = time.perf_counter()
    results = sched.run(reqs)
    wall = time.perf_counter() - t0
    if cfg.layer_kind(0) == "rwkv":
        counts = expect_counts("zeroL spec", wkv=len(reqs) + cfg.num_layers
                               * sum(len(_prefill_chunks(int(p), 16))
                                     for p in lens))
    else:
        counts = expect_counts("zeroL spec", flash_attention=len(reqs))
    _check_served("zeroL spec", cfg, lens, gens, results, sched)
    rate = sched.acceptance_rate
    mal = float(np.mean([r.mean_accepted_len for r in results]))
    print(f"zeroL spec {cfg.name}: 1 -> {cfg.num_layers} layers "
          f"(copying_zeroL), draft "
          f"depth 1, gamma {SPEC_GAMMA}: {len(reqs)} requests at their "
          f"budgets, {sched.spec_rounds} rounds, acceptance {rate:.4f} "
          f"({sched.spec_accepted}/{sched.spec_proposed}; bar "
          f"{SPEC_ZEROL_ACCEPTANCE}), mean accepted length {mal:.4f}, "
          f"{sum(len(r.new_tokens) for r in results) / wall:.1f} tokens/s "
          "(no warm-up)")
    if rate < SPEC_ZEROL_ACCEPTANCE:
        _fail(f"zeroL draft acceptance {rate:.4f} < {SPEC_ZEROL_ACCEPTANCE}")
    return rate, counts


def streams_vs(label, cfg, registry, got, want, params) -> int:
    """Each stream of ``got`` against ``want``'s of the same request: equal
    (a stream cut short by a fault or a deadline: equal to the first
    tokens of ``want``'s), or first different where the target's top-2
    logit gap (a solo forward with ``params`` on the card over the prompt
    and the common prefix) is below ``SPEC_TIE_GAP``.  Returns how many
    streams are exactly equal."""
    api = registry.get_model(cfg)
    equal = 0
    for a, b in zip(got, want, strict=True):
        if a.uid != b.uid or not np.array_equal(a.prompt, b.prompt):
            _fail(f"{label}: request {a.uid} is not request {b.uid}")
        n = len(a.new_tokens)
        if n > len(b.new_tokens) or (a.completed
                                      and n != len(b.new_tokens)):
            _fail(f"{label}, request {a.uid}: {n} tokens "
                  f"({a.finish_reason}) against {len(b.new_tokens)}")
        ref = b.new_tokens[:n]
        if np.array_equal(a.new_tokens, ref):
            equal += 1
            continue
        t = int(np.argmax(a.new_tokens != ref))
        ctx = np.concatenate([a.prompt, a.new_tokens[:t]])
        with torch.inference_mode():
            logits, _ = api.apply(params, cfg, torch.from_numpy(
                ctx[None]).long().cuda())
        top2 = torch.topk(logits[0, -1].float(), 2).values
        gap = float(top2[0] - top2[1])
        print(f"  {label}, request {a.uid}: first differs at token {t} "
              f"({a.new_tokens[t]} against {ref[t]}), top-2 gap {gap:.3e}")
        if gap >= SPEC_TIE_GAP:
            _fail(f"{label}, request {a.uid} leaves the stream at token {t} "
                  f"with a top-2 gap {gap:.3e} >= {SPEC_TIE_GAP:.0e}")
    print(f"{label}: {equal} of {len(got)} streams equal, the rest first "
          f"different at a near-tie (gap < {SPEC_TIE_GAP:.0e})")
    return equal


def spec_vs_plain(cfg, registry, spec, plain, engine) -> int:
    """Each spec stream against phase 6's f32 stream of the same request
    (``streams_vs``).  Returns how many streams differ."""
    return len(spec) - streams_vs("spec vs plain on the card", cfg,
                                  registry, spec, plain, engine.params)


# Phases 23-26: the RoPE architectures at full width, random weights from
# seed 0 in f32.  llama3-0.3b trains with the launcher's defaults, one
# layer to 24 at half of 12 steps; mixtral-0.3b through one expansion in 6.
# Phases 24-26 serve phase 6's traffic at these depths (cut from 24, 24
# and 30 to make room for phases 36-43: each layer adds the same
# host-bound step work, and starcoder2's weights are drawn on the host).
SERVE_CUT = {"qwen3-0.3b": 4, "mixtral-0.3b": 2, "starcoder2-3b": 2}
# The paper's draft over qwen3-0.3b: a one-layer source expanded to this
# many layers (cut from 24 to make room for phases 36-42: the acceptance
# does not depend on the depth, the run's time does).
QWEN3_ZEROL_DEPTH = 3
MIXTRAL_TRAIN_ARGV = TRAIN_ARGV[:TRAIN_ARGV.index("--steps")] + [
    "--steps", "6"] + TRAIN_ARGV[TRAIN_ARGV.index("--steps") + 2:]


def rope_train_path(cfglib, train, arch, argv=TRAIN_ARGV):
    """``train.main`` for ``arch`` (``train_main_path``: the expansion, the
    losses, the checkpoints, every kernel's launches against the count the
    run implies), then the Newton–Schulz chain's launches named by leaf
    kind.  Returns (result, {kernel: launches})."""
    cfg = cfglib.get_config(arch)
    with tempfile.TemporaryDirectory() as tmp:
        res, counts = train_main_path(cfg, train, os.path.join(tmp, "run"),
                                      argv)
    fused, large = _ns_launches(cfg)
    print(f"  {arch}: flash forward and backward at G = "
          f"{cfg.num_heads // cfg.num_kv_heads}, hd {cfg.head_dim}; at "
          f"{cfg.num_layers} layers one Muon update is {fused} ns_fused "
          f"chains (stacked leaves"
          + (", expert stacks and routers" if cfg.moe else "")
          + f") and {large} GEMMs (the large-route embedding"
          + ("" if cfg.tie_embeddings else " and head") + ")")
    return res, counts


def rope_serve_paths(cfglib, registry, serve, fa_ops, pa_ops, arch,
                     int8=False, depth=None):
    """Phase 6's traffic for ``arch`` over f32 pages (and, with ``int8``,
    over int8 pages), counters from 0 before each run; at ``depth`` layers
    where given (``serve.main`` then draws the model at that depth).
    Returns (the f32 run's paged launches, its ``summarize`` record, the
    int8 run's launches or None)."""
    cfg = cfglib.get_config(arch)
    if depth is not None:
        cfg = cfg.with_depth(depth)
    saved = serve.cfglib
    serve.cfglib = types.SimpleNamespace(**{
        **vars(saved), "get_config": lambda name: cfg if name == arch
        else saved.get_config(name)})
    try:
        launches, _, _, _, stats = paged_main_path(cfg, serve, fa_ops,
                                                   pa_ops)
        q_launches = None
        if int8:
            q_launches = paged_main_path(cfg, serve, fa_ops, pa_ops,
                                         ("--kv-dtype", "int8"))[0]
    finally:
        serve.cfglib = saved
    print(f"  {arch} at {cfg.num_layers} layers: paged kernel at G = "
          f"{cfg.num_heads // cfg.num_kv_heads}, hd {cfg.head_dim}; "
          f"aggregate tokens/s {stats['tokens_per_s']:.1f} (f32 pages)")
    return launches, stats, q_launches


# ---------------------------------------------------------------------------
# Phases 27-29: recurrent carries in continuous serving (rwkv6-7b, jamba)
# ---------------------------------------------------------------------------

RWKV_PAGED_ARGV = _with_arch(PAGED_ARGV, "rwkv6-7b")
# The paper's draft over rwkv6-7b: a one-layer source expanded to this many
# layers (cut from 32: the acceptance does not depend on the depth, the
# run's time does).
RWKV_ZEROL_DEPTH = 4
# Phase 27 serves the first 2 of phase 15's 32 layers (cut from 32 to make
# room for phases 40-43, and from 4 for phase 44: each layer adds the same
# host-bound chunk and step work; the full depth's prefill and decode stay
# phase 15's).
RWKV_CONT_DEPTH = 2
RWKV_SPEC_REQUESTS = 8
PAGE = 16                           # --block-size of every paged run here


def _pow2(n: int) -> list:
    """The binary decomposition of n, largest power of two first (this
    script's own copy, so the launch checks do not take their counts from
    the code under check)."""
    out = []
    while n:
        out.append(1 << (n.bit_length() - 1))
        n -= out[-1]
    return out


def _prefill_chunks(P: int, bs: int, prefix_cache=False, skip=0) -> list:
    """Chunk widths of a P-token prompt's paged prefill (no --chunk-len
    cap) from ``skip`` tokens on.  With the prefix cache a recurrent
    model's prefill is cut at the last page boundary at or below P - 1,
    where its carry is snapshot."""
    snap = (P - 1) // bs * bs if prefix_cache else 0
    if snap > skip:
        return _pow2(snap - skip) + _pow2(P - snap)
    return _pow2(P - skip)


def _run_counted(label, eng, reqs, max_batch=8, warmup=False):
    """``ContinuousScheduler(eng).run(reqs)`` with every launch counter at
    0 just before (and before ``warmup(reqs)`` where ``warmup``, as
    ``serve.main`` warms up) and the engine's masked decode steps counted.
    Returns (results, scheduler, summarize record, decode steps, peak
    bytes)."""
    from repro_torch.train.serve_scheduler import (ContinuousScheduler,
                                                   summarize)
    steps = [0]
    decode = eng.decode_masked

    def counted(*a, **kw):
        steps[0] += 1
        return decode(*a, **kw)
    eng.decode_masked = counted
    sched = ContinuousScheduler(eng, max_batch=max_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    if warmup:
        sched.warmup(reqs)
    t0 = time.perf_counter()
    results = sched.run(reqs)
    torch.cuda.synchronize()
    stats = summarize(results, time.perf_counter() - t0)
    print(f"  {label}: {stats['generated_tokens']} tokens, aggregate "
          f"tokens/s {stats['tokens_per_s']:.1f}, ttft p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return results, sched, stats, steps[0], torch.cuda.max_memory_allocated()


def _requests_of(traffic):
    from repro_torch.train.serve_scheduler import Request
    return [Request(prompt=p, max_new_tokens=g) for p, g in traffic]


def rwkv_continuous_paths(cfglib, registry, params):
    """Phase 27: ``rwkv6-7b`` at full width and ``RWKV_CONT_DEPTH`` layers
    over phase 6's traffic, on the first layers of phase 15's weights
    ``params`` (views, no copy).  ``RWKV_PAGED_ARGV``'s run
    through the engine and scheduler ``serve.main --continuous --paged``
    builds (warm-up and run) first, then on the same weights the prefix
    cache, ``--spec-depth 2 --gamma 4`` and the paper's draft, counters
    from 0 before each run and the WKV launches checked against the
    chunks this script derives from the requests.  Returns {run: WKV
    launches}."""
    from repro_torch.train.serve_engine import ServeEngine
    from repro_torch.tree import tree_map
    cfg = cfglib.get_config("rwkv6-7b").with_depth(RWKV_CONT_DEPTH)
    params = dict(params, blocks=tree_map(lambda t: t[:RWKV_CONT_DEPTH],
                                          params["blocks"]))
    L = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {}
    # (a) as the CLI serves it: the warm-up serves each prompt length once,
    # then the run
    traffic = _drawn_traffic(cfg, RWKV_PAGED_ARGV)
    arg = {k: int(v) for k, v in zip(RWKV_PAGED_ARGV, RWKV_PAGED_ARGV[1:])
           if k in ("--prompt-len", "--gen", "--max-batch")}
    eng = ServeEngine(cfg, params, device="cuda",
                      max_len=arg["--prompt-len"] + arg["--gen"] + 1,
                      paged=True, block_size=PAGE)
    results, sched, stats, _, _ = _run_counted(
        "rwkv6-7b paged", eng, _requests_of(traffic),
        max_batch=arg["--max-batch"], warmup=True)
    del eng
    lens = [len(p) for p, _ in traffic]
    _check_served("rwkv6-7b paged", cfg, lens, [g for _, g in traffic],
                  results, sched)
    chunks = sum(len(_pow2(P)) for P in set(lens)) \
        + sum(len(_pow2(P)) for P in lens)
    out["paged"] = expect_counts("rwkv6-7b paged main path",
                                 wkv=chunks * L)["wkv"]
    ks = sched.kv_stats()
    print(f"rwkv6-7b paged main path: {len(lens)} requests at their budgets, "
          f"pool returned; {out['paged']} WKV launches = {chunks} prefill "
          f"chunks (warm-up included) x {L} layers, no other kernel; "
          f"aggregate tokens/s {stats['tokens_per_s']:.1f}, ttft p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; kv storage "
          f"{ks['kv_bytes_per_token']} bytes a token (ratio "
          f"{ks['kv_bytes_ratio']}); {time.perf_counter() - t0:.1f} s")
    max_len = sched.engine.max_len
    del sched
    # (b) the prefix cache over the shared-prefix traffic, the last eight
    # requests sent again: a repeat hits at its publisher's snapshot
    ptraffic = _drawn_traffic(cfg, RWKV_PAGED_ARGV + ["--prefix-cache"])
    ptraffic = ptraffic + ptraffic[-8:]
    eng = ServeEngine(cfg, params, device="cuda",
                      max_len=max(len(p) + g for p, g in ptraffic) + 1,
                      paged=True, block_size=PAGE, prefix_cache=True)
    pres, psched, _, _, _ = _run_counted("rwkv6-7b prefix cache", eng,
                                         _requests_of(ptraffic))
    plens = [len(p) for p, _ in ptraffic]
    _check_served("rwkv6-7b prefix cache", cfg, plens,
                  [g for _, g in ptraffic], pres, psched)
    pchunks = 0
    for r in pres:
        # A hit restores a snapshot: a page boundary at or below P - 1.
        P, skip = len(r.prompt), r.prefix_tokens
        if skip % PAGE or skip > (P - 1) // PAGE * PAGE:
            _fail(f"prefix request {r.uid} (P={P}) skipped {skip} tokens, "
                  "not a snapshot boundary below P")
        pchunks += len(_prefill_chunks(P, PAGE, True, skip))
    out["prefix"] = expect_counts("rwkv6-7b prefix cache",
                                  wkv=pchunks * L)["wkv"]
    hits = [r for r in pres if r.prefix_tokens]
    if not hits:
        _fail(f"the rwkv6-7b prefix-cache run had no hit: "
              f"{psched.prefix_stats()}")
    for r in pres[len(ptraffic) - 8:]:
        # A repeat runs cold or from its own first run's snapshot: the same
        # chunk edges as that run, so the same bits.
        first = pres[r.uid - 8]
        if r.prefix_tokens not in (0, (len(r.prompt) - 1) // PAGE * PAGE):
            _fail(f"prefix request {r.uid} hit at {r.prefix_tokens} tokens, "
                  "not at its first run's snapshot")
        if not np.array_equal(r.tokens, first.tokens):
            _fail(f"prefix request {r.uid} ({r.prefix_tokens} tokens from "
                  f"the cache) differs from its cold run {first.uid}")
    print(f"rwkv6-7b prefix cache: hits {len(hits)}/{len(pres)} at the "
          f"snapshot boundary, {psched.prefix_skipped_tokens} prompt tokens "
          f"skipped, every repeat's stream equal to its cold run's; "
          f"{out['prefix']} WKV launches = {pchunks} chunks x {L}")
    del eng, psched
    # (c) --spec-depth 2 --gamma 4 over the first RWKV_SPEC_REQUESTS of
    # (a)'s requests (a round replays the target's γ+1 decode steps, so
    # the whole traffic took a minute of the script's time limit)
    eng = ServeEngine(cfg, params, device="cuda", max_len=max_len,
                      paged=True, block_size=PAGE, spec_decode=True,
                      gamma=SPEC_GAMMA, draft_depth=SPEC_DEPTH)
    n = RWKV_SPEC_REQUESTS
    reqs = _requests_of([(r.prompt, len(r.new_tokens))
                         for r in results[:n]])
    sres, ssched, _, _, _ = _run_counted("rwkv6-7b spec", eng, reqs)
    _check_served("rwkv6-7b spec", cfg, lens[:n], [g for _, g in traffic][:n],
                  sres, ssched)
    schunks = sum(len(_pow2(P)) for P in lens[:n])
    out["spec"] = expect_counts(
        "rwkv6-7b spec", wkv=schunks * L + SPEC_DEPTH * len(reqs))["wkv"]
    mal = float(np.mean([r.mean_accepted_len for r in sres]))
    print(f"rwkv6-7b spec: {ssched.spec_rounds} rounds, acceptance "
          f"{ssched.acceptance_rate:.4f}, mean accepted length {mal:.4f}; "
          f"{out['spec']} WKV launches = {schunks} chunks x {L} + "
          f"{len(reqs)} draft prefills x {SPEC_DEPTH}")
    spec_vs_plain(cfg, registry, sres, results[:n], eng)
    del eng, ssched
    # (d) the paper's draft
    _, counts = spec_zerol(cfglib, registry, "rwkv6-7b", RWKV_ZEROL_DEPTH)
    out["zeroL"] = counts["wkv"]
    print(f"rwkv6-7b continuous phase {time.perf_counter() - t0:.1f} s")
    return out


def jamba_continuous_paths(cfg, engine):
    """Phase 28: jamba at full width and depth 8 on phase 19's weights
    over the first ``JAMBA_CONT_REQUESTS`` of phase 6's requests through
    ``ContinuousScheduler``: paged over f32
    and int8 pages, contiguous, and speculative with the zero-layer draft.
    Counters from 0 before each run, checked against counts derived from
    the requests: the scan once per Mamba layer per prefill chunk (paged)
    or per admission (contiguous), the paged kernel once per attention
    layer per masked decode step, flash once per attention layer per
    contiguous admission.  Returns {run: launch counts}."""
    from repro_torch.train.serve_engine import ServeEngine
    t0 = time.perf_counter()
    n_mamba = sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.num_layers))
    n_attn = cfg.num_layers - n_mamba
    traffic = _drawn_traffic(cfg, PAGED_ARGV)[:JAMBA_CONT_REQUESTS]
    lens, gens = [len(p) for p, _ in traffic], [g for _, g in traffic]
    chunks = sum(len(_pow2(P)) for P in lens)
    max_len = max(P + g for P, g in zip(lens, gens)) + 1
    out = {}
    for run, kw in (("paged f32", dict(paged=True)),
                    ("paged int8", dict(paged=True, kv_dtype="int8")),
                    ("contiguous", dict()),
                    ("zero-layer draft", dict(paged=True, spec_decode=True,
                                              gamma=SPEC_GAMMA,
                                              draft_depth=0))):
        eng = ServeEngine(cfg, engine.params, device="cuda", max_len=max_len,
                          block_size=PAGE, **kw)
        label = f"jamba {run}"
        res, sched, _, steps, _ = _run_counted(label, eng,
                                               _requests_of(traffic))
        if "paged" in kw:
            _check_served(label, cfg, lens, gens, res, sched)
        elif [len(r.new_tokens) for r in res] != gens:
            _fail(f"{label}: budgets not met")
        if run.startswith("paged"):
            want = dict(selective_scan=chunks * n_mamba,
                        paged_attention=steps * n_attn)
        elif run == "contiguous":
            want = dict(selective_scan=len(lens) * n_mamba,
                        flash_attention=len(lens) * n_attn)
        else:
            want = dict(selective_scan=chunks * n_mamba)
        if run.startswith("paged") and steps == 0:
            _fail(f"{label}: no masked decode step")
        out[run] = expect_counts(label, **want)
        extra = ""
        if run == "zero-layer draft":
            mal = float(np.mean([r.mean_accepted_len for r in res]))
            extra = (f"; {sched.spec_rounds} rounds, acceptance "
                     f"{sched.acceptance_rate:.4f}, mean accepted length "
                     f"{mal:.4f}")
        if run == "paged int8":
            extra = f"; kv storage {sched.kv_stats()}"
        print(f"  {label}: launches {out[run]} ({chunks} prefill chunks, "
              f"{len(lens)} admissions, {steps} masked decode steps){extra}")
        del eng, sched
    print(f"jamba continuous phase {time.perf_counter() - t0:.1f} s")
    return out


def _served_logits_cpu(cfg, params, prompt, new_tokens, chunks):
    """The port's plain CPU serving path fed the card's tokens: a B=1 paged
    cache, ``lm_prefill_chunk`` over ``chunks`` (the carry admitted into the
    cache as the paged admission does), then one decode step a token.
    Returns the logits that picked each new token, (G, V)."""
    from repro_torch.models import transformer as tr
    P, G = len(prompt), len(new_tokens)
    nb = -(-(P + G) // PAGE)
    table = torch.arange(nb, dtype=torch.int32)[None, :]
    toks = torch.from_numpy(np.concatenate([prompt, new_tokens])).long()[None]
    out = []
    with torch.inference_mode():
        cache = tr.lm_init_paged_cache(params, cfg, 1, nb, PAGE, P + G,
                                       torch.float32, device="cpu")
        carry = tr.lm_init_prefill_carry(params, cfg, P + G, torch.float32,
                                         device="cpu")
        ctx = 0
        for C in chunks:
            logits, cache, carry = tr.lm_prefill_chunk(
                params, cfg, toks[:, ctx:ctx + C], cache, carry, table, ctx)
            ctx += C
        out.append(logits[0, 0])
        for ln, lc in carry.items():
            for key, t in lc.items():
                cache[ln][key].copy_(t)
        for t in range(1, G):
            logits, cache = tr.lm_decode_step(
                params, cfg, toks[:, P + t - 1:P + t], cache, P + t - 1,
                block_table=table)
            out.append(logits[0, 0])
    return torch.stack(out).numpy()


def _stream_vs_cpu(label, cfg, params, res, chunks, tol, relative=False):
    """Each card token against the CPU's argmax fed the same tokens: equal
    wherever the CPU's top-2 margin exceeds ``tol`` (with ``relative``,
    ``tol`` times max(1, max|logit|)).  Returns the smallest margin seen."""
    want = _served_logits_cpu(cfg, params, res.prompt, res.new_tokens,
                              chunks)
    if relative:
        tol = tol * max(1.0, float(np.abs(want).max()))
    worst = np.inf
    for t, row in enumerate(want):
        top2 = np.sort(row)[-2:]
        margin = float(top2[1] - top2[0])
        tok, cpu_tok = int(res.new_tokens[t]), int(np.argmax(row))
        if tok != cpu_tok and margin > tol:
            _fail(f"{label} request {res.uid} step {t}: card {tok} cpu "
                  f"{cpu_tok}, top-2 margin {margin:.4f}")
        worst = min(worst, margin)
    print(f"  {label} request {res.uid}: P={len(res.prompt)} prefix "
          f"{res.prefix_tokens} tokens {res.new_tokens.tolist()} equal the "
          f"CPU argmax (smallest margin {worst:.4f})")
    return worst


def rwkv_paged_card_vs_cpu(cfglib, registry):
    """Phase 29, ``rwkv6-7b`` at full width and depth 2: three requests
    (prompts 100, 37, 128; 8 tokens; 2 slots; pages of 16) and a repeat of
    the first, which hits the prefix cache, through the paged scheduler on
    the card, each stream held against the port's plain CPU serving path
    fed the same tokens over the same chunks."""
    from repro_torch.train.serve_engine import ServeEngine
    from repro_torch.train.serve_scheduler import ContinuousScheduler, Request
    t0 = time.perf_counter()
    cfg = cfglib.get_config("rwkv6-7b").with_depth(2)
    params = registry.get_model(cfg).init(torch.Generator().manual_seed(0),
                                          cfg, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (P,)).astype(np.int32)
               for P in (100, 37, 128)]
    reqs = [Request(prompt=p, max_new_tokens=8) for p in prompts + prompts[:1]]
    eng = ServeEngine(cfg, params, device="cuda", max_len=128 + 8 + 1,
                      paged=True, block_size=PAGE, prefix_cache=True)
    res = ContinuousScheduler(eng, max_batch=2, num_blocks=48).run(reqs)
    if [r.prefix_tokens for r in res] != [0, 0, 0, 96]:
        _fail(f"rwkv card vs cpu: prefix tokens "
              f"{[r.prefix_tokens for r in res]}, expected [0, 0, 0, 96]")
    if not np.array_equal(res[3].tokens, res[0].tokens):
        _fail("rwkv card vs cpu: the prefix hit differs from its cold run")
    worst = min(_stream_vs_cpu("rwkv6-7b paged", cfg, params, r,
                               _prefill_chunks(len(r.prompt), PAGE, True),
                               LOGIT_TOL) for r in res)
    print(f"rwkv paged card vs cpu ({cfg.num_layers} layers): 4 requests x 8 "
          f"tokens equal where the margin allows (smallest {worst:.4f}), the "
          f"hit equal to its cold run; {time.perf_counter() - t0:.1f} s")


def jamba_paged_card_vs_cpu(cfg, engine, host):
    """Phase 29, jamba at full width and depth 8: three short requests
    (prompts 64, 37, 20; ``JAMBA_PAGED_CPU_TOKENS`` tokens; 2 slots; pages
    of 16) through the paged
    scheduler on the card against the CPU's serving path over the same
    chunks (``host``: phase 19's weights on the host), tokens equal where
    the CPU's top-2 margin exceeds ``JAMBA_LOGIT_TOL`` of max(1,
    max|logit|)."""
    from repro_torch.train.serve_engine import ServeEngine
    from repro_torch.train.serve_scheduler import ContinuousScheduler, Request
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        (P,)).astype(np.int32),
                    max_new_tokens=JAMBA_PAGED_CPU_TOKENS)
            for P in (64, 37, 20)]
    eng = ServeEngine(cfg, engine.params, device="cuda",
                      max_len=64 + JAMBA_PAGED_CPU_TOKENS + 1, paged=True,
                      block_size=PAGE)
    res = ContinuousScheduler(eng, max_batch=2).run(reqs)
    worst = min(_stream_vs_cpu("jamba paged", cfg, host, r,
                               _pow2(len(r.prompt)),
                               JAMBA_LOGIT_TOL, relative=True) for r in res)
    print(f"jamba paged card vs cpu: 3 requests x {JAMBA_PAGED_CPU_TOKENS} "
          f"tokens equal where the "
          f"margin allows (smallest {worst:.4f}); "
          f"{time.perf_counter() - t0:.1f} s")


# Phase 30: fault tolerance in serving over phase 6's traffic.  A seeded
# storm (2% of the site hits fault, 2 retries); a tape that faults each
# serving site once, late enough that the radix tree is warm (pool.evict
# fires only under pool pressure, which phase 6's full provisioning never
# makes: the CPU tests fault it); a crash at a scheduler iteration
# boundary, restored on a fresh engine; a bounded queue and a deadline.
FAULT_STORM = "storm:0.02:0"
FAULT_TAPE = ("pool.alloc:40,radix.match:10,radix.publish:10,"
              "engine.prefill_chunk:30,engine.decode:50,"
              "engine.table_upload:5")
CRASH_ITER, RWKV_CRASH_ITER = 60, 25
QUEUE_LIMIT, DEADLINE_S = 8, 1e-3


def _engine_calls(eng, names):
    """Count ``eng``'s calls of each method in ``names`` where it returns,
    and time each with the card synchronized before and after (seconds
    under ``names[i] + '_s'``)."""
    calls = {}
    for name in names:
        calls[name], calls[name + "_s"] = 0, 0.0
        method = getattr(eng, name)

        def counted(*a, _m=method, _n=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _m(*a, **kw)
            torch.cuda.synchronize()
            calls[_n + "_s"] += time.perf_counter() - t0
            calls[_n] += 1
            return out
        setattr(eng, name, counted)
    return calls


def _crash_and_restore(label, cfg, params, reqs, crash_iter, max_len):
    """``reqs`` through ``ContinuousScheduler(snapshot_every=1)`` on an
    engine armed with ``sched.iter:crash_iter:crash``, then the last
    snapshot restored on a fresh engine over the same weights, every
    counter at 0 before the crash run.  Returns (merged results, masked
    decode steps and prefill chunks of both runs, the snapshot, restore
    seconds, seconds in the restore's prefill chunks, the fresh engine's
    params on the card)."""
    from repro_torch.train.faults import CrashError
    from repro_torch.train.serve_engine import ServeEngine
    from repro_torch.train.serve_scheduler import ContinuousScheduler
    kw = dict(device="cuda", max_len=max_len, paged=True, block_size=16)
    eng = ServeEngine(cfg, params, faults=f"sched.iter:{crash_iter}:crash",
                      **kw)
    first = _engine_calls(eng, ("decode_masked", "prefill_chunk"))
    sched = ContinuousScheduler(eng, max_batch=8, snapshot_every=1)
    zero_counts()
    try:
        sched.run(reqs)
    except CrashError as e:
        print(f"  {label}: {e}")
    else:
        _fail(f"{label}: the run outlived sched.iter:{crash_iter}:crash")
    snap = sched.last_snapshot
    if not any(item["emitted"] for item in snap["inflight"]):
        _fail(f"{label}: the snapshot holds no request mid-decode")
    del eng, sched
    eng2 = ServeEngine(cfg, params, **kw)
    second = _engine_calls(eng2, ("decode_masked", "prefill_chunk"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged = ContinuousScheduler(eng2, max_batch=8).restore(snap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = first["decode_masked"] + second["decode_masked"]
    chunks = (first["prefill_chunk"], second["prefill_chunk"])
    print(f"  {label}: snapshot at the boundary of iteration {crash_iter}: "
          f"{len(snap['done'])} done, {len(snap['inflight'])} in flight "
          f"({sum(len(i['emitted']) for i in snap['inflight'])} tokens "
          f"emitted), {len(snap['queued'])} queued; restore {wall:.3f} s on "
          f"a fresh engine, {second['prefill_chunk_s']:.3f} s of it "
          f"({second['prefill_chunk_s'] / wall:.1%}) in "
          f"{second['prefill_chunk']} re-prefill chunks")
    return (merged, steps, chunks, snap, wall, second["prefill_chunk_s"],
            eng2.params)


def fault_serving_paths(cfg, cfglib, registry, serve, plain, prefix_int8,
                        spec) -> dict:
    """Phase 30 (see the module docstring).  ``plain``, ``prefix_int8`` and
    ``spec``: phase 6's f32 and prefix-cache-over-int8 results and phase
    22's spec results, the streams each run is held to.  Returns the
    readings for the record."""
    from repro_torch.train.serve_scheduler import FINISH_REASONS
    out = {}
    weights = registry.get_model(cfg).init(torch.Generator().manual_seed(0),
                                           cfg, device="cpu")
    # (a) the storm: every request ends with one reason; completed streams
    # equal phase 6's, failed ones are its first tokens (near-tie rule)
    argv = PAGED_ARGV + ["--faults", FAULT_STORM, "--retries", "2"]
    results, sched, stats, calls = _serve_counted(serve, argv,
                                                  ("decode_masked",))
    expect_counts("fault storm",
                  paged_attention=calls["decode_masked"] * cfg.num_layers)
    fs, plane = sched.fault_stats(), sched.engine.faults
    if len(results) != len(plain) or any(
            r.finish_reason not in FINISH_REASONS for r in results):
        _fail(f"fault storm results {[r.finish_reason for r in results]}")
    if not plane.fired:
        _fail("the fault storm never fired")
    eq = streams_vs("fault storm", cfg, registry, results, plain,
                    sched.engine.params)
    print(f"fault storm {FAULT_STORM}: {len(plane.fired)} faults over "
          f"{sum(plane.counts.values())} site hits, {fs['retries']} retries, "
          f"{fs['failed']} failed; finish reasons {stats['finish_reasons']}; "
          f"aggregate tokens/s {stats['tokens_per_s']:.1f} (goodput), "
          f"{stats['tokens_per_s_all']:.1f} all; paged launches "
          f"{calls['decode_masked'] * cfg.num_layers} = "
          f"{calls['decode_masked']} decode steps x {cfg.num_layers}")
    out["storm"] = dict(faults=len(plane.fired), retries=fs["retries"],
                        failed=fs["failed"], equal=eq,
                        tokens_per_s=stats["tokens_per_s"])
    # (b) each serving site once over the prefix cache on int8 pages:
    # streams equal the clean prefix + int8 run's
    argv = PAGED_ARGV + ["--prefix-cache", "--kv-dtype", "int8", "--faults",
                         FAULT_TAPE]
    results, sched, stats, calls = _serve_counted(serve, argv,
                                                  ("decode_masked",))
    expect_counts("fault tape",
                  paged_attention=calls["decode_masked"] * cfg.num_layers)
    plane = sched.engine.faults
    lens, gens = _drawn_requests(cfg, argv)
    _check_served("fault tape", cfg, lens, gens, results, sched)
    want = sorted(tuple(e.split(":")[:2]) for e in FAULT_TAPE.split(","))
    got = sorted((site, str(hit)) for site, hit, _ in plane.fired)
    if got != want:
        _fail(f"fault tape fired {plane.fired}, expected {want}")
    eq = streams_vs("fault tape", cfg, registry, results, prefix_int8,
                    sched.engine.params)
    print(f"fault tape over the prefix cache on int8 pages: "
          f"{len(plane.fired)} faults, {sched.retries} retries, every "
          f"request at its budget; prefix hits "
          f"{sched.prefix_stats()['prefix_hits']}")
    out["tape"] = dict(retries=sched.retries, equal=eq)
    # (c) the draft prefill faulted once under speculation
    argv = PAGED_ARGV + SPEC_ARGV + ["--faults", "engine.draft_prefill:1"]
    results, sched, stats, calls = _serve_counted(serve, argv,
                                                  ("admit_paged",))
    expect_counts("draft prefill fault",
                  flash_attention=SPEC_DEPTH * calls["admit_paged"])
    lens, gens = _drawn_requests(cfg, argv)
    _check_served("draft prefill fault", cfg, lens, gens, results, sched)
    if sched.engine.faults.fired != [("engine.draft_prefill", 1, "fault")]:
        _fail(f"draft prefill tape fired {sched.engine.faults.fired}")
    eq = streams_vs("draft prefill fault", cfg, registry, results, spec,
                    sched.engine.params)
    out["draft_prefill"] = dict(retries=sched.retries, equal=eq)
    # (d) a crash at an iteration boundary, restored on a fresh engine
    reqs = _requests_of(_drawn_traffic(cfg, PAGED_ARGV))
    arg = dict(zip(PAGED_ARGV, PAGED_ARGV[1:]))
    max_len = int(arg["--prompt-len"]) + int(arg["--gen"]) + 1  # serve.main's
    merged, steps, chunks, snap, wall, pf, on_card = _crash_and_restore(
        "crash-restore", cfg, weights, reqs, CRASH_ITER, max_len)
    expect_counts("crash-restore",
                  paged_attention=steps * cfg.num_layers)
    if [r.finish_reason for r in merged] != ["limit"] * len(reqs):
        _fail(f"crash-restore reasons {[r.finish_reason for r in merged]}")
    eq = streams_vs("crash-restore", cfg, registry, merged, plain, on_card)
    out["crash_restore"] = dict(equal=eq, restore_s=wall,
                                reprefill_share=pf / wall,
                                paged_launches=steps * cfg.num_layers)
    del weights, on_card
    # (e) a bounded queue and a deadline: every request arrives before the
    # first iteration (rate 1e9), so QUEUE_LIMIT wait and the rest shed;
    # the QUEUE_LIMIT admitted in the first iteration are past DEADLINE_S
    # at the second (a 12-layer chunk each is dispatched in between), and
    # none can reach its budget (16 tokens at least) by then
    argv = PAGED_ARGV[:PAGED_ARGV.index("--rate")] + ["--rate", "1e9"] \
        + PAGED_ARGV[PAGED_ARGV.index("--rate") + 2:] + [
            "--queue-limit", str(QUEUE_LIMIT), "--deadline-s",
            str(DEADLINE_S)]
    results, sched, stats, calls = _serve_counted(serve, argv,
                                                  ("decode_masked",))
    expect_counts("queue limit and deadline",
                  paged_attention=calls["decode_masked"] * cfg.num_layers)
    n = len(results)
    want = {"shed": n - QUEUE_LIMIT, "deadline": QUEUE_LIMIT}
    if stats["finish_reasons"] != want or sched.shed != want["shed"] or \
            sched.deadline_hits != want["deadline"]:
        _fail(f"queue limit and deadline: {stats['finish_reasons']}, "
              f"expected {want}")
    for r in results:
        if r.finish_reason == "deadline" and \
                r.finished_s - r.arrival_s <= DEADLINE_S:
            _fail(f"request {r.uid} finished 'deadline' before it")
    streams_vs("queue limit and deadline", cfg, registry,
               [r for r in results if len(r.new_tokens)],
               [p for r, p in zip(results, plain) if len(r.new_tokens)],
               sched.engine.params)
    print(f"queue limit {QUEUE_LIMIT}, deadline {DEADLINE_S} s: "
          f"{stats['finish_reasons']} as derived")
    out["queue_deadline"] = dict(stats["finish_reasons"])
    # (f) rwkv6-7b at depth 2: a crash and a restore; the WKV kernel runs
    # the re-prefill from a fresh carry, chunk by chunk
    rcfg = cfglib.get_config("rwkv6-7b").with_depth(2)
    rw = registry.get_model(rcfg).init(torch.Generator().manual_seed(0),
                                       rcfg, device="cpu")
    reqs = _requests_of(_drawn_traffic(rcfg, _with_arch(PAGED_ARGV,
                                                        rcfg.name))[:6])
    from repro_torch.train.serve_engine import ServeEngine
    eng = ServeEngine(rcfg, rw, device="cuda", max_len=max_len, paged=True,
                      block_size=16)
    clean_chunks = _engine_calls(eng, ("prefill_chunk",))
    clean, _, _, _, _ = _run_counted("rwkv6-7b depth 2 clean", eng, reqs)
    derived = sum(len(_prefill_chunks(len(r.prompt), 16)) for r in reqs)
    expect_counts("rwkv6-7b depth 2 clean", wkv=rcfg.num_layers * derived)
    if clean_chunks["prefill_chunk"] != derived:
        _fail(f"rwkv clean run: {clean_chunks['prefill_chunk']} chunks, "
              f"derived {derived}")
    del eng
    merged, _, chunks, snap, wall, pf, on_card = _crash_and_restore(
        "rwkv6-7b depth 2 crash-restore", rcfg, rw, reqs, RWKV_CRASH_ITER,
        max_len)
    re_derived = sum(len(_prefill_chunks(len(i["prompt"]) + len(i["emitted"]),
                                         16))
                     for i in snap["inflight"] + snap["queued"])
    if chunks[1] != re_derived:
        _fail(f"rwkv restore: {chunks[1]} chunks, derived {re_derived}")
    wkv = expect_counts("rwkv6-7b depth 2 crash-restore",
                        wkv=rcfg.num_layers * sum(chunks))["wkv"]
    eq = streams_vs("rwkv6-7b depth 2 crash-restore", rcfg, registry, merged,
                    clean, on_card)
    del on_card, rw
    print(f"rwkv6-7b depth 2: {wkv} WKV launches = 2 layers x ({chunks[0]} "
          f"chunks before the crash + {chunks[1]} re-prefill chunks, "
          f"derived {re_derived})")
    out["rwkv_crash_restore"] = dict(equal=eq, wkv=wkv, restore_s=wall,
                                     reprefill_share=pf / wall)
    return out


def _fault_tcfg(**kw):
    """Phase 13's training as ``launch/train.py`` builds it from
    ``TRAIN_ARGV``, with a checkpoint every 3 steps and every step
    logged."""
    from repro_torch.configs.base import (ExpansionConfig, OptimizerConfig,
                                          ScheduleConfig, TrainConfig)
    arg = dict(zip(TRAIN_ARGV, TRAIN_ARGV[1:]))
    base = dict(total_steps=TRAIN_STEPS, seq_len=int(arg["--seq-len"]),
                global_batch=int(arg["--batch"]), source_layers=1,
                expansions=(ExpansionConfig(at_frac=TRAIN_TAU,
                                            target_layers=12,
                                            init=arg["--init"]),),
                optimizer=OptimizerConfig(name="muon_nsgd",
                                          learning_rate=0.01),
                schedule=ScheduleConfig(name="wsd"), seed=0,
                checkpoint_every=3, log_every=1)
    base.update(kw)
    return TrainConfig(**base)


def _train_counts(cfg, first: int, last: int, tau: int):
    """Each kernel's launches over steps first..last-1 of phase 13's run
    (1 layer before ``tau``, then cfg's depth; no eval in 12 steps)."""
    layers = [1 if s < tau else cfg.num_layers for s in range(first, last)]
    fused, large = _ns_launches(cfg)
    want = {name: 0 for name in COUNTERS}
    want.update(flash_attention=sum(layers), flash_attention_bwd=sum(layers),
                ns_fused=fused * len(layers), matmul=large * len(layers))
    return want


def _same_state(label, a, b):
    """Bit equality of two runs' losses, params and momenta."""
    from repro_torch.tree import leaves_with_path
    if a.history["loss"] != b.history["loss"]:
        _fail(f"{label}: losses {a.history['loss']} against "
              f"{b.history['loss']}")
    differ = [".".join(p) for (p, x), (_, y) in zip(
        leaves_with_path({"params": a.params, "opt_state": a.opt_state}),
        leaves_with_path({"params": b.params, "opt_state": b.opt_state}))
        if not torch.equal(x, y)]
    return differ


def fault_training_paths(cfg, registry) -> dict:
    """Phase 31 (see the module docstring).  Returns the readings."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.train import loop
    from repro_torch.train.engine import ProgressiveTrainer
    from repro_torch.train.faults import CrashError
    tau = int(TRAIN_TAU * TRAIN_STEPS)
    tc = _fault_tcfg()
    out = {}

    def train(label, first, last, ckpt_dir=None, crash=False, **kw):
        zero_counts()
        t0 = time.perf_counter()
        try:
            res = loop.train(cfg, tc, checkpoint_dir=ckpt_dir,
                             device="cuda", log_fn=lambda *a: None, **kw)
        except CrashError as e:
            if not crash:
                raise
            print(f"  {label}: {e} after {time.perf_counter() - t0:.1f} s; "
                  f"latest checkpoint {ckpt.latest_step(ckpt_dir)}")
            res = None
        else:
            if crash:
                _fail(f"{label} did not crash")
            print(f"  {label}: {time.perf_counter() - t0:.1f} s, losses "
                  f"{res.history['loss'][0]:.4f} -> "
                  f"{res.history['loss'][-1]:.4f}")
        want = _train_counts(cfg, first, last, tau)
        if read_counts() != want:
            _fail(f"{label}: launches {read_counts()}, expected {want}")
        return res

    # One clean run (its repeat cut for time: each resumed run below is
    # held to it bit for bit, which a nondeterministic step would break).
    clean = train("clean run", 0, TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        # train.iter:8 alone (train.iter:6, cut for time, resumed from 3
        # as the async crash below does)
        for k in (7,):
            d = os.path.join(tmp, f"k{k}")
            train(f"train.iter:{k + 1}:crash", 0, k, d, crash=True,
                  faults=f"train.iter:{k + 1}:crash")
            latest = ckpt.latest_step(d)
            if latest != (3 if k < tau else 6):
                _fail(f"crash at step {k}: latest checkpoint {latest}")
            res = train(f"resumed from {latest}", latest, TRAIN_STEPS, d)
            differ = _same_state(f"resume from {latest}", res, clean)
            if differ:
                _fail(f"resumed from {latest}: {differ} differ")
        d = os.path.join(tmp, "write")
        train("ckpt.write:2:crash (async)", 0, tau, d, crash=True,
              faults="ckpt.write:2:crash")
        if ckpt.latest_step(d) != 3 or not os.path.isdir(
                os.path.join(d, "step_000000006.tmp")):
            _fail(f"async crash: steps {ckpt.all_steps(d)}")
        res = train("resumed from 3", 3, TRAIN_STEPS, d)
        differ = _same_state("resume after the async crash", res, clean)
        if differ:
            _fail(f"resumed after the async crash: {differ} differ")
    print("phase 31 crash-resume: train.iter:8 and ckpt.write:2 (async) "
          "crashes resumed bit-identical to the clean run")
    # nan at step 8 under skip, a train.step fault retried at step 2: the
    # skipped step leaves params and momenta bit for bit
    checked = []
    build = ProgressiveTrainer._build_steps

    def watched(self, c):
        step_fn, eval_fn = build(self, c)

        def stepped(params, opt_state, batch, step, *rest):
            if step != 8:
                return step_fn(params, opt_state, batch, step, *rest)
            before = [t.clone() for t in _leaves((params, opt_state))]
            params, opt_state, m = step_fn(params, opt_state, batch, step,
                                           *rest)
            after = _leaves((params, opt_state))
            checked.append((float(m["bad"]), all(
                torch.equal(x, y) for x, y in zip(before, after))))
            return params, opt_state, m
        return stepped, eval_fn
    ProgressiveTrainer._build_steps = watched
    try:
        skip = train("nan:8 under skip, train.step:3 retried", 0,
                     TRAIN_STEPS, nan_policy="skip", nan_inject="nan:8",
                     faults="train.step:3")
    finally:
        ProgressiveTrainer._build_steps = build
    h = skip.history
    if checked != [(1.0, True)] or h["skipped_steps"] != [8] or \
            not math.isnan(h["loss"][8]) or \
            h["loss"][:8] != clean.history["loss"][:8] or \
            skip.fault_stats["retries"] != 1:
        _fail(f"skip: {checked} {h['skipped_steps']} {h['loss']} "
              f"{skip.fault_stats}")
    if not all(torch.isfinite(t).all() for t in _leaves(skip.params)):
        _fail("skip: non-finite params after the skipped step")
    dts = [dt for _, dt in skip.step_times]
    clean_dts = [dt for _, dt in clean.step_times]
    out["retry_step_s"] = dts[2]
    out["sentinel_step_ms"] = 1e3 * float(np.median(dts[tau + 1:]))
    out["plain_step_ms"] = 1e3 * float(np.median(clean_dts[tau + 1:]))
    print(f"phase 31 skip: step 8 bad, params and momenta bit-identical "
          f"across it, losses 0-7 equal the clean run's; the retried step 2 "
          f"took {dts[2] * 1e3:.1f} ms (1-layer steps "
          f"{1e3 * float(np.median(dts[1:tau])):.1f} ms median; backoff "
          f"50 ms); sentinel step {out['sentinel_step_ms']:.2f} ms against "
          f"the plain step's {out['plain_step_ms']:.2f} ms at 12 layers "
          "(median of steps 7-11)")
    # the hang deadline below the 12-layer step time
    deadline = 0.5 * out["plain_step_ms"] / 1e3
    hang = train(f"hang deadline {deadline * 1e3:.1f} ms", 0, TRAIN_STEPS,
                 hang_deadline_s=deadline)
    want = [s for s, (_, dt) in enumerate(hang.step_times) if dt > deadline]
    if hang.history["hangs"] != want or not want:
        _fail(f"hangs {hang.history['hangs']}, expected {want}")
    differ = _same_state("hang run", hang, clean)
    if differ:
        _fail(f"the hang run differs from the clean run in {differ}")
    print(f"phase 31 hang deadline {deadline * 1e3:.1f} ms: hangs at steps "
          f"{want}, run completed bit-identical to the clean run")
    out["hangs"] = want
    out.update(async_overlap(cfg, registry, clean))
    return out


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t)]
    return tree_leaves(tree)


def async_overlap(cfg, registry, res) -> dict:
    """The asynchronous save against the synchronous one at 12 layers
    (params and momenta of ``res``, ~1 GB): the time ``save`` holds the
    caller (device clones), the three train steps after it against three
    steps alone, and how long the write runs on after them.  What the save
    costs the training loop: the hold plus the steps' excess, against the
    synchronous save's whole time."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.core.schedules import make_schedule
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.optim.base import make_optimizer
    from repro_torch.train import steps as steps_lib
    tc = _fault_tcfg()
    step = steps_lib.make_train_step(
        cfg, make_optimizer(tc.optimizer),
        make_schedule(tc.schedule, tc.optimizer.learning_rate,
                      tc.total_steps))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=tc.seq_len,
                                  global_batch=tc.global_batch, seed=0))
    batch = {k: torch.from_numpy(np.asarray(v)).cuda().long()
             for k, v in data.batch(0).items()}
    p, o = res.params, res.opt_state
    tree = {"params": p, "opt_state": o}

    def timed(fn):
        # the compute stream only, as the trainer waits for a step: the
        # async write's copy runs on a side stream
        stream = torch.cuda.current_stream()
        stream.synchronize()
        t0 = time.perf_counter()
        fn()
        stream.synchronize()
        return time.perf_counter() - t0
    alone = [timed(lambda: step(p, o, batch, 11)) for _ in range(3)]
    with tempfile.TemporaryDirectory() as tmp:
        sync = timed(lambda: ckpt.save(tmp, 1, tree))
        ac = ckpt.AsyncCheckpointer()
        call = timed(lambda: ac.save(tmp, 2, tree))
        during = [timed(lambda: step(p, o, batch, 11)) for _ in range(3)]
        t0 = time.perf_counter()
        ac.wait()
        rest = time.perf_counter() - t0
        if ckpt.latest_step(tmp) != 2:
            _fail("the async save did not land")
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(tree))
    held = call + sum(during) - sum(alone)

    def ms(xs):
        return ", ".join(f"{1e3 * x:.1f}" for x in xs)
    print(f"phase 31 async save of {nbytes / 1e9:.3f} GB: save() held the "
          f"caller {call * 1e3:.1f} ms (device clones), the next 3 steps "
          f"took {ms(during)} ms against {ms(alone)} alone, the write ran "
          f"on {rest * 1e3:.1f} ms after them; it cost the loop "
          f"{held * 1e3:.1f} ms against {sync * 1e3:.1f} ms for a "
          "synchronous save")
    return {"async_call_ms": call * 1e3,
            "async_steps_ms": [1e3 * x for x in during],
            "steps_alone_ms": [1e3 * x for x in alone],
            "async_rest_ms": rest * 1e3, "async_held_ms": held * 1e3,
            "sync_save_ms": sync * 1e3}


# ---------------------------------------------------------------------------
# Phases 32-35: sliding windows, softcaps and head dim 256 (gemma2-9b,
# gemma3-12b), and the rest of the training recipe (AdamW, SGD, NSGD,
# remat)
# ---------------------------------------------------------------------------

# The gemmas' flash shapes (hd 256, 16 query heads over 8 kv heads): gemma2
# prefill past its 4096 window with softcap 50, gemma3 past its 1024 one.
GEMMA_FA = {"gemma2-9b": dict(B=1, S=5120, H=16, KV=8, window=4096,
                              softcap=50.0),
            "gemma3-12b": dict(B=2, S=2048, H=16, KV=8, window=1024,
                               softcap=0.0)}
HD256 = 256
# gemma's global-layer decode: G = 2, hd 256, pages of 16, contexts past
# 4096 (the last row of a parity case is all trash).
# With the softcap on, q is scaled so that the logits reach the cap
# (|q.k|/16 with a standard deviation of 8 against a cap of 50).
SOFTCAP_Q_SCALE = 8.0
GEMMA_PAGED = dict(B=4, H=16, KV=8, hd=HD256, bs=16, NB=400, cursor=5000)
GEMMA_PAGED_CURSORS = [4200, 6175, 4096, 0]
# Phase 33: gemma2-9b at full size, 8 requests into 4 slots.
GEMMA2_TRAFFIC = dict(n=8, lo=4160, hi=6144, gen=32, slots=4, seed=33)
# Phase 33 serves gemma2-9b at 4 of its 42 layers (cut to make room for
# phases 40-43: two of its 21 local/global pairs; every request still runs
# past the 4096 window and the paged kernel at G = 2, hd 256 on each global
# layer).
GEMMA2_SERVE_DEPTH = 4
# Phase 34: gemma3-12b at full width and 12 layers (two 5:1 periods), 16
# requests into 8 slots: a 1280-token shared prefix alone, then 15 prompts
# of 1281-2000 tokens that extend it.
GEMMA3_DEPTH = 12
GEMMA3_TRAFFIC = dict(n=16, lo=1281, hi=2000, gen=32, slots=8, seed=34,
                      shared=1280)
GEMMA3_SPEC_DEPTH, GEMMA3_GAMMA = 6, 4
# Phase 35: gemma2-9b at full width trained 2 -> 4 layers, one 5120-token
# sequence a step; gpt2-12l at phase 13's settings for 6 steps.
GEMMA2_TRAIN = dict(source=2, target=4, steps=4, seq=5120, batch=1)
RECIPE_STEPS = 6


def _flash_plain(q, k, v, o, do, window, cap, causal=True):
    """The plain backward on the backward kernel's own inputs, head by
    head in f32 on the card (causal, or over every key at S_k != S_q
    with ``causal=False``): dq, dk, dv from q, k, v, the forward output
    ``o`` it is handed (D = rowsum(dO o) with that o: bf16 inputs get a
    bf16 o) and dO, with the window, the softcap and its derivative.  And
    the sums of magnitudes behind each entry of the forward's output and
    of dq, dk, dv: ``P |V|``, ``|dS| |K|``, ``|dS|^T |Q|`` and ``P^T |dO|``
    (the last two summed over each kv head's group); a kernel that rounds
    each P or dS to TF32 (2^-11 relative) moves an entry by at most 2^-11
    times its magnitude.  Returns ((dq, dk, dv), (o, dq, dk, dv) of
    magnitudes)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    i = torch.arange(S, device=q.device)
    j = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[:, None] >= j[None, :]
    if window > 0:
        mask &= (i[:, None] - j[None, :]) < window
    grads = [torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)]
    mags = [torch.zeros_like(q), torch.zeros_like(q), torch.zeros_like(k),
            torch.zeros_like(v)]
    rs = 1.0 / math.sqrt(hd)
    for b in range(B):
        for h in range(H):
            kh = h // G
            qh, kk, vv, dh = q[b, :, h], k[b, :, kh], v[b, :, kh], do[b, :, h]
            x = qh @ kk.T * rs
            if cap > 0:
                x = cap * torch.tanh(x / cap)
            p = torch.softmax(x.masked_fill(~mask, -1e30), dim=-1)
            dx = p * (dh @ vv.T - (dh * o[b, :, h]).sum(-1, keepdim=True))
            ds = dx * (1 - (x / cap) ** 2) if cap > 0 else dx
            grads[0][b, :, h] = ds @ kk * rs
            grads[1][b, :, kh] += ds.T @ qh * rs
            grads[2][b, :, kh] += p.T @ dh
            ds = ds.abs()
            mags[0][b, :, h] = p @ vv.abs()
            mags[1][b, :, h] = ds @ kk.abs() * rs
            mags[2][b, :, kh] += ds.T @ qh.abs() * rs
            mags[3][b, :, kh] += p.T @ dh.abs()
            del x, p, dx, ds
    return grads, mags


def _flash_room(want, mag, dtype, backward=False):
    """Each entry's limit against the plain version (``hd256_flash``): f32
    by ``TOL`` (forward) or
    ``BWD_TOL`` times max(1, max|plain|) (each gradient); bf16, whose
    kernel rounds P and dS to TF32 for its second products and its result
    to bf16 once, by 2^-8 |plain| + 2^-10 magnitude + 1e-6 max(1,
    max|plain|) (the 2^-11 of each rounded P or dS, doubled for f32 sums
    in another order)."""
    if dtype == torch.float32:
        peak = max(1.0, want.abs().max().item()) if backward else 1.0
        return torch.full_like(want, (BWD_TOL if backward else TOL)[dtype]
                               * peak)
    return (2.0 ** -8 * want.abs() + 2.0 ** -10 * mag
            + 1e-6 * max(1.0, want.abs().max().item()))


def _worst_ratio(got, want, room) -> float:
    return ((got.float() - want).abs() / room).max().item()


def _sdpa_best(q, k, v, do, causal=True):
    """SDPA's best single call (causal unless ``causal=False``; no window
    or softcap) on (B, S, heads, hd) inputs, forward and backward: as
    PyTorch dispatches GQA
    (``enable_gqa``) and on K/V repeated to every query head (the repeat
    not timed), each on the backend ``torch._fused_sdp_choice`` picks.
    Returns {fwd: (ms, backend), bwd: (ms, backend), readings}."""
    from torch.nn.attention import sdpa_kernel
    H = q.shape[2]
    rep = [t.repeat_interleave(H // k.shape[2], dim=2) for t in (k, v)]
    readings = {}
    for label, (kk, vv) in (("gqa", (k, v)), ("repeated", rep)):
        sdpa, backend = sdpa_yardstick(q, kk, vv, causal)
        fwd = sdpa(_time_device_ms, 10)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, kk, vv))
        with sdpa_kernel([getattr(torch.nn.attention.SDPBackend, backend)]):
            so = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=kt.shape[1] != H)
            bwd = _time_device_ms(lambda: torch.autograd.grad(
                so, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 10)
        readings[label] = dict(backend=backend, fwd_ms=fwd, bwd_ms=bwd)
        del so, qt, kt, vt
    del rep
    best = {}
    for key in ("fwd", "bwd"):
        label = min(readings, key=lambda r: readings[r][f"{key}_ms"])
        best[key] = (readings[label][f"{key}_ms"],
                     f"{readings[label]['backend']} ({label})")
    return dict(best, readings=readings)


def _hd256_bounds(work, dtype) -> dict:
    """f32: the route's bound (3xTF32) and the f32 FMA one; bf16: the bf16
    peak's and one TF32 pass's."""
    from repro_torch.roofline import torch_cost
    if dtype == torch.float32:
        return dict(**work.bound(),
                    f32_bound_ms=work.bounds()["f32_bound_ms"])
    return dict(**work.bound(), tf32_route_bound_ms=torch_cost.bound(
        {"tf32": work.flops}, work.bytes)["bound_ms"])


def hd256_flash(fa_ops) -> dict:
    """Phase 32, the flash half: forward and backward at gemma2's and
    gemma3's shapes, f32 and bf16, on the card, entry by entry
    (``_flash_room``; dq, dk, dv each on its own): the forward against the
    plain version run on f32 copies of the same inputs, the backward
    against the plain backward on its own inputs (``_flash_plain``: the o
    the forward gave it); finite, bit-identical on repeat.  Where
    the softcap is on, q is scaled by ``SOFTCAP_Q_SCALE`` so that the
    logits reach it; the same rule must reject the plain version without
    the softcap and without the window (the check can see both).  Then
    device times (CUDA events) of the kernel, its plain version and SDPA's
    best call (causal, without the window and the softcap it cannot
    express), beside the card's bound: f32 on this route's three TF32
    passes, bf16 at the bf16 tensor-core peak (and the one TF32 pass this
    route runs).  Returns {arch: {dtype: record}}."""
    from repro_torch.configs.base import HW_PEAK_BF16_FLOPS
    from repro_torch.roofline import torch_cost
    out = {}
    for n, (arch, s) in enumerate(GEMMA_FA.items()):
        B, S, H, KV, W, cap = (s[k] for k in ("B", "S", "H", "KV", "window",
                                              "softcap"))
        kw = dict(causal=True, window=W, logit_softcap=cap)
        out[arch] = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _inputs(B, S, H, KV, HD256, dtype, 3200 + 10 * n)
            if cap > 0:
                q = (q.float() * SOFTCAP_Q_SCALE).to(dtype)
            do = _inputs(B, S, H, H, HD256, dtype, 3201 + 10 * n)[0]
            f32 = [t.float() for t in (q, k, v, do)]
            before = fa_ops.KERNEL_LAUNCHES
            got = fa_ops.flash_attention(q, k, v, force="kernel", **kw)
            again = fa_ops.flash_attention(q, k, v, force="kernel", **kw)
            want = fa_ops.flash_attention(*f32[:3], force="ref", **kw)
            torch.cuda.synchronize()
            gw, mags = _flash_plain(q, k, v, got, do, W, cap)
            room = _flash_room(want, mags[0], dtype)
            err = (got.float() - want).abs().max().item()
            ratio = _worst_ratio(got, want, room)
            blind = {}
            for what, kw_off in (("softcap", dict(kw, logit_softcap=0.0)),
                                 ("window", dict(kw, window=0))):
                if kw_off != kw:
                    off = fa_ops.flash_attention(*f32[:3], force="ref",
                                                 **kw_off)
                    blind[what] = _worst_ratio(off, want, room)
                    del off
            if (ratio > 1.0 or fa_ops.KERNEL_LAUNCHES != before + 2
                    or not bool(torch.isfinite(got).all())
                    or not torch.equal(got, again)
                    or min(blind.values()) <= 1.0):
                _fail(f"hd 256 flash forward {arch} {dtype}: err {err:.2e}, "
                      f"worst err/limit {ratio:.3f}, repeat equal "
                      f"{torch.equal(got, again)}, the plain version "
                      f"without each of {list(blind)} at {blind} of the "
                      "limit (must exceed 1)")
            del want, again, room
            gk = _bwd_pair(fa_ops, q, k, v, do, kw, "kernel")
            gk2 = _bwd_pair(fa_ops, q, k, v, do, kw, "kernel")
            rooms = [_flash_room(w, m, dtype, backward=True)
                     for w, m in zip(gw, mags[1:])]
            berrs = [(a.float() - b).abs().max().item()
                     for a, b in zip(gk, gw)]
            bratios = [_worst_ratio(a, b, r) for a, b, r in zip(gk, gw, rooms)]
            bblind = {}
            for what, off in (("softcap", (W, 0.0)), ("window", (0, cap))):
                if off != (W, cap):
                    go, _ = _flash_plain(q, k, v, got, do, *off)
                    bblind[what] = min(_worst_ratio(a, b, r) for a, b, r
                                       in zip(go, gw, rooms))
                    del go
            if (max(bratios) > 1.0
                    or not all(bool(torch.isfinite(t).all()) for t in gk)
                    or not all(torch.equal(a, b) for a, b in zip(gk, gk2))
                    or min(bblind.values()) <= 1.0):
                _fail(f"hd 256 flash backward {arch} {dtype}: dq/dk/dv err "
                      f"{berrs}, err/limit {bratios}, the plain version "
                      f"without each of {list(bblind)} at {bblind} of the "
                      "limit (must exceed 1)")
            del gk, gw, gk2, rooms, mags, f32, got
            ms = _time_device_ms(lambda: fa_ops.flash_attention(
                q, k, v, force="kernel", **kw), 10)
            plain_ms = _time_device_ms(lambda: fa_ops.flash_attention(
                q, k, v, force="ref", **kw), 2)
            lib = _sdpa_best(q, k, v, do)
            es = q.element_size()
            work = torch_cost.flash_attention(B, S, S, H, KV, HD256,
                                              window=W, itemsize=es)
            flops = work.flops
            bound = _hd256_bounds(work, dtype)
            fwd = dict(ms=ms, plain_ms=plain_ms, library_ms=lib["fwd"][0],
                       library_backend=lib["fwd"][1], **bound,
                       max_abs_err=err, err_over_limit=ratio,
                       blind_over_limit=blind, sdpa=lib["readings"])
            o, lse = fa_ops.flash_attention_cuda(q, k, v, with_lse=True, **kw)
            bwd_ms = _time_device_ms(lambda: fa_ops.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, **kw), 10)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            ref_out = fa_ops.flash_attention(*leaves, force="ref", **kw)
            bwd_plain = _time_device_ms(lambda: torch.autograd.grad(
                ref_out, leaves, do, retain_graph=True), 2)
            del ref_out, leaves
            bbound = _hd256_bounds(torch_cost.flash_attention_bwd(
                B, S, S, H, KV, HD256, window=W, itemsize=es), dtype)
            bwd = dict(ms=bwd_ms, plain_ms=bwd_plain,
                       library_ms=lib["bwd"][0],
                       library_backend=lib["bwd"][1], **bbound,
                       max_abs_err=max(berrs), err_over_limit=max(bratios),
                       blind_over_limit=bblind)
            name = str(dtype)[6:]
            out[arch][name] = dict(forward=fwd, backward=bwd)
            peak = ("3xTF32" if dtype == torch.float32 else
                    f"bf16 at {HW_PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s")
            print(f"  {card_line()}: hd 256 flash at {arch}'s shape (B={B} "
                  f"S={S} H={H}/{KV} window {W} softcap {cap:g}"
                  f"{f', q x{SOFTCAP_Q_SCALE:g}' if cap > 0 else ''}) "
                  f"{name}: forward err {err:.2e} = {ratio:.3f} of its "
                  f"limit (plain without {blind}), kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, sdpa {lib['fwd'][1]} (causal, "
                  f"no window or softcap) {lib['fwd'][0]:.4f} ms, bound "
                  f"{fwd['bound_ms']:.4f} ms ({fwd['bound_by']}; "
                  f"{flops / 1e9:.2f} GFLOP, {peak}); backward err "
                  f"{max(berrs):.2e}, dq/dk/dv at "
                  f"{[round(r, 3) for r in bratios]} of their limits "
                  f"(plain without {bblind}), kernel {bwd_ms:.4f} ms, "
                  f"plain (autograd) {bwd_plain:.4f} ms, sdpa backward "
                  f"{lib['bwd'][1]} {lib['bwd'][0]:.4f} ms, bound "
                  f"{bwd['bound_ms']:.4f} ms ({bwd['bound_by']}); sdpa "
                  f"readings {lib['readings']}")
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    return out


def hd256_paged(pa_ops) -> dict:
    """Phase 32, the paged half: the decode at G = 2, hd 256 (gemma's
    global layers), softcap 50 and 0, f32 and bf16 q over f32, bf16, int8
    and fp8 pages, contexts past 4096 (and a zero cursor and an all-trash
    row), against the plain version with ``paged_parity``'s rule, finite
    and bit-identical on repeat; then device times of each page dtype at
    softcap 50 (L2 flushed) beside the byte bound and SDPA on the gathered
    context.  Returns {page dtype: record}."""
    f32, bf16 = torch.float32, torch.bfloat16
    s = GEMMA_PAGED
    B, H, KV, hd, bs, NB = (s[k] for k in ("B", "H", "KV", "hd", "bs",
                                           "NB"))
    worst, n = {}, 0
    for q_dt in (f32, bf16):
        for kv_dt in (f32, bf16, torch.int8, torch.float8_e4m3fn):
            for cap in (50.0, 0.0):
                n += 1
                q, kp, vp, tbl, idx, ks, vs = paged_case(
                    B, H, KV, hd, bs, NB, q_dt, kv_dt, GEMMA_PAGED_CURSORS,
                    seed=3300 + n)
                kw = dict(k_scales=ks, v_scales=vs, logit_softcap=cap)
                before = pa_ops.KERNEL_LAUNCHES
                got = pa_ops.paged_attention(q, kp, vp, tbl, idx,
                                             force="kernel", **kw)
                again = pa_ops.paged_attention(q, kp, vp, tbl, idx,
                                               force="kernel", **kw)
                want = pa_ops.paged_attention(q.float(), kp, vp, tbl, idx,
                                              force="ref", **kw)
                torch.cuda.synchronize()
                live = slice(0, B - 1)
                want_l = want[live].float()
                peak = max(1.0, want_l.abs().max().item())
                tol = TOL[f32] * (peak if ks is not None or q_dt == bf16
                                  else 1.0)
                diff = (got[live].float() - want_l).abs()
                room = tol + (2.0 ** -8 * want_l.abs() if q_dt == bf16
                              else 0.0)
                err = diff.max().item()
                ok = (bool((diff <= room).all())
                      and bool(torch.isfinite(got).all())
                      and torch.equal(got, again)
                      and pa_ops.KERNEL_LAUNCHES == before + 2)
                name = str(kv_dt)[6:]
                worst[name] = max(worst.get(name, 0.0), err)
                print(f"  pa hd256 q {str(q_dt)[6:]:8s} kv {name:13s} B{B} "
                      f"H{H}/{KV} NB{NB} cap{cap:<4g} cursors "
                      f"{GEMMA_PAGED_CURSORS} err={err:.2e} tol={tol:.1e} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    _fail(f"hd 256 paged decode q {q_dt} pages {kv_dt} cap "
                          f"{cap}: err {err:.2e}")
    out = {}
    for kv_dt in (f32, bf16, torch.int8, torch.float8_e4m3fn):
        name = str(kv_dt)[6:]
        out[name] = dict(paged_times(pa_ops, kv_dt, s, cap=50.0),
                         max_abs_err=worst[name])
    print(f"hd 256 paged parity: {n} cases within tolerance; worst error "
          f"per page dtype {worst}")
    return out


def hd256_registers(fa_regs, pa_regs) -> dict:
    """The hd-256 entry functions' (registers, spill bytes), out of every
    flash and paged entry function's."""
    fa = [r for r in fa_regs if "<256," in r[0]]
    pa = [r for r in pa_regs if ", hd 256," in r[0]]
    print("hd 256 entry functions (registers, spill bytes): flash "
          + "; ".join(f"{n} {r}, {sp}" for n, r, sp in fa) + " | paged "
          + "; ".join(f"{r}, {sp}" for _, r, sp in pa))
    if len(fa) != 6 or len(pa) != 24:
        _fail(f"hd 256 entry functions: {len(fa)} flash (6 expected), "
              f"{len(pa)} paged (24 expected)")
    return dict(flash=[list(r) for r in fa], paged=[list(r) for r in pa])


def _gemma_traffic(cfg, t):
    """[(prompt, budget)]: ``t["n"]`` prompts of lengths uniform in
    [lo, hi], drawn from ``t["seed"]``.  With ``t["shared"]`` every prompt
    begins with one shared prefix of that many tokens, and the first is
    that prefix alone: a sliding-window model hits the prefix cache only
    at a snapshot its publisher took (at its last page boundary below its
    length), so later prompts that extend the bare prefix hit there."""
    rng = np.random.default_rng(t["seed"])
    shared = rng.integers(0, cfg.vocab_size, (t.get("shared", 0),))
    lens = rng.integers(t["lo"], t["hi"] + 1, t["n"])
    if len(shared):
        lens[0] = len(shared)
    return [(np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, (int(P) - len(shared),))]).astype(np.int32),
        t["gen"]) for P in lens]


def _global_layers(cfg) -> int:
    return sum(cfg.layer_kind(i) == "attn" and cfg.layer_window(i) == 0
               for i in range(cfg.num_layers))


def _solo_streams(label, cfg, params, traffic, max_len):
    """Each request alone through ``ServeEngine.generate`` (contiguous
    cache, B=1, greedy), counters from 0: one flash launch per layer per
    prefill (windowed layers with their window), decode attention plain.
    Returns result-like records for ``streams_vs``."""
    import types
    from repro_torch.train.serve_engine import ServeEngine
    eng = ServeEngine(cfg, params, device="cuda", max_len=max_len)
    zero_counts()
    t0 = time.perf_counter()
    out = []
    for uid, (prompt, gen) in enumerate(traffic):
        res = eng.generate(prompt[None], gen)
        out.append(types.SimpleNamespace(
            uid=uid, prompt=prompt, new_tokens=res.tokens[0, len(prompt):],
            completed=True, finish_reason="limit"))
    expect_counts(label, flash_attention=len(traffic) * cfg.num_layers)
    print(f"  {label}: {len(traffic)} solo generations, "
          f"{len(traffic) * cfg.num_layers} flash launches (hd "
          f"{cfg.head_dim}; window layers with their window), "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def gemma2_full_serving(cfglib, registry) -> dict:
    """Phase 33: ``gemma2-9b`` at full width and ``GEMMA2_SERVE_DEPTH``
    layers (random weights drawn on the card), paged continuous serving in
    f32: 8
    requests into 4 slots, prompts uniform in 4160-6144 (past the 4096
    window: every ring wraps), 32 new tokens, pages of 16, counters from
    0: the paged kernel once per global layer per masked decode step
    (G = 2, hd 256, softcap 50), flash never; the pool returned; each
    stream held to solo ``generate`` (flash prefill with the window and
    the softcap) under phase 22's near-tie rule.  Returns launch counts."""
    from repro_torch.train.serve_engine import ServeEngine
    t0 = time.perf_counter()
    cfg = cfglib.get_config("gemma2-9b").with_depth(GEMMA2_SERVE_DEPTH)
    params = draw_on_card(registry, cfg)
    t = GEMMA2_TRAFFIC
    traffic = _gemma_traffic(cfg, t)
    max_len = t["hi"] + t["gen"] + 1
    eng = ServeEngine(cfg, params, device="cuda", max_len=max_len,
                      paged=True, block_size=PAGE)
    res, sched, stats, steps, peak = _run_counted(
        "gemma2-9b paged f32", eng, _requests_of(traffic),
        max_batch=t["slots"])
    n_glob = _global_layers(cfg)
    paged = expect_counts("gemma2-9b paged", paged_attention=steps * n_glob)[
        "paged_attention"]
    _check_served("gemma2-9b paged", cfg, [len(p) for p, _ in traffic],
                  [g for _, g in traffic], res, sched)
    del eng, sched
    torch.cuda.empty_cache()
    solo = _solo_streams("gemma2-9b solo", cfg, params, traffic, max_len)
    flash = cfg.num_layers * len(traffic)
    equal = streams_vs("gemma2-9b paged vs solo", cfg, registry, res, solo,
                       params)
    ring_gb = 2 * 4096 * cfg.num_kv_heads * cfg.head_dim * 4 \
        * (cfg.num_layers - n_glob) / 1e9
    print(f"gemma2-9b at {cfg.num_layers} layers: {len(traffic)} requests "
          f"(prompts "
          f"{min(len(p) for p, _ in traffic)}-"
          f"{max(len(p) for p, _ in traffic)}) at their budgets; {paged} "
          f"paged launches = {steps} decode steps x {n_glob} global layers; "
          f"{equal}/{len(res)} streams equal to solo generate; aggregate "
          f"tokens/s {stats['tokens_per_s']:.1f}, ttft p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; rings {ring_gb:.2f} GB a "
          f"row; peak {peak / 2 ** 30:.2f} GiB; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(paged=paged, flash_solo=flash,
                tokens_per_s=stats["tokens_per_s"])


def gemma3_serving(cfglib, registry) -> dict:
    """Phase 34: ``gemma3-12b`` at full width and 12 layers (two 5:1
    periods; random weights drawn on the card), 16 requests into 8 slots,
    prompts of 1280-2000 tokens (a 1280-token shared prefix, first alone:
    every ring of 1024 wraps), 32 tokens, pages of 16, counters from 0
    before each run: paged over f32 pages and over int8 pages (agreement
    with f32 at least ``QUANT_AGREEMENT``), the prefix cache (the requests
    admitted after the bare prefix published hit at its snapshot, 1264
    tokens, and restore its rings; streams held to the f32 run's under
    the near-tie rule) and ``--spec-depth 6 --gamma 4`` (flash once per
    draft layer per admission, paged never; streams held likewise).
    Returns launch counts per run."""
    from repro_torch.train.serve_engine import ServeEngine
    t0 = time.perf_counter()
    cfg = cfglib.get_config("gemma3-12b").with_depth(GEMMA3_DEPTH)
    params = draw_on_card(registry, cfg)
    t = GEMMA3_TRAFFIC
    traffic = _gemma_traffic(cfg, t)
    max_len = t["hi"] + t["gen"] + 1
    lens, gens = [len(p) for p, _ in traffic], [g for _, g in traffic]
    n_glob = _global_layers(cfg)
    out, runs = {}, {}
    for key, kw in (("f32", {}), ("int8", dict(kv_dtype="int8")),
                    ("prefix", dict(prefix_cache=True))):
        eng = ServeEngine(cfg, params, device="cuda", max_len=max_len,
                          paged=True, block_size=PAGE, **kw)
        res, sched, stats, steps, _ = _run_counted(
            f"gemma3-12b paged {key}", eng, _requests_of(traffic),
            max_batch=t["slots"])
        out[key] = expect_counts(f"gemma3-12b paged {key}",
                                 paged_attention=steps * n_glob)[
                                     "paged_attention"]
        _check_served(f"gemma3-12b paged {key}", cfg, lens, gens, res, sched)
        if key == "prefix":
            hits = [r for r in res if r.prefix_tokens]
            for r in hits:
                if r.prefix_tokens % PAGE or \
                        r.prefix_tokens > (len(r.prompt) - 1) // PAGE * PAGE:
                    _fail(f"gemma3 prefix request {r.uid} skipped "
                          f"{r.prefix_tokens} tokens, not a snapshot "
                          "boundary below P")
            if not hits:
                _fail(f"the gemma3 prefix-cache run had no hit: "
                      f"{sched.prefix_stats()}")
            print(f"  gemma3-12b prefix cache: hits {len(hits)}/{len(res)}, "
                  f"{sched.prefix_skipped_tokens} prompt tokens skipped "
                  "(each hit restored its publisher's ring snapshot)")
        runs[key] = res
        del eng, sched
        torch.cuda.empty_cache()
    hit, tot = _agreement(runs["f32"], runs["int8"])
    print(f"  gemma3-12b int8 pages: agreement with f32 {hit}/{tot} = "
          f"{hit / tot:.4f} (bar {QUANT_AGREEMENT})")
    if hit / tot < QUANT_AGREEMENT:
        _fail(f"gemma3 int8 agreement {hit / tot:.4f} < {QUANT_AGREEMENT}")
    streams_vs("gemma3-12b prefix vs f32", cfg, registry, runs["prefix"],
               runs["f32"], params)
    eng = ServeEngine(cfg, params, device="cuda", max_len=max_len,
                      paged=True, block_size=PAGE, spec_decode=True,
                      gamma=GEMMA3_GAMMA, draft_depth=GEMMA3_SPEC_DEPTH)
    res, sched, stats, _, _ = _run_counted(
        "gemma3-12b spec", eng, _requests_of(traffic), max_batch=t["slots"])
    out["spec"] = expect_counts(
        "gemma3-12b spec",
        flash_attention=GEMMA3_SPEC_DEPTH * len(traffic))["flash_attention"]
    _check_served("gemma3-12b spec", cfg, lens, gens, res, sched)
    mal = float(np.mean([r.mean_accepted_len for r in res]))
    print(f"  gemma3-12b spec (draft {GEMMA3_SPEC_DEPTH} layers, gamma "
          f"{GEMMA3_GAMMA}): {sched.spec_rounds} rounds, acceptance "
          f"{sched.acceptance_rate:.4f}, mean accepted length {mal:.4f}; "
          f"{out['spec']} flash launches = {len(traffic)} admissions x "
          f"{GEMMA3_SPEC_DEPTH} draft layers")
    streams_vs("gemma3-12b spec vs f32", cfg, registry, res, runs["f32"],
               params)
    del eng, sched
    print(f"gemma3-12b phase {time.perf_counter() - t0:.1f} s")
    return out


class _UniformTokens:
    """Training batches of uniform random tokens, drawn from a seed per
    step (``SyntheticLM``'s interface; its Zipf draws take ~12 s for one
    5120-token sequence over gemma's 256000-token vocabulary)."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab, self.seq_len, self.batch_size = vocab, seq_len, batch
        self.seed = seed

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        rng = np.random.default_rng((self.seed, step, shard))
        toks = rng.integers(0, self.vocab, (self.batch_size // num_shards,
                                            self.seq_len + 1))
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def gemma2_training(cfglib) -> dict:
    """Phase 35, gemma2's half: ``gemma2-9b`` at full width (hd 256,
    window 4096, softcaps) through ``ProgressiveTrainer``, 2 -> 4 layers
    at step 2 of 4, one 5120-token sequence a step, AdamW, remat at the
    launcher's ``--remat`` default for the arch (``REMAT_DEFAULTS``:
    'nothing'), every counter at 0 just before: the flash forward twice a
    layer a step (the checkpointed forward reruns in the backward), the
    backward once, no Newton–Schulz; finite losses, peak memory."""
    from repro_torch.configs.base import (ExpansionConfig, OptimizerConfig,
                                          ScheduleConfig, TrainConfig)
    from repro_torch.train.engine import ProgressiveTrainer
    t0 = time.perf_counter()
    g = GEMMA2_TRAIN
    cfg = cfglib.get_config("gemma2-9b").with_depth(g["target"])
    remat = cfglib.default_remat("gemma2-9b")
    tau = g["steps"] // 2
    tc = TrainConfig(total_steps=g["steps"], seq_len=g["seq"],
                     global_batch=g["batch"], source_layers=g["source"],
                     expansions=(ExpansionConfig(at_frac=tau / g["steps"],
                                                 target_layers=g["target"]),),
                     optimizer=OptimizerConfig(name="adamw",
                                               learning_rate=1e-4),
                     schedule=ScheduleConfig(name="constant"), seed=0,
                     eval_every=10_000, log_every=1, remat=remat)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = ProgressiveTrainer(
        cfg, tc, device="cuda", log_fn=lambda *a: None, eval_batches=[],
        data=_UniformTokens(cfg.vocab_size, g["seq"], g["batch"])).run()
    layers = [g["source"]] * tau + [g["target"]] * (g["steps"] - tau)
    counts = expect_counts("gemma2-9b training",
                           flash_attention=2 * sum(layers),
                           flash_attention_bwd=sum(layers))
    h = res.history
    if h["expansion_steps"] != [tau] or res.final_layers != g["target"] \
            or not all(np.isfinite(h["loss"])) or len(h["loss"]) != g["steps"]:
        _fail(f"gemma2-9b training: expansion {h['expansion_steps']}, "
              f"layers {res.final_layers}, losses {h['loss']}")
    peak = torch.cuda.max_memory_allocated()
    dts = [dt for _, dt in res.step_times]
    print(f"gemma2-9b training at full width: {g['source']} -> "
          f"{g['target']} layers at step {tau}, {g['batch']} x {g['seq']} "
          f"tokens a step (window 4096 binding), AdamW, remat {remat!r}: "
          f"losses {[round(x, 4) for x in h['loss']]}; launches {counts}; "
          f"step times {[round(1e3 * d, 1) for d in dts]} ms; peak device "
          f"memory {peak / 2 ** 30:.2f} GiB; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(flash_attention=counts["flash_attention"],
                flash_attention_bwd=counts["flash_attention_bwd"],
                peak_gib=peak / 2 ** 30)


def recipe_training(cfglib) -> dict:
    """Phase 35, the recipe's half: ``gpt2-12l`` at phase 13's settings
    (batch 16 x 256, 1 -> 12 layers at τ = 0.5, WSD, lr 0.01) for
    ``RECIPE_STEPS`` steps through ``train.loop.train`` under AdamW, NSGD
    and SGD, then AdamW under remat 'nothing' and 'dots': every loss and
    the final params of each remat run bit for bit those of remat off;
    each run's launches derived (flash forward once a layer a step, twice
    under remat; the backward once; no Newton–Schulz) and its own peak
    memory printed, each remat run's below remat off's."""
    from repro_torch.configs.base import (ExpansionConfig, OptimizerConfig,
                                          ScheduleConfig, TrainConfig)
    from repro_torch.train import loop
    t0 = time.perf_counter()
    cfg = cfglib.get_config("gpt2-12l")
    tau = int(TRAIN_TAU * RECIPE_STEPS)
    layers = [1] * tau + [cfg.num_layers] * (RECIPE_STEPS - tau)
    runs = {}
    for name, remat in (("adamw", False), ("nsgd", False), ("sgd", False),
                        ("adamw", "nothing"), ("adamw", "dots")):
        tc = TrainConfig(total_steps=RECIPE_STEPS, seq_len=256,
                         global_batch=16, source_layers=1,
                         expansions=(ExpansionConfig(
                             at_frac=TRAIN_TAU, target_layers=cfg.num_layers),),
                         optimizer=OptimizerConfig(name=name,
                                                   learning_rate=0.01),
                         schedule=ScheduleConfig(name="wsd"), seed=0,
                         log_every=1, remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        zero_counts()
        res = loop.train(cfg, tc, device="cuda")
        fwd = (2 if remat else 1) * sum(layers)
        expect_counts(f"{name} remat {remat}", flash_attention=fwd,
                      flash_attention_bwd=sum(layers))
        losses = res.history["loss"]
        if len(losses) != RECIPE_STEPS or not all(np.isfinite(losses)):
            _fail(f"gpt2-12l {name} remat {remat}: losses {losses}")
        # the run's own peak: what it allocated above what was held before
        # it (each run's params go to the host, so nothing is)
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        runs[(name, remat)] = (losses, [t.cpu() for t in _leaves(res.params)],
                               peak)
        del res
        print(f"  gpt2-12l {name} remat {remat!r}: losses "
              f"{[round(x, 4) for x in losses]}, flash {fwd} forward and "
              f"{sum(layers)} backward launches, peak {peak:.2f} GiB above "
              f"the {held / 2 ** 30:.2f} GiB held before it")
    base_l, base_p, base_peak = runs[("adamw", False)]
    for remat in ("nothing", "dots"):
        l, p, peak = runs[("adamw", remat)]
        if l != base_l or not all(torch.equal(a, b)
                                  for a, b in zip(p, base_p)):
            _fail(f"remat {remat!r}: losses {l} against {base_l}, or params "
                  "not bit-identical to remat off")
        if peak >= base_peak:
            _fail(f"remat {remat!r} peaked at {peak:.2f} GiB, not below "
                  f"remat off's {base_peak:.2f}")
        print(f"  remat {remat!r}: losses and params bit for bit those of "
              f"remat off; peak {peak:.2f} GiB against {base_peak:.2f}")
    print(f"recipe training phase {time.perf_counter() - t0:.1f} s")
    return {f"{n} remat {r}": v[2] for (n, r), v in runs.items()}


# Phase 36: the flash kernels at S_k != S_q (whisper-base's
# cross-attention: decoder queries over every encoder frame, non-causal),
# the encoder's own S = 1500 self-attention (no key tile of 64, 32 or 16
# divides 1500) and GQA with S_k != S_q: (label, B, S_q, S_k, H, KV, hd).
CROSS_FA = (("whisper cross", 4, 448, 1500, 8, 8, 64),
            ("whisper encoder", 4, 1500, 1500, 8, 8, 64),
            ("gqa cross", 2, 300, 1000, 8, 2, 128))


def cross_attention_lane(fa_ops) -> dict:
    """Phase 36: the forward and backward kernels, non-causal, at
    ``CROSS_FA``'s shapes in f32 and bf16, entry by entry against the
    plain version (phase 32's rule, ``_flash_room``: the forward against
    the plain version on f32 copies, dq, dk, dv against the plain backward
    on the kernel's own inputs), finite and bit-identical on repeat; then
    device times of the kernel, its plain version and SDPA's best
    non-causal call (which takes S_k != S_q itself) beside the card's
    bound: f32 on this route's three TF32 passes, bf16 at the bf16 peak.
    Returns {label: {dtype: {forward, backward}}}."""
    t0 = time.perf_counter()
    out = {}
    for n, (label, B, Sq, Sk, H, KV, hd) in enumerate(CROSS_FA):
        kw = dict(causal=False, window=0, logit_softcap=0.0)
        out[label] = {}
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(3600 + 10 * n)
            q, do = (torch.randn((B, Sq, H, hd), generator=g, device="cuda")
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn((B, Sk, KV, hd), generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            before = fa_ops.KERNEL_LAUNCHES, fa_ops.BWD_LAUNCHES
            got = fa_ops.flash_attention(q, k, v, force="kernel", **kw)
            again = fa_ops.flash_attention(q, k, v, force="kernel", **kw)
            want = fa_ops.flash_attention(q.float(), k.float(), v.float(),
                                          force="ref", **kw)
            gw, mags = _flash_plain(q, k, v, got, do, 0, 0.0, causal=False)
            room = _flash_room(want, mags[0], dtype)
            err = (got.float() - want).abs().max().item()
            ratio = _worst_ratio(got, want, room)
            gk = _bwd_pair(fa_ops, q, k, v, do, kw, "kernel")
            gk2 = _bwd_pair(fa_ops, q, k, v, do, kw, "kernel")
            rooms = [_flash_room(w, m, dtype, backward=True)
                     for w, m in zip(gw, mags[1:])]
            berrs = [(a.float() - b).abs().max().item()
                     for a, b in zip(gk, gw)]
            bratios = [_worst_ratio(a, b, r) for a, b, r in zip(gk, gw, rooms)]
            shapes = [tuple(t.shape) for t in gk]
            if (ratio > 1.0 or max(bratios) > 1.0
                    or fa_ops.KERNEL_LAUNCHES != before[0] + 4
                    or fa_ops.BWD_LAUNCHES != before[1] + 2
                    or shapes != [tuple(q.shape), tuple(k.shape),
                                  tuple(v.shape)]
                    or not all(bool(torch.isfinite(t).all())
                               for t in (got, *gk))
                    or not torch.equal(got, again)
                    or not all(torch.equal(a, b) for a, b in zip(gk, gk2))):
                _fail(f"flash at {label} (B={B} Sq={Sq} Sk={Sk} H={H}/{KV} "
                      f"hd={hd}) {dtype}: forward err {err:.2e} = {ratio:.3f} "
                      f"of its limit, dq/dk/dv err {berrs} at {bratios}, "
                      f"grad shapes {shapes}, repeats equal "
                      f"{torch.equal(got, again)}")
            del gk, gk2, gw, rooms, mags, want, again, room, got
            t = _flash_times(fa_ops, q, k, v, do, kw)
            fwd = dict(t["forward"], max_abs_err=err, err_over_limit=ratio)
            bwd = dict(t["backward"], max_abs_err=max(berrs),
                       err_over_limit=max(bratios))
            name = str(dtype)[6:]
            out[label][name] = dict(forward=fwd, backward=bwd)
            print(f"  {card_line()}: flash at {label} (B={B} Sq={Sq} Sk={Sk} "
                  f"H={H}/{KV} hd={hd}, non-causal) {name}: forward err "
                  f"{err:.2e} = {ratio:.3f} of its limit, kernel "
                  f"{fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, sdpa "
                  f"{fwd['library_backend']} {fwd['library_ms']:.4f} ms, "
                  f"bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']}); "
                  f"backward dq/dk/dv at {[round(r, 3) for r in bratios]} of "
                  f"their limits, kernel {bwd['ms']:.4f} ms, plain (autograd) "
                  f"{bwd['plain_ms']:.4f} ms, sdpa {bwd['library_backend']} "
                  f"{bwd['library_ms']:.4f} ms, bound {bwd['bound_ms']:.4f} "
                  f"ms ({bwd['bound_by']})")
            del q, k, v, do
            torch.cuda.empty_cache()
    # Causal attention at S_k != S_q has no caller: the wrapper refuses it.
    q, k, v = (torch.zeros((1, n, 8, 64), device="cuda") for n in (8, 16, 16))
    try:
        fa_ops.flash_attention(q, k, v, causal=True, force="kernel")
    except ValueError:
        pass
    else:
        _fail("causal flash attention at S_k != S_q was not refused")
    print(f"cross-attention lane phase {time.perf_counter() - t0:.1f} s")
    return out


# Phase 37: deepseekv3-0.3b (MLA) at full size.  Its training is the
# launcher's run of phase 25's length (1 -> DSV3_DEPTH layers); its serving
# traffic 6 requests into 3 slots over a 128-token shared prefix (the bare
# prefix first), prompts up to 448 tokens, 16 tokens each, pages of 16.
DSV3 = "deepseekv3-0.3b"
# Phase 37 trains and serves deepseekv3-0.3b at 4 of its 24 layers (cut
# to make room for phases 40-43: each layer adds the same host-bound work).
DSV3_DEPTH = 4
DSV3_TRAFFIC = dict(n=6, lo=160, hi=448, gen=16, slots=3, seed=37,
                    shared=128)
# Phase 38: qwen2-vl-2b at full width and depth (28 layers), text-only
# serving of 8 requests into 8 slots, then one training step of 2
# sequences of 256 frontend embeds + 256 tokens.
QWEN2VL = "qwen2-vl-2b"
QWEN2VL_TRAFFIC = dict(n=8, lo=256, hi=768, gen=32, slots=8, seed=38)
# Phase 38 runs qwen2-vl-2b at 4 of its 28 layers (cut to make room for
# phases 40-43: each layer adds the same host-bound step work).
QWEN2VL_DEPTH = 4
QWEN2VL_TRAIN_B, QWEN2VL_TRAIN_S = 2, 256
# Phase 39: whisper-base at full size (6 + 6 layers, 1500 frames): batches
# of 4 x 1500 frames and 448 tokens (the decoder's context), 2 Muon steps
# at 2 decoder layers, the expansion to 6, 2 more; then 32 greedy tokens.
WHISPER = "whisper-base"
WHISPER_B, WHISPER_S, WHISPER_G = 4, 448, 32


def _dropless(cfg):
    """``cfg`` with an MoE capacity of num_experts / top_k: every expert
    takes every token that picks it (a token picks an expert once), so a
    prefill routes alike in chunks and in one piece.  At the configs'
    1.25 which tokens overflow depends on how they are grouped, and a
    chunked prefill groups them otherwise than ``generate``'s."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def _on_card(params):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.cuda(), params)


def deepseekv3_paths(cfglib, registry, train, serve, fa_ops) -> dict:
    """Phase 37: ``deepseekv3-0.3b`` at full size.  The paper's recipe
    through ``launch/train.py`` (phase 25's length: 1 -> ``DSV3_DEPTH``
    layers at step
    3 of 6, Muon-NSGD under WSD; flash forward and backward at hd 64, G = 2
    on the up-projected K/V; the Newton–Schulz kernels over the latent
    projections and the expert stacks).  Its grown checkpoint served
    with continuous batching over paged KV, the pages holding latent rows:
    f32 pages, int8 pages, the prefix cache (hits held to the f32 run's
    streams); no kernel launches there (the latent read is plain, as in
    the reference; chunked prefill is plain).  The f32 streams held to
    solo ``generate`` (flash prefill) under phase 22's near-tie rule.  The
    int8 run's agreement with f32 is a finding, not held to the
    reference's 0.9: a perturbation that moves a token's hidden state
    flips its top-2 experts where the router's second and third logits
    are close, so an MoE model's int8 stream leaves the f32 one far more
    often than a dense one's (the int8 MLA path is held to the CPU's
    instead, at depth 2).  The paper's draft: the run's one-layer
    checkpoint at step 3 expanded by ``copying_zeroL`` to that depth and
    drafted
    at depth 1 (acceptance at least ``SPEC_ZEROL_ACCEPTANCE``, one flash
    launch an admission), its streams held to the source's solo
    generation.  Serving routes dropless (``_dropless``), so that chunked
    and one-piece prefills route alike.  Then card against CPU at depth 2:
    a generation, the int8 prefix-cache run and one train step.  Returns
    launch counts and readings."""
    from repro_torch.core import expansion
    from repro_torch.train.serve_engine import ServeEngine
    t0 = time.perf_counter()
    cfg = cfglib.get_config(DSV3).with_depth(DSV3_DEPTH)
    out = {}
    saved = train.cfglib
    # launch/train.py draws and grows the model at DSV3_DEPTH
    train.cfglib = types.SimpleNamespace(**{
        **vars(saved), "get_config": lambda name: cfg if name == DSV3
        else saved.get_config(name)})
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "run")
        try:
            _, out["training"] = train_main_path(cfg, train, ckpt_dir,
                                                 MIXTRAL_TRAIN_ARGV)
        finally:
            train.cfglib = saved
        p24, _ = serve.load_params(ckpt_dir, cfg)
        p1, cfg1 = serve.load_params(ckpt_dir, cfg, step=int(
            TRAIN_TAU * 6))
    print(f"  {DSV3} training phase {time.perf_counter() - t0:.1f} s")
    scfg = _dropless(cfg)
    p24 = _on_card(p24)
    t = DSV3_TRAFFIC
    traffic = _gemma_traffic(cfg, t)
    max_len = t["hi"] + t["gen"] + 1
    lens, gens = [len(p) for p, _ in traffic], [g for _, g in traffic]
    r = cfg.mla_kv_lora_rank
    runs = {}
    for key, kw in (("f32", {}), ("int8", dict(kv_dtype="int8")),
                    ("prefix", dict(prefix_cache=True))):
        label = f"{DSV3} paged {key}"
        eng = ServeEngine(scfg, p24, device="cuda", max_len=max_len,
                          paged=True, block_size=PAGE, **kw)
        res, sched, stats, steps, _ = _run_counted(
            label, eng, _requests_of(traffic), max_batch=t["slots"])
        expect_counts(label)           # the latent read is plain: no kernel
        if steps == 0:
            _fail(f"{label} ran no masked decode step")
        _check_served(label, cfg, lens, gens, res, sched)
        ks = sched.kv_stats()
        want = cfg.num_layers * (r + 4 if key == "int8" else 4 * r)
        if ks["kv_bytes_per_token"] != want:
            _fail(f"{label}: {ks['kv_bytes_per_token']} pool bytes a token, "
                  f"expected {want} (latent rows of {r})")
        print(f"  {label}: {steps} masked decode steps, pool bytes a token "
              f"{ks['kv_bytes_per_token']} (f32 K/V pages would take "
              f"{cfg.num_layers * 8 * cfg.kv_dim})")
        if key == "prefix":
            ps = sched.prefix_stats()
            if ps["prefix_hits"] < 1:
                _fail(f"the {DSV3} prefix-cache run had no hit: {ps}")
            print(f"  {DSV3} prefix cache: hits {ps['prefix_hits']}/"
                  f"{ps['prefix_requests']}, {ps['prefix_skipped_tokens']} "
                  "prompt tokens skipped")
        out[f"paged_{key}"] = dict(tokens_per_s=stats["tokens_per_s"],
                                   ttft_p50_s=stats["ttft_p50_s"],
                                   decode_steps=steps)
        runs[key] = res
        del eng, sched
    hit, tot = _agreement(runs["f32"], runs["int8"])
    print(f"  {DSV3} int8 latent pages: agreement with f32 {hit}/{tot} = "
          f"{hit / tot:.4f} (a finding: MoE routing flips, see above)")
    out["int8_agreement"] = hit / tot
    streams_vs(f"{DSV3} prefix vs f32", scfg, registry, runs["prefix"],
               runs["f32"], p24)
    solo = _solo_streams(f"{DSV3} solo generate", scfg, p24, traffic,
                         max_len)
    out["paged_equal_solo"] = streams_vs(f"{DSV3} paged vs solo", scfg,
                                         registry, runs["f32"], solo, p24)
    del p24
    # the paper's draft from the run's own one-layer checkpoint
    p1 = _on_card(p1)
    zl = expansion.expand_params(p1, cfg1, cfg.num_layers, "copying_zeroL")
    eng = ServeEngine(scfg, zl, device="cuda", max_len=max_len, paged=True,
                      block_size=PAGE, spec_decode=True, gamma=SPEC_GAMMA,
                      draft_depth=1)
    res, sched, stats, _, _ = _run_counted(
        f"{DSV3} zeroL spec", eng, _requests_of(traffic),
        max_batch=t["slots"])
    out["spec"] = expect_counts(f"{DSV3} zeroL spec",
                                flash_attention=len(traffic))[
                                    "flash_attention"]
    _check_served(f"{DSV3} zeroL spec", cfg, lens, gens, res, sched)
    rate = sched.acceptance_rate
    print(f"  {DSV3} zeroL spec (1 -> {cfg.num_layers} layers, draft depth "
          f"1, gamma {SPEC_GAMMA}): {sched.spec_rounds} rounds, acceptance "
          f"{rate:.4f}, {out['spec']} flash launches (the draft's prefills)")
    if rate < SPEC_ZEROL_ACCEPTANCE:
        _fail(f"{DSV3} zeroL acceptance {rate:.4f} < {SPEC_ZEROL_ACCEPTANCE}")
    out["zerol_acceptance"] = rate
    s1 = _dropless(cfg1)
    solo1 = _solo_streams(f"{DSV3} one-layer source solo", s1, p1, traffic,
                          max_len)
    streams_vs(f"{DSV3} zeroL spec vs its source", s1, registry, res, solo1,
               p1)
    del eng, sched, zl, p1
    gc.collect()
    torch.cuda.empty_cache()
    card_vs_cpu(cfglib, registry, ServeEngine, fa_ops, DSV3, 2,
                dropless=True)
    quant_card_vs_cpu(cfglib, registry, DSV3, 2, dropless=True)
    train_card_vs_cpu(cfglib, registry, DSV3, 2)
    print(f"{DSV3} phase {time.perf_counter() - t0:.1f} s")
    return out


def qwen2_vl_paths(cfglib, registry, fa_ops) -> dict:
    """Phase 38: ``qwen2-vl-2b`` at full width and ``QWEN2VL_DEPTH``
    layers (drawn on the card), M-RoPE with text ids.  Text-only
    continuous serving over paged KV, f32 and int8 pages (the paged kernel
    at G = 6, hd 128, once a layer a masked decode step; the int8 run's
    agreement with f32 a finding: at this width with random weights the
    top-2 logit gaps are small beside int8's error, 0.75 on the CPU at
    depth 2), the f32 streams held to solo ``generate`` under the near-tie
    rule; then one ``make_train_step`` step (Muon-NSGD) on 2
    sequences of 256 frontend embeds prepended to 256 tokens, the loss over
    the text: flash forward and backward once a layer over 512 positions,
    the Newton–Schulz kernels over the stacks and the 151936-row
    embedding; then card against CPU at depth 2 (a generation, and the
    int8 prefix-cache run held to the CPU's at the int8 lane).  Returns
    launch counts and readings."""
    from repro_torch.configs.base import OptimizerConfig, ScheduleConfig
    from repro_torch.core.schedules import make_schedule
    from repro_torch.optim.base import make_optimizer
    from repro_torch.train import steps as steps_lib
    from repro_torch.train.serve_engine import ServeEngine
    t0 = time.perf_counter()
    cfg = cfglib.get_config(QWEN2VL).with_depth(QWEN2VL_DEPTH)
    params = draw_on_card(registry, cfg)
    t = QWEN2VL_TRAFFIC
    traffic = _gemma_traffic(cfg, t)
    max_len = t["hi"] + t["gen"] + 1
    lens, gens = [len(p) for p, _ in traffic], [g for _, g in traffic]
    out, runs = {}, {}
    for key, kw in (("f32", {}), ("int8", dict(kv_dtype="int8"))):
        label = f"{QWEN2VL} paged {key}"
        eng = ServeEngine(cfg, params, device="cuda", max_len=max_len,
                          paged=True, block_size=PAGE, **kw)
        res, sched, stats, steps, _ = _run_counted(
            label, eng, _requests_of(traffic), max_batch=t["slots"])
        out[f"paged_{key}"] = expect_counts(
            label, paged_attention=steps * cfg.num_layers)["paged_attention"]
        if steps == 0:
            _fail(f"{label} ran no masked decode step")
        _check_served(label, cfg, lens, gens, res, sched)
        out[f"paged_{key}_tokens_per_s"] = stats["tokens_per_s"]
        runs[key] = res
        del eng, sched
    hit, tot = _agreement(runs["f32"], runs["int8"])
    print(f"  {QWEN2VL} int8 pages: agreement with f32 {hit}/{tot} = "
          f"{hit / tot:.4f} (a finding; the int8 path is held to the CPU's "
          "at depth 2 below)")
    out["int8_agreement"] = hit / tot
    solo = _solo_streams(f"{QWEN2VL} solo generate", cfg, params, traffic,
                         max_len)
    out["paged_equal_solo"] = streams_vs(f"{QWEN2VL} paged vs solo", cfg,
                                         registry, runs["f32"], solo, params)
    # one training step with the frontend's embeds prepended
    opt = make_optimizer(OptimizerConfig())
    step = steps_lib.make_train_step(cfg, opt, make_schedule(
        ScheduleConfig(), 0.01, 100))
    g = torch.Generator(device="cuda").manual_seed(38)
    B, S, N = QWEN2VL_TRAIN_B, QWEN2VL_TRAIN_S, cfg.num_frontend_embeds
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "embeds": torch.randn((B, N, cfg.d_model), generator=g,
                                   device="cuda")}
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.perf_counter()
    params, state, m = step(params, state, batch, 0)
    loss = float(m["loss"])
    dt = time.perf_counter() - t1
    fused, large = _ns_launches(cfg)
    out["training"] = expect_counts(
        f"{QWEN2VL} train step", flash_attention=cfg.num_layers,
        flash_attention_bwd=cfg.num_layers, ns_fused=fused, matmul=large)
    if not math.isfinite(loss):
        _fail(f"{QWEN2VL} train step loss {loss}")
    print(f"  {QWEN2VL} train step: {B} x ({N} embeds + {S} tokens), loss "
          f"{loss:.4f} over the text, {dt * 1e3:.1f} ms (the first step), "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"{out['training']}")
    out["train_step_ms"], out["train_loss"] = dt * 1e3, loss
    del params, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    card_vs_cpu(cfglib, registry, ServeEngine, fa_ops, QWEN2VL, 2)
    quant_card_vs_cpu(cfglib, registry, QWEN2VL, 2)
    print(f"{QWEN2VL} phase {time.perf_counter() - t0:.1f} s")
    return out


def whisper_paths(cfglib, registry) -> dict:
    """Phase 39: ``whisper-base`` at full size.  Muon-NSGD steps through
    ``make_train_step`` on batches of 4 x 1500 frames and 448 tokens: 2 at
    2 decoder layers (2 encoder layers), ``expand_params`` to 6 (the
    encoder scaled to 6 with it, 'random'), 2 more; per step and layer the
    flash kernels run the encoder's S = 1500 self-attention, the decoder's
    causal self-attention and its cross-attention at S_k = 1500 != S_q =
    448, forward and backward.  Then greedy decoding of 32 tokens through
    ``encdec_decode_step`` (the encoder once through flash; the decode's
    attention plain, as in the reference) equal to the teacher-forced
    argmax of ``encdec_apply`` under the near-tie rule.  Returns launch
    counts and readings."""
    from repro_torch.configs.base import OptimizerConfig, ScheduleConfig
    from repro_torch.core import expansion
    from repro_torch.core.schedules import make_schedule
    from repro_torch.models import encdec
    from repro_torch.optim.base import make_optimizer
    from repro_torch.train import steps as steps_lib
    t0 = time.perf_counter()
    cfg = cfglib.get_config(WHISPER)
    cfg2 = cfg.with_depth(2)
    api = registry.get_model(cfg)
    # the 2-layer source of the full config: its encoder at 6 * 2 / 6 = 2
    # layers (an init of cfg2, whose num_layers is 2, would keep 6)
    params = api.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      num_layers=2, device="cuda")
    opt = make_optimizer(OptimizerConfig())
    sched = make_schedule(ScheduleConfig(), 0.01, 100)
    g = torch.Generator(device="cuda").manual_seed(39)
    B, S, T = WHISPER_B, WHISPER_S, cfg.encoder_seq_len

    def batch():
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                             device="cuda")
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "frames": torch.randn((B, T, cfg.d_model), generator=g,
                                      device="cuda")}
    def enc_depth(p):
        leaf = p["enc_blocks"]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        return leaf.shape[0]
    if enc_depth(params) != encdec.encoder_depth(cfg, 2):
        _fail(f"{WHISPER} source: {enc_depth(params)} encoder layers")
    state = opt.init(params)
    fused, large = _ns_launches(cfg)
    zero_counts()
    losses, times, depths = [], [], []
    for c, n in ((cfg2, 2), (cfg, 2)):
        if c is cfg:
            params, state = expansion.make_expand_fn(cfg2, cfg.num_layers,
                                                     "random")(
                params, state, torch.Generator(device="cuda").manual_seed(1))
        step = steps_lib.make_train_step(c, opt, sched)
        for _ in range(n):
            b = batch()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, state, m = step(params, state, b, len(losses))
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t1)
            depths.append(c.num_layers)
    enc_depths = [encdec.encoder_depth(cfg, L) for L in depths]
    per_step = [e + 2 * d for e, d in zip(enc_depths, depths)]
    out = {"training": expect_counts(
        f"{WHISPER} training", flash_attention=sum(per_step),
        flash_attention_bwd=sum(per_step), ns_fused=fused * len(losses),
        matmul=large * len(losses))}
    if enc_depth(params) != cfg.num_encoder_layers or \
            not all(math.isfinite(x) for x in losses):
        _fail(f"{WHISPER} training: encoder depth {enc_depth(params)} after "
              f"the expansion, losses {losses}")
    print(f"  {WHISPER} training: steps at decoder depths {depths} (encoder "
          f"{enc_depths}), losses {[round(x, 4) for x in losses]}, step "
          f"times {[round(x * 1e3, 1) for x in times]} ms; launches "
          f"{out['training']}")
    out["losses"], out["step_ms"] = losses, [x * 1e3 for x in times]
    # greedy decoding against teacher forcing
    frames, G = batch()["frames"], WHISPER_G
    with torch.inference_mode():
        zero_counts()
        enc = encdec.encode(params, cfg, frames)
        cache = api.init_cache(params, cfg, B, G + 1, torch.float32,
                               device="cuda", enc_out=enc)
        toks = [torch.zeros((B, 1), dtype=torch.long, device="cuda")]
        logs = []
        for t in range(G):
            lg, cache = api.decode_step(params, cfg, toks[-1], cache,
                                        torch.full((B,), t, device="cuda"))
            logs.append(lg)
            toks.append(lg.argmax(-1))
        out["decode"] = expect_counts(f"{WHISPER} decode",
                                      flash_attention=cfg.num_encoder_layers)
        stream = torch.cat(toks, dim=1)
        zero_counts()
        tf, _ = api.apply(params, cfg, stream[:, :-1], frames)
        out["teacher_forced"] = expect_counts(
            f"{WHISPER} teacher forcing",
            flash_attention=cfg.num_encoder_layers + 2 * cfg.num_layers)
    dec = torch.cat(logs, dim=1)
    diff = (dec - tf).abs().max().item()
    for b in range(B):
        got, want = stream[b, 1:], tf[b].argmax(-1)
        if torch.equal(got, want):
            continue
        i = int((got != want).nonzero()[0])
        top2 = torch.topk(tf[b, i].float(), 2).values
        gap = float(top2[0] - top2[1])
        print(f"  {WHISPER} row {b}: first differs at token {i}, top-2 gap "
              f"{gap:.3e}")
        if gap >= SPEC_TIE_GAP:
            _fail(f"{WHISPER} greedy row {b} leaves the teacher-forced "
                  f"argmax at token {i} with a top-2 gap {gap:.3e}")
    print(f"  {WHISPER} greedy decode: {B} x {G} tokens through "
          f"encdec_decode_step equal the teacher-forced argmax of "
          f"encdec_apply (where the gap allows); logits within {diff:.2e}; "
          f"{cfg.num_encoder_layers} flash launches (the encoder) in "
          f"decoding, {out['teacher_forced']['flash_attention']} in the "
          "teacher-forced forward")
    out["decode_vs_teacher_forced_max_abs"] = diff
    if diff > LOGIT_TOL:
        _fail(f"{WHISPER} decode logits differ from teacher forcing by "
              f"{diff:.2e} > {LOGIT_TOL:.0e}")
    del params, state, cache, enc
    print(f"{WHISPER} phase {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phases 40-42: the paper's expansion-timing recipe, and training rwkv6-7b
# and jamba on the card through the recurrent backward kernels
# ---------------------------------------------------------------------------

# Phase 40: core/recipe.calibrate_tau on gpt2-12l at full width: two probes
# of RECIPE_PROBE_STEPS steps at the launcher's batch (16 x 256, Muon-NSGD
# under WSD, a one-layer source) for a production run of RECIPE_TOTAL steps.
RECIPE_PROBE_STEPS, RECIPE_TOTAL = 40, 1000

# The backward kernels against their plain reverse recurrences, entry by
# entry: 1e-4 of max(1, max|plain|) (f32 sums in other orders; the kernels
# re-run their states from the forward's chunk starts), plus 2^-7 |plain|
# where the gradient is bfloat16 (both sides round it once, and two f32
# values a hair apart can round to neighbouring bf16 values, one unit in the
# last place apart).  The gradients of dtype f32 (dw, du, the states' and
# the scan's dA, dD) take the f32 rule whatever the inputs' dtype.
REC_BWD_TOL = 1e-4
# Phase 41's grid of lengths: one step, around and at the forward's chunks
# (16 at hd 128, 32 otherwise), past them, and the serving shape's.
# (15 and 63 cut for time: 16, 17, 64 and 100 take the chunk boundaries)
WKV_BWD_S = (1, 16, 17, 64, 100, 1024)
# rwkv6-7b trained at full width, 2 -> 4 of its 32 layers (copying_stack at
# half the steps), Muon-NSGD, batches of 4 x 1024 (full depth holds about
# 90 GB with grads and momentum and does not fit the card).
RWKV_TRAIN = dict(source=2, target=4, steps=4, batch=4, seq=1024)
# One step at depth 1, card against CPU: the loss to TRAIN_LOSS_TOL and
# every gradient leaf within REC_GRAD_TOL of its largest CPU entry (cuBLAS
# and MKL f32 products and the kernels against the plain forms, through one
# layer and the 65536-wide head).
REC_GRAD_TOL = 1e-3
REC_CPU_BATCH = dict(batch=2, seq=64)
# Phase 42's grid of the scan backward.
SCAN_BWD_S, SCAN_BWD_D = (1, 15, 64, 100, 1024), (16, 200, 1000)
# jamba at full width, its first two layers (a dense Mamba layer, a Mamba
# layer with the 16-expert MoE) as a period-2 pattern of their own: the
# 8-layer period admits no depth 1 or 2, and the two-layer pattern no depth
# 1, so the run trains depth 2 (3.57 B params; 4 layers, 6.6 B, do not fit
# with grads and momentum).  NSGD, not Muon-NSGD: Muon over the 48 expert
# matrices of 4096 x 14336 is ~264 TFLOP of 3xTF32 work a step, seconds a
# step beside the scan's milliseconds.
JAMBA_TRAIN = dict(layers=2, steps=3, batch=4, seq=1024, optimizer="nsgd")


def _load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` unrun)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recipe_phase(cfglib) -> dict:
    """Phase 40: ``calibrate_tau`` on ``gpt2-12l`` at full width through
    ``train.loop.train`` on the card, every counter at 0 just before: the
    probes' steps, the ``MixingReport``, τ and the production plan, each
    kernel's launches against the count the two probes imply; then the
    quickstart's eq (1.1) savings line for that plan."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import recipe
    t0 = time.perf_counter()
    cfg = cfglib.get_config("gpt2-12l")
    base = TrainConfig(total_steps=RECIPE_TOTAL, seq_len=256,
                       global_batch=16, source_layers=1)
    zero_counts()
    res = recipe.calibrate_tau(cfg, base, probe_steps=RECIPE_PROBE_STEPS,
                               log_fn=lambda m: print(f"  {m}"),
                               device="cuda")
    counts = read_counts()
    T = res.probe_steps
    warmup = max(1, int(base.schedule.warmup_frac * T))
    exp = max(1, int((warmup + 1) / T * T))         # the trainer's rounding
    layers = [cfg.num_layers] * T + [base.source_layers] * exp \
        + [cfg.num_layers] * (T - exp)
    fused, large = _ns_launches(cfg)
    want = {name: 0 for name in COUNTERS}
    want.update(flash_attention=sum(layers), flash_attention_bwd=sum(layers),
                ns_fused=fused * 2 * T, matmul=large * 2 * T)
    if counts != want:
        _fail(f"calibrate_tau launches {counts}, expected {want}")
    rep = res.mixing
    e = res.train_config.expansions[0]
    warm_prod = int(base.schedule.warmup_frac * base.total_steps)
    stable_end = base.total_steps - max(1, int(base.total_steps
                                               * base.schedule.decay_frac))
    if not warm_prod < res.tau <= stable_end or e.target_layers != 12 \
            or abs(e.at_frac - res.tau / base.total_steps) > 1e-9:
        _fail(f"calibrate_tau: tau {res.tau} outside ({warm_prod}, "
              f"{stable_end}] or plan {e}")
    quick = _load_example("quickstart_torch")
    line = quick.savings_line(cfg, base.total_steps, res.tau,
                              base.seq_len * base.global_batch,
                              base.source_layers)
    print(f"calibrate_tau gpt2-12l: probes of {T} steps (16 x 256, "
          f"Muon-NSGD, WSD; expansion 1 -> 12 at step {exp}); "
          f"MixingReport(mixed={rep.mixed}, mix_step={rep.mix_step}, "
          f"mix_tokens={rep.mix_tokens}, tolerance={rep.tolerance}); "
          f"tau = {res.tau} of {base.total_steps} ({e.init}); launches "
          f"{counts}")
    print(f"  quickstart_torch: {line}")
    sec = time.perf_counter() - t0
    print(f"recipe phase {sec:.1f} s")
    return dict(tau=res.tau, mixed=rep.mixed, mix_step=rep.mix_step,
                mix_tokens=rep.mix_tokens, probe_steps=T, launches=counts,
                savings=line, seconds=sec)


def _bwd_ratio(got, want) -> float:
    """The largest |got - plain| over its entry's limit (``REC_BWD_TOL``)."""
    w = want.float()
    room = torch.full_like(w, REC_BWD_TOL * max(1.0, w.abs().max().item()))
    if want.dtype == torch.bfloat16:
        room = room + 2.0 ** -7 * w.abs()
    return _worst_ratio(got, w, room)


def _grads_through(fn, leaves_in, cotangents):
    """Gradients of sum(out * cotangent) over ``fn``'s outputs with respect
    to ``leaves_in`` (fresh leaves), through autograd."""
    leaves = [t.detach().clone().requires_grad_() for t in leaves_in]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * c.float()).sum()
               for o, c in zip(outs, cotangents) if c is not None)
    return torch.autograd.grad(loss, leaves)


def wkv_bwd_parity(wkv_ops) -> dict:
    """Phase 41, its kernel lane: the WKV backward through ``wkv``'s
    autograd Function (the forward saving its chunk states, then the
    backward kernel) against ``ref.wkv_bwd_ref`` on the same inputs and
    cotangents (dy, and the final state's), every gradient entry by entry
    and finite, over head dim x length x decays x zero/random S_0 x dtype,
    one backward launch a case; then the serving shape (f32) and 3 repeats
    there, bit-identical, f32 and bf16."""
    from repro_torch.kernels.rwkv6 import ref
    t0 = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(2, S, 2, hd, dtype, state, decay)
             for dtype in (f32, bf16) for hd in (16, 32, 64, 128)
             for S in WKV_BWD_S for decay in WKV_DECAYS
             for state in (False, True)]
    cases.append(RWKV_SHAPE[:3] + (RWKV_SHAPE[3], f32, True, "near 0.69"))
    bad, worst, main_err = 0, {}, 0.0
    for n, (B, S, H, hd, dtype, state, decay) in enumerate(cases):
        args = wkv_case(B, S, H, hd, dtype, state, WKV_DECAYS[decay],
                        seed=5000 + n, zeros=decay == "near 0")
        g = torch.Generator(device="cuda").manual_seed(6000 + n)
        dy = torch.randn(args[0].shape, generator=g, device="cuda").to(dtype)
        ds = torch.randn(args[5].shape, generator=g, device="cuda")
        before = wkv_ops.BWD_LAUNCHES
        got = _grads_through(wkv_ops.wkv, args, (dy, ds))
        torch.cuda.synchronize()
        want = ref.wkv_bwd_ref(*args, dy, ds)
        ratio = max(_bwd_ratio(a, b) for a, b in zip(got, want))
        ok = (ratio <= 1.0 and wkv_ops.BWD_LAUNCHES == before + 1
              and all(a.dtype == b.dtype for a, b in zip(got, want))
              and all(bool(torch.isfinite(a).all()) for a in got))
        bad += not ok
        label = (f"{str(dtype)[6:]:8s} B{B} S{S:<4d} H{H:<2d} hd{hd:<3d} "
                 f"state {'rand' if state else 'zero'} decay {decay}")
        if dtype not in worst or ratio > worst[dtype][0]:
            worst[dtype] = (ratio, label)
        if not ok:
            print(f"  wkv bwd {label}: {ratio:.3f} of the limit FAIL")
        if n == len(cases) - 1:
            main_err = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(got, want))
        del got, want
    for dtype, (ratio, label) in worst.items():
        print(f"  wkv bwd worst {str(dtype)[6:]}: {ratio:.3f} of the limit "
              f"at {label}")
    if bad:
        _fail(f"{bad} of {len(cases)} WKV backward cases")
    print(f"wkv bwd parity: {len(cases)} cases within their entry-by-entry "
          f"limits, finite, one backward launch each; serving shape max abs "
          f"err {main_err:.3e}")
    B, S, H, hd = RWKV_SHAPE
    for dtype in (f32, bf16):
        args = wkv_case(B, S, H, hd, dtype, True, WKV_DECAYS["near 0.69"], 8)
        g = torch.Generator(device="cuda").manual_seed(9)
        dy = torch.randn(args[0].shape, generator=g, device="cuda").to(dtype)
        first = _grads_through(wkv_ops.wkv, args, (dy, None))
        for _ in range(3):
            again = _grads_through(wkv_ops.wkv, args, (dy, None))
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                _fail(f"wkv backward repeats differ ({dtype})")
    print("wkv bwd: 3 repeats bit-identical at the serving shape, f32 and "
          f"bf16 (every gradient); phase {time.perf_counter() - t0:.1f} s")
    return dict(cases=len(cases), worst={str(k)[6:]: v[0]
                                         for k, v in worst.items()},
                max_abs_err=main_err)


def wkv_bwd_times(wkv_ops) -> dict:
    """The backward kernel at the serving shape, f32 and bf16 r/k/v, L2
    flushed (CUDA events), beside its bound and the plain reverse
    recurrence's time (f32)."""
    from repro_torch.kernels.rwkv6 import ref
    from repro_torch.roofline import torch_cost
    B, S, H, hd = RWKV_SHAPE
    flush = _flusher()
    C = wkv_ops._entry("wkv_chunk_steps")(hd)
    if C != wkv_ops.chunk_steps(hd):
        _fail(f"wkv.cu's chunk of {C} steps at hd {hd}, ops.chunk_steps "
              f"says {wkv_ops.chunk_steps(hd)}")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        r, k, v, w, u, s0 = wkv_case(B, S, H, hd, dtype, True,
                                     WKV_DECAYS["near 0.69"], 11)
        _, _, chunks = wkv_ops.wkv_cuda(r, k, v, w, u, s0, save_chunks=True)
        g = torch.Generator(device="cuda").manual_seed(12)
        dy = torch.randn(r.shape, generator=g, device="cuda").to(dtype)
        ds = torch.randn(s0.shape, generator=g, device="cuda")
        ms = _time_device_ms(lambda: wkv_ops.wkv_bwd_cuda(
            r, k, v, w, u, chunks, dy, ds), 10, flush)
        # 17 f32 operations a state entry and step on the CUDA cores; r,
        # k, v, dy, w and the chunk states in, dr, dk, dv, dw out
        work = torch_cost.wkv_bwd(B, S, H, hd, C, itemsize=r.element_size())
        flops, nbytes, bound = work.flops, work.bytes, work.bound()
        name = str(dtype)[6:]
        print(f"wkv bwd kernel at B={B} S={S} H={H} hd={hd} {name} r/k/v "
              f"(chunks of {C}), L2 flushed: {ms:.4f} ms; bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP f32), "
              f"{ms / bound['bound_ms']:.2f}x")
        out[name] = (ms, bound, (r, k, v, w, u, s0, dy, ds))
    ms, bound, args = out["float32"]
    plain_ms = _time_ms(lambda: ref.wkv_bwd_ref(*args), 2)
    print(f"wkv bwd times at B={B} S={S} H={H} hd={hd} f32: kernel "
          f"{ms:.4f} ms, plain reverse recurrence {plain_ms:.4f} ms, "
          f"library none; bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, **bound,
                bf16_ms=out["bfloat16"][0],
                bf16_bound_ms=out["bfloat16"][1]["bound_ms"])


def _cut_params(params, cfg, device="cuda"):
    """``cfg``'s params taken from a deeper or wider-patterned draw of the
    same architecture: each leaf of ``cfg``'s tree at the same path, the
    stacked blocks' leading axis cut to ``cfg``'s; copies on ``device``."""
    from repro_torch.models import registry
    from repro_torch.tree import leaves_with_path
    like = registry.get_model(cfg).init(None, cfg, device="meta")
    out = {}
    for path, x in leaves_with_path(like):
        src = params
        for key in path:
            src = src[key]
        if path[0] == "blocks":
            src = src[:x.shape[0]]
        if tuple(src.shape) != tuple(x.shape) or src.dtype != x.dtype:
            _fail(f"cutting {cfg.name}: {path} {tuple(src.shape)} "
                  f"{src.dtype}, expected {tuple(x.shape)} {x.dtype}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = src.detach().to(device, copy=True)
    return out


def _train_from(params, cfg, tcfg):
    """``train.loop``'s trainer (``ProgressiveTrainer``) on the card with
    its fresh init replaced by ``params`` (a cut of weights drawn earlier,
    instead of a host draw of the same size), uniform-token batches, every
    counter at 0 just before.  Returns (result, counts, peak GiB)."""
    from repro_torch.train.engine import ProgressiveTrainer

    class FromParams(ProgressiveTrainer):
        def _init_state(self, c):
            if c.num_layers != tcfg.source_layers:
                _fail(f"{c.name}: fresh init at {c.num_layers} layers")
            return params, self.opt.init(params)

    data = _UniformTokens(cfg.vocab_size, tcfg.seq_len, tcfg.global_batch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = FromParams(cfg, tcfg, data=data, device="cuda",
                     log_fn=lambda *a: None, async_ckpt=False).run()
    torch.cuda.synchronize()
    return res, read_counts(), torch.cuda.max_memory_allocated() / 2 ** 30


def _check_training(label, res, counts, want, layers):
    h = res.history
    if counts != want:
        _fail(f"{label} training launches {counts}, expected {want}")
    if h["layers"] != layers or not all(np.isfinite(h["loss"])):
        _fail(f"{label} training: losses {h['loss']} at layers "
              f"{h['layers']}, expected layers {layers}")


def rwkv_training(cfglib, src) -> dict:
    """Phase 41's training: ``rwkv6-7b`` at full width from ``src`` (a
    2-layer cut of phase 15's weights), expanded to 4 (``copying_stack``)
    at half of ``RWKV_TRAIN``'s steps, Muon-NSGD, 4 x 1024 tokens a step:
    finite losses, the expansion, and every kernel's launches against the
    count the run implies (the WKV forward and backward once a layer a
    step)."""
    from repro_torch.configs.base import ExpansionConfig, TrainConfig
    t0 = time.perf_counter()
    c = RWKV_TRAIN
    cfg = cfglib.get_config("rwkv6-7b").with_depth(c["target"])
    tau = c["steps"] // 2
    tcfg = TrainConfig(
        total_steps=c["steps"], seq_len=c["seq"], global_batch=c["batch"],
        source_layers=c["source"], expansions=(ExpansionConfig(
            at_frac=tau / c["steps"], target_layers=c["target"],
            init="copying_stack"),),
        eval_every=10 ** 9, checkpoint_every=10 ** 9, log_every=1)
    res, counts, peak = _train_from(src, cfg, tcfg)
    del src
    layers = [c["source"]] * tau + [c["target"]] * (c["steps"] - tau)
    want = {name: 0 for name in COUNTERS}
    want.update(wkv=sum(layers), wkv_bwd=sum(layers))
    for n in layers:
        fused, large = _ns_launches(cfg.with_depth(n))
        want["ns_fused"] += fused
        want["matmul"] += large
    _check_training("rwkv6-7b", res, counts, want, layers)
    ms = [round(1e3 * t, 1) for _, t in res.step_times]
    n_params = sum(t.numel() for t in _leaves(res.params))
    print(f"rwkv6-7b training at full width: {c['source']} -> "
          f"{c['target']} layers at step {tau} (copying_stack), "
          f"{c['batch']} x {c['seq']} tokens a step, Muon-NSGD: losses "
          f"{[round(x, 4) for x in res.history['loss']]}; {n_params} params "
          f"at {c['target']} layers; launches {counts}; step times {ms} ms; "
          f"peak device memory {peak:.2f} GiB; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(launches=counts, losses=res.history["loss"], step_ms=ms,
                peak_gib=peak, params=n_params)


def _loss_and_grads(params, cfg, batch):
    from repro_torch.models import transformer as tr
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = tr.lm_loss(params, cfg, batch["tokens"], batch["labels"])
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return float(loss.detach()), grads


def train_grads_card_vs_cpu(label, cfg, card, host, kernel) -> dict:
    """One loss and backward at ``cfg`` (full width, reduced depth) from the
    same params on the card (``card``) and the CPU (``host``), on the same
    batch (``REC_CPU_BATCH``): the loss to ``TRAIN_LOSS_TOL``, every
    gradient leaf within ``REC_GRAD_TOL`` of its largest CPU entry; the
    card's backward kernel ``kernel`` launched once a layer."""
    c = REC_CPU_BATCH
    host_batch = _UniformTokens(cfg.vocab_size, c["seq"], c["batch"],
                                seed=7).batch(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for side, p in (("card", card), ("host", host)):
        dev = next(iter(_leaves(p))).device
        batch = {k: torch.from_numpy(v).long().to(dev)
                 for k, v in host_batch.items()}
        zero_counts()
        t0 = time.perf_counter()
        out[side] = _loss_and_grads(p, cfg, batch) + (
            time.perf_counter() - t0, read_counts()[kernel])
    if out["card"][3] != cfg.num_layers or out["host"][3] != 0:
        _fail(f"{label} card vs cpu: {kernel} launches {out['card'][3]} "
              f"on the card, {out['host'][3]} on the CPU")
    loss_diff = abs(out["card"][0] - out["host"][0])
    worst, worst_i = 0.0, -1
    for i, (a, b) in enumerate(zip(out["card"][1], out["host"][1])):
        rel = (a.cpu() - b).abs().max().item() / max(
            b.abs().max().item(), 1e-30)
        if not bool(torch.isfinite(a).all()) or rel > worst:
            worst, worst_i = (float("inf") if not bool(
                torch.isfinite(a).all()) else rel), i
    from repro_torch.tree import leaves_with_path
    names = [".".join(p) for p, _ in leaves_with_path(host)]
    print(f"{label} train card vs cpu at {cfg.num_layers} layer(s): loss "
          f"{out['card'][0]:.6f} vs {out['host'][0]:.6f} (diff "
          f"{loss_diff:.2e}, tol {TRAIN_LOSS_TOL:.0e}); worst gradient "
          f"{worst:.2e} of its largest entry at {names[worst_i]} (tol "
          f"{REC_GRAD_TOL:.0e}, {len(names)} leaves); CPU "
          f"{out['host'][2]:.1f} s")
    if loss_diff > TRAIN_LOSS_TOL or worst > REC_GRAD_TOL:
        _fail(f"{label}: one loss and backward differ between the card and "
              "the CPU")
    return dict(loss_diff=loss_diff, worst_grad_rel=worst)


def rwkv_backward_phase(cfglib, params):
    """Phase 41's first half (right after phase 27, on phase 15's
    weights): the depth-1 step card against CPU, and the 2-layer cut the
    training starts from.  Returns (readings, cut); the caller frees
    ``params`` before ``rwkv_backward_rest``."""
    cfg = cfglib.get_config("rwkv6-7b")
    cfg1 = cfg.with_depth(1)
    card = _cut_params(params, cfg1)
    host = _cut_params(params, cfg1, device="cpu")
    vs = train_grads_card_vs_cpu("rwkv6-7b", cfg1, card, host, "wkv_bwd")
    del card, host
    cut = _cut_params(params, cfg.with_depth(RWKV_TRAIN["source"]))
    return dict(card_vs_cpu=vs), cut


def rwkv_backward_rest(cfglib, wkv_ops, out, cut) -> dict:
    """Phase 41's second half, with the 32-layer weights freed: the WKV
    backward's lane and times, then ``rwkv6-7b`` trained 2 -> 4 layers
    from ``cut``."""
    t0 = time.perf_counter()
    out.update(lane=wkv_bwd_parity(wkv_ops), times=wkv_bwd_times(wkv_ops))
    print(f"rwkv backward lanes {time.perf_counter() - t0:.1f} s")
    out["training"] = rwkv_training(cfglib, cut)
    return out


def scan_bwd_parity(scan_ops) -> dict:
    """Phase 42, its kernel lane: the scan backward through both entry
    points' autograd Function (h0 and the final state's gradient on
    ``selective_scan_with_state``) against ``ref.selective_scan_bwd_ref``,
    every gradient entry by entry and finite, over N x length x channels x
    decays x dtype; then jamba's shape (f32) and 3 repeats there,
    bit-identical, f32 and bf16."""
    from repro_torch.kernels.mamba_scan import ref
    t0 = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(2, S, d, N, dtype, regime, with_state)
             for dtype in (f32, bf16) for N in (4, 16) for S in SCAN_BWD_S
             for d in SCAN_BWD_D for regime in SCAN_REGIMES
             for with_state in (True, False)]
    cases.append(JAMBA_SCAN_SHAPE[:3] + (JAMBA_SCAN_SHAPE[3], f32, "near 1",
                                        True))
    bad, worst, main_err = 0, {}, 0.0
    for n, (B, S, d, N, dtype, regime, with_state) in enumerate(cases):
        u, dt, A, Bm, Cm, Dp, h0 = scan_case(B, S, d, N, dtype, True, regime,
                                             seed=7000 + n)
        g = torch.Generator(device="cuda").manual_seed(8000 + n)
        dy = torch.randn(u.shape, generator=g, device="cuda").to(dtype)
        dh = torch.randn(h0.shape, generator=g, device="cuda")
        before = scan_ops.BWD_LAUNCHES
        if with_state:
            got = _grads_through(
                lambda *a: scan_ops.selective_scan_with_state(*a[:6],
                                                              h0=a[6]),
                (u, dt, A, Bm, Cm, Dp, h0), (dy, dh))
            want = ref.selective_scan_bwd_ref(u, dt, A, Bm, Cm, Dp, h0, dy,
                                              dh)
        else:
            got = _grads_through(scan_ops.selective_scan,
                                 (u, dt, A, Bm, Cm, Dp), (dy,))
            want = ref.selective_scan_bwd_ref(u, dt, A, Bm, Cm, Dp, None,
                                              dy)[:6]
        torch.cuda.synchronize()
        ratio = max(_bwd_ratio(a, b) for a, b in zip(got, want))
        ok = (ratio <= 1.0 and scan_ops.BWD_LAUNCHES == before + 1
              and all(a.dtype == b.dtype for a, b in zip(got, want))
              and all(bool(torch.isfinite(a).all()) for a in got))
        bad += not ok
        label = (f"{str(dtype)[6:]:8s} B{B} S{S:<4d} d{d:<5d} N{N:<2d} "
                 f"dtA {regime}{' h0+final' if with_state else ''}")
        if dtype not in worst or ratio > worst[dtype][0]:
            worst[dtype] = (ratio, label)
        if not ok:
            print(f"  scan bwd {label}: {ratio:.3f} of the limit FAIL")
        if n == len(cases) - 1:
            main_err = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(got, want))
        del got, want
    for dtype, (ratio, label) in worst.items():
        print(f"  scan bwd worst {str(dtype)[6:]}: {ratio:.3f} of the limit "
              f"at {label}")
    if bad:
        _fail(f"{bad} of {len(cases)} scan backward cases")
    print(f"scan bwd parity: {len(cases)} cases within their entry-by-entry "
          f"limits, finite, one backward launch each; jamba's shape max abs "
          f"err {main_err:.3e}")
    B, S, d, N = JAMBA_SCAN_SHAPE
    for dtype in (f32, bf16):
        u, dt, A, Bm, Cm, Dp, h0 = scan_case(B, S, d, N, dtype, True,
                                             "model", seed=13)
        g = torch.Generator(device="cuda").manual_seed(14)
        dy = torch.randn(u.shape, generator=g, device="cuda").to(dtype)

        def grads():
            return _grads_through(
                lambda *a: scan_ops.selective_scan_with_state(*a[:6],
                                                              h0=a[6]),
                (u, dt, A, Bm, Cm, Dp, h0), (dy, None))
        first = grads()
        for _ in range(3):
            if not all(torch.equal(a, b) for a, b in zip(first, grads())):
                _fail(f"scan backward repeats differ ({dtype})")
    print("scan bwd: 3 repeats bit-identical at jamba's shape, f32 and bf16 "
          f"(every gradient); phase {time.perf_counter() - t0:.1f} s")
    return dict(cases=len(cases), worst={str(k)[6:]: v[0]
                                         for k, v in worst.items()},
                max_abs_err=main_err)


def scan_bwd_times(scan_ops) -> dict:
    """The backward kernel at jamba's shape, f32 and bf16, L2 flushed
    (CUDA events), beside its bound, the SFU's floor for its exps, and the
    plain reverse recurrence's time (f32)."""
    from repro_torch.kernels.mamba_scan import ref
    from repro_torch.roofline import torch_cost
    B, S, d, N = JAMBA_SCAN_SHAPE
    flush = _flusher()
    K = scan_ops._entry("selective_scan_save_steps")()
    if K != scan_ops.SAVE_STEPS:
        _fail(f"selective_scan.cu saves every {K} steps, ops.SAVE_STEPS "
              f"says {scan_ops.SAVE_STEPS}")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        u, dt, A, Bm, Cm, Dp, h0 = scan_case(B, S, d, N, dtype, True,
                                             "model", seed=15)
        _, _, saved = scan_ops.selective_scan_cuda(u, dt, A, Bm, Cm, Dp, h0,
                                                   save_states=True)
        g = torch.Generator(device="cuda").manual_seed(16)
        dy = torch.randn(u.shape, generator=g, device="cuda").to(dtype)
        dh = torch.randn(h0.shape, generator=g, device="cuda")
        ms = _time_device_ms(lambda: scan_ops.selective_scan_bwd_cuda(
            u, dt, A, Bm, Cm, Dp, saved, dy, dh), 10, flush)
        # Per state entry and step: two re-runs of the state (3 operations
        # and an exp each) and the step back (20 operations and an exp),
        # plus ~2 adds of the channel sums: 28 f32 operations, 3 exps.
        work = torch_cost.selective_scan_bwd(B, S, d, N, K,
                                             itemsize=u.element_size())
        flops, nbytes, bound = work.flops, work.bytes, work.bound()
        name = str(dtype)[6:]
        print(f"scan bwd kernel at B={B} S={S} d={d} N={N} {name}, L2 "
              f"flushed: {ms:.4f} ms; bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP f32), {ms / bound['bound_ms']:.2f}x")
        out[name] = (ms, bound, (u, dt, A, Bm, Cm, Dp, h0, dy, dh))
    ms, bound, args = out["float32"]
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split(",")[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = B * -(-d // 64)
    busiest = -(-ctas // n_sm) * 64 * S * N * 3
    sfu_ms = busiest / 16 / (clock * 1e6) * 1e3
    plain_ms = _time_ms(lambda: ref.selective_scan_bwd_ref(*args), 2)
    print(f"scan bwd SFU floor: {busiest / 1e6:.2f} M exps on the busiest SM "
          f"({ctas} CTAs on {n_sm} SMs) / 16 a clock at {clock:.0f} MHz = "
          f"{sfu_ms:.4f} ms, beside the bound {bound['bound_ms']:.4f} ms")
    print(f"scan bwd times at B={B} S={S} d={d} N={N} f32: kernel {ms:.4f} "
          f"ms, plain reverse recurrence {plain_ms:.4f} ms, library none; "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, **bound,
                bf16_ms=out["bfloat16"][0],
                bf16_bound_ms=out["bfloat16"][1]["bound_ms"],
                sfu_floor_ms=sfu_ms)


def _jamba_cut(cfg, layers: int):
    """jamba's first ``layers`` layers as a pattern of their own."""
    return dataclasses.replace(cfg, block_pattern=cfg.block_pattern[:layers],
                               moe_pattern=cfg.moe_pattern[:layers],
                               num_layers=layers)


def jamba_training(cfg8, params) -> dict:
    """Phase 42's training: jamba's first two layers at full width (cut
    from phase 19's weights), ``JAMBA_TRAIN``'s steps through the trainer,
    NSGD, 4 x 1024 tokens a step: finite losses and the scan's forward and
    backward once a Mamba layer a step, no other kernel."""
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    t0 = time.perf_counter()
    c = JAMBA_TRAIN
    cfg = _jamba_cut(cfg8, c["layers"])
    tcfg = TrainConfig(total_steps=c["steps"], seq_len=c["seq"],
                       global_batch=c["batch"], source_layers=c["layers"],
                       optimizer=OptimizerConfig(name=c["optimizer"]),
                       eval_every=10 ** 9, checkpoint_every=10 ** 9,
                       log_every=1)
    res, counts, peak = _train_from(params, cfg, tcfg)
    n_mamba = sum(cfg.layer_kind(i) == "mamba" for i in range(c["layers"]))
    want = {name: 0 for name in COUNTERS}
    want.update(selective_scan=n_mamba * c["steps"],
                selective_scan_bwd=n_mamba * c["steps"])
    _check_training("jamba", res, counts, want, [c["layers"]] * c["steps"])
    ms = [round(1e3 * t, 1) for _, t in res.step_times]
    n_params = sum(t.numel() for t in _leaves(res.params))
    print(f"jamba training at full width: layers 0-1 (dense Mamba, Mamba + "
          f"16-expert MoE), {c['steps']} steps of {c['batch']} x {c['seq']} "
          f"tokens, {c['optimizer']}: losses "
          f"{[round(x, 4) for x in res.history['loss']]}; {n_params} "
          f"params; launches {counts}; step times {ms} ms; peak device "
          f"memory {peak:.2f} GiB; phase {time.perf_counter() - t0:.1f} s")
    return dict(launches=counts, losses=res.history["loss"], step_ms=ms,
                peak_gib=peak, params=n_params)


def jamba_backward_phase(cfg8, params, host=None):
    """Phase 42's first half (right after phase 29's jamba half, on phase
    19's weights): the depth-1 (dense Mamba layer) step card against CPU
    from ``host`` (phase 20's host copy; cut from the card when None), and
    the two-layer cut the training starts from.  Returns (readings, cut);
    the caller frees the 8-layer weights before ``jamba_backward_rest``."""
    cfg1 = _jamba_cut(cfg8, 1)
    card1 = _cut_params(params, cfg1)
    host1 = _cut_params(params if host is None else host, cfg1,
                        device="cpu")
    vs = train_grads_card_vs_cpu("jamba", cfg1, card1, host1,
                                 "selective_scan_bwd")
    del card1, host1
    cut = _cut_params(params, _jamba_cut(cfg8, JAMBA_TRAIN["layers"]))
    return dict(card_vs_cpu=vs), cut


def jamba_backward_rest(scan_ops, cfg8, out, cut) -> dict:
    """Phase 42's second half, with the 8-layer weights freed: the scan
    backward's lane and times, then jamba's first two layers trained from
    ``cut``."""
    t0 = time.perf_counter()
    out.update(lane=scan_bwd_parity(scan_ops), times=scan_bwd_times(scan_ops))
    print(f"jamba backward lanes {time.perf_counter() - t0:.1f} s")
    out["training"] = jamba_training(cfg8, cut)
    return out


# ---------------------------------------------------------------------------
# 43. The mesh: gpt2-12l at full width, depth 1 -> 2 at step 4 of 8, global
# batch 16 x 256, Muon-NSGD under WSD, on a 'single' mesh (one NCCL rank)
# against mesh=None in this process, then on two ranks that share the card
# over gloo at 2x1 (FSDP/DP) and 1x2 (TP), spawned once.
# ---------------------------------------------------------------------------

MESH_STEPS, MESH_TAU = 8, 0.5
# Per-step losses of the two-rank meshes against the single mesh: the
# reference's own tolerance for its sharded runs (tests/test_distributed.py).
MESH_LOSS_TOL = 1e-4
# (c) the next step's loss, restored under 2x1 against mesh=None: the same
# params and batch; only the DP mean of two half-batch means differs.
MESH_RESUME_TOL = 1e-5
# (d) 1x2 logits against solo generate: TP sums heads, d_ff and vocab rows
# in two halves; the reference's TP tolerance.
MESH_LOGIT_TOL = 1e-4
MESH_PROMPTS = (4, 64, 8)       # (B, P, G) of the serving half
# The paged kernel at a rank's local shape against its plain version,
# relative to max(1, max|plain|): f32 sums in other orders over f32 pages,
# the same dequantizing product over int8 ones.
PAGED_TP_TOL = 1e-4
# A two-rank mesh's larger per-rank training peak over mesh=None's: half
# the state and half the activations a rank, plus one whole leaf gathered
# at a time.
MESH_PEAK_RATIO = 0.85


def _mesh_tcfg(total=MESH_STEPS):
    from repro_torch.configs.base import (ExpansionConfig, OptimizerConfig,
                                          ScheduleConfig, TrainConfig)
    return TrainConfig(
        total_steps=total, seq_len=256, global_batch=16, source_layers=1,
        expansions=(ExpansionConfig(at_frac=MESH_TAU, target_layers=2,
                                    init="random"),),
        optimizer=OptimizerConfig(name="muon_nsgd"),
        schedule=ScheduleConfig(name="wsd"), eval_every=10_000,
        checkpoint_every=10_000, log_every=1, seed=0)


def _mesh_counts(cfg):
    """One rank's launches in an 8-step run (every rank computes every
    step of its shard: one flash forward and backward a layer a step on
    its rows or heads, and every Muon matrix whole); every other kernel
    0."""
    tau = int(MESH_TAU * MESH_STEPS)
    layers = [1] * tau + [2] * (MESH_STEPS - tau)
    fused, large = _ns_launches(cfg)
    want = {name: 0 for name in COUNTERS}
    want.update(flash_attention=sum(layers),
                flash_attention_bwd=sum(layers),
                ns_fused=fused * MESH_STEPS, matmul=large * MESH_STEPS)
    return want


def _serve_counts(cfg):
    """One rank's launches in one greedy ``generate`` of the grown model:
    one prefill, one flash forward a layer on the rank's rows (2x1) or
    heads (1x2); contiguous decode attention is plain torch; every other
    kernel 0."""
    want = {name: 0 for name in COUNTERS}
    want["flash_attention"] = cfg.num_layers
    return want


# (e) continuous serving on the mesh: 8 requests (16 until phase 44, cut
# for time; phase 44 serves the same 8) into 4 slots (4 divides both
# ranks of 2x1) over pages of 16, prompts of 32-160 tokens, the even
# ones opening with one shared 64-token (4-page) prefix, 16-32 new tokens,
# greedy, all queued at once, served from the grown checkpoint.  No
# warm-up run: every process has trained and served before (a)-(d).
MESH_CSERVE_REQUESTS, MESH_CSERVE_SLOTS, MESH_CSERVE_BLOCK = 8, 4, 16
MESH_CSERVE_SHARED = 64
MESH_CSERVE_MAX_LEN = 192              # the longest prompt + budget
MESH_CSERVE_KW = {
    "f32": dict(paged=True, block_size=MESH_CSERVE_BLOCK),
    "int8+prefix": dict(paged=True, block_size=MESH_CSERVE_BLOCK,
                        kv_dtype="int8", prefix_cache=True),
    "spec": dict(paged=True, block_size=MESH_CSERVE_BLOCK, spec_decode=True,
                 draft_depth=1, gamma=4)}
MESH_CSERVE_RUNS = {"2x1": ("f32", "int8+prefix", "spec"),
                    "1x2": ("f32", "spec")}


# (f)-(h): (e)'s traffic over f32 pages under faults and the placement
# knobs.  Backoff 0: a faulted row retries at the next iteration whatever
# the clock reads, so a mesh's site hits are mesh=None's under one storm.
MESH_STORM = "storm:0.05:0"
MESH_FAULT_SCHED = dict(snapshot_every=1, retry_backoff_s=0.0)
MESH_CRASH_ITER = 20
MESH_CRASH_RUNS = ("f32", "spec")
MESH_KNOBS = {"fsdp": ("2x1", dict(fsdp=True)),
              "layout": ("1x2", dict(layout="fsdp"))}
# (h)'s paged runs serve (e)'s first 4 requests (cut for time: each decode
# step gathers every leaf through gloo, ~12 tokens/s on two ranks).
MESH_KNOB_REQUESTS = 4
# A rank's resident parameter bytes under a knob over mesh=None's: every
# leaf split in two but for the few whose dims do not divide.
MESH_KNOB_BYTES = 0.55


def _mesh_traffic(vocab: int) -> list:
    """Phase 43's serving traffic (``MESH_CSERVE_*``), from seed 5."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, (MESH_CSERVE_SHARED,))
    reqs = []
    for i in range(MESH_CSERVE_REQUESTS):
        P, G = int(rng.integers(32, 161)), int(rng.integers(16, 33))
        if i % 2 == 0:
            P = max(P, MESH_CSERVE_SHARED + 1)
            prompt = np.concatenate([shared, rng.integers(
                0, vocab, (P - MESH_CSERVE_SHARED,))])
        else:
            prompt = rng.integers(0, vocab, (P,))
        reqs.append(dict(prompt=prompt.astype(np.int32), max_new_tokens=G))
    return reqs


def _as_results(reqs, got) -> list:
    """``mesh_runs.cserve``'s results as the ``RequestResult`` fields that
    ``streams_vs`` reads."""
    out = []
    for req, r in zip(reqs, got["results"], strict=True):
        P = len(req["prompt"])
        out.append(types.SimpleNamespace(
            uid=r["uid"], prompt=np.asarray(r["tokens"][:P]),
            new_tokens=np.asarray(r["tokens"][P:]),
            finish_reason=r["finish_reason"],
            completed=r["finish_reason"] in ("eos", "limit")))
    return out


def _cserve_stats(got) -> dict:
    """The stats that every rank and ``mesh=None`` must share: prefix hits
    and skipped tokens, rounds, acceptance, mean accepted length."""
    sp, pf = got["stats"]["spec"], got["stats"]["prefix"]
    mal = [r["mean_accepted_len"] for r in got["results"]
           if r["spec_rounds"]]
    return {"prefix_hits": pf["prefix_hits"],
            "prefix_skipped_tokens": pf["prefix_skipped_tokens"],
            "spec_rounds": sp["spec_rounds"],
            "acceptance": sp["acceptance_rate"],
            "mean_accepted_len": float(np.mean(mal)) if mal else 0.0}


def mesh_serving(ranks, none, traffic, cfg, params, card) -> dict:
    """(e): each two-rank continuous run against ``mesh=None``'s run of the
    same mode: every rank's results and stats alike; streams equal under
    phase 22's near-tie rule; prefix hits and skipped tokens equal to
    ``mesh=None``'s, acceptance too where every stream is equal; at 2x1
    the radix tree's pages (int8 values and scales) hashing alike on both
    ranks; each rank's launches those of ``mesh=None``'s run (one paged
    launch a layer a masked decode step over the rank's rows or heads; a
    spec run's one flash launch an admission, the draft's replicated B=1
    prefill, and no paged launch).  Returns the readings."""
    from repro_torch.models import registry
    out = {}
    n = len(traffic)
    for spec, runs in MESH_CSERVE_RUNS.items():
        for run in runs:
            name = f"cserve_{spec}_{run}"
            ref = none[run]
            got = [res[name] for res in ranks]
            for r, g in enumerate(got):
                if [x["tokens"].tolist() for x in g["results"]] != \
                        [x["tokens"].tolist() for x in got[0]["results"]]:
                    _fail(f"{name}: rank {r}'s streams differ from rank 0's")
                if _cserve_stats(g) != _cserve_stats(got[0]):
                    _fail(f"{name}: rank {r}'s stats {_cserve_stats(g)} "
                          f"differ from rank 0's {_cserve_stats(got[0])}")
                if [x["admitted_s"] for x in g["results"]] != \
                        [x["admitted_s"] for x in got[0]["results"]]:
                    _fail(f"{name}: rank {r}'s admission times differ")
                if g["counts"] != ref["counts"]:
                    _fail(f"{name}: rank {r} launches {g['counts']}, "
                          f"expected mesh=None's {ref['counts']}")
            if any(x["finish_reason"] != "limit" for x in got[0]["results"]):
                _fail(f"{name}: not every request ran to its budget")
            paged = ref["counts"]["paged_attention"]
            if run == "spec":
                want = {k: 0 for k in COUNTERS}
                want["flash_attention"] = n       # draft depth 1
                if ref["counts"] != want:
                    _fail(f"{name}: mesh=None launches {ref['counts']}, "
                          f"expected {want}")
            elif paged <= 0 or paged % cfg.num_layers or any(
                    v for k, v in ref["counts"].items()
                    if k != "paged_attention"):
                _fail(f"{name}: mesh=None launches {ref['counts']}, "
                      f"expected {cfg.num_layers} paged a decode step and "
                      "no other kernel")
            equal = streams_vs(f"phase 43 {name}", cfg, registry,
                               _as_results(traffic, got[0]),
                               _as_results(traffic, ref), params)
            st, st_none = _cserve_stats(got[0]), _cserve_stats(ref)
            keys = ("prefix_hits", "prefix_skipped_tokens") + (
                tuple(st) if equal == n else ())
            if any(st[k] != st_none[k] for k in keys):
                _fail(f"{name}: stats {st} against mesh=None's {st_none}")
            rec = {"streams_equal": equal, "stats": st,
                   "launches_per_rank": [g["counts"] for g in got],
                   "launches_mesh_none": ref["counts"],
                   "tokens_per_s": got[0]["summary"]["tokens_per_s"],
                   "tokens_per_s_mesh_none": ref["summary"]["tokens_per_s"],
                   "ttft_p50_s": got[0]["summary"]["ttft_p50_s"],
                   "ttft_p50_s_mesh_none": ref["summary"]["ttft_p50_s"]}
            if run == "int8+prefix":
                hashes = [g["radix_hash"] for g in got]
                if spec == "2x1" and len(set(hashes)) != 1:
                    _fail(f"{name}: the radix tree's pages differ between "
                          f"ranks: {hashes}")
                if st["prefix_hits"] < 1:
                    _fail(f"{name}: no prefix hit")
                rec["radix_hash_equal_mesh_none"] = \
                    hashes[0] == ref["radix_hash"]
                print(f"  (e) {name}: radix-tree pages (int8 values and "
                      f"scales) hash alike on both ranks "
                      f"({hashes[0][:16]}), equal to mesh=None's: "
                      f"{rec['radix_hash_equal_mesh_none']}")
            print(f"  (e) {name}: {equal} of {n} streams equal mesh=None's "
                  f"(the rest at near-ties); stats {st} on both ranks; "
                  f"launches per rank {[g['counts'] for g in got]}, as "
                  f"mesh=None's; {rec['tokens_per_s']:.1f} tokens/s, TTFT "
                  f"p50 {1e3 * rec['ttft_p50_s']:.1f} ms against mesh=None's "
                  f"{rec['tokens_per_s_mesh_none']:.1f}, "
                  f"{1e3 * rec['ttft_p50_s_mesh_none']:.1f} ms [{card}]")
            out[name] = rec
    for kv in ("float32", "int8"):
        err = max(res[f"paged_6_heads_{kv}"]["max_abs_err"] for res in ranks)
        if not err <= PAGED_TP_TOL:
            _fail(f"paged kernel at the 1x2 local shape over {kv} pages: "
                  f"{err}")
        out[f"paged_6_heads_{kv}"] = err
        print(f"  (e) paged kernel at the 1x2 local shape (B 4, 6 heads of "
              f"64, 12 pages of 16) over {kv} pages vs plain: {err:.3g} "
              f"(limit {PAGED_TP_TOL})")
    return out


def _same_streams(label, got):
    """Every rank's tokens and finish reasons alike."""
    first = [(x["tokens"].tolist(), x["finish_reason"])
             for x in got[0]["results"]]
    for r, g in enumerate(got):
        if [(x["tokens"].tolist(), x["finish_reason"])
                for x in g["results"]] != first:
            _fail(f"{label}: rank {r}'s streams differ from rank 0's")


def mesh_fault_lanes(ranks, none, traffic, cfg, params, solo, card) -> dict:
    """(f)-(h) of phase 43 against ``none`` (``mesh=None``'s clean f32
    run, its storm run, its run of (h)'s requests) and ``solo``
    (``mesh=None``'s ``generate``).  Returns the readings."""
    from repro_torch.models import registry
    out = {}
    n = len(traffic)
    clean = _as_results(traffic, none["f32"])
    # (f) the storm
    ref = none["storm"]
    want_fault = ref["stats"]["fault"]
    for spec in ("2x1", "1x2"):
        name = f"storm_{spec}"
        got = [res[name] for res in ranks]
        _same_streams(name, got)
        for r, g in enumerate(got):
            if g["stats"]["fault"] != want_fault:
                _fail(f"{name}: rank {r}'s fault stats {g['stats']['fault']}"
                      f" against mesh=None's {want_fault}")
            if g["counts"] != ref["counts"]:
                _fail(f"{name}: rank {r} launches {g['counts']}, expected "
                      f"mesh=None's {ref['counts']}")
        reasons = [x["finish_reason"] for x in got[0]["results"]]
        if reasons != [x["finish_reason"] for x in ref["results"]]:
            _fail(f"{name}: finish reasons {reasons} against mesh=None's")
        if not want_fault["retries"] or ref["counts"]["paged_attention"] <= 0:
            _fail(f"{name}: the storm retried nothing or decoded nothing")
        equal = streams_vs(f"phase 43 (f) {name}", cfg, registry,
                           _as_results(traffic, got[0]), clean, params)
        out[name] = {"streams_equal": equal, "finish_reasons": reasons,
                     "fault": want_fault,
                     "launches_per_rank": [g["counts"] for g in got],
                     "tokens_per_s": got[0]["summary"]["tokens_per_s"],
                     "goodput": got[0]["summary"]["goodput"],
                     "seconds": got[0]["seconds"],
                     "clean_seconds": ranks[0][f"cserve_{spec}_f32"][
                         "seconds"]}
        print(f"  (f) {name}: {MESH_STORM} over f32 pages: retries "
              f"{want_fault['retries']}, site hits "
              f"{want_fault['fault_sites']}, reasons "
              f"{ {k: reasons.count(k) for k in set(reasons)} } on both "
              f"ranks, as mesh=None's; {equal} of {n} streams equal the "
              f"clean run's; paged launches per rank "
              f"{[g['counts']['paged_attention'] for g in got]} (mesh=None "
              f"{ref['counts']['paged_attention']}); run "
              f"{out[name]['seconds']:.2f} s against the clean run's "
              f"{out[name]['clean_seconds']:.2f} s [{card}]")
    # (g) crash-restore at 2x1
    for run in MESH_CRASH_RUNS:
        name = f"crash_2x1_{run}"
        got = [res[name] for res in ranks]
        _same_streams(name, got)
        for r, g in enumerate(got):
            if not g["crashed"]:
                _fail(f"{name}: rank {r} ran past sched.iter:"
                      f"{MESH_CRASH_ITER}:crash")
            if g["counts"] != got[0]["counts"]:
                _fail(f"{name}: rank {r} launches {g['counts']}, rank 0 "
                      f"{got[0]['counts']}")
        kernel = "flash_attention" if run == "spec" else "paged_attention"
        if got[0]["counts"][kernel] <= 0:
            _fail(f"{name}: no {kernel} launch through the crash and the "
                  "restore")
        if any(x["finish_reason"] != "limit" for x in got[0]["results"]):
            _fail(f"{name}: not every request ran to its budget")
        equal = streams_vs(f"phase 43 (g) {name}", cfg, registry,
                           _as_results(traffic, got[0]), clean, params)
        out[name] = {"streams_equal": equal,
                     "launches_per_rank": [g["counts"] for g in got],
                     "seconds": got[0]["seconds"]}
        print(f"  (g) {name}: sched.iter:{MESH_CRASH_ITER}:crash on both "
              f"ranks, rank 0's snapshot restored on a fresh scheduler on "
              f"each: {equal} of {n} streams equal the clean run's; "
              f"{kernel} launches per rank "
              f"{[g['counts'][kernel] for g in got]} through crash and "
              f"restore; {out[name]['seconds']:.2f} s [{card}]")
    # (h) the placement knobs
    whole = solo["held"]["param_bytes"]
    for knob, (spec, _) in MESH_KNOBS.items():
        got = [res[f"serve_{knob}_{spec}"] for res in ranks]
        for r, g in enumerate(got):
            if not np.array_equal(g["tokens"], got[0]["tokens"]):
                _fail(f"serve {knob} {spec}: rank {r}'s tokens differ")
            if g["counts"] != solo["counts"]:
                _fail(f"serve {knob} {spec}: rank {r} launches "
                      f"{g['counts']}, expected solo's {solo['counts']}")
        rows = _ties_only(f"phase 43 (h) serve {knob} {spec}",
                          got[0]["tokens"], solo["tokens"], solo["logits"])
        lerr = float(np.max(np.abs(got[0]["logits"] - solo["logits"])))
        if not lerr <= MESH_LOGIT_TOL:
            _fail(f"serve {knob} {spec}: logits off solo by {lerr}")
        ratio = [g["held"]["param_bytes"] / whole for g in got]
        if not max(ratio) <= MESH_KNOB_BYTES:
            _fail(f"{knob} {spec}: a rank holds {max(ratio):.3f} of "
                  f"mesh=None's parameter bytes (limit {MESH_KNOB_BYTES})")
        name = f"cserve_{knob}_{spec}"
        cs = [res[name] for res in ranks]
        ref = none["knobs"]
        _same_streams(name, cs)
        for r, g in enumerate(cs):
            if g["counts"] != ref["counts"]:
                _fail(f"{name}: rank {r} launches {g['counts']}, expected "
                      f"mesh=None's {ref['counts']}")
        if any(x["finish_reason"] != "limit" for x in cs[0]["results"]):
            _fail(f"{name}: not every request ran to its budget")
        reqs = traffic[:MESH_KNOB_REQUESTS]
        equal = streams_vs(f"phase 43 (h) {name}", cfg, registry,
                           _as_results(reqs, cs[0]),
                           _as_results(reqs, ref), params)
        out[knob] = {"spec": spec, "rows_equal": rows,
                     "logit_max_abs_err": lerr,
                     "param_bytes_per_rank": [g["held"]["param_bytes"]
                                              for g in got],
                     "param_bytes_mesh_none": whole, "ratio": ratio,
                     "serve_launches_per_rank": [g["counts"] for g in got],
                     "streams_equal": equal,
                     "cserve_launches_per_rank": [g["counts"] for g in cs],
                     "tokens_per_s": cs[0]["summary"]["tokens_per_s"],
                     "tokens_per_s_mesh_none":
                         ref["summary"]["tokens_per_s"]}
        print(f"  (h) {knob} at {spec}: generate {rows} of "
              f"{len(solo['tokens'])} rows equal solo's, logits within "
              f"{lerr:.3g}; flash launches per rank "
              f"{[g['counts']['flash_attention'] for g in got]}; resident "
              f"parameter bytes per rank "
              f"{[g['held']['param_bytes'] for g in got]} against "
              f"mesh=None's {whole} ({[round(x, 4) for x in ratio]}); "
              f"continuous paged: {equal} of {len(reqs)} streams equal "
              f"mesh=None's, "
              f"paged launches per rank "
              f"{[g['counts']['paged_attention'] for g in cs]}; "
              f"{out[knob]['tokens_per_s']:.1f} tokens/s against "
              f"{out[knob]['tokens_per_s_mesh_none']:.1f} [{card}]")
    return out


def _max_diff(a: dict, b: dict) -> float:
    if sorted(a) != sorted(b):
        _fail(f"trees differ in leaves: {sorted(set(a) ^ set(b))}")
    return max(float(np.max(np.abs(a[k].astype(np.float64)
                                   - b[k].astype(np.float64)))) for k in a)


def _run_line(label, r, card):
    st = r["step_times"][1:] or r["step_times"]
    return (f"  {label}: {1e3 * sum(st) / len(st):.1f} ms a step (steps 2-8 "
            f"mean; the first {1e3 * r['step_times'][0]:.1f} ms), peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, run "
            f"{r['seconds']:.1f} s (of it {r['mesh_s']:.1f} s building the "
            f"mesh) [{card}]")


def mesh_phase(cfglib, card) -> dict:
    """Phase 43; returns its readings and each rank's launches."""
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.launch import mesh as mesh_lib
    # The rank scenarios, shared with the mesh tests (no JAX there).
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import mesh_runs
    from repro_torch.launch.serve import load_params
    from repro_torch.models import registry
    from repro_torch.optim.base import make_optimizer
    t0 = time.perf_counter()
    cfg = cfglib.get_config("gpt2-12l").with_depth(2)
    tcfg = _mesh_tcfg()
    want = _mesh_counts(cfg.with_depth(1))
    tau = int(MESH_TAU * MESH_STEPS)
    print("phase 43: the mesh (gpt2-12l full width, 1 -> 2 layers at step "
          f"{tau} of {MESH_STEPS}, 16 x 256, Muon-NSGD/WSD) [{card}]")

    # (a) mesh=None and the 'single' mesh, in this process
    none = mesh_runs.train(cfg, tcfg, None, device="cuda", want_params=True,
                           count=True)
    single = mesh_runs.train(cfg, tcfg, "single", device="cuda",
                             want_params=True, count=True)
    if dist.get_backend() != "nccl":
        _fail(f"single mesh backend {dist.get_backend()}, expected nccl")
    dist.destroy_process_group()
    mesh_runs._MESHES.clear()
    if single["history"]["loss"] != none["history"]["loss"]:
        _fail(f"single mesh losses {single['history']['loss']} != mesh=None "
              f"{none['history']['loss']}")
    p_diff = _max_diff(single["params"], none["params"])
    if p_diff:
        _fail(f"single mesh final params differ from mesh=None by {p_diff}")
    for label, r in (("mesh=None", none), ("single", single)):
        if r["counts"] != want:
            _fail(f"{label} launches {r['counts']}, expected {want}")
    print(f"  (a) single (1 NCCL rank) == mesh=None bit for bit: {MESH_STEPS} "
          f"losses, {len(none['params'])} final leaves; expansion "
          f"{single['history']['expansion_steps']}")
    print(_run_line("mesh=None", none, card))
    print(_run_line("single", single, card))

    # (b)-(d) two ranks sharing the card over gloo, one spawn
    B, P, G = MESH_PROMPTS
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    traffic = _mesh_traffic(cfg.vocab_size)
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        mesh_dir = os.path.join(tmp, "resume_2x1")
        scen = [
            ("2x1", "train", dict(cfg=cfg, tcfg=tcfg, mesh="2x1",
                                  count=True)),
            ("1x2", "train", dict(cfg=cfg, tcfg=tcfg, mesh="1x2",
                                  ckpt_dir=run_dir, count=True,
                                  want_params=True)),
            ("flash_6_heads", "flash_local",
             dict(shape=(16, 256, cfg.num_heads // 2, cfg.head_dim))),
            ("restored_2x1", "restore_state",
             dict(cfg=cfg, mesh="2x1", directory=run_dir, step=MESH_STEPS,
                  opt_name="muon_nsgd")),
            ("copy", "copy_step", dict(src=run_dir, dst=mesh_dir,
                                       step=MESH_STEPS, mesh="2x1")),
            ("next_2x1", "train", dict(cfg=cfg, tcfg=_mesh_tcfg(MESH_STEPS
                                                                 + 1),
                                       mesh="2x1", ckpt_dir=mesh_dir)),
            ("serve_2x1", "serve", dict(cfg=cfg, params_np=None,
                                        prompts=prompts, num_tokens=G,
                                        mesh="2x1", max_len=P + G,
                                        ckpt_dir=run_dir, count=True)),
            ("serve_1x2", "serve", dict(cfg=cfg, params_np=None,
                                        prompts=prompts, num_tokens=G,
                                        mesh="1x2", max_len=P + G,
                                        ckpt_dir=run_dir, count=True))]
        scen += [(f"cserve_{spec}_{run}", "cserve", dict(
                     cfg=cfg, params_np=None, requests=traffic, mesh=spec,
                     max_len=MESH_CSERVE_MAX_LEN,
                     max_batch=MESH_CSERVE_SLOTS,
                     engine_kw=MESH_CSERVE_KW[run], count=True,
                     ckpt_dir=run_dir))
                 for spec, runs in MESH_CSERVE_RUNS.items()
                 for run in runs]
        f32_kw = dict(cfg=cfg, params_np=None, requests=traffic,
                      max_len=MESH_CSERVE_MAX_LEN,
                      max_batch=MESH_CSERVE_SLOTS, count=True,
                      ckpt_dir=run_dir)
        snap_dir = os.path.join(tmp, "snapshots")
        os.makedirs(snap_dir)
        scen += [(f"storm_{spec}", "cserve", dict(
                     f32_kw, mesh=spec, engine_kw=MESH_CSERVE_KW["f32"],
                     faults=MESH_STORM, sched_kw=MESH_FAULT_SCHED))
                 for spec in ("2x1", "1x2")]
        scen += [(f"crash_2x1_{run}", "cserve", dict(
                     f32_kw, mesh="2x1", engine_kw=MESH_CSERVE_KW[run],
                     faults=f"sched.iter:{MESH_CRASH_ITER}:crash",
                     snapshot_dir=snap_dir,
                     sched_kw=dict(snapshot_every=1)))
                 for run in MESH_CRASH_RUNS]
        for knob, (spec, kw) in MESH_KNOBS.items():
            scen += [(f"serve_{knob}_{spec}", "serve", dict(
                         cfg=cfg, params_np=None, prompts=prompts,
                         num_tokens=G, mesh=spec, max_len=P + G,
                         ckpt_dir=run_dir, count=True, engine_kw=kw)),
                     (f"cserve_{knob}_{spec}", "cserve", dict(
                         f32_kw, mesh=spec,
                         requests=traffic[:MESH_KNOB_REQUESTS],
                         engine_kw=dict(MESH_CSERVE_KW["f32"], **kw)))]
        scen += [(f"paged_6_heads_{kv}", "paged_local",
                  dict(B=MESH_CSERVE_SLOTS, H=cfg.num_heads // 2,
                       KV=cfg.num_kv_heads // 2, hd=cfg.head_dim,
                       bs=MESH_CSERVE_BLOCK,
                       pages=MESH_CSERVE_MAX_LEN // MESH_CSERVE_BLOCK,
                       kv_dtype=kv))
                 for kv in ("float32", "int8")]
        t1 = time.perf_counter()
        ranks = mesh_lib.spawn(mesh_runs.run, 2, (scen, "cuda"),
                               device="cuda", threads=0, timeout_s=600)
        spawn_s = time.perf_counter() - t1
        # mesh=None: restore and the next step, and solo generate
        none_dir = os.path.join(tmp, "resume_none")
        os.makedirs(none_dir)
        name = f"step_{MESH_STEPS:09d}"
        import shutil
        shutil.copytree(os.path.join(run_dir, name),
                        os.path.join(none_dir, name))
        like_p = registry.get_model(cfg).init(None, cfg, device="meta")
        opt = make_optimizer(tcfg.optimizer)
        restored_none = bridge.flatten(ckpt.restore(
            run_dir, MESH_STEPS, {"params": like_p,
                                  "opt_state": opt.init(like_p)}))
        next_none = mesh_runs.train(cfg, _mesh_tcfg(MESH_STEPS + 1), None,
                                    device="cuda", ckpt_dir=none_dir)
        params, scfg = load_params(run_dir, cfg)
        solo = mesh_runs.serve(scfg, mesh_runs._numpy(bridge.flatten(params)),
                               prompts, G, None, device="cuda",
                               max_len=P + G, count=True)
        # (e)'s reference streams: the same traffic with mesh=None
        t1 = time.perf_counter()
        cserve_none = {run: mesh_runs.cserve(
            cfg, None, traffic, None, device="cuda",
            max_len=MESH_CSERVE_MAX_LEN, max_batch=MESH_CSERVE_SLOTS,
            engine_kw=MESH_CSERVE_KW[run], count=True, ckpt_dir=run_dir)
            for run in MESH_CSERVE_KW}
        # (f)'s reference: the storm on one device
        cserve_none["storm"] = mesh_runs.cserve(
            device="cuda", mesh=None, engine_kw=MESH_CSERVE_KW["f32"],
            faults=MESH_STORM, sched_kw=MESH_FAULT_SCHED, **f32_kw)
        # (h)'s reference: its requests on one device
        cserve_none["knobs"] = mesh_runs.cserve(
            device="cuda", mesh=None, engine_kw=MESH_CSERVE_KW["f32"],
            **dict(f32_kw, requests=traffic[:MESH_KNOB_REQUESTS]))
        none_s = time.perf_counter() - t1

    out = {"single_equals_none": True, "spawn_s": spawn_s}
    ref_loss = np.array(single["history"]["loss"])
    for spec in ("2x1", "1x2"):
        for r, res in enumerate(ranks):
            got = res[spec]
            if got["history"] != ranks[0][spec]["history"]:
                _fail(f"{spec}: rank {r}'s history differs from rank 0's")
            if got["history"]["expansion_steps"] != [tau]:
                _fail(f"{spec} expansion at "
                      f"{got['history']['expansion_steps']}, expected [{tau}]")
            if got["counts"] != want:
                _fail(f"{spec} rank {r} launches {got['counts']}, expected "
                      f"{want}")
        err = float(np.max(np.abs(np.array(ranks[0][spec]["history"]["loss"])
                                  - ref_loss)))
        if not err <= MESH_LOSS_TOL:
            _fail(f"{spec} losses off the single mesh by {err}")
        out[spec] = {"loss_max_abs_err": err,
                     "launches_per_rank": [res[spec]["counts"]
                                           for res in ranks],
                     "ms_per_step": [1e3 * float(np.mean(
                         res[spec]["step_times"][1:])) for res in ranks],
                     "peak_gib": [res[spec]["peak_bytes"] / 2**30
                                  for res in ranks]}
        print(f"  (b) {spec} (2 ranks share the card, gloo): losses within "
              f"{err:.3g} of single (limit {MESH_LOSS_TOL}), expansion "
              f"[{tau}], launches per rank {[res[spec]['counts'] for res in ranks]}")
        for r, res in enumerate(ranks):
            print(_run_line(f"{spec} rank {r}", res[spec], card))
        # Each rank holds half the state and computes half the rows (2x1)
        # or heads, d_ff and vocab (1x2): its peak must stay below one
        # device's, or some path holds the whole state on a rank.
        ratio = max(res[spec]["peak_bytes"] for res in ranks) / \
            none["peak_bytes"]
        out[spec]["peak_over_mesh_none"] = ratio
        if not ratio < MESH_PEAK_RATIO:
            _fail(f"{spec}: a rank's peak is {ratio:.3f} of mesh=None's "
                  f"(limit {MESH_PEAK_RATIO})")
        print(f"  (b) {spec}: the larger rank's peak is {ratio:.3f} of "
              f"mesh=None's (limit {MESH_PEAK_RATIO})")
    fl = ranks[0]["flash_6_heads"]
    if not max(fl.values()) <= TOL[torch.float32]:
        _fail(f"flash at the 6-head local shape: {fl}")
    out["flash_6_heads"] = fl
    print(f"  (b) flash fwd/bwd at the TP shape (16, 256, 6, 64) f32 vs plain:"
          f" {fl} (limit {TOL[torch.float32]})")

    # (c) elastic checkpoints
    tree_1x2 = {"['params']" + k: v for k, v in
                ranks[0]["1x2"]["params"].items()}
    for r, res in enumerate(ranks):
        got = res["restored_2x1"]
        if not got["shard_shapes_ok"]:
            _fail(f"rank {r}: restored shards do not have their specs' "
                  "shapes")
        d = _max_diff(got["tree"], restored_none)
        if d:
            _fail(f"1x2 checkpoint restored under 2x1 differs from mesh=None "
                  f"by {d}")
    d_run = _max_diff({k: v for k, v in restored_none.items()
                       if k.startswith("['params']")}, tree_1x2)
    if d_run:
        _fail(f"restored params differ from the 1x2 run's by {d_run}")
    l_mesh = ranks[0]["next_2x1"]["history"]["loss"][-1]
    l_none = next_none["history"]["loss"][-1]
    if not abs(l_mesh - l_none) <= MESH_RESUME_TOL:
        _fail(f"next step after restore: 2x1 loss {l_mesh}, mesh=None "
              f"{l_none}")
    out["resume"] = {"loss_2x1": l_mesh, "loss_none": l_none}
    print(f"  (c) saved under 1x2, restored under 2x1 and mesh=None: "
          f"{len(restored_none)} leaves equal bit for bit; next step's loss "
          f"{l_mesh!r} (2x1) vs {l_none!r} (mesh=None)")

    # (d) serving the grown checkpoint
    want_serve = _serve_counts(cfg)
    if solo["counts"] != want_serve:
        _fail(f"solo generate launches {solo['counts']}, expected "
              f"{want_serve}")
    for spec in ("2x1", "1x2"):
        for r, res in enumerate(ranks):
            if res[f"serve_{spec}"]["counts"] != want_serve:
                _fail(f"serve {spec} rank {r} launches "
                      f"{res[f'serve_{spec}']['counts']}, expected "
                      f"{want_serve}")
        got = ranks[0][f"serve_{spec}"]
        if not np.array_equal(got["tokens"], solo["tokens"]):
            _fail(f"{spec} greedy tokens differ from solo generate")
        lerr = float(np.max(np.abs(got["logits"] - solo["logits"])))
        if spec == "1x2" and not lerr <= MESH_LOGIT_TOL:
            _fail(f"1x2 logits off solo by {lerr}")
        out[f"serve_{spec}"] = {"logit_max_abs_err": lerr,
                                "seconds": got["seconds"],
                                "launches_per_rank": [
                                    res[f"serve_{spec}"]["counts"]
                                    for res in ranks]}
        print(f"  (d) serve {spec}: {B} x {G} greedy tokens == solo "
              f"generate; logits within {lerr:.3g}; flash launches per "
              f"rank {[res[f'serve_{spec}']['counts']['flash_attention'] for res in ranks]}"
              f" (1 prefill x {cfg.num_layers} layers, as solo's "
              f"{solo['counts']['flash_attention']}; no other kernel)")
    # (e) continuous, paged, prefix-cached and speculative serving
    from repro_torch.tree import tree_map
    card_params = tree_map(lambda t: t.cuda(), params)
    out["serving"] = mesh_serving(ranks, cserve_none, traffic, scfg,
                                  card_params, card)
    # (f)-(h) serving under faults and the placement knobs
    out["faults"] = mesh_fault_lanes(ranks, cserve_none, traffic, scfg,
                                     card_params, solo, card)
    del card_params
    served = {k: v for k, v in ranks[0]["_seconds"].items()
              if k.startswith(("cserve_", "storm_", "crash_", "serve_"))}
    print(f"  (e) rank 0's serving runs {sum(served.values()):.1f} s "
          f"({ {k: round(v, 1) for k, v in served.items()} }); mesh=None's "
          f"{none_s:.1f} s")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 43: {out['seconds']:.1f} s (spawn {spawn_s:.1f} s) "
          f"[{card}]")
    return out


# ---------------------------------------------------------------------------
# 44. Expert parallelism and the tensor-parallel Mamba, RWKV6 and MLA layers
# on 1x2 (two ranks sharing the card over gloo): jamba's first two layers,
# rwkv6-7b and deepseekv3-0.3b at full width and depth 2, each trained and
# served on the rank's experts, channels and heads against mesh=None.
# ---------------------------------------------------------------------------

# (steps, global batch, sequence length) of each model's training run,
# Muon-NSGD, no expansion: jamba at phase 42's batch for 2 steps (3 until
# the serving fault lanes came in, cut for time: a 1x2 step takes ~12 s),
# deepseekv3-0.3b at the launcher's, rwkv6-7b at 2 x 512 (cut from phase
# 41's 4 x 1024 for time: its 1x2 step moves ~16 activations of
# B x S x 4096 through gloo).
MESH44_TRAIN = {"jamba": (2, 4, 1024), "rwkv": (2, 2, 512),
                "dsv3": (3, 16, 256)}
MESH44_PROMPTS = (4, 64, 8)          # (B, P, G) of the greedy generations
MESH44_REQUESTS = 8                  # deepseekv3-0.3b's continuous run
# (e) rwkv6-7b's crash-restore at 1x2: 4 of phase 43's requests over f32
# pages, a sched.iter crash, rank 0's snapshot restored on each rank (its
# re-prefill runs WKV on the rank's 32 heads from a fresh carry).
MESH44_RWKV_REQUESTS, MESH44_RWKV_CRASH = 4, 12
# Losses of the 1x2 runs against mesh=None's: the reference's own
# tolerance for its sharded runs.  rwkv6-7b's generation: logits against
# solo generate, phase 43's TP tolerance.
MESH44_LOSS_TOL = 1e-4


def _mesh44_cfgs(cfglib):
    return {"jamba": _jamba_cut(cfglib.get_config("jamba-v0.1-52b"), 2),
            "rwkv": cfglib.get_config("rwkv6-7b").with_depth(2),
            "dsv3": cfglib.get_config("deepseekv3-0.3b").with_depth(2)}


def _mesh44_tcfg(cfg, name):
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    steps, batch, seq = MESH44_TRAIN[name]
    return TrainConfig(total_steps=steps, seq_len=seq, global_batch=batch,
                       source_layers=cfg.num_layers,
                       optimizer=OptimizerConfig(name="muon_nsgd"),
                       eval_every=10 ** 9, checkpoint_every=10 ** 9,
                       log_every=1, seed=0)


def _split_before(path, cfg) -> bool:
    """Whether a layer computed the leaf at ``path`` on its 'model' shard
    before expert and tensor parallelism (the vocab, MHA/GQA attention
    and the dense MLP); every other leaf the rule splits was gathered."""
    if path[-1] in ("embed", "lm_head"):
        return True
    if "attn" in path and path[-1] in ("wq", "wk", "wv", "wo"):
        return cfg.attention != "mla"
    return "mlp" in path


def _reckon(cfg, registry) -> dict:
    """From the meta device under 1x2's rules: the params a rank holds
    (GB f32), the whole model's, and what the gather path (every expert
    stack, Mamba, RWKV6 and MLA projection gathered over 'model' for the
    forward, its whole gradient held in the backward) would add a rank:
    twice the other rank's share of those leaves."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.tree import leaves_with_path
    ms = shd.MeshShape(("data", "model"), (1, 2))
    like = registry.get_model(cfg).init(None, cfg, device="meta")
    local = whole = other = 0
    for path, x in leaves_with_path(like):
        spec = shd.param_spec(path, x.shape, ms)
        n = x.numel()
        part = int(np.prod(shd.local_shape(x.shape, spec, ms)))
        whole, local = whole + n, local + part
        if part < n and not _split_before(path, cfg):
            other += n - part
    return {"rank_params_gb": 4 * local / 1e9, "whole_gb": 4 * whole / 1e9,
            "gather_path_extra_gb": 2 * 4 * other / 1e9}


def _ns_rank_launches(cfg, model: int) -> dict:
    """(ns_fused, matmul) launches of one Muon update on a rank of a 1 x
    ``model`` mesh: one ``ns_fused`` a fused-route leaf, 15 GEMMs (5
    steps of 3) a matrix the rank orthogonalizes of a large-route leaf:
    each matrix whole, the leading dims as the rank holds them (an expert
    stack split over 'model' gives the rank E/model matrices)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.newton_schulz import ops as ns_ops
    from repro_torch.models import registry
    from repro_torch.optim import muon
    from repro_torch.tree import leaves_with_path
    ms = shd.MeshShape(("data", "model"), (1, model))
    fused = large = 0
    for path, x in leaves_with_path(
            registry.get_model(cfg).init(None, cfg, device="meta")):
        if not muon._is_matrix(path, x):
            continue
        if ns_ops.route(*x.shape[-2:]) == "fused":
            fused += 1
            continue
        held = shd.local_shape(x.shape, shd.param_spec(path, x.shape, ms),
                               ms)
        large += math.prod(held[:-2])
    return {"ns_fused": fused, "matmul": 15 * large}


def _muon_expert_stack(cfg, g) -> torch.Tensor:
    """A rank's momentum of ``cfg``'s first expert stack (``w_gate``) as
    Muon hands it to Newton-Schulz on 1x2: the leaf's held shape, its
    leading dims (layers, the rank's E/2 experts) flattened into one
    batch, drawn from ``g``."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import registry
    from repro_torch.tree import leaves_with_path
    ms = shd.MeshShape(("data", "model"), (1, 2))
    for path, x in leaves_with_path(
            registry.get_model(cfg).init(None, cfg, device="meta")):
        if path[-2:] == ("moe", "w_gate"):
            held = shd.local_shape(x.shape, shd.param_spec(path, x.shape, ms),
                                   ms)
            return torch.randn((math.prod(held[:-2]),) + tuple(held[-2:]),
                               generator=g, device="cuda") * 0.02
    raise ValueError(f"{cfg.name} has no expert stack")


def mesh44_rwkv_restore(ranks, none, traffic, cfg, registry, card) -> dict:
    """(e): ``rwkv6-7b``'s crash-restore at 1x2 against ``mesh=None``'s
    crash-restore (each rank's WKV launches, the crash and the restore's
    re-prefill chunks on its 32 heads, equal to it) and its clean run (the
    streams, under the near-tie rule)."""
    import mesh_runs
    got = [res["crash_rwkv"] for res in ranks]
    ref = none["crash_rwkv"]
    _same_streams("phase 44 (e) crash_rwkv", got)
    for r, g in enumerate(got + [ref]):
        if not g["crashed"]:
            _fail(f"phase 44 (e): run {r} ran past sched.iter:"
                  f"{MESH44_RWKV_CRASH}:crash")
    for r, g in enumerate(got):
        if g["counts"] != ref["counts"]:
            _fail(f"phase 44 (e): rank {r} launches {g['counts']}, expected "
                  f"mesh=None's {ref['counts']}")
    if ref["counts"]["wkv"] <= 0 or any(
            v for k, v in ref["counts"].items() if k != "wkv"):
        _fail(f"phase 44 (e): mesh=None launches {ref['counts']}, expected "
              "WKV alone")
    if any(x["finish_reason"] != "limit" for x in got[0]["results"]):
        _fail("phase 44 (e): not every request ran to its budget")
    params = mesh_runs.card_params(cfg, 0, "cuda")
    equal = streams_vs("phase 44 (e) rwkv6-7b crash-restore 1x2", cfg,
                       registry, _as_results(traffic, got[0]),
                       _as_results(traffic, none["cserve_rwkv"]), params)
    del params
    out = {"streams_equal": equal,
           "launches_per_rank": [g["counts"] for g in got],
           "launches_mesh_none": ref["counts"],
           "seconds": got[0]["seconds"]}
    print(f"  (e) {cfg.name} at 2 layers, 1x2: sched.iter:"
          f"{MESH44_RWKV_CRASH}:crash on both ranks, rank 0's snapshot "
          f"restored on each: {equal} of {len(traffic)} streams equal "
          f"mesh=None's clean run; WKV launches per rank "
          f"{[g['counts']['wkv'] for g in got]} through crash and restore "
          f"(32 of 64 heads), as mesh=None's {ref['counts']['wkv']}; "
          f"{out['seconds']:.2f} s [{card}]")
    return out


def mesh44_lanes(scan_ops, wkv_ops, ns_ops, cfgs) -> dict:
    """Each kernel of phase 44's paths at its rank-local shape on 1x2
    against its plain version on the same inputs: the scan forward and
    backward on 4096 of jamba's 8192 channels, the WKV forward and
    backward on 32 of rwkv6-7b's 64 heads (and the forward at (e)'s
    restore shape: B 1, a 128-token chunk from a carried state),
    ``ns_fused`` on deepseekv3-0.3b's
    expert stack as a rank's Muon hands it over (2 layers x 4 of 8 experts
    of 512 x 1024), Newton-Schulz through the ``matmul`` kernel on jamba's
    (8 of 16 experts of 4096 x 14336, too large to fuse), flash forward and
    backward on deepseekv3-0.3b's 4 of 8 query heads over 2 of 4 KV heads
    (G = 2).  The launches count nowhere: the caller read its main paths'
    counters before."""
    import mesh_runs
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    t0 = time.perf_counter()
    f32 = torch.float32
    out = {}
    _, B, S = MESH44_TRAIN["jamba"]
    d = cfgs["jamba"].ssm.expand * cfgs["jamba"].d_model // 2
    N = cfgs["jamba"].ssm.d_state
    u, dt, A, Bm, Cm, Dp, h0 = scan_case(B, S, d, N, f32, True, "model", 44)
    y, h = scan_ops.selective_scan_with_state(u, dt, A, Bm, Cm, Dp, h0=h0,
                                              force="kernel")
    wy, wh = scan_ops.selective_scan_with_state(u, dt, A, Bm, Cm, Dp, h0=h0,
                                                force="chunked")
    out["selective_scan"] = max(_rel_floor(y, wy), _rel_floor(h, wh))
    g = torch.Generator(device="cuda").manual_seed(45)
    dy = torch.randn(u.shape, generator=g, device="cuda")
    got = _grads_through(lambda *a: scan_ops.selective_scan_with_state(
        *a[:6], h0=a[6]), (u, dt, A, Bm, Cm, Dp, h0), (dy, None))
    want = scan_ref.selective_scan_bwd_ref(u, dt, A, Bm, Cm, Dp, h0, dy)
    out["selective_scan_bwd"] = max(_bwd_ratio(a, b)
                                    for a, b in zip(got, want))
    del u, dt, A, Bm, Cm, Dp, h0, y, h, wy, wh, got, want
    H = cfgs["rwkv"].d_model // cfgs["rwkv"].ssm.head_dim // 2
    hd = cfgs["rwkv"].ssm.head_dim
    _, B, S = MESH44_TRAIN["rwkv"]
    args = wkv_case(B, S, H, hd, f32, True, WKV_DECAYS["near 0.69"], 46)
    y, s = wkv_ops.wkv(*args, force="kernel")
    wy, ws = wkv_ops.wkv(*args, force="chunked")
    out["wkv"] = max(_rel_floor(y, wy), _rel_floor(s, ws))
    dy = torch.randn(args[0].shape, generator=g, device="cuda")
    got = _grads_through(wkv_ops.wkv, args, (dy, None))
    want = wkv_ref.wkv_bwd_ref(*args, dy, None)
    out["wkv_bwd"] = max(_bwd_ratio(a, b) for a, b in zip(got, want))
    # (e)'s restore: a B=1 re-prefill chunk from a carried state
    args = wkv_case(1, 128, H, hd, f32, True, WKV_DECAYS["near 0.69"], 47)
    y, s = wkv_ops.wkv(*args, force="kernel")
    wy, ws = wkv_ops.wkv(*args, force="chunked")
    out["wkv_restore_chunk"] = max(_rel_floor(y, wy), _rel_floor(s, ws))
    del args, y, s, wy, ws, got, want
    dsv3 = cfgs["dsv3"]
    x = _muon_expert_stack(dsv3, g)
    if ns_ops.route(*x.shape[-2:]) != "fused":
        _fail(f"phase 44: {tuple(x.shape)} does not take ns_fused's route")
    out["ns_fused"] = _rel_err(ns_ops.ns_fused(x, force="kernel"),
                               ns_ops.ns_fused(x, force="ref"))
    x = _muon_expert_stack(cfgs["jamba"], g)
    if ns_ops.route(*x.shape[-2:]) != "large":
        _fail(f"phase 44: {tuple(x.shape)} does not take matmul's route")
    out["matmul"] = _rel_err(ns_ops.newton_schulz(x, force="kernel"),
                             ns_ops.newton_schulz(x, force="ref"))
    del x
    _, batch, seq = MESH44_TRAIN["dsv3"]
    fl = mesh_runs.flash_local((batch, seq, dsv3.num_heads // 2,
                                dsv3.head_dim), device="cuda",
                               kv_heads=dsv3.num_kv_heads // 2)
    out["flash_attention"] = fl["out"]
    out["flash_attention_bwd"] = max(v for k, v in fl.items() if k != "out")
    torch.cuda.synchronize()
    limits = {"selective_scan": SCAN_TOL[f32], "selective_scan_bwd": 1.0,
              "wkv": WKV_TOL[f32], "wkv_bwd": 1.0,
              "wkv_restore_chunk": WKV_TOL[f32], "ns_fused": NS_TOL[f32],
              "matmul": NS_TOL[f32],
              "flash_attention": TOL[f32], "flash_attention_bwd": TOL[f32]}
    for name, err in out.items():
        ok = err <= limits[name]
        print(f"  (d) {name} at the 1x2 local shape vs plain: {err:.3g} "
              f"(limit {limits[name]}{' of its entries' if limits[name] == 1.0 else ''}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"phase 44: {name} at its rank-local shape: {err}")
    print(f"  (d) local-shape lanes {time.perf_counter() - t0:.1f} s")
    return out


def _ties_only(label, got, want, logits):
    """Greedy rows ``got`` against ``want``: equal, or first different
    where ``want``'s logits (B, G, V) at that step have a top-2 gap below
    ``SPEC_TIE_GAP``.  Returns how many rows are equal."""
    P = want.shape[1] - logits.shape[1]
    equal = 0
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got[b] != want[b])
        if not diff.size:
            equal += 1
            continue
        t = int(diff[0]) - P
        top2 = np.sort(logits[b, t])[-2:]
        gap = float(top2[1] - top2[0])
        print(f"  {label}, row {b}: first differs at token {t}, top-2 gap "
              f"{gap:.3e}")
        if t < 0 or gap >= SPEC_TIE_GAP:
            _fail(f"{label}, row {b} leaves solo generate's stream at token "
                  f"{t} with a top-2 gap {gap:.3e}")
    return equal


def mesh_layers_phase(cfglib, registry, card) -> dict:
    """Phase 44; returns its readings."""
    from repro_torch.launch import mesh as mesh_lib
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import mesh_runs
    t0 = time.perf_counter()
    cfgs = _mesh44_cfgs(cfglib)
    print("phase 44: expert parallelism and tensor-parallel Mamba, RWKV6 "
          "and MLA on 1x2 (two ranks sharing the card over gloo), full "
          f"width, depth 2 [{card}]")
    reckoned = {}
    for name, cfg in cfgs.items():
        reckoned[name] = r = _reckon(cfg, registry)
        print(f"  (a) {cfg.name} at 2 layers: {r['whole_gb']:.2f} GB f32 "
              f"params, {r['rank_params_gb']:.2f} GB a rank on 1x2 (x3 with "
              f"momentum and gradients: {3 * r['rank_params_gb']:.1f} GB; "
              f"two ranks {6 * r['rank_params_gb']:.1f} GB); the gather "
              f"path would add {r['gather_path_extra_gb']:.2f} GB a rank "
              "(reckoned on the meta device)")
    B, P, G = MESH44_PROMPTS
    prompts = {name: np.random.default_rng(44).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
        for name, cfg in cfgs.items()}
    dsv3 = _dropless(cfgs["dsv3"])
    traffic = _mesh_traffic(dsv3.vocab_size)[:MESH44_REQUESTS]
    cs_kw = dict(max_len=MESH_CSERVE_MAX_LEN, max_batch=MESH_CSERVE_SLOTS,
                 engine_kw=MESH_CSERVE_KW["f32"], count=True, card_seed=0)

    # (a)-(c), mesh=None in this process, one model at a time
    none = {}
    for name, cfg in cfgs.items():
        none[name] = mesh_runs.train(cfg, _mesh44_tcfg(cfg, name), None,
                                     device="cuda", count=True, card_seed=0)
        gc.collect()
        torch.cuda.empty_cache()
        if name != "dsv3":
            none[f"serve_{name}"] = mesh_runs.serve(
                cfg, None, prompts[name], G, None, device="cuda",
                max_len=P + G, count=True, card_seed=0)
        gc.collect()
        torch.cuda.empty_cache()
    none["cserve_dsv3"] = mesh_runs.cserve(dsv3, None, traffic, None,
                                           device="cuda", **cs_kw)
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_traffic = _mesh_traffic(cfgs["rwkv"].vocab_size)[
        :MESH44_RWKV_REQUESTS]
    snap_dir = tempfile.mkdtemp(prefix="phase44_")
    crash_kw = dict(faults=f"sched.iter:{MESH44_RWKV_CRASH}:crash",
                    snapshot_dir=snap_dir, sched_kw=dict(snapshot_every=1))
    none["cserve_rwkv"] = mesh_runs.cserve(cfgs["rwkv"], None, rwkv_traffic,
                                           None, device="cuda", **cs_kw)
    none["crash_rwkv"] = mesh_runs.cserve(cfgs["rwkv"], None, rwkv_traffic,
                                          None, device="cuda", **cs_kw,
                                          **crash_kw)
    gc.collect()
    torch.cuda.empty_cache()

    scen = []
    for name, cfg in cfgs.items():
        scen.append((name, "train", dict(cfg=cfg,
                                         tcfg=_mesh44_tcfg(cfg, name),
                                         mesh="1x2", count=True,
                                         card_seed=0)))
        if name != "dsv3":
            scen.append((f"serve_{name}", "serve", dict(
                cfg=cfg, params_np=None, prompts=prompts[name],
                num_tokens=G, mesh="1x2", max_len=P + G, count=True,
                card_seed=0)))
    scen.append(("cserve_dsv3", "cserve", dict(cfg=dsv3, params_np=None,
                                               requests=traffic, mesh="1x2",
                                               **cs_kw)))
    scen.append(("crash_rwkv", "cserve", dict(
        cfg=cfgs["rwkv"], params_np=None, requests=rwkv_traffic,
        mesh="1x2", **cs_kw, **crash_kw)))
    t1 = time.perf_counter()
    ranks = mesh_lib.spawn(mesh_runs.run, 2, (scen, "cuda"), device="cuda",
                           threads=0, timeout_s=900)
    spawn_s = time.perf_counter() - t1
    import shutil
    shutil.rmtree(snap_dir, ignore_errors=True)

    out = {"reckoned": reckoned, "spawn_s": spawn_s,
           "scenario_s": ranks[0]["_seconds"]}
    for name, cfg in cfgs.items():
        ref = none[name]
        got = [res[name] for res in ranks]
        steps = MESH44_TRAIN[name][0]
        want = {k: 0 for k in COUNTERS}
        want.update({"jamba": dict(selective_scan=2 * steps,
                                   selective_scan_bwd=2 * steps),
                     "rwkv": dict(wkv=2 * steps, wkv_bwd=2 * steps),
                     "dsv3": dict(flash_attention=2 * steps,
                                  flash_attention_bwd=2 * steps)}[name])
        for model, counts in [(1, ref["counts"])] + [
                (2, g["counts"]) for g in got]:
            w = dict(want, **{k: v * steps for k, v in
                              _ns_rank_launches(cfg, model).items()})
            if counts != w:
                _fail(f"{name}: launches {counts} with 'model' {model}, "
                      f"expected {w}")
        for r, g in enumerate(got):
            if g["history"]["loss"] != got[0]["history"]["loss"]:
                _fail(f"{name}: rank {r}'s losses differ from rank 0's")
        err = float(np.max(np.abs(np.array(got[0]["history"]["loss"])
                                  - np.array(ref["history"]["loss"]))))
        if not err <= MESH44_LOSS_TOL:
            _fail(f"{name}: 1x2 losses {got[0]['history']['loss']} off "
                  f"mesh=None's {ref['history']['loss']} by {err}")
        peaks = [g["peak_bytes"] / 2 ** 30 for g in got]
        rec = {"losses": got[0]["history"]["loss"],
               "losses_mesh_none": ref["history"]["loss"],
               "loss_max_abs_err": err,
               "launches_per_rank": [g["counts"] for g in got],
               "peak_gib_per_rank": peaks,
               "peak_gib_mesh_none": ref["peak_bytes"] / 2 ** 30,
               "gather_path_peak_gib_reckoned": max(peaks) + reckoned[name][
                   "gather_path_extra_gb"] * 1e9 / 2 ** 30,
               "ms_per_step": [1e3 * float(np.mean(g["step_times"][1:]))
                               for g in got],
               "ms_per_step_mesh_none": 1e3 * float(np.mean(
                   ref["step_times"][1:]))}
        out[name] = rec
        print(f"  ({'abc'[list(cfgs).index(name)]}) {cfg.name}: {steps} "
              f"Muon-NSGD steps of {MESH44_TRAIN[name][1]} x "
              f"{MESH44_TRAIN[name][2]}; losses {rec['losses']} against "
              f"mesh=None's {rec['losses_mesh_none']} (max diff {err:.3g}, "
              f"limit {MESH44_LOSS_TOL}); launches per rank "
              f"{rec['launches_per_rank'][0]}, mesh=None's {ref['counts']} "
              "(as derived: a rank's Newton-Schulz GEMMs on its experts)")
        print(f"      peak per rank {[round(p, 2) for p in peaks]} GiB "
              f"against mesh=None's {rec['peak_gib_mesh_none']:.2f} GiB and "
              f"the gather path's {rec['gather_path_peak_gib_reckoned']:.2f}"
              f" GiB (reckoned); ms a step (steps 2+) "
              f"{[round(x, 1) for x in rec['ms_per_step']]} against "
              f"{rec['ms_per_step_mesh_none']:.1f} [{card}]")

    for name in ("jamba", "rwkv"):
        ref = none[f"serve_{name}"]
        got = [res[f"serve_{name}"] for res in ranks]
        for r, g in enumerate(got):
            if not np.array_equal(g["tokens"], got[0]["tokens"]):
                _fail(f"serve {name}: rank {r}'s tokens differ")
            if g["counts"] != ref["counts"]:
                _fail(f"serve {name}: rank {r} launches {g['counts']}, "
                      f"expected solo's {ref['counts']}")
        kernel = "selective_scan" if name == "jamba" else "wkv"
        if ref["counts"][kernel] != 2:
            _fail(f"serve {name}: solo launches {ref['counts']}, expected "
                  f"one {kernel} a layer in the prefill")
        if name == "rwkv":
            if not np.array_equal(got[0]["tokens"], ref["tokens"]):
                _fail("rwkv6-7b 1x2 greedy tokens differ from solo generate")
            lerr = float(np.max(np.abs(got[0]["logits"] - ref["logits"])))
            if not lerr <= MESH_LOGIT_TOL:
                _fail(f"rwkv6-7b 1x2 logits off solo by {lerr}")
            equal = B
        else:
            lerr = None
            equal = _ties_only("phase 44 jamba 1x2 generate",
                               got[0]["tokens"], ref["tokens"],
                               ref["logits"])
        out[f"serve_{name}"] = {"rows_equal": equal, "logit_max_abs_err":
                                lerr, "launches_per_rank":
                                [g["counts"] for g in got]}
        print(f"  ({'ab'[name == 'rwkv']}) {cfgs[name].name} greedy generate "
              f"at 1x2 ({B} prompts of {P}, {G} tokens): {equal} of {B} "
              f"rows equal solo generate's"
              + (f", logits within {lerr:.3g}" if lerr is not None else
                 " (the rest at near-ties)")
              + f"; {kernel} launches per rank "
              f"{[g['counts'][kernel] for g in got]}, as solo's")
    ref = none["cserve_dsv3"]
    got = [res["cserve_dsv3"] for res in ranks]
    for r, g in enumerate(got):
        if [x["tokens"].tolist() for x in g["results"]] != \
                [x["tokens"].tolist() for x in got[0]["results"]]:
            _fail(f"cserve dsv3: rank {r}'s streams differ from rank 0's")
        if g["counts"] != ref["counts"]:
            _fail(f"cserve dsv3: rank {r} launches {g['counts']}, expected "
                  f"mesh=None's {ref['counts']}")
    if any(x["finish_reason"] != "limit" for x in got[0]["results"]):
        _fail("cserve dsv3: not every request ran to its budget")
    params = mesh_runs.card_params(dsv3, 0, "cuda")
    equal = streams_vs("phase 44 (c) deepseekv3-0.3b 1x2", dsv3, registry,
                       _as_results(traffic, got[0]),
                       _as_results(traffic, ref), params)
    del params
    out["cserve_dsv3"] = {"streams_equal": equal,
                          "launches_per_rank": [g["counts"] for g in got],
                          "tokens_per_s": got[0]["summary"]["tokens_per_s"],
                          "tokens_per_s_mesh_none":
                              ref["summary"]["tokens_per_s"]}
    print(f"  (c) deepseekv3-0.3b continuous paged serving at 1x2 "
          f"(dropless; {MESH44_REQUESTS} requests into "
          f"{MESH_CSERVE_SLOTS} slots, latent pages whole, MLA on 4 of 8 "
          f"heads): {equal} of {MESH44_REQUESTS} streams equal mesh=None's "
          f"(the rest at near-ties); launches per rank "
          f"{[g['counts'] for g in got]}, as mesh=None's; "
          f"{out['cserve_dsv3']['tokens_per_s']:.1f} tokens/s against "
          f"{out['cserve_dsv3']['tokens_per_s_mesh_none']:.1f} [{card}]")
    out["crash_rwkv"] = mesh44_rwkv_restore(ranks, none, rwkv_traffic,
                                            cfgs["rwkv"], registry, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["lanes"] = mesh44_lanes(OPS["scan"], OPS["wkv"], OPS["ns"], cfgs)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 44: {out['seconds']:.1f} s (spawn {spawn_s:.1f} s; rank "
          f"0's scenarios { {k: round(v, 1) for k, v in ranks[0]['_seconds'].items()} }) "
          f"[{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 46: attention on a rank's query heads over one KV head, and the
# tensor-parallel encoder-decoder (ROADMAP A21's remainder)
# ---------------------------------------------------------------------------

# (a) starcoder2-3b (24 query heads over 2 KV heads) at full width and
# MESH46_DEPTH of its 30 layers (reduced for time), four ranks sharing the
# card over gloo at 1x4: 6 query heads and 1 of the 2 KV heads a rank.
# AdamW steps (steps, batch, seq); greedy generate of (B, P, G); the
# continuous paged runs serve the same B prompts, G tokens each, into
# MESH46_SLOTS slots over pages of MESH46_BLOCK.
MESH46_ARCH, MESH46_DEPTH = "starcoder2-3b", 2
MESH46_TRAIN = (2, 4, 512)
MESH46_PROMPTS = (4, 64, 8)
MESH46_SLOTS, MESH46_BLOCK = 2, 16
MESH46_KV = ("float32", "int8")
# (b) whisper-base at full width (6 + 6 layers) at 1x2: Muon-NSGD steps of
# (steps, B, S) over 1500 frames, then G greedy tokens.
MESH46_WHISPER = (2, 2, 64, 8)
# The paged decode at a 1x4 rank's shape: starcoder2-3b's timing shape
# (G12_SHAPE) on 6 query heads over 1 KV head.
G6_SHAPE = dict(G12_SHAPE, H=6, KV=1)


def _mesh46_tcfg():
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    steps, batch, seq = MESH46_TRAIN
    return TrainConfig(total_steps=steps, seq_len=seq, global_batch=batch,
                       source_layers=MESH46_DEPTH,
                       optimizer=OptimizerConfig(name="adamw",
                                                 learning_rate=1e-3),
                       eval_every=10 ** 9, checkpoint_every=10 ** 9,
                       log_every=1, seed=0)


def _flash_times(fa_ops, q, k, v, do, kw) -> dict:
    """Device times of the flash kernel's forward and backward on (q, k,
    v) under ``kw`` (causal, window, logit_softcap), of their plain
    versions and of SDPA's best call (``_sdpa_best``), beside the card's
    bound for the same work (``roofline.torch_cost``):
    {forward: {...}, backward: {...}}."""
    from repro_torch.roofline import torch_cost
    ms = _time_device_ms(lambda: fa_ops.flash_attention(
        q, k, v, force="kernel", **kw), 10)
    plain_ms = _time_device_ms(lambda: fa_ops.flash_attention(
        q, k, v, force="ref", **kw), 2)
    lib = _sdpa_best(q, k, v, do, causal=kw["causal"])
    o, lse = fa_ops.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    bwd_ms = _time_device_ms(lambda: fa_ops.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, **kw), 10)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_out = fa_ops.flash_attention(*leaves, force="ref", **kw)
    bwd_plain = _time_device_ms(lambda: torch.autograd.grad(
        ref_out, leaves, do, retain_graph=True), 2)
    del ref_out, leaves, o, lse
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dims = dict(causal=kw["causal"], itemsize=q.element_size())
    return {"forward": dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib["fwd"][0],
                library_backend=lib["fwd"][1], **torch_cost.flash_attention(
                    B, Sq, Sk, H, KV, hd, **dims).bound()),
            "backward": dict(
                ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib["bwd"][0],
                library_backend=lib["bwd"][1],
                **torch_cost.flash_attention_bwd(
                    B, Sq, Sk, H, KV, hd, **dims).bound())}


def _whisper46_batches(cfg) -> list:
    steps, B, S, _ = MESH46_WHISPER
    rng = np.random.default_rng(46)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "frames": rng.standard_normal(
                        (B, cfg.encoder_seq_len, cfg.d_model),
                        dtype=np.float32)})
    return out


def mesh46_lanes(fa_ops, pa_ops, cfg, wcfg, card) -> dict:
    """Each kernel of phase 46's paths at its rank-local shape against its
    plain version on the same inputs: flash forward and backward on (a)'s
    training shape at a 1x4 rank (6 query heads over 1 KV head, causal),
    the paged decode at G = 6 over f32 and int8 pages, the cross-attention
    of (b) at a 1x2 rank (4 of 8 heads, 64 queries over 1500 frames,
    non-causal); then the flash and paged kernels timed beside their
    bounds, plain versions and SDPA.  The launches count nowhere: the
    caller read its main paths' counters before."""
    import mesh_runs
    t0 = time.perf_counter()
    _, B, S = MESH46_TRAIN
    H, KV = cfg.num_heads // 4, 1
    fl = mesh_runs.flash_local((B, S, H, cfg.head_dim), seed=46,
                               device="cuda", kv_heads=KV)
    steps, wb, ws, _ = MESH46_WHISPER
    cross = mesh_runs.flash_local(
        (wb, ws, wcfg.num_heads // 2, wcfg.head_dim), seed=47, device="cuda",
        s_k=wcfg.encoder_seq_len, causal=False)
    s = G6_SHAPE
    paged = {kv: mesh_runs.paged_local(
        s["B"], s["H"], s["KV"], s["hd"], s["bs"], s["NB"], kv_dtype=kv,
        seed=46, device="cuda")["max_abs_err"] for kv in MESH46_KV}
    errs = {"flash_attention": fl["out"],
            "flash_attention_bwd": max(v for k, v in fl.items()
                                       if k != "out"),
            "cross_flash_attention": cross["out"],
            "cross_flash_attention_bwd": max(v for k, v in cross.items()
                                             if k != "out"),
            **{f"paged_attention_{kv}": e for kv, e in paged.items()}}
    limits = {k: (PAGED_TP_TOL if k.startswith("paged") else
                  TOL[torch.float32]) for k in errs}
    for name, err in errs.items():
        ok = err <= limits[name]
        print(f"  (c) {name} at the rank-local shape vs plain: {err:.3g} "
              f"(limit {limits[name]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"phase 46: {name} at its rank-local shape: {err}")
    g = torch.Generator(device="cuda").manual_seed(460)
    q, do = (torch.randn((B, S, H, cfg.head_dim), generator=g,
                         device="cuda") for _ in range(2))
    k, v = (torch.randn((B, S, KV, cfg.head_dim), generator=g,
                        device="cuda") for _ in range(2))
    times = _flash_times(fa_ops, q, k, v, do, dict(causal=True, window=0,
                                                   logit_softcap=0.0))
    del q, k, v, do
    for d, r in times.items():
        print(f"  (c) {card}: flash {d} at (B={B}, S={S}, {H} query heads "
              f"over {KV} KV head, hd {cfg.head_dim}, causal, f32): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_backend']} {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    times["paged"] = paged_times(pa_ops, s=G6_SHAPE)
    torch.cuda.empty_cache()
    print(f"  (c) local-shape lanes {time.perf_counter() - t0:.1f} s")
    return {"errs": errs, "times": times}


def mesh_heads_phase(cfglib, registry, card) -> dict:
    """Phase 46; returns its readings."""
    import concurrent.futures
    from repro_torch.launch import mesh as mesh_lib
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import mesh_runs
    t0 = time.perf_counter()
    cfg = cfglib.get_config(MESH46_ARCH).with_depth(MESH46_DEPTH)
    wcfg = cfglib.get_config(WHISPER)
    print(f"phase 46: {cfg.name} at full width and {MESH46_DEPTH} layers "
          f"on 1x4 ({cfg.num_heads // 4} query heads over 1 of "
          f"{cfg.num_kv_heads} KV heads a rank) and {wcfg.name} "
          f"({wcfg.num_encoder_layers} + {wcfg.num_layers} layers) on 1x2, "
          f"ranks sharing the card over gloo [{card}]")
    B, P, G = MESH46_PROMPTS
    prompts = np.random.default_rng(46).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    reqs = [dict(prompt=p, max_new_tokens=G) for p in prompts]
    tcfg = _mesh46_tcfg()
    wbatches = _whisper46_batches(wcfg)
    frames = wbatches[0]["frames"]
    WG = MESH46_WHISPER[3]

    def cs_kw(kv):
        return dict(max_len=P + G, max_batch=MESH46_SLOTS, count=True,
                    card_seed=0, engine_kw=dict(
                        paged=True, block_size=MESH46_BLOCK,
                        **({} if kv == "float32" else {"kv_dtype": kv})))

    a = [("train", "train", dict(cfg=cfg, tcfg=tcfg, mesh="1x4",
                                 count=True, card_seed=0)),
         ("serve", "serve", dict(cfg=cfg, params_np=None, prompts=prompts,
                                 num_tokens=G, mesh="1x4", max_len=P + G,
                                 count=True, card_seed=0))]
    a += [(f"cserve_{kv}", "cserve", dict(cfg=cfg, params_np=None,
                                          requests=reqs, mesh="1x4",
                                          **cs_kw(kv)))
          for kv in MESH46_KV]
    b = [("train", "encdec_train", dict(cfg=wcfg, params_np=None,
                                        batches=wbatches, mesh="1x2",
                                        card_seed=0, count=True)),
         ("decode", "encdec_decode", dict(cfg=wcfg, params_np=None,
                                          frames=frames, num_tokens=WG,
                                          mesh="1x2", card_seed=0,
                                          count=True))]
    # The two spawns run at once; mesh=None's runs in this process
    # meanwhile, one at a time.
    t1 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fa = pool.submit(mesh_lib.spawn, mesh_runs.run, 4, (a, "cuda"),
                         device="cuda", threads=0, timeout_s=600)
        fb = pool.submit(mesh_lib.spawn, mesh_runs.run, 2, (b, "cuda"),
                         device="cuda", threads=0, timeout_s=600)
        none = {"train": mesh_runs.train(cfg, tcfg, None, device="cuda",
                                         count=True, card_seed=0),
                "serve": mesh_runs.serve(cfg, None, prompts, G, None,
                                         device="cuda", max_len=P + G,
                                         count=True, card_seed=0)}
        for kv in MESH46_KV:
            none[f"cserve_{kv}"] = mesh_runs.cserve(
                cfg, None, reqs, None, device="cuda", **cs_kw(kv))
        gc.collect()
        torch.cuda.empty_cache()
        wnone = {"train": mesh_runs.encdec_train(
                     wcfg, None, wbatches, None, device="cuda",
                     card_seed=0, count=True),
                 "decode": mesh_runs.encdec_decode(
                     wcfg, None, frames, WG, None, device="cuda",
                     card_seed=0, count=True)}
        none_s = time.perf_counter() - t1
        ra, rb = fa.result(), fb.result()
    spawn_s = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    out = {"spawn_s": spawn_s, "mesh_none_s": none_s,
           "scenario_s": {"1x4": ra[0]["_seconds"], "1x2": rb[0]["_seconds"]}}

    # (a) training: losses, launches
    steps = MESH46_TRAIN[0]
    ref = none["train"]
    got = [r["train"] for r in ra]
    want = {k: 0 for k in COUNTERS}
    want.update(flash_attention=MESH46_DEPTH * steps,
                flash_attention_bwd=MESH46_DEPTH * steps)
    for who, counts in [("mesh=None", ref["counts"])] + [
            (f"rank {r}", g["counts"]) for r, g in enumerate(got)]:
        if counts != want:
            _fail(f"phase 46 (a) training: {who} launches {counts}, "
                  f"expected {want}")
    for r, g in enumerate(got):
        if g["history"]["loss"] != got[0]["history"]["loss"]:
            _fail(f"phase 46 (a): rank {r}'s losses differ from rank 0's")
    err = float(np.max(np.abs(np.array(got[0]["history"]["loss"])
                              - np.array(ref["history"]["loss"]))))
    if not (err <= MESH_LOSS_TOL and all(
            math.isfinite(x) for x in got[0]["history"]["loss"])):
        _fail(f"phase 46 (a): 1x4 losses {got[0]['history']['loss']} off "
              f"mesh=None's {ref['history']['loss']} by {err}")
    out["train"] = {"losses": got[0]["history"]["loss"],
                    "losses_mesh_none": ref["history"]["loss"],
                    "loss_max_abs_err": err,
                    "launches_per_rank": [g["counts"] for g in got],
                    "peak_gib_per_rank": [g["peak_bytes"] / 2 ** 30
                                          for g in got],
                    "peak_gib_mesh_none": ref["peak_bytes"] / 2 ** 30}
    print(f"  (a) {cfg.name} training, {steps} AdamW steps of "
          f"{MESH46_TRAIN[1]} x {MESH46_TRAIN[2]}: losses "
          f"{out['train']['losses']} against mesh=None's "
          f"{out['train']['losses_mesh_none']} (max diff {err:.3g}, limit "
          f"{MESH_LOSS_TOL}); launches per rank {got[0]['counts']}, as "
          f"mesh=None's; peak per rank "
          f"{[round(p, 2) for p in out['train']['peak_gib_per_rank']]} GiB "
          f"against mesh=None's {out['train']['peak_gib_mesh_none']:.2f} "
          f"[{card}]")

    # (a) greedy generate against solo generate
    ref = none["serve"]
    got = [r["serve"] for r in ra]
    for r, g in enumerate(got):
        if not np.array_equal(g["tokens"], got[0]["tokens"]):
            _fail(f"phase 46 (a) generate: rank {r}'s tokens differ")
        if g["counts"] != ref["counts"] or ref["counts"][
                "flash_attention"] != MESH46_DEPTH:
            _fail(f"phase 46 (a) generate: rank {r} launches {g['counts']}"
                  f", solo's {ref['counts']}")
    equal = _ties_only("phase 46 (a) 1x4 generate", got[0]["tokens"],
                       ref["tokens"], ref["logits"])
    out["serve"] = {"rows_equal": equal,
                    "launches_per_rank": [g["counts"] for g in got]}
    print(f"  (a) greedy generate at 1x4 ({B} prompts of {P}, {G} tokens): "
          f"{equal} of {B} rows equal solo generate's (the rest at "
          f"near-ties); flash launches per rank "
          f"{[g['counts']['flash_attention'] for g in got]}, as solo's")

    # (a) the continuous paged runs: f32 streams against solo generate,
    # int8 ones against mesh=None's int8 run; launches and pool bytes
    params = mesh_runs.card_params(cfg, 0, "cuda")
    solo = [types.SimpleNamespace(
        uid=i, prompt=prompts[i], new_tokens=np.asarray(
            none["serve"]["tokens"][i, P:]), finish_reason="limit",
        completed=True) for i in range(B)]
    for kv in MESH46_KV:
        ref = none[f"cserve_{kv}"]
        got = [r[f"cserve_{kv}"] for r in ra]
        for r, g in enumerate(got):
            if [x["tokens"].tolist() for x in g["results"]] != \
                    [x["tokens"].tolist() for x in got[0]["results"]]:
                _fail(f"phase 46 (a) {kv}: rank {r}'s streams differ")
            if g["counts"] != ref["counts"] or not g["counts"][
                    "paged_attention"]:
                _fail(f"phase 46 (a) {kv}: rank {r} launches "
                      f"{g['counts']}, mesh=None's {ref['counts']}")
            if 2 * g["pool_bytes"] != ref["pool_bytes"]:
                _fail(f"phase 46 (a) {kv}: rank {r}'s pool holds "
                      f"{g['pool_bytes']} bytes, mesh=None's "
                      f"{ref['pool_bytes']} (1 of 2 KV heads: half)")
        if any(x["finish_reason"] != "limit" for x in got[0]["results"]):
            _fail(f"phase 46 (a) {kv}: not every request ran to its budget")
        mine = _as_results(reqs, got[0])
        want = solo if kv == "float32" else _as_results(reqs, ref)
        equal = streams_vs(f"phase 46 (a) {kv} 1x4 continuous", cfg,
                           registry, mine, want, params)
        out[f"cserve_{kv}"] = {
            "streams_equal": equal,
            "launches_per_rank": [g["counts"] for g in got],
            "pool_bytes_per_rank": [g["pool_bytes"] for g in got],
            "pool_bytes_mesh_none": ref["pool_bytes"],
            "tokens_per_s": got[0]["summary"]["tokens_per_s"],
            "tokens_per_s_mesh_none": ref["summary"]["tokens_per_s"]}
        print(f"  (a) continuous paged serving at 1x4 over {kv} pages "
              f"({B} requests into {MESH46_SLOTS} slots): {equal} of {B} "
              f"streams equal {'solo generate' if kv == 'float32' else 'mesh=None'}"
              f"'s; paged launches per rank "
              f"{[g['counts']['paged_attention'] for g in got]} as "
              f"mesh=None's {ref['counts']['paged_attention']}; a rank's "
              f"pool {got[0]['pool_bytes']} bytes, mesh=None's "
              f"{ref['pool_bytes']}; "
              f"{out[f'cserve_{kv}']['tokens_per_s']:.1f} tokens/s against "
              f"{out[f'cserve_{kv}']['tokens_per_s_mesh_none']:.1f} [{card}]")
    del params

    # (b) whisper-base: losses, decode
    ref = wnone["train"]
    got = [r["train"] for r in rb]
    for r, g in enumerate(got):
        if g["losses"] != got[0]["losses"]:
            _fail(f"phase 46 (b): rank {r}'s losses differ from rank 0's")
        if g["counts"]["flash_attention"] != ref["counts"]["flash_attention"] \
                or g["counts"]["flash_attention_bwd"] != \
                ref["counts"]["flash_attention_bwd"]:
            _fail(f"phase 46 (b): rank {r} launches {g['counts']}, "
                  f"mesh=None's {ref['counts']}")
    per_step = wcfg.num_encoder_layers + 2 * wcfg.num_layers
    if ref["counts"]["flash_attention"] != per_step * len(wbatches):
        _fail(f"phase 46 (b): mesh=None's launches {ref['counts']}")
    err = float(np.max(np.abs(np.array(got[0]["losses"])
                              - np.array(ref["losses"]))))
    if not (err <= MESH_LOSS_TOL and all(math.isfinite(x)
                                         for x in got[0]["losses"])):
        _fail(f"phase 46 (b): 1x2 losses {got[0]['losses']} off mesh=None's "
              f"{ref['losses']} by {err}")
    out["whisper_train"] = {"losses": got[0]["losses"],
                            "losses_mesh_none": ref["losses"],
                            "loss_max_abs_err": err,
                            "launches_per_rank": [g["counts"] for g in got],
                            "step_ms": [1e3 * x for x in got[0]["step_s"]],
                            "step_ms_mesh_none": [1e3 * x
                                                  for x in ref["step_s"]]}
    print(f"  (b) {wcfg.name} training, {len(wbatches)} Muon-NSGD steps of "
          f"{MESH46_WHISPER[1]} x {MESH46_WHISPER[2]} over "
          f"{wcfg.encoder_seq_len} frames: losses {got[0]['losses']} "
          f"against mesh=None's {ref['losses']} (max diff {err:.3g}); flash "
          f"launches per rank {[g['counts']['flash_attention'] for g in got]}"
          f", mesh=None's {ref['counts']['flash_attention']} [{card}]")
    ref = wnone["decode"]
    got = [r["decode"] for r in rb]
    for r, g in enumerate(got):
        if not np.array_equal(g["tokens"], got[0]["tokens"]):
            _fail(f"phase 46 (b) decode: rank {r}'s tokens differ")
        if g["counts"] != ref["counts"]:
            _fail(f"phase 46 (b) decode: rank {r} launches {g['counts']}, "
                  f"mesh=None's {ref['counts']}")
        heads = {s[-2] for s in g["cache_shapes"].values()}
        if heads != {wcfg.num_heads // 2}:
            _fail(f"phase 46 (b) decode: rank {r}'s caches {g['cache_shapes']}")
    equal = _ties_only("phase 46 (b) 1x2 whisper decode", got[0]["tokens"],
                       ref["tokens"], ref["logits"])
    out["whisper_decode"] = {"rows_equal": equal,
                             "launches_per_rank": [g["counts"] for g in got]}
    print(f"  (b) greedy decode at 1x2 ({len(frames)} rows, {WG} tokens "
          f"through encdec_decode_step, caches on {wcfg.num_heads // 2} of "
          f"{wcfg.num_heads} heads): {equal} of "
          f"{len(frames)} rows equal mesh=None's (the rest at near-ties)")
    out["lanes"] = mesh46_lanes(OPS["fa"], OPS["pa"], cfg, wcfg, card)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 46: {out['seconds']:.1f} s (spawns {spawn_s:.1f} s, "
          f"mesh=None {none_s:.1f} s; rank 0's scenarios "
          f"{ {k: {n: round(x, 1) for n, x in v.items()} for k, v in out['scenario_s'].items()} }) "
          f"[{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 45: the roofline and the dry run: gpt2-12l's training step counted
# on meta and on the card, then timed; one production cell of the dry run
# ---------------------------------------------------------------------------

# The card's count of the step's bytes against the meta count, and
# max_memory_allocated against the predicted peak (arguments + the
# counter's temp), relative.
ROOF_BYTES_TOL = 0.01
ROOF_PEAK_TOL = 0.15
ROOF_WARMUP, ROOF_TIMED = 2, 5
# One production cell of the dry run, in a child process.
DRYRUN_CELL = ["--arch", "starcoder2-3b", "--shape", "train_4k", "--mesh",
               "single"]


def _roof_step(cfg, registry, device):
    """(step, params, optimizer state, batch) of one training step at the
    launcher's shape (batch 16 x 256, f32, Muon-NSGD under WSD,
    ``mesh=None``): weights drawn once from seed 0 on the card, meta
    tensors on meta."""
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.core.schedules import make_schedule
    from repro_torch.optim.base import make_optimizer
    from repro_torch.train import steps
    tc = TrainConfig()
    opt = make_optimizer(OptimizerConfig())
    step = steps.make_train_step(cfg, opt, make_schedule(
        tc.schedule, tc.optimizer.learning_rate, TRAIN_STEPS))
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    params = registry.get_model(cfg).init(gen, cfg, device=device)
    B, S = TRAIN_SHAPE[:2]
    g = torch.Generator().manual_seed(1)
    batch = {k: (torch.empty((B, S), dtype=torch.long, device="meta")
                 if device == "meta" else
                 torch.randint(0, cfg.vocab_size, (B, S), generator=g)
                 .to(device)) for k in ("tokens", "labels")}
    return step, params, opt.init(params), batch


def _tree_bytes(*trees) -> int:
    from repro_torch.tree import leaves_with_path
    return sum(x.numel() * x.element_size() for t in trees
               for _, x in leaves_with_path(t))


def roofline_phase(cfglib, registry, card) -> dict:
    """Phase 45: (a) gpt2-12l's 12-layer training step counted on meta
    (FLOPs by unit, bytes, kernel bytes, the predicted peak: arguments +
    the counter's temp); (b) the same step on the card under the counter
    after a warm-up: FLOPs equal to (a)'s, each kernel region's entries
    equal to its launch counter, bytes within ``ROOF_BYTES_TOL``; (c) the
    step timed with CUDA events (``ROOF_TIMED`` steps after
    ``ROOF_WARMUP``): median and spread, achieved FLOP/s, ``mfu`` (the
    model FLOPs over the median at the f32 peak, TF32 off), the roofline's
    t_compute/t_memory, max_memory_allocated against the predicted peak
    within ``ROOF_PEAK_TOL``; (d) ``DRYRUN_CELL`` through the dry run's CLI
    in a child process, its row through ``roofline.report``."""
    from repro_torch.configs.base import HW_PEAK_F32_FLOPS, ShapeConfig
    from repro_torch.roofline import analysis
    from repro_torch.roofline.torch_cost import StepCounter
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfglib.get_config("gpt2-12l")
    B, S = TRAIN_SHAPE[:2]
    shape = ShapeConfig("gpt2_train_16x256", S, B, "train")
    model_flops = analysis.model_flops_estimate(cfg, shape)

    # (a) the count on meta
    step, params, state, batch = _roof_step(cfg, registry, "meta")
    args = _tree_bytes(params, state, batch)
    with StepCounter() as meta_counter:
        step(params, state, batch, 0)
    meta = meta_counter.count
    predicted_peak = args + meta.peak_bytes
    terms = analysis.RooflineTerms(
        arch="gpt2-12l", shape=shape.name, mesh="none", chips=1,
        hlo_flops=meta.flops, hlo_bytes=meta.bytes, coll_bytes_weighted=0.0,
        coll_by_op={}, model_flops=model_flops,
        flops_by_unit=dict(meta.by_unit))
    print(f"  {card}: (a) gpt2-12l train step {B}x{S} f32 on meta: "
          f"{meta.flops:.6e} FLOPs ({ {u: f'{f:.4e}' for u, f in meta.by_unit.items()} }), "
          f"{meta.bytes:.6e} bytes outside kernels, {meta.kernel_bytes:.6e} "
          f"kernel bytes, regions {dict(meta.regions)}; arguments {args} "
          f"bytes + temp {meta.peak_bytes} = predicted peak "
          f"{predicted_peak / 2 ** 30:.3f} GiB; model FLOPs "
          f"{model_flops:.6e}; t_compute {terms.t_compute * 1e3:.3f} ms, "
          f"t_memory {terms.t_memory * 1e3:.3f} ms")
    del params, state, batch

    # (b) the same step on the card under the counter, after a warm-up
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    step, params, state, batch = _roof_step(cfg, registry, "cuda")
    params, state, _ = step(params, state, batch, 0)
    torch.cuda.synchronize()
    zero_counts()
    with StepCounter() as card_counter:
        params, state, _ = step(params, state, batch, 1)
        torch.cuda.synchronize()
    launches = read_counts()
    got = card_counter.count
    fused, large = _ns_launches(cfg)
    regions = {k: got.regions.get(k, 0) for k in launches}
    byte_diff = abs(got.bytes - meta.bytes) / meta.bytes
    print(f"  {card}: (b) the step on the card under the counter: "
          f"{got.flops:.6e} FLOPs (meta {meta.flops:.6e}), "
          f"{got.bytes:.6e} bytes ({100 * byte_diff:.4f}% off meta's), "
          f"kernel bytes {got.kernel_bytes:.6e}; regions {regions}, "
          f"launches {launches}")
    if got.flops != meta.flops:
        _fail(f"phase 45: the card counted {got.flops} FLOPs, meta "
              f"{meta.flops}")
    want = {k: 0 for k in launches}
    want.update(flash_attention=cfg.num_layers,
                flash_attention_bwd=cfg.num_layers, ns_fused=fused,
                matmul=large)
    if regions != launches or launches != want:
        _fail(f"phase 45: regions {regions}, launches {launches} (flash "
              f"{cfg.num_layers} and its backward {cfg.num_layers}, ns_fused "
              f"{fused}, matmul {large} expected, each region = its launches)")
    if byte_diff > ROOF_BYTES_TOL:
        _fail(f"phase 45: bytes {got.bytes} against meta's {meta.bytes}")

    # (c) the timing
    for i in range(ROOF_WARMUP):
        params, state, _ = step(params, state, batch, 2 + i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(ROOF_TIMED):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        params, state, _ = step(params, state, batch, 2 + ROOF_WARMUP + i)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    peak = torch.cuda.max_memory_allocated() - before
    median = float(np.median(ms))
    mfu = model_flops / (median / 1e3 * HW_PEAK_F32_FLOPS)
    peak_ratio = peak / predicted_peak
    print(f"  {card}: (c) {ROOF_TIMED} steps after {ROOF_WARMUP} warm-ups: "
          f"median {median:.3f} ms (min {min(ms):.3f}, max {max(ms):.3f}, "
          f"spread {max(ms) - min(ms):.3f} ms); counted {got.flops / median / 1e9:.2f} "
          f"TFLOP/s achieved, model {model_flops / median / 1e9:.2f} TFLOP/s, "
          f"mfu {mfu:.4f} (model FLOPs / (median x "
          f"{HW_PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32)); roofline "
          f"t_compute {terms.t_compute * 1e3:.3f} ms, t_memory "
          f"{terms.t_memory * 1e3:.3f} ms ({terms.dominant}); peak "
          f"{peak / 2 ** 30:.3f} GiB against the predicted "
          f"{predicted_peak / 2 ** 30:.3f} GiB ({peak_ratio:.4f}x)")
    if abs(peak_ratio - 1) > ROOF_PEAK_TOL:
        _fail(f"phase 45: max_memory_allocated {peak} against the predicted "
              f"{predicted_peak} ({peak_ratio:.4f}x)")
    del params, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    # (d) one production cell of the dry run in a child process
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_CELL,
             "--out", tmp], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=300)
        cell_s = time.perf_counter() - t0
        if run.returncode != 0:
            _fail(f"phase 45: the dry run exited {run.returncode}: "
                  f"{run.stdout[-2000:]} {run.stderr[-2000:]}")
        rep = subprocess.run(
            [sys.executable, "-m", "repro_torch.roofline.report", "--dir",
             tmp], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=120, check=True)
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name)) as f:
            cell = json.load(f)
    print(f"  {card}: (d) dry run {' '.join(DRYRUN_CELL)} in a child "
          f"process: {cell_s:.1f} s, count {cell['count_s']:.1f} s; "
          f"roofline.report:")
    for line in rep.stdout.splitlines():
        print(f"    {line}")
    seconds = time.perf_counter() - t_phase
    print(f"roofline phase {seconds:.1f} s")
    return dict(card=card, meta_flops=meta.flops,
                flops_by_unit=dict(meta.by_unit), meta_bytes=meta.bytes,
                kernel_bytes=meta.kernel_bytes, card_flops=got.flops,
                card_bytes=got.bytes, regions=regions, launches=launches,
                arguments_bytes=args, temp_bytes=meta.peak_bytes,
                predicted_peak_bytes=predicted_peak,
                max_memory_allocated=peak, step_ms=ms, median_ms=median,
                model_flops=model_flops, mfu=mfu,
                t_compute_ms=terms.t_compute * 1e3,
                t_memory_ms=terms.t_memory * 1e3,
                dryrun_cell={k: cell[k] for k in (
                    "arch", "shape", "mesh", "chips", "hlo_flops",
                    "t_compute", "t_memory", "t_collective", "dominant",
                    "roofline_fraction", "fits_hbm", "count_s")},
                dryrun_cell_s=cell_s, seconds=seconds)


def run_only(only, cfglib, registry, fa_ops, pa_ops, train, serve) -> int:
    """``--only``: after the card and the build, the named phases of
    36-46 alone, each as the full run makes it (41 and 42 on weights drawn
    on the card for them); prints their readings as JSON and no closing
    line."""
    got = {}
    if 45 in only:
        got["45"] = roofline_phase(cfglib, registry, card_line())
    if 40 in only:
        got["40"] = recipe_phase(cfglib)
    if 41 in only:
        cfg = cfglib.get_config("rwkv6-7b")
        params = draw_on_card(registry, cfg)
        got["41"], cut = rwkv_backward_phase(cfglib, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        rwkv_backward_rest(cfglib, OPS["wkv"], got["41"], cut)
        del cut
        gc.collect()
        torch.cuda.empty_cache()
    if 42 in only:
        cfg8 = cfglib.get_config("jamba-v0.1-52b").with_depth(JAMBA_DEPTH)
        params = draw_on_card(registry, cfg8)
        got["42"], cut = jamba_backward_phase(cfg8, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        jamba_backward_rest(OPS["scan"], cfg8, got["42"], cut)
        del cut
        gc.collect()
        torch.cuda.empty_cache()
    if 36 in only:
        got["36"] = cross_attention_lane(fa_ops)
    if 37 in only:
        got["37"] = deepseekv3_paths(cfglib, registry, train, serve, fa_ops)
    if 38 in only:
        got["38"] = qwen2_vl_paths(cfglib, registry, fa_ops)
    if 39 in only:
        got["39"] = whisper_paths(cfglib, registry)
    if 43 in only:
        got["43"] = mesh_phase(cfglib, card_line())
    if 44 in only:
        got["44"] = mesh_layers_phase(cfglib, registry, card_line())
    if 46 in only:
        got["46"] = mesh_heads_phase(cfglib, registry, card_line())
    print(json.dumps(got))
    return 0


def main() -> int:
    only = None
    if sys.argv[1:2] == ["--only"] and len(sys.argv) == 3:
        only = {int(x) for x in sys.argv[2].split(",")}
        if not only <= set(range(36, 47)):
            print("chip_smoke: --only takes phases among 36-46",
                  file=sys.stderr)
            return 2
    elif sys.argv[1:]:
        print("usage: chip_smoke.py [--only 36,37,...,46]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs as cfglib
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.newton_schulz import ops as ns_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.launch import serve, train
    from repro_torch.models import registry
    from repro_torch.train.serve_engine import ServeEngine
    from repro_torch.kernels import LAUNCH_COUNTERS
    COUNTERS.update(LAUNCH_COUNTERS)
    OPS.update(fa=fa_ops, pa=pa_ops, ns=ns_ops, wkv=wkv_ops, scan=scan_ops)

    # 1. the card
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. the build: one nvcc per kernel, all started together
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(_build.KERNELS)}")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")
    fa_regs = flash_registers(_build.build_log("flash_attention"))
    print("flash entry functions (registers, spill bytes): " + "; ".join(
        f"{n} {r}, {sp}" for n, r, sp in fa_regs))
    if len(fa_regs) != 18 or any(sp for _, _, sp in fa_regs):
        _fail(f"flash entry functions: {fa_regs} (18 expected, none spilling)")
    pa_regs = paged_registers(_build.build_log("paged_attention"))
    print("paged entry functions (registers, spill bytes): " + "; ".join(
        f"{n} {r}, {sp}" for n, r, sp in pa_regs))
    if len(pa_regs) != 72 or any(sp for _, _, sp in pa_regs):
        _fail(f"paged entry functions: {pa_regs} (72 expected, none "
              "spilling)")
    hd256_regs = hd256_registers(fa_regs, pa_regs)
    wkv_regs = wkv_registers(_build.build_log("rwkv6"))
    scan_regs = scan_registers(_build.build_log("mamba_scan"))
    print("wkv and scan entry functions (registers, spill bytes): "
          + "; ".join(f"{n} {r}, {sp}" for n, r, sp in wkv_regs + scan_regs))
    if (len(wkv_regs) != 24 or len(scan_regs) != 12
            or any(sp for _, _, sp in wkv_regs + scan_regs)):
        _fail(f"wkv and scan entry functions: {wkv_regs} {scan_regs} (24 "
              "and 12 expected: the forward, its chunk-saving twin and the "
              "backward; none spilling)")
    if only:
        return run_only(only, cfglib, registry, fa_ops, pa_ops, train,
                        serve)

    _mark("3-4")
    # 3-4. kernel parity on the card
    main_err = parity(fa_ops)
    fa_f64 = fa_f64_and_repeats(fa_ops)
    paged_errs = paged_parity(pa_ops)

    _mark("32")
    # 32. the hd-256 kernels (gemma2's and gemma3's shapes) against their
    # plain versions, f32 and bf16, and their times
    t0 = time.perf_counter()
    fa256 = hd256_flash(fa_ops)
    pa256 = hd256_paged(pa_ops)
    print(f"hd 256 kernels phase {time.perf_counter() - t0:.1f} s")

    _mark("36")
    # 36. the flash kernels at S_k != S_q (whisper's cross-attention) and
    # at the encoder's S = 1500, non-causal, against their plain versions
    cross = cross_attention_lane(fa_ops)

    _mark("5")
    # 5. the contiguous main path, counters from 0
    cfg = cfglib.get_config("gpt2-12l")
    zero_counts()
    res = serve.main(MAIN_ARGV)
    # serve.main runs two generations (warm-up and timed): two prefills of
    # one launch per layer, and contiguous decode attention is plain torch.
    launches = expect_counts("main path", flash_attention=2 * cfg.num_layers)[
        "flash_attention"]
    if res.tokens.shape != (8, 512 + 64):
        _fail(f"main path returned tokens {res.tokens.shape}")
    if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
        _fail("main path produced tokens outside the vocabulary")
    print(f"main path: {launches} flash-attention launches "
          f"(2 prefills x {cfg.num_layers} layers, 0 in decode)")

    _mark("6")
    # 6. the continuous paged main path, counters from 0; then over int8
    # pages, fp8 pages and the prefix cache over int8 pages, counters from
    # 0 before each
    paged_launches, _, paged_results, _, paged_stats = paged_main_path(
        cfg, serve, fa_ops, pa_ops)
    quant_launches, quant_results = quant_main_paths(cfg, serve, fa_ops,
                                                     pa_ops)

    _mark("7")
    # 7. card against CPU
    card_vs_cpu(cfglib, registry, ServeEngine, fa_ops)
    paged_card_vs_cpu(cfglib, registry)
    quant_card_vs_cpu(cfglib, registry)

    _mark("8")
    # 8. times
    t = times(fa_ops)
    readings = profiler_readings()
    pa_call = paged_one_kernel(pa_ops, readings["paged"])
    tp = paged_times(pa_ops)
    tq = {name: paged_times(pa_ops, dt) for name, dt in
          (("int8", torch.int8), ("float8_e4m3fn", torch.float8_e4m3fn))}
    t_g12 = paged_times(pa_ops, s=G12_SHAPE)     # starcoder2-3b's decode
    quantized = [
        {"kv_dtype": name, "launches": quant_launches[key],
         "prefix_cache_launches": (quant_launches["prefix+int8"]
                                   if key == "int8" else None),
         "max_abs_err": paged_errs[name], **tq[name]}
        for name, key in (("int8", "int8"), ("float8_e4m3fn", "fp8"))]

    _mark("9")
    # 9. training parity on the card
    ns_err = ns_parity(ns_ops)
    mm_err = matmul_parity(ns_ops)
    bwd_err = bwd_parity(fa_ops)
    bwd_f64 = bwd_f64_and_repeats(fa_ops)

    _mark("10-11")
    # 10-11. the training main path, counters from 0, then serve its
    # checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "run")
        res, train_counts = train_main_path(cfg, train, ckpt_dir)
        serve_trained(serve, ckpt_dir, cfg.num_layers)

    _mark("12")
    # 12. card against CPU, one train step (gpt2-12l at depth 1,
    # llama3-0.3b and mixtral-0.3b at depth 2)
    train_card_vs_cpu(cfglib, registry)
    train_card_vs_cpu(cfglib, registry, "llama3-0.3b", 2)
    train_card_vs_cpu(cfglib, registry, "mixtral-0.3b", 2)

    _mark("13")
    # 13. training times
    t_ns, t_mm, t_bwd = train_times(ns_ops, fa_ops, res, cfg)

    _mark("45")
    # 45. the roofline: gpt2-12l's training step counted on meta and on the
    # card under the counter, timed; one production cell of the dry run
    gc.collect()
    torch.cuda.empty_cache()
    roof = roofline_phase(cfglib, registry, card)

    _mark("14")
    # 14. WKV parity on the card
    t0 = time.perf_counter()
    wkv_err = wkv_parity(wkv_ops)
    print(f"wkv parity phase {time.perf_counter() - t0:.1f} s")

    _mark("15")
    # 15. the RWKV6 main path, counters from 0, on weights drawn once on
    # the card for phases 15-17 and 27
    rwkv_cfg = cfglib.get_config("rwkv6-7b")
    rwkv_params = draw_on_card(registry, rwkv_cfg)
    rwkv_res, wkv_launches, _ = rwkv_main_path(cfglib, rwkv_params)

    _mark("16")
    # 16. card against CPU
    t0 = time.perf_counter()
    rwkv_card_vs_cpu(cfglib, registry)
    print(f"rwkv card vs cpu phase {time.perf_counter() - t0:.1f} s")

    _mark("17")
    # 17. WKV times
    t_wkv = wkv_times(wkv_ops, rwkv_res, rwkv_cfg.num_layers,
                      readings["wkv"])
    del rwkv_res

    _mark("27")
    # 27. rwkv6-7b at full width and depth in continuous serving on phase
    # 15's weights (run right after phase 17): paged through the CLI, then
    # the prefix cache, speculation and the paper's draft, counters from 0
    # before each run
    rwkv_cont = rwkv_continuous_paths(cfglib, registry, rwkv_params)

    _mark("41")
    # 41. the WKV backward (right after phase 27, on phase 15's weights):
    # one depth-1 step card against CPU; then, the weights freed, its lane
    # and times and rwkv6-7b trained 2 -> 4 layers from a cut of them
    rwkv_bwd, rwkv_cut = rwkv_backward_phase(cfglib, rwkv_params)
    del rwkv_params
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_backward_rest(cfglib, wkv_ops, rwkv_bwd, rwkv_cut)
    del rwkv_cut
    gc.collect()
    torch.cuda.empty_cache()

    _mark("18")
    # 18. scan parity on the card
    t0 = time.perf_counter()
    scan_err = scan_parity(scan_ops)
    print(f"scan parity phase {time.perf_counter() - t0:.1f} s")

    _mark("19")
    # 19. the jamba main path, counters from 0
    jamba_cfg, engine, jamba_res, jamba_counts, _ = jamba_main_path(
        cfglib, registry, ServeEngine)

    _mark("20")
    # 20. card against CPU
    jamba_host = jamba_card_vs_cpu(jamba_cfg, engine, registry)

    _mark("21")
    # 21. scan times
    n_mamba = sum(jamba_cfg.layer_kind(i) == "mamba"
                  for i in range(jamba_cfg.num_layers))
    t_scan, t_fa_jamba = jamba_times(scan_ops, fa_ops, jamba_res,
                                     n_mamba, readings["scan"])

    _mark("28")
    # 28. jamba in continuous serving on phase 19's weights: paged over
    # f32 and int8 pages, contiguous, the zero-layer draft; counters from 0
    # before each run.  29, jamba's half: card against CPU, paged
    jamba_cont = jamba_continuous_paths(jamba_cfg, engine)
    jamba_paged_card_vs_cpu(jamba_cfg, engine, jamba_host)

    _mark("42")
    # 42. the scan backward (right after phase 29's jamba half, on phase
    # 19's weights): one depth-1 step card against CPU; then, the 8 layers
    # freed, its lane and times and jamba's first two layers trained from a
    # cut of them
    jamba_bwd, jamba_cut = jamba_backward_phase(jamba_cfg, engine.params,
                                                jamba_host)
    del engine, jamba_host
    gc.collect()
    torch.cuda.empty_cache()
    jamba_backward_rest(scan_ops, jamba_cfg, jamba_bwd, jamba_cut)
    del jamba_cut
    gc.collect()
    torch.cuda.empty_cache()

    _mark("22")
    # 22. self-speculative decoding: phase 6's traffic, counters from 0;
    # the same with the prefix cache over int8 pages; the paper's draft;
    # spec streams against phase 6's
    t0 = time.perf_counter()
    spec_results, spec_sched, spec_stats, spec_launches = spec_main_path(
        cfg, serve, fa_ops)
    print(f"  {card}: spec aggregate tokens/s "
          f"{spec_stats['tokens_per_s']:.1f} against phase 6's f32 "
          f"{paged_stats['tokens_per_s']:.1f}")
    _, sched_pi, _, _ = spec_main_path(cfg, serve, fa_ops,
                                       ("--prefix-cache", "--kv-dtype",
                                        "int8", "--requests",
                                        str(SPEC_PREFIX_REQUESTS)))
    if sched_pi.prefix_hits < 1:
        _fail(f"the spec prefix-cache run had no hit: "
              f"{sched_pi.prefix_stats()}")
    spec_zerol(cfglib, registry, "gpt2-12l", GPT2_ZEROL_DEPTH)
    spec_vs_plain(cfg, registry, spec_results, paged_results,
                  spec_sched.engine)
    print(f"spec phase {time.perf_counter() - t0:.1f} s")

    _mark("23")
    # 23. progressive training of llama3-0.3b at full width and depth
    t0 = time.perf_counter()
    rope_train_path(cfglib, train, "llama3-0.3b")
    print(f"llama3 training phase {time.perf_counter() - t0:.1f} s")

    _mark("24")
    # 24. qwen3-0.3b over paged KV, f32 and int8 pages; the paper's draft
    t0 = time.perf_counter()
    rope_serve_paths(cfglib, registry, serve, fa_ops, pa_ops, "qwen3-0.3b",
                     int8=True, depth=SERVE_CUT["qwen3-0.3b"])
    spec_zerol(cfglib, registry, "qwen3-0.3b", QWEN3_ZEROL_DEPTH)
    print(f"qwen3 serving phase {time.perf_counter() - t0:.1f} s")

    _mark("25")
    # 25. mixtral-0.3b: a few training steps through one expansion, then
    # phase 6's traffic over paged KV
    t0 = time.perf_counter()
    rope_train_path(cfglib, train, "mixtral-0.3b", MIXTRAL_TRAIN_ARGV)
    rope_serve_paths(cfglib, registry, serve, fa_ops, pa_ops, "mixtral-0.3b",
                     depth=SERVE_CUT["mixtral-0.3b"])
    print(f"mixtral phase {time.perf_counter() - t0:.1f} s")

    _mark("26")
    # 26. starcoder2-3b at full width over paged KV (the paged kernel at
    # G = 12, hd 128), then card against CPU at depth 2 (flash's prefill at
    # G = 12, and three paged requests)
    t0 = time.perf_counter()
    g12_launches, _, _ = rope_serve_paths(
        cfglib, registry, serve, fa_ops, pa_ops, "starcoder2-3b",
        depth=SERVE_CUT["starcoder2-3b"])
    gc.collect()
    torch.cuda.empty_cache()
    card_vs_cpu(cfglib, registry, ServeEngine, fa_ops, "starcoder2-3b", 2)
    paged_card_vs_cpu(cfglib, registry, "starcoder2-3b", 2)
    print(f"starcoder2 phase {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    _mark("29")
    # 29, rwkv6-7b's half: card against CPU at depth 2, paged with a
    # prefix hit
    rwkv_paged_card_vs_cpu(cfglib, registry)

    _mark("30")
    # 30. fault tolerance in serving, over phase 6's traffic: a fault
    # storm, each serving site once over the prefix cache on int8 pages,
    # the draft prefill under speculation, a crash restored on a fresh
    # engine, a bounded queue and a deadline; rwkv6-7b at depth 2 crashed
    # and restored
    t0 = time.perf_counter()
    fault_serving_paths(cfg, cfglib, registry, serve, paged_results,
                        quant_results["prefix+int8"], spec_results)
    print(f"fault serving phase {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    _mark("31")
    # 31. fault tolerance in training: phase 13's run twice, bit for bit;
    # crashes resumed; nan under skip; the hang deadline; the async save
    t0 = time.perf_counter()
    fault_training_paths(cfg, registry)
    print(f"fault training phase {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    _mark("33")
    # 33. gemma2-9b at full size, paged continuous serving past its window,
    # held to solo generation; card against CPU at depth 2
    g2 = gemma2_full_serving(cfglib, registry)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paged_card_vs_cpu(cfglib, registry, "gemma2-9b", 2)
    print(f"gemma2-9b card vs cpu phase {time.perf_counter() - t0:.1f} s")

    _mark("34")
    # 34. gemma3-12b at full width and 12 layers: paged f32 and int8, the
    # prefix cache restoring ring snapshots, speculation
    gc.collect()
    torch.cuda.empty_cache()
    g3 = gemma3_serving(cfglib, registry)
    gc.collect()
    torch.cuda.empty_cache()

    _mark("35")
    # 35. training: gemma2-9b at full width 2 -> 4 layers under AdamW and
    # remat; gpt2-12l under AdamW, NSGD and SGD, remat bit for bit off
    g2_train = gemma2_training(cfglib)
    gc.collect()
    torch.cuda.empty_cache()
    recipe_peaks = recipe_training(cfglib)
    gc.collect()
    torch.cuda.empty_cache()

    _mark("37")
    # 37. deepseekv3-0.3b (MLA) at 4 layers: the paper's recipe 1 -> 4
    # layers, its checkpoint served over latent pages (f32, int8, prefix
    # cache), a copying_zeroL draft, card against CPU at depth 2
    dsv3 = deepseekv3_paths(cfglib, registry, train, serve, fa_ops)
    gc.collect()
    torch.cuda.empty_cache()

    _mark("38")
    # 38. qwen2-vl-2b (M-RoPE) at full size: paged serving, one training
    # step with 256 frontend embeds, card against CPU at depth 2
    vl = qwen2_vl_paths(cfglib, registry, fa_ops)
    gc.collect()
    torch.cuda.empty_cache()

    _mark("39")
    # 39. whisper-base at full size: training on frames through an
    # expansion, greedy decoding against teacher forcing
    wh = whisper_paths(cfglib, registry)
    gc.collect()
    torch.cuda.empty_cache()

    _mark("40")
    # 40. the paper's expansion-timing recipe: calibrate_tau on gpt2-12l
    # at full width, the quickstart's savings line for its plan
    rec = recipe_phase(cfglib)
    gc.collect()
    torch.cuda.empty_cache()

    _mark("43")
    # 43. the mesh: gpt2-12l 1 -> 2 layers on a single mesh against
    # mesh=None, then on two ranks sharing the card (2x1, 1x2), elastic
    # checkpoints and serving the grown checkpoint
    mesh = mesh_phase(cfglib, card)

    _mark("44")
    # 44. expert parallelism and the tensor-parallel Mamba, RWKV6 and MLA
    # layers on 1x2: jamba's first two layers, rwkv6-7b and
    # deepseekv3-0.3b at full width and depth 2 against mesh=None, each
    # kernel at its rank-local shape against its plain version
    mesh44 = mesh_layers_phase(cfglib, registry, card)
    gc.collect()
    torch.cuda.empty_cache()

    _mark("46")
    # 46. attention on a rank's query heads over one KV head (starcoder2-3b
    # at 1x4) and the tensor-parallel encoder-decoder (whisper-base at
    # 1x2) against mesh=None, each kernel at its rank-local shape against
    # its plain version
    mesh46 = mesh_heads_phase(cfglib, registry, card)
    gc.collect()
    torch.cuda.empty_cache()

    def mesh_launches(kernel):
        return {spec: [c[kernel] for c in mesh[spec]["launches_per_rank"]]
                for spec in ("2x1", "1x2")}

    def mesh44_launches(kernel, run):
        return [c[kernel] for c in mesh44[run]["launches_per_rank"]]

    def fault_launches(kernel):
        """Each rank's launches in phase 43's lanes (f)-(h)."""
        f = mesh["faults"]
        out = {name: [c[kernel] for c in r["launches_per_rank"]]
               for name, r in f.items() if "launches_per_rank" in r}
        for knob in MESH_KNOBS:
            for key in ("serve", "cserve"):
                out[f"{key}_{knob}_{f[knob]['spec']}"] = [
                    c[kernel] for c in f[knob][f"{key}_launches_per_rank"]]
        return out

    record = {"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
         "launches": launches, "spec_path_launches": spec_launches,
         "mesh_43_launches_per_rank": mesh_launches("flash_attention"),
         "mesh_43_serve_launches_per_rank": {
             spec: [c["flash_attention"] for c in
                    mesh[f"serve_{spec}"]["launches_per_rank"]]
             for spec in ("2x1", "1x2")},
         "mesh_43_tp_local_shape_err": mesh["flash_6_heads"]["out"],
         "mesh_43_fault_knob_launches_per_rank": fault_launches(
             "flash_attention"),
         "mesh_44_launches_per_rank": {
             "deepseekv3_0_3b_training": mesh44_launches("flash_attention",
                                                         "dsv3")},
         "mesh_44_local_shape_err": mesh44["lanes"]["flash_attention"],
         "mesh_46_launches_per_rank": {
             "starcoder2_3b_training_1x4": [
                 c["flash_attention"] for c in
                 mesh46["train"]["launches_per_rank"]],
             "starcoder2_3b_generate_1x4": [
                 c["flash_attention"] for c in
                 mesh46["serve"]["launches_per_rank"]],
             "whisper_base_training_1x2": [
                 c["flash_attention"] for c in
                 mesh46["whisper_train"]["launches_per_rank"]]},
         "mesh_46_local_shape_err": {
             "6_heads_over_1": mesh46["lanes"]["errs"]["flash_attention"],
             "whisper_cross_4_heads":
                 mesh46["lanes"]["errs"]["cross_flash_attention"]},
         "mesh_46_local_shape": mesh46["lanes"]["times"]["forward"],
         "jamba_contiguous_launches":
             jamba_cont["contiguous"]["flash_attention"],
         "max_abs_err": main_err, **t,
         **t_fa_jamba, "f64_err": fa_f64,
         "registers_spills": [list(r) for r in fa_regs],
         "cross_attention": {lbl: {d: r["forward"] for d, r in v.items()}
                             for lbl, v in cross.items()},
         "new_archs_launches": {
             "deepseekv3_0_3b_training": dsv3["training"]["flash_attention"],
             "deepseekv3_0_3b_zerol_spec": dsv3["spec"],
             "qwen2_vl_2b_train_step": vl["training"]["flash_attention"],
             "whisper_base_training": wh["training"]["flash_attention"],
             "whisper_base_decode": wh["decode"]["flash_attention"]},
         "hd_256": {"launches": {"gemma2_9b_solo_generate": g2["flash_solo"],
                                 "gemma3_12b_spec": g3["spec"],
                                 "gemma2_9b_training":
                                     g2_train["flash_attention"]},
                    "shapes": {a: {d: r["forward"] for d, r in v.items()}
                               for a, v in fa256.items()},
                    "registers_spills": hd256_regs["flash"]}},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/paged_attention/csrc/"
                   "paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:97",
         "launches": g12_launches, "max_abs_err": paged_errs["float32 G12"],
         "shape": "starcoder2-3b decode: B=8 H=24 KV=2 hd=128 bs=16 "
                  "cursors 575, f32 pages, L2 flushed", **t_g12,
         "qwen2_vl_2b_launches": vl["paged_f32"],
         "gpt2_12l": {"launches": paged_launches, "spec_path_launches": 0,
                      "max_abs_err": paged_errs["float32"], **tp, **pa_call},
         "quantized": quantized,
         "mesh_43_launches_per_rank": {
             name: [c["paged_attention"] for c in r["launches_per_rank"]]
             for name, r in mesh["serving"].items()
             if name.startswith("cserve_")},
         "mesh_43_tp_local_shape_err": {
             kv: mesh["serving"][f"paged_6_heads_{kv}"]
             for kv in ("float32", "int8")},
         "mesh_43_fault_knob_launches_per_rank": fault_launches(
             "paged_attention"),
         "mesh_46_launches_per_rank": {
             kv: [c["paged_attention"] for c in
                  mesh46[f"cserve_{kv}"]["launches_per_rank"]]
             for kv in MESH46_KV},
         "mesh_46_local_shape_err": {
             kv: mesh46["lanes"]["errs"][f"paged_attention_{kv}"]
             for kv in MESH46_KV},
         "mesh_46_local_shape": dict(
             shape="starcoder2-3b decode at a 1x4 rank: B=8 H=6 KV=1 "
                   "hd=128 bs=16 cursors 575, f32 pages, L2 flushed",
             **mesh46["lanes"]["times"]["paged"]),
         "jamba_v01_52b": {run: jamba_cont[run]["paged_attention"]
                           for run in ("paged f32", "paged int8")},
         "registers_spills": [list(r) for r in pa_regs],
         "hd_256": {"launches": {"gemma2_9b": g2["paged"],
                                 **{f"gemma3_12b_{k}": v for k, v in
                                    g3.items() if k != "spec"}},
                    "shape": "gemma decode: B=4 H=16 KV=8 hd=256 bs=16 "
                             "cursors 5000, softcap 50, q f32, L2 flushed",
                    "pages": pa256,
                    "registers_spills": hd256_regs["paged"]}},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd.cu",
         "replaces": "none (no TPU kernel: JAX differentiates its attention "
                     "itself)",
         "launches": train_counts["flash_attention_bwd"],
         "max_abs_err": bwd_err, "f64_err": bwd_f64, **t_bwd,
         "mesh_43_launches_per_rank": mesh_launches("flash_attention_bwd"),
         "mesh_43_tp_local_shape_err": max(
             v for k, v in mesh["flash_6_heads"].items() if k != "out"),
         "mesh_44_launches_per_rank": {
             "deepseekv3_0_3b_training": mesh44_launches(
                 "flash_attention_bwd", "dsv3")},
         "mesh_44_local_shape_err": mesh44["lanes"]["flash_attention_bwd"],
         "mesh_46_launches_per_rank": {
             "starcoder2_3b_training_1x4": [
                 c["flash_attention_bwd"] for c in
                 mesh46["train"]["launches_per_rank"]],
             "whisper_base_training_1x2": [
                 c["flash_attention_bwd"] for c in
                 mesh46["whisper_train"]["launches_per_rank"]]},
         "mesh_46_local_shape_err": {
             "6_heads_over_1": mesh46["lanes"]["errs"]["flash_attention_bwd"],
             "whisper_cross_4_heads":
                 mesh46["lanes"]["errs"]["cross_flash_attention_bwd"]},
         "mesh_46_local_shape": mesh46["lanes"]["times"]["backward"],
         "cross_attention": {lbl: {d: r["backward"] for d, r in v.items()}
                             for lbl, v in cross.items()},
         "new_archs_launches": {
             "deepseekv3_0_3b_training":
                 dsv3["training"]["flash_attention_bwd"],
             "qwen2_vl_2b_train_step": vl["training"]["flash_attention_bwd"],
             "whisper_base_training": wh["training"]["flash_attention_bwd"]},
         "hd_256": {"launches": {"gemma2_9b_training":
                                 g2_train["flash_attention_bwd"]},
                    "shapes": {a: {d: r["backward"] for d, r in v.items()}
                               for a, v in fa256.items()},
                    "peak_gib_gemma2_9b_training": g2_train["peak_gib"],
                    "peak_gib_gpt2_12l_recipe": recipe_peaks}},
        {"name": "ns_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/newton_schulz/csrc/"
                   "newton_schulz.cu",
         "replaces": "src/repro/kernels/newton_schulz/kernel.py:48",
         "launches": train_counts["ns_fused"], "max_abs_err": ns_err,
         "mesh_43_launches_per_rank": mesh_launches("ns_fused"),
         "mesh_44_launches_per_rank": {
             run: mesh44_launches("ns_fused", run)
             for run in ("jamba", "rwkv", "dsv3")},
         "mesh_44_local_shape_err": mesh44["lanes"]["ns_fused"],
         "new_archs_launches": {
             "deepseekv3_0_3b": dsv3["training"]["ns_fused"],
             "qwen2_vl_2b": vl["training"]["ns_fused"],
             "whisper_base": wh["training"]["ns_fused"]},
         **t_ns},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/newton_schulz/csrc/"
                   "newton_schulz.cu",
         "replaces": "src/repro/kernels/newton_schulz/kernel.py:79",
         "launches": train_counts["matmul"], "max_abs_err": mm_err,
         "mesh_43_launches_per_rank": mesh_launches("matmul"),
         "mesh_44_launches_per_rank": {
             run: mesh44_launches("matmul", run)
             for run in ("jamba", "rwkv", "dsv3")},
         "mesh_44_local_shape_err": mesh44["lanes"]["matmul"],
         "new_archs_launches": {
             "deepseekv3_0_3b": dsv3["training"]["matmul"],
             "qwen2_vl_2b": vl["training"]["matmul"],
             "whisper_base": wh["training"]["matmul"]},
         **t_mm},
        {"name": "wkv", "route": "cuda",
         "source": "src/repro_torch/kernels/rwkv6/csrc/wkv.cu",
         "replaces": "src/repro/kernels/rwkv6/kernel.py:71",
         "launches": wkv_launches, "spec_path_launches": rwkv_cont["spec"],
         "continuous_launches": rwkv_cont,
         "training_launches": rwkv_bwd["training"]["launches"]["wkv"],
         "mesh_44_launches_per_rank": {
             "training": mesh44_launches("wkv", "rwkv"),
             "generate": mesh44_launches("wkv", "serve_rwkv"),
             "crash_restore": mesh44_launches("wkv", "crash_rwkv")},
         "mesh_44_local_shape_err": mesh44["lanes"]["wkv"],
         "mesh_44_restore_chunk_err": mesh44["lanes"]["wkv_restore_chunk"],
         "max_abs_err": wkv_err, **t_wkv,
         "registers_spills": [list(r) for r in wkv_regs
                              if not r[0].startswith("wkv_bwd")]},
        {"name": "wkv_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/rwkv6/csrc/wkv_bwd.cu",
         "replaces": "none (no TPU kernel: JAX differentiates the WKV's "
                     "plain forms itself)",
         "launches": rwkv_bwd["training"]["launches"]["wkv_bwd"],
         "mesh_44_launches_per_rank": mesh44_launches("wkv_bwd", "rwkv"),
         "mesh_44_local_shape_ratio": mesh44["lanes"]["wkv_bwd"],
         "max_abs_err": rwkv_bwd["lane"]["max_abs_err"],
         **rwkv_bwd["times"], "cases": rwkv_bwd["lane"]["cases"],
         "worst_of_limit": rwkv_bwd["lane"]["worst"],
         "card_vs_cpu": rwkv_bwd["card_vs_cpu"],
         "training": {k: v for k, v in rwkv_bwd["training"].items()
                      if k != "launches"},
         "registers_spills": [list(r) for r in wkv_regs
                              if r[0].startswith("wkv_bwd")]},
        {"name": "selective_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/mamba_scan/csrc/"
                   "selective_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan/kernel.py:49",
         "launches": jamba_counts["selective_scan"],
         "spec_path_launches":
             jamba_cont["zero-layer draft"]["selective_scan"],
         "continuous_launches": {run: c["selective_scan"]
                                 for run, c in jamba_cont.items()},
         "training_launches":
             jamba_bwd["training"]["launches"]["selective_scan"],
         "mesh_44_launches_per_rank": {
             "training": mesh44_launches("selective_scan", "jamba"),
             "generate": mesh44_launches("selective_scan", "serve_jamba")},
         "mesh_44_local_shape_err": mesh44["lanes"]["selective_scan"],
         "max_abs_err": scan_err,
         **t_scan, "registers_spills": [list(r) for r in scan_regs
                                        if not r[0].startswith("scan_bwd")]},
        {"name": "selective_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/mamba_scan/csrc/"
                   "selective_scan_bwd.cu",
         "replaces": "none (no TPU kernel: JAX differentiates the scan's "
                     "plain forms itself)",
         "launches": jamba_bwd["training"]["launches"]["selective_scan_bwd"],
         "mesh_44_launches_per_rank": mesh44_launches("selective_scan_bwd",
                                                      "jamba"),
         "mesh_44_local_shape_ratio": mesh44["lanes"]["selective_scan_bwd"],
         "max_abs_err": jamba_bwd["lane"]["max_abs_err"],
         **jamba_bwd["times"], "cases": jamba_bwd["lane"]["cases"],
         "worst_of_limit": jamba_bwd["lane"]["worst"],
         "card_vs_cpu": jamba_bwd["card_vs_cpu"],
         "training": {k: v for k, v in jamba_bwd["training"].items()
                      if k != "launches"},
         "registers_spills": [list(r) for r in scan_regs
                              if r[0].startswith("scan_bwd")]}]}
    _mark("the record")
    print(json.dumps({"recipe": rec}))
    print(json.dumps({"roofline_45": roof}))
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
