#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repo root on a machine with one NVIDIA H100 (and the CUDA
toolkit): ``python3 chip_smoke.py``. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel) and runs
twenty-nine phases, then prints its result lines, exiting non-zero on any
failure:

1. Kernels against their plain PyTorch versions, on the card, at the
   full-width smollm-135m shapes of the serving and training paths, in bf16
   and f32 (cola_fit in f32, the only dtype the fit runs in), the flash
   forward at the prefill shape (16 x 512), at the training shape (32 x 128,
   run 60 times a training step) and at the chunk-round shape through
   ``ops.sdpa_decode`` and ``ops.sdpa_decode_paged`` (16 rows of 128 queries
   at chunk starts inside the prompts, dead rows, a shuffled table); the
   bf16 flash forward and backward (dq; dk/dv) are tensor-core kernels,
   whose registers and spills per head dim the build lines before report
   from ptxas (no spill at the path's d_head 64), as they do for the
   split-KV decode kernel per dtype and head dim (no spill in bf16 at
   d_head 64): max error, and median
   device times (L2 flushed, the host run ahead behind a device sleep) of
   the kernel, the plain version and the library call
   (``F.scaled_dot_product_attention`` for the attention kernels, over the
   gathered dense view for paged decode; its backward for the flash backward
   kernels, also timed as a pair, ``flash_attention_bwd[pair]``, against
   that one backward with the summed bound; the ``torch.matmul`` chain for
   cola_fit; the gather (+ dequantise) + two ``torch.bmm`` chain for
   multi_lora and multi_lora_q8), with each kernel's bound on this card,
   and for cola_fit and the multi-LoRA prefill and chunk rows the time
   PyTorch takes to move the same bytes (``stream``).
   Paged decode also runs with window, softcap and dead rows, and dense
   decode with all 16 slots at position 1023, the engine's horizon
   (``decode_attention[full 1024]``, every split of every slot live);
   multi_lora at the prefill and the decode-tick shape (``[tick 16]``, the
   q and the v tap) and at the tick with every row padding (``[tick 16,
   padding]``: the launch floor of the tick's grid), multi_lora_q8 at the
   decode and chunk shapes; cola_fit at both taps of the fit (q: 576 -> 576,
   ``[attn.v]``: 576 -> 192); the build lines report the registers and
   spills of each cola_fit and multi-LoRA instantiation too (no spill at the
   path's rank 8). A second launch of the flash backward, cola_fit, dense and
   paged decode and both multi-LoRA kernels (bf16 and f32) must give the
   same bits; rows of the multi-LoRA prefill (T 8192) and chunk-round
   (T 2048) calls must equal the same rows in a T 16 call, and int8 the f32
   kernel on the dequantised bank, bit for bit. Then, in bf16 and f32, the
   rows of the other registered configs (``model_cases``): gemma2-9b's
   d_head 256 in the flash forward (2 x 4608 with window 4096 and softcap
   50, and without either; a chunk round of 8 x 128 against a 6144 cache)
   and in decode (8 slots up to 6143, window 4096, softcap 50, dead rows:
   dense, paged, and the ring tick, which must equal the dense tick bit for
   bit), G 1 at d_head 64 (gpt2-small) and G 4 at d_head 128
   (mistral-nemo-12b), G 8 and G 6 at d_head 128 (qwen3-moe-30b-a3b,
   dbrx-132b), and multi_lora / multi_lora_q8 at the q and v taps of
   gemma2-9b, mistral-nemo-12b, mistral-large-123b (d_in 12288),
   qwen3-moe-30b-a3b (2048), dbrx-132b (6144) and mamba2-370m's ssm taps
   (1024 -> 4384, 2048 -> 1024) and its fit (cola_fit f32, L 48, T 4 x
   2048, both taps); qwen3-moe's training
   shape in the flash backward (1 x 2048, 32 / 4 heads) and its fit
   (cola_fit f32, L 48, T 2048: q 2048 -> 4096, v 2048 -> 512);
   gemma2's training shape in the flash backward (dq and dk/dv at 1 x 4608,
   16 / 8 heads, d_head 256, with window 4096 + softcap 50 and with neither;
   the row with neither also against the library's whole backward) and its
   fit (cola_fit f32 at q 3584 -> 4096, the shared-memory kernel with its
   columns split in two, and v 3584 -> 2048; L 21, T 4608, rank 8);
   zamba2-7b's d_head 112 (32 heads, MHA) in the flash forward and both
   backward kernels at its training shape (2 x 2048), the forward at a
   chunk round of 8 x 128 against a 1024 cache, dense and paged decode at
   8 slots of 1024 with dead rows and a shuffled table, multi_lora (tick 8)
   and multi_lora_q8 (T 1024) at 3584 -> 3584 and its fit (cola_fit f32, L
   14 calls, T 2 x 2048, 3584 -> 3584); musicgen-medium's and
   pixtral-12b's training shapes (4 x 2048, 24 heads of 64, MHA; 1 x 2048,
   32 / 8 heads of 128) in the flash forward and both backward kernels,
   their fits (cola_fit f32: 1536 -> 1536, L 48, T 8192; 5120 -> 4096 and
   5120 -> 1024, L 40, T 2048) and multi_lora / multi_lora_q8 at 1536 ->
   1536; in bf16 the rank shares on 16 "model" ranks (2 x 4096) of
   mistral-large-123b (6 query heads and 1 KV head of 128), zamba2-7b (2 /
   2 of 112) and dbrx-132b (3 / 1 of 128) in the flash forward and both
   backward kernels; each launched twice to the same bits. Then the dense
   decode kernel with its log-sum-exp (``return_lse``: o in f32, lse (B,
   H)), in bf16 and f32: timed rows at the decode_32k rank shares (8 slots
   x 2,048 positions) of mistral-large-123b (96 / 8 heads of 128), zamba2-7b
   (32 / 32 of 112) and dbrx-132b (48 / 8 of 128) and at smollm's
   tick on one 64-position block of 1,024, and the serve step's split and
   merge (``lse_merge_checks``): one cache cut into 16 position blocks,
   a launch a block at positions less its offset, merged by
   ``tensor_parallel.merge``, against one launch over the whole cache, at
   smollm's, mistral-large's (32,768 positions) and gemma2's heads (window
   4096, softcap 50), with slots in the first block, at the last position
   and dead. A softcap row has no library time (no library call takes a
   softcap); the row without one has it. The build lines report the
   registers and spills of every d_head 256 and 112 instantiation (the
   flash backward's at 256, the forward's and bf16 decode's at 112 and
   ``fit_smem_kernel<8>`` must not spill; the backward's at 112 are
   printed).
2. Serving at full width: ``ServeEngine`` on smollm-135m (30 layers, bf16)
   with 4 users' rank-8 ``qv`` adapters, 16 slots, max_len 1024 and 32
   requests (prompts 32-512 tokens, 32 new tokens each), run to completion
   with every kernel's launch count reset just before and read just after.
3. Engine against the plain path: a full-width f32 engine on the card and
   the same engine on the CPU (plain versions) must emit equal greedy tokens.
4. Training at full width: ``ColaSession`` Mode A on smollm-135m (30 layers,
   bf16, remat "full"), merged rank-8 ``qv`` adapters, interval 2, AdamW at
   TrainConfig's lr and weight decay, SyntheticLM batches of 32 x 128: a
   warm-up step, then 6 measured steps (3 fits) with the launch counts reset
   just before and read just after. The payloads and banks go through the
   session's ``OffloadChannel``: 3 fits committed, no rollback, dead letter
   or resend; the host time of the channel's checks a step is printed.
5. Training against the plain path: one f32 full-width ``server_step_a`` +
   ``fit_grads`` on the card and on the CPU (plain versions) must agree, and
   on the card Mode A's fit gradients must equal Mode B's (Prop 1).
6. Serving at scale: phase 2's requests and adapters through
   ``ServeEngine(kv_layout="paged", kv_block=16, prefill_chunk=128,
   bank_store="int8")``, with the launch counts reset just before and read
   just after: paged decode, int8 multi-LoRA and the flash forward (the
   chunk rounds) must run, the dense decode and f32 multi-LoRA kernels must
   not, and the block pool must be whole again at the end.
7. Serving at scale against the plain path, f32 full width, 8 requests: the
   card's paged + chunked + int8 engine against the CPU's (equal greedy
   tokens), and on the card paged == dense and int8 == the f32 engine on the
   explicitly dequantised bank (equal tokens); the largest logit gap of each.
8. The tiered adapter store (``[store]``), phase 2's weights and prompts,
   request i to user (5 i) mod 24, with the launch counts reset just before
   and read just after: (a) 24 users through 8 resident rows
   (``resident_slots=8``) and 16 slots, dense KV and an f32 bank, and
   (b) the same with paged KV, chunks of 128 and an int8 bank, each against
   the all-resident engine with the same options: equal tokens, rows
   evicted, admission waiting on pins, every pin released, the resident
   bank a third of the dense one; (c) clustering at threshold 0.95, shared
   and merged: two near-identical users share one row and their tokens; an
   ``install_adapters`` on one splits it off (copy-on-write), the other's
   tokens stay, the split user's equal a one-user engine on the new bank,
   and a merged member's a one-user engine on the members' mean.
9. The fault-tolerant training runtime (``[runtime]``), smollm-135m at full
   width (30 layers, bf16, remat "full"), with the launch counts reset just
   before and read just after (cola_fit, both flash backward kernels, the
   flash forward, multi_lora and dense decode must run): a K = 4
   ``CollabSession`` (merged Mode A, rank-8 ``qv``, interval 1, AdamW at
   TrainConfig's settings, SyntheticLM 32 x 128 with 4 users, 6 steps,
   ``RetryPolicy(max_attempts=6, timeout_ticks=2)`` without sleeps):
   (a) two fault-free runs give equal banks and losses, bit for bit;
   (b) drop / delay / duplicate on users 1 / 2 / 3 (injector seed 0) are all
   recovered: banks and losses equal (a)'s and the counters equal the JAX
   package's for the same map (12 drops, 4 delays, 8 duplicates injected;
   12 resends, 4 late deliveries, 4 duplicates discarded); (c) with every
   row to user 0 and user 1's returns NaN-poisoned, user 1 is quarantined
   at version 0 (2 rollbacks, 12 rejected fits, 4 refused pushes, 2 dead
   letters), the others reach version 6 and user 0 equals the fault-free
   run bit for bit; ``publish_banks`` into a 16-slot engine on the initial
   banks installs 3, and user 1 serves its initial bank (its tokens equal a
   one-user engine's); (d) ``TrainLoop`` over a Mode A ``ColaSession``:
   2 steps and a resume to 4 equal 4 uninterrupted steps (adapters and
   AdamW state), the straggler hook checkpoints and lifts a quarantine, and
   a fit on the worker thread (``timeout_s``) equals the same-thread fit.
   Prints the collab step, the fit round, the channel's checks and the
   checkpoint's save and restore times.
10. Telemetry (``[telemetry]``), with the launch counts reset just before
   and read just after (all eight kernels must run): (a) phase 2's 32
   requests and (b) phase 6's, each with ``Telemetry(trace=True)``: the
   tokens of the telemetry-off phase, bit for bit, a valid trace, 32
   completed and 32 TTFT samples, no postmortem, (b)'s ``pager.*`` equal to
   the pager's stats and the pool whole; (c) phase 9 (c)'s chaos run with
   the telemetry handed to the injector and the ``CollabSession``: banks and
   losses equal the telemetry-off run's, exactly one quarantine postmortem
   (user 1) whose ring holds the injected fault, the rejected fits, the
   rollback and the quarantine and names ``last_error_seq``, round-tripped
   from disk, none for user 0; (d) a ``TrainLoop`` over Mode A writes
   ``telemetry.jsonl``. No record, span argument or metric holds a tensor.
   Under ``torch.cuda.set_sync_debug_mode("warn")`` one workload makes as
   many synchronising calls with telemetry as without. Prints each path's
   span table (host wall time), the decode-tick and prefill p50 with
   telemetry off and on in turns (three runs each, a reading), and checks
   that a ``torch.profiler`` run sees the ``serve.decode`` and
   ``offload.fit`` annotations of ``Telemetry(profiler_annotations=True)``.
11. gemma2-9b's pairs plan at full width and depth (``[gemma2]``): 42
   layers, bf16, seeded random weights, 4 users' rank-8 qv adapters, 8
   slots, max_len 6144, 12 requests of 256-4800 tokens (two past the 4096
   window), 16 new tokens each, with the launch counts reset just before
   and read just after each run: (a) dense KV and an f32 bank (the flash
   forward, dense decode and multi_lora must run), (b) paged KV in blocks
   of 16, chunks of 128, rings for the local stack and an int8 bank (the
   flash forward, paged decode in its pool and ring modes and
   multi_lora_q8 must run, dense decode must not); every request completes
   and the pool is whole at the end.
12. gemma2-9b against the plain path (``[gemma2-vs-plain]``), f32 at full
   width with the depth cut to 2 layers (1 pair), three requests of 200 /
   1500 / 4400 tokens, 8 new tokens: the card's dense engine and its paged
   + chunked + ring + int8 engine each against the CPU's same engine, and
   paged + ring against dense on the card: equal greedy tokens.
13. gemma2-9b's ColA training (``[gemma2-train]``): (a) full width and depth
   (42 layers, bf16, remat "full", seeded random weights), ``ColaSession``
   Mode A merged rank-8 ``qv`` on both stacks, interval 1, AdamW at
   TrainConfig's settings, SyntheticLM 1 x 4608 (past the 4096 window), a
   warm-up step and 4 measured steps with a fit each, the offloader on the
   card through the channel, the launch counts reset just before and read
   just after: 84 flash forwards (42 and their recomputes), 42 dq, 42 dk/dv
   a step and 4 cola_fit launches a fit (a tap of each stack); every loss
   finite, every tap's x and grad_h finite and grad_h non-zero, the bank
   moved at every fit, every fit committed; prints the server step p50, the
   fit ms, training tokens/s, the channel's checks and the peak memory.
   (b) f32 at full width, depth cut to 2 layers (1 pair), 1 x 4608: one
   step of the merged session (server step, fit, AdamW) on the card and on
   the CPU, losses within 1e-5, each tap's grad_h and fit gradients within
   1e-3 of the largest entry (as phase 5), the bank after AdamW within 1e-3
   of its largest entry wherever both devices see the gradient's sign (2 lr
   elsewhere); on the card the unmerged server step's loss and fit
   gradients against the CPU's, and its fit gradients equal to Mode B's
   (Prop 1).
14. The other registered configs (``[configs]``), 8 requests of 32-512
   tokens, 16 new tokens, 8 slots: gpt2-small at full size in f32, its card
   tokens equal to the CPU's; mistral-nemo-12b at full width and depth in
   bf16; mistral-large-123b at full width, depth cut to 2 layers, bf16.
15. The MoE blocks and QK-norm (``[moe]``), with the launch counts reset
   just before and read just after each run: (a) qwen3-moe-30b-a3b at full
   width and depth (48 layers, 128 experts top 8, QK-norm, bf16, seeded
   random weights, init drawn a layer of experts at a time, its peak memory
   printed), phase 14's load (4 users' rank-8 qv adapters, 8 slots,
   max_len 1024, 8 requests of 32-512 tokens, 16 new) with dense KV and an
   f32 bank, then paged KV, chunks of 128 and an int8 bank (the flash
   forward, the layout's decode kernel and the bank's multi-LoRA kernel
   must run, the others not); (b) ColA training on it: a warm-up step and
   2 measured steps, Mode A merged rank-8 qv, interval 1, AdamW, remat
   "full", SyntheticLM 1 x 2048, launches exactly 96 flash forwards, 48 dq
   and 48 dk/dv a step and 2 cola_fit a fit, losses (the aux included)
   finite, grad_h non-zero, the bank moved; (c) dbrx-132b at full width
   with the depth cut to 4 layers, served as in phase 14.
16. The MoE path against the plain path (``[moe-vs-plain]``): qwen3-moe in
   f32 at full width cut to 2 layers, capacity factor 1.25, the dense and
   the paged + chunked + int8 engines on the card and on the CPU (prefill
   and chunk calls route in 512-token groups): equal greedy tokens, and
   how many routing decisions differ between the devices with the smallest
   CPU top-k margin among them; one merged session step at 1 x 1024, card
   against CPU: losses within 1e-5, grad_h and the fit gradients within
   1e-3 of their largest entry.
17. The SSM plan (``[ssm]``), with the launch counts reset just before and
   read just after each run: mamba2-370m at full width and depth (48
   layers, d_model 1024, 32 SSD heads of 64, state 128, bf16, seeded
   random weights; dt_bias, A_log and D f32), (a) phase 14's load with 4
   users' rank-8 qv adapters (the taps fall back to the ssm in and out
   projections, 1024 -> 4384 and 2048 -> 1024) with dense state and an f32
   bank, then the paged layout, chunks of 128 and an int8 bank (multi_lora,
   then multi_lora_q8, must run; no attention kernel may); (b) ColA
   training: a warm-up step and 2 measured steps, Mode A merged rank-8 qv,
   interval 1, AdamW, remat "full", SyntheticLM 4 x 2048: exactly 2
   cola_fit launches a fit and no attention kernel, losses finite, grad_h
   non-zero at both taps, the bank moved.
18. The SSM plan against the plain path (``[ssm-vs-plain]``): mamba2-370m
   in f32 at full width cut to 2 layers, the dense and the paged + chunked
   + int8 engines on the card and on the CPU, prompts whose last chunk is
   narrower than 128, 4 slots (two reused): equal greedy tokens, the
   largest next-token logit gap printed; one merged session step at 2 x
   1024, card against CPU: losses within 1e-5, grad_h and the fit
   gradients within 1e-3 of their largest entry.
19. The hybrid plan (``[hybrid]``), with the launch counts reset just
   before and read just after each run: zamba2-7b at full width and depth
   (81 Mamba2 layers, d_model 3584, 112 SSD heads of 64, state 64, and one
   shared attention block of 32 heads of 112 at the head of each of the 14
   segments; bf16, seeded random weights, its parameters and GiB printed),
   (a) phase 14's load with 4 users' rank-8 qv adapters at the shared q and
   v taps (one adapter at every call), dense KV and state and an f32 bank,
   then paged KV, chunks of 128 and an int8 bank: every prefill and chunk
   call launches the flash forward 14 times, every tick the layout's decode
   kernel 14 times, and each call the bank's multi-LoRA kernel 28 times;
   every request finishes and the pool is whole; (b) ColA training: a
   warm-up step and 2 measured steps, Mode A merged rank-8 qv, interval 1,
   AdamW, remat "full", SyntheticLM 2 x 2048: exactly 28 flash forwards, 14
   dq and 14 dk/dv a step and 2 cola_fit a fit, losses finite, grad_h
   non-zero at every call of both taps, the bank moved, the peak printed.
20. The hybrid plan against the plain path (``[hybrid-vs-plain]``):
   zamba2-7b in f32 at full width cut to 7 layers (the shared block every
   6 kept: segments of 6 and 1), the dense and the paged + chunked + int8
   engines on the card and on the CPU, prompts whose last chunk is
   narrower than 128, 4 slots (two reused): equal greedy tokens, the
   largest next-token logit gap printed; one merged session step at 1 x
   1024, card against CPU: losses within 1e-5, grad_h and the fit gradients
   of both shared taps within 1e-3 of their largest entry.
21. musicgen-medium at full width and depth (``[musicgen]``: 48 layers,
   d_model 1536, 24 heads of 64, MHA, 4 codebooks of 2048 summed at the
   input, an untied head of 4 x 2048 columns; bf16, seeded random weights,
   its parameters and GiB printed), with the launch counts reset just
   before and read just after each run: (a) 8 rows on 4 users' rank-8 qv
   adapters, prompts of 32-512 positions x 4 codebooks, through the
   model's entry points (the engine serves (P,) token prompts only): one
   batched ``prefill`` with ``lengths`` into a dense cache and an f32 bank,
   then paged K/V, prefill chunks of 128 through ``decode_step`` and an
   int8 bank, each followed by 16 greedy ticks (``decode_step`` and an
   argmax over the last axis, each tick's (8, 1, 4) argmax fed back):
   every prefill or chunk call launches the flash forward 48 times, every
   tick the layout's decode kernel 48 times, each call the bank's
   multi-LoRA kernel 96 times, nothing else; every row gets 16 tokens of 4
   codebooks; the pool is whole at the end; tick p50, prefill and chunk
   times and the peak printed; (b) ColA training: a warm-up step and 2
   measured steps, Mode A merged rank-8 qv, interval 1, AdamW, remat
   "full", SyntheticLM 4 x 2048 of 4 codebooks: exactly 96 flash forwards,
   48 dq and 48 dk/dv a step and 2 cola_fit a fit, losses finite, grad_h
   non-zero, the bank moved.
22. pixtral-12b at full width and depth (``[pixtral]``: 40 layers, d_model
   5120, 32 / 8 heads of 128, vocab 131072, embeddings in and an
   ``unembed`` head; bf16, seeded), as phase 21 with the stubbed
   frontend's seeded embeddings as prompts and as each tick's input (the
   argmax tokens recorded): 40 flash forwards a prefill or chunk call, 40
   decode launches a tick, 80 multi-LoRA a call; (b) at 1 x 2048 of
   SyntheticLM's embeddings: 80 / 40 / 40 attention launches a step.
23. Both against the plain path (``[modality-vs-plain]``): each in f32 at
   full width cut to 2 layers, dense + f32 and paged + chunks of 128 +
   int8, 4 rows of 300 / 77 / 190 / 45 positions, 8 ticks, on the card and
   on the CPU: equal greedy tokens (all 4 codebooks for musicgen), the
   largest next-token logit gap printed; one merged session step at 1 x
   1024: losses within 1e-5, grad_h and the fit gradients within 1e-3 of
   their largest entry.
24. The distribution layer (``[distributed]``): a world-size-1 process group
   (``init_process_group("cpu:gloo,cuda:nccl")``, one NCCL all_reduce on
   the card checked), ``single_device_mesh()`` on the card, and
   mistral-nemo-12b at full width and depth (40 layers, bf16, seeded,
   remat "full") placed by ``sharding.distribute`` (no leaf copied), its
   own ``microbatches=8``, 8 x 1024 of seeded tokens with unevenly masked
   labels, rank-8 qv adapters (B drawn, so every gradient is non-zero):
   (a) ``make_train_step`` in Mode A, a warm-up step and 2 measured steps,
   each step's 8 pushes through an ``Offloader`` (interval 8, AdamW) and
   its fit (2 cola_fit launches a fit), its warm-up step's products (mm,
   bmm, addmm) counted; (a, dots) the same at remat "dots" (a fresh
   ``Offloader``, no direct calls): its warm-up step's loss and every
   tap's (x, grad_h) equal (a)'s bit for bit, a step's flash launches
   (a)'s (640 / 320 / 320: the forward is recomputed under both), the
   products it ran (a)'s less those it kept (``remat.saved_product_meter``)
   in number and FLOPs, step p50 and peak against (a)'s; (b) Mode B the
   same as (a), without an optimizer; a step's attention launches exactly 8 times one direct
   ``gl.server_step_a`` / ``train_step_b`` on one microbatch, and its loss
   and data or gradients equal the direct calls on microbatches of 1 x 1024
   bit for bit; (c) ``make_prefill_step`` at 8 x 512 (40 flash forwards),
   the cache written into an 8 x 1024 decode cache, then 16 ticks of
   ``make_serve_step`` (40 decode launches a tick), tokens and prefill
   logits equal to direct ``model.prefill`` / ``decode_step``; step p50,
   tokens/s and peak memory printed; the group destroyed at the end.
25. The distribution layer against the plain path
   (``[distributed-vs-plain]``): nemo in f32 at full width cut to 2 layers
   (remat "none"), 8 x 256 with ``microbatches=8``, the card's Mode A and
   Mode B steps against the CPU's (a gloo mesh on the host in the same
   group): losses within 1e-5, data and gradients within 1e-3 of their
   largest entry; a prefill at 8 x 256 and 8 ticks: equal tokens.
26. The step builders' share of the card's peak (``[roofline]``): the
   dry-run's count (``repro_torch.launch.dryrun``) of phase 24's four steps
   (Mode A and Mode B at 8 x 1024 with M 8, the prefill step at 8 x 512, a
   serve-step tick at 8 slots of 1024; nemo whole, bf16, remat "full") as
   rank 0 of a one-rank fake group on the host's plain path, against phase
   24's measured ms: counted FLOPs beside ``model_flops``, achieved FLOP/s,
   the shares of the bf16 peak and of the bytes bound (the step's inputs
   read once and outputs written once) and which bounds the step, the
   plain path's unfused bytes beside them, and the card's name and power
   limit; a share past 1.05 fails. No kernel launches.
27. Tensor parallelism over "model" (``[tensor-parallel]``), in a process it
   shares with phases 28 and 29, run first (``chip_smoke.py
   --tensor-parallel OUT --ssm-parallel OUT --expert-parallel OUT``): rank
   0 of a fake
   process group of 256 ranks (``init_process_group("fake")``: its
   collectives return at once and move no data) on a 16 x 16 mesh of the
   card, mistral-large-123b at full width and depth (88 layers, bf16, remat
   "full", its ``microbatches=8``), every leaf the rank's block under the
   rules drawn on the card from a seed (the 227.6 GiB tree never exists):
   train_4k's rank share in Mode B (rank-16 qv adapters, 8 microbatches of
   2 x 4096), a warm-up step and a timed one, then prefill_32k's (2 x
   32768), then decode_32k's through the serve step (8 slots, the rank's
   2,048-position block of a 32,768-position cache, about 5.9 GB, drawn on
   the card at ``cache_shardings``' placement; a tick under the collective
   recorder, a warm-up, 5 timed ticks); each step's ms (the collectives'
   time left out; the ticks' p50), peak memory, flash launches (exactly
   1,408 / 704 / 704 a train step, 88 a prefill) and the head counts they
   ran at (6 query heads, 1 KV head of 128, every launch), and every tick's
   88 dense decode launches at 96 query / 8 KV heads of 128 over 2,048
   positions and no other kernel, no collective moving a KV leaf, every
   cache block updated in place, a peak below 20 GiB. The train and
   prefill steps hold the residual stream split by sequence over the 16
   "model" ranks: every layer input (what remat saves; its bytes printed,
   counted as each is passed) must be the rank's (2, S / 16, 12288) rows,
   and each step's peak within 10 % of the dry-run's count
   (``TP_DRYRUN_PEAK``, from the record ``TP_DRYRUN_RECORD`` names). The
   values are not checked: the fake group moves no data.
28. The Mamba2 heads over "model" (``[ssm-parallel]``), in phase 27's
   process after it, on its fake group of 256 and its 16 x 16 mesh: zamba2-7b at full width and depth (81
   Mamba2 layers at d_model 3,584, a shared block every 6: 14 calls; bf16,
   remat "full", ``microbatches=8``), every leaf the rank's block drawn on
   the card: train_4k's rank share in Mode B cut to 1 of its 8
   microbatches (2 x 4096: all 8 take about three minutes a step), one
   step with no warm-up step,
   prefill_32k's (2 x 32768) and decode_32k's tick (8 slots, 2,048 of
   32,768 positions; a warm-up, 5 timed ticks), as phase 27 runs them. Each
   Mamba2 mixer scans the rank's 7 of the 112 SSD heads (every
   ``ops.ssd`` / ``ssd_decode_step`` call recorded), the shared block's
   flash launches run 2 query / 2 KV heads of 112 (exactly 28 / 14 / 14
   a microbatch, 14 a prefill), a tick's 14 dense decode launches (the
   log-sum-exp entry) run 32 / 32 heads over 2,048 positions; the serve
   step's SSM state stays the rank's (8, 7, 64, 64) block a layer and its
   conv state the rank's 456-channel block, both updated in place, no
   collective labelled with the state, the conv state gathered a layer at
   a time (its bytes printed); layer inputs the rank's (2, S / 16, 3584)
   rows; each peak within 10 % of the dry-run's (``SSM_DRYRUN_PEAK``, from
   the records ``SSM_DRYRUN_RECORD`` names; train_4k's of all 8
   microbatches, whose peak is one microbatch's).
29. Expert parallelism (``[expert-parallel]``), in phase 28's process after
   it, on its fake group and mesh: dbrx-132b at full width and depth (40
   layers, d_model 6,144, 48 / 8 heads of 128, 16 experts of 10,752, top
   4, the einsum dispatch in groups of 512; bf16, remat "full",
   ``microbatches=8``), every leaf the rank's block drawn on the card (its
   1 expert of 16 a layer): train_4k's rank share in Mode B at all 8
   microbatches of 2 x 4096 (one step, no warm-up step), prefill_32k's (2
   x 32768) and decode_32k's tick (8 slots, 2,048 of 32,768 positions; a
   warm-up, 5 timed ticks). Every expert MLP call (forward and recompute)
   runs the rank's 1 of 16 experts (``_ExpertRecorder``), every expert
   leaf is gathered as its 1-expert block (d_model over "data"; the bytes
   printed against the 16 experts'), the flash launches run 3 query / 1
   KV head of 128 (exactly 640 / 320 / 320 a train step, 40 a prefill; a
   KV head shared by 2 ranks), a tick's 40 dense decode launches (the
   log-sum-exp entry) 48 / 8 heads over 2,048 positions, no KV leaf moved,
   every block in place; layer inputs the rank's (2, S / 16, 6144) rows;
   each peak within 10 % of the dry-run's (``EP_DRYRUN_PEAK``, from the
   records ``EP_DRYRUN_RECORD`` names). The values are not checked: the
   fake group moves no data, so the gathered tokens are not the model's
   (the accounting stays in range on any routing).
30. The last lines: the card's name and power limit, one JSON line with every
   kernel's numbers, and ``{"ok": true, "device": {...}}`` last.

The CPU halves of phases 12, 13 (b), 16, 18, 20 and 23 (the plain path on
the host, in f32) and phase 26's count run in a worker process that the
script starts after the build (``chip_smoke.py --cpu-halves DIR THREADS``,
no card in its environment, all but two of the host's cores): it computes
them from the same seeds as the card's halves, in the order the phases
need them, while the card's phases run, and saves each to
``build/chip_smoke_cpu/``; each phase waits for its half (``[cpu-halves]
<job>: waited N s``) and compares as before. The worker dies with the
script. Phase 25's CPU half stays in the script: it shares the card's
process group. Phase 26's count starts its own fake group in the worker,
which has none; it is the worker's last job and runs beside phase 25,
which runs before phase 24, and it is awaited before phase 24, so no
worker job runs while phase 24 times the steps it counts.

Without a card (``torch.cuda.is_available()`` false) it exits non-zero and
prints no result.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
SEED = 0

# Tolerance of a kernel against its plain version: max |kernel - plain| <=
# TOL[dtype] * (1 + max |plain|). bf16: two roundings of a bf16 output
# (2^-8 each) where the kernel keeps f32 that the plain version rounds;
# f32: the same sums in another order.
TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of single calls, L2 flushed before each (the
    serving path finds every layer's operands cold). A device-side sleep
    after the flush lets the host enqueue the call before the start event
    runs, so the time is the device's alone: without it, a wrapper's host
    work (checks, allocation, the ctypes call) longer than the flush reads
    as device time."""

    SLEEP_CYCLES = 2_000_000   # ~1 ms at the H100's clocks

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def once_ms(self, fn) -> float:
        self.flush.zero_()
        torch.cuda._sleep(self.SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    def median_ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        return statistics.median(self.once_ms(fn) for _ in range(iters))

    def median_diff_ms(self, fn, part, iters: int = 20, warmup: int = 3) -> float:
        """Median over iterations of fn's time less part's, the two timed in
        turns in each iteration: two separate medians drift apart by more
        than the difference itself now and then."""
        for _ in range(warmup):
            fn()
            part()
        return statistics.median(self.once_ms(fn) - self.once_ms(part)
                                 for _ in range(iters))


def ptxas_report(name: str, kernel: str) -> list[str]:
    """Registers and spills of each instantiation of ``kernel`` by its
    template arguments (``<64>``, ``<bf16,64>``, ``<8,3>``), from the
    ``-Xptxas -v`` log of ``csrc/<name>.cu``."""
    from repro_torch.kernels import _build

    out, tag, spills = [], None, ""
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"{kernel}I((?:f|13__nv_bfloat16|Li\d+E|Lb[01]E)+)E",
                          line)
            # a bool template argument names the decode kernel's ring mode
            tag = m and ",".join(
                n or ("ring" if ring == "1" else "bf16" if bf else "f32")
                for n, ring, bf in re.findall(
                    r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16)|f", m.group(1))
                if ring != "0")
        elif tag and "spill stores" in line:
            spills = line.strip()
        elif tag and (m := re.search(r"Used (\d+) registers", line)):
            out.append(f"{kernel}<{tag}>: {m.group(1)} registers; {spills}")
            tag = None
    return out


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least ms the card could take: bytes over HBM's rate or
    operations over the dtype's peak (the H100 SXM data sheet's, dense, at
    the 700 W limit: ``repro_torch.analysis.roofline``), the larger."""
    from repro_torch.analysis import roofline as rl

    peak = {torch.bfloat16: rl.PEAK_FLOPS, torch.float32: rl.PEAK_FLOPS_F32}
    t_bytes = nbytes / rl.HBM_BW * 1e3
    t_ops = flops / peak[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_cases(cfg, dtype, dev, gen):
    """Inputs of each kernel at the shapes the serving (phase 2) and training
    (phase 4) paths give it. Yields dicts: name, fn (the kernel), plain, lib
    (one library call, or a pair (call, part) whose time difference is the
    library time, or None), nbytes and flops (for the bound), with_lse for
    a flash forward that returns (o, lse), and for a kernel bound by the
    bytes it streams, stream (PyTorch moving the same bytes once: the rate
    the card reaches, printed beside the bound)."""
    import torch.nn.functional as F

    from repro_torch.kernels import cola_fit as cf
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import multi_lora as ml
    from repro_torch.kernels import ops, ref

    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    # prefill: 16 prompts padded to the 512 bucket
    J, P = 16, 512
    q, k, v = rnd(J, P, H, D), rnd(J, P, K, D), rnd(J, P, K, D)
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = int((pos[0][None, :] <= pos[0][:, None]).sum())
    yield dict(
        name="flash_attention", with_lse=True,
        fn=lambda: fa.flash_attention(q, k, v, q_positions=pos, kv_positions=pos),
        plain=lambda: fa.plain(q, k, v, q_positions=pos, kv_positions=pos),
        lib=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True),
        nbytes=nbytes(q, k, v, q) + J * H * P * 4 + 2 * P * 4,
        flops=4 * D * pairs * J * H)

    # training: the flash backward at TrainConfig's batch 32 x seq 128
    Bt, S = 32, 128
    q, k, v, do = rnd(Bt, S, H, D), rnd(Bt, S, K, D), rnd(Bt, S, K, D), \
        rnd(Bt, S, H, D)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    o, lse = fa.flash_attention(q, k, v, q_positions=pos, kv_positions=pos)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    kw = dict(q_positions=pos, kv_positions=pos)
    pairs = int((pos[0][None, :] <= pos[0][:, None]).sum()) * Bt * H
    stats = 2 * nbytes(lse) + 2 * S * 4    # lse, delta, positions
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), (qt, kt, vt), dot)

    # the forward at the training shape: 60 launches a step with remat "full"
    yield dict(
        name="flash_attention[train 32 x 128]", with_lse=True,
        fn=lambda: fa.flash_attention(q, k, v, **kw),
        plain=lambda: fa.plain(q, k, v, **kw),
        lib=sdpa_fwd,
        nbytes=nbytes(q, k, v, q) + nbytes(lse) + 2 * S * 4,
        flops=4 * D * pairs)

    yield dict(
        name="flash_attention_bwd_dq",
        fn=lambda: fa.bwd_dq(q, k, v, do, lse, delta, **kw),
        plain=lambda: fa.plain_bwd(q, k, v, o, lse, do, **kw)[0],
        lib=(sdpa_fwd_bwd, sdpa_fwd),
        nbytes=nbytes(q, k, v, do, q) + stats, flops=6 * D * pairs)
    yield dict(
        name="flash_attention_bwd_dkv",
        fn=lambda: fa.bwd_dkv(q, k, v, do, lse, delta, **kw),
        plain=lambda: fa.plain_bwd(q, k, v, o, lse, do, **kw)[1:],
        lib=(sdpa_fwd_bwd, sdpa_fwd),
        nbytes=nbytes(q, k, v, do, k, v) + stats, flops=8 * D * pairs)
    # the pair in one window against the library's whole backward, with the
    # summed bound: the like-for-like comparison
    yield dict(
        name="flash_attention_bwd[pair]",
        fn=lambda: (fa.bwd_dq(q, k, v, do, lse, delta, **kw),
                    *fa.bwd_dkv(q, k, v, do, lse, delta, **kw)),
        plain=lambda: fa.plain_bwd(q, k, v, o, lse, do, **kw),
        lib=(sdpa_fwd_bwd, sdpa_fwd),
        nbytes=nbytes(q, k, v, do, q) + nbytes(q, k, v, do, k, v) + 2 * stats,
        flops=14 * D * pairs)

    # the fit (f32 only): 30 layers, T = interval 2 x 32 x 128 rows, rank 8
    if dtype == torch.float32:
        Lf, T, r, d = cfg.n_layers, 2 * Bt * S, 8, cfg.d_model
        for tap, d_out in (("", H * D), ("[attn.v]", K * D)):
            x, g = rnd(Lf, T, d), rnd(Lf, T, d_out)
            A, Bm = rnd(Lf, d, r) / r ** 0.5, rnd(Lf, r, d_out) * 0.05
            yield dict(
                name="cola_fit" + tap,
                fn=lambda x=x, g=g, A=A, Bm=Bm: cf.cola_fit_lowrank(x, g, A, Bm),
                plain=lambda x=x, g=g, A=A, Bm=Bm: cf.plain(x, g, A, Bm),
                lib=lambda x=x, g=g, A=A, Bm=Bm: (
                    torch.matmul((x @ A).transpose(1, 2), g),
                    torch.matmul(x.transpose(1, 2), g @ Bm.transpose(1, 2))),
                # the rate the card streams x and g at: one reduction each
                stream=lambda x=x, g=g: (x.sum(), g.sum()),
                nbytes=nbytes(x, g, A, Bm, A, Bm),
                flops=4 * r * (d + d_out) * T * Lf)

    # decode tick: 16 slots against a 1024-position cache
    B, Smax = 16, 1024
    qd = rnd(B, 1, H, D)
    kc, vc = rnd(B, Smax, K, D), rnd(B, Smax, K, D)
    posd = torch.randint(32, 545, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    mask = (torch.arange(Smax, device=dev)[None, :] <= posd[:, None])[:, None, None]
    qdt, kct, vct = (t.transpose(1, 2).contiguous() for t in (qd, kc, vc))
    # the tick, and every slot at the horizon (position 1023: all splits live)
    full = torch.full((B,), Smax - 1, dtype=torch.int32, device=dev)
    for tag, p in (("", posd), ("[full 1024]", full)):
        n_kv = int((p.clamp(max=Smax - 1) + 1).sum())
        pmask = (torch.arange(Smax, device=dev)[None, :] <= p[:, None])[:, None, None]
        yield dict(
            name="decode_attention" + tag,
            fn=lambda p=p: da.decode_attention(qd, kc, vc, p, live=live),
            plain=lambda p=p: da.plain(qd, kc, vc, p, live=live),
            lib=lambda pmask=pmask: F.scaled_dot_product_attention(
                qdt, kct, vct, attn_mask=pmask, enable_gqa=True),
            nbytes=2 * nbytes(qd) + 2 * n_kv * K * D * qd.element_size() + B * 5,
            flops=4 * D * H * n_kv)
    n_kv = int((posd.clamp(max=Smax - 1) + 1).sum())

    # the same decode tick on the paged layout: a pool of 16 x 64 blocks of
    # 16 positions, each row's blocks drawn from a shuffled pool
    bs = 16
    nb = Smax // bs
    perm = torch.randperm(B * nb, generator=torch.Generator().manual_seed(SEED))
    table = torch.zeros(B, nb, dtype=torch.int32)
    kp, vp = rnd(B * nb, bs, K, D), rnd(B * nb, bs, K, D)
    it = iter(perm.tolist())
    for b, p in enumerate(posd.tolist()):
        for j in range(p // bs + 1):
            table[b, j] = next(it)
    table = table.to(dev)
    kg, vg = (t[table.long()].flatten(1, 2).transpose(1, 2).contiguous()
              for t in (kp, vp))
    n_tab = int((posd // bs + 1).sum())
    for tag, kw in (("", {}), ("[window 256, softcap 30, dead rows]",
                               dict(window=256, softcap=30.0,
                                    live=torch.arange(B, device=dev) % 4 != 3))):
        wmask = mask if not kw else mask & (
            torch.arange(Smax, device=dev)[None, :]
            > posd[:, None] - 256)[:, None, None]
        n_read = n_kv if not kw else int(
            (kw["live"] * (posd.clamp(max=255) + 1)).sum())
        yield dict(
            name="decode_attention_paged" + tag,
            fn=lambda kw=kw: da.decode_attention_paged(qd, kp, vp, posd, table,
                                                       **kw),
            plain=lambda kw=kw: da.plain_paged(qd, kp, vp, posd, table, **kw),
            lib=lambda wmask=wmask: F.scaled_dot_product_attention(
                qdt, kg, vg, attn_mask=wmask, enable_gqa=True),
            nbytes=(2 * nbytes(qd) + 2 * n_read * K * D * qd.element_size()
                    + n_tab * 4 + B * 5),
            flops=4 * D * H * n_read)

    # a chunk round as the engine's ops calls run it (the flash forward
    # kernel; for paged, after a gather of the rows' blocks): 16 rows of 128
    # queries at chunk starts inside the prompts, a quarter of the rows dead,
    # against the dense cache and against the pool through a shuffled table
    C = 128
    qc = rnd(B, C, H, D)
    posc = C * torch.randint(0, 4, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
    livec = torch.arange(B, device=dev) % 4 != 3
    tablec = torch.zeros(B, nb, dtype=torch.int32)
    it = iter(perm.tolist())
    for b, p in enumerate(posc.tolist()):
        for j in range((p + C - 1) // bs + 1):
            tablec[b, j] = next(it)
    tablec = tablec.to(dev)
    qpos = posc[:, None] + torch.arange(C, device=dev)[None]
    cmask = (torch.arange(Smax, device=dev)[None, None, :]
             <= qpos[:, :, None])[:, None]
    qct = qc.transpose(1, 2).contiguous()
    kgc, vgc = (t[tablec.long()].flatten(1, 2).transpose(1, 2).contiguous()
                for t in (kp, vp))
    n_read = int((livec * (posc + C)).sum())
    pairs = int((livec[:, None] * (qpos + 1)).sum())
    n_tabc = int((livec * ((posc + C - 1) // bs + 1)).sum())
    for tag, fn, plain, kk, vv, tab_bytes in (
            ("[chunk 16 x 128, dense]",
             lambda: ops.sdpa_decode(qc, kc, vc, posc, live=livec),
             lambda: ref.sdpa_decode(qc, kc, vc, posc, live=livec),
             kct, vct, 0),
            ("[chunk 16 x 128, paged]",
             lambda: ops.sdpa_decode_paged(qc, kp, vp, posc, tablec,
                                           live=livec),
             lambda: ref.sdpa_decode_paged(qc, kp, vp, posc, tablec,
                                           live=livec),
             kgc, vgc, n_tabc * 4)):
        yield dict(
            name="flash_attention" + tag, fn=fn, plain=plain,
            lib=lambda kk=kk, vv=vv: F.scaled_dot_product_attention(
                qct, kk, vv, attn_mask=cmask, enable_gqa=True),
            nbytes=(2 * nbytes(qc) + 2 * n_read * K * D * qc.element_size()
                    + tab_bytes + B * 5),
            flops=4 * D * H * pairs)

    # adapted taps, 4 users, rank 8: q at prefill (8192 token rows), and at a
    # decode tick (16 slots, one row each), where it runs most often, q and v;
    # the tick with every row padding: the launch floor of the tick's grid
    U, r, d = 4, 8, cfg.d_model
    A = rnd(U, d, r, dt=torch.float32) / r ** 0.5
    Bq = rnd(U, r, H * D, dt=torch.float32) * 0.05
    Bv = rnd(U, r, K * D, dt=torch.float32) * 0.05
    for tag, T, per_user, Bm in (("", J * P, P, Bq), ("[tick 16]", B, 1, Bq),
                                 ("[tick 16, 576 -> 192]", B, 1, Bv),
                                 ("[tick 16, padding]", B, 0, Bq)):
        x = rnd(T, d)
        idx = ((torch.arange(T // per_user, device=dev, dtype=torch.int32)
                % U).repeat_interleave(per_user) if per_user else
               torch.full((T,), -1, dtype=torch.int32, device=dev))
        d_out = Bm.shape[-1]
        yield dict(
            name="multi_lora" + tag,
            fn=lambda x=x, idx=idx, Bm=Bm: ml.multi_lora(x, A, Bm, idx),
            plain=lambda x=x, idx=idx, Bm=Bm: ml.plain(x, A, Bm, idx),
            lib=None if not per_user else lambda x=x, idx=idx, Bm=Bm: torch.bmm(
                torch.bmm(x.float()[:, None], A[idx.long()]), Bm[idx.long()]),
            # at prefill, the rate the card moves x into a y-sized tensor
            **(dict(stream=lambda x=x, out=torch.empty_like(x): out.copy_(x))
               if T > B else {}),
            nbytes=(nbytes(x, idx, A, Bm) if per_user else nbytes(idx))
            + T * d_out * x.element_size(),
            flops=2 * T * (d * r + r * d_out) if per_user else 0)

    # the int8 bank: a decode tick (16 slots) and a chunk round (16 x 128)
    for tag, T, d_out in (("", B, H * D), ("[576 -> 192]", B, K * D),
                          ("[T 2048]", B * 128, H * D)):
        x = rnd(T, d)
        Aq, As = ml.quant_rows(rnd(U, d, r, dt=torch.float32) / r ** 0.5)
        Bq, Bs = ml.quant_rows(rnd(U, r, d_out, dt=torch.float32) * 0.05)
        ix = (torch.arange(B, device=dev, dtype=torch.int32) % U
              ).repeat_interleave(T // B)
        yield dict(
            name="multi_lora_q8" + tag,
            **(dict(stream=lambda x=x, out=torch.empty_like(x): out.copy_(x))
               if T > B else {}),
            fn=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix:
                ml.multi_lora_q8(x, Aq, As, Bq, Bs, ix),
            plain=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix:
                ml.plain_q8(x, Aq, As, Bq, Bs, ix),
            lib=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix: torch.bmm(
                torch.bmm(x.float()[:, None],
                          Aq[ix.long()].float() * As[ix.long()]),
                Bq[ix.long()].float() * Bs[ix.long()]),
            nbytes=nbytes(x, ix, Aq, As, Bq, Bs) + T * d_out * x.element_size(),
            flops=2 * T * (d * r + r * d_out))


LARGE_RANK = "large rank of 16: G 6 d128, 2 x 4096"
ZAMBA2_RANK = "zamba2 rank of 16: G 1 d112, 2 / 2 heads, 2 x 4096"
DBRX_RANK = "dbrx rank of 16: G 3 d128, 3 / 1 heads, 2 x 4096"
SOFTCAP_NOTE = ("no library call takes a softcap: the library time is on "
                "the row without one")


def _causal_pairs(q_pos, k_len: int, window: int | None = None) -> int:
    """(query, key) pairs a causal (windowed) attention sees: keys at
    positions 0..k_len-1, queries at q_pos (a 1-D tensor of positions)."""
    hi = q_pos.clamp(max=k_len - 1) + 1
    lo = (q_pos - window + 1).clamp(min=0) if window else torch.zeros_like(q_pos)
    return int((hi - lo).clamp(min=0).sum())


def _ring_of(kc, vc, pos, w_ring):
    """Each slot's ring of its last ``w_ring`` positions of a dense cache,
    position t at ring row t % w_ring (rows older than that stay zero)."""
    rk = torch.zeros((kc.shape[0], w_ring) + kc.shape[2:], dtype=kc.dtype,
                     device=kc.device)
    rv = torch.zeros_like(rk)
    for b, p in enumerate(pos.tolist()):
        t = torch.arange(max(0, p - w_ring + 1), p + 1, device=kc.device)
        rk[b, t % w_ring], rv[b, t % w_ring] = kc[b, t], vc[b, t]
    return rk, rv


def model_cases(dtype, dev, gen):
    """Phase-1 rows at the other registered configs' shapes, in ``dtype``
    (names carry it): gemma2-9b's d_head 256 (16 q heads, 8 kv heads, G 2;
    local window 4096, attention softcap 50) in the flash forward (2 x 4608
    with and without window and softcap; a chunk round of 8 rows x 128
    queries against a 6144 cache) and in decode (8 slots up to position
    6143, window 4096, softcap 50, dead rows: dense, paged through a
    shuffled table, and the ring tick, which must equal the dense tick bit
    for bit: ``tick`` names the two); G 1 at d_head 64 (gpt2-small), G 4
    (mistral-nemo-12b), G 8 (qwen3-moe-30b-a3b) and G 6 (dbrx-132b) at
    d_head 128 in both; qwen3-moe's training shape in the flash backward (1
    x 2048) and its fit (cola_fit f32, L 48, T 2048: q 2048 -> 4096, v 2048
    -> 512); and multi_lora (f32 bank, a tick of 8 slots) and multi_lora_q8
    (int8 bank, a chunk round of 8 x 128 rows) at the q and v taps of
    gemma2-9b (3584 -> 4096 / 2048), mistral-nemo-12b (5120 -> 4096 / 1024),
    mistral-large-123b (12288 -> 12288 / 1024), qwen3-moe-30b-a3b (2048 ->
    4096 / 512), dbrx-132b (6144 -> 6144 / 1024) and mamba2-370m's ssm taps
    (1024 -> 4384, 2048 -> 1024); mamba2-370m's fit (cola_fit f32, L 48,
    T 4 x 2048, both ssm taps); the training shapes of musicgen-medium (4 x
    2048, 24 heads of 64, MHA) and pixtral-12b (1 x 2048, G 4 at d_head
    128) in the flash forward and both backward kernels, their fits
    (cola_fit f32: musicgen 1536 -> 1536, L 48, T 8192; pixtral q 5120 ->
    4096 and v 5120 -> 1024, L 40, T 2048) and multi_lora / multi_lora_q8 at
    musicgen's 1536 -> 1536; and in bf16 the flash forward and both
    backward kernels at mistral-large-123b's rank share on 16 "model" ranks
    (2 x 4096, 6 query heads, 1 KV head, d_head 128)."""
    import torch.nn.functional as F

    from repro_torch.kernels import cola_fit as cf
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import multi_lora as ml
    from repro_torch.kernels import ops, ref

    dt = "bf16" if dtype == torch.bfloat16 else "f32"

    def rnd(*shape, d=dtype):
        return torch.randn(shape, generator=gen, device=dev).to(d)

    def flash(tag, B, S, H, K, D, window=None, softcap=None):
        q, k, v = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D)
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        kw = dict(q_positions=pos, kv_positions=pos, window=window,
                  softcap=softcap)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = None
        if softcap is None and window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        return dict(
            name=f"flash_attention[{tag} {dt}]", with_lse=True,
            fn=lambda: fa.flash_attention(q, k, v, **kw),
            plain=lambda: fa.plain(q, k, v, **kw), lib=lib,
            **({} if lib or softcap is None else dict(note=SOFTCAP_NOTE)),
            nbytes=nbytes(q, k, v, q) + B * H * S * 4 + 2 * S * 4,
            flops=4 * D * B * H * _causal_pairs(pos[0], S, window))

    def decode(tag, B, Smax, H, K, D, pos, window=None, softcap=None,
               live=None):
        q = rnd(B, 1, H, D)
        kc, vc = rnd(B, Smax, K, D), rnd(B, Smax, K, D)
        kw = dict(live=live, window=window, softcap=softcap)
        qt, kct, vct = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
        ar = torch.arange(Smax, device=dev)[None, :]
        mask = ar <= pos[:, None]
        if window:
            mask = mask & (ar > pos[:, None] - window)
        lib = None
        if softcap is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kct, vct, attn_mask=mask[:, None, None], enable_gqa=True)
        alive = live if live is not None else torch.ones_like(pos, dtype=torch.bool)
        n_read = int(sum(_causal_pairs(p[None], Smax, window)
                         for p, a in zip(pos, alive) if a))
        return (q, kc, vc, kw), dict(
            name=f"decode_attention[{tag} {dt}]",
            fn=lambda: da.decode_attention(q, kc, vc, pos, **kw),
            plain=lambda: da.plain(q, kc, vc, pos, **kw), lib=lib,
            **({} if lib else dict(note=SOFTCAP_NOTE)),
            nbytes=2 * nbytes(q) + 2 * n_read * K * D * q.element_size() + B * 5,
            flops=4 * D * H * n_read)

    def flash_bwd(tag, B, S, H, K, D, window=None, softcap=None):
        """The dq and dk/dv rows of one backward shape; the library's whole
        backward (``scaled_dot_product_attention``'s) on a row with neither
        window nor softcap, as in kernel_cases."""
        q, k, v, do = rnd(B, S, H, D), rnd(B, S, K, D), rnd(B, S, K, D), \
            rnd(B, S, H, D)
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        kw = dict(q_positions=pos, kv_positions=pos, window=window,
                  softcap=softcap)
        o, lse = fa.flash_attention(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        pairs = B * H * _causal_pairs(pos[0], S, window)
        stats = 2 * nbytes(lse) + 2 * S * 4    # lse, delta, positions
        extra = dict(lib=None, note=SOFTCAP_NOTE)
        if softcap is None and window is None:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()

            def sdpa_fwd():
                with torch.no_grad():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)

            def sdpa_fwd_bwd():
                return torch.autograd.grad(F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), (qt, kt, vt),
                    dot)

            extra = dict(lib=(sdpa_fwd_bwd, sdpa_fwd))
        yield dict(extra,
                   name=f"flash_attention_bwd_dq[{tag} {dt}]",
                   fn=lambda: fa.bwd_dq(q, k, v, do, lse, delta, **kw),
                   plain=lambda: fa.plain_bwd(q, k, v, o, lse, do, **kw)[0],
                   nbytes=nbytes(q, k, v, do, q) + stats, flops=6 * D * pairs)
        yield dict(extra,
                   name=f"flash_attention_bwd_dkv[{tag} {dt}]",
                   fn=lambda: fa.bwd_dkv(q, k, v, do, lse, delta, **kw),
                   plain=lambda: fa.plain_bwd(q, k, v, o, lse, do, **kw)[1:],
                   nbytes=nbytes(q, k, v, do, k, v) + stats,
                   flops=8 * D * pairs)

    # gemma2-9b's attention: d_head 256, 16 q heads, 8 kv heads
    H, K, D, W, CAP = 16, 8, 256, 4096, 50.0
    yield flash("gemma2 d256: 2 x 4608, window 4096, softcap 50", 2, 4608, H,
                K, D, window=W, softcap=CAP)
    yield flash("gemma2 d256: 2 x 4608, no window, no softcap", 2, 4608, H, K,
                D)
    # its training shape in the backward ([gemma2-train]: 1 x 4608, 42 dq
    # and 42 dk/dv launches a step), with the local stack's window and
    # softcap and with neither
    yield from flash_bwd("gemma2 d256: 1 x 4608, window 4096, softcap 50", 1,
                         4608, H, K, D, window=W, softcap=CAP)
    yield from flash_bwd("gemma2 d256: 1 x 4608, no window, no softcap", 1,
                         4608, H, K, D)
    # and its fit (f32 only): one stack's 21 layers of each tap, T = 1 x 4608
    # rows, rank 8; q's 3584 + 4096 columns take the shared-memory kernel
    # with its columns split in two, v's 3584 + 2048 one slice
    if dtype == torch.float32:
        L, T, r, d_in = 21, 4608, 8, 3584
        for d_out in (4096, 2048):
            x, g = rnd(L, T, d_in), rnd(L, T, d_out)
            A, Bm = rnd(L, d_in, r) / r ** 0.5, rnd(L, r, d_out) * 0.05
            yield dict(
                name=f"cola_fit[gemma2 {d_in} -> {d_out}: L {L}, T {T} {dt}]",
                fn=lambda x=x, g=g, A=A, Bm=Bm: cf.cola_fit_lowrank(x, g, A, Bm),
                plain=lambda x=x, g=g, A=A, Bm=Bm: cf.plain(x, g, A, Bm),
                lib=lambda x=x, g=g, A=A, Bm=Bm: (
                    torch.matmul((x @ A).transpose(1, 2), g),
                    torch.matmul(x.transpose(1, 2), g @ Bm.transpose(1, 2))),
                stream=lambda x=x, g=g: (x.sum(), g.sum()),
                nbytes=nbytes(x, g, A, Bm, A, Bm),
                flops=4 * r * (d_in + d_out) * T * L)

    # a chunk round of the global stack: 8 rows x 128 queries at chunk
    # starts inside 6144-position prompts against the dense cache, softcap
    # 50, a quarter of the rows dead
    B, Smax, C = 8, 6144, 128
    qc = rnd(B, C, H, D)
    kc, vc = rnd(B, Smax, K, D), rnd(B, Smax, K, D)
    posc = C * torch.randint(0, Smax // C, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
    livec = torch.arange(B, device=dev) % 4 != 3
    qpos = posc[:, None] + torch.arange(C, device=dev)[None]
    pairs = sum(_causal_pairs(qpos[b], Smax) for b in range(B) if livec[b])
    n_read = int((livec * (posc + C)).sum())
    yield dict(
        name=f"flash_attention[gemma2 d256: chunk 8 x 128 against 6144, "
             f"softcap 50 {dt}]",
        fn=lambda: ops.sdpa_decode(qc, kc, vc, posc, live=livec, softcap=CAP),
        plain=lambda: ref.sdpa_decode(qc, kc, vc, posc, live=livec,
                                      softcap=CAP),
        lib=None, note=SOFTCAP_NOTE,
        nbytes=2 * nbytes(qc) + 2 * n_read * K * D * qc.element_size() + B * 5,
        flops=4 * D * H * pairs)
    del qc, kc, vc

    # decode: 8 slots up to position 6143, window 4096, softcap 50, dead rows
    pos = torch.randint(0, Smax, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0], pos[1], pos[2] = Smax - 1, W + 200, 100
    live = torch.arange(B, device=dev) % 4 != 3
    tag = "gemma2 d256: 8 slots to 6143, window 4096, softcap 50, dead rows"
    (q, kc, vc, kw), case = decode(tag, B, Smax, H, K, D, pos, window=W,
                                   softcap=CAP, live=live)
    yield dict(case, tick="dense")
    # the same tick through a shuffled pool of 16-position blocks ...
    bs = 16
    nb = Smax // bs
    perm = torch.randperm(B * nb, generator=torch.Generator().manual_seed(SEED))
    table = perm.reshape(B, nb).to(device=dev, dtype=torch.int32)
    kp = torch.empty((B * nb, bs, K, D), dtype=dtype, device=dev)
    vp = torch.empty_like(kp)
    kp[table.long()] = kc.reshape(B, nb, bs, K, D)
    vp[table.long()] = vc.reshape(B, nb, bs, K, D)
    yield dict(case, name=f"decode_attention_paged[{tag} {dt}]",
               fn=lambda: da.decode_attention_paged(q, kp, vp, pos, table, **kw),
               plain=lambda: da.plain_paged(q, kp, vp, pos, table, **kw),
               nbytes=case["nbytes"] + nbytes(table))
    # ... and through the rings of the last 4096 + 127 positions
    rk, rv = _ring_of(kc, vc, pos, W + 127)
    yield dict(case, tick="ring",
               name=f"decode_attention_paged[ring {tag}, W_ring 4223 {dt}]",
               fn=lambda: da.decode_attention_ring(q, rk, rv, pos,
                                                   horizon=Smax, **kw),
               plain=lambda: da.plain_ring(q, rk, rv, pos, **kw))
    del kc, vc

    # gpt2-small (G 1, d_head 64), mistral-nemo-12b (G 4, d_head 128), and
    # the MoE configs' attention: qwen3-moe-30b-a3b (G 8, d_head 128; its
    # serving path's 8 x 512 prefill) and dbrx-132b (G 6, d_head 128)
    for tag, H, K, D in (("gpt2 G 1 d64", 12, 12, 64),
                         ("nemo G 4 d128", 32, 8, 128),
                         ("qwen3 G 8 d128", 32, 4, 128),
                         ("dbrx G 6 d128", 48, 8, 128)):
        yield flash(f"{tag}: 8 x 512", 8, 512, H, K, D)
        pos = torch.randint(32, 1024, (8,), generator=gen, device=dev,
                            dtype=torch.int32)
        yield decode(f"{tag}: 8 slots of 1024", 8, 1024, H, K, D, pos)[1]

    # qwen3-moe-30b-a3b's training shape ([moe] (b): 1 x 2048, 48 dq and 48
    # dk/dv launches a step) and its fit (f32): 48 layers of each tap, T = 1
    # x 2048 rows, rank 8, q 2048 -> 4096 and v 2048 -> 512
    yield from flash_bwd("qwen3 G 8 d128: 1 x 2048", 1, 2048, 32, 4, 128)
    if dtype == torch.float32:
        L, T, r, d_in = 48, 2048, 8, 2048
        for d_out in (4096, 512):
            x, g = rnd(L, T, d_in), rnd(L, T, d_out)
            A, Bm = rnd(L, d_in, r) / r ** 0.5, rnd(L, r, d_out) * 0.05
            yield dict(
                name=f"cola_fit[qwen3 {d_in} -> {d_out}: L {L}, T {T} {dt}]",
                fn=lambda x=x, g=g, A=A, Bm=Bm: cf.cola_fit_lowrank(x, g, A, Bm),
                plain=lambda x=x, g=g, A=A, Bm=Bm: cf.plain(x, g, A, Bm),
                lib=lambda x=x, g=g, A=A, Bm=Bm: (
                    torch.matmul((x @ A).transpose(1, 2), g),
                    torch.matmul(x.transpose(1, 2), g @ Bm.transpose(1, 2))),
                stream=lambda x=x, g=g: (x.sum(), g.sum()),
                nbytes=nbytes(x, g, A, Bm, A, Bm),
                flops=4 * r * (d_in + d_out) * T * L)

    # zamba2-7b's shared attention block ([hybrid]): d_head 112, 32 heads,
    # MHA. The training shape (2 x 2048: 28 forwards, 14 dq and 14 dk/dv a
    # step) in the forward and both backward kernels
    H, K, D = 32, 32, 112
    yield flash("zamba2 G 1 d112: 2 x 2048", 2, 2048, H, K, D)
    yield from flash_bwd("zamba2 G 1 d112: 2 x 2048", 2, 2048, H, K, D)
    # a chunk round of 8 rows x 128 queries at chunk starts inside
    # 1024-position prompts against the dense cache, a quarter dead
    B, Smax, C = 8, 1024, 128
    qc = rnd(B, C, H, D)
    kc, vc = rnd(B, Smax, K, D), rnd(B, Smax, K, D)
    posc = C * torch.randint(0, Smax // C, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
    livec = torch.arange(B, device=dev) % 4 != 3
    qpos = posc[:, None] + torch.arange(C, device=dev)[None]
    pairs = sum(_causal_pairs(qpos[b], Smax) for b in range(B) if livec[b])
    n_read = int((livec * (posc + C)).sum())
    maskc = torch.arange(Smax, device=dev)[None, None] <= qpos[:, :, None]
    qct, kct, vct = (t.transpose(1, 2).contiguous() for t in (qc, kc, vc))
    yield dict(
        name=f"flash_attention[zamba2 d112: chunk 8 x 128 against 1024 {dt}]",
        fn=lambda: ops.sdpa_decode(qc, kc, vc, posc, live=livec),
        plain=lambda: ref.sdpa_decode(qc, kc, vc, posc, live=livec),
        lib=lambda: F.scaled_dot_product_attention(
            qct, kct, vct, attn_mask=maskc[:, None]),
        nbytes=2 * nbytes(qc) + 2 * n_read * K * D * qc.element_size() + B * 5,
        flops=4 * D * H * pairs)
    # decode: 8 slots of 1024, a quarter dead, dense and through a shuffled
    # pool of 16-position blocks (14 launches a tick)
    pos = torch.randint(32, Smax, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0] = Smax - 1
    live = torch.arange(B, device=dev) % 4 != 3
    tag = "zamba2 G 1 d112: 8 slots of 1024, dead rows"
    (q, kc, vc, kw), case = decode(tag, B, Smax, H, K, D, pos, live=live)
    yield case
    bs = 16
    nb = Smax // bs
    perm = torch.randperm(B * nb, generator=torch.Generator().manual_seed(SEED))
    table = perm.reshape(B, nb).to(device=dev, dtype=torch.int32)
    kp = torch.empty((B * nb, bs, K, D), dtype=dtype, device=dev)
    vp = torch.empty_like(kp)
    kp[table.long()] = kc.reshape(B, nb, bs, K, D)
    vp[table.long()] = vc.reshape(B, nb, bs, K, D)
    yield dict(case, name=f"decode_attention_paged[{tag} {dt}]",
               fn=lambda: da.decode_attention_paged(q, kp, vp, pos, table, **kw),
               plain=lambda: da.plain_paged(q, kp, vp, pos, table, **kw),
               nbytes=case["nbytes"] + nbytes(table))
    del qc, kc, vc, kp, vp
    # its fit (f32): one adapter at each of the 14 calls, the calls
    # expanded to L 14 for the kernel; T = 2 x 2048 rows, rank 8, q and v
    # both 3584 -> 3584
    if dtype == torch.float32:
        L, T, r, d_in, d_out = 14, 4096, 8, 3584, 3584
        x, g = rnd(L, T, d_in), rnd(L, T, d_out)
        A, Bm = rnd(L, d_in, r) / r ** 0.5, rnd(L, r, d_out) * 0.05
        yield dict(
            name=f"cola_fit[zamba2 {d_in} -> {d_out}: L {L}, T {T} {dt}]",
            fn=lambda: cf.cola_fit_lowrank(x, g, A, Bm),
            plain=lambda: cf.plain(x, g, A, Bm),
            lib=lambda: (
                torch.matmul((x @ A).transpose(1, 2), g),
                torch.matmul(x.transpose(1, 2), g @ Bm.transpose(1, 2))),
            stream=lambda: (x.sum(), g.sum()),
            nbytes=nbytes(x, g, A, Bm, A, Bm),
            flops=4 * r * (d_in + d_out) * T * L)

    # the training shapes of musicgen-medium ([musicgen] (b): 4 x 2048, 24
    # heads of 64, MHA; 96 forwards, 48 dq and 48 dk/dv a step) and
    # pixtral-12b ([pixtral] (b): 1 x 2048, 32 / 8 heads of 128; 80 / 40 /
    # 40) in the forward and both backward kernels, and their fits (f32,
    # rank 8): musicgen's q and v both 1536 -> 1536 (one row for the two), L
    # 48, T 4 x 2048; pixtral's q 5120 -> 4096 and v 5120 -> 1024, L 40, T
    # 2048
    for tag, B, H, K, D in (("musicgen G 1 d64: 4 x 2048", 4, 24, 24, 64),
                            ("pixtral G 4 d128: 1 x 2048", 1, 32, 8, 128)):
        yield flash(tag, B, 2048, H, K, D)
        yield from flash_bwd(tag, B, 2048, H, K, D)
    # mistral-large-123b's rank share on 16 "model" ranks ([tensor-parallel]:
    # 2 x 4096 a microbatch, 6 query heads and the 1 KV head they read,
    # d_head 128), in the dtype it runs in
    if dtype == torch.bfloat16:
        yield flash(LARGE_RANK, 2, 4096, 6, 1, 128)
        yield from flash_bwd(LARGE_RANK, 2, 4096, 6, 1, 128)
        # zamba2-7b's ([ssm-parallel]): its shared block's 2 query and 2 KV
        # heads of 112 a rank
        yield flash(ZAMBA2_RANK, 2, 4096, 2, 2, 112)
        yield from flash_bwd(ZAMBA2_RANK, 2, 4096, 2, 2, 112)
        # dbrx-132b's ([expert-parallel]): 3 query heads and the 1 KV head
        # they read (its 8 KV heads shared by 2 ranks each) of 128
        yield flash(DBRX_RANK, 2, 4096, 3, 1, 128)
        yield from flash_bwd(DBRX_RANK, 2, 4096, 3, 1, 128)
    if dtype == torch.float32:
        r = 8
        for model, L, T, d_in, d_out in (("musicgen", 48, 4 * 2048, 1536, 1536),
                                         ("pixtral", 40, 2048, 5120, 4096),
                                         ("pixtral", 40, 2048, 5120, 1024)):
            x, g = rnd(L, T, d_in), rnd(L, T, d_out)
            A, Bm = rnd(L, d_in, r) / r ** 0.5, rnd(L, r, d_out) * 0.05
            yield dict(
                name=f"cola_fit[{model} {d_in} -> {d_out}: L {L}, T {T} {dt}]",
                fn=lambda x=x, g=g, A=A, Bm=Bm: cf.cola_fit_lowrank(x, g, A, Bm),
                plain=lambda x=x, g=g, A=A, Bm=Bm: cf.plain(x, g, A, Bm),
                lib=lambda x=x, g=g, A=A, Bm=Bm: (
                    torch.matmul((x @ A).transpose(1, 2), g),
                    torch.matmul(x.transpose(1, 2), g @ Bm.transpose(1, 2))),
                stream=lambda x=x, g=g: (x.sum(), g.sum()),
                nbytes=nbytes(x, g, A, Bm, A, Bm),
                flops=4 * r * (d_in + d_out) * T * L)
            del x, g

    # mamba2-370m's fit ([ssm] (b), f32): 48 layers of each ssm tap, T = 4 x
    # 2048 rows, rank 8, in 1024 -> 4384 and out 2048 -> 1024
    if dtype == torch.float32:
        L, T, r = 48, 4 * 2048, 8
        for d_in, d_out in ((1024, 4384), (2048, 1024)):
            x, g = rnd(L, T, d_in), rnd(L, T, d_out)
            A, Bm = rnd(L, d_in, r) / r ** 0.5, rnd(L, r, d_out) * 0.05
            yield dict(
                name=f"cola_fit[mamba2 {d_in} -> {d_out}: L {L}, T {T} {dt}]",
                fn=lambda x=x, g=g, A=A, Bm=Bm: cf.cola_fit_lowrank(x, g, A, Bm),
                plain=lambda x=x, g=g, A=A, Bm=Bm: cf.plain(x, g, A, Bm),
                lib=lambda x=x, g=g, A=A, Bm=Bm: (
                    torch.matmul((x @ A).transpose(1, 2), g),
                    torch.matmul(x.transpose(1, 2), g @ Bm.transpose(1, 2))),
                stream=lambda x=x, g=g: (x.sum(), g.sum()),
                nbytes=nbytes(x, g, A, Bm, A, Bm),
                flops=4 * r * (d_in + d_out) * T * L)
            del x, g

    # the adapted taps of the eight configs, 4 users, rank 8 (mamba2's are
    # its ssm in and out projections, of two input widths; zamba2's q and
    # v, both 3584 -> 3584, and musicgen's, both 1536 -> 1536, one row for
    # the two; pixtral's are nemo's)
    U, r = 4, 8
    for model, d_in, outs in (("gemma2", 3584, (4096, 2048)),
                              ("nemo", 5120, (4096, 1024)),
                              ("large", 12288, (12288, 1024)),
                              ("qwen3", 2048, (4096, 512)),
                              ("dbrx", 6144, (6144, 1024)),
                              ("mamba2", 1024, (4384,)),
                              ("mamba2", 2048, (1024,)),
                              ("zamba2", 3584, (3584,)),
                              ("musicgen", 1536, (1536,))):
        for d_out in outs:
            A = rnd(U, d_in, r, d=torch.float32) / r ** 0.5
            Bm = rnd(U, r, d_out, d=torch.float32) * 0.05
            x = rnd(8, d_in)
            idx = torch.arange(8, device=dev, dtype=torch.int32) % U
            yield dict(
                name=f"multi_lora[{model} {d_in} -> {d_out}: tick 8 {dt}]",
                fn=lambda x=x, A=A, Bm=Bm, idx=idx: ml.multi_lora(x, A, Bm, idx),
                plain=lambda x=x, A=A, Bm=Bm, idx=idx: ml.plain(x, A, Bm, idx),
                lib=lambda x=x, A=A, Bm=Bm, idx=idx: torch.bmm(
                    torch.bmm(x.float()[:, None], A[idx.long()]), Bm[idx.long()]),
                nbytes=nbytes(x, idx, A, Bm) + 8 * d_out * x.element_size(),
                flops=2 * 8 * (d_in * r + r * d_out))
            Aq, As = ml.quant_rows(A)
            Bq, Bs = ml.quant_rows(Bm)
            T = 8 * 128
            x = rnd(T, d_in)
            ix = (torch.arange(8, device=dev, dtype=torch.int32) % U
                  ).repeat_interleave(128)
            yield dict(
                name=f"multi_lora_q8[{model} {d_in} -> {d_out}: T 1024 {dt}]",
                fn=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix:
                    ml.multi_lora_q8(x, Aq, As, Bq, Bs, ix),
                plain=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix:
                    ml.plain_q8(x, Aq, As, Bq, Bs, ix),
                lib=lambda x=x, Aq=Aq, As=As, Bq=Bq, Bs=Bs, ix=ix: torch.bmm(
                    torch.bmm(x.float()[:, None],
                              Aq[ix.long()].float() * As[ix.long()]),
                    Bq[ix.long()].float() * Bs[ix.long()]),
                nbytes=nbytes(x, ix, Aq, As, Bq, Bs) + T * d_out * x.element_size(),
                flops=2 * T * (d_in * r + r * d_out))


def lse_cases(dtype, dev, gen):
    """Phase-1 rows of the dense decode kernel with its log-sum-exp
    (``return_lse=True``: o in f32 and lse (B, H) f32), as the serve step
    runs it on a rank's block of a KV cache split by sequence: mistral-large-
    123b's decode_32k rank share on 16 "model" ranks (8 slots, rank 0's
    2,048 positions of 32,768, 96 query / 8 KV heads of 128, every position
    of the block live, as in phase 27), zamba2-7b's (the same block, its
    shared block's 32 / 32 heads of 112, as in phase 28) and smollm-135m's
    tick (16 slots
    against block 7 of 16 of a 1,024-position cache, its 64 positions at
    positions less the offset 448, the slots past its start)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da

    dt = "bf16" if dtype == torch.bfloat16 else "f32"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    for tag, B, S, H, K, D, pos in (
            ("large rank share: 8 slots x 2048 of 32768, 96 / 8 heads of 128",
             8, 2048, 96, 8, 128, ints(30000, 32768, 8)),
            ("zamba2 rank share: 8 slots x 2048 of 32768, 32 / 32 heads of "
             "112", 8, 2048, 32, 32, 112, ints(30000, 32768, 8)),
            ("dbrx rank share: 8 slots x 2048 of 32768, 48 / 8 heads of 128",
             8, 2048, 48, 8, 128, ints(30000, 32768, 8)),
            ("smollm: 16 slots x block 7 of 16 (64 of 1024), 9 / 3 heads "
             "of 64", 16, 64, 9, 3, 64, ints(448, 1024, 16) - 448)):
        q, kb, vb = rnd(B, 1, H, D), rnd(B, S, K, D), rnd(B, S, K, D)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kb, vb))
        mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None])
        n_read = int((pos.clamp(max=S - 1) + 1).sum())
        yield dict(
            name=f"decode_attention[lse: {tag} {dt}]", with_lse=True,
            fn=lambda q=q, kb=kb, vb=vb, pos=pos: da.decode_attention(
                q, kb, vb, pos, return_lse=True),
            plain=lambda q=q, kb=kb, vb=vb, pos=pos: da.plain(
                q, kb, vb, pos, return_lse=True),
            lib=lambda qt=qt, kt=kt, vt=vt, mask=mask:
                F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask[:, None, None],
                    enable_gqa=True),
            nbytes=(nbytes(q) + 2 * n_read * K * D * q.element_size()
                    + B * H * (D + 1) * 4 + B * 4),
            flops=4 * D * H * n_read)


def lse_merge_checks(dtype, dev, gen) -> None:
    """The serve step's split and merge on the card: one cache cut into 16
    position blocks, one launch a block at positions less its offset
    (``return_lse``), the blocks merged by ``tensor_parallel.merge``,
    against one launch over the whole cache: o within TOL[dtype], lse
    within it where finite and -inf at the same (slot, head)s, no NaN; at
    smollm-135m's tick (16 slots of 1,024), mistral-large-123b's decode_32k
    rank share (8 slots of 32,768, 96 / 8 heads of 128) and gemma2-9b's
    heads (8 slots of 8,192, 16 / 8 heads of 256, window 4096, softcap 50);
    a slot at position 0 and one inside the first block (every later block
    empty), one at the last position, a dead slot. Every call launches the
    kernel."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import decode_attention as da

    n = 16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for tag, B, S, H, K, D, kw in (
            ("smollm 16 x 1024, 9 / 3 x 64", 16, 1024, 9, 3, 64, {}),
            ("large 8 x 32768, 96 / 8 x 128", 8, 32768, 96, 8, 128, {}),
            ("gemma2 8 x 8192, 16 / 8 x 256, window 4096, softcap 50", 8,
             8192, 16, 8, 256, dict(window=4096, softcap=50.0))):
        q, kc, vc = rnd(B, 1, H, D), rnd(B, S, K, D), rnd(B, S, K, D)
        pos = torch.randint(0, S, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        pos[0], pos[1], pos[2] = 0, S - 1, S // n // 2
        live = torch.arange(B, device=dev) != 3
        before = da.decode_attention.launches
        o_w, l_w = da.decode_attention(q, kc, vc, pos, live=live,
                                       return_lse=True, **kw)
        size = S // n
        parts = [da.decode_attention(
            q, kc[:, c * size:(c + 1) * size].contiguous(),
            vc[:, c * size:(c + 1) * size].contiguous(), pos - c * size,
            live=live, return_lse=True, **kw) for c in range(n)]
        o_m, l_m = tp.merge(torch.stack([o for o, _ in parts]),
                            torch.stack([lse for _, lse in parts]))
        torch.cuda.synchronize()
        check(da.decode_attention.launches - before == n + 1,
              f"[kernels] lse merge {tag}: the kernel did not run each call")
        err, scale = max_err(o_m, o_w)
        tol = TOL[dtype] * (1 + scale)
        fin = torch.isfinite(l_w)
        same_empty = torch.equal(fin, torch.isfinite(l_m)) and \
            not bool(fin[3].any()) and bool(torch.isfinite(o_m).all())
        l_err, l_scale = max_err(l_m[fin], l_w[fin])
        l_tol = TOL[dtype] * (1 + l_scale)
        check(err <= tol and l_err <= l_tol and same_empty,
              f"[kernels] lse merge {tag} {dtype}: o {err:.3g} (tol "
              f"{tol:.3g}), lse {l_err:.3g} (tol {l_tol:.3g}), empty rows "
              f"alike {same_empty}")
        print(f"[kernels] decode_attention lse, 16 blocks merged against "
              f"the whole cache, {tag} {str(dtype).replace('torch.', '')}: "
              f"o max_abs_err {err:.3e} (tol {tol:.2e}), lse {l_err:.3e} "
              f"(tol {l_tol:.2e}); the dead slot's lse -inf and o 0",
              flush=True)
        del q, kc, vc, parts


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|) over a tensor or a tuple of them."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    return err, max(float(w.float().abs().max()) for w in want)


def measure(c, dtype, timer) -> dict:
    """One phase-1 row: the kernel against its plain version (within
    TOL[dtype] * (1 + max |plain|)), and the median device times of the
    kernel, the plain version and the library call, beside the bound."""
    name = c["name"]
    got, want = c["fn"](), c["plain"]()
    if c.get("with_lse"):   # (o, lse): scale by o's values
        err = max(max_err(g, w)[0] for g, w in zip(got, want))
        scale = max_err(got[0], want[0])[1]
    else:
        err, scale = max_err(got, want)
    torch.cuda.synchronize()
    tol = TOL[dtype] * (1 + scale)
    check(err <= tol, f"{name} {dtype}: max |kernel - plain| = {err:.3g}"
          f" > {tol:.3g}")
    ms = timer.median_ms(c["fn"])
    plain_ms = timer.median_ms(c["plain"], iters=5)
    lib = c["lib"]
    if isinstance(lib, tuple):   # (call, part): library time of the rest
        lib_ms = timer.median_diff_ms(*lib)
    else:
        lib_ms = timer.median_ms(lib) if lib is not None else None
    b_ms, b_by = bound(c["nbytes"], c["flops"], dtype)
    dt = str(dtype).replace("torch.", "")
    stream = (f"  stream {timer.median_ms(c['stream']):.4f} ms"
              if "stream" in c else "")
    note = f"  ({c['note']})" if "note" in c else ""
    print(f"[kernels] {name:24s} {dt:8s} max_abs_err {err:.3e} "
          f"(tol {tol:.2e})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
          f"  library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
          f"  bound {b_ms:.4g} ms ({b_by}){stream}{note}", flush=True)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms)
    if "note" in c:
        row["note"] = c["note"]
    return row


def phase_kernels(cfg, dev) -> dict:
    """Rows of the JSON line, in the dtype each kernel runs in on its path:
    bf16, and f32 for cola_fit; then the rows of the other registered
    configs' shapes (``model_cases``) in both dtypes."""
    timer = Timer(dev)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for c in kernel_cases(cfg, dtype, dev, gen):
            row = measure(c, dtype, timer)
            if dtype == torch.bfloat16 or c["name"] not in rows:
                rows[c["name"]] = row
    # a second launch of the flash backward, cola_fit, dense and paged decode
    # and both multi-LoRA kernels (all their rows) gives the same bits
    for dtype, names in ((torch.float32, ("flash_attention_bwd", "cola_fit",
                                          "decode_attention", "multi_lora")),
                         (torch.bfloat16, ("flash_attention_bwd",
                                           "decode_attention", "multi_lora"))):
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        for c in kernel_cases(cfg, dtype, dev, gen):
            if c["name"].startswith(names):
                a, b = c["fn"](), c["fn"]()
                a, b = (a,) if isinstance(a, torch.Tensor) else a, \
                    (b,) if isinstance(b, torch.Tensor) else b
                check(all(torch.equal(x, y) for x, y in zip(a, b)),
                      f"{c['name']} {dtype}: two launches on the same inputs "
                      "differ")
    multi_lora_rows(cfg, dev)
    # the pairs plan's d_head 256 and the other configs' head layouts and
    # tap widths, each row launched twice to the same bits
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)
        outs = {}
        for c in model_cases(dtype, dev, gen):
            rows[c["name"]] = measure(c, dtype, timer)
            a, b = c["fn"](), c["fn"]()
            a, b = (a,) if isinstance(a, torch.Tensor) else a, \
                (b,) if isinstance(b, torch.Tensor) else b
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{c['name']}: two launches on the same inputs differ")
            if "tick" in c:
                outs[c["tick"]] = a[0]
        check(torch.equal(outs["ring"], outs["dense"]),
              f"d_head 256 {dtype}: the ring tick differs from the dense tick")
        print(f"[kernels] d_head 256 {dtype}: the ring tick equals the dense "
              "tick with the same window, bit for bit", flush=True)
    # the dense decode kernel with its log-sum-exp: the serve step's rank
    # share and its split and merge
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        for c in lse_cases(dtype, dev, gen):
            rows[c["name"]] = measure(c, dtype, timer)
        lse_merge_checks(dtype, dev, gen)
        _free()
    return rows


def multi_lora_rows(cfg, dev) -> None:
    """A row's bits do not depend on the launch: rows of the prefill call
    (T 8192, tiles of 32 rows, f32 bank) and of the chunk-round call (T 2048,
    int8 bank) equal the same rows computed in a tick-sized call of 16 rows
    (one row a block, columns in slices), among other neighbours; and the int8
    kernel equals the f32 kernel on the dequantised bank, in bf16 and f32."""
    from repro_torch.kernels import multi_lora as ml

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    U, r, d, d_out = 4, 8, cfg.d_model, cfg.n_heads * cfg.d_head
    A = torch.randn(U, d, r, generator=gen, device=dev) / r ** 0.5
    Bm = torch.randn(U, r, d_out, generator=gen, device=dev) * 0.05
    (Aq, As), (Bq, Bs) = ml.quant_rows(A), ml.quant_rows(Bm)
    Ad, Bd = ml.dequant_rows(Aq, As), ml.dequant_rows(Bq, Bs)
    for dtype in (torch.bfloat16, torch.float32):
        for name, T, run, fn in (
                ("multi_lora", 16 * 512, 512,
                 lambda x, i: ml.multi_lora(x, A, Bm, i)),
                ("multi_lora_q8", 16 * 128, 128,
                 lambda x, i: ml.multi_lora_q8(x, Aq, As, Bq, Bs, i))):
            x = torch.randn(T, d, generator=gen, device=dev).to(dtype)
            idx = (torch.arange(T // run, device=dev, dtype=torch.int32) % U
                   ).repeat_interleave(run)
            idx[T // 3:T // 3 + 40] = -1
            rows = torch.randperm(T, generator=gen, device=dev)[:16]
            big = fn(x, idx)
            small = fn(x[rows].contiguous(), idx[rows])
            check(torch.equal(small, big[rows]),
                  f"{name} {dtype}: rows of a T {T} call differ from the same "
                  "rows in a T 16 call")
            if name == "multi_lora_q8":
                check(torch.equal(big, ml.multi_lora(x, Ad, Bd, idx)),
                      f"{name} {dtype}: int8 differs from the f32 kernel on the "
                      "dequantised bank")
    torch.cuda.synchronize()
    print("[kernels] multi_lora rows: T 8192 (f32 bank) and T 2048 (int8) "
          "rows == the same rows in T 16 calls; int8 == f32 on the dequantised "
          "bank (bf16, f32)", flush=True)


# ---------------------------------------------------------------------------
# phases 2 and 3: the serving path
# ---------------------------------------------------------------------------

def user_banks(cfg, n_users: int, device, seed: int) -> list[dict]:
    """Rank-8 ``qv`` adapters, B nonzero, on the CPU generator for
    reproducibility across devices."""
    from repro_torch.core import gl
    from repro_torch.models import model

    gen = torch.Generator().manual_seed(seed)
    sites = model.tap_sites(cfg)
    out = []
    for _ in range(n_users):
        bank = {}
        for tap in gl.select_taps(cfg, "qv"):
            s = sites[tap]
            lead = (s.stacked,) if s.stacked else ()   # zamba2's shared taps
            bank[tap] = {
                "A": torch.randn(lead + (s.d_in, 8), generator=gen) / 8 ** 0.5,
                "B": torch.randn(lead + (8, s.d_out), generator=gen) * 0.05}
        out.append({t: {n: a.to(device) for n, a in e.items()}
                    for t, e in bank.items()})
    return out


def serve(cfg, params, banks, prompts, device, *, slots, max_len, max_new,
          engine=None, users=None, **options):
    """Serve ``prompts`` to completion (user ``users[i]``, by default
    i % len(banks), for request i); ``options`` go to ``ServeEngine``.
    Returns (engine, requests, the largest ``kv_cache_bytes()`` seen after a
    tick)."""
    from repro_torch.runtime.serve_loop import ServeEngine

    eng = (engine or ServeEngine)(cfg, params, slots=slots, max_len=max_len,
                                  user_adapters=banks, device=device, **options)
    if users is None:
        users = [i % len(banks) for i in range(len(prompts))]
    return (eng, *drive(eng, prompts, users, max_new))


def drive(eng, prompts, users, max_new) -> tuple[list, int]:
    """Submit request i (``prompts[i]`` for ``users[i]``) to ``eng`` and tick
    until it is idle. Returns (requests, the largest ``kv_cache_bytes()``
    seen after a tick)."""
    from repro_torch.runtime.serve_loop import Request

    reqs = [Request(rid=i, user=u, prompt=p, max_new=max_new)
            for i, (u, p) in enumerate(zip(users, prompts))]
    for r in reqs:
        eng.submit(r)
    peak_bytes = eng.kv_cache_bytes()
    for _ in range(10_000):
        if not eng.queue and all(r is None for r in eng.active):
            break
        eng.tick()
        peak_bytes = max(peak_bytes, eng.kv_cache_bytes())
    return reqs, peak_bytes


def serving_setup(cfg, dev):
    """Phase 2's weights, 4 users' adapters and 32 prompts of 32-512 tokens."""
    from repro_torch.models import model

    params = model.init(cfg, seed=SEED, device=dev)
    banks = user_banks(cfg, 4, dev, SEED)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(32, 513, 32)]
    return params, banks, prompts


def phase_serving(cfg, dev, setup) -> tuple[dict, list]:
    """Phase 2; returns the launch counts and the tokens of the measured
    run."""
    params, banks, prompts = setup
    # warm-up (library handles, allocator); its launches are not counted
    serve(cfg, params, banks, prompts[:2], dev, slots=16, max_len=1024,
          max_new=2)
    torch.cuda.synchronize()

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    eng, reqs, _ = serve(cfg, params, banks, prompts, dev, slots=16,
                         max_len=1024, max_new=32)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in ws.items()}

    check(all(r.status == "done" and len(r.out) == 32 for r in reqs),
          "not every request finished with 32 tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
          "a token outside the vocabulary")
    for n in ("flash_attention", "decode_attention", "multi_lora"):
        check(launches[n] > 0, f"kernel {n} was never launched on the serving "
              "path")
    tp = eng.throughput()
    print(f"[serve] smollm-135m bf16, 30 layers, 16 slots, 4 users: "
          f"{tp['completed']} requests, decode {tp['decode_tok_per_s']:.1f} tok/s,"
          f" prefill {tp['prefill_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{tp['ttft']['p50'] * 1e3:.1f} ms p99 {tp['ttft']['p99'] * 1e3:.1f} ms,"
          f" decode tick p50 {tp['decode_tick']['p50'] * 1e3:.2f} ms,"
          f" prefill calls {eng.stats['prefill_calls']}", flush=True)
    print(f"[serve] launches on the serving path: {launches}", flush=True)
    return launches, [r.out for r in reqs]


def phase_engine_vs_plain(cfg, dev) -> None:
    from repro_torch.models import model

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params_cpu = model.init(cfg32, seed=SEED + 1, device="cpu")
    params_gpu = {k: _to(v, dev) for k, v in params_cpu.items()}
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
               for _ in range(4)]
    outs, logits = {}, {}
    for device, params in (("cpu", params_cpu), (dev, params_gpu)):
        banks = user_banks(cfg32, 4, device, SEED + 1)
        eng, reqs, _ = serve(cfg32, params, banks, prompts, device, slots=4,
                             max_len=128, max_new=8)
        outs[str(device)] = [r.out for r in reqs]
        users = torch.arange(4, dtype=torch.int32, device=device)
        lg, _ = model.prefill(cfg32, params,
                              {"tokens": torch.as_tensor(np.stack(prompts),
                                                         device=device)},
                              eng.spec, eng._cola_vars(users))
        logits[str(device)] = lg.float().cpu()
    diff = float((logits["cpu"] - logits[str(dev)]).abs().max())
    print(f"[engine-vs-plain] f32 full width: card tokens == CPU tokens: "
          f"{outs['cpu'] == outs[str(dev)]}; prefill logits max |diff| "
          f"{diff:.3e} (max |logit| {float(logits['cpu'].abs().max()):.3f})",
          flush=True)
    check(outs["cpu"] == outs[str(dev)],
          f"greedy tokens differ: cpu {outs['cpu']} card {outs[str(dev)]}")


SCALE = dict(kv_layout="paged", kv_block=16, prefill_chunk=128,
             bank_store="int8")


def phase_serving_at_scale(cfg, dev, setup) -> tuple[dict, list]:
    """Phase 2's requests through paged KV, chunked prefill and an int8 bank;
    returns the launch counts and the tokens of the measured run."""
    from repro_torch.models import model

    params, banks, prompts = setup
    # warm-up with the same options; its launches are not counted
    serve(cfg, params, banks, prompts[:2], dev, slots=16, max_len=1024,
          max_new=2, **SCALE)
    torch.cuda.synchronize()

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    eng, reqs, peak_bytes = serve(cfg, params, banks, prompts, dev, slots=16,
                                  max_len=1024, max_new=32, **SCALE)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in ws.items()}

    check(all(r.status == "done" and len(r.out) == 32 for r in reqs),
          "serving at scale: not every request finished with 32 tokens")
    for n in ("decode_attention_paged", "multi_lora_q8", "flash_attention"):
        check(launches[n] > 0, f"kernel {n} was never launched serving at scale")
    for n in ("decode_attention", "multi_lora"):
        check(launches[n] == 0, f"kernel {n} ran {launches[n]} times serving at "
              "scale (paged KV and an int8 bank must not reach it)")
    for tap, leaves in eng.bank.items():
        check(sorted(leaves) == ["A_q", "A_scale", "B_q", "B_scale"]
              and all(leaves[n].dtype == torch.int8 for n in ("A_q", "B_q"))
              and all(leaves[n].dtype == torch.float32
                      for n in ("A_scale", "B_scale"))
              and all(t.is_cuda for t in leaves.values()),
              f"bank {tap}: {[(n, t.dtype, t.device) for n, t in leaves.items()]}")
    st = eng.stats
    check(st["kv_allocs"] == st["kv_frees"] > 0,
          f"kv allocs {st['kv_allocs']} != frees {st['kv_frees']}")
    eng.pager.assert_empty()

    dense_bytes = sum(int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
                      for leaves in model.cache_specs(cfg, 16, 1024).values()
                      for shape, dt in leaves.values())
    pool_bytes = sum(leaf.numel() * leaf.element_size()
                     for stack in eng.cache.values() for leaf in stack.values())
    tp = eng.throughput()
    decode_calls = tp["decode_tick"]["count"]   # one sample per decode call
    print(f"[scale] smollm-135m bf16, 30 layers, 16 slots, 4 users, paged KV "
          f"(blocks of 16), chunks of 128, int8 bank: {tp['completed']} "
          f"requests, decode {tp['decode_tok_per_s']:.1f} tok/s, prefill "
          f"{tp['prefill_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{tp['ttft']['p50'] * 1e3:.1f} ms p99 {tp['ttft']['p99'] * 1e3:.1f} ms,"
          f" decode tick p50 {tp['decode_tick']['p50'] * 1e3:.2f} ms, chunk "
          f"round p50 {tp['prefill']['p50'] * 1e3:.2f} ms", flush=True)
    print(f"[scale] kv_blocks_peak {st['kv_blocks_peak']} of "
          f"{eng.pager.n_blocks}; kv_cache_bytes at peak {peak_bytes} against "
          f"the dense engine's {dense_bytes} ({peak_bytes / dense_bytes:.3f}: "
          f"the share the traffic used); pool allocated {pool_bytes} bytes "
          f"({pool_bytes / dense_bytes:.3f} of dense); "
          f"ticks {st['ticks']}, chunk rounds {st['chunk_rounds']}, decode "
          f"calls {decode_calls}", flush=True)
    print(f"[scale] launches: {launches}; per chunk round: flash "
          f"{launches['flash_attention'] / st['chunk_rounds']:.1f}; per decode "
          f"call: decode_attention_paged "
          f"{launches['decode_attention_paged'] / decode_calls:.1f}; "
          f"multi_lora_q8 per call (chunk rounds + decode calls) "
          f"{launches['multi_lora_q8'] / (st['chunk_rounds'] + decode_calls):.1f}",
          flush=True)
    return launches, [r.out for r in reqs]


def phase_scale_vs_plain(cfg, dev) -> None:
    """f32 full width, 8 requests: the card's paged + chunked + int8 engine
    against the CPU's, paged against dense and int8 against the dequantised
    f32 bank on the card. Equal greedy tokens; prints the largest gap of the
    next-token logits of live rows across each pair's steps."""
    from repro_torch.kernels import multi_lora as ml
    from repro_torch.models import model
    from repro_torch.runtime.serve_loop import ServeEngine

    class Recording(ServeEngine):
        """Keeps every step's next-token logits of the rows it ran for."""

        def _step_logits(self, tokens, positions, users, live, lens=None):
            out = super()._step_logits(tokens, positions, users, live, lens)
            self.logits.append(out[live].float().cpu())
            return out

        def __init__(self, *a, **kw):
            self.logits = []
            super().__init__(*a, **kw)

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params_cpu = model.init(cfg32, seed=SEED + 1, device="cpu")
    params_gpu = _to(params_cpu, dev)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(20, 151, 8)]
    kw = dict(slots=4, max_len=256, max_new=8, engine=Recording,
              prefill_chunk=32, bank_store="int8")
    banks_cpu = user_banks(cfg32, 4, "cpu", SEED + 1)
    banks_gpu = [_to(b, dev) for b in banks_cpu]
    deq = [{t: {n: ml.dequant_rows(*ml.quant_rows(a)).to(dev)
                for n, a in e.items()} for t, e in b.items()} for b in banks_cpu]
    runs = {
        "card": (params_gpu, banks_gpu, dev, dict(kw, kv_layout="paged")),
        "cpu": (params_cpu, banks_cpu, "cpu", dict(kw, kv_layout="paged")),
        "card dense": (params_gpu, banks_gpu, dev, kw),
        "card f32 dequantised": (params_gpu, deq, dev,
                                 dict(kw, kv_layout="paged", bank_store="f32")),
    }
    out = {}
    for name, (params, banks, device, opts) in runs.items():
        eng, reqs, _ = serve(cfg32, params, banks, prompts, device, **opts)
        check(all(r.status == "done" and len(r.out) == 8 for r in reqs),
              f"{name}: not every request finished")
        if eng.pager is not None:
            eng.pager.assert_empty()
        out[name] = ([r.out for r in reqs], eng.logits)
    for other in ("cpu", "card dense", "card f32 dequantised"):
        (toks, lg), (toks_o, lg_o) = out["card"], out[other]
        check(len(lg) == len(lg_o), f"card vs {other}: {len(lg)} steps vs "
              f"{len(lg_o)}")
        gap = max(float((a - b).abs().max()) for a, b in zip(lg, lg_o))
        top = max(float(a.abs().max()) for a in lg)
        print(f"[scale-vs-plain] f32 full width, paged + chunked + int8 on the "
              f"card vs {other}: tokens equal {toks == toks_o}; largest "
              f"next-token logit gap {gap:.3e} (max |logit| {top:.3f}) over "
              f"{len(lg)} steps", flush=True)
        check(toks == toks_o, f"greedy tokens differ, card vs {other}: "
              f"{toks} vs {toks_o}")


STORE_USERS, STORE_ROWS = 24, 8


def _bank_bytes(bank: dict) -> int:
    return sum(l.numel() * l.element_size()
               for leaves in bank.values() for l in leaves.values())


def _store_vs_resident(cfg, params, prompts, banks, dev, tag, **options):
    """Phase 2's requests, request i to user (5 i) mod 24 (users repeat),
    through ``resident_slots=8`` and through the all-resident engine with the
    same options: equal tokens, rows evicted, every pin released, the bank a
    third of the dense one, admission waiting on pins. Prints the store's
    counters and both engines' serving figures."""
    users = [(5 * i) % STORE_USERS for i in range(len(prompts))]
    kw = dict(slots=16, max_len=1024, max_new=32, users=users, **options)
    store, s_reqs, _ = serve(cfg, params, banks, prompts, dev,
                             resident_slots=STORE_ROWS, **kw)
    full, f_reqs, _ = serve(cfg, params, banks, prompts, dev, **kw)
    torch.cuda.synchronize()
    for name, reqs in (("store", s_reqs), ("all-resident", f_reqs)):
        check(all(r.status == "done" and len(r.out) == 32 for r in reqs),
              f"[store] {tag} {name}: not every request finished")
    same = [r.out for r in s_reqs] == [r.out for r in f_reqs]
    st, m = store.stats, store.store.metrics()
    dense = _bank_bytes(full.bank)
    # the first 16 requests are 16 distinct users: all-resident admits them
    # in one round, 8 rows pin at most 8 of them at a time
    rounds = [len({r.t_admit for r in reqs[:16]}) for reqs in (s_reqs, f_reqs)]
    tp = {n: e.throughput() for n, e in (("store", store), ("all", full))}
    print(f"[store] {tag}: U {STORE_USERS}, R {STORE_ROWS}, 16 slots; tokens "
          f"equal to the all-resident engine: {same}; admission rounds of the "
          f"first 16 requests {rounds[0]} (all-resident {rounds[1]}); hits "
          f"{m['hits']} misses {m['misses']} evictions {m['evictions']} "
          f"fetches {m['fetches']}, fetch_time per fetch "
          f"{m['fetch_time'] / max(m['fetches'], 1) * 1e3:.3f} ms (host time "
          f"around the row copies, from pageable host memory: they return "
          f"when done); resident bytes {st['store_resident_bytes']} (dense "
          f"bank {dense}), host bytes {m['host_bytes']}; pinned at the end "
          f"{st['store_pinned']}", flush=True)
    print(f"[store] {tag}: store vs all-resident: decode tick p50 "
          f"{tp['store']['decode_tick']['p50'] * 1e3:.2f} vs "
          f"{tp['all']['decode_tick']['p50'] * 1e3:.2f} ms, TTFT p50 "
          f"{tp['store']['ttft']['p50'] * 1e3:.1f} vs "
          f"{tp['all']['ttft']['p50'] * 1e3:.1f} ms, decode "
          f"{tp['store']['decode_tok_per_s']:.1f} vs "
          f"{tp['all']['decode_tok_per_s']:.1f} tok/s; {card_line()}",
          flush=True)
    check(same, f"[store] {tag}: tokens differ from the all-resident engine")
    check(st["store_evictions"] > 0, f"[store] {tag}: no row was evicted")
    check(st["store_pinned"] == 0, f"[store] {tag}: {st['store_pinned']} "
          "users still pinned")
    check(st["store_resident_bytes"] == dense * STORE_ROWS // STORE_USERS,
          f"[store] {tag}: resident bytes {st['store_resident_bytes']} != "
          f"{dense} * {STORE_ROWS} // {STORE_USERS}")
    check(rounds[0] > 1 and rounds[1] == 1, f"[store] {tag}: admission rounds "
          f"{rounds}: admission never waited on pins")
    for eng in (store, full):
        if eng.pager is not None:
            eng.pager.assert_empty()


def _one_user(cfg, params, bank, prompts, dev, max_new=32) -> list:
    eng, reqs, _ = serve(cfg, params, [bank], prompts, dev, slots=16,
                         max_len=1024, max_new=max_new)
    return [r.out for r in reqs]


def _clustering(cfg, params, prompts, dev) -> None:
    """Four users, 1 a near copy of 0 (cosine 1 >= 0.95), 2 and 3 their own:
    0 and 1 share one resident row and serve the same tokens. ``shared``: an
    install on 1 splits it off (copy-on-write); 0's tokens stay, 1's equal a
    one-user engine on the new bank. ``merged``: a member's tokens equal a
    one-user engine on the members' mean."""
    from repro_torch.core.merge import merge_adapter_pytrees
    from repro_torch.runtime.serve_loop import ServeEngine

    b0, b2, b3 = user_banks(cfg, 3, dev, SEED + 2)
    banks = [b0, {t: {n: a * 1.01 for n, a in e.items()}
                  for t, e in b0.items()}, b2, b3]
    new = user_banks(cfg, 1, dev, SEED + 3)[0]
    for mode in ("shared", "merged"):
        eng = ServeEngine(cfg, params, slots=16, max_len=1024,
                          user_adapters=banks, resident_slots=3,
                          cluster_threshold=0.95, cluster_mode=mode,
                          device=dev)
        st = eng.store
        check(st.cluster_of(0) is not None
              and st.cluster_of(0) == st.cluster_of(1)
              and st.cluster_of(2) is None and st.cluster_of(3) is None,
              f"[store] {mode}: clusters "
              f"{[st.cluster_of(u) for u in range(4)]}")

        def tokens(user):
            reqs, _ = drive(eng, prompts, [user] * len(prompts), 32)
            return [r.out for r in reqs]

        t0, t1 = tokens(0), tokens(1)
        check(t0 == t1 and st.resident_index(0) == st.resident_index(1),
              f"[store] {mode}: the cluster's members differ")
        if mode == "shared":
            check(eng.install_adapters(1, new, version=1),
                  "[store] shared: the install was rejected")
            a0, a1 = tokens(0), tokens(1)
            solo = _one_user(cfg, params, new, prompts, dev)
            print(f"[store] shared: splits {st.counters['splits']}; after "
                  f"the split 0's tokens unchanged {a0 == t0}, 1's changed "
                  f"{a1 != t1} and equal to a one-user engine on the new bank "
                  f"{a1 == solo}", flush=True)
            check(st.counters["splits"] == 1 and st.cluster_of(1) is None,
                  f"[store] shared: splits {st.counters['splits']}")
            check(a0 == t0, "[store] shared: a split perturbed the cluster")
            check(a1 != t1 and a1 == solo, "[store] shared: the split user "
                  "does not serve the new bank")
        else:
            mean = merge_adapter_pytrees([_to(b, "cpu") for b in banks[:2]])
            solo = _one_user(cfg, params, _to(mean, dev), prompts, dev)
            print(f"[store] merged: a member's tokens equal a one-user engine "
                  f"on the members' mean {t0 == solo}", flush=True)
            check(t0 == solo, "[store] merged: tokens differ from the mean's")


def phase_store(cfg, dev, setup) -> dict:
    """The tiered adapter store at full width (phase 2's weights and
    prompts): (a) dense KV and an f32 bank, (b) paged KV, chunks of 128 and
    an int8 bank, each against the all-resident engine with the same
    options, (c) clustering and the copy-on-write hot-swap. Returns the
    launch counts of the phase."""
    params, _, prompts = setup
    banks = user_banks(cfg, STORE_USERS, dev, SEED)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    _store_vs_resident(cfg, params, prompts, banks, dev, "(a) dense, f32")
    _store_vs_resident(cfg, params, prompts, banks, dev,
                       "(b) paged, chunks of 128, int8", **SCALE)
    _clustering(cfg, params, prompts[:4], dev)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in ws.items()}
    print(f"[store] launches: {launches}", flush=True)
    for n in ("flash_attention", "decode_attention", "decode_attention_paged",
              "multi_lora", "multi_lora_q8"):
        check(launches[n] > 0, f"kernel {n} was never launched in [store]")
    return launches


def wrappers() -> dict:
    """Every kernel wrapper of the port, by the kernel's name; each counts
    its own launches."""
    from repro_torch.kernels import cola_fit as cf
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import multi_lora as ml

    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd_dq": fa.bwd_dq,
            "flash_attention_bwd_dkv": fa.bwd_dkv,
            "cola_fit": cf.cola_fit_lowrank,
            "decode_attention": da.decode_attention,
            "decode_attention_paged": da.decode_attention_paged,
            "multi_lora": ml.multi_lora,
            "multi_lora_q8": ml.multi_lora_q8}


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "cola_fit")


def _measured_steps(sess, batches, dev) -> dict:
    """A warm-up step of ``sess`` on ``batches[0]`` (its launches are not
    counted), then a step on each later batch with every kernel's launch
    count reset just before and read just after, the peak memory read from
    a reset, each fit timed between syncs and the channel's checks timed
    (``time_channel_checks``). Checks that every fit moved the bank.
    Returns the losses, step / server / fit ms, the checks' ms, the launch
    counts and the peak memory."""
    from repro_torch.utils import tree_leaves

    off = sess.offloader
    fit_ms: list[float] = []
    inner = off.maybe_fit

    def timed_fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner()
        torch.cuda.synchronize()
        fit_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    off.maybe_fit = timed_fit
    sess.step(batches[0])
    torch.cuda.synchronize()
    fit_ms.clear()
    check_ms, untimed = time_channel_checks()

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, server_ms, losses = [], [], []
    for b in batches[1:]:
        before = [t.clone() for t in tree_leaves(sess.adapters)]
        n_fits = len(fit_ms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(sess.step(b))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        server_ms.append(step_ms[-1] - sum(fit_ms[n_fits:]))
        if len(fit_ms) > n_fits:
            check(any(not torch.equal(a, t) for a, t
                      in zip(before, tree_leaves(sess.adapters))),
                  f"step {sess.step_count}: the fit left the adapters as they were")
    launches = {n: w.launches for n, w in ws.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    untimed()
    off.maybe_fit = inner
    return dict(losses=losses, step_ms=step_ms, server_ms=server_ms,
                fit_ms=fit_ms, check_ms=check_ms, launches=launches, peak=peak)


def phase_training(cfg, dev) -> dict:
    """Six Mode A steps of ColaSession at full width; returns the launch
    counts of the measured steps."""
    from repro_torch.configs.base import ColaConfig, TrainConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model
    from repro_torch.optim import optimizers
    from repro_torch.profile_train import SETUPS

    tc = TrainConfig()
    batch, seq, interval = SETUPS[cfg.name]
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=interval)
    check(cfg.remat == "full" and cfg.param_dtype == "bfloat16",
          f"training config {cfg.remat}/{cfg.param_dtype}")
    sess = ColaSession(cfg, cc, model.init(cfg, seed=SEED, device=dev),
                       seed=SEED, device=dev, optimizer=optimizers.adamw(
                           tc.lr, b1=tc.b1, b2=tc.b2, eps=tc.eps,
                           weight_decay=tc.weight_decay))
    data = SyntheticLM(cfg, batch=batch, seq=seq, seed=SEED, device=dev)
    m = _measured_steps(sess, [data.batch_at(i) for i in range(7)], dev)
    losses, step_ms, fit_ms = m["losses"], m["step_ms"], m["fit_ms"]
    launches = m["launches"]
    off = sess.offloader
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(len(fit_ms) == 3 and off.stats["fits"] == 3,
          f"{len(fit_ms)} fits in the measured steps, {off.stats['fits']} in all")
    health = sess.channel_health()[0]
    check(health["fits_committed"] == 3 and all(
        health[k] == 0 for k in ("rollbacks", "dead_letters", "send_retries")),
        f"offload rounds failed: {health}")
    for n in TRAIN_KERNELS:
        check(launches[n] > 0, f"kernel {n} was never launched in training")
    n_steps = len(step_ms)
    tokens = n_steps * batch * seq
    print(f"[train] smollm-135m bf16, 30 layers, remat full, Mode A merged "
          f"rank-8 qv, interval {interval}, batch {batch} x {seq}: losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"[train] step ms {[round(t, 2) for t in step_ms]}; server step p50 "
          f"{statistics.median(m['server_ms']):.2f} ms; fit ms "
          f"{[round(t, 2) for t in fit_ms]} (p50 {statistics.median(fit_ms):.2f});"
          f" {checks_line(m['check_ms'], n_steps)}; "
          f"{tokens / (sum(step_ms) / 1e3):.1f} training tokens/s; peak memory "
          f"{m['peak'] / 2**30:.3f} GiB", flush=True)
    print(f"[train] launches in {n_steps} steps: {launches}; per step "
          f"{ {n: c / n_steps for n, c in launches.items()} }", flush=True)
    return launches


def phase_training_vs_plain(cfg, dev) -> None:
    """f32 full width, batch 2 x 128: the card's Mode A server step and fit
    against the CPU's (plain versions), and on the card Mode A == Mode B."""
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core import gl
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8)
    spec_a = gl.make_spec(cfg32, cc)
    spec_b = gl.make_spec(cfg32, ColaConfig(mode="fused_fit", family="lowrank",
                                            taps="qv", rank=8))
    params = model.init(cfg32, seed=SEED + 2, device="cpu")
    gen = torch.Generator().manual_seed(SEED + 2)
    adapters = gl.init_adapters(cfg32, cc, gen, device="cpu")
    for w in adapters.values():   # B != 0, so dA carries information
        w["B"] = torch.randn(w["B"].shape, generator=gen) * 0.02
    batch = SyntheticLM(cfg32, batch=2, seq=128, seed=SEED + 2,
                        device="cpu").batch_at(0)
    out = {}
    for device in ("cpu", dev):
        p, ad, b = (_to(t, device) for t in (params, adapters, batch))
        loss, data, _ = gl.server_step_a(cfg32, spec_a, p, ad, b)
        out[str(device)] = (float(loss), gl.fit_grads(spec_a, ad, data))
    loss_cpu, g_cpu = out["cpu"]
    loss_gpu, g_gpu = out[str(dev)]
    # f32 sums in other orders through 30 layers and a 49152-way softmax
    loss_diff = abs(loss_gpu - loss_cpu)
    check(loss_diff <= 1e-5 * abs(loss_cpu),
          f"loss card {loss_gpu} vs CPU {loss_cpu}")
    worst = 0.0
    for tap, w in g_cpu.items():
        for leaf, a in w.items():
            err, scale = max_err(g_gpu[tap][leaf].cpu(), a)
            worst = max(worst, err / scale)
            check(err <= 1e-3 * scale, f"fit grad {tap}.{leaf}: card vs CPU "
                  f"max |diff| {err:.3g} > 1e-3 x {scale:.3g}")
    # Prop 1 on the card, at test_gl_equivalence.py's tolerance
    ad = _to(adapters, dev)
    loss_b, g_b, _ = gl.train_step_b(cfg32, spec_b, _to(params, dev), ad,
                                     _to(batch, dev))
    prop1 = 0.0   # max |A - B| / (atol + rtol |B|): allclose when <= 1
    for tap, w in g_b.items():
        for leaf, b in w.items():
            a = g_gpu[tap][leaf]
            ratio = float(((a - b).abs() / (1e-6 + 2e-4 * b.abs())).max())
            prop1 = max(prop1, ratio)
            check(ratio <= 1, f"Prop 1 on the card: {tap}.{leaf} Mode A vs "
                  f"Mode B beyond rtol 2e-4, atol 1e-6 ({ratio:.3g} x)")
    check(abs(float(loss_b) - loss_gpu) <= 1e-6 * abs(loss_gpu),
          f"Mode B loss {float(loss_b)} vs Mode A {loss_gpu}")
    print(f"[train-vs-plain] f32 full width, batch 2 x 128: loss card "
          f"{loss_gpu:.7f} CPU {loss_cpu:.7f} (|diff| {loss_diff:.3e}); fit "
          f"grads max |card - CPU| / max |CPU| {worst:.3e} (tol 1e-3); Prop 1 on "
          f"the card: max |A - B| / (1e-6 + 2e-4 |B|) = {prop1:.3f} (<= 1)",
          flush=True)


def time_channel_checks():
    """Time every check of ``OffloadChannel`` (a payload's checksums and
    finiteness, a returned bank's finiteness and update norm): host time
    from a sync before the check to its result, so it reads the check alone
    and not the device work queued before it. Returns (the times in ms by
    kind, "payload" and "bank", a function that removes the timing)."""
    from repro_torch.core import channel

    ms: dict[str, list[float]] = {"payload": [], "bank": []}
    originals = {"payload": channel._tree_stats, "bank": channel._bank_stats}

    def timed(fn, into):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    channel._tree_stats = timed(originals["payload"], ms["payload"])
    channel._bank_stats = timed(originals["bank"], ms["bank"])

    def untimed():
        channel._tree_stats = originals["payload"]
        channel._bank_stats = originals["bank"]

    return ms, untimed


def checks_line(ms: dict, steps: int) -> str:
    """The channel's checks: host ms a step, and each kind's p50 a check."""
    total = sum(sum(v) for v in ms.values())
    kinds = ", ".join(f"{k} p50 {statistics.median(v):.3f} ms x {len(v)}"
                      for k, v in ms.items() if v)
    return (f"channel checks {total / steps:.3f} ms of host time a step "
            f"({kinds})")


# ---------------------------------------------------------------------------
# phase 9: the fault-tolerant training runtime
# ---------------------------------------------------------------------------

RUNTIME_STEPS = 6
RUNTIME_ZERO = ("send_retries", "late_deliveries", "dup_discarded",
                "rollbacks", "corrupt_rejected", "nan_rejected", "late_dropped",
                "dead_letters", "fit_rejected", "refused_quarantined",
                "fit_timeouts", "fit_errors")
RUNTIME_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv", "cola_fit", "multi_lora",
                   "decode_attention")


def _adamw():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import optimizers

    tc = TrainConfig()
    return optimizers.adamw(tc.lr, b1=tc.b1, b2=tc.b2, eps=tc.eps,
                            weight_decay=tc.weight_decay)


def _policy(**kw):
    from repro_torch.runtime.faults import RetryPolicy

    return RetryPolicy(**{"max_attempts": 6, "timeout_ticks": 2,
                          "backoff_base": 0.0, "sleep": lambda s: None, **kw})


def _collab_run(cfg, params, batches, dev, *, injector=None, user0=False,
                fit_ms=None, telemetry=None):
    """Six steps of a K = 4 merged ``CollabSession`` (rank-8 ``qv``,
    interval 1, AdamW at TrainConfig's settings). With ``fit_ms``, every fit
    round is timed between syncs into it. Returns (session, losses, step
    ms)."""
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.collab import CollabSession

    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=1, users=4)
    sess = CollabSession(cfg, cc, params, seed=SEED, optimizer=_adamw(),
                         injector=injector, policy=_policy(), device=dev,
                         telemetry=telemetry)
    if fit_ms is not None:
        for ch in sess.channels:
            def timed(fn=ch.fit_round):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                fit_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            ch.fit_round = timed
    losses, step_ms = [], []
    for b in batches:
        b = dict(b)
        uid = b.pop("user_id")
        if user0:
            uid = torch.zeros_like(uid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(sess.train_step(b, uid))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return sess, losses, step_ms


def _bank_leaves(sess) -> list[list]:
    from repro_torch.utils import sorted_leaves

    return [[t.clone() for t in sorted_leaves(ch.adapters)]
            for ch in sess.channels]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _runtime_collab(cfg, params, dev) -> dict:
    """(a) determinism, (b) recoverable faults, (c) a poisoned peer and its
    banks served. Returns the figures to print."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.faults import (SINGLE_FAULTS, FaultInjector,
                                            FaultProfile)
    from repro_torch.runtime.serve_loop import ServeEngine, publish_banks

    data = SyntheticLM(cfg, batch=32, seq=128, users=4, seed=SEED, device=dev)
    batches = [data.batch_at(i) for i in range(RUNTIME_STEPS)]

    # (a) two fault-free runs: equal bits; the second times its fit rounds
    # and the channel's checks
    ref, ref_losses, step_ms = _collab_run(cfg, params, batches, dev)
    ref_banks = _bank_leaves(ref)
    fit_ms: list[float] = []
    check_ms, untimed = time_channel_checks()
    try:
        again, losses, _ = _collab_run(cfg, params, batches, dev,
                                       fit_ms=fit_ms)
    finally:
        untimed()
    check(losses == ref_losses, f"[runtime] (a) losses of two fault-free "
          f"runs differ: {ref_losses} vs {losses}")
    check(all(_equal(a, b) for a, b in zip(_bank_leaves(again), ref_banks)),
          "[runtime] (a) banks of two fault-free runs differ")
    check(ref.bank_versions() == [RUNTIME_STEPS] * 4,
          f"[runtime] (a) versions {ref.bank_versions()}")
    del again
    print(f"[runtime] (a) K 4, {RUNTIME_STEPS} steps, batch 32 x 128: two "
          f"fault-free runs equal bit for bit; losses "
          f"{[round(x, 4) for x in ref_losses]}", flush=True)

    # (b) drop, delay and duplicate: recovered, bit for bit, JAX's counters
    inj = FaultInjector({1: SINGLE_FAULTS["drop"], 2: SINGLE_FAULTS["delay"],
                         3: SINGLE_FAULTS["duplicate"]}, seed=0)
    sess, losses, _ = _collab_run(cfg, params, batches, dev, injector=inj)
    hs = sess.channel_health()
    want = {1: {"send_retries": 12}, 2: {"late_deliveries": 4},
            3: {"dup_discarded": 4}}
    got = {k: {c: hs[k][c] for c in RUNTIME_ZERO if hs[k][c]} for k in hs}
    check(inj.injected == {"drop": 12, "delay": 4, "duplicate": 8,
                           "corrupt": 0, "nan": 0},
          f"[runtime] (b) injected {inj.injected}")
    check(got == {k: want.get(k, {}) for k in range(4)},
          f"[runtime] (b) counters {got}")
    check(sess.bank_versions() == [RUNTIME_STEPS] * 4,
          f"[runtime] (b) versions {sess.bank_versions()}")
    check(losses == ref_losses and all(
        _equal(a, b) for a, b in zip(_bank_leaves(sess), ref_banks)),
        "[runtime] (b) recovered faults changed the banks or losses")
    print(f"[runtime] (b) drop/delay/duplicate on users 1/2/3: injected "
          f"{inj.injected}; counters {got}; banks and losses equal (a)'s",
          flush=True)
    del sess

    # (c) user 1's returns poisoned, every row to user 0
    clean, clean_losses, _ = _collab_run(cfg, params, batches, dev, user0=True)
    inj = FaultInjector({1: FaultProfile(nan=1.0, targets=("adapters",))},
                        seed=0)
    sess, losses, _ = _collab_run(cfg, params, batches, dev, injector=inj,
                                  user0=True)
    h1 = sess.channel_health()[1]
    got1 = {c: h1[c] for c in RUNTIME_ZERO if h1[c]}
    check(h1["quarantined"] and h1["version"] == 0 and got1 == {
        "rollbacks": 2, "fit_rejected": 12, "refused_quarantined": 4,
        "dead_letters": 2} and len(sess.channels[1].dead_letters) == 2,
        f"[runtime] (c) user 1: {h1}")
    check(sess.bank_versions() == [RUNTIME_STEPS, 0, RUNTIME_STEPS,
                                   RUNTIME_STEPS],
          f"[runtime] (c) versions {sess.bank_versions()}")
    check(losses == clean_losses and _equal(_bank_leaves(sess)[0],
                                            _bank_leaves(clean)[0]),
          "[runtime] (c) the poisoned peer perturbed user 0")
    del clean

    # the committed banks into a 16-slot f32-bank engine on the initial ones
    # (those of a session that has taken no step)
    init = [off.adapters for off in _collab_run(cfg, params, [], dev)[0]
            .offloaders]
    eng = ServeEngine(cfg, params, slots=16, max_len=1024, user_adapters=init,
                      device=dev)
    installed = publish_banks(eng, sess.channels)
    check(installed == 3 and eng.bank_versions.tolist() == [
        RUNTIME_STEPS, 0, RUNTIME_STEPS, RUNTIME_STEPS],
        f"[runtime] (c) installed {installed}, versions "
        f"{eng.bank_versions.tolist()}")
    for tap, e in eng.bank.items():
        for name, leaf in e.items():
            check(torch.equal(leaf[:, 1], init[1][tap][name]),
                  f"[runtime] (c) user 1's row of {tap}.{name} changed")
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (24, 57, 130)]
    tokens = {}
    for u in range(4):
        reqs, _ = drive(eng, prompts, [u] * len(prompts), 8)
        check(all(r.status == "done" and len(r.out) == 8 for r in reqs),
              f"[runtime] (c) user {u}'s requests did not finish")
        tokens[u] = [r.out for r in reqs]
    solo = _one_user(cfg, params, init[1], prompts, dev, max_new=8)
    check(tokens[1] == solo, "[runtime] (c) user 1's tokens differ from a "
          "one-user engine on its initial bank")
    print(f"[runtime] (c) nan on user 1's returns, rows to user 0: user 1 "
          f"quarantined at version 0, {got1}; user 0 equal to the fault-free "
          f"run; publish_banks installed {installed}, bank_versions "
          f"{eng.bank_versions.tolist()}, user 1 serves its initial bank "
          f"(tokens equal a one-user engine)", flush=True)
    return {"step_ms": step_ms, "fit_ms": fit_ms, "check_ms": check_ms}


def _runtime_restart(cfg, params, dev) -> dict:
    """(d) TrainLoop over a Mode A ColaSession: 4 steps against 2 + a resume
    to 4, the straggler hook, a fit on the worker thread. Returns the
    checkpoint's save and restore ms."""
    import tempfile

    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.train_loop import TrainLoop
    from repro_torch.utils import sorted_leaves

    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=1)
    data = SyntheticLM(cfg, batch=32, seq=128, seed=SEED, device=dev)

    def session(**kw):
        return ColaSession(cfg, cc, params, seed=SEED, optimizer=_adamw(),
                           device=dev, **kw)

    def state(sess):
        off = sess.offloader
        return ([t.clone() for t in sorted_leaves(off.adapters)]
                + [t.clone() for t in sorted_leaves(
                    {k: v for k, v in off.opt_state.items() if k != "step"})],
                off.opt_state["step"])

    with tempfile.TemporaryDirectory() as d:
        full = TrainLoop(session(), data, f"{d}/a", ckpt_every=2)
        full.run(4, resume=False)
        TrainLoop(session(), data, f"{d}/b", ckpt_every=2).run(2, resume=False)
        resumed = TrainLoop(session(), data, f"{d}/b", ckpt_every=2)
        resumed.run(4, resume=True)
        (want, want_step), (got, got_step) = state(full.session), state(
            resumed.session)
        check(resumed.session.step_count == 4 and got_step == want_step == 4
              and type(got_step) is int and _equal(got, want)
              and resumed.losses == full.losses[2:],
              "[runtime] (d) the resumed run differs from the uninterrupted")

        sess = full.session
        sess.channel.quarantined = True
        full._on_straggler(4, 9.9, 0.1)
        full.ckpt.wait()
        check(full.ckpt.latest_step() == 4 and not sess.channel.quarantined
              and full.recoveries == 1,
              "[runtime] (d) the straggler hook did not checkpoint and reset")

        save_ms, restore_ms = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full.ckpt.save(5, full._state())
            save_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            step, tree = full.ckpt.restore(5)
            full._load_state(tree)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        check(_equal(state(sess)[0], want), "[runtime] (d) a restore changed "
              "the state")

    # one fit on the worker thread (timeout_s) against the same thread
    banks = []
    for policy in (None, _policy(timeout_s=60.0)):
        s = session(policy=policy)
        s.step(data.batch_at(0))
        banks.append([t.clone() for t in sorted_leaves(s.adapters)])
    check(_equal(*banks), "[runtime] (d) the worker-thread fit differs")
    print(f"[runtime] (d) TrainLoop over Mode A: 2 steps + a resume to 4 equal "
          f"4 uninterrupted (adapters, AdamW state, step {got_step}); the "
          f"straggler hook checkpointed and lifted the quarantine; the fit on "
          f"the worker thread equals the same-thread fit", flush=True)
    return {"save_ms": save_ms, "restore_ms": restore_ms}


def phase_runtime(cfg, dev) -> dict:
    """Phase 9 at full width; returns the launch counts of the phase."""
    from repro_torch.models import model

    check(cfg.remat == "full" and cfg.param_dtype == "bfloat16",
          f"runtime config {cfg.remat}/{cfg.param_dtype}")
    params = model.init(cfg, seed=SEED, device=dev)
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    figs = _runtime_collab(cfg, params, dev)
    figs.update(_runtime_restart(cfg, params, dev))
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in ws.items()}
    print(f"[runtime] launches: {launches}", flush=True)
    for n in RUNTIME_KERNELS:
        check(launches[n] > 0, f"kernel {n} was never launched in [runtime]")
    fit = figs["fit_ms"]
    print(f"[runtime] collab step p50 {statistics.median(figs['step_ms']):.2f} "
          f"ms (K 4; steps {[round(t, 2) for t in figs['step_ms']]}); fit round "
          f"p50 {statistics.median(fit):.3f} ms a user ({len(fit)} rounds, "
          f"{sum(fit) / RUNTIME_STEPS:.3f} ms a step); "
          f"{checks_line(figs['check_ms'], RUNTIME_STEPS)}; checkpoint save p50 "
          f"{statistics.median(figs['save_ms']):.2f} ms, restore p50 "
          f"{statistics.median(figs['restore_ms']):.2f} ms; {card_line()}",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 10: telemetry through the serving paths and the training runtime
# ---------------------------------------------------------------------------

NAN_USER1 = dict(nan=1.0, targets=("adapters",))


def _host_values_only(tm) -> None:
    """No tensor reaches a record, a span argument or a metric (it would
    sync when a postmortem prints it, and keep device memory alive)."""
    def walk(v):
        check(not isinstance(v, torch.Tensor),
              f"[telemetry] a tensor in the telemetry: {v!r}")
        if isinstance(v, (dict, list)):
            for x in (v.values() if isinstance(v, dict) else v):
                walk(x)

    walk([tm.recorder.events(*k) for k in tm.recorder.keys()])
    walk([p["events"] for p in tm.recorder.postmortems])
    walk([ev.get("args", {}) for ev in (tm.tracer.events if tm.tracer else ())])
    walk(tm.snapshot())


def _span_table(tag: str, tm, names) -> dict:
    """Print the trace's rows of ``names`` (ms, host wall time) and return
    them by name; every name must have spans."""
    from repro_torch import trace_summary
    from repro_torch.telemetry import validate_trace

    doc = tm.tracer.to_doc()
    problems = validate_trace(doc)
    check(problems == [], f"[telemetry] {tag}: invalid trace {problems[:3]}")
    rows = {r["name"]: r for r in trace_summary.span_table(doc)}
    for n in names:
        check(n in rows, f"[telemetry] {tag}: no {n} span ({sorted(rows)})")
        r = rows[n]
        print(f"[telemetry] {tag} span {n}: count {r['count']}, total "
              f"{r['total_ms']:.2f} ms, mean {r['mean_ms']:.3f}, p50 "
              f"{r['p50_ms']:.3f}, p99 {r['p99_ms']:.3f}, max "
              f"{r['max_ms']:.3f} ms", flush=True)
    return rows


def count_syncs(fn) -> "collections.Counter":
    """Synchronising calls ``fn`` makes, as ``torch.cuda``'s sync debug mode
    reports them (one warning each), by the Python line that made them."""
    import gc
    import warnings

    gc.collect()            # no finalizer of an earlier run's objects inside
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def _telemetry_serving(cfg, dev, setup, want, tag, d, **options):
    """Phase 2's (or 6's) 32 requests with telemetry: the tokens of the
    telemetry-off run, a valid trace, JAX's counters, no postmortem."""
    from repro_torch.telemetry import Telemetry

    params, banks, prompts = setup
    tm = Telemetry(trace=True, out_dir=d)
    eng, reqs, _ = serve(cfg, params, banks, prompts, dev, slots=16,
                         max_len=1024, max_new=32, telemetry=tm, **options)
    check([r.out for r in reqs] == want,
          f"[telemetry] {tag}: tokens differ from the telemetry-off run's")
    snap = eng.telemetry_snapshot()
    check(snap["serve.completed"] == 32 and snap["serve.ttft_s"]["count"] == 32,
          f"[telemetry] {tag}: completed {snap['serve.completed']}, ttft "
          f"count {snap['serve.ttft_s']['count']}")
    check(tm.recorder.postmortems == [],
          f"[telemetry] {tag}: postmortems {tm.recorder.postmortems[:1]}")
    _host_values_only(tm)
    return tm, eng, snap


def _telemetry_chaos(cfg, params, dev, d) -> None:
    """Phase 9 (c)'s chaos run with telemetry: the same banks and losses,
    one quarantine postmortem (user 1) that names the failing seq ids. Runs
    off, on, on, off, so that the step times compare in turns."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.faults import FaultInjector, FaultProfile
    from repro_torch.telemetry import Telemetry

    data = SyntheticLM(cfg, batch=32, seq=128, users=4, seed=SEED, device=dev)
    batches = [data.batch_at(i) for i in range(RUNTIME_STEPS)]
    runs, step_ms = [], {False: [], True: []}
    for on, d_run in ((False, None), (True, d), (True, f"{d}-2"),
                      (False, None)):
        tm = Telemetry(trace=True, out_dir=d_run) if on else None
        sess, losses, ms = _collab_run(
            cfg, params, batches, dev, user0=True, telemetry=tm,
            injector=FaultInjector({1: FaultProfile(**NAN_USER1)}, seed=0,
                                   telemetry=tm))
        runs.append((_bank_leaves(sess), losses, sess if len(runs) == 1
                     else None, tm))
        step_ms[on].append(statistics.median(ms))
        del sess
    for banks, losses, _, _ in runs[1:]:
        check(losses == runs[0][1] and all(
            _equal(a, b) for a, b in zip(banks, runs[0][0])),
            "[telemetry] (c) telemetry changed the chaos run's banks or "
            "losses")
    sess, tm = runs[1][2], runs[1][3]
    pms = tm.recorder.postmortems
    quar = [p for p in pms if p["reason"].startswith("quarantined after")]
    check(len(quar) == 1 and (quar[0]["scope"], quar[0]["key"]) == ("user", 1),
          f"[telemetry] (c) quarantine postmortems {[p['reason'] for p in pms]}")
    pm = quar[0]
    kinds = [e["kind"] for e in pm["events"]]
    check({"fault_injected", "fit_rejected", "rollback", "quarantine"}
          <= set(kinds), f"[telemetry] (c) the postmortem's kinds {kinds}")
    failing = {e["seq"] for e in pm["events"]
               if e["kind"] in ("fit_rejected", "rollback")}
    last = sess.channels[1].health()["last_error_seq"]
    check(last in failing, f"[telemetry] (c) last_error_seq {last} not in "
          f"the postmortem's failing seqs {sorted(failing)}")
    with open(pm["path"]) as f:
        disk = json.load(f)
    check(disk["reason"] == pm["reason"]
          and [e["kind"] for e in disk["events"]] == kinds,
          "[telemetry] (c) the postmortem on disk differs")
    check(not any(p["scope"] == "user" and p["key"] == 0 for p in pms),
          "[telemetry] (c) a postmortem for user 0")
    _host_values_only(tm)
    print(f"[telemetry] (c) chaos K 4 (user 1 NaN-poisoned): banks and "
          f"losses of off, on, on, off equal; postmortems "
          f"{[(p['key'], p['reason'][:40]) for p in pms]}; the quarantine's "
          f"ring {len(kinds)} events, failing seqs {sorted(failing)}, "
          f"last_error_seq {last}; collab step p50 ms off "
          f"{[round(x, 2) for x in step_ms[False]]}, on "
          f"{[round(x, 2) for x in step_ms[True]]} (off, on, on, off)",
          flush=True)
    rows = _span_table("(c)", tm, ("session.offload_round", "channel.push",
                                   "channel.fit_round"))
    print(f"[telemetry] (c) offload rounds "
          f"{rows['session.offload_round']['total_ms'] / RUNTIME_STEPS:.2f} "
          f"ms a step, of the on-run's collab step p50 "
          f"{step_ms[True][0]:.2f} ms", flush=True)


def _telemetry_train_loop(cfg, params, dev, d):
    """(d) a TrainLoop over Mode A with telemetry writes telemetry.jsonl.
    Returns the session (its next step is profiled)."""
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.runtime.train_loop import TrainLoop
    from repro_torch.telemetry import Telemetry

    tm = Telemetry(out_dir=d)
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=1)
    sess = ColaSession(cfg, cc, params, seed=SEED, optimizer=_adamw(),
                       device=dev, telemetry=tm)
    data = SyntheticLM(cfg, batch=32, seq=128, seed=SEED, device=dev)
    TrainLoop(sess, data, f"{d}/loop", telemetry=tm).run(2, resume=False)
    with open(f"{d}/loop/telemetry.jsonl") as f:
        recs = [json.loads(line) for line in f]
    m = recs[-1]["metrics"]
    check(m["train.step_s"]["count"] == 2 and m["channel.u0.version"] == 2,
          f"[telemetry] (d) last telemetry.jsonl record {m}")
    _host_values_only(tm)
    print(f"[telemetry] (d) TrainLoop over Mode A, 2 steps: telemetry.jsonl "
          f"{len(recs)} records, train.step_s count "
          f"{m['train.step_s']['count']}, p50 {m['train.step_s']['p50'] * 1e3:.2f} "
          f"ms, channel.u0.version {m['channel.u0.version']}", flush=True)
    return sess, data.batch_at(2)


def _overhead(cfg, dev, setup) -> None:
    """Decode-tick and prefill p50 with telemetry off and on, in turns, three
    runs each (a reading, not a gate)."""
    from repro_torch.telemetry import Telemetry

    params, banks, prompts = setup
    p50 = {False: {"decode_tick": [], "prefill": []},
           True: {"decode_tick": [], "prefill": []}}
    for on in (False, True) * 3:
        eng, _, _ = serve(cfg, params, banks, prompts, dev, slots=16,
                          max_len=1024, max_new=16,
                          telemetry=Telemetry(trace=True) if on else None)
        tp = eng.throughput()
        for k in p50[on]:
            p50[on][k].append(tp[k]["p50"] * 1e3)
    for k in ("decode_tick", "prefill"):
        off, on = p50[False][k], p50[True][k]
        print(f"[telemetry] overhead {k} p50 ms (32 requests, 16 new tokens; "
              f"off, on in turns): off {[round(x, 2) for x in off]} median "
              f"{statistics.median(off):.2f} spread {max(off) - min(off):.2f}; "
              f"on {[round(x, 2) for x in on]} median "
              f"{statistics.median(on):.2f} spread {max(on) - min(on):.2f}",
              flush=True)


def _annotations(cfg, dev, setup, sess, batch) -> None:
    """``Telemetry(profiler_annotations=True)``: a torch.profiler run of one
    tick and one fit sees ``serve.decode`` and ``offload.fit``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve_loop import Request, ServeEngine
    from repro_torch.telemetry import Telemetry, enable_profiler_annotations

    params, banks, prompts = setup
    try:
        tm = Telemetry(profiler_annotations=True)
        eng = ServeEngine(cfg, params, slots=16, max_len=1024,
                          user_adapters=banks, device=dev, telemetry=tm)
        for i in range(2):
            eng.submit(Request(rid=i, user=i, prompt=prompts[i], max_new=4))
        eng.tick()                       # admission and prefill
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.tick()
            sess.step(batch)             # Mode A: push and fit, this thread
            torch.cuda.synchronize()
    finally:
        enable_profiler_annotations(False)
    names = {e.name for e in prof.events()}
    check({"serve.decode", "offload.fit"} <= names,
          f"[telemetry] profiler annotations missing: "
          f"{sorted(n for n in names if '.' in n and '::' not in n)[:20]}")
    print("[telemetry] torch.profiler sees serve.decode and offload.fit",
          flush=True)


def phase_telemetry(cfg, dev, setup, serve_tokens, scale_tokens) -> dict:
    """Phase 10 at full width; returns the launch counts of the phase."""
    import tempfile

    from repro_torch.models import model

    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as d:
        # (a) dense serving, f32 bank
        tm, eng, _ = _telemetry_serving(cfg, dev, setup, serve_tokens, "(a)",
                                        f"{d}/a")
        print("[telemetry] (a) dense serving: tokens equal phase 2's; valid "
              "trace; serve.completed 32, serve.ttft_s count 32; no "
              "postmortem", flush=True)
        _span_table("(a)", tm, ("serve.tick", "serve.admit", "serve.decode",
                                "serve.prefill"))
        # (b) paged + chunked + int8
        tm, eng, snap = _telemetry_serving(cfg, dev, setup, scale_tokens,
                                           "(b)", f"{d}/b", **SCALE)
        pager = {k: snap[f"pager.{k}"] for k in eng.pager.stats}
        check(pager == eng.pager.stats, f"[telemetry] (b) pager.* {pager}")
        eng.pager.assert_empty()
        print(f"[telemetry] (b) paged + chunks of 128 + int8: tokens equal "
              f"phase 6's; pager.* == pager.stats {pager}; pool whole",
              flush=True)
        _span_table("(b)", tm, ("serve.tick", "serve.prefill_chunk",
                                "serve.decode"))
        # (c), (d)
        train_params = model.init(cfg, seed=SEED, device=dev)
        _telemetry_chaos(cfg, train_params, dev, f"{d}/c")
        sess, batch = _telemetry_train_loop(cfg, train_params, dev, f"{d}/d")

        # no sync added: one workload, off and on in turns, under sync debug
        # mode, after a counted warm-up (the first run under the mode made
        # one more call, at torch/cuda/__init__.py, telemetry off)
        from repro_torch.telemetry import Telemetry
        params, banks, prompts = setup

        def workload(on):
            serve(cfg, params, banks, prompts[:8], dev, slots=16,
                  max_len=1024, max_new=8,
                  telemetry=Telemetry(trace=True, out_dir=f"{d}/s")
                  if on else None)

        warm = count_syncs(lambda: workload(False))
        syncs = [count_syncs(lambda: workload(on))
                 for on in (False, True, False, True)]
        totals = [sum(c.values()) for c in syncs]
        check(syncs[0] == syncs[1] == syncs[2] == syncs[3] and totals[0] > 0,
              f"[telemetry] synchronising calls off, on, off, on {totals}: "
              f"off - on {syncs[0] - syncs[1]}, on - off {syncs[1] - syncs[0]}")
        print(f"[telemetry] synchronising calls (8 requests, 8 new tokens, "
              f"sync debug mode; off, on, off, on): {totals} (warm-up "
              f"{sum(warm.values())}, {dict(warm - syncs[0])} more), by line "
              f"{dict(syncs[1])}", flush=True)

        _overhead(cfg, dev, setup)
        _annotations(cfg, dev, setup, sess, batch)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in ws.items()}
    print(f"[telemetry] launches: {launches}; {card_line()}", flush=True)
    for n, c in launches.items():
        check(c > 0, f"kernel {n} was never launched in [telemetry]")
    return launches


# ---------------------------------------------------------------------------
# phases 11-14: gemma2's pairs plan (serving, training) and the other
# registered configs
# ---------------------------------------------------------------------------

GEMMA2_PAGED = dict(kv_layout="paged", kv_block=16, prefill_chunk=128,
                    bank_store="int8")


def _free() -> None:
    """Give the caching allocator's blocks back before the next model."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _gemma2_prompts(cfg, n: int, lo: int, hi: int, seed: int, long=()):
    """``n`` seeded prompts of ``lo``-``hi`` tokens; ``long`` sets the
    lengths of the first few (prompts past the local window)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    lens[:len(long)] = long
    return [rng.integers(0, cfg.vocab_size, int(m)).astype(np.int32)
            for m in lens]


def _counted(fn) -> tuple:
    """Run ``fn`` with every kernel's launch count (the ring decode's too)
    reset just before and read just after; returns (fn's result, counts)."""
    from repro_torch.kernels import decode_attention as da

    ws = dict(wrappers(), decode_attention_ring=da.decode_attention_ring)
    for w in ws.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: w.launches for n, w in ws.items()}


def phase_gemma2(dev) -> dict:
    """gemma2-9b at full width and depth (42 layers, d_model 3584, bf16,
    seeded random weights), 4 users' rank-8 qv adapters, 8 slots, max_len
    6144, 12 requests of 256-4800 tokens (two past the 4096 window, so the
    local window masks and the rings wrap), 16 new tokens each: (a) dense KV
    and an f32 bank, (b) paged KV in blocks of 16, chunks of 128, rings for
    the local stack and an int8 bank. Returns the launch counts of both."""
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.utils import tree_leaves

    cfg = registry.get_config("gemma2-9b")
    params = model.init(cfg, seed=SEED, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    banks = user_banks(cfg, 4, dev, SEED)
    prompts = _gemma2_prompts(cfg, 12, 256, 4800, SEED, long=(4800, 4400))
    total = {}
    for tag, opts, ran, idle in (
            ("(a) dense KV, f32 bank", {},
             ("flash_attention", "decode_attention", "multi_lora"),
             ("decode_attention_paged", "decode_attention_ring",
              "multi_lora_q8")),
            ("(b) paged KV + rings, chunks of 128, int8 bank", GEMMA2_PAGED,
             ("flash_attention", "decode_attention_paged",
              "decode_attention_ring", "multi_lora_q8"),
             ("decode_attention", "multi_lora"))):
        torch.cuda.reset_peak_memory_stats(dev)
        (eng, reqs, peak_bytes), launches = _counted(lambda: serve(
            cfg, params, banks, prompts, dev, slots=8, max_len=6144,
            max_new=16, **opts))
        check(all(r.status == "done" and len(r.out) == 16 for r in reqs),
              f"[gemma2] {tag}: not every request finished with 16 tokens")
        check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
              f"[gemma2] {tag}: a token outside the vocabulary")
        for n in ran:
            check(launches[n] > 0, f"[gemma2] {tag}: {n} never launched")
        for n in idle:
            check(launches[n] == 0, f"[gemma2] {tag}: {n} ran {launches[n]} "
                  "times")
        cache = {s: tuple(e["k"].shape) for s, e in eng.cache.items()}
        cache_bytes = sum(l.numel() * l.element_size()
                          for e in eng.cache.values() for l in e.values())
        if eng.pager is not None:
            st = eng.stats
            check(st["kv_allocs"] == st["kv_frees"] > 0,
                  f"[gemma2] {tag}: kv allocs {st['kv_allocs']} != frees "
                  f"{st['kv_frees']}")
            eng.pager.assert_empty()
        tp = eng.throughput()
        print(f"[gemma2] {tag}: gemma2-9b bf16, 42 layers, {n_params} "
              f"parameters, 8 slots, 4 users, 12 requests (prompts "
              f"{sorted(len(p) for p in prompts)}): {tp['completed']} "
              f"completed, decode {tp['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{tp['ttft']['p50'] * 1e3:.1f} ms, decode tick p50 "
              f"{tp['decode_tick']['p50'] * 1e3:.2f} ms, prefill calls "
              f"{eng.stats['prefill_calls']}, chunk rounds "
              f"{eng.stats['chunk_rounds']}, prefill call / chunk round p50 "
              f"{tp['prefill']['p50'] * 1e3:.2f} ms; {card_line()}", flush=True)
        print(f"[gemma2] {tag}: cache {cache} = {cache_bytes} bytes, "
              f"kv_cache_bytes at peak {peak_bytes}; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
              f"launches {launches}", flush=True)
        total = {n: total.get(n, 0) + c for n, c in launches.items()}
        del eng, reqs
        _free()
    del params, banks
    _free()
    return total


def _recording_engine():
    """A ServeEngine that keeps every step's next-token logits of the rows
    it ran for (on the host)."""
    from repro_torch.runtime.serve_loop import ServeEngine

    class Recording(ServeEngine):
        def __init__(self, *a, **kw):
            self.logits = []
            super().__init__(*a, **kw)

        def _step_logits(self, tokens, positions, users, live, lens=None):
            out = super()._step_logits(tokens, positions, users, live, lens)
            self.logits.append(out[live].float().cpu())
            return out

    return Recording


def _plain_setup(name: str, n_layers: int, lens, prompt_seed: int) -> tuple:
    """The f32 model at full width cut to ``n_layers``, its seeded weights on
    the CPU, seeded prompts of ``lens`` tokens and 2 users' banks: the same
    on the card's side of a comparison and in the CPU worker."""
    from repro_torch.configs import registry
    from repro_torch.models import model

    cfg = registry.get_config(name).replace(
        n_layers=n_layers, param_dtype="float32", compute_dtype="float32")
    params = model.init(cfg, seed=SEED + 1, device="cpu")
    rng = np.random.default_rng(prompt_seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    return cfg, params, prompts, user_banks(cfg, 2, "cpu", SEED + 1)


def _engine_run(tag, label, cfg, params, banks, prompts, device, kw, opts,
                routing: bool = False) -> dict:
    """Serve ``prompts`` to completion on the recording engine: every
    request done with its ``max_new`` tokens, the pool whole at the end.
    Returns the tokens, each step's next-token logits, the engine's stats,
    the routing records (with ``routing``) and the seconds it took."""
    records, restore = _routing_recorder() if routing else ([], None)
    t0 = time.perf_counter()
    try:
        eng, reqs, _ = serve(cfg, params, banks, prompts, device,
                             engine=_recording_engine(), **kw, **opts)
    finally:
        if restore is not None:
            restore()
    check(all(r.status == "done" and len(r.out) == kw["max_new"]
              for r in reqs), f"{tag} {label}: not every request finished")
    if eng.pager is not None:
        eng.pager.assert_empty()
    return dict(tokens=[r.out for r in reqs], logits=eng.logits,
                stats=dict(eng.stats), records=records,
                secs=time.perf_counter() - t0)


GEMMA2_PLAIN = ("gemma2-9b", 2, (200, 1500, 4400), SEED + 1)
GEMMA2_PLAIN_KW = dict(slots=2, max_len=4608, max_new=8)
GEMMA2_PLAIN_RUNS = {"dense": {}, "paged": GEMMA2_PAGED}


def _cpu_gemma2_vs_plain() -> dict:
    """The CPU half of phase 12: its dense and its paged engine."""
    cfg, params, prompts, banks = _plain_setup(*GEMMA2_PLAIN)
    return {f"cpu {n}": _engine_run("[gemma2-vs-plain]", f"cpu {n}", cfg,
                                    params, banks, prompts, "cpu",
                                    GEMMA2_PLAIN_KW, opts)
            for n, opts in GEMMA2_PLAIN_RUNS.items()}


def phase_gemma2_vs_plain(dev) -> None:
    """gemma2-9b in f32 at full width with the depth cut to 2 layers (1
    pair: a local and a global layer, the CPU runs every engine too), three
    requests of 200 / 1500 / 4400 tokens (the last past the 4096 window),
    8 new tokens, 2 slots: the card's dense engine against the CPU's, the
    card's paged + chunks of 128 + rings + int8 engine against the CPU's
    same engine (the CPU's from the worker), and on the card paged + rings
    against dense with the same chunks and int8 bank (the KV layout alone
    differs): equal greedy tokens; prints the largest next-token logit gap
    of each."""
    tag = "[gemma2-vs-plain]"
    cfg, params_cpu, prompts, banks_cpu = _plain_setup(*GEMMA2_PLAIN)
    params_gpu = _to(params_cpu, dev)
    banks_gpu = [_to(b, dev) for b in banks_cpu]
    out = {}
    for name, opts in (("card dense", GEMMA2_PLAIN_RUNS["dense"]),
                       ("card paged", GEMMA2_PLAIN_RUNS["paged"]),
                       ("card dense, chunks of 128, int8",
                        dict(prefill_chunk=128, bank_store="int8"))):
        out[name] = _engine_run(tag, name, cfg, params_gpu, banks_gpu,
                                prompts, dev, GEMMA2_PLAIN_KW, opts)
        print(f"{tag} {name}: {out[name]['secs']:.1f} s", flush=True)
    for name, run in cpu_half("gemma2-vs-plain").items():
        print(f"{tag} {name}: {run['secs']:.1f} s", flush=True)
        out[name] = run
    for a, b in (("card dense", "cpu dense"), ("card paged", "cpu paged"),
                 ("card paged", "card dense, chunks of 128, int8")):
        toks, lg = out[a]["tokens"], out[a]["logits"]
        toks_o, lg_o = out[b]["tokens"], out[b]["logits"]
        steps = min(len(lg), len(lg_o))
        gap = (max(float((x - y).abs().max()) for x, y in zip(lg, lg_o))
               if len(lg) == len(lg_o) else None)
        top = max(float(x.abs().max()) for x in lg[:steps])
        print(f"{tag} f32, 2 layers at full width: {a} vs {b}: "
              f"tokens equal {toks == toks_o}; largest next-token logit gap "
              f"{gap if gap is None else f'{gap:.3e}'} (max |logit| {top:.3f})"
              f" over {len(lg)} / {len(lg_o)} steps", flush=True)
        check(toks == toks_o, f"{tag} greedy tokens differ, {a} "
              f"vs {b}: {toks} vs {toks_o}")
    del params_gpu, banks_gpu
    _free()


GEMMA2_TRAIN_STEPS = 4


def _tap_stats(sess, per_call: bool = False) -> list:
    """Wrap the session's channel push so that every pushed payload leaves,
    per tap, device flags (x finite, grad_h finite, grad_h non-zero; with
    ``per_call``, non-zero at every index of its leading axis: each call of
    zamba2's shared block), read after the steps: no sync inside a step."""
    flags = []
    push = sess.channel.push

    def nonzero(g):
        return (g.flatten(1) != 0).any(1).all() if per_call else (g != 0).any()

    def pushed(data):
        flags.append({t: torch.stack([x.isfinite().all(), g.isfinite().all(),
                                      nonzero(g)])
                      for t, (x, g) in data.items()})
        return push(data)

    sess.channel.push = pushed
    return flags


def _gemma2_train_full(dev) -> dict:
    """(a): gemma2-9b at full width and depth, bf16, remat "full", Mode A
    merged rank-8 qv, interval 1, AdamW, 1 x 4608, a warm-up step then the
    measured steps, each with its fit (``_measured_steps``); every step's
    taps checked (``_tap_stats``). Returns the launch counts."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model
    from repro_torch.profile_train import SETUPS

    cfg = registry.get_config("gemma2-9b")
    batch, seq, interval = SETUPS[cfg.name]   # 1 x 4608: past the 4096 window
    check(cfg.remat == "full" and cfg.param_dtype == "bfloat16"
          and cfg.loss_chunk == 512, f"gemma2 training config {cfg.remat}/"
          f"{cfg.param_dtype}/{cfg.loss_chunk}")
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=interval)
    sess = ColaSession(cfg, cc, model.init(cfg, seed=SEED, device=dev),
                       seed=SEED, device=dev, optimizer=_adamw())
    taps = sorted(sess.adapters)
    check(taps == ["layers_a.attn.q", "layers_a.attn.v", "layers_b.attn.q",
                   "layers_b.attn.v"], f"[gemma2-train] taps {taps}")
    data = SyntheticLM(cfg, batch=batch, seq=seq, seed=SEED, device=dev)
    flags = _tap_stats(sess)
    m = _measured_steps(sess, [data.batch_at(i) for i in
                               range(GEMMA2_TRAIN_STEPS + 1)], dev)
    losses, step_ms, fit_ms = m["losses"], m["step_ms"], m["fit_ms"]
    launches = m["launches"]

    n = GEMMA2_TRAIN_STEPS
    check(all(np.isfinite(losses)), f"[gemma2-train] non-finite loss: {losses}")
    check(len(fit_ms) == n, f"[gemma2-train] {len(fit_ms)} fits in {n} steps")
    bad = [(i, t) for i, f in enumerate(flags) for t, v in f.items()
           if not bool(v.all())]
    check(len(flags) == n + 1 and not bad, f"[gemma2-train] a tap's x or "
          f"grad_h not finite, or grad_h all zero (step, tap): {bad}")
    health = sess.channel_health()[0]
    check(health["fits_committed"] == n + 1 and all(
        health[k] == 0 for k in ("rollbacks", "dead_letters", "send_retries")),
        f"[gemma2-train] offload rounds failed: {health}")
    # a step: 42 forwards and their 42 recomputes, 42 of each backward
    # kernel; a fit: one cola_fit launch per tap of each stack
    want = {"flash_attention": 84 * n, "flash_attention_bwd_dq": 42 * n,
            "flash_attention_bwd_dkv": 42 * n, "cola_fit": 4 * n}
    check(all(launches[k] == v for k, v in want.items()),
          f"[gemma2-train] launches {launches}, want {want}")
    tokens = n * batch * seq
    print(f"[gemma2-train] (a) gemma2-9b bf16, 42 layers, remat full, Mode A "
          f"merged rank-8 qv on both stacks, interval {interval}, AdamW, batch "
          f"{batch} x {seq}: losses {[round(x, 5) for x in losses]}; every "
          f"tap's x and grad_h finite, grad_h non-zero; the bank moved at "
          f"every fit", flush=True)
    print(f"[gemma2-train] (a) step ms {[round(t, 1) for t in step_ms]}; server "
          f"step p50 {statistics.median(m['server_ms']):.1f} ms; fit ms "
          f"{[round(t, 2) for t in fit_ms]} (p50 {statistics.median(fit_ms):.2f})"
          f"; {checks_line(m['check_ms'], n)}; "
          f"{tokens / (sum(step_ms) / 1e3):.1f} training tokens/s; peak memory "
          f"{m['peak'] / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); {card_line()}", flush=True)
    print(f"[gemma2-train] (a) launches in {n} steps: {launches}", flush=True)
    del sess
    _free()
    return launches


def _session_step(cfg, cc, params, batch, device, tag) -> dict:
    """One step of a merged ``ColaSession`` on ``device`` (the merged server
    step, the push through the channel, the fit and AdamW) from ``params``
    and a bank whose B is drawn != 0 the same way on every device (so dA
    carries information). Returns the session, the bank before and after,
    the loss, each tap's grad_h, the fit gradients (``gl.fit_grads`` on the
    pushed payload and the bank before, as the offloader's fit computes
    them) and the seconds the step took."""
    from repro_torch.core import gl
    from repro_torch.core.session import ColaSession

    sess = ColaSession(cfg, cc, params, seed=SEED + 2, device=device,
                       optimizer=_adamw())
    gen = torch.Generator().manual_seed(SEED + 2)
    for tap in sorted(sess.adapters):
        B = torch.randn(sess.adapters[tap]["B"].shape, generator=gen) * 0.02
        # in place: the offloader and its channel hold these tensors too
        sess.adapters[tap]["B"].copy_(B)
        sess.offloader.adapters[tap]["B"].copy_(B)
    bank0 = {t: {k: v.clone() for k, v in w.items()}
             for t, w in sess.adapters.items()}
    pushed = []
    push = sess.channel.push
    sess.channel.push = lambda data: (pushed.append(data), push(data))[1]
    t0 = time.perf_counter()
    loss = sess.step(_to(batch, device))
    secs = time.perf_counter() - t0
    check(sess.offloader.stats["fits"] == 1
          and sess.channel_health()[0]["fits_committed"] == 1,
          f"{tag} on {device}: the fit did not commit")
    (data,) = pushed
    grads = gl.fit_grads(sess.offloader.spec, bank0, data)
    return dict(sess=sess, bank0=bank0, loss=loss, secs=secs,
                grad_h={t: g.cpu() for t, (_, g) in data.items()},
                fit=_to(grads, "cpu"), bank=_to(sess.adapters, "cpu"))


def _gemma2_train_plain_setup() -> tuple:
    """(b)'s config (f32, 2 layers), merged rank-8 qv ColA, seeded weights
    on the CPU and (a)'s batch shape of SyntheticLM."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model
    from repro_torch.profile_train import SETUPS

    batch_size, seq, _ = SETUPS["gemma2-9b"]
    cfg = registry.get_config("gemma2-9b").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=1)
    params = model.init(cfg, seed=SEED + 2, device="cpu")
    batch = SyntheticLM(cfg, batch=batch_size, seq=seq, seed=SEED + 2,
                        device="cpu").batch_at(0)
    return cfg, cc, params, batch


def _cpu_gemma2_train() -> dict:
    """The CPU half of phase 13 (b): the merged session step."""
    out = _session_step(*_gemma2_train_plain_setup(), "cpu",
                        "[gemma2-train] (b)")
    del out["sess"]
    return out


def _gemma2_train_vs_plain(dev) -> None:
    """(b): gemma2-9b in f32 at full width, depth cut to 2 layers (1 pair),
    at (a)'s batch shape: one step of a merged rank-8 qv ``ColaSession``
    (``_session_step``) on the card and on the CPU (plain versions):
    the losses within 1e-5; each tap's grad_h and fit gradients within
    phase 5's 1e-3 of the largest entry; the bank after the fit and AdamW
    within 1e-3 of its largest entry wherever the CPU's gradient is larger
    than the card-vs-CPU gap of that gradient (so both devices see its
    sign), and within AdamW's step, 2 lr, elsewhere (its first step is
    lr g / (|g| + eps), the sign of a gradient the two devices do not
    resolve there). Then on the card the unmerged Mode A server step: its
    loss and fit gradients against the CPU's merged ones, and its fit
    gradients against Mode B's adapter gradients (Prop 1) at
    test_gl_equivalence.py's tolerance."""
    from repro_torch.configs.base import ColaConfig, TrainConfig
    from repro_torch.core import gl

    cfg, cc, params, batch = _gemma2_train_plain_setup()
    batch_size, seq = batch["tokens"].shape
    gpu = _session_step(cfg, cc, params, batch, dev, "[gemma2-train] (b)")
    cpu = cpu_half("gemma2-train")
    loss_diff = abs(gpu["loss"] - cpu["loss"])
    check(loss_diff <= 1e-5 * abs(cpu["loss"]),
          f"[gemma2-train] loss card {gpu['loss']} vs CPU {cpu['loss']}")
    worst = {"grad_h": 0.0, "fit": 0.0, "bank": 0.0}
    gaps = {}
    for tap in sorted(cpu["grad_h"]):
        pairs = [("grad_h", f"{tap} grad_h", gpu["grad_h"][tap],
                  cpu["grad_h"][tap])]
        pairs += [("fit", f"{tap}.{leaf}", gpu["fit"][tap][leaf], a)
                  for leaf, a in cpu["fit"][tap].items()]
        for kind, what, got, want in pairs:
            err, scale = max_err(got, want)
            check(scale > 0 and err <= 1e-3 * scale, f"[gemma2-train] {what}: "
                  f"card vs CPU max |diff| {err:.3g} > 1e-3 x {scale:.3g}")
            worst[kind] = max(worst[kind], err / scale)
            gaps[what] = err
    lr = TrainConfig().lr
    unresolved = total = 0
    for tap, w in cpu["bank"].items():
        for leaf, want in w.items():
            got = gpu["bank"][tap][leaf]
            check(bool((got != gpu["bank0"][tap][leaf].cpu()).any()),
                  f"[gemma2-train] the card's fit left {tap}.{leaf} as it was")
            sure = cpu["fit"][tap][leaf].abs() > gaps[f"{tap}.{leaf}"]
            diff = (got - want).abs()
            scale = float(want.abs().max())
            err = float(diff[sure].max())
            rest = float(diff[~sure].max()) if bool((~sure).any()) else 0.0
            check(err <= 1e-3 * scale and rest <= 2 * lr * (1 + 1e-3),
                  f"[gemma2-train] bank {tap}.{leaf} after AdamW: card vs CPU "
                  f"max |diff| {err:.3g} (tol 1e-3 x {scale:.3g}) where the "
                  f"gradient's sign is resolved, {rest:.3g} (tol 2 lr) "
                  f"elsewhere")
            worst["bank"] = max(worst["bank"], err / scale)
            unresolved += int((~sure).sum())
            total += sure.numel()

    # the unmerged server step on the card, and Mode B (Prop 1)
    sess = gpu.pop("sess")
    bank0, b = gpu["bank0"], _to(batch, dev)
    spec_a = gl.make_spec(cfg, ColaConfig(mode="faithful_offload",
                                          family="lowrank", taps="qv", rank=8))
    loss_a, data, _ = gl.server_step_a(cfg, spec_a, sess.base_params, bank0,
                                       b)
    g_a = gl.fit_grads(sess.offloader.spec, bank0, data)
    del data
    check(abs(float(loss_a) - cpu["loss"]) <= 1e-5 * abs(cpu["loss"]),
          f"[gemma2-train] unmerged loss card {float(loss_a)} vs merged CPU "
          f"{cpu['loss']}")
    unmerged = 0.0
    for tap, w in cpu["fit"].items():
        for leaf, want in w.items():
            err, scale = max_err(g_a[tap][leaf].cpu(), want)
            check(err <= 1e-3 * scale, f"[gemma2-train] unmerged fit grad "
                  f"{tap}.{leaf}: card vs the CPU's merged step max |diff| "
                  f"{err:.3g} > 1e-3 x {scale:.3g}")
            unmerged = max(unmerged, err / scale)
    spec_b = gl.make_spec(cfg, ColaConfig(mode="fused_fit", family="lowrank",
                                          taps="qv", rank=8))
    loss_b, g_b, _ = gl.train_step_b(cfg, spec_b, sess.base_params, bank0, b)
    prop1 = 0.0   # max |A - B| / (atol + rtol |B|): allclose when <= 1
    for tap, w in g_b.items():
        for leaf, gb in w.items():
            ga = g_a[tap][leaf]
            ratio = float(((ga - gb).abs() / (1e-6 + 2e-4 * gb.abs())).max())
            prop1 = max(prop1, ratio)
            check(ratio <= 1, f"[gemma2-train] Prop 1 on the card: {tap}.{leaf}"
                  f" Mode A vs Mode B beyond rtol 2e-4, atol 1e-6 ({ratio:.3g} x)")
    check(abs(float(loss_b) - float(loss_a)) <= 1e-6 * abs(float(loss_a)),
          f"[gemma2-train] Mode B loss {float(loss_b)} vs Mode A "
          f"{float(loss_a)}")
    print(f"[gemma2-train] (b) f32, 2 layers at full width, {batch_size} x "
          f"{seq}, merged session step: loss card {gpu['loss']:.7f} CPU "
          f"{cpu['loss']:.7f} (|diff| {loss_diff:.3e}); max |card - CPU| / "
          f"max |CPU| over the 4 taps: grad_h {worst['grad_h']:.3e}, fit "
          f"grads {worst['fit']:.3e} (tol 1e-3), the bank after AdamW "
          f"{worst['bank']:.3e} (tol 1e-3; {unresolved} of {total} entries "
          f"where the devices do not resolve the gradient's sign, within 2 "
          f"lr); unmerged on the card: loss {float(loss_a):.7f}, fit grads "
          f"{unmerged:.3e} of the CPU's merged; Prop 1 on the card: max "
          f"|A - B| / (1e-6 + 2e-4 |B|) = {prop1:.3f} (<= 1); session step "
          f"{cpu['secs']:.1f} s on the CPU, {gpu['secs']:.2f} s on the card",
          flush=True)
    del sess, gpu, g_a, g_b
    _free()


def phase_gemma2_train(dev) -> dict:
    """gemma2-9b's ColA training on the card: (a) full width and depth, (b)
    against the plain path and Mode B at 2 layers. Returns (a)'s launch
    counts."""
    launches = _gemma2_train_full(dev)
    _gemma2_train_vs_plain(dev)
    return launches


def phase_configs(dev) -> dict:
    """Short ServeEngine runs of the other registered configs (8 requests
    of 32-512 tokens, 16 new tokens, 8 slots, 4 users' rank-8 qv adapters):
    gpt2-small at full size in f32 (its config's dtype: the f32 kernels),
    its card tokens equal to the CPU's; mistral-nemo-12b at full width and
    depth, bf16; mistral-large-123b at full width with its depth cut to 2
    layers, bf16 (the 88 layers do not fit one 80 GB card). Returns the
    launch counts of the card runs."""
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.utils import tree_leaves

    total = {}
    for name, depth in (("gpt2-small", None), ("mistral-nemo-12b", None),
                        ("mistral-large-123b", 2)):
        cfg = registry.get_config(name)
        if depth:
            cfg = cfg.replace(n_layers=depth)
        params = model.init(cfg, seed=SEED, device=dev)
        n_params = sum(t.numel() for t in tree_leaves(params))
        banks = user_banks(cfg, 4, dev, SEED)
        rng = np.random.default_rng(SEED + 2)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in rng.integers(32, 513, 8)]
        (eng, reqs, _), launches = _counted(lambda: serve(
            cfg, params, banks, prompts, dev, slots=8, max_len=1024,
            max_new=16))
        check(all(r.status == "done" and len(r.out) == 16 for r in reqs),
              f"[configs] {name}: not every request finished")
        for n in ("flash_attention", "decode_attention", "multi_lora"):
            check(launches[n] > 0, f"[configs] {name}: {n} never launched")
        tp = eng.throughput()
        same = ""
        if name == "gpt2-small":
            cpu, cpu_reqs, _ = serve(cfg, _to(params, "cpu"),
                                     [_to(b, "cpu") for b in banks], prompts,
                                     "cpu", slots=8, max_len=1024, max_new=16)
            same = [r.out for r in reqs] == [r.out for r in cpu_reqs]
            check(same, f"[configs] {name}: card tokens differ from the CPU's")
            same = "; card tokens == CPU tokens: True"
        print(f"[configs] {name} {cfg.param_dtype}, {cfg.n_layers} layers, "
              f"{n_params} parameters: {tp['completed']} completed, decode "
              f"{tp['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{tp['ttft']['p50'] * 1e3:.1f} ms, decode tick p50 "
              f"{tp['decode_tick']['p50'] * 1e3:.2f} ms{same}; launches "
              f"{launches}", flush=True)
        total = {n: total.get(n, 0) + c for n, c in launches.items()}
        del eng, reqs, params, banks
        _free()
    return total


# ---------------------------------------------------------------------------
# phases 15 and 16: the MoE blocks and QK-norm (qwen3-moe-30b-a3b, dbrx-132b)
# ---------------------------------------------------------------------------

MOE_TRAIN_STEPS = 2
# (label, options, kernels that must run, kernels that must not)
MOE_RUNS = (("dense KV, f32 bank", {},
             ("flash_attention", "decode_attention", "multi_lora"),
             ("decode_attention_paged", "decode_attention_ring",
              "multi_lora_q8")),
            ("paged KV, chunks of 128, int8 bank", SCALE,
             ("flash_attention", "decode_attention_paged", "multi_lora_q8"),
             ("decode_attention", "decode_attention_ring", "multi_lora")))


def _moe_serve(cfg, params, dev, tag, runs, check_calls=None) -> dict:
    """phase 14's load on a MoE config: 4 users' rank-8 qv adapters, 8
    slots, max_len 1024, 8 requests of 32-512 tokens (one prefill of 8 x
    512: eight 512-token routing groups), 16 new tokens each, once per
    entry of ``runs`` with the launch counts reset just before and read
    just after; ``check_calls(engine, label)``, where given, checks each
    run's engine before it goes. Returns the launch counts of all runs."""
    from repro_torch.utils import tree_leaves

    n_params = sum(t.numel() for t in tree_leaves(params))
    banks = user_banks(cfg, 4, dev, SEED)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(32, 513, 8)]
    total = {}
    for label, opts, ran, idle in runs:
        torch.cuda.reset_peak_memory_stats(dev)
        (eng, reqs, peak_bytes), launches = _counted(lambda: serve(
            cfg, params, banks, prompts, dev, slots=8, max_len=1024,
            max_new=16, **opts))
        check(all(r.status == "done" and len(r.out) == 16 for r in reqs),
              f"{tag} {label}: not every request finished with 16 tokens")
        check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
              f"{tag} {label}: a token outside the vocabulary")
        for n in ran:
            check(launches[n] > 0, f"{tag} {label}: {n} never launched")
        for n in idle:
            check(launches[n] == 0, f"{tag} {label}: {n} ran {launches[n]} "
                  "times")
        if eng.pager is not None:
            eng.pager.assert_empty()
        if check_calls is not None:
            check_calls(eng, label)
        tp = eng.throughput()
        print(f"{tag} {cfg.name} {cfg.param_dtype}, {cfg.n_layers} layers, "
              f"{n_params} parameters, {label}: {tp['completed']} completed, "
              f"decode {tp['decode_tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{tp['ttft']['p50'] * 1e3:.1f} ms, decode tick p50 "
              f"{tp['decode_tick']['p50'] * 1e3:.2f} ms, prefill calls "
              f"{eng.stats['prefill_calls']}, chunk rounds "
              f"{eng.stats['chunk_rounds']}, prefill call / chunk round p50 "
              f"{tp['prefill']['p50'] * 1e3:.2f} ms; largest kv_cache_bytes "
              f"{peak_bytes}; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
              f"{card_line()}", flush=True)
        print(f"{tag} {label}: launches {launches}", flush=True)
        total = {n: total.get(n, 0) + c for n, c in launches.items()}
        del eng, reqs
        _free()
    return total


def _cola_train(cfg, params, dev, tag, taps, want, per_call=False) -> dict:
    """A ColA warm-up step and MOE_TRAIN_STEPS measured steps at full width
    and depth (bf16, remat "full"), Mode A merged rank-8 qv (``taps``),
    interval 1, AdamW, SyntheticLM at the config's ``SETUPS`` shape, each
    step with its fit (``_measured_steps``); every step's taps checked
    (``_tap_stats``, grad_h at every call with ``per_call``); the launch
    counts exactly ``want(n_layers, steps)``. Returns the launch counts."""
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core.session import ColaSession
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.profile_train import SETUPS

    batch, seq, interval = SETUPS[cfg.name]
    check(cfg.remat == "full" and cfg.param_dtype == "bfloat16",
          f"{tag} training config {cfg.remat}/{cfg.param_dtype}")
    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=interval)
    sess = ColaSession(cfg, cc, params, seed=SEED, device=dev,
                       optimizer=_adamw())
    check(sorted(sess.adapters) == list(taps), f"{tag} taps "
          f"{sorted(sess.adapters)}")
    data = SyntheticLM(cfg, batch=batch, seq=seq, seed=SEED, device=dev)
    flags = _tap_stats(sess, per_call)
    m = _measured_steps(sess, [data.batch_at(i) for i in
                               range(MOE_TRAIN_STEPS + 1)], dev)
    losses, step_ms, fit_ms = m["losses"], m["step_ms"], m["fit_ms"]
    launches, n = m["launches"], MOE_TRAIN_STEPS
    check(all(np.isfinite(losses)), f"{tag} non-finite loss: {losses}")
    check(len(fit_ms) == n, f"{tag} {len(fit_ms)} fits in {n} steps")
    bad = [(i, t) for i, f in enumerate(flags) for t, v in f.items()
           if not bool(v.all())]
    check(len(flags) == n + 1 and not bad, f"{tag} a tap's x or grad_h "
          f"not finite, or grad_h all zero{' at a call' if per_call else ''}"
          f" (step, tap): {bad}")
    health = sess.channel_health()[0]
    check(health["fits_committed"] == n + 1 and all(
        health[k] == 0 for k in ("rollbacks", "dead_letters", "send_retries")),
        f"{tag} offload rounds failed: {health}")
    L = cfg.n_layers
    expected = want(L, n)
    check(all(launches[k] == v for k, v in expected.items()),
          f"{tag} launches {launches}, want {expected}")
    tokens = n * batch * seq
    aux = (f" (CE + {cfg.aux_loss_coef} x the MoE aux)" if cfg.n_experts
           else "")
    print(f"{tag} {cfg.name} bf16, {L} layers, remat full, Mode A merged "
          f"rank-8 qv ({', '.join(taps)}), interval {interval}, AdamW, batch "
          f"{batch} x {seq}: losses{aux} {[round(x, 5) for x in losses]}; "
          f"every tap's x and grad_h finite, grad_h non-zero"
          f"{' at every call' if per_call else ''}; the bank moved at every "
          f"fit", flush=True)
    print(f"{tag} step ms {[round(t, 1) for t in step_ms]} (p50 "
          f"{statistics.median(step_ms):.1f}); server step p50 "
          f"{statistics.median(m['server_ms']):.1f} ms; fit ms "
          f"{[round(t, 2) for t in fit_ms]} (p50 {statistics.median(fit_ms):.2f})"
          f"; {checks_line(m['check_ms'], n)}; "
          f"{tokens / (sum(step_ms) / 1e3):.1f} training tokens/s; peak memory "
          f"{m['peak'] / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"{card_line()}", flush=True)
    print(f"{tag} launches in {n} steps: {launches}", flush=True)
    del sess
    _free()
    return launches


def _moe_train(cfg, params, dev) -> dict:
    """(b): ``_cola_train`` on qwen3-moe: a step is 48 forwards and their
    48 recomputes and 48 of each backward kernel; a fit one cola_fit launch
    a tap."""
    return _cola_train(
        cfg, params, dev, "[moe] (b)", ("layers.attn.q", "layers.attn.v"),
        lambda L, n: {"flash_attention": 2 * L * n,
                      "flash_attention_bwd_dq": L * n,
                      "flash_attention_bwd_dkv": L * n, "cola_fit": 2 * n})


def phase_moe(dev) -> dict:
    """qwen3-moe-30b-a3b at full width and depth (48 layers, 128 experts
    top 8, QK-norm, bf16, seeded random weights; init drawn a layer of
    experts at a time, its peak memory printed): (a) phase 14's serving load
    with dense KV and an f32 bank, then paged KV, chunks of 128 and an int8
    bank; (b) ColA training (``_moe_train``); then (c) dbrx-132b at full
    width with the depth cut to 4 layers, served as in phase 14 (dense KV,
    f32 bank). Returns the launch counts of all runs."""
    from repro_torch.configs import registry
    from repro_torch.models import model

    cfg = registry.get_config("qwen3-moe-30b-a3b")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    print(f"[moe] qwen3-moe-30b-a3b init at full depth in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB of parameters, "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); {card_line()}", flush=True)
    total = _moe_serve(cfg, params, dev, "[moe] (a)", MOE_RUNS)
    train = _moe_train(cfg, params, dev)
    del params
    _free()

    cfg = registry.get_config("dbrx-132b").replace(n_layers=4)
    params = model.init(cfg, seed=SEED, device=dev)
    dbrx = _moe_serve(cfg, params, dev, "[moe] (c)", MOE_RUNS[:1])
    del params
    _free()
    return {n: total[n] + train.get(n, 0) + dbrx[n] for n in total}


def _routing_recorder():
    """Wrap ``moe._route`` so that every call also keeps, on the host, its
    expert ids and the router's k + 1 largest probabilities (one sync a
    call: for the comparison runs only). Returns (the records, a function
    that restores ``_route``)."""
    from repro_torch.models import moe

    inner = moe._route
    records = []

    def route(params, x, top_k):
        w, idx, aux = inner(params, x, top_k)
        probs = torch.softmax(x.float() @ params["router"]["w"].float(), -1)
        top = torch.topk(probs, top_k + 1, dim=-1).values
        records.append((idx.reshape(-1, top_k).cpu(),
                        top.reshape(-1, top_k + 1).cpu()))
        return w, idx, aux

    moe._route = route
    return records, lambda: setattr(moe, "_route", inner)


def _routing_gaps(card, cpu) -> str:
    """How many tokens' routing decisions (their top-k experts, in order)
    differ between the card's calls and the CPU's, and the smallest CPU
    top-k margin (gap between neighbours among the k + 1 largest
    probabilities) among them and among all."""
    check(len(card) == len(cpu), f"[moe-vs-plain] {len(card)} routing calls "
          f"on the card, {len(cpu)} on the CPU")
    n = differ = 0
    least_all = least_differ = float("inf")
    for (ia, _), (ib, pb) in zip(card, cpu):
        check(ia.shape == ib.shape, "[moe-vs-plain] routing call shapes differ")
        margin = (pb[:, :-1] - pb[:, 1:]).min(dim=-1).values
        bad = (ia != ib).any(dim=-1)
        n += ia.shape[0]
        differ += int(bad.sum())
        least_all = min(least_all, float(margin.min()))
        if bool(bad.any()):
            least_differ = min(least_differ, float(margin[bad].min()))
    among = f"among them {least_differ:.3e}; " if differ else ""
    return (f"{differ} of {n} routing decisions differ (smallest CPU top-k "
            f"margin {among}among all {least_all:.3e})")


MOE_PLAIN = ("qwen3-moe-30b-a3b", 2, (400, 96, 120, 64, 200, 50), SEED + 1)
PLAIN_KW = dict(slots=4, max_len=1024, max_new=8)
PLAIN_RUNS = (("dense", {}), ("paged, chunks of 128, int8", SCALE))


def _cpu_engine_vs_plain(setup, tag, session_rows, routing=False) -> dict:
    """The CPU half of phases 16, 18 and 20: the dense and the paged engine
    on ``setup``'s model, and the merged session step."""
    cfg, params, prompts, banks = _plain_setup(*setup)
    runs = {label: _engine_run(tag, f"{label} on the cpu", cfg, params, banks,
                               prompts, "cpu", PLAIN_KW, opts, routing)
            for label, opts in PLAIN_RUNS}
    return dict(runs=runs, session=_cpu_session(cfg, params, session_rows,
                                                f"{tag} (b)"))


def phase_moe_vs_plain(dev) -> None:
    """qwen3-moe-30b-a3b in f32 at full width, depth cut to 2 layers (~6.2
    GB a device), at the config's capacity factor 1.25, against the CPU's
    plain path (from the worker): (a) the dense engine and the paged +
    chunks of 128 + int8 engine, 4 slots, 6 requests of 400 / 96 / 120 /
    64 / 200 / 50 tokens, 8 new tokens (the first prefill routes its 4 x
    512 tokens in 512-token groups, the second its 2 x 256 in one group
    across both rows, and every chunk round 4 x 128 in one group): equal
    greedy tokens, and the routing decisions that differ between the
    devices with the smallest CPU top-k margin among them (reported, never
    hidden); (b) one merged rank-8 qv session step (server step, fit,
    AdamW) at 1 x 1024, card against CPU: losses within 1e-5, each tap's
    grad_h and fit gradients within 1e-3 of the largest entry (as phase 13
    (b))."""
    tag = "[moe-vs-plain]"
    cfg, params_cpu, prompts, banks_cpu = _plain_setup(*MOE_PLAIN)
    params_gpu = _to(params_cpu, dev)
    del params_cpu
    banks_gpu = [_to(b, dev) for b in banks_cpu]
    card = {label: _engine_run(tag, f"{label} on the card", cfg, params_gpu,
                               banks_gpu, prompts, dev, PLAIN_KW, opts, True)
            for label, opts in PLAIN_RUNS}
    cpu = cpu_half("moe-vs-plain")
    for label, _ in PLAIN_RUNS:
        a, b = card[label], cpu["runs"][label]
        toks, toks_c, lg, lg_c = a["tokens"], b["tokens"], a["logits"], \
            b["logits"]
        st = a["stats"]
        gap = (max(float((x - y).abs().max()) for x, y in zip(lg, lg_c))
               if len(lg) == len(lg_c) else None)
        print(f"{tag} f32, 2 layers at full width, {label}: prefill "
              f"calls {st['prefill_calls']}, chunk rounds {st['chunk_rounds']}"
              f"; tokens card == CPU: {toks == toks_c}; largest next-token "
              f"logit gap {gap if gap is None else f'{gap:.3e}'} (max |logit| "
              f"{max(float(x.abs().max()) for x in lg_c):.3f}); "
              f"{_routing_gaps(a['records'], b['records'])}; {a['secs']:.1f} "
              f"s on the card, {b['secs']:.1f} s on the CPU", flush=True)
        check(toks == toks_c, f"{tag} {label}: greedy tokens differ, "
              f"card {toks} vs CPU {toks_c}")
    del banks_gpu, card
    _free()

    _session_vs_plain(cfg, cpu["session"], params_gpu, dev, 1, f"{tag} (b)")
    del params_gpu
    _free()


def _session_setup(cfg, batch_rows: int) -> tuple:
    """Merged rank-8 qv ColA and a seeded SyntheticLM batch of
    ``batch_rows`` x 1024 on the CPU."""
    from repro_torch.configs.base import ColaConfig
    from repro_torch.data.pipeline import SyntheticLM

    cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                    rank=8, merged=True, interval=1)
    return cc, SyntheticLM(cfg, batch=batch_rows, seq=1024, seed=SEED + 2,
                           device="cpu").batch_at(0)


def _cpu_session(cfg, params_cpu, batch_rows: int, tag: str) -> dict:
    """The CPU half of ``_session_vs_plain``."""
    cc, batch = _session_setup(cfg, batch_rows)
    out = _session_step(cfg, cc, params_cpu, batch, "cpu", tag)
    del out["sess"]
    return out


def _session_vs_plain(cfg, cpu, params_gpu, dev, batch_rows, tag):
    """One merged rank-8 qv session step (server step, fit, AdamW) at
    ``batch_rows`` x 1024, card against CPU (``_session_step``; ``cpu`` is
    the CPU's, ``_cpu_session``): losses within 1e-5, each tap's grad_h and
    fit gradients within 1e-3 of the largest entry (as phase 13 (b)); the
    bank after AdamW printed."""
    cc, batch = _session_setup(cfg, batch_rows)
    gpu = _session_step(cfg, cc, params_gpu, batch, dev, tag)
    del gpu["sess"]
    loss_diff = abs(gpu["loss"] - cpu["loss"])
    check(loss_diff <= 1e-5 * abs(cpu["loss"]),
          f"{tag} loss card {gpu['loss']} vs CPU {cpu['loss']}")
    worst = {"grad_h": 0.0, "fit": 0.0}
    for t in sorted(cpu["grad_h"]):
        pairs = [("grad_h", f"{t} grad_h", gpu["grad_h"][t], cpu["grad_h"][t])]
        pairs += [("fit", f"{t}.{leaf}", gpu["fit"][t][leaf], a)
                  for leaf, a in cpu["fit"][t].items()]
        for kind, what, got, want in pairs:
            err, scale = max_err(got, want)
            check(scale > 0 and err <= 1e-3 * scale, f"{tag} {what}: card vs "
                  f"CPU max |diff| {err:.3g} > 1e-3 x {scale:.3g}")
            worst[kind] = max(worst[kind], err / scale)
    bank = max(max_err(gpu["bank"][t][leaf], w)[0] / max_err(w, w)[1]
               for t, e in cpu["bank"].items() for leaf, w in e.items())
    print(f"{tag} f32, {cfg.n_layers} layers at full width, merged session "
          f"step at "
          f"{batch_rows} x 1024: loss card {gpu['loss']:.7f} CPU "
          f"{cpu['loss']:.7f} (|diff| "
          f"{loss_diff:.3e}); max |card - CPU| / max |CPU| over both taps: "
          f"grad_h {worst['grad_h']:.3e}, fit grads {worst['fit']:.3e} (tol "
          f"1e-3); the bank after AdamW {bank:.3e} (not held to a bound); "
          f"session step {cpu['secs']:.1f} s on the CPU, {gpu['secs']:.2f} s "
          f"on the card", flush=True)
    del gpu
    _free()


# ---------------------------------------------------------------------------
# phases 17 and 18: the SSM plan (mamba2-370m)
# ---------------------------------------------------------------------------

ATTENTION_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv", "decode_attention",
                     "decode_attention_paged", "decode_attention_ring")
SSM_TAPS = ("layers.ssm.in", "layers.ssm.out")
# (label, options, kernels that must run, kernels that must not): no
# attention kernel on the attention-free path
SSM_RUNS = (("dense state, f32 bank", {}, ("multi_lora",),
             ATTENTION_KERNELS + ("multi_lora_q8", "cola_fit")),
            ("paged layout, chunks of 128, int8 bank", SCALE,
             ("multi_lora_q8",),
             ATTENTION_KERNELS + ("multi_lora", "cola_fit")))


def phase_ssm(dev) -> dict:
    """mamba2-370m at full width and depth (48 layers, d_model 1024, 32 SSD
    heads of 64, state 128, bf16, seeded random weights): (a) phase 14's
    serving load (4 users' rank-8 qv adapters, which tap the ssm in and out
    projections, 8 slots, max_len 1024, 8 requests of 32-512 tokens, 16
    new), dense state and an f32 bank, then the paged layout, chunks of 128
    and an int8 bank, the bank's multi-LoRA kernel launched and no attention
    kernel; (b) ColA training (``_cola_train``): 2 cola_fit launches a fit
    and no attention kernel. Returns the launch counts of all runs."""
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.utils import tree_leaves

    cfg = registry.get_config("mamba2-370m")
    t0 = time.perf_counter()
    params = model.init(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    f32 = [k for k, v in params["layers"]["ssm"].items()
           if torch.is_tensor(v) and v.dtype == torch.float32]
    check(sorted(f32) == ["A_log", "D", "dt_bias"], f"[ssm] f32 leaves {f32}")
    print(f"[ssm] mamba2-370m init at full depth in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{sum(t.numel() for t in tree_leaves(params))} parameters, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB; {card_line()}",
          flush=True)
    serve_launches = _moe_serve(cfg, params, dev, "[ssm] (a)", SSM_RUNS)
    none = dict.fromkeys(ATTENTION_KERNELS[:5] + ("multi_lora",
                                                  "multi_lora_q8"), 0)
    train = _cola_train(cfg, params, dev, "[ssm] (b)", SSM_TAPS,
                        lambda L, n: {**none, "cola_fit": 2 * n})
    del params
    _free()
    return {n: serve_launches[n] + train.get(n, 0) for n in serve_launches}


SSM_PLAIN = ("mamba2-370m", 2, (300, 77, 190, 140, 45, 260), SEED + 3)


def _engine_vs_plain(dev, setup, tag, desc, session_rows) -> None:
    """Phases 18 and 20: ``setup``'s model on the card against the CPU's
    half from the worker (``_cpu_engine_vs_plain``): (a) the dense and the
    paged + chunks of 128 + int8 engines, equal greedy tokens, the largest
    next-token logit gap printed; (b) the merged session step
    (``_session_vs_plain``)."""
    cfg, params_cpu, prompts, banks_cpu = _plain_setup(*setup)
    params_gpu = _to(params_cpu, dev)
    del params_cpu
    banks_gpu = [_to(b, dev) for b in banks_cpu]
    card = {label: _engine_run(tag, f"{label} on the card", cfg, params_gpu,
                               banks_gpu, prompts, dev, PLAIN_KW, opts)
            for label, opts in PLAIN_RUNS}
    cpu = cpu_half(tag.strip("[]"))
    for label, _ in PLAIN_RUNS:
        a, b = card[label], cpu["runs"][label]
        toks, toks_c, lg, lg_c = a["tokens"], b["tokens"], a["logits"], \
            b["logits"]
        st = a["stats"]
        check(len(lg) == len(lg_c), f"{tag} {label}: {len(lg)} "
              f"steps on the card, {len(lg_c)} on the CPU")
        gap = max(float((x - y).abs().max()) for x, y in zip(lg, lg_c))
        print(f"{tag} f32, {desc} at full width, {label}: prefill "
              f"calls {st['prefill_calls']}, chunk rounds {st['chunk_rounds']}"
              f", chunk groups {st['prefill_chunks']}; tokens card == CPU: "
              f"{toks == toks_c}; largest next-token logit gap {gap:.3e} (max "
              f"|logit| {max(float(x.abs().max()) for x in lg_c):.3f}); "
              f"{a['secs']:.1f} s on the card, {b['secs']:.1f} s on the CPU",
              flush=True)
        check(toks == toks_c, f"{tag} {label}: greedy tokens differ, "
              f"card {toks} vs CPU {toks_c}")
    del banks_gpu, card
    _free()
    _session_vs_plain(cfg, cpu["session"], params_gpu, dev, session_rows,
                      f"{tag} (b)")
    del params_gpu
    _free()


def phase_ssm_vs_plain(dev) -> None:
    """mamba2-370m in f32 at full width, depth cut to 2 layers, against the
    CPU's plain path: (a) the dense engine and the paged + chunks of 128 +
    int8 engine, 4 slots (two requests reuse a slot), 6 requests of 300 /
    77 / 190 / 140 / 45 / 260 tokens (tail chunks of 44, 77, 62, 12, 45
    and 4), 8 new tokens: equal greedy tokens, the largest next-token logit
    gap printed; (b) one merged rank-8 qv session step at 2 x 1024
    (``_session_vs_plain``)."""
    _engine_vs_plain(dev, SSM_PLAIN, "[ssm-vs-plain]", "2 layers", 2)


# ---------------------------------------------------------------------------
# phases 19 and 20: the hybrid plan (zamba2-7b)
# ---------------------------------------------------------------------------

HYBRID_TAPS = ("shared.attn.q", "shared.attn.v")
# (label, options, kernels that must run, kernels that must not)
HYBRID_RUNS = (("dense KV and state, f32 bank", {},
                ("flash_attention", "decode_attention", "multi_lora"),
                ("decode_attention_paged", "decode_attention_ring",
                 "multi_lora_q8", "cola_fit")),
               ("paged KV, chunks of 128, int8 bank", SCALE,
                ("flash_attention", "decode_attention_paged",
                 "multi_lora_q8"),
                ("decode_attention", "decode_attention_ring", "multi_lora",
                 "cola_fit")))


def _call_counting_engine():
    """A ServeEngine that keeps, for each device call, its kind ("prefill",
    "chunk" or "tick") and every kernel's launches in it (the wrappers'
    counts read on the host before and after: no sync)."""
    from repro_torch.runtime.serve_loop import ServeEngine

    ws = wrappers()

    class Counting(ServeEngine):
        def __init__(self, *a, **kw):
            self.calls = []
            super().__init__(*a, **kw)

        def _counted_call(self, kind, fn, *a, **kw):
            before = {n: w.launches for n, w in ws.items()}
            out = fn(*a, **kw)
            self.calls.append((kind, {n: w.launches - before[n]
                                      for n, w in ws.items()}))
            return out

        def _step_logits(self, tokens, positions, users, live, lens=None):
            kind = "tick" if tokens.shape[1] == 1 else "chunk"
            return self._counted_call(kind, super()._step_logits, tokens,
                                      positions, users, live, lens)

        def _prefill(self, tokens, users, slot_ids, lengths):
            return self._counted_call("prefill", super()._prefill, tokens,
                                      users, slot_ids, lengths)

    return Counting


def _hybrid_calls(n_seg: int):
    """The per-call launch check of ``_moe_serve``: every prefill and chunk
    call launches the flash forward once a shared-block call (n_seg) and
    the bank's multi-LoRA kernel twice as often (q and v), every tick the
    layout's decode kernel n_seg times and the bank's kernel 2 n_seg
    times."""
    def check_calls(eng, label):
        bank = "multi_lora_q8" if eng.bank and "A_q" in next(
            iter(eng.bank.values())) else "multi_lora"
        decode = ("decode_attention" if eng.pager is None
                  else "decode_attention_paged")
        want = {"prefill": {"flash_attention": n_seg, bank: 2 * n_seg},
                "chunk": {"flash_attention": n_seg, bank: 2 * n_seg},
                "tick": {decode: n_seg, bank: 2 * n_seg}}
        kinds = collections.Counter(k for k, _ in eng.calls)
        bad = [(k, got) for k, got in eng.calls
               if {n: c for n, c in got.items() if c} != want[k]]
        check(not bad and kinds["tick"] > 0 and (kinds["prefill"] > 0
                                                 or kinds["chunk"] > 0),
              f"[hybrid] (a) {label}: calls {dict(kinds)}, a call's "
              f"launches off {want}: {bad[:3]}")
        print(f"[hybrid] (a) {label}: device calls {dict(kinds)}, each "
              f"launching exactly {want}", flush=True)
    return check_calls


def phase_hybrid(dev) -> dict:
    """zamba2-7b at full width and depth (81 Mamba2 layers, d_model 3584,
    112 SSD heads of 64, state 64; the shared attention block, 32 heads of
    112, MHA, d_ff 14336, at the head of each of the 14 segments; bf16,
    seeded random weights): (a) phase 14's serving load (4 users' rank-8 qv
    adapters at the shared q and v taps, 8 slots, max_len 1024, 8 requests
    of 32-512 tokens, 16 new) with dense KV and state and an f32 bank, then
    paged KV, chunks of 128 and an int8 bank, each device call's launches
    exact (``_hybrid_calls``); (b) ColA training (``_cola_train``): 28 flash
    forwards, 14 dq and 14 dk/dv a step, 2 cola_fit a fit, grad_h non-zero
    at every call of both taps. Returns the launch counts of all runs."""
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.utils import tree_leaves

    cfg = registry.get_config("zamba2-7b")
    n_seg = len(model.layer_plan(cfg)[1])
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    f32 = [k for k, v in params["layers"]["ssm"].items()
           if torch.is_tensor(v) and v.dtype == torch.float32]
    check(sorted(f32) == ["A_log", "D", "dt_bias"], f"[hybrid] f32 leaves {f32}")
    hq = cfg.n_heads * cfg.d_head
    check(params["shared"]["attn"]["q"]["w"].shape == (cfg.d_model, hq),
          "[hybrid] the shared block is not one unstacked block")
    print(f"[hybrid] zamba2-7b init at full depth in "
          f"{time.perf_counter() - t0:.1f} s: {cfg.n_layers} Mamba2 layers "
          f"and the shared block over {n_seg} segments, "
          f"{sum(t.numel() for t in tree_leaves(params))} parameters, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); {card_line()}", flush=True)
    engine = _call_counting_engine()
    runs = tuple((label, dict(opts, engine=engine), ran, idle)
                 for label, opts, ran, idle in HYBRID_RUNS)
    serve_launches = _moe_serve(cfg, params, dev, "[hybrid] (a)", runs,
                                check_calls=_hybrid_calls(n_seg))
    none = dict.fromkeys(("decode_attention", "decode_attention_paged",
                          "multi_lora", "multi_lora_q8"), 0)
    train = _cola_train(
        cfg, params, dev, "[hybrid] (b)", HYBRID_TAPS,
        lambda L, n: {**none, "flash_attention": 2 * n_seg * n,
                      "flash_attention_bwd_dq": n_seg * n,
                      "flash_attention_bwd_dkv": n_seg * n,
                      "cola_fit": 2 * n}, per_call=True)
    del params
    _free()
    return {n: serve_launches[n] + train.get(n, 0) for n in serve_launches}


HYBRID_PLAIN = ("zamba2-7b", 7, SSM_PLAIN[2], SEED + 3)


def phase_hybrid_vs_plain(dev) -> None:
    """zamba2-7b in f32 at full width, depth cut to 7 layers with the shared
    block every 6 kept (segments of 6 and 1: two calls and a one-layer
    tail), against the CPU's plain path: (a) the dense engine and the paged
    + chunks of 128 + int8 engine, 4 slots (two requests reuse a slot), 6
    requests of 300 / 77 / 190 / 140 / 45 / 260 tokens (tail chunks of 44,
    77, 62, 12, 45 and 4), 8 new tokens: equal greedy tokens, the largest
    next-token logit gap printed; (b) one merged rank-8 qv session step at
    1 x 1024 (``_session_vs_plain``: losses within 1e-5, grad_h and the fit
    gradients of both shared taps within 1e-3 of their largest entry)."""
    from repro_torch.configs import registry
    from repro_torch.models import model

    cfg = registry.get_config(HYBRID_PLAIN[0]).replace(n_layers=HYBRID_PLAIN[1])
    check(model.layer_plan(cfg)[1] == [(0, 6), (6, 1)],
          f"[hybrid-vs-plain] plan {model.layer_plan(cfg)}")
    _engine_vs_plain(dev, HYBRID_PLAIN, "[hybrid-vs-plain]",
                     "7 layers (segments of 6 and 1)", 1)


# ---------------------------------------------------------------------------
# phases 21-23: musicgen-medium's codebooks and untied head, pixtral-12b's
# embedding input
# ---------------------------------------------------------------------------

MODALITY_TAPS = ("layers.attn.q", "layers.attn.v")
# (label, paged KV with prefill chunks of 128, bank store)
MODALITY_RUNS = (("dense KV, f32 bank", False, "f32"),
                 ("paged KV, chunks of 128, int8 bank", True, "int8"))


def _modality_inputs(cfg, lens, seed: int) -> list:
    """Seeded prompts: (P, CB) tokens, or with ``embed_input`` the stubbed
    frontend's (P, d) f32 embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.embed_input:
        return [rng.standard_normal((int(n), cfg.d_model)).astype(np.float32)
                for n in lens]
    return [rng.integers(0, cfg.vocab_size, (int(n), cfg.n_codebooks))
            .astype(np.int32) for n in lens]


def modality_serve(cfg, params, banks, prompts, device, *, paged: bool,
                   store: str, ticks: int, seed: int, max_len: int = 1024,
                   chunk: int = 128, block: int = 16, keep_logits=False):
    """Serve one row a prompt through the model's entry points, as the JAX
    package's prefill and serve steps do at one device (its engine serves
    (P,) token prompts only): row i on user i % len(banks)'s adapters
    (``cola_vars`` with per-row ``idx``, as ``ServeEngine._cola_vars``
    builds them; the f32 bank, or int8 through ``quantize_bank``). Dense:
    one right-padded ``model.prefill`` with ``lengths``, scattered into an
    ``init_cache`` (``scatter_prefill_cache``). Paged: a ``BlockPager``
    reserves each row's prompt and ticks, and the prompts go through
    ``model.decode_step`` in rounds of ``chunk`` (a row live until its
    prompt is in), the table copied to the device each call. Then
    ``ticks`` greedy ticks (``decode_step`` + an argmax over the last
    axis): with codebooks each tick feeds back the last (B, 1, CB) argmax;
    with ``embed_input`` it takes a seeded (B, 1, d) stub embedding. Each
    device call's kind, launches (the wrappers' counts, read on the host)
    and host seconds (the argmax read back ends it) are kept. Returns the
    tokens (the prompt's argmax and each tick's, per row), the calls, the
    largest pool use and, with ``keep_logits``, each call's next-token
    logits on the host. The pool must be whole at the end."""
    from repro_torch.core import gl
    from repro_torch.core import taps as taps_lib
    from repro_torch.models import model
    from repro_torch.runtime.kv_pager import BlockPager
    from repro_torch.runtime.serve_loop import (quantize_bank,
                                                stack_user_adapters)
    from repro_torch.utils import cdiv

    B, L = len(prompts), cfg.n_layers
    lens = np.array([len(p) for p in prompts], np.int32)
    key = "embeds" if cfg.embed_input else "tokens"
    bank = stack_user_adapters(banks)
    if store == "int8":
        bank = quantize_bank(bank)
    users = torch.arange(B, dtype=torch.int32, device=device) % len(banks)
    cola_vars = {"adapters": {t: dict({n: a.to(device).contiguous()
                                       for n, a in e.items()},
                                      idx=users.expand(L, -1))
                              for t, e in bank.items()}}
    spec = taps_lib.make_spec(family="multi_lowrank",
                              taps=gl.select_taps(cfg, "qv"), scale=1.0)
    stub = np.random.default_rng(seed).standard_normal(
        (ticks, B, 1, cfg.d_model)).astype(np.float32)
    ws = wrappers()
    calls, logits_kept = [], []

    def tensor(a):
        return torch.as_tensor(a, device=device)

    def call(kind, fn):
        """One device call; returns its rows' next-token argmax (on the
        host) and logits."""
        before = {n: w.launches for n, w in ws.items()}
        t0 = time.perf_counter()
        logits = fn()
        nxt = logits.argmax(dim=-1)
        host = nxt.cpu()
        calls.append((kind, {n: w.launches - before[n] for n, w in ws.items()},
                      time.perf_counter() - t0))
        if keep_logits:
            logits_kept.append(logits.float().cpu())
        return nxt, host

    pager = None
    feat = prompts[0].shape[1:]
    if paged:
        n_blocks = B * cdiv(max_len, block)
        pager = BlockPager(n_blocks, block, B, max_len)
        for i, n in enumerate(lens):
            check(pager.reserve(i, int(n) + ticks), f"slot {i}: no reservation")
        cache = model.init_cache(cfg, B, max_len, kv_layout="paged",
                                 kv_blocks=n_blocks, kv_block=block,
                                 device=device)
        done = np.zeros(B, np.int32)
        first = [None] * B
        rows = torch.arange(B, device=device)
        while (done < lens).any():
            x = np.zeros((B, chunk) + feat, prompts[0].dtype)
            pos, width = done.copy(), np.ones(B, np.int32)
            live = done < lens
            for i in np.flatnonzero(live):
                c = min(chunk, int(lens[i] - done[i]))
                x[i, :c] = prompts[i][done[i]:done[i] + c]
                width[i] = c
                check(pager.ensure(i, min(int(done[i]) + chunk - 1,
                                          max_len - 1)), f"slot {i}: ensure")
            table = tensor(pager.table)

            def step(x=x, pos=pos, live=live, table=table, width=width):
                lg, _ = model.decode_step(
                    cfg, params, {key: tensor(x), "positions": tensor(pos)},
                    cache, spec, cola_vars, live=tensor(live),
                    block_table=table)
                return lg[rows, tensor(width).long() - 1]

            nxt, host = call("chunk", step)
            done += np.where(live, width, 0).astype(np.int32)
            for i in np.flatnonzero(live & (done >= lens)):
                first[i] = (nxt[i], host[i])
        nxt = torch.stack([f[0] for f in first])
        host = torch.stack([f[1] for f in first])
    else:
        cache = model.init_cache(cfg, B, max_len, device=device)
        x = np.zeros((B, int(lens.max())) + feat, prompts[0].dtype)
        for i, p in enumerate(prompts):
            x[i, :len(p)] = p

        def prefill():
            lg, pre = model.prefill(cfg, params, {key: tensor(x)}, spec,
                                    cola_vars, lengths=tensor(lens))
            model.scatter_prefill_cache(cache, pre, np.arange(B))
            return lg[:, -1]

        nxt, host = call("prefill", prefill)
    tokens = [[host[i].tolist()] for i in range(B)]
    peak_blocks = pager.blocks_in_use() if pager is not None else 0
    for t in range(ticks):
        pos = lens + t
        table = None
        if pager is not None:
            for i in range(B):
                check(pager.ensure(i, int(pos[i])), f"slot {i}: ensure")
            table = tensor(pager.table)
            peak_blocks = max(peak_blocks, pager.blocks_in_use())
        x = tensor(stub[t]) if cfg.embed_input else nxt[:, None]

        def tick(x=x, pos=pos, table=table):
            lg, _ = model.decode_step(cfg, params,
                                      {key: x, "positions": tensor(pos)},
                                      cache, spec, cola_vars,
                                      block_table=table)
            return lg[:, -1]

        nxt, host = call("tick", tick)
        for i in range(B):
            tokens[i].append(host[i].tolist())
    if pager is not None:
        for i in range(B):
            pager.release(i)
        pager.assert_empty()
    del cache
    return dict(tokens=tokens, calls=calls, logits=logits_kept,
                peak_blocks=peak_blocks)


def _modality_calls(tag, label, cfg, calls, store, paged) -> dict:
    """Every device call's launches exact: a prefill or chunk call the
    flash forward once a layer and the bank's multi-LoRA kernel twice a
    layer (q and v), a tick the layout's decode kernel once a layer and
    the bank's kernel twice; nothing else. Returns the calls' total
    launches."""
    L = cfg.n_layers
    bank = "multi_lora_q8" if store == "int8" else "multi_lora"
    decode = "decode_attention_paged" if paged else "decode_attention"
    want = {"prefill": {"flash_attention": L, bank: 2 * L},
            "chunk": {"flash_attention": L, bank: 2 * L},
            "tick": {decode: L, bank: 2 * L}}
    kinds = collections.Counter(k for k, _, _ in calls)
    bad = [(k, got) for k, got, _ in calls
           if {n: c for n, c in got.items() if c} != want[k]]
    check(not bad and kinds["tick"] > 0, f"{tag} {label}: calls "
          f"{dict(kinds)}, a call's launches off {want}: {bad[:3]}")
    print(f"{tag} {label}: device calls {dict(kinds)}, each prefill or "
          f"chunk call launching exactly {want['chunk']}, each tick "
          f"{want['tick']}", flush=True)
    total = collections.Counter()
    for _, got, _ in calls:
        total.update(got)
    return dict(total)


def phase_modality(dev, name: str, tag: str) -> dict:
    """``name`` (musicgen-medium: 48 layers, d_model 1536, 24 heads of 64,
    MHA, 4 codebooks of 2048 summed at the input and an untied head of 4 x
    2048 columns; pixtral-12b: 40 layers, d_model 5120, 32 / 8 heads of
    128, vocab 131072, embeddings in and an ``unembed`` head) at full width
    and depth, bf16, seeded random weights: (a) 8 rows on 4 users' rank-8
    qv adapters, prompts of 32-512 positions (x 4 codebooks, or stub
    embeddings), right-padded: one batched prefill with ``lengths`` into a
    dense cache and an f32 bank, then paged K/V, prefill chunks of 128
    through ``decode_step`` and an int8 bank, each followed by 16 greedy
    ticks (``modality_serve``), with the launch counts reset just before
    and read just after each run and each device call's launches exact
    (``_modality_calls``); (b) ColA training (``_cola_train``): a warm-up
    step and 2 measured steps, Mode A merged rank-8 qv, interval 1, AdamW,
    remat "full", SyntheticLM at ``SETUPS``' shape: 2 L flash forwards, L
    dq and L dk/dv a step and 2 cola_fit a fit. Returns the launch counts
    of all runs."""
    from repro_torch.configs import registry
    from repro_torch.models import model
    from repro_torch.utils import tree_leaves

    cfg = registry.get_config(name)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{tag} {name} init at full depth in {time.perf_counter() - t0:.1f} "
          f"s: {cfg.n_layers} layers, {n_params} parameters, "
          f"{n_params * 2 / 2**30:.2f} GiB in bf16 "
          f"({torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated, "
          f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB); "
          f"leaves {sorted(k for k in params if not k.startswith('layers'))}"
          f"; {card_line()}", flush=True)
    banks = user_banks(cfg, 4, dev, SEED)
    rng = np.random.default_rng(SEED + 2)
    prompts = _modality_inputs(cfg, rng.integers(32, 513, 8), SEED + 2)
    ticks = 16
    total = collections.Counter()
    for label, paged, store in MODALITY_RUNS:
        torch.cuda.reset_peak_memory_stats(dev)
        out, launches = _counted(lambda: modality_serve(
            cfg, params, banks, prompts, dev, paged=paged, store=store,
            ticks=ticks, seed=SEED + 3))
        calls = _modality_calls(f"{tag} (a)", label, cfg, out["calls"], store,
                                paged)
        check(all(calls.get(n, 0) == c for n, c in launches.items()),
              f"{tag} (a) {label}: launches {launches} != the calls' {calls}")
        width = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        toks = np.array(out["tokens"])
        check(toks.shape == (8, ticks + 1) + width
              and 0 <= toks.min() and toks.max() < cfg.vocab_size,
              f"{tag} (a) {label}: tokens of shape {toks.shape}, not 8 rows "
              f"of the prompt's and {ticks} ticks' {width} in the vocabulary")
        secs = {k: [s * 1e3 for kk, _, s in out["calls"] if kk == k]
                for k in ("prefill", "chunk", "tick")}
        pre = (f"prefill call {secs['prefill'][0]:.1f} ms" if secs["prefill"]
               else f"{len(secs['chunk'])} chunk calls, p50 "
                    f"{statistics.median(secs['chunk']):.1f} ms, "
                    f"{sum(secs['chunk']):.1f} ms in all")
        print(f"{tag} (a) {name} bf16, {label}: 8 rows of "
              f"{sorted(len(p) for p in prompts)} positions, every row "
              f"{ticks} tick tokens of shape {width}; {pre}; tick p50 "
              f"{statistics.median(secs['tick']):.2f} ms (max "
              f"{max(secs['tick']):.2f}); largest pool use "
              f"{out['peak_blocks']} blocks of 16; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
              f"{card_line()}", flush=True)
        print(f"{tag} (a) {label}: launches {launches}", flush=True)
        total.update(launches)
        _free()
    none = dict.fromkeys(("decode_attention", "decode_attention_paged",
                          "multi_lora", "multi_lora_q8"), 0)
    train = _cola_train(
        cfg, params, dev, f"{tag} (b)", MODALITY_TAPS,
        lambda L, n: {**none, "flash_attention": 2 * L * n,
                      "flash_attention_bwd_dq": L * n,
                      "flash_attention_bwd_dkv": L * n, "cola_fit": 2 * n})
    del params
    _free()
    total.update(train)
    return dict(total)


MODALITY_PLAIN = ("musicgen-medium", "pixtral-12b")


def _modality_plain_setup(name: str) -> tuple:
    """``name`` in f32 at full width cut to 2 layers, seeded weights on the
    CPU, 4 seeded rows of 300 / 77 / 190 / 45 positions, 2 users' banks."""
    from repro_torch.configs import registry
    from repro_torch.models import model

    cfg = registry.get_config(name).replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    params = model.init(cfg, seed=SEED + 1, device="cpu")
    prompts = _modality_inputs(cfg, (300, 77, 190, 45), SEED + 3)
    return cfg, params, prompts, user_banks(cfg, 2, "cpu", SEED + 1)


def _modality_run(cfg, params, banks, prompts, device, paged, store) -> dict:
    """``modality_serve`` for 8 ticks, the logits kept and the seconds it
    took."""
    t0 = time.perf_counter()
    out = modality_serve(cfg, params, banks, prompts, device, paged=paged,
                         store=store, ticks=8, seed=SEED + 4,
                         keep_logits=True)
    return dict(out, secs=time.perf_counter() - t0)


def _cpu_modality_vs_plain(name: str) -> dict:
    """The CPU half of phase 23 for ``name``: both serving runs and the
    merged session step."""
    cfg, params, prompts, banks = _modality_plain_setup(name)
    runs = {label: _modality_run(cfg, params, banks, prompts, "cpu", paged,
                                 store)
            for label, paged, store in MODALITY_RUNS}
    return dict(runs=runs, session=_cpu_session(
        cfg, params, 1, f"[modality-vs-plain] {name} (b)"))


def phase_modality_vs_plain(dev) -> None:
    """musicgen-medium and pixtral-12b in f32 at full width, depth cut to 2
    layers, against the CPU's plain path (from the worker): (a)
    ``modality_serve``, dense + f32 bank and paged + chunks of 128 + int8
    bank, 4 rows of 300 / 77 / 190 / 45 positions (tail chunks of 44, 77,
    62 and 45) on 2 users, 8 ticks: equal greedy tokens (all 4 codebooks
    for musicgen), the largest next-token logit gap printed; (b) one merged
    rank-8 qv session step at 1 x 1024 (``_session_vs_plain``: losses
    within 1e-5, grad_h and the fit gradients within 1e-3 of their largest
    entry)."""
    tag = "[modality-vs-plain]"
    for name in MODALITY_PLAIN:
        cfg, params_cpu, prompts, banks_cpu = _modality_plain_setup(name)
        params_gpu = _to(params_cpu, dev)
        del params_cpu
        banks_gpu = [_to(b, dev) for b in banks_cpu]
        runs = {label: _modality_run(cfg, params_gpu, banks_gpu, prompts, dev,
                                     paged, store)
                for label, paged, store in MODALITY_RUNS}
        half = cpu_half(f"modality-vs-plain-{name}")
        for label, _, _ in MODALITY_RUNS:
            card, cpu = runs[label], half["runs"][label]
            check(len(card["logits"]) == len(cpu["logits"]),
                  f"{tag} {name} {label}: {len(card['logits'])} calls on the "
                  f"card, {len(cpu['logits'])} on the CPU")
            gap = max(float((x - y).abs().max())
                      for x, y in zip(card["logits"], cpu["logits"]))
            same = card["tokens"] == cpu["tokens"]
            print(f"{tag} {name} f32, 2 layers at full width, {label}: "
                  f"{len(card['calls'])} device calls; tokens card == CPU: "
                  f"{same}; largest next-token logit gap {gap:.3e} (max "
                  f"|logit| {max(float(x.abs().max()) for x in cpu['logits']):.3f}"
                  f"); {card['secs']:.1f} s on the card, {cpu['secs']:.1f} s "
                  f"on the CPU", flush=True)
            check(same, f"{tag} {name} {label}: greedy tokens differ, card "
                  f"{card['tokens']} vs CPU {cpu['tokens']}")
        del banks_gpu, runs
        _free()
        _session_vs_plain(cfg, half["session"], params_gpu, dev, 1,
                          f"{tag} {name} (b)")
        del params_gpu
        _free()


# ---------------------------------------------------------------------------
# phases 24 and 25: the distribution layer on torch.distributed
# ---------------------------------------------------------------------------

DIST_ROWS, DIST_SEQ, DIST_STEPS = 8, 1024, 2
DIST_PREFILL, DIST_MAX_LEN, DIST_TICKS = 512, 1024, 16
DIST_PLAIN_SEQ, DIST_PLAIN_TICKS = 256, 8
ATTN_TRAIN = ("flash_attention", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _process_group(dev, tag: str) -> None:
    """A world-size-1 group: gloo for the host's tensors, NCCL for the
    card's; one all_reduce on the card shows NCCL is up (a failed init or
    collective raises: nothing falls back)."""
    import torch.distributed as dist

    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    t = torch.arange(4, dtype=torch.float32, device=dev)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    check(torch.equal(t.cpu(), torch.arange(4, dtype=torch.float32)),
          f"{tag} NCCL all_reduce at world size 1 changed its input")
    print(f"{tag} process group: backend {dist.get_backend()}, world size "
          f"{dist.get_world_size()}, NCCL all_reduce on the card checked",
          flush=True)


def _dist_batch(cfg, rows: int, seq: int, seed: int, dev) -> dict:
    """Seeded tokens and next-token labels, row r's first (37 r) mod (seq /
    2) labels masked (-1): the rows' counts differ, so a microbatch grouped
    wrongly or a mean of means would show."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    for r in range(rows):
        labels[r, :(37 * r) % (seq // 2)] = -1
    return {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
            "labels": torch.as_tensor(labels, device=dev)}


def _micro(batch: dict, i: int, m: int) -> dict:
    b = next(iter(batch.values())).shape[0] // m
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


def _same(got, want) -> float:
    """0.0 when equal bit for bit, else max |got - want| over max |want|
    (``got`` moved to ``want``'s device)."""
    got = got.to(want.device)
    if torch.equal(got, want):
        return 0.0
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _dist_adapters(cfg, cc, dev) -> dict:
    """Seeded rank-8 adapters with B drawn too (B = 0 leaves dA = 0)."""
    from repro_torch.core import gl

    g = torch.Generator().manual_seed(SEED)
    adapters = gl.init_adapters(cfg, cc, g, device=dev)
    for w in adapters.values():
        w["B"] = (torch.randn(w["B"].shape, generator=g) * 0.01).to(dev)
    return adapters


class _ProductCounter(TorchDispatchMode):
    """Counts the products (mm, bmm, addmm) that run under it (``calls``)
    and their FLOPs (2 m k n). It sits below a checkpoint's own dispatch
    modes, so a product that remat "dots" replays from what it kept never
    reaches it: the count is of the products the card ran."""

    _OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)

    def __init__(self):
        super().__init__()
        self.calls = self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self._OPS:
            a = args[1] if func is torch.ops.aten.addmm.default else args[0]
            self.calls += 1
            self.flops += 2 * out.numel() * a.shape[-1]
        return out


def _dist_train(tag, cfg, cc, mesh, P, params, adapters, batches, dev,
                offloader=None, record=None, direct=True
                ) -> tuple[dict, float]:
    """``make_train_step(cfg, cc, mesh)``: a warm-up step on batches[0],
    then one measured step on each later batch (launches reset just before
    and read just after the step, and again around the fit); Mode A's data
    pushed to ``offloader`` as M pushes and fitted. Then (``direct``) the
    last step against the direct per-microbatch calls: launches exactly M
    times one call's, loss and data or gradients bit for bit (or within
    1e-6 of the largest entry). With ``record`` (a dict, Mode A) the
    warm-up step runs under a ``_ProductCounter`` and remat's
    ``saved_product_meter``, and ``record`` gets their numbers, the step's
    loss and each tap's (x, grad_h) on the host, the launches of one
    measured step and the peak. Returns the launch counts of the measured
    windows and the measured steps' p50 ms."""
    from repro_torch.core import gl
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import steps
    from repro_torch.models import remat
    from repro_torch.utils import tree_leaves

    m = cfg.microbatches
    fn, (_, ash) = steps.make_train_step(cfg, cc, mesh)
    mode_a = cc.mode == "faithful_offload"
    total = collections.Counter()
    step_ms, fit_ms, losses = [], [], []
    peak = step_peak = 0
    for n, batch in enumerate(batches):
        used = {t: {k: v.clone() for k, v in w.items()} for t, w in
                (offloader.adapters if offloader else adapters).items()}
        A = sh.distribute(mesh, used, ash)
        out = None   # the last step's data goes before the next is made
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if n == 0 and record is not None:
            with (_ProductCounter() as products,
                  remat.saved_product_meter() as kept):
                (loss, out), launches = _counted(lambda: fn(P, A, batch))
            record.update(
                products=(products.calls, products.flops),
                kept=(len(kept.shapes), kept.bytes, kept.flops),
                loss=float(loss),
                out={t: (x.to_local().cpu(), g.to_local().cpu())
                     for t, (x, g) in out.items()})
        else:
            (loss, out), launches = _counted(lambda: fn(P, A, batch))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_peak = max(step_peak, torch.cuda.max_memory_allocated(dev))
        losses.append(float(loss))
        if offloader is not None:
            before = [t.clone() for t in tree_leaves(offloader.adapters)]
            t0 = time.perf_counter()

            def fit():
                for i in range(m):
                    offloader.push({t: (x.to_local()[i], g.to_local()[i])
                                    for t, (x, g) in out.items()})
                return offloader.maybe_fit()

            new, fl = _counted(fit)
            fit_ms.append((time.perf_counter() - t0) * 1e3)
            check(new is not None and fl["cola_fit"] == 2
                  and sum(fl.values()) == 2,
                  f"{tag} a fit of {m} pushes launched {fl}, not 2 cola_fit")
            check(any(not torch.equal(a, b) for a, b in
                      zip(before, tree_leaves(offloader.adapters))),
                  f"{tag} the fit left the adapters as they were")
            launches = collections.Counter(launches) + collections.Counter(fl)
        if n:
            total.update(launches)
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    check(all(np.isfinite(losses)), f"{tag} losses {losses}")
    label = "Mode A" if mode_a else "Mode B"
    tokens = sum(next(iter(b.values())).numel() for b in batches[1:])
    measured = step_ms[1:]
    fits = (f"; fit ms {[round(t, 2) for t in fit_ms[1:]]} (8 pushes, 2 "
            f"cola_fit a fit)" if fit_ms else "")
    print(f"{tag} {label} {cfg.name} bf16, {cfg.n_layers} layers, remat "
          f"{cfg.remat}, {m} microbatches of {DIST_ROWS // m} x {DIST_SEQ}: "
          f"losses {[round(x, 5) for x in losses]}; step ms "
          f"{[round(t, 1) for t in step_ms]} (warm-up first; p50 of the "
          f"measured {statistics.median(measured):.1f}){fits}; "
          f"{tokens / (sum(measured) / 1e3):.1f} training tokens/s; peak "
          f"memory {peak / 2**30:.2f} GiB (the steps' own, the fits left "
          f"out: {step_peak / 2**30:.2f} GiB); {card_line()}", flush=True)
    if record is not None:
        record.update(launches={k: launches[k] for k in ATTN_TRAIN},
                      peak=step_peak, p50=statistics.median(measured))
    if not direct:
        return dict(total), statistics.median(measured)

    # the last step against the direct calls on its microbatches
    spec = gl.make_spec(cfg, cc)
    call = gl.server_step_a if mode_a else gl.train_step_b
    tot = acc = None
    worst = 0.0
    for i in range(m):
        mb = _micro(batches[-1], i, m)
        (loss_i, got_i, _), c = _counted(
            lambda: call(cfg, spec, params, used, mb))
        if i == 0:
            one = {k: c[k] for k in ATTN_TRAIN}
        if tot is None:
            tot = torch.zeros((), dtype=loss_i.dtype, device=loss_i.device)
        tot = tot + loss_i
        if mode_a:
            for t, (x, g) in got_i.items():
                worst = max(worst, _same(out[t][0].to_local()[i], x),
                            _same(out[t][1].to_local()[i], g))
        else:
            acc = (got_i if acc is None else
                   {t: {k: acc[t][k] + v for k, v in w.items()}
                    for t, w in got_i.items()})
        del got_i
    if mode_a:
        direct = tot / m
    else:
        direct = tot / float(m)
        for t, w in acc.items():
            for k, v in w.items():
                worst = max(worst, _same(out[t][k].to_local(), v / float(m)))
    lw = _same(loss, direct)
    last = {k: launches[k] for k in ATTN_TRAIN}
    check(all(one[k] > 0 and last[k] == m * one[k] for k in ATTN_TRAIN),
          f"{tag} a step launched {last}, not {m} x one microbatch's {one}")
    check(lw <= 1e-6 and worst <= 1e-6,
          f"{tag} step against the direct calls: loss {lw:.3g}, "
          f"{'data' if mode_a else 'gradients'} {worst:.3g} of the largest")
    print(f"{tag} {label}: a step launches {last} = {m} x one microbatch's "
          f"{one}; loss and {'data' if mode_a else 'gradients'} against the "
          f"direct calls: "
          f"{'equal bit for bit' if lw == worst == 0.0 else f'{max(lw, worst):.3g} of the largest entry'}"
          f"; launches in {len(batches) - 1} measured steps "
          f"{dict(total)}", flush=True)
    return dict(total), statistics.median(measured)


def _dist_serve(tag, cfg, mesh, P, params, dev) -> tuple[dict, float, float]:
    """``make_prefill_step`` at 8 x DIST_PREFILL, its cache written into a
    placed 8 x DIST_MAX_LEN decode cache, then DIST_TICKS ticks of
    ``make_serve_step``; tokens and prefill logits equal to direct
    ``model.prefill`` / ``decode_step``. Returns the launch counts, the
    measured prefill's ms and the ticks' p50 ms."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import steps
    from repro_torch.models import model
    from repro_torch.utils import tree_map

    L, B = cfg.n_layers, DIST_ROWS
    rng = np.random.default_rng(SEED + 20)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, DIST_PREFILL))
                           .astype(np.int32), device=dev)
    fn_p, _ = steps.make_prefill_step(cfg, mesh)
    fn_s, _ = steps.make_serve_step(cfg, mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    fn_p(P, {"tokens": toks})   # warm-up
    _free()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (logits, pre), total = _counted(lambda: fn_p(P, {"tokens": toks}))
    pre_ms = (time.perf_counter() - t0) * 1e3
    check(total["flash_attention"] == L and sum(total.values()) == L,
          f"{tag} (c) prefill launched {total}, not {L} flash forwards")
    total = collections.Counter(total)
    cspec, _ = steps.serve_shardings(cfg, mesh, B, DIST_MAX_LEN)
    C = sh.distribute(mesh, model.init_cache(cfg, B, DIST_MAX_LEN,
                                             device=dev), cspec)
    model.scatter_prefill_cache(tree_map(lambda d: d.to_local(), C),
                                tree_map(lambda d: d.to_local(), pre),
                                range(B))
    del pre
    tok = logits.to_local().argmax(-1).to(torch.int32)
    pos = torch.full((B,), DIST_PREFILL, dtype=torch.int32, device=dev)
    got, tick_ms = [tok], []
    for _ in range(DIST_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (out, C), c = _counted(
            lambda: fn_s(P, C, {"tokens": tok, "positions": pos}))
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        check(c["decode_attention"] == L and sum(c.values()) == L,
              f"{tag} (c) a tick launched {c}, not {L} decode")
        total.update(c)
        tok, pos = out.to_local(), pos + 1
        got.append(tok)
    peak = torch.cuda.max_memory_allocated(dev)
    del C
    _free()
    # direct
    lg, pre = model.prefill(cfg, params, {"tokens": toks})
    same_logits = torch.equal(lg, logits.to_local())
    cache = model.init_cache(cfg, B, DIST_MAX_LEN, device=dev)
    model.scatter_prefill_cache(cache, pre, range(B))
    del pre
    tok = lg.argmax(-1).to(torch.int32)
    pos = torch.full((B,), DIST_PREFILL, dtype=torch.int32, device=dev)
    want = [tok]
    for _ in range(DIST_TICKS):
        lg, cache = model.decode_step(cfg, params, {"tokens": tok,
                                                    "positions": pos}, cache)
        tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
        want.append(tok)
    del cache
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{tag} (c) the steps' tokens differ from the direct calls'")
    check(same_logits, f"{tag} (c) the prefill step's logits differ from "
          f"model.prefill's")
    print(f"{tag} (c) {cfg.name} bf16: prefill step 8 x {DIST_PREFILL} "
          f"{pre_ms:.1f} ms ({B * DIST_PREFILL / (pre_ms / 1e3):.1f} prefill "
          f"tokens/s), {DIST_TICKS} serve-step ticks p50 "
          f"{statistics.median(tick_ms):.2f} ms (max {max(tick_ms):.2f}; "
          f"{B / (statistics.median(tick_ms) / 1e3):.1f} decode tokens/s); "
          f"tokens and prefill logits equal to model.prefill / decode_step; "
          f"peak memory {peak / 2**30:.2f} GiB; launches {dict(total)}; "
          f"{card_line()}", flush=True)
    return dict(total), pre_ms, statistics.median(tick_ms)


def _dist_dots(tag, cfg, cc, mesh, P, params, adapters, batches, dev,
               recs) -> dict:
    """(a) again at remat "dots" (``recs["full"]``: (a)'s record): a fresh
    ``Offloader``, a warm-up step and DIST_STEPS measured ones, no direct
    calls. Checks that its warm-up step's loss and every tap's (x, grad_h)
    equal (a)'s bit for bit (the same ops on the same inputs: the kept
    products are replayed, the rest recomputed), that a step launches the
    flash kernels as (a)'s (the forward recomputed under both), and that
    the products it ran are (a)'s less the ones it kept, in number and in
    FLOPs. Returns the launch counts of the measured windows."""
    from repro_torch.core import gl
    from repro_torch.core.offload import Offloader

    full, dots = recs["full"], recs["dots"]
    off = Offloader(gl.make_spec(cfg, cc), adapters, _adamw(),
                    interval=cfg.microbatches, device=dev)
    dcfg = cfg.replace(remat="dots")
    launches, _ = _dist_train(f"{tag} (a, dots)", dcfg, cc, mesh, P,
                              params, None, batches, dev, offloader=off,
                              record=dots, direct=False)
    del off
    check(dots["loss"] == full["loss"],
          f"{tag} (a, dots) loss {dots['loss']!r}, not (a)'s {full['loss']!r}")
    check(set(dots["out"]) == set(full["out"]),
          f"{tag} (a, dots) taps {sorted(dots['out'])}")
    for t, (x, g) in full["out"].items():
        check(torch.equal(dots["out"][t][0], x)
              and torch.equal(dots["out"][t][1], g),
              f"{tag} (a, dots) {t}: x or grad_h differ from (a)'s: "
              f"{_same(dots['out'][t][0], x):.3g} / "
              f"{_same(dots['out'][t][1], g):.3g} of the largest entry")
    check(dots["launches"] == full["launches"],
          f"{tag} (a, dots) a step launched {dots['launches']}, not (a)'s "
          f"{full['launches']}")
    (fc, ff), (dc, df) = full["products"], dots["products"]
    kept_n, kept_bytes, kept_flops = dots["kept"]
    check(full["kept"][0] == 0 and kept_n > 0 and fc - dc == kept_n
          and ff - df == kept_flops,
          f"{tag} (a, dots) ran {dc} products ({df:.4g} FLOPs) against "
          f"(a)'s {fc} ({ff:.4g}), keeping {kept_n} ({kept_flops:.4g})")
    print(f"{tag} (a, dots) Mode A at remat dots: step p50 "
          f"{dots['p50']:.1f} ms against (a)'s {full['p50']:.1f} "
          f"({dots['p50'] / full['p50'] - 1:+.1%}); a step's peak "
          f"{dots['peak'] / 2**30:.2f} GiB against {full['peak'] / 2**30:.2f} "
          f"({(dots['peak'] - full['peak']) / 2**30:+.2f} GiB); a step "
          f"launches {dots['launches']} as (a); the untimed warm-up step ran "
          f"{dc} products, {df:.4e} FLOPs, against (a)'s {fc}, {ff:.4e}: "
          f"{kept_n} kept ({kept_bytes / 2**30:.3f} GiB over the step's "
          f"{cfg.microbatches} microbatches, "
          f"{kept_bytes / cfg.microbatches / 2**30:.3f} GiB a microbatch, "
          f"{kept_flops:.4e} FLOPs), replayed and not rerun; loss and every "
          f"tap's (x, grad_h) equal to (a)'s bit for bit; {card_line()}",
          flush=True)
    return launches


def phase_distributed(dev) -> tuple[dict, dict]:
    """mistral-nemo-12b at full width and depth through the step builders on
    a one-card mesh (phase 24; see the module docstring). Returns the
    launch counts of the measured windows and the measured ms of each step
    ({"mode_a", "mode_b", "prefill", "tick"}: p50s, the prefill's one)."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig
    from repro_torch.core import gl
    from repro_torch.core.offload import Offloader
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.models import model
    from repro_torch.utils import tree_leaves

    tag = "[distributed]"
    _process_group(dev, tag)
    try:
        mesh = single_device_mesh()
        cfg = registry.get_config("mistral-nemo-12b")
        check(cfg.microbatches == 8 and cfg.remat == "full"
              and cfg.param_dtype == "bfloat16",
              f"{tag} config {cfg.microbatches} / {cfg.remat} / "
              f"{cfg.param_dtype}")
        torch.cuda.reset_peak_memory_stats(dev)
        params = model.init(cfg, seed=SEED, device=dev)
        ps = sh.params_shardings(mesh, steps.shaped_params(cfg),
                                 policy=cfg.shard_policy)
        P = sh.distribute(mesh, params, ps)
        check(all(d.to_local().data_ptr() == t.data_ptr()
                  for d, t in zip(tree_leaves(P), tree_leaves(params))),
              f"{tag} distribute copied a leaf at one rank")
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"{tag} {cfg.name}: {cfg.n_layers} layers, {n_params} "
              f"parameters ({n_params * 2 / 2**30:.2f} GiB in bf16) placed on "
              f"the {tuple(mesh.shape)} mesh {mesh.mesh_dim_names} without a "
              f"copy; init peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
              f" GiB", flush=True)
        batches = [_dist_batch(cfg, DIST_ROWS, DIST_SEQ, SEED + 10 + i, dev)
                   for i in range(DIST_STEPS + 1)]
        cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                        rank=8)
        adapters = _dist_adapters(cfg, cc, dev)
        ms, recs = {}, {"full": {}, "dots": {}}
        off = Offloader(gl.make_spec(cfg, cc), adapters, _adamw(),
                        interval=cfg.microbatches, device=dev)
        launches, ms["mode_a"] = _dist_train(
            f"{tag} (a)", cfg, cc, mesh, P, params, None, batches, dev,
            offloader=off, record=recs["full"])
        total = collections.Counter(launches)
        del off
        _free()
        total.update(_dist_dots(tag, cfg, cc, mesh, P, params, adapters,
                                batches, dev, recs))
        del recs
        _free()
        launches, ms["mode_b"] = _dist_train(
            f"{tag} (b)", cfg, dataclasses.replace(cc, mode="fused_fit"),
            mesh, P, params, adapters, batches, dev)
        total.update(launches)
        _free()
        launches, ms["prefill"], ms["tick"] = _dist_serve(tag, cfg, mesh, P,
                                                          params, dev)
        total.update(launches)
        del P, params
        _free()
        return dict(total), ms
    finally:
        dist.destroy_process_group()


def phase_distributed_vs_plain(dev) -> None:
    """nemo f32 at full width, 2 layers, through the step builders on the
    card's mesh and on a host mesh of the same group (phase 25)."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import make_mesh, single_device_mesh
    from repro_torch.models import model
    from repro_torch.utils import tree_leaves, tree_map

    tag = "[distributed-vs-plain]"
    _process_group(dev, tag)
    try:
        meshes = {"card": single_device_mesh(),
                  "cpu": make_mesh(1, 1, device_type="cpu")}
        cfg = registry.get_config("mistral-nemo-12b").replace(
            n_layers=2, param_dtype="float32", compute_dtype="float32",
            remat="none")
        params = {"card": model.init(cfg, seed=SEED, device=dev)}
        params["cpu"] = _to(params["card"], "cpu")
        batch = {"card": _dist_batch(cfg, DIST_ROWS, DIST_PLAIN_SEQ,
                                     SEED + 30, dev)}
        batch["cpu"] = _to(batch["card"], "cpu")
        cc = ColaConfig(mode="faithful_offload", family="lowrank", taps="qv",
                        rank=8)
        adapters = {"card": _dist_adapters(cfg, cc, dev)}
        adapters["cpu"] = _to(adapters["card"], "cpu")
        for mode in ("faithful_offload", "fused_fit"):
            c = dataclasses.replace(cc, mode=mode)
            res = {}
            for where, mesh in meshes.items():
                fn, (ps, ash) = steps.make_train_step(cfg, c, mesh)
                t0 = time.perf_counter()
                loss, out = fn(sh.distribute(mesh, params[where], ps),
                               sh.distribute(mesh, adapters[where], ash),
                               batch[where])
                if where == "card":
                    torch.cuda.synchronize()
                res[where] = (loss, [d.to_local() for d in tree_leaves(out)],
                              (time.perf_counter() - t0) * 1e3)
            (lg, og, msg), (lc, oc, msc) = res["card"], res["cpu"]
            lrel = abs(float(lg) - float(lc)) / abs(float(lc))
            worst = max(_same(a, b) for a, b in zip(og, oc))
            check(lrel <= 1e-5 and worst <= 1e-3,
                  f"{tag} {mode}: loss {float(lg)} / {float(lc)} ({lrel:.3g}"
                  f"), outputs {worst:.3g} of the largest entry")
            print(f"{tag} {mode} f32, 2 layers, {cfg.microbatches} "
                  f"microbatches of 1 x {DIST_PLAIN_SEQ}: loss card "
                  f"{float(lg):.6f} / CPU {float(lc):.6f} ({lrel:.3g} "
                  f"relative); {'data' if mode == 'faithful_offload' else 'gradients'}"
                  f" within {worst:.3g} of the largest entry; step ms card "
                  f"{msg:.1f}, CPU {msc:.1f}", flush=True)
            del res
        toks = {}
        for where, mesh in meshes.items():
            d = dev if where == "card" else torch.device("cpu")
            fn_p, _ = steps.make_prefill_step(cfg, mesh)
            fn_s, _ = steps.make_serve_step(cfg, mesh)
            ps = sh.params_shardings(mesh, steps.shaped_params(cfg))
            P = sh.distribute(mesh, params[where], ps)
            logits, pre = fn_p(P, {"tokens": batch[where]["tokens"]})
            cspec, _ = steps.serve_shardings(cfg, mesh, DIST_ROWS,
                                             2 * DIST_PLAIN_SEQ)
            C = sh.distribute(mesh, model.init_cache(
                cfg, DIST_ROWS, 2 * DIST_PLAIN_SEQ, device=d), cspec)
            model.scatter_prefill_cache(tree_map(lambda x: x.to_local(), C),
                                        tree_map(lambda x: x.to_local(), pre),
                                        range(DIST_ROWS))
            tok = logits.to_local().argmax(-1).to(torch.int32)
            pos = torch.full((DIST_ROWS,), DIST_PLAIN_SEQ, dtype=torch.int32,
                             device=d)
            out = [tok.cpu()]
            for _ in range(DIST_PLAIN_TICKS):
                o, C = fn_s(P, C, {"tokens": tok, "positions": pos})
                tok, pos = o.to_local(), pos + 1
                out.append(tok.cpu())
            toks[where] = torch.cat(out, dim=1)
        check(torch.equal(toks["card"], toks["cpu"]),
              f"{tag} serve: card tokens differ from the CPU's")
        print(f"{tag} prefill step 8 x {DIST_PLAIN_SEQ} + "
              f"{DIST_PLAIN_TICKS} serve-step ticks: card tokens == CPU "
              f"tokens ({tuple(toks['card'].shape)}); {card_line()}",
              flush=True)
        del params, adapters
        _free()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 26: the step builders' share of the card's peak
# ---------------------------------------------------------------------------

# (label, ColA mode, step kind, rows, sequence or cache length, phase 24's
# time) of each step phase 24 measures
ROOFLINE_CELLS = (
    ("Mode A step", "faithful_offload", "train", DIST_ROWS, DIST_SEQ,
     "mode_a"),
    ("Mode B step", "fused_fit", "train", DIST_ROWS, DIST_SEQ, "mode_b"),
    ("prefill step", "fused_fit", "prefill", DIST_ROWS, DIST_PREFILL,
     "prefill"),
    ("serve-step tick", "fused_fit", "decode", DIST_ROWS, DIST_MAX_LEN,
     "tick"))


def _cpu_roofline() -> dict:
    """The dry-run's count of phase 24's steps (mistral-nemo-12b whole,
    bf16, remat "full", M 8, rank-8 qv adapters) as rank 0 of a one-rank
    fake group, on the host's plain path: {time key: {"flops",
    "bytes_accessed", "collective_bytes", "memory", "count_s",
    "model_flops"}}, each interpolated from 2, 3 and 4 layers
    (``dryrun.count_by_layers``, exact for the uniform plan)."""
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import single_device_mesh

    cfg = registry.get_config("mistral-nemo-12b")
    out = {}
    with dryrun.fake_world(1):
        mesh = single_device_mesh(device_type="cpu")
        for _, mode, kind, rows, seq, key in ROOFLINE_CELLS:
            cc = ColaConfig(mode=mode, family="lowrank", taps="qv", rank=8)
            c = dryrun.count_by_layers(cfg, cc, kind, rows, seq, mesh)
            c["model_flops"] = rl.model_flops(
                cfg, registry.ShapeSpec(key, kind, seq, rows))
            out[key] = c
    return out


def phase_roofline(counts: dict, ms: dict) -> None:
    """Phase 24's measured steps against the dry-run's count of them (phase
    26): the roofline terms of the count (``roofline.roofline_terms``: the
    counted FLOPs over the bf16 peak, the bytes the step must move over
    HBM's rate), each over the step's measured time, which of the two
    bounds the step, and achieved FLOP/s; a share past 1.05 fails (the
    count or the clock is wrong). The plain path's unfused bytes are
    printed beside them and bound nothing. ``counts``:
    ``_cpu_roofline``'s."""
    from repro_torch.analysis import roofline as rl

    tag = "[roofline]"
    card = card_line()
    for label, mode, kind, rows, seq, key in ROOFLINE_CELLS:
        c, t = counts[key], ms[key] / 1e3
        terms = rl.roofline_terms(c)
        compute, mem = terms["t_compute"] / t, terms["t_memory"] / t
        shape = (f"{rows} x {seq}, M 8" if kind == "train" else
                 f"{rows} x {seq}" if kind == "prefill" else
                 f"{rows} slots of {seq}")
        print(f"{tag} {label} ({mode if kind == 'train' else kind}, {shape}):"
              f" counted {c['flops']:.6e} FLOP (model_flops "
              f"{c['model_flops']:.6e}), inputs + outputs "
              f"{rl.bytes_moved(c['memory'], c['gathered_leaf_bytes']):.6e} "
              f"bytes, unfused plain-path "
              f"bytes {c['bytes_accessed']:.6e} (counted in "
              f"{c['count_s']:.1f} s on the host); measured {ms[key]:.2f}"
              f" ms: {c['flops'] / t:.6e} FLOP/s, {compute:.4f} of the bf16 "
              f"peak ({rl.PEAK_FLOPS:.4g} FLOP/s), {mem:.4f} of the bytes "
              f"bound ({rl.HBM_BW:.4g} B/s): bound by {terms['bottleneck']} "
              f"(unfused bytes {terms['t_memory_unfused'] / t:.4f}); {card}",
              flush=True)
        check(compute <= 1.05 and mem <= 1.05,
              f"{tag} {label}: a share past 1.05 (compute {compute:.3f}, "
              f"bytes {mem:.3f}): the count or the clock is wrong")


# ---------------------------------------------------------------------------
# phase 27: one rank of mistral-large-123b's 16 x 16 mesh, tensor-parallel
# ---------------------------------------------------------------------------

# (label, ColA mode, step kind, the whole batch's rows, sequence): the
# dry-run's train_4k (Mode B, as its fused_fit), prefill_32k and decode_32k
# cells (a serve-step tick against the 32,768-position cache)
TP_CELLS = (("train_4k", "fused_fit", "train", 256, 4096),
            ("prefill_32k", "fused_fit", "prefill", 32, 32768),
            ("decode_32k", None, "decode", 128, 32768))
TP_HEADS = (6, 1, 128)   # a rank's query heads, KV heads, d_head on 16
# a tick's decode launches: every head, over the rank's 2,048 positions
TP_DECODE = (96, 8, 128, 2048)
TP_TICKS = 5
ATTN_KERNELS = ("flash_attention", "bwd_dq", "bwd_dkv")
# the dry-run's peak a rank in bytes, copied from the record that
# TP_DRYRUN_RECORD names (with the sequence split); the measured peak must
# lie within 10 % of it. A change to the step builders or the models moves
# it: recount with that command and copy the new value here.
TP_DRYRUN_PEAK = {"train_4k": 3659634712, "prefill_32k": 10867466240}
TP_DRYRUN_RECORD = ("memory.peak_bytes_per_device of the {label} record of "
                    "`python -m repro_torch.launch.dryrun --arch "
                    "mistral-large-123b --shape {label} --mesh single` "
                    "(mesh pod16x16, mode fused_fit)")


# phase 28: one rank of zamba2-7b's 16 x 16 mesh, its Mamba2 heads split:
# the same three cells, train_4k cut to 1 of its 8 microbatches (32 rows:
# the rank's 2 x 4096); its 8 took 172.6 s a step on the card, past the
# script's time (ROADMAP, "Budget of the chip script")
SSM_CELLS = (("train_4k", "fused_fit", "train", 32, 4096),
             ("prefill_32k", "fused_fit", "prefill", 32, 32768),
             ("decode_32k", None, "decode", 128, 32768))
SSM_LAYERS, SSM_CALLS = 81, 14    # Mamba2 layers, shared-block calls
SSM_HEADS = 7                     # a rank's SSD heads: 112 over 16
SSM_ATTN = (2, 2, 112)            # the shared block's heads a rank
SSM_DECODE = (32, 32, 112, 2048)  # a tick's decode: every head, 2,048
# a rank's state blocks in the serve step: (layers, slots, heads, P, N)
# and (layers, slots, W - 1, channels: 7,296 over 16)
SSM_BLOCKS = {"layers.ssm": [81, 8, 7, 64, 64],
              "layers.conv": [81, 8, 3, 456]}
# the dry-run's peak a rank in bytes, as TP_DRYRUN_PEAK, from the records
# SSM_DRYRUN_RECORD names (train_4k's of all 8 microbatches, counted by
# layers: its three depths' peaks grow linearly)
SSM_DRYRUN_PEAK = {"train_4k": 2676863712, "prefill_32k": 11668577408,
                   "decode_32k": 4422185196}
SSM_DRYRUN_RECORD = ("memory.peak_bytes_per_device of the {label} record of "
                     "`python -m repro_torch.launch.dryrun --arch zamba2-7b "
                     "--shape {label} --mesh single{flags}` (mesh pod16x16, "
                     "mode fused_fit)")


# phase 29: one rank of dbrx-132b's 16 x 16 mesh, its experts split over
# "model": the same three cells, train_4k at all 8 microbatches (the rank's
# 2 x 4096 each)
EP_LAYERS = 40
EP_HEADS = (3, 1, 128)             # 48 / 16 query heads, a KV head of 8 shared
EP_DECODE = (48, 8, 128, 2048)     # a tick's decode: every head, 2,048
# every expert leaf as the rank gathers it: its 1 expert of 16, d_model
# gathered over "data" (gate, up; down's (1, 10752, 6144))
EP_EXPERTS = {"layers.moe.gate": [1, 6144, 10752],
              "layers.moe.up": [1, 6144, 10752],
              "layers.moe.down": [1, 10752, 6144]}
# the dry-run's peak a rank in bytes, as TP_DRYRUN_PEAK, from the records
# EP_DRYRUN_RECORD names
EP_DRYRUN_PEAK = {"train_4k": 2599483644, "prefill_32k": 6744617120,
                  "decode_32k": 4268234028}
EP_DRYRUN_RECORD = ("memory.peak_bytes_per_device of the {label} record of "
                    "`python -m repro_torch.launch.dryrun --arch dbrx-132b "
                    "--shape {label} --mesh single` (mesh pod16x16, mode "
                    "fused_fit)")


def _rank_blocks(mesh, shaped: dict, specs: dict, gen, dev, std) -> dict:
    """Rank 0's block of every leaf of ``shaped`` (meta) under its spec, as
    DTensors of the whole leaf's shape: each block drawn on the card from
    ``gen`` in f32 (``std(path, leaf)`` its scale, None: ones) and cast to
    the leaf's dtype; the whole leaf never exists."""
    from repro_torch.distributed import sharding as sh

    mshape = sh.mesh_shape(mesh)
    flat = {}
    sh._map(lambda p, x: flat.__setitem__(p, x), specs)

    def one(path, leaf):
        spec = flat[path]
        local = [n // sh._size(mshape, sh._entry_axes(e))
                 for n, e in zip(leaf.shape, spec)]
        scale = std(sh._path_str(path), leaf)
        if scale is None:
            x = torch.ones(local, dtype=leaf.dtype, device=dev)
        else:
            x = torch.randn(local, generator=gen, device=dev,
                            dtype=torch.float32).mul_(scale).to(leaf.dtype)
        return sh.wrap(mesh, x, spec, leaf.shape)

    return sh._map(one, shaped)


class _HeadRecorder:
    """Records the (query heads, KV heads, d_head, key positions) of every
    flash and dense decode launch while active: each wrapper is replaced by
    one that notes its shapes and calls it (its launch counter keeps
    counting: the wrapper reads its counter by its module's name)."""

    def __enter__(self):
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import flash_attention as fa

        self.seen = collections.Counter()
        self.orig = [(fa, n, getattr(fa, n)) for n in ATTN_KERNELS]
        self.orig.append((da, "decode_attention", da.decode_attention))
        for mod, n, f in self.orig:
            def rec(q, k, *a, _n=n, _f=f, **kw):
                self.seen[_n, q.shape[2], k.shape[2], q.shape[3],
                          k.shape[1]] += 1
                return _f(q, k, *a, **kw)
            rec.launches = f.launches
            setattr(mod, n, rec)
        return self

    def __exit__(self, *exc):
        for mod, n, f in self.orig:
            f.launches = getattr(mod, n).launches
            setattr(mod, n, f)


class _SsdRecorder:
    """Records the head count of every SSD scan and recurrence step while
    active (``kernels.ops.ssd`` / ``ssd_decode_step``, which the Mamba2
    mixer calls through the module)."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.seen = collections.Counter()
        self.ops, self.orig = ops, (ops.ssd, ops.ssd_decode_step)
        ssd, step = self.orig

        def ssd_seen(x, *a, **kw):
            self.seen["ssd", x.shape[2]] += 1
            return ssd(x, *a, **kw)

        def step_seen(x, *a, **kw):
            self.seen["ssd_decode_step", x.shape[1]] += 1
            return step(x, *a, **kw)

        ops.ssd, ops.ssd_decode_step = ssd_seen, step_seen
        return self

    def __exit__(self, *exc):
        self.ops.ssd, self.ops.ssd_decode_step = self.orig


class _ExpertRecorder:
    """Records, while active, the experts of every expert MLP call (the
    dispatched activations' and the expert leaves' expert dims: the MoE
    blocks call ``models.moe._expert_ffn`` through the module)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.seen = collections.Counter()
        self.moe, self.orig = moe, moe._expert_ffn

        def ffn(params, h):
            self.seen[h.shape[-3], params["gate"].shape[-3]] += 1
            return self.orig(params, h)

        moe._expert_ffn = ffn
        return self

    def __exit__(self, *exc):
        self.moe._expert_ffn = self.orig


# the rank shares run in processes of their own: phase 27's
# mistral-large-123b (``--tensor-parallel``), and phase 28's zamba2-7b
# (``--ssm-parallel``) and phase 29's dbrx-132b (``--expert-parallel``) in
# one: (tag, arch, cells, its layers, microbatches and remat, whether the
# train step is timed after a warm-up step)
RANK_SHARES = {
    "--tensor-parallel": ("[tensor-parallel]", "mistral-large-123b",
                          TP_CELLS, (88, 8, "full"), True),
    "--ssm-parallel": ("[ssm-parallel]", "zamba2-7b", SSM_CELLS,
                       (81, 8, "full"), False),
    "--expert-parallel": ("[expert-parallel]", "dbrx-132b", TP_CELLS,
                          (40, 8, "full"), False),
}


def tensor_parallel_main(shares: list[tuple[str, str]]) -> int:
    """The rank shares' process (``chip_smoke.py --tensor-parallel
    OUT.json``; ``--ssm-parallel OUT.json --expert-parallel OUT.json``):
    rank 0 of a fake process group of 256 ranks (its collectives return at
    once and move no data) on a 16 x 16 mesh of the card; for each (flag,
    path) of ``shares`` in turn, its config (``RANK_SHARES``) at full width
    and depth, its leaves the rank's blocks drawn on the card
    (``_rank_share_run``), the numbers written to the path."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_production_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_production_mesh(device_type="cuda")
        for which, out_path in shares:
            t0 = time.perf_counter()
            res = _rank_share_run(which, mesh, dev)
            res["seconds"] = time.perf_counter() - t0
            Path(out_path).write_text(json.dumps(res))
            _free()
    finally:
        dist.destroy_process_group()
    return 0


def _rank_share_run(which: str, mesh, dev) -> dict:
    """One rank share: each of its cells through the step builders,
    launches, SSD head counts, expert counts and peak counted, the train
    step timed after a warm-up step where the share asks for one (the
    serve step: ``TP_TICKS`` timed ticks after a warm-up, the collectives
    of a recorded tick and whether each cache block was updated in
    place)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ColaConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import steps
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import model as model_lib

    tag, arch, cells, expect, warm = RANK_SHARES[which]
    res = {}
    cfg = registry.get_config(arch)
    check((cfg.n_layers, cfg.microbatches, cfg.remat) == expect,
          f"{tag} config {cfg}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shaped = steps.shaped_params(cfg)
    ps = sh.params_shardings(mesh, shaped, policy=cfg.shard_policy)

    def std(path, leaf):
        if path.endswith(".scale"):
            return None
        return 0.02 if path.endswith("emb") else leaf.shape[-2] ** -0.5

    P = _rank_blocks(mesh, shaped, ps, gen, dev, std)
    held = sum(x.numel() * x.element_size() for x in _local_leaves(P))
    whole = sum(t.numel() * t.element_size()
                for t in _local_leaves(shaped))
    mixer = (f", {cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim} SSD "
             f"heads of {cfg.ssm_headdim}, state {cfg.ssm_state}, a "
             f"shared block every {cfg.shared_attn_every} layers"
             if cfg.ssm_state else "")
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}{mixer}, bf16, remat "
          f"{cfg.remat}; rank 0 of a fake group of 256 on the 16 x 16 "
          f"mesh {mesh.mesh_dim_names}: its blocks "
          f"{held / 2**30:.3f} GiB of the tree's {whole / 2**30:.1f} GiB",
          flush=True)
    for label, mode, kind, rows, seq in cells:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        m = 1
        if kind == "train":
            cc = ColaConfig(mode=mode, family="lowrank", taps="qv",
                            rank=16)
            # a cut batch keeps a microbatch's rows: fewer of them
            m = rows // 16 // (256 // 16 // cfg.microbatches)
            fn, (_, ash) = steps.make_train_step(
                cfg.replace(microbatches=m), cc, mesh)
            A = _rank_blocks(
                mesh, steps.shaped_adapters(cfg, cc), ash, gen, dev,
                lambda p, leaf: (leaf.shape[-1] ** -0.5
                                 if p.endswith(".A") else 0.01))
            batch = _dist_batch(cfg, rows, seq, SEED + 40, dev)
            step = (lambda: fn(P, A, batch))
            if warm:
                fn(P, A, batch)
        elif kind == "decode":
            res[label] = _tp_decode(cfg, mesh, P, gen, dev, rows, seq,
                                    tag)
            continue
        else:
            fn, _ = steps.make_prefill_step(cfg, mesh)
            toks = torch.as_tensor(np.random.default_rng(SEED + 41)
                                   .integers(0, cfg.vocab_size,
                                             (rows, seq))
                                   .astype(np.int32), device=dev)
            step = (lambda: fn(P, {"tokens": toks}))
        _free()
        torch.cuda.reset_peak_memory_stats(dev)
        with _HeadRecorder() as heads, _SsdRecorder() as ssd, \
                _ExpertRecorder() as experts, tp.gather_meter() as leaves, \
                model_lib.layer_input_meter() as saved:
            t0 = time.perf_counter()
            out, launches = _counted(step)
            ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        del out
        _free()
        res[label] = {
            "ms": ms, "peak": peak, "launches": launches,
            "heads": [list(k) + [v] for k, v in heads.seen.items()],
            "ssd": [list(k) + [v] for k, v in ssd.seen.items()],
            "rows": rows // 16 // m, "microbatches": m, "seq": seq,
            "layer_inputs": sorted(set(saved.shapes)),
            "layer_input_bytes": saved.bytes, **_expert_numbers(experts,
                                                                 leaves)}
        timed = ("one step, no warm-up" if kind == "train" and not warm
                 else "one step after a warm-up" if kind == "train"
                 else "one call")
        print(f"{tag} {label} ({mode if kind == 'train' else kind}): the "
              f"rank's share, {m} x {rows // 16 // m} x {seq}: "
              f"{ms:.1f} ms ({timed}; the "
              f"collectives' time left out: the fake group moves "
              f"nothing); peak memory {peak / 2**30:.2f} GiB "
              f"(torch.cuda.max_memory_allocated); launches "
              f"{ {k: v for k, v in launches.items() if v} }; flash "
              f"launches by (kernel, query heads, KV heads, d_head): "
              f"{dict(heads.seen)}"
              + (f"; SSD calls by (op, heads): {dict(ssd.seen)}"
                 if ssd.seen else "") + f"; {card_line()}", flush=True)
        kept = ("what remat saves for the recompute" if kind == "train"
                else "none saved: a prefill takes no gradient")
        print(f"{tag} {label}: the residual stream between blocks "
              f"(sequence split over the 16 \"model\" ranks): layer "
              f"inputs {sorted(set(saved.shapes))}, {len(saved.shapes)} "
              f"of them, {saved.bytes / m / 2**30:.3f} GiB a "
              f"(micro)batch ({kept}), {saved.bytes / 2**30:.3f} GiB "
              f"in all, counted as each layer's input is passed",
              flush=True)
    print(f"{tag} values not checked: the fake group's collectives move "
          f"no data, so the gathered leaves and activations are not the "
          f"model's (numerics: world size 8 == 1 on the CPU's gloo "
          f"groups, phases 24-25 at world size 1)", flush=True)
    return res


def _expert_numbers(experts: "_ExpertRecorder", leaves) -> dict:
    """An MoE step's expert MLP calls by (dispatched experts, the leaves'
    experts) and the expert leaves as gathered: their shapes and bytes
    (``tensor_parallel.gather_meter``)."""
    if not experts.seen:
        return {}
    moe = {p: b for p, b in leaves.by_leaf.items() if ".moe." in f".{p}"}
    return {"experts": [list(k) + [v] for k, v in experts.seen.items()],
            "expert_leaves": {p: sorted(leaves.shapes[p]) for p in moe},
            "expert_bytes": sum(moe.values())}


def _tp_decode(cfg, mesh, P, gen, dev, rows: int, seq: int, tag: str
               ) -> dict:
    """decode_32k's rank share through ``make_serve_step``: the cache the
    rank's block under ``cache_shardings`` (8 slots x 2,048 positions of
    32,768, every layer) drawn on the card, every slot's position in the
    last 2,048 (so rank 0's block is wholly live); a tick under the
    collective recorder (no collective may move a KV leaf, every block must
    come back as the same storage), a warm-up, then ``TP_TICKS`` ticks, each
    timed and its launches and decode shapes counted."""
    from repro_torch.analysis import collectives
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import steps
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import model as model_lib

    fn, _ = steps.make_serve_step(cfg, mesh)
    cspec, _ = steps.serve_shardings(cfg, mesh, rows, seq)
    shaped = {st: {n: torch.empty(shape, dtype=dt, device="meta")
                   for n, (shape, dt) in leaves.items()}
              for st, leaves in model_lib.cache_specs(cfg, rows,
                                                      seq).items()}
    C = _rank_blocks(mesh, shaped, cspec, gen, dev, lambda p, leaf: 0.5)
    held = sum(x.numel() * x.element_size() for x in _local_leaves(C))
    rng = np.random.default_rng(SEED + 42)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (rows, 1)).astype(np.int32), device=dev),
        "positions": torch.as_tensor(rng.integers(
            seq - 2048, seq, rows).astype(np.int32), device=dev)}
    before = {(st, n): d.to_local().untyped_storage().data_ptr()
              for st, leaves in C.items() for n, d in leaves.items()}
    rec = collectives.CollectiveRecorder()
    with rec:
        _, new = fn(P, C, batch)
    in_place = all(new[st][n].to_local().untyped_storage().data_ptr() == p
                   and new[st][n].placements == sh.placements(
                       mesh, cspec[st][n])
                   for (st, n), p in before.items())
    moves = collectives.by_leaf(rec.records)
    blocks = {f"{st}.{n}": list(d.to_local().shape)
              for st, leaves in new.items() for n, d in leaves.items()}
    del new, rec
    fn(P, C, batch)   # warm-up
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    ms, per_tick = [], []
    with _HeadRecorder() as heads, _SsdRecorder() as ssd, \
            _ExpertRecorder() as experts, tp.gather_meter() as leaves:
        for _ in range(TP_TICKS):
            t0 = time.perf_counter()
            out, launches = _counted(lambda: fn(P, C, batch))
            ms.append((time.perf_counter() - t0) * 1e3)
            per_tick.append({k: v for k, v in launches.items() if v})
            del out
    peak = torch.cuda.max_memory_allocated(dev)
    p50 = statistics.median(ms)
    print(f"{tag} decode_32k (serve step, greedy): the rank's share, "
          f"{rows // 16} slots x 2,048 of {seq} positions, its cache blocks "
          f"{held / 2**30:.3f} GiB: tick p50 {p50:.2f} ms over {TP_TICKS} "
          f"ticks ({', '.join(f'{t:.2f}' for t in ms)}; the collectives' "
          f"time left out); peak memory {peak / 2**30:.2f} GiB; launches a "
          f"tick {per_tick[0]}; decode launches by (kernel, query heads, KV "
          f"heads, d_head, positions): {dict(heads.seen)}"
          + (f"; SSD steps by (op, heads): {dict(ssd.seen)}" if ssd.seen
             else "")
          + f"; collectives by label: {moves or 'none'}; cache blocks "
          f"{blocks}; every block updated in place: {in_place}; "
          f"{card_line()}", flush=True)
    return {"ms": p50, "ticks": ms, "peak": peak, "launches": per_tick,
            "heads": [list(k) + [v] for k, v in heads.seen.items()],
            "ssd": [list(k) + [v] for k, v in ssd.seen.items()],
            "rows": rows // 16, "seq": seq, "cache_bytes": held,
            "moves": moves, "in_place": in_place, "blocks": blocks,
            **_expert_numbers(experts, leaves)}


def _local_leaves(tree) -> list:
    out: list = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        else:
            out.append(x.to_local() if hasattr(x, "to_local") else x)
    walk(tree)
    return out


def _rank_shares(*whiches: str) -> dict:
    """The rank shares ``whiches`` in one process (``tensor_parallel_main``)
    run to its end and their numbers read back, by flag."""
    outs = {w: ROOT / "build" / f"chip_smoke{w.replace('-', '_')}.json"
            for w in whiches}
    args = []
    for w, out in outs.items():
        out.unlink(missing_ok=True)
        args += [w, str(out)]
    _free()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           *args], cwd=ROOT, timeout=600)
    tags = " ".join(RANK_SHARES[w][0] for w in whiches)
    check(proc.returncode == 0 and all(o.exists() for o in outs.values()),
          f"{tags} the ranks' process ended with rc {proc.returncode}")
    return {w: json.loads(out.read_text()) for w, out in outs.items()}


def phase_tensor_parallel(res: dict) -> dict:
    """Phase 27 (``res``: its numbers from the process it shares with
    phases 28 and 29, ``_rank_shares``; the process group is global): rank
    0 of mistral-large-123b's 16 x 16 mesh through the step builders.
    Checks that
    each step's flash launches are exactly the rank's (train: M x L x 2
    forwards with the recompute, M x L dq and dk/dv; prefill: L forwards),
    every one at 6 query heads and 1 KV head of 128, and that every serve
    tick launches the dense decode kernel L times at 96 query / 8 KV heads
    of 128 over the rank's 2,048 positions and nothing else, moves no KV
    leaf and updates every cache block in place, at a peak below 20 GiB;
    returns the launches of every step."""
    tag = "[tensor-parallel]"
    L, total = 88, collections.Counter()
    for label, mode, kind, rows, seq in TP_CELLS:
        r = res[label]
        if kind == "decode":
            want = {"decode_attention": L}
            check(all(t == want for t in r["launches"]),
                  f"{tag} {label} launched {r['launches']}, not {want} a "
                  f"tick")
            check(all(tuple(h[1:5]) == TP_DECODE for h in r["heads"])
                  and sum(h[5] for h in r["heads"]) == L * TP_TICKS,
                  f"{tag} {label}: decode ran at {r['heads']}, not "
                  f"{TP_DECODE}")
            check(not [k for k in r["moves"] if k.endswith((".k", ".v"))]
                  and r["in_place"],
                  f"{tag} {label}: a KV leaf moved ({r['moves']}) or a block "
                  f"came back other than in place ({r['in_place']})")
            check(r["peak"] < 20 * 2**30,
                  f"{tag} {label}: peak {r['peak'] / 2**30:.2f} GiB")
            total.update({k: v * TP_TICKS for k, v in want.items()})
            continue
        m = r["microbatches"]
        want = ({"flash_attention": 2 * m * L, "flash_attention_bwd_dq": m * L,
                 "flash_attention_bwd_dkv": m * L} if kind == "train"
                else {"flash_attention": L})
        got = {k: v for k, v in r["launches"].items() if v}
        check(got == want, f"{tag} {label} launched {got}, not {want}")
        check(all(tuple(h[1:4]) == TP_HEADS for h in r["heads"])
              and sum(h[5] for h in r["heads"]) == sum(want.values()),
              f"{tag} {label}: flash ran at {r['heads']}, not {TP_HEADS}")
        # the rank's rows of the sequence between blocks: S / 16
        rows_in = (r["rows"], seq // 16, 12288)
        check(r["layer_inputs"] == [list(rows_in)],
              f"{tag} {label}: layer inputs {r['layer_inputs']}, not "
              f"{rows_in}")
        dry = TP_DRYRUN_PEAK[label]
        source = (f"TP_DRYRUN_PEAK[{label!r}] = {dry} B, "
                  + TP_DRYRUN_RECORD.format(label=label))
        check(abs(r["peak"] / dry - 1) <= 0.10,
              f"{tag} {label}: peak {r['peak'] / 2**30:.2f} GiB, not "
              f"within 10 % of the dry-run's {dry / 2**30:.2f} GiB "
              f"({source}; recount it if the step has changed)")
        print(f"{tag} {label}: peak {r['peak'] / 2**30:.2f} GiB, the "
              f"dry-run's {dry / 2**30:.2f} GiB ({r['peak'] / dry - 1:+.1%}; "
              f"{source})", flush=True)
        total.update(got)
    return dict(total)


def phase_ssm_parallel(res: dict) -> dict:
    """Phase 28 (``res``: its numbers from the process it shares with phase
    29, ``_rank_shares``): rank 0 of zamba2-7b's 16 x 16 mesh
    through the step builders, its Mamba2 mixers scanning 7 of the 112 SSD
    heads. Checks every step's flash launches (train: M x 14 x 2 forwards
    with the recompute, M x 14 dq and dk/dv; prefill: 14 forwards) at the
    shared block's 2 query / 2 KV heads of 112, every SSD scan at 7 heads,
    the layer inputs the rank's (2, S / 16, 3584) rows; every tick's 14
    dense decode launches (the log-sum-exp entry) at 32 / 32 heads of 112
    over the rank's 2,048 positions and 81 SSD steps at 7 heads, no KV or
    SSM state leaf moved, the conv state gathered a layer at a time, every
    cache block (the state's (8, 7, 64, 64) a layer) updated in place;
    each peak within 10 % of the dry-run's; returns the launches of every
    step."""
    tag = "[ssm-parallel]"
    total = collections.Counter()
    for label, mode, kind, rows, seq in SSM_CELLS:
        r = res[label]
        if kind == "decode":
            want = {"decode_attention": SSM_CALLS}
            check(all(t == want for t in r["launches"]),
                  f"{tag} {label} launched {r['launches']}, not {want} a "
                  f"tick")
            check(all(tuple(h[1:5]) == SSM_DECODE for h in r["heads"])
                  and sum(h[5] for h in r["heads"]) == SSM_CALLS * TP_TICKS,
                  f"{tag} {label}: decode ran at {r['heads']}, not "
                  f"{SSM_DECODE}")
            check(r["ssd"] == [["ssd_decode_step", SSM_HEADS,
                                SSM_LAYERS * TP_TICKS]],
                  f"{tag} {label}: SSD steps {r['ssd']}, not "
                  f"{SSM_LAYERS} a tick at {SSM_HEADS} heads")
            moved = {k for k in r["moves"] if k.startswith("cache.")}
            conv = r["moves"].get("cache.layers.conv", {})
            check(moved == {"cache.layers.conv"}
                  and set(conv) == {"all-gather"},
                  f"{tag} {label}: cache collectives {r['moves']}, not the "
                  f"conv state's gathers alone")
            check(r["in_place"] and all(r["blocks"][k] == v
                                        for k, v in SSM_BLOCKS.items()),
                  f"{tag} {label}: a block came back other than in place "
                  f"({r['in_place']}) or not the rank's ({r['blocks']})")
            print(f"{tag} {label}: the SSM state stays the rank's heads "
                  f"block {r['blocks']['layers.ssm']} (no collective "
                  f"labelled with it), the conv state's channel block "
                  f"{r['blocks']['layers.conv']} gathered a layer at a time: "
                  f"{conv['all-gather'] / 1e6:.2f} MB a tick (all-gather)",
                  flush=True)
        else:
            m = r["microbatches"]
            want = ({"flash_attention": 2 * m * SSM_CALLS,
                     "flash_attention_bwd_dq": m * SSM_CALLS,
                     "flash_attention_bwd_dkv": m * SSM_CALLS}
                    if kind == "train" else {"flash_attention": SSM_CALLS})
            got = {k: v for k, v in r["launches"].items() if v}
            check(got == want, f"{tag} {label} launched {got}, not {want}")
            check(all(tuple(h[1:4]) == SSM_ATTN for h in r["heads"])
                  and sum(h[5] for h in r["heads"]) == sum(want.values()),
                  f"{tag} {label}: flash ran at {r['heads']}, not "
                  f"{SSM_ATTN}")
            scans = (2 if kind == "train" else 1) * m * SSM_LAYERS
            check(all(h[:2] == ["ssd", SSM_HEADS] for h in r["ssd"])
                  and sum(h[2] for h in r["ssd"]) == scans,
                  f"{tag} {label}: SSD scans {r['ssd']}, not {SSM_HEADS} "
                  f"heads")
            rows_in = (r["rows"], seq // 16, 3584)
            check(r["layer_inputs"] == [list(rows_in)],
                  f"{tag} {label}: layer inputs {r['layer_inputs']}, not "
                  f"{rows_in}")
        total.update(want if kind != "decode" else
                     {k: v * TP_TICKS for k, v in want.items()})
        dry = SSM_DRYRUN_PEAK[label]
        flags = " --by-layers --jobs 3" if kind == "train" else ""
        source = (f"SSM_DRYRUN_PEAK[{label!r}] = {dry} B, "
                  + SSM_DRYRUN_RECORD.format(label=label, flags=flags))
        check(abs(r["peak"] / dry - 1) <= 0.10,
              f"{tag} {label}: peak {r['peak'] / 2**30:.2f} GiB, not "
              f"within 10 % of the dry-run's {dry / 2**30:.2f} GiB "
              f"({source}; recount it if the step has changed)")
        print(f"{tag} {label}: peak {r['peak'] / 2**30:.2f} GiB, the "
              f"dry-run's {dry / 2**30:.2f} GiB ({r['peak'] / dry - 1:+.1%}; "
              f"{source})", flush=True)
    return dict(total)


def phase_expert_parallel(res: dict) -> dict:
    """Phase 29 (``res``: its numbers from the process it shares with phase
    28): rank 0 of dbrx-132b's 16 x 16 mesh through the step builders, its
    MoE FFN split by experts over "model". Checks every expert MLP call
    (forward and recompute) at the rank's 1 of the 16 experts, every
    expert leaf gathered as its 1-expert block (d_model gathered over
    "data", never a whole layer's experts), every step's flash launches
    (train: M x 40 x 2 forwards with the recompute, M x 40 dq and dk/dv;
    prefill: 40 forwards) at 3 query heads and the 1 KV head they read, of
    128, the layer inputs the rank's (2, S / 16, 6144) rows; every tick's
    40 dense decode launches (the log-sum-exp entry) at 48 / 8 heads over
    2,048 positions, no KV leaf moved, every cache block in place; each
    peak within 10 % of the dry-run's (``EP_DRYRUN_PEAK``); returns the
    launches of every step."""
    tag = "[expert-parallel]"
    L, total = EP_LAYERS, collections.Counter()
    # one layer's expert leaves, bf16: the rank's 1 expert, and all 16 (what
    # a replicated FFN gathers)
    one = sum(int(np.prod(v)) for v in EP_EXPERTS.values()) * 2
    for label, mode, kind, rows, seq in TP_CELLS:
        r = res[label]
        if kind == "decode":
            want = {"decode_attention": L}
            check(all(t == want for t in r["launches"]),
                  f"{tag} {label} launched {r['launches']}, not {want} a "
                  f"tick")
            check(all(tuple(h[1:5]) == EP_DECODE for h in r["heads"])
                  and sum(h[5] for h in r["heads"]) == L * TP_TICKS,
                  f"{tag} {label}: decode ran at {r['heads']}, not "
                  f"{EP_DECODE}")
            check(not [k for k in r["moves"] if k.endswith((".k", ".v"))]
                  and r["in_place"],
                  f"{tag} {label}: a KV leaf moved ({r['moves']}) or a block "
                  f"came back other than in place ({r['in_place']})")
            calls = L * TP_TICKS
            total.update({k: v * TP_TICKS for k, v in want.items()})
        else:
            m = r["microbatches"]
            want = ({"flash_attention": 2 * m * L,
                     "flash_attention_bwd_dq": m * L,
                     "flash_attention_bwd_dkv": m * L} if kind == "train"
                    else {"flash_attention": L})
            got = {k: v for k, v in r["launches"].items() if v}
            check(got == want, f"{tag} {label} launched {got}, not {want}")
            check(all(tuple(h[1:4]) == EP_HEADS for h in r["heads"])
                  and sum(h[5] for h in r["heads"]) == sum(want.values()),
                  f"{tag} {label}: flash ran at {r['heads']}, not "
                  f"{EP_HEADS}")
            rows_in = (r["rows"], seq // 16, 6144)
            check(r["layer_inputs"] == [list(rows_in)],
                  f"{tag} {label}: layer inputs {r['layer_inputs']}, not "
                  f"{rows_in}")
            calls = (2 * m if kind == "train" else 1) * L
            total.update(want)
        check(r["experts"] == [[1, 1, calls]],
              f"{tag} {label}: expert MLP calls by (dispatched experts, "
              f"leaves' experts) {r['experts']}, not {calls} at 1 of 16")
        check(r["expert_leaves"] == {p: [v] for p, v in EP_EXPERTS.items()}
              and r["expert_bytes"] == calls * one,
              f"{tag} {label}: expert leaves gathered as "
              f"{r['expert_leaves']}, {r['expert_bytes']} B, not the rank's "
              f"1-expert blocks {EP_EXPERTS}, {calls} x {one} B")
        print(f"{tag} {label}: {calls} expert MLP calls, every one at the "
              f"rank's 1 of 16 experts; its expert leaves gathered as "
              f"{ {p: v[0] for p, v in r['expert_leaves'].items()} }: "
              f"{r['expert_bytes'] / 1e9:.3f} GB in all, {one / 1e6:.1f} MB "
              f"a layer against the 16 experts' {16 * one / 1e9:.3f} GB "
              f"(1/16)", flush=True)
        dry = EP_DRYRUN_PEAK[label]
        source = (f"EP_DRYRUN_PEAK[{label!r}] = {dry} B, "
                  + EP_DRYRUN_RECORD.format(label=label))
        check(abs(r["peak"] / dry - 1) <= 0.10,
              f"{tag} {label}: peak {r['peak'] / 2**30:.2f} GiB, not "
              f"within 10 % of the dry-run's {dry / 2**30:.2f} GiB "
              f"({source}; recount it if the step has changed)")
        print(f"{tag} {label}: peak {r['peak'] / 2**30:.2f} GiB, the "
              f"dry-run's {dry / 2**30:.2f} GiB ({r['peak'] / dry - 1:+.1%}; "
              f"{source})", flush=True)
    return dict(total)


# ---------------------------------------------------------------------------
# the CPU halves of phases 12, 13 (b), 16, 18, 20 and 23 and phase 26's
# count, in a worker process
# ---------------------------------------------------------------------------

# in the order the phases need them
CPU_JOBS = ("gemma2-vs-plain", "gemma2-train", "moe-vs-plain", "ssm-vs-plain",
            "hybrid-vs-plain", *(f"modality-vs-plain-{n}"
                                 for n in MODALITY_PLAIN), "roofline")


def _cpu_job(job: str):
    if job == "gemma2-vs-plain":
        return _cpu_gemma2_vs_plain()
    if job == "gemma2-train":
        return _cpu_gemma2_train()
    if job == "moe-vs-plain":
        return _cpu_engine_vs_plain(MOE_PLAIN, "[moe-vs-plain]", 1,
                                    routing=True)
    if job == "ssm-vs-plain":
        return _cpu_engine_vs_plain(SSM_PLAIN, "[ssm-vs-plain]", 2)
    if job == "hybrid-vs-plain":
        return _cpu_engine_vs_plain(HYBRID_PLAIN, "[hybrid-vs-plain]", 1)
    if job == "roofline":
        return _cpu_roofline()
    return _cpu_modality_vs_plain(job.removeprefix("modality-vs-plain-"))


def cpu_halves_main(out_dir: str, threads: int) -> int:
    """The worker: every job of ``CPU_JOBS`` in turn on ``threads`` of the
    host's cores, each result saved whole to ``out_dir/<job>.pt``. It dies
    with the script that started it."""
    import ctypes
    import gc
    import signal

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    torch.set_num_threads(threads)
    sys.path.insert(0, str(ROOT / "src"))
    out = Path(out_dir)
    for job in CPU_JOBS:
        tmp = out / f"{job}.pt.part"
        torch.save(_cpu_job(job), tmp)
        os.replace(tmp, out / f"{job}.pt")
        gc.collect()
    return 0


class CpuHalves:
    """The worker process (``chip_smoke.py --cpu-halves DIR THREADS``, no
    card in its environment) that computes the CPU halves of the comparison
    phases from the same seeds as their card halves while the card's phases
    run, leaving the card's phases two of the host's cores. The halves are
    the CPU's plain path, as they were in the script's own process."""

    def __init__(self, out_dir: Path):
        self.dir = out_dir
        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True)
        self.log = open(self.dir / "worker.log", "w")
        threads = max(1, len(os.sched_getaffinity(0)) - 2)
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cpu-halves",
             str(self.dir), str(threads)], cwd=ROOT, stdout=self.log,
            stderr=subprocess.STDOUT, env=dict(os.environ,
                                               CUDA_VISIBLE_DEVICES=""))
        print(f"[cpu-halves] worker started on {threads} CPU threads: "
              f"{', '.join(CPU_JOBS)}", flush=True)

    def get(self, job: str, timeout: float = 900.0):
        """``job``'s result, waiting for the worker; fails if it ended
        without it."""
        path = self.dir / f"{job}.pt"
        t0 = time.perf_counter()
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                self.log.flush()
                tail = (self.dir / "worker.log").read_text()[-4000:]
                check(False, f"the CPU worker ended with rc "
                      f"{self.proc.returncode} before {job}:\n{tail}")
            check(time.perf_counter() - t0 < timeout,
                  f"the CPU worker gave no {job} in {timeout:.0f} s")
            time.sleep(0.1)
        waited = time.perf_counter() - t0
        out = torch.load(path, weights_only=False)
        path.unlink()
        print(f"[cpu-halves] {job}: waited {waited:.1f} s", flush=True)
        return out

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


_HALVES: CpuHalves | None = None


def cpu_half(job: str):
    """The CPU half of a comparison phase, from the worker."""
    check(_HALVES is not None, f"no CPU worker for {job}")
    return _HALVES.get(job)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    start = time.perf_counter()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}"
          f"; {torch.get_num_threads()} CPU threads",
          flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {sorted(built)} built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    global _HALVES
    _HALVES = CpuHalves(ROOT / "build" / "chip_smoke_cpu")
    atexit.register(_HALVES.close)
    # registers and spills of every instantiation: the tensor-core kernels
    # at every head dim, the decode kernel per dtype too, cola_fit's by rank
    # block, columns a thread and rows a tile, multi-LoRA's by x dtype, bank
    # (0 f32, 1 int8) and rank; at the path's shapes (bf16 d_head 64, and
    # zamba2's 112 in the forward and bf16 decode, which run on every
    # prefill and tick; the fit's rank 8, 3 columns a thread; multi-LoRA's
    # rank 8) they must not spill
    # (and d_head 256's own tilings: flash_fwd_tc_kernel<256>,
    # flash_fwd_f32_kernel<256>, decode_split_kernel<*,256> and its ring
    # mode <*,*,ring>, printed beside the others; the backward's at 112 are
    # printed)
    for name, kernel, n, paths in (
            ("flash_attention", "flash_fwd_tc_kernel", 6, ("64", "112")),
            ("flash_attention", "flash_fwd_f32_kernel", 6, ()),
            ("flash_attention_bwd", "flash_bwd_dq_tc_kernel", 6, ("64", "256")),
            ("flash_attention_bwd", "flash_bwd_dkv_tc_kernel", 6,
             ("64", "256")),
            ("flash_attention_bwd", "flash_bwd_dq_f32_kernel", 6, ("256",)),
            ("flash_attention_bwd", "flash_bwd_dkv_f32_kernel", 6, ("256",)),
            ("decode_attention", "decode_split_kernel", 24,
             ("bf16,64", "bf16,112")),
            ("cola_fit", "fit_reg_kernel", 4, ("8,3,8",)),
            ("cola_fit", "fit_smem_kernel", 1, ("8",)),
            ("multi_lora", "multi_lora_vec_kernel", 12,
             ("bf16,0,8", "bf16,1,8", "f32,0,8", "f32,1,8")),
            ("multi_lora", "multi_lora_any_kernel", 4, ())):
        report = ptxas_report(name, kernel)
        check(len(report) == n, f"no ptxas report of {kernel}: {report}")
        for line in report:
            print(f"[build] {line}", flush=True)
        for path in paths:
            at = [x for x in report if x.startswith(f"{kernel}<{path}>:")]
            check(len(at) == 1 and "0 bytes spill stores" in at[0]
                  and "0 bytes spill loads" in at[0],
                  f"{kernel} spills at the path's <{path}>: {at}")

    cfg = registry.get_config("smollm-135m")
    t0 = time.perf_counter()
    rows = phase_kernels(cfg, dev)
    print(f"[kernels] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    setup = serving_setup(cfg, dev)
    launches, serve_tokens = phase_serving(cfg, dev, setup)
    print(f"[serve] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_engine_vs_plain(cfg, dev)
    print(f"[engine-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    train = phase_training(cfg, dev)
    print(f"[train] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_training_vs_plain(cfg, dev)
    print(f"[train-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    scale, scale_tokens = phase_serving_at_scale(cfg, dev, setup)
    print(f"[scale] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_scale_vs_plain(cfg, dev)
    print(f"[scale-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    store = phase_store(cfg, dev, setup)
    print(f"[store] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runtime = phase_runtime(cfg, dev)
    print(f"[runtime] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tele = phase_telemetry(cfg, dev, setup, serve_tokens, scale_tokens)
    del setup
    print(f"[telemetry] done in {time.perf_counter() - t0:.1f} s", flush=True)
    _free()
    t0 = time.perf_counter()
    gemma2 = phase_gemma2(dev)
    print(f"[gemma2] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_gemma2_vs_plain(dev)
    print(f"[gemma2-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    gemma2_train = phase_gemma2_train(dev)
    print(f"[gemma2-train] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    configs = phase_configs(dev)
    print(f"[configs] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    moe = phase_moe(dev)
    print(f"[moe] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_moe_vs_plain(dev)
    print(f"[moe-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    ssm = phase_ssm(dev)
    print(f"[ssm] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_ssm_vs_plain(dev)
    print(f"[ssm-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    hybrid = phase_hybrid(dev)
    print(f"[hybrid] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_hybrid_vs_plain(dev)
    print(f"[hybrid-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    musicgen = phase_modality(dev, "musicgen-medium", "[musicgen]")
    print(f"[musicgen] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    pixtral = phase_modality(dev, "pixtral-12b", "[pixtral]")
    print(f"[pixtral] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_modality_vs_plain(dev)
    print(f"[modality-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # phase 25 runs before 24, beside the worker's last job (phase 26's
    # count), which must be done before phase 24 times the steps it counts
    t0 = time.perf_counter()
    phase_distributed_vs_plain(dev)
    print(f"[distributed-vs-plain] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    counts = cpu_half("roofline")
    t0 = time.perf_counter()
    distributed, dist_ms = phase_distributed(dev)
    print(f"[distributed] done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    phase_roofline(counts, dist_ms)
    print(f"[roofline] done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    shares = _rank_shares("--tensor-parallel", "--ssm-parallel",
                          "--expert-parallel")
    secs = {w: r["seconds"] for w, r in shares.items()}
    tensor_parallel = phase_tensor_parallel(shares["--tensor-parallel"])
    ssm_parallel = phase_ssm_parallel(shares["--ssm-parallel"])
    expert_parallel = phase_expert_parallel(shares["--expert-parallel"])
    print(f"[tensor-parallel] [ssm-parallel] [expert-parallel] done in "
          f"{time.perf_counter() - t0:.1f} s, one process: its phase 27 "
          f"{secs['--tensor-parallel']:.1f} s, phase 28 "
          f"{secs['--ssm-parallel']:.1f} s, phase 29 "
          f"{secs['--expert-parallel']:.1f} s", flush=True)
    print(f"[phases] done in {time.perf_counter() - start:.1f} s, the build "
          f"included", flush=True)
    _HALVES.close()

    replaces = {
        "flash_attention": "src/repro/kernels/flash_attention.py:61",
        "flash_attention_bwd_dq": "src/repro/kernels/flash_attention.py:152",
        "flash_attention_bwd_dkv": "src/repro/kernels/flash_attention.py:200",
        "cola_fit": "src/repro/kernels/cola_fit.py:40",
        "decode_attention": "src/repro/kernels/decode_attention.py:62",
        "decode_attention_paged": "src/repro/kernels/decode_attention.py:157",
        "multi_lora": "src/repro/kernels/multi_lora.py:64",
        "multi_lora_q8": "src/repro/kernels/multi_lora.py:176",
    }
    sources = {"flash_attention_bwd_dq": "flash_attention_bwd",
               "flash_attention_bwd_dkv": "flash_attention_bwd",
               "decode_attention_paged": "decode_attention",
               "multi_lora_q8": "multi_lora"}
    # launches: the serving, training, serving-at-scale, store, runtime,
    # telemetry, gemma2, gemma2-train, configs, moe, ssm, hybrid, musicgen,
    # pixtral, distributed, tensor-parallel, ssm-parallel and
    # expert-parallel runs' together
    # (flash_attention runs on every attention path, none on the ssm path,
    # which runs the multi-LoRA kernels and cola_fit; the ring ticks count
    # as the paged decode kernel's, of which they are the ring addressing
    # mode); the top-level numbers are the kernel's first row, "rows" holds every phase-1 row of the kernel (both cola_fit taps,
    # multi_lora at a tick, the d_head 256 and 112 rows and the other
    # configs' shapes)
    for extra in (gemma2, configs, moe, ssm, hybrid, musicgen, pixtral,
                  distributed):
        extra["decode_attention_paged"] += extra.pop("decode_attention_ring", 0)
    kernels = [dict(name=n, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{sources.get(n, n)}.cu",
                    replaces=replaces[n],
                    launches=(launches[n] + train[n] + scale[n] + store[n]
                              + runtime[n] + tele[n] + gemma2[n]
                              + gemma2_train[n] + configs[n] + moe[n]
                              + ssm[n] + hybrid[n] + musicgen.get(n, 0)
                              + pixtral.get(n, 0) + distributed.get(n, 0)
                              + tensor_parallel.get(n, 0)
                              + ssm_parallel.get(n, 0)
                              + expert_parallel.get(n, 0)),
                    **rows[n],
                    rows={k: v for k, v in rows.items()
                          if k == n or k.startswith(n + "[")})
               for n in replaces]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-halves"]:
        sys.exit(cpu_halves_main(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] and sys.argv[1] in RANK_SHARES:
        sys.exit(tensor_parallel_main(list(zip(sys.argv[1::2],
                                               sys.argv[2::2]))))
    sys.exit(main())
