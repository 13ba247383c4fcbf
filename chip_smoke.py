#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each raising on failure:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. build: compile the hand-written kernels from the sources in the
   checkout (``nm_spmm``, ``wu_outer``, ``adamw``, ``flash_attn`` and
   ``flash_bwd``: CUDA C++, one ``nvcc`` each, started together; ``lif``:
   Triton). Prints
   each kernel instance's registers and spills from ``ptxas -v`` (with the
   dynamic shared memory of the nine bf16 ``wgmma`` instances, which must
   not spill).
3. kernel parity: each kernel against its plain torch version on the card,
   at its path's shapes and at a tiled / ragged shape, with its
   device time (summed kernel durations in a ``torch.profiler`` trace, L2
   flushed before each call; ``wall_ms`` is back-to-back calls by CUDA
   events, L2 warm, host launch gaps included), the plain version's, the
   least time the card could take
   (bytes over 3.35 TB/s or flops over the dtype's peak, whichever is
   larger) and, where one PyTorch call computes the same function, that
   call's time (timed only; the port never calls it). ``nm_spmm`` also runs
   fused with the per-slot delta at the serving shape (1024 slots, 512 ->
   512, T 104, f32; and 1000 slots; and 256, phase 19e's interactive tier,
   as ``lif`` and ``wu_outer_slots`` too), against ``ref.nm_spmm_fused``, with
   rows computed alone equal bit for bit to the same rows of the batch.
   The fused AdamW (no TPU kernel) on phase 21's Moonlight tree, two steps
   bit for bit the plain update given its clip; its norm timed beside
   ``torch._foreach_norm``, its update beside ``torch._fused_adamw_``. ``wu_outer`` also writes exact zeros for a
   closed gate (``scale = 0``),
   and runs with the add into the compact weights fused in (the training
   path's launch; a closed gate returns ``wc`` bit for bit), timed fused and
   unfused beside ``torch.matmul(pre.T, mod)``. ``wu_outer_slots`` updates
   one layer of slot-leading deltas in place at the serving shape (1024
   slots, T 104, f32), all slots open and 40 % open: bit for bit against
   ``delta + ref.wu_outer_slots``, closed slots and the other layer not
   written; its bytes and bound count the open slots only.
   ``flash_fwd`` at the LM prefill shape (bf16), the LM training shape (B 2,
   S 4096, H 12, KV 2, dh 128), a small f32 shape, a 512 window (whole KV
   tiles skipped, rows whose first visited tile is all masked), a ragged
   S = 1000, MQA, Moonlight's prefill (B 4, S 2048, 16 query and 16 KV
   heads of 128: group 1), windows of 500 and 65 (off the key-tile edges), head
   widths 160 (StableLM) and 64, f32 at dh 160 with a window of 37, and
   Zamba2's shared block at its prefill (B 4, S 2048, 32 query and 32 KV
   heads of 64, its window of 4096 past S), and the training shapes of
   phases 21 and 22 (B 2, S 4096): Moonlight's (16 and 16 heads of 128)
   and Zamba2's shared block (32 and 32 heads of 64, window 4096 = S),
   against the plain ``ref.flash_fwd`` (bf16 out per element within
   ``ref.bf16_out_tolerance``) and, as the library yardstick,
   ``scaled_dot_product_attention``.
   Then ``python -m pytest --noconftest -q tests/test_torch_cuda.py``, the
   card-side tests (jax-free), in a process of its own; it must pass. It
   starts once phase 19 is done and runs beside phases 20, 24a, 24d and
   5-7 (whose times, none of them gated, then share the card and the
   host with it), and is read before phase 8.
4. serving at full width: the paper network (512-512-512-16, T=50, 80 %
   N:M sparsity, gating on, backend "kernels") serves 1024 gesture streams
   of 4 windows each through ``StreamScheduler`` (1024 slots, chunk 8,
   pipeline depth 1) until drained. Every stream must get 4 predictions,
   ``nm_spmm`` (every launch fused with the slots' deltas), ``lif`` and
   ``wu_outer_slots`` (the per-slot update, in place) must have launched
   grid steps x 8 x 2 times in that run and ``wu_outer`` never, and the
   deltas must be finite. Then, for the record, one full-grid chunk
   step under ``torch.profiler``: host wall, enqueue time, device busy time.
5. path parity: one 8-step chunk of 64 slots through backend "kernels"
   and backend "ref" (plain LIF), the windows at t 24-31 of 50 so that the
   per-slot weight update runs (t >= 30, after the t 25 snapshot): logits
   and deltas close, the update moved the deltas; spikes equal up to a
   first flip within rounding of the threshold, and >= 99.9 % equal over
   the neuron-steps where either side spiked.
6. training at full width: the paper network (backend "kernels") learns
   80 gesture samples of batch 16 through ``make_train_fn`` (OSSL, gated
   WU, DSST epochs after samples 39 and 79), then one ``make_eval_fn``
   call on 64 samples. Every kernel must have launched (80 + 1) x T x L
   times (``nm_spmm`` never fused: training has no deltas); after each
   epoch ``topology.check`` holds, L x G x J x k units
   were recycled (k from ``k_per_group``), and the weights are finite and
   exactly zero off the mask. Records samples/s, peak memory, the eval
   accuracy and one training sample under ``torch.profiler``.
7. training path parity: one 8-row training sample, the last of a DSST
   period, through backend "kernels" (compact rep) and "ref" (dense rep):
   logits and updated dense weights close, the masks after the epoch
   equal, spikes under the rule of phase 5.

8. LM serving at full width: Phi-3-medium-14B at its published config
   (40 layers, bf16, random weights from seed 0) generates 32 greedy tokens
   for 4 random prompts of 2048 tokens through ``launch.serve.generate``.
   ``flash_fwd`` must launch exactly 40 times (one prefill, none in
   decode), every token lie in the vocabulary and the last logits be
   finite. Records prefill ms and prompt tokens/s, decode ms per token
   (p50) and generated tokens/s, peak memory, and one prefill and one
   decode step under ``torch.profiler``.
9. LM path parity: the same model on 2 prompts of 512 tokens with
   ``attn="flash"`` and ``attn="plain"``: the prefill's last logits within
   a relative L2 error of 5 %, and the 8 greedy tokens equal up to a first
   divergence, allowed only where the plain run's top two logits lie
   within two bf16 ulps of its top logit.

   Phase 3 also holds the two flash backward kernels (``flash_bwd_dkv``,
   ``flash_bwd_dq``) against the plain f32 ``ref.flash_bwd`` (GQA groups
   summed in f32) on the forward kernel's ``out`` and ``lse``: at the LM
   training shape (B 2, S 4096, H 12, KV 2, dh 128, bf16), f32, a window of
   500, a ragged S = 1000, MQA, dh 160 with a window of 65, dh 64, and the
   Moonlight and Zamba2 training shapes of phase 3's forward list; bf16
   per element within ``ref.bf16_grad_tolerance``, f32 within ``1e-5`` of
   the tensor's largest element; timed beside the plain version, the bound
   and the backward of ``scaled_dot_product_attention`` (its backend named).
10. LM training at full width: Qwen2-VL-2B at its published config (28
   layers, d_model 1536, 12 query and 2 KV heads of 128, d_ff 8960, vocab
   151936, bf16, remat) from ``init_train_state`` on a CUDA generator
   seeded 0, 8 steps of ``make_train_step`` (AdamW lr 1e-3, 2 warm-up steps
   of 100, IA/SS gating on) on the port's ``TokenPipeline`` (batch 2 x 4096
   tokens). Every step: loss, grad norm and params finite, and exactly
   2 x 28 ``flash_fwd`` launches (forward and remat recompute), 28
   ``flash_bwd_dkv`` and 28 ``flash_bwd_dq``; the last loss below the
   first. Records ms per step (median of steps 2-8), tokens/s, MFU against
   989.4 TFLOP/s, peak memory, losses, gate fractions and one profiled step.
11. LM training parity: the same model cut to 2 layers, B 2 x S 1024, one
   step through ``attn="flash"`` and ``attn="plain"`` from the same params
   and batch: loss within 1 % and every gradient leaf within a relative L2
   error of ``TRAIN_GRAD_REL_L2``, updated params finite; one ``mode="local"``
   step (block 0's CE gradient exactly zero, the readout's not); one masked
   N:M step (n 2 of m 8, block 32, MLP) with ``dsst_every=1``: every mask
   group keeps exactly 2 units after the event, and some moved.
12. live topology under serving at full width: phase 4's fleet (the paper
   network, 1024 slots, chunk 8, depth 1, 1024 gesture streams x 4
   windows) with a ``TopologyService`` (``epoch_every`` 25 grid steps, the
   hottest lane folded into the base each epoch) until drained. Every
   stream must get 4 predictions, at least three epochs land under traffic,
   one chunk fn is built (``n_compiles`` 1), ``nm_spmm`` (all fused),
   ``lif`` and ``wu_outer_slots`` launch grid steps x 8 x 2 times and
   ``wu_outer`` never; after each epoch (checked on the card right after
   its swap) the N:M invariant holds, pruned = regrown = L x G x J x k with
   k from ``DSSTConfig.k_for_event``, every lane but the merged one keeps
   its surviving blocks' deltas bit for bit (old and new kept ids
   compared) and regrown blocks are exactly 0; the deltas are finite.
   Records events/s, step p50/p99, each epoch's host wall, peak memory and
   the telemetry's topology rollup, then profiles one chunk step with the
   DSST factors on (``factor_cost``: what they add to phase 4's step).
13. serving parity across a swap: 64 slots, windows at t 24-31 then 32-39
   (the update runs), one chunk, a forced epoch, one chunk, through backend
   "kernels" and "ref": the masks after the epoch equal, logits within
   1e-4, deltas within 1e-6 + 1e-4 relative, spikes under the rule of
   phase 5. Then a dense-layout fleet (``compact=False``) and a compact one
   serve the same 64 streams x 2 windows with epochs every 4 grid steps:
   the same epochs and masks, logits and the deltas at kept coordinates
   within 1e-5 (the layout tolerance of tests/test_compact_serving.py),
   the dense deltas zero off the mask, ``nm_spmm`` unfused on the dense
   fleet (``nm_spmm_fused`` and ``wu_outer_slots`` 0 there).
14. checkpoints: phase 12's evolved fleet (1024 slots) through
   ``save_fleet`` / ``restore_fleet``: params, mask, deltas and state bit
   for bit, and one chunk from the restored fleet equal bit for bit to one
   from the live fleet; the checkpoint restored into a dense fleet
   (``compact=False``) and that saved and restored compact again, bitwise
   at kept coordinates and zero elsewhere. Then LM training (phase 11's
   Qwen2-VL-2B widths at 2 layers, 2 x 1024 tokens, deterministic
   algorithms on): 6 steps straight through against 4 steps with a
   single checkpoint after step 3 and a resume to 6 from a replayed
   pipeline, the last loss and every param and AdamW moment bit for bit.
   Records the bytes written and the save and restore walls.
15. MoE serving at full size, once phases 8-14 have freed their models (at
   most MOE_HELD_BYTES still allocated): Moonlight-16B-A3B at its published
   config (48 layers, d_model 2048, 16 query and 16 KV heads of 128, 64
   experts of d_ff 1408, top 6, vocab 163840, bf16, random weights from a
   CUDA generator seeded 0) generates 32 greedy tokens for 4 random prompts
   of 2048 tokens through ``launch.serve.generate``, under phase 8's gates
   and records (``flash_fwd`` exactly 48 launches, all in the prefill, no
   other kernel; tokens in the vocabulary; finite logits). Then one more
   prefill under a spy on the MoE layer: every layer's ``moe_dropped``
   times N·K equals the host's count of its trash slots, and for 64 sampled tokens
   of layer 0 the layer's output equals a per-token loop through their
   top-k experts (renormalised gates, a dropped choice adds 0; per element
   within ``ref.bf16_out_tolerance``), each kept choice in the expert the
   loop picks.
16. (a) MoE path parity: Moonlight's first 2 layers at full width, 2
   prompts of 512 tokens, ``attn="flash"`` against ``attn="plain"``. The
   router's logits are bf16, so the two routes may order two experts
   otherwise at a near-tie: until a prompt row's first routing flip the
   routes differ by rounding only, so every flip in that call must be a
   near-tie of the plain run (the k-th expert within ROUTER_GAP_ULPS bf16
   ulps of the best one the flash run took instead); later flips are
   counted. The last logits within PARITY_REL_L2 on the rows whose last
   prompt token kept its experts in both layers (at least one), and the 8
   greedy tokens equal up to a first divergence, allowed at phase 9's
   near-tie or at or after the row's first routing flip.
   (b) the continuous batcher on the model's first BATCH_MOE_LAYERS of its
   48 layers (cut from all 48 for the run's time): 8 slots, 12 requests
   with seeded prompts of 16-48 tokens and 8 new tokens each: every request
   finishes with 8 tokens in the vocabulary, the 12 go through 8 slots
   (reused), the grid drains, no kernel launches (decode only). Records
   steps, tokens/s, step ms p50 and utilization. Then the two requests
   admitted at step 0 (slots 0 and 1) against their lone 1-slot runs under
   (a)'s routing and divergence rules.
17. ssm and hybrid serving at full size, once Moonlight is freed, one model
   on the card at a time: Mamba2-2.7B (64 layers, d_model 2560, d_inner
   5120, 80 SSD heads of 64, state 128) and Zamba2-1.2B (38 layers, d_model
   2048, its shared attention + MLP block after every 6th layer, 32 heads of
   64, window 4096), bf16, random weights from a CUDA generator seeded 0,
   each generate 32 greedy tokens for 4 random prompts of 2048 tokens
   through ``launch.serve.generate``, under phase 8's gates and records:
   ``flash_fwd`` exactly 0 launches for Mamba2 and 6 for Zamba2 (its shared
   block's calls), all in the prefill, no other kernel. For Mamba2 also one
   layer's chunked SSD (f32) at the prefill shape, timed, with its share of
   the prefill's busy time.
18. (a) chunked prefill against replay: each model at full width, cut to 2
   (Mamba2) and 12 (Zamba2, two shared-block calls) layers, 2 prompts of
   512 tokens: ``prefill`` against the reference's algorithm, the prompt
   replayed token by token through ``decode_step``. ``pos`` equal, the last
   logits within PARITY_REL_L2, every cache tensor of layer i (conv window,
   SSM state, the shared block's K/V rings) within (i + 1) x
   CACHE_REL_L2_PER_LAYER relative L2, the prefill's ``flash_fwd``
   launches one per shared-block call; then 8 greedy tokens from each cache
   equal up to a first divergence, allowed only at phase 9's near-tie (of
   the replay's logits).
   (b) Zamba2's 12 layers, ``attn="flash"`` against ``attn="plain"``, under
   phase 9's rules.
   (c) the continuous batcher on the full Mamba2 under phase 16b's traffic
   and gates (no kernel launches), the two step-0 requests equal to their
   lone 1-slot runs up to a near-tie divergence.
19. the serving runtime on phase 4's fleet, run right after phase 4. Each
   run is phase 4's paper network, streams and gates (every stream 4
   predictions, launches grid steps x C x L summed over the tiers, finite
   deltas) and is held bit for bit (window logits and final deltas of
   every stream) against phase 4's run. (a) ingestion A/B: the streams as
   ``AERStreamSource``s at depth 1, polled inline, then through the ingest
   worker; the worker queued chunks and every stream detached; records
   events/s, phase walls, ``serving_ingest_chunks_total``, the queue peak
   and the steal polls; and, for the record, the ingesting run again with
   the worker's idle wait at 50 ms instead of 0.5. (b) depth 2 with
   ingestion, and for the record without it. (c) the default
   ``AutopilotConfig`` from depth 1 with ingestion: it moved or recorded
   its decisions; records the depth timeline, the depths visited and the
   final overlap EMA. (d) an ``obs.Tracer`` on phase 4's fleet, an
   untraced run and a traced one (TRACE_PAIRS pairs, interleaved; cut
   from two for the run's time): no span dropped, exactly one
   ``sched.step/stage/poll_sources/dispatch/retire/device_wait`` span per
   grid step, the Prometheus scrape parses back; records the tracer's cost
   (traced over untraced wall, beside the reference's 25 % allowance, not
   gated) and writes the Chrome trace to ``chiprun_out/runtime_trace.json``.
   (e) two tiers, ``interactive`` (chunk 2, 256 slots, every 4th stream) and
   ``bulk`` (chunk 8, 768 slots), with ingestion: one chunk fn per tier, and
   every stream equal to its run on a single-grid fleet of its tier's
   geometry (two more runs); records per-tier step walls and events/s.
20. the static checks on the card, run right after phase 19 on phase 4's
   params and task (``repro_torch.analysis``). (a) every registry entry at
   its small geometry on ``cuda`` passes its contract set, the launch
   counters read around each checked call: the compact SNN entries launch
   ``nm_spmm`` (fused), ``lif`` and ``wu_outer_slots`` C x L times a call,
   the dense ones ``nm_spmm`` (unfused) and ``lif``, the decode step none.
   (b) phase 4's chunk fn (the paper network, 1024 slots, C 8), factors off
   and on: ``mask_free``, ``no_dense_deltas``, ``slot_separable(1024)``,
   ``dtype_discipline``, ``no_collectives`` and ``compile_count`` (and
   ``no_factor_carries`` with the factors off) hold, 16 launches each a
   call; records the recorded call's wall beside an unchecked call's and
   the checked calls' peak. (c) 20 grid steps of phase 4's fleet at depth 1
   polled inline, at depth 2 with ingestion and the autopilot, and on 19e's
   two tiers, with ``_poll_sources``, ``_stage``, ``_admit``, ``_dispatch``
   and ``_apply_autopilot`` under ``torch.cuda.set_sync_debug_mode
   ("error")`` (retire, whose fetch is the one sanctioned wait, unguarded):
   no phase may sync; launches 20 x C x L summed over the tiers. Prints
   ``analysis {...}``.

21. MoE training, once phase 16 has freed Moonlight's serving weights (at
   most MOE_HELD_BYTES still allocated): Moonlight-16B-A3B at full width,
   MOE_TRAIN_LAYERS of its 48 layers (the whole model's training state
   does not fit one card), under phase 10's traffic, gates and records
   (``flash_fwd`` 2L, ``flash_bwd_dkv`` and ``flash_bwd_dq`` L a step, the
   SNN kernels never), the loss in MOE_LOSS_CHUNK-position slabs;
   ``moe_dropped`` a step, MFU on the active params (attention, router, 6
   of 64 experts, head). (a) at MOE_PARITY_LAYERS layers, 2 x 1024: the
   same ``loss_and_grads`` twice, deterministic algorithms off, gradients
   equal bit for bit; flash vs plain under phase 11's rule, deterministic
   algorithms on; MOE_LOOP_TOKENS tokens through layer 0's MoE at a
   capacity that drops nothing, the gradients of its output with respect
   to its input, router, w1, w2 and w3 against a per-token loop in f32
   (MOE_LOOP_GRAD_REL_L2 per token row, expert and router column); one
   masked-expert step (n 2 of m 4, block 32) with ``dsst_every=1``: every
   mask keeps 2 of each 4, the weights are zero off it, some units moved.
22. ssm and hybrid training at full size, once phase 18 has freed its
   models, one at a time: Mamba2-2.7B and Zamba2-1.2B under phase 10's
   traffic, gates and records (``flash_fwd`` 0 and 12, ``flash_bwd_dkv``
   and ``flash_bwd_dq`` 0 and 6 a step: the shared block's calls, twice
   forward under remat); for Mamba2 one SSD layer's forward and forward +
   backward at the training shape and their share of the profiled step's
   busy time, for Zamba2 the shared block's flash time a step. (a) Mamba2
   cut to SSM_PARITY_LAYERS layers in f32, 2 x 1024: the card's
   ``loss_and_grads`` against the host's from the same params, loss and
   every leaf within SSM_GRAD_REL_L2 relative L2 (the SSD's backward has
   no kernel and no plain twin). (b) Zamba2 cut to HYBRID_PARITY_LAYERS
   layers, flash vs plain under phase 11's rule, with the flash route's
   launches exact.
23. the runtime and the launcher, once phase 22 has freed its models. The
   dry-run CLI (``python -m repro_torch.launch.dryrun --arch all --shape
   all``) and ``launcher --arch qwen2_vl_2b --validate`` start before phase
   2, in processes of their own (they compute on ``meta``, on the CPU, while
   the phases before 23 use the card), and are read here. (a)
   recovery: Qwen2-VL-2B at full width cut to RECOVERY_LAYERS of its 28
   layers, phase 10's traffic (B 2 x S 4096, flash route, batches from
   ``synthetic_lm_batch`` by step), deterministic algorithms on:
   ``run_with_recovery`` over RECOVERY_STEPS steps, a checkpoint every
   RECOVERY_EVERY, nodes lost at RECOVERY_FAIL_AT; it must log 2 restarts
   restored from [-1, 3] and end equal bit for bit to a straight loop of
   the same step from a clone of the initial state. Records each save and
   restore (wall, bytes, the allocation before it and the peak across it:
   one state beside the straight run's, never two), the time lost to the
   failures and the flash launches of both runs (2L / L / L a step,
   replays counted), exact. (b) compression: int8 and top-k (5 %)
   ``ErrorFeedback.step`` over one step's gradient tree (~560 M elements),
   ms a tree and ``compressed_bytes`` over the f32 bytes; the embedding's
   gradient and a stacked MLP leaf compressed on the card and on the host,
   payloads equal bit for bit. (c) the dry run: exit 0, every applicable
   cell ok and none failed, each with nonzero collectives and a peak a
   device on both fake production meshes (16 x 16, 2 x 16 x 16: the
   cell's step tensor-parallel on ``meta``, counted by
   ``spmd.count_collectives``; the CLI's worker processes); one arch a family's
   train, prefill and decode cell on 16 x 16 logged (calls and wire bytes
   by op, the peak a device); its Qwen2-VL-2B (params, moments, gating state)
   bytes equal the bytes phase 10's ``init_train_state`` requested from the
   allocator, exactly, and what it allocated within the allocator's
   rounding (``allocation_growth``); its peak estimate at phase 10's cell
   beside the peak measured there (not gated). (d) the launcher's CLI on the
   card, started with phase 23 and run while (a) and (b) use the card:
   ``--arch stablelm_12b --steps 4 --seq-len 32 --global-batch 4 --opt
   zero1`` prints a loss, ``--validate`` prints ``validate OK``.
24. the slot-sharded serving fleet on a ``("slots",)`` mesh of four
   entries of the one card (``make_serving_mesh(devices=[cuda:0] * 4)``:
   the shards run one after another on the card's stream, through the code
   that runs them on distinct cards). (a) right after phase 20: phase 4's
   fleet (1024 gesture streams x 4 windows, the paper network, 1024 slots
   as 4 shards of 256, C 8, depth 1), its digest equal to phase 4's bit for
   bit, one chunk fn, ``nm_spmm`` (all fused), ``lif`` and
   ``wu_outer_slots`` launched grid steps x C x L x 4 times and
   ``wu_outer`` never; recorded, not gated: events/s, step p50 / p99, peak
   memory, and the sharded step's breakdown (busy ms, launches a step).
   (b) right after phase 13: phase 12's live topology service on the mesh
   against phase 12's 1-device run: epochs (index, grid step, pruned,
   regrown, mask change, merged lanes), params and masks, deltas and every
   stream's predictions bit for bit, one chunk fn. (c) the sync guard over
   the sharded fleet's stage, admit and dispatch (phase 20c's check, 0
   syncs), phase 20's registry with its 9 entries, the sharded fleet's
   checkpoint equal to the 1-device fleet's file for file (arrays bit for
   bit) and restored onto the mesh, and ``elastic_remesh`` from 4 shards to
   2 and back bit for bit. (d) right after (a): shards of 1 and of 2 slots
   at the paper's width, where torch's row reductions may take another
   launch shape: the chunk step (3 chunks, decay and clip, factors on) on
   4 shards against the 1-device step, and the fleet at 2 slots a shard
   (the scheduler's floor) against the 1-device fleet, in the compact and
   the dense delta layouts, every output bit for bit. (The ``"ref"``
   backend's dense base GEMM is refused on a slot mesh of the card.)
25. data-parallel LM training across processes (slice 16), once phase 23
   has freed its state: Qwen2-VL-2B at full width cut to DP_LAYERS of its
   28 layers, phase 10's batch (B 2 x S 4096), the gate on, the flash
   route, under ``spmd.activate(mesh, flash_attn=True, seq_shard=True)``,
   each configuration in processes of its own (``dp_child``). (a) one rank
   joins a one-rank NCCL group through ``launcher.fleet_init``'s
   variables, builds ``make_host_mesh()`` (a ``DeviceMesh`` of 1 x 1) and
   runs DP_STEPS_A data-parallel steps with ZeRO-1 asked for, against
   ``make_train_step``'s steps from the same state: params, moments and
   losses bit for bit, and no collective issued (counted: a DP axis of 1
   has no group, ``spmd.dp_groups``); ``dp_overhead_ms`` is
   the DP step's median time (CUDA events) less the plain step's. (b) two
   ranks share ``cuda:0`` over gloo (NCCL refuses two ranks on one
   device), each on its half of the global batch
   (``synthetic_lm_batch(..., rank, 2)``), DP_STEPS_B steps with ZeRO-1 off
   and on: the ranks' params bit-identical, ZeRO-1 bit for bit the
   replicated update with half the moments a rank, and against the
   1-process step on the two halves concatenated the step-0 gradients
   within TRAIN_GRAD_REL_L2 a leaf (phase 11's bound), the losses within
   DP_LOSS_REL and the params within DP_PARAM_REL_L2; each rank's peak
   memory and step times recorded. (c) ``launcher --arch qwen2_vl_2b
   --validate --multi-pod``, a CPU tool process on a fake 512-rank group,
   prints the per-device argument bytes under the 2 x 16 x 16 placements;
   they must equal this script's own sum of each leaf's local block from
   ``placements`` over the full config on ``meta``. The flash kernels'
   launches of (a) and (b)'s DP runs are the ``lm_dp_training`` path,
   exact (2L / L / L a step and process).
26. the MoE family data-parallel (slice 17), once phase 25 has freed its
   state: two gloo ranks share ``cuda:0`` (``moe_dp_child``), one after
   another in the same two processes. (a) Moonlight-16B-A3B at full width
   cut to DP_MOE_LAYERS of its 48 layers, phase 10's batch (B 2 x S 4096,
   one row a rank), the gate on, the flash route, the loss in phase 21's
   slabs, under ``spmd.activate(mesh, flash_attn=True, shardmap_moe=True)``
   on ``make_host_mesh()`` (data 2), with deterministic algorithms on:
   DP_MOE_STEPS steps with ZeRO-1 off and then on; the ranks' params
   bit-identical (digests: ``tensor_digest``), ZeRO-1 bit for bit the
   replicated update, the all-reduced step-0 gradients bit for bit
   ``((g0.float() + g1.float()) / 2).to(dtype)`` of the 1-process
   ``grad_step`` on each half alone (run in this process first; each half
   has its own capacity), the DP loss and ``moe_dropped`` the halves'
   means; recorded: the 1-process step on the whole batch and its
   ``moe_dropped``, each rank's peak memory and step ms, the collectives.
   The flash launches of the DP steps are the ``lm_dp_moe_training`` path,
   exact (2L / L / L a step and process). (b) one Moonlight MoE layer at
   full width (64 experts, top 6, d_ff 1408) on ``make_host_mesh(model=2)``
   (data 1, model 2), each rank running 32 experts, x [2, 4096, 2048] bf16:
   the output and the gradients of x, the router and the rank's expert
   block within EP_REL_L2 relative L2 of the 1-process ``moe_apply`` on
   the card, the aux terms equal, nothing outside the block, three
   all-reduces a forward and backward; ms and the all-reduced bytes
   recorded. (c) phase 23b's gradient tree (Qwen2-VL-2B, 2 layers, 562 M
   elements), each rank's scaled by ``1 + 0.01 n`` from its own seed,
   through ``compressed_mean``, int8 and top-k 5 %: the ranks' results
   bit-identical (digests), and on DP_COMPRESS_GATE's leaves bit for bit
   the host's mean of the same inputs; ms a tree and the gathered bytes
   against f32. (d) (a)'s ZeRO-1 moments placed on the mesh as
   ``DTensor`` s (``DataParallel.placed_opt_state``) and remeshed by
   ``elastic_remesh`` onto one device, a leaf at a time: bit for bit the
   replicated run's moments. (e) the global-batch dispatch: (a)'s step
   under ``spmd.activate(mesh, flash_attn=True)`` (no ``shardmap_moe``: one
   capacity from the global token count, slots in global batch order,
   each rank's experts on its own rows), its all-reduced step-0 gradients
   within TRAIN_GRAD_REL_L2 a leaf, its loss within DP_LOSS_REL and its
   ``moe_dropped`` within DP_LOSS_REL of the 1-process step on the whole
   batch (run in this process first, ``whole_grads.pt``).
27. tensor parallelism (slice 18), once phase 26 has freed its state: two
   gloo ranks share ``cuda:0`` on ``make_host_mesh(model=2)`` (data 1,
   model 2), ``tp_child``, with the parameters placed as ``DTensor`` s by
   the rules. (a) phase 25's Qwen2-VL-2B (DP_LAYERS layers, B 2 x S 4096,
   the gate on) under ``spmd.activate(mesh, flash_attn=True,
   seq_shard=True)``, each rank on the whole batch, DP_STEPS_B steps
   against 25b's 1-process reference (kept from phase 25): the step-0
   gradients within TRAIN_GRAD_REL_L2 a leaf, the losses within
   DP_LOSS_REL, the params within DP_PARAM_REL_L2, the replicated leaves
   bit-identical across ranks, every gradient in its parameter's
   placements, the moments of their parameters' local shapes; each rank's
   state bytes, peak memory, step ms and collectives a step recorded; the
   flash launches are the ``lm_tp_training`` path, exact (2L / L / L a
   step and rank, on 6 of 12 query heads). (b) Phi-3-medium-14B at full
   width cut to TP_LAYERS layers, LM_BATCH x LM_PROMPT prompts, prefill
   and TP_NEW greedy decode steps over caches split over their slots
   (``init_cache(mesh=)``), against the 1-process greedy trace in this
   process: the last prefill logits within TP_LOGIT_REL_L2 relative L2, the
   tokens equal on both ranks and to the 1-process tokens up to a
   1-process top-2 gap of TP_GAP_ULPS bf16 ulps; prefill ms, decode ms at
   p50 and the collectives' bytes a token recorded; the flash launches are
   the ``lm_tp_serving`` path, exact (L a rank).
28. tensor parallelism for the moe, ssm and hybrid families (slice 19),
   once phase 27 has freed its state: two gloo ranks share ``cuda:0`` on
   ``make_host_mesh(model=2)`` (``tp_family_child``), the parameters placed
   as ``DTensor`` s by the rules, deterministic algorithms on, each part
   at full width with depth cut (TP_FAMILY_PARTS) against its 1-process run
   in this process (``tp_family_reference``): (a) Moonlight, 1 layer (EP:
   32 of 64 experts and 8 of 16 heads a rank), phase 10's batch, the gate
   on, the flash route, the loss in slabs, 1 step, with ``shardmap_moe`` and
   without it, bit for bit each other; (b) Mamba2, 2 layers, 3 steps,
   sequence-parallel; (c) Zamba2, 6 layers (its shared block once, 16 of 32
   heads), 1 step, sequence-parallel. Training gates as 27a's (gradients,
   losses, params, replicas, placements; a leaf drawn at zero within
   TP_ZERO_INIT_REL_L2) and ``moe_dropped`` equal on the ranks and within
   TP_DROPPED_ABS of the 1-process value; serving: the prefill of LM_BATCH x LM_PROMPT prompts and
   TP_FAMILY_NEW greedy decode steps over caches placed by
   ``cache_shardings``, gated as 27b. Recorded: step ms, peak, collectives
   a step and a token, the SSD's ms on a rank's ``P`` block beside the
   whole. (d) (b)'s TP state after step TP_CKPT_STEP saved (rank 0 writes
   the unsharded layout), restored into the 1-process template (rank 0)
   and onto the ranks, bit for bit each way, and the next step from the
   restored state bit for bit the straight run's. The flash launches are
   the ``lm_tp_moe`` and ``lm_tp_hybrid`` paths (``lm_tp_ssm`` runs none),
   exact. Also recorded, as the causes of the two gates that are not phase
   27's: the leaf drawn at zero's step-0 sign flips against the runs'
   gradient difference (``zero_init_flips``), and the router's moved
   choices against their top-k gap (``router_flips``).

29. (a) the head cut, once phase 28 has freed its state:
   CUT_WORLD gloo ranks share ``cuda:0`` on ``make_host_mesh(model=8)``
   (``cut_child``): Qwen2-VL-2B at full width cut to CUT_LAYERS layers,
   its 12 query heads over a model axis of 8 (1.5 heads of ``wq``'s
   columns a rank, K/V cut inside a head), the gate on, the flash route,
   ``seq_shard``: one step of CUT_B x CUT_S against the 1-process step in
   this process (``cut_reference``), under 27a's bounds (gradients,
   loss, params, replicas, placements) with ``wq`` placed on its columns;
   then the prefill of CUT_B x CUT_S and CUT_NEW greedy tokens against the
   1-process greedy trace, under 27b's. The flash launches are the
   ``lm_cut_training`` and ``lm_cut_serving`` paths (2L / L / L a step and
   L a prefill, a rank), exact. (b) the seven demos of ``examples/torch``
   (DEMOS), each a process of its own, run one after another from the
   start of phase 23 (``start_demos``): each exits 0, prints its reference
   demo's contract line (``compiled variants 1``, ``OK``, the bitwise
   resume, falling losses) and a ``kernels`` line in which every kernel of
   its path launched (``nm_spmm``, ``lif``, ``wu_outer`` for SNN
   training; the fused ``nm_spmm``, ``lif``, ``wu_outer_slots`` for
   serving; ``flash_fwd``, and the backward pair where a demo trains).
   Phase 3 holds each of those kernels against its plain version at the
   shapes the demos launch it (``demo_*`` cases, held and not timed:
   DEMO_SLOT_GRIDS, ``demo_flash_shapes``). The demos share the card with
   phases 23 to 29a, so the times those phases record (none gated) are
   taken beside another CUDA process.

The processes of phases 25-29a are started one phase ahead
(``prestart``): each imports torch and the port and opens its CUDA
context while the phase before runs, then waits for its entry.

``python3 chip_smoke.py --gate-faults`` runs none of the phases above but
the build of the flash kernels and phase 28's Mamba2 and Moonlight
training, clean and with a fault planted in memory (GATE_FAULTS: a skipped
step, the mixer's ``conv_b`` gradient not summed over the ranks, the MoE
capacity one rounding step short), and writes each run's phase 28
readings to ``chiprun_out/gate_faults.json``: the evidence that places
TP_ZERO_INIT_REL_L2 and TP_DROPPED_ABS.

Prints the kernels line (JSON; ten rows: the six TPU kernels' ports,
``nm_spmm_fused``, ``wu_outer_slots`` and the fused AdamW's two,
``adamw_norm`` and ``adamw_update``; the ``wu_outer`` row is its fused
launch, the training path's), the card line, and last
``{"ok": true, "device": {...}}``; the full record goes to
``chiprun_out/chip_smoke.json``. Exits non-zero, printing no result, when
no CUDA device is present or the port's sources are missing.
"""
import contextlib
import copy
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # CUDA-core f32, dense bf16
N_STREAMS, N_WINDOWS, CHUNK_LEN = 1024, 4, 8
TRAIN_BATCH, TRAIN_SAMPLES, EVAL_BATCH = 16, 80, 64
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "phi3_medium_14b", 4, 2048, 32
PARITY_BATCH, PARITY_PROMPT, PARITY_NEW = 2, 512, 8
# phase 9: the routes round at other places (plain: bf16 scores and probs;
# flash: f32 scores, bf16 probs per tile) and the difference then passes
# through 40 bf16 layers, each rounding activations to 8 bits; each route
# lies a few percent from exact arithmetic there, so the two may differ by
# as much. A wrong mask or head mapping moves the logits by O(100 %).
PARITY_REL_L2 = 0.05
# a greedy token may differ only where the plain run's top two logits lie
# within two bf16 ulps of its top logit (the logits are bf16)
PARITY_GAP_ULPS = 2
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "qwen2_vl_2b", 2, 4096, 8
TRAIN_PARITY_LAYERS, TRAIN_PARITY_S = 2, 1024
PEAK_BF16 = 989.4e12                        # H100 SXM dense bf16, for MFU
# phase 11: the plain route rounds scores and probabilities to bf16 and
# differentiates through them in bf16, the flash route keeps scores in f32
# and rounds only p and ds for its products; both then pass through bf16
# activations in two layers. Rounding moves a gradient leaf by ~1 % (relative
# L2); a lost GQA head or query tile in dK/dV moves it by tens of percent.
TRAIN_GRAD_REL_L2 = 0.05
MOE_ARCH, MOE_LOOP_TOKENS, MOE_PARITY_LAYERS = "moonshot_v1_16b_a3b", 64, 2
MOE_HELD_BYTES = 2 << 30       # what may stay allocated before Moonlight's draw
BATCH_SLOTS, BATCH_REQUESTS, BATCH_NEW, BATCH_MAX_SEQ = 8, 12, 8, 256
BATCH_PROMPT_MIN, BATCH_PROMPT_MAX = 16, 48
BATCH_MOE_LAYERS = 24    # phase 16b's depth (of Moonlight's 48)
# phases 16a and 16b: the router's logits are bf16, so two runs that differ
# by rounding order two experts otherwise where their logits lie within a
# few bf16 ulps (exact bf16 ties among 64 experts are common; those keep the
# lower expert on both sides). The plain route's bf16 scores move the
# router's input by ~3 % against the flash route's (the last logits' rel
# L2), ~6 ulps of a logit near 1.5, the largest gap the first run read; a
# wrong head or slot mapping moves the router's input by O(100 %) and its
# flips' gaps by up to the logits' spread (hundreds of ulps).
ROUTER_GAP_ULPS = 16
SSM_ARCH, HYBRID_ARCH = "mamba2_2p7b", "zamba2_1p2b"
SSM_PARITY_LAYERS, HYBRID_PARITY_LAYERS = 2, 12   # Zamba2: 2 shared calls
# phase 18a: the chunked prefill and the replay round at other places (the
# conv's bf16 sum of products against an f32-accumulated one, bf16
# activations between layers after f32 SSD sums in other orders), and each
# layer adds its own rounding to what it inherits: at a reduced width in
# bf16 on the CPU the SSM state moved 0.5 % at layer 0 and ~0.35 % more a
# layer, to 4.1 % at layer 12. So the cache tensors written at layer i (the
# shared block's after layer i) are held to (i + 1) x CACHE_REL_L2_PER_LAYER
# relative L2, one bf16 ulp of 2^-8 four times over a layer. A state not
# carried across chunks, a conv window off by a token or a ring slot off by
# one moves a tensor by O(100 %) at the first layer it touches. The last
# logits within PARITY_REL_L2.
CACHE_REL_L2_PER_LAYER = 2 ** -6
# phase 21: Moonlight at full width, 4 of its 48 layers (the whole model's
# training state, ~336 GB, does not fit one card); the loss in slabs of
# 1024 positions, so the [8192, 163840] f32 logits (5.4 GB, and as much
# again for their gradient) never exist whole
MOE_TRAIN_LAYERS, MOE_LOSS_CHUNK = 4, 1024
# phase 21a: the MoE layer's gradients against a per-token loop in f32 on
# the same bf16 values. The layer rounds to bf16 (2^-9 relative at most)
# at its logits, gates, the two expert products, the silu product, the
# output, and each product of the backward: about eight roundings on the
# longest path (the router's), <= 2^-6 if all lined up; 2^-5 leaves twice
# that. Held per token row (input), per expert (w1, w2, w3) and per router
# column, so that one lost or misrouted choice (~1/6 of a row's or an
# expert's gradient, a token picks 6 experts) stands out.
MOE_LOOP_GRAD_REL_L2 = 2 ** -5
# phase 22a: Mamba2 (2 layers, f32) on the card against the host, TF32 off:
# the same f32 arithmetic summed in other orders (cuBLAS and the card's
# reductions against the host's), ~1e-6 relative a leaf; 1e-4 leaves 100x.
# A wrong SSD backward (a lost inter-chunk term, a transposed decay) moves
# the mixer's leaves by O(1).
SSM_GRAD_REL_L2 = 1e-4


def log(msg):
    print(msg, flush=True)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_kernels(torch, fn, iters=1, keep=None, expect=None):
    """The device-side events (kernels, copies) of ``iters`` calls of ``fn``
    in a ``torch.profiler`` trace, after one warm-up call, and the host wall
    time in ms of those same traced calls up to the end of their device
    work. ``keep`` filters the events by name; with ``expect`` a trace that
    holds another number of events is taken again, and after the last try
    the fullest trace is returned (and the shortfall logged)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # now and then a trace comes back without the call's device events (once
    # in a few dozen traces on the H100, and once three times running):
    # trace again after a pause, at most four more times
    best = ([], 0.0)
    for attempt in range(5):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and (keep is None or keep(e.name))]
        if events and (expect is None or len(events) == expect):
            return events, wall
        if len(events) > len(best[0]):
            best = (events, wall)
    if not best[0]:
        raise RuntimeError("the profiler recorded no device time for the call")
    log(f"trace: {len(best[0])} device events, want {expect}")
    return best


def ptxas_instances(text):
    """Each kernel instance in a ``ptxas -v`` log: its name (template head
    width as ``dh``), registers, and spill stores and loads in bytes."""
    import re
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            # the last <length><name> part of the mangled (nested) name
            i, name = (3 if mangled.startswith("_ZN") else 2), mangled
            while i < len(mangled) and mangled[i].isdigit():
                j = i
                while mangled[j].isdigit():
                    j += 1
                n = int(mangled[i:j])
                name, i = mangled[j:j + n], j + n
            dh = re.search(r"ILi(\d+)E", mangled)
            cur = {"kernel": name,
                   "dh": int(dh.group(1)) if dh else None,
                   "registers": None, "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
        elif cur is not None and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            for n, kind in nums:
                cur[f"spill_{kind}"] = int(n)
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def kernel_class(name):
    """``gemm`` (cuBLAS), ``flash`` (the port's attention kernels) or
    ``other`` (elementwise, reductions, copies and the rest)."""
    if name.startswith("nvjet") or "gemm" in name or "cutlass" in name:
        return "gemm"
    return "flash" if "flash_" in name else "other"


def trace_summary(torch, fn):
    """One call of ``fn`` under ``torch.profiler`` (after a warm-up call):
    its traced wall, the device busy time (summed kernel durations) and its
    split by ``kernel_class``, the device span, the idle share of the wall,
    and the ten largest kernels."""
    kernels, traced_ms = device_kernels(torch, fn)
    by_name, by_class = {}, {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        c = kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"traced_wall_ms": traced_ms, "device_busy_ms": busy_ms,
            "device_span_ms": span_ms,
            "device_idle_share": 1.0 - busy_ms / traced_ms,
            "device_ms_by_class": by_class,
            "device_launches": len(kernels),
            "top": [{"name": k[:90], "ms": us / 1e3, "count": n}
                    for k, (us, n) in top]}


_FLUSH = {}


def device_ms(torch, fn, iters=20):
    """Device time of one call of ``fn``: the summed durations of the
    kernels it launches, so the host's launch gaps between them do not
    count (they do in ``wall_ms``). The 50 MB L2 is flushed before every
    call, as the serving step's ~1 GB working set leaves it; the flush's
    own kernels (named once per run) are left out of the sum. A trace of the
    ``iters`` calls must hold ``iters`` times the events of one traced call,
    else it is taken again: a trace that lost events would pass for a
    faster kernel. Where the profiler records no device event at all,
    the time is ``wall_ms``'s (logged)."""
    if not _FLUSH:
        _FLUSH["scratch"] = torch.empty(64 << 20, dtype=torch.uint8,
                                        device="cuda")
        _FLUSH["names"] = {e.name for e in device_kernels(
            torch, _FLUSH["scratch"].zero_, iters=4)[0]}
    scratch, flush_names = _FLUSH["scratch"], _FLUSH["names"]

    def flushed():
        scratch.zero_()
        fn()
    keep = lambda name: name not in flush_names   # noqa: E731
    try:
        per_call = len(device_kernels(torch, flushed, 1, keep=keep)[0])
    except RuntimeError as e:
        # a trace with no device events five times running (seen once on
        # the H100, in phase 17): CUDA events, L2 warm, launch gaps counted
        log(f"device_ms: {e}; timed by CUDA events instead")
        return wall_ms(torch, fn, iters)
    kernels, _ = device_kernels(torch, flushed, iters, keep=keep,
                                expect=per_call * iters)
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / iters


def wall_ms(torch, fn, iters=20):
    """Time per call of ``iters`` back-to-back calls, by CUDA events: the
    device time plus whatever gaps the host's launches leave (L2 warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timings(torch, prefix, fn):
    return {f"{prefix}ms": device_ms(torch, fn),
            f"{prefix}wall_ms": wall_ms(torch, fn)}


def untimed(torch, prefix, fn):
    """In place of :func:`timings` for a case that is held but not timed
    (the demos' shapes: microseconds a launch, and phase 3 is on the run's
    critical path)."""
    return {}


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def nm_case(torch, name, dtype, b, k, o, spec, sparse_x, timed=True):
    from repro_torch.core.sparsity import random_unit_mask
    from repro_torch.kernels.nm_spmm import ops, ref
    from repro_torch.kernels.nm_spmm.kernel import nm_spmm_cuda
    gen = torch.Generator().manual_seed(0)
    mask = random_unit_mask(gen, spec, k, o)
    w = torch.randn((k, o), generator=gen)
    wc, idx = ops.make_compact(w, mask, spec.block, spec.out_tile)
    x = ((torch.rand((b, k), generator=gen) < 0.1).float() if sparse_x
         else torch.randn((b, k), generator=gen))
    x, wc, idx = (x.to("cuda", dtype), wc.to("cuda", dtype), idx.cuda())
    dense = ref.densify(wc, idx, k)
    y_k = nm_spmm_cuda(x, wc, idx)
    y_r = ref.nm_spmm(x, wc, idx)
    torch.cuda.synchronize()
    err = max_err(y_k, y_r)
    # f32: only the summation order differs; bf16: both round the f32 sum
    # to bf16 (8-bit mantissa), so allow a few of its ulps at |y|
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * (1 + float(y_r.float().abs().max()))
    if not err <= tol:
        raise AssertionError(f"nm_spmm {name}: max |kernel - plain| {err} > {tol}")
    j, t, bk, bo = wc.shape
    es = x.element_size()
    nbytes = (x.numel() + wc.numel() + y_k.numel()) * es + idx.numel() * 4
    flops = 2 * b * j * t * bk * bo
    dname = str(dtype).split(".")[-1]
    bound_ms, bound_by = bound(nbytes, flops, dname)
    tm = timings if timed else untimed
    rec = {"case": name, "dtype": dname, "shape": [b, k, j, t, bk, bo],
           "max_abs_err": err, "tol": tol,
           **tm(torch, "", lambda: nm_spmm_cuda(x, wc, idx)),
           **tm(torch, "plain_", lambda: ref.nm_spmm(x, wc, idx)),
           **tm(torch, "library_", lambda: torch.matmul(x, dense)),
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"parity nm_spmm {json.dumps(rec)}")
    return rec


def nm_fused_case(torch, name, b, k=512, timed=True):
    """The gather kernel with the per-slot delta fused in, at the serving
    shape (x ``[b, k]`` spikes, k -> k at the paper's 4-group sparsity: T
    104 at 512, f32), against ``ref.nm_spmm_fused`` (the base product plus
    ``nm_spmm_deltas``); rows computed alone must equal the same rows of
    the batch bit for bit."""
    from repro_torch.core.sparsity import paper_spec_4groups, random_unit_mask
    from repro_torch.kernels.nm_spmm import ops, ref
    from repro_torch.kernels.nm_spmm.kernel import nm_spmm_fused_cuda
    o = k
    gen = torch.Generator().manual_seed(6)
    spec = paper_spec_4groups(k, 0.8)
    wc, idx = ops.make_compact(torch.randn((k, o), generator=gen),
                               random_unit_mask(gen, spec, k, o), 1, 1)
    x = (torch.rand((b, k), generator=gen) < 0.05).float().cuda()
    delta = (0.02 * torch.randn((b, *wc.shape), generator=gen)).cuda()
    wc, idx = wc.cuda(), idx.cuda()
    y_k = nm_spmm_fused_cuda(x, wc, idx, delta)
    y_r = ref.nm_spmm_fused(x, wc, idx, delta)
    solo = {r: nm_spmm_fused_cuda(x[r:r + 1].contiguous(), wc, idx,
                                  delta[r:r + 1].contiguous())
            for r in (0, b // 2, b - 1)}
    torch.cuda.synchronize()
    err = max_err(y_k, y_r)
    tol = 1e-4                  # f32: only the summation order differs
    if not err <= tol:
        raise AssertionError(f"nm_spmm fused {name}: max |kernel - plain| {err} > {tol}")
    if not all(torch.equal(y, y_k[r:r + 1]) for r, y in solo.items()):
        raise AssertionError(f"nm_spmm fused {name}: a row alone differs from "
                             f"the same row in the batch")
    j, t = idx.shape
    nbytes = (x.numel() + wc.numel() + delta.numel() + y_k.numel()) * 4 \
        + idx.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4 * b * j * t, "float32")
    tm = timings if timed else untimed
    rec = {"case": name, "dtype": "float32", "shape": [b, k, j, t, 1, 1],
           "max_abs_err": err, "tol": tol, "solo_rows_bitwise": True,
           **tm(torch, "", lambda: nm_spmm_fused_cuda(x, wc, idx, delta)),
           **tm(torch, "plain_", lambda: ref.nm_spmm_fused(x, wc, idx, delta)),
           "library_ms": None, "plain_call": "ref.nm_spmm + nm_spmm_deltas",
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}
    log(f"parity nm_spmm_fused {json.dumps(rec)}")
    return rec


def card_tests(tool):
    """Waits for the run of ``tests/test_torch_cuda.py`` that
    :func:`start_side_runs` started; it must pass."""
    rc, text, seconds = finish_tool(tool, 600)
    tail = text.strip().splitlines()[-1:] or [""]
    rec = {"rc": rc, "summary": tail[0], "seconds": seconds}
    log(f"card_tests {json.dumps(rec)}")
    if rc != 0:
        raise AssertionError(f"tests/test_torch_cuda.py failed:\n"
                             f"{text[-8000:]}")
    return rec


def adamw_case(torch):
    """The fused AdamW (``kernels/adamw``) on phase 21's tree: Moonlight's
    4 layers at full width, 2.95 B trainable elements, bf16 parameters and
    gradients, f32 moments, a per-layer gate with one layer closed. Two
    steps of ``adamw_update`` on the card (the norm's launch and the
    update's, each step) against the plain update (``ref.update``) leaf by
    leaf with the kernel path's clip: ``p``, ``m`` and ``v`` bit for bit;
    the norm within 1e-6 of the f64 sum. Timed over the whole tree: the
    whole ``adamw_update`` against the plain path (``ref.sq_sums``, the
    clip, ``ref.update``); under ``norm`` and ``update`` each kernel alone
    against its plain part and its library yardstick,
    ``torch._foreach_norm`` (a norm a leaf, not summed) and
    ``torch._fused_adamw_`` (no clip, no gate); the port calls neither."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.adamw import kernel as ak, ref as aref
    from repro_torch.launch.train import TrainHParams, init_train_state
    from repro_torch.optim import adamw_update, gated_scale_tree
    from repro_torch.optim.optimizer import (AdamWConfig, cosine_schedule,
                                             tree_leaves, tree_map, trainable)
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    params, state, _ = init_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg,
        TrainHParams(opt=opt), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    grads = tree_map(lambda p: (1e-3 * torch.randn(
        p.shape, device="cuda", generator=gen)).to(p.dtype)
        if trainable(p) else None, params)
    gate = torch.tensor([1.0, 0.0, 1.0, 1.0], device="cuda")[:cfg.n_layers]
    scale = gated_scale_tree(params, gate, cfg.sparsity)
    start = tree_map(lambda p: p.clone() if trainable(p) else p, params)
    n = sum(p.numel() for p in tree_leaves(params) if trainable(p))
    names = ("adamw_norm", "adamw_update")
    before = launch_counts(), ak.adamw_update_cuda.elems
    clips, norms = [], []
    for _ in range(2):
        params, state, om = adamw_update(grads, params, state, opt, scale)
        norms.append(om["grad_norm"])
        clips.append(torch.clamp(opt.grad_clip / (om["grad_norm"] + 1e-9),
                                 max=1.0))
    counted = {k: launch_counts()[k] - before[0][k] for k in names}
    counted["elems"] = ak.adamw_update_cuda.elems - before[1]
    if counted != {**adamw_launches(2), "elems": 2 * n}:
        raise AssertionError(f"adamw: counted {counted}, want "
                             f"{adamw_launches(2)} over {2 * n} elements")
    leaves = [x for x in zip(tree_leaves(grads), tree_leaves(params),
                             tree_leaves(start), tree_leaves(state.m),
                             tree_leaves(state.v), tree_leaves(scale))
              if trainable(x[1])]
    f64 = sum(float(g.double().square().sum()) for g, *_ in leaves) ** 0.5
    norm_rel = abs(float(norms[0]) - f64) / f64
    if not (norm_rel <= 1e-6 and torch.equal(norms[0], norms[1])):
        raise AssertionError(f"adamw: norm {[float(x) for x in norms]}, f64 "
                             f"{f64}")
    differ = []
    for i, (g, p, p0, m, v, s) in enumerate(leaves):
        pp, mm, vv = p0.clone(), torch.zeros_like(m), torch.zeros_like(v)
        for step, clip in enumerate(clips):
            t = np.float32(step + 1)
            aref.update(g, pp, mm, vv, s, clip, opt, cosine_schedule(opt, step),
                        float(np.float32(1) - np.float32(opt.b1) ** t),
                        float(np.float32(1) - np.float32(opt.b2) ** t))
        if not (torch.equal(pp, p) and torch.equal(mm, m)
                and torch.equal(vv, v)):
            differ.append((i, tuple(p.shape)))
        del pp, mm, vv
    if differ:
        raise AssertionError(f"adamw: kernel and plain update differ at "
                             f"leaves {differ}")
    leaves = [(g, p, m, v, s) for g, p, _, m, v, s in leaves]
    del start
    t = np.float32(3)
    lr, bc1, bc2 = (cosine_schedule(opt, 2),
                    float(np.float32(1) - np.float32(opt.b1) ** t),
                    float(np.float32(1) - np.float32(opt.b2) ** t))

    gs, flat = [x[0] for x in leaves], [False] * len(leaves)
    clip = clips[-1]

    def plain_norm():
        return aref.sq_sums(gs, flat)[0]

    def plain_update(clip):
        for leaf in leaves:
            aref.update(*leaf, clip, opt, lr, bc1, bc2)

    def plain():
        clip = torch.clamp(opt.grad_clip / (torch.sqrt(plain_norm()) + 1e-9),
                           max=1.0)
        plain_update(clip)
    # the library's fused AdamW takes one dtype for p, g, m and v: f32
    # copies of p and g (4 bytes an element more than the port moves)
    lists = [[x[1].float() for x in leaves], [x[0].float() for x in leaves],
             [x[2] for x in leaves], [x[3] for x in leaves]]
    steps = [torch.ones((), device="cuda") for _ in leaves]

    def library():
        torch._fused_adamw_(*lists, [], steps, lr=lr, beta1=opt.b1,
                            beta2=opt.b2, weight_decay=opt.weight_decay,
                            eps=opt.eps, amsgrad=False, maximize=False)
    # norm: g read; update: g and p read, p written, m and v read and written
    norm_bytes = sum(g.numel() * g.element_size() for g in gs)
    update_bytes = sum(p.numel() * (2 * p.element_size() + g.element_size()
                                    + 16) for g, p, *_ in leaves)
    nbytes = norm_bytes + update_bytes
    bound_ms, bound_by = bound(nbytes, 0, "float32")
    parts = {}
    for part, nb, fn, plain_fn, lib_fn, plain_call, lib_call, err in (
            ("norm", norm_bytes, lambda: ak.adamw_norm_cuda(gs, flat),
             plain_norm, lambda: torch._foreach_norm(gs),
             "ref.sq_sums", "torch._foreach_norm (a norm a leaf)",
             abs(float(norms[0]) - f64)),
            ("update", update_bytes,
             lambda: ak.adamw_update_cuda(leaves, clip, opt, lr, bc1, bc2),
             lambda: plain_update(clip), library, "ref.update a leaf",
             "torch._fused_adamw_ (f32 p, g, m and v)", 0.0)):
        b_ms, b_by = bound(nb, 0, "float32")
        parts[part] = {"case": "moonlight_l4", "max_abs_err": err,
                       **timings(torch, "", fn),
                       **timings(torch, "plain_", plain_fn),
                       **timings(torch, "library_", lib_fn),
                       "plain_call": plain_call, "library_call": lib_call,
                       "bound_ms": b_ms, "bound_by": b_by, "bytes": nb}
    rec = {"case": "moonlight_l4", "dtype": "bfloat16", "elems": n,
           "leaves": len(leaves), "launches_per_update": 2,
           "max_abs_err": 0.0, "bitwise": True, "norm_rel_f64": norm_rel,
           **timings(torch, "", lambda: adamw_update(grads, params, state,
                                                      opt, scale)),
           **timings(torch, "plain_", plain),
           "plain_call": "ref.sq_sums, the clip, ref.update a leaf",
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           **parts}
    log(f"parity adamw {json.dumps(rec)}")
    del params, state, grads, leaves, lists, gs
    torch.cuda.empty_cache()
    return rec


def lif_case(torch, shape, timed=True):
    from repro_torch.kernels.lif import ref
    from repro_torch.kernels.lif.kernel import lif_cuda
    gen = torch.Generator().manual_seed(1)
    v, cur = (torch.randn(shape, generator=gen).cuda() for _ in range(2))
    tr = torch.rand(shape, generator=gen).cuda()
    kw = dict(alpha=0.9, beta=0.85, theta=1.0)
    got = lif_cuda(v, tr, cur, **kw)
    want = ref.lif_step(v, tr, cur, **kw)
    torch.cuda.synchronize()
    err = max(max_err(a, b) for a, b in zip(got, want))
    # the kernel may fuse αv + I into one FMA (one rounding, not two)
    if not err <= 1e-5:
        raise AssertionError(f"lif {shape}: max |kernel - plain| {err} > 1e-5")
    n = v.numel()
    bound_ms, bound_by = bound(6 * n * 4, 7 * n, "float32")
    tm = timings if timed else untimed
    rec = {"case": "x".join(map(str, shape)), "dtype": "float32",
           "max_abs_err": err, "tol": 1e-5,
           **tm(torch, "", lambda: lif_cuda(v, tr, cur, **kw)),
           **tm(torch, "plain_", lambda: ref.lif_step(v, tr, cur, **kw)),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"parity lif {json.dumps(rec)}")
    return rec


def wu_case(torch, name, dtype, b, spec, timed=True):
    from repro_torch.core.sparsity import random_unit_mask
    from repro_torch.kernels.nm_spmm import ops as nm_ops
    from repro_torch.kernels.wu_outer import ref
    from repro_torch.kernels.wu_outer.kernel import wu_outer_cuda
    k = o = 512
    gen = torch.Generator().manual_seed(2)
    mask = random_unit_mask(gen, spec, k, o)
    _, idx = nm_ops.make_compact(torch.zeros((k, o)), mask, spec.block,
                                 spec.out_tile)
    pre = torch.rand((b, k), generator=gen).to("cuda", dtype)   # traces
    mod = (0.1 * torch.randn((b, o), generator=gen)).to("cuda", dtype)
    idx = idx.cuda()
    scale = torch.tensor(0.02 / b, device="cuda", dtype=dtype)  # lr / B
    bk, bo = spec.block, spec.out_tile
    j, t = idx.shape
    wc = (0.05 * torch.randn((j, t, bk, bo), generator=gen)).to("cuda", dtype)
    got = wu_outer_cuda(pre, mod, idx, scale, bk=bk, bo=bo)
    want = ref.wu_outer(pre, mod, idx, scale, bk, bo)
    closed = wu_outer_cuda(pre, mod, idx, torch.zeros_like(scale), bk=bk,
                           bo=bo)
    applied = wu_outer_cuda(pre, mod, idx, scale, bk=bk, bo=bo, wc=wc)
    want_applied = wc + ref.wu_outer(pre, mod, idx, scale, bk, bo)
    closed_applied = wu_outer_cuda(pre, mod, idx, torch.zeros_like(scale),
                                   bk=bk, bo=bo, wc=wc)
    torch.cuda.synchronize()
    err, err_applied = max_err(got, want), max_err(applied, want_applied)
    # f32: only the order of the batch sum differs; bf16: the plain version
    # rounds the product and the scaled result to bf16, the kernel once.
    # With the add (which both round alike) the same, of the larger result.
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    tol = rel * float(want.float().abs().max())
    tol_applied = rel * float(want_applied.float().abs().max())
    if not (err <= tol and err_applied <= tol_applied):
        raise AssertionError(f"wu_outer {name}: max |kernel - plain| {err} "
                             f"(tol {tol}), with the add {err_applied} "
                             f"(tol {tol_applied})")
    if not bool((closed == 0).all()) or not torch.equal(closed_applied, wc):
        raise AssertionError(f"wu_outer {name}: a closed gate changed the "
                             f"update or the weights")
    es = pre.element_size()
    nbytes = (pre.numel() + mod.numel() + got.numel()) * es + idx.numel() * 4
    flops = 2 * b * j * t * bk * bo
    dname = str(dtype).split(".")[-1]
    bound_ms, bound_by = bound(nbytes, flops, dname)
    # the fused update also reads wc (and adds): the training path's launch
    f_bound_ms, f_bound_by = bound(nbytes + wc.numel() * es,
                                   flops + 2 * wc.numel(), dname)
    tm = timings if timed else untimed
    library = tm(torch, "library_", lambda: torch.matmul(pre.T, mod))
    fused = {"max_abs_err": err_applied, "tol": tol_applied,
             **tm(torch, "", lambda: wu_outer_cuda(pre, mod, idx, scale,
                                                   bk=bk, bo=bo, wc=wc)),
             **tm(torch, "plain_", lambda: wc + ref.wu_outer(
                 pre, mod, idx, scale, bk, bo)),
             **library, "bound_ms": f_bound_ms, "bound_by": f_bound_by,
             "plain_call": "wc + ref.wu_outer"}
    rec = {"case": name, "dtype": dname, "shape": [b, k, j, t, bk, bo],
           "max_abs_err": err, "tol": tol, "closed_gate_zero": True,
           **tm(torch, "", lambda: wu_outer_cuda(pre, mod, idx, scale,
                                                 bk=bk, bo=bo)),
           **tm(torch, "plain_", lambda: ref.wu_outer(pre, mod, idx,
                                                       scale, bk, bo)),
           **library, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_call": "torch.matmul(pre.T, mod)", "fused": fused}
    log(f"parity wu_outer {json.dumps(rec)}")
    return rec


def wu_slots_case(torch, name, open_frac, s=N_STREAMS, k=512, timed=True):
    """The per-slot update in place at the serving shape (``s`` slots, K = N
    = ``k`` at the paper's 4-group sparsity: T 104 at 512, f32) on one layer
    of slot-leading deltas ``[S, 2, J, T, 1, 1]``, a share ``open_frac`` of the slots open: bit for bit against
    the plain ``delta + ref.wu_outer_slots``, closed slots and the other
    layer not written (compared as bits). Bytes and the bound count the open
    slots only: the kernel never touches a closed one."""
    from repro_torch.core.sparsity import paper_spec_4groups, random_unit_mask
    from repro_torch.kernels.nm_spmm import ops as nm_ops
    from repro_torch.kernels.wu_outer import ref
    from repro_torch.kernels.wu_outer.kernel import wu_outer_slots_cuda
    o = k
    gen = torch.Generator().manual_seed(5)
    spec = paper_spec_4groups(k, 0.8)
    _, idx = nm_ops.make_compact(torch.zeros((k, o)),
                                 random_unit_mask(gen, spec, k, o), 1, 1)
    j, t = idx.shape
    pre = torch.rand((s, k), generator=gen).cuda()              # traces
    mod = (0.1 * torch.randn((s, o), generator=gen)).cuda()
    gate = (torch.rand(s, generator=gen) < open_frac).cuda()
    scale = torch.where(gate, 0.02, 0.0)
    deltas = (0.01 * torch.randn((s, 2, j, t, 1, 1), generator=gen)).cuda()
    idx = idx.cuda()
    view = deltas[:, 1]
    before = deltas.clone()
    want = view + ref.wu_outer_slots(pre, mod, idx, scale, 1, 1)
    wu_outer_slots_cuda(view, pre, mod, idx, scale, bk=1, bo=1)
    torch.cuda.synchronize()
    err = max_err(view, want)
    bits = lambda a: a.contiguous().view(torch.int32)   # noqa: E731
    checks = {"bitwise": torch.equal(view, want),
              "closed_untouched": torch.equal(bits(deltas[~gate, 1]),
                                              bits(before[~gate, 1])),
              "other_layer_untouched": torch.equal(bits(deltas[:, 0]),
                                                   bits(before[:, 0]))}
    if not all(checks.values()):
        raise AssertionError(f"wu_outer_slots {name}: {checks}, max |kernel - "
                             f"plain| {err}")
    n_open = int(gate.sum())
    nbytes = 4 * (n_open * (2 * j * t + k + o) + j * t + s)
    bound_ms, bound_by = bound(nbytes, 3 * n_open * j * t, "float32")
    tm = timings if timed else untimed
    rec = {"case": name, "dtype": "float32", "shape": [s, k, j, t, 1, 1],
           "open_slots": n_open, "max_abs_err": err, "tol": 0.0, **checks,
           **tm(torch, "", lambda: wu_outer_slots_cuda(
               view, pre, mod, idx, scale, bk=1, bo=1)),
           **tm(torch, "plain_", lambda: view + ref.wu_outer_slots(
               pre, mod, idx, scale, 1, 1)),
           "library_ms": None, "plain_call": "delta + ref.wu_outer_slots",
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}
    log(f"parity wu_outer_slots {json.dumps(rec)}")
    return rec


def causal_pairs(s, window):
    """Visible (query, key) pairs of one head: sum over rows of min(i + 1, w)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_case(torch, name, dtype, b, s, h, kv, dh, window, timed=True):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops, ref
    from repro_torch.kernels.flash_attn.kernel import flash_fwd_cuda
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((b, s, h, dh), generator=gen).to("cuda", dtype)
    k, v = (torch.randn((b, s, kv, dh), generator=gen).to("cuda", dtype)
            for _ in range(2))
    out, lse = flash_fwd_cuda(q, k, v, window)
    kl = ops._to_kernel_layout(q, k, v)
    o_r, lse_r = ref.flash_fwd(*kl, window)
    o_r = ops._from_kernel_layout(o_r, b, s, h, dh)
    torch.cuda.synchronize()
    err, lse_err = max_err(out, o_r), max_err(lse, lse_r)
    # f32: sums in another order, 1e-5 per element; bf16: per element, one
    # bf16 ulp of the element plus 2^-6 of its row's rms (the p terms are
    # rounded at other running maxima), ref.bf16_out_tolerance. lse: f32
    # sums of <= S terms, fast exp/log.
    if dtype == torch.float32:
        tol, tol_rule = 1e-5, "1e-5"
    else:
        tol, tol_rule = ref.bf16_out_tolerance(o_r), "2^-7|o_r| + 2^-6 rms_row(o_r)"
    over = float(((out.float() - o_r.float()).abs() / tol).max())
    if not (over <= 1.0 and lse_err <= 1e-4):
        raise AssertionError(f"flash_fwd {name}: |kernel - plain| out up to "
                             f"{over} x ({tol_rule}), max {err}; lse {lse_err} "
                             f"(tol 1e-4)")
    es = q.element_size()
    nbytes = 2 * (q.numel() + k.numel()) * es + lse.numel() * 4
    flops = 4 * dh * causal_pairs(s, window) * b * h
    dname = str(dtype).split(".")[-1]
    bound_ms, bound_by = bound(nbytes, flops, dname)
    tm = timings if timed else untimed
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None or window >= s:     # a window past S masks nothing
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    else:
        i = torch.arange(s, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    rec = {"case": name, "dtype": dname, "shape": [b, s, h, kv, dh],
           "window": window, "max_abs_err": err, "tol": tol_rule,
           "err_over_tol": over, "lse_max_abs_err": lse_err,
           **tm(torch, "", lambda: flash_fwd_cuda(q, k, v, window)),
           **tm(torch, "plain_", lambda: ref.flash_fwd(*kl, window)),
           **tm(torch, "library_", lib),
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "bytes": nbytes}
    log(f"parity flash_fwd {json.dumps(rec)}")
    return rec


def sdpa_backend(names):
    """Which SDPA backend ran, from its kernels' names."""
    joined = " ".join(names).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if key in joined:
            return backend
    return "math"


def flash_bwd_case(torch, name, dtype, b, s, h, kv, dh, window, timed=True):
    """Both backward kernels against the plain f32 ``ref.flash_bwd`` on the
    forward kernel's ``out`` and ``lse``; one record per kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops, ref
    from repro_torch.kernels.flash_attn.kernel import (flash_bwd_dkv_cuda,
                                                       flash_bwd_dq_cuda,
                                                       flash_fwd_cuda)
    gen = torch.Generator().manual_seed(4)
    q, dout = (torch.randn((b, s, h, dh), generator=gen).to("cuda", dtype)
               for _ in range(2))
    k, v = (torch.randn((b, s, kv, dh), generator=gen).to("cuda", dtype)
            for _ in range(2))
    out, lse = flash_fwd_cuda(q, k, v, window)
    delta = ops.bwd_delta(out, dout)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, window)
    dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, window)
    # the plain version in f32 on the same bf16 values, GQA groups summed
    # in f32 (the kernel sums them in f32 and rounds once; the reference
    # rounds each head's dk/dv and then sums)
    kl = ops._to_kernel_layout(q, k, v)
    ol = ops._to_kernel_layout(out, k, v)[0]
    dol = dout.transpose(1, 2).reshape(b * h, s, dh)
    f32 = [x.float() for x in (*kl, ol)]
    grads = ref.flash_bwd(*f32, lse, dol.float(), window)
    sigmas = ref.bwd_rounding_sigmas(*f32, lse, dol.float(), window)

    def group(x):
        return x.reshape(b, kv, h // kv, s, dh).sum(2).transpose(1, 2)
    want = {"dq": (ops._from_kernel_layout(grads[0], b, s, h, dh),
                   ops._from_kernel_layout(sigmas[0], b, s, h, dh)),
            "dk": (group(grads[1]), group(sigmas[1] ** 2).sqrt()),
            "dv": (group(grads[2]), group(sigmas[2] ** 2).sqrt())}
    del grads, sigmas
    torch.cuda.synchronize()
    errs = {}
    for key, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        r, sg = want[key]
        if dtype == torch.float32:      # sums in another order
            tol = 1e-5 * float(r.abs().max())
        else:
            tol = ref.bf16_grad_tolerance(r, sg)
        d = (got.float() - r).abs()
        errs[key] = (float(d.max()), float((d / tol).max()))
    del want
    bad = {k: e for k, e in errs.items() if not e[1] <= 1.0}
    if bad:
        raise AssertionError(f"flash_bwd {name}: |kernel - plain| over the "
                             f"bound: {bad} (max abs, x bound)")
    tol_rule = ("1e-5 max|g|" if dtype == torch.float32 else
                "2^-7|g| + 2^-6 sigma + 2^-16 max|g| (ref.bf16_grad_tolerance)")
    es = q.element_size()
    pairs = causal_pairs(s, window) * b * h
    dname = str(dtype).split(".")[-1]
    io = {"dkv": (2 * q.numel() + 4 * k.numel()) * es + 2 * lse.numel() * 4,
          "dq": (3 * q.numel() + 2 * k.numel()) * es + 2 * lse.numel() * 4}
    flops = {"dkv": 4 * 2 * dh * pairs, "dq": 3 * 2 * dh * pairs}
    tm = timings if timed else untimed
    plain = tm(torch, "plain_", lambda: ref.flash_bwd(
        *kl, ol, lse, dol, window))
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    if window is None or window >= s:     # a window past S masks nothing
        so = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
    else:
        i = torch.arange(s, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        so = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                            enable_gqa=True)
    dso = dout.transpose(1, 2)

    def lib():
        torch.autograd.grad(so, (qt, kt, vt), dso, retain_graph=True)
    library = tm(torch, "library_", lib)
    backend = (sdpa_backend(e.name for e in device_kernels(torch, lib)[0])
               if timed else "not timed")
    recs = {}
    for which, fn, keys in (
            ("dkv", lambda: flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, window),
             ("dk", "dv")),
            ("dq", lambda: flash_bwd_dq_cuda(q, k, v, dout, lse, delta, window),
             ("dq",))):
        bound_ms, bound_by = bound(io[which], flops[which], dname)
        rec = {"case": name, "dtype": dname, "shape": [b, s, h, kv, dh],
               "window": window,
               "max_abs_err": max(errs[k][0] for k in keys),
               "err_over_tol": max(errs[k][1] for k in keys),
               "errs": {k: errs[k] for k in keys}, "tol": tol_rule,
               **tm(torch, "", fn), **plain, **library,
               "library_call": f"scaled_dot_product_attention backward "
                               f"(dq, dk and dv; backend {backend})",
               "plain_call": "ref.flash_bwd (dq, dk and dv, f32 products)",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "flops": flops[which], "bytes": io[which]}
        log(f"parity flash_bwd_{which} {json.dumps(rec)}")
        recs[which] = rec
    return recs


def paper_config(backend):
    from repro_torch.core.dsst import DSSTConfig
    from repro_torch.core.gating import GatingConfig
    from repro_torch.core.snn import SNNConfig
    return SNNConfig(n_in=512, n_hidden=512, n_layers=2, n_out=16,
                     t_steps=50, sparsity=0.8,
                     dsst=DSSTConfig(period=40, prune_frac=0.25),
                     gating=GatingConfig(enabled=True), backend=backend)


def kernel_counters():
    from repro_torch.kernels import launch_counters
    return launch_counters()


def reset_counters():
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    return counters


NO_ATTN = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def adamw_launches(steps):
    """The fused AdamW's launches over ``steps`` optimizer steps of one
    process: a step launches the norm once and the update once."""
    return {"adamw_norm": steps, "adamw_update": steps}


NO_ADAMW = adamw_launches(0)
# what the fused AdamW serves in the JAX package: jnp, fused by XLA
ADAMW_JNP = "src/repro/optim/optimizer.py:62"


def fleet_digest(done):
    """Per stream, what the bit-for-bit gates compare: the timesteps fed,
    the window logits' bytes and a SHA-256 of the final deltas' bytes (the
    deltas themselves, 430 MB for the fleet, are not kept)."""
    return {s.sid: (s.timesteps_fed,
                    b"".join(p.logits.tobytes() for p in s.predictions),
                    hashlib.sha256(s.final_deltas.tobytes()).hexdigest())
            for s in done}


def check_same(want, got, what):
    """Raise unless two fleet digests agree stream for stream."""
    if sorted(want) != sorted(got):
        raise AssertionError(f"{what}: other streams retired")
    bad = [sid for sid in want if want[sid] != got[sid]]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} streams differ bit for bit "
                             f"(first {bad[:8]})")


_SOURCES = {}


def stream_sources(task, sids, aer):
    """Fresh sources for ``sids``. Each is built once (its seeded sampling is
    most of a fleet's set-up) and handed out as a copy rewound to its first
    chunk: a source's only state is its cursor, and no consumer writes the
    chunks it releases."""
    from repro_torch.serving import AERStreamSource, TaskStreamSource
    out = []
    for sid in sids:
        key = (id(task), aer, sid)
        if key not in _SOURCES:
            source = AERStreamSource if aer else TaskStreamSource
            _SOURCES[key] = source(task, N_WINDOWS, seed=sid)
        src = copy.copy(_SOURCES[key])
        src._next = 0
        out.append(src)
    return out


def run_fleet(torch, params, task, tag, sids=None, chunk_len=CHUNK_LEN,
              aer=False, tiers=None, tier_of=None, **kw):
    """Serve gesture streams ``sids`` (all N_STREAMS by default; seed = sid,
    N_WINDOWS windows, AER-packed with ``aer``) through the port's
    ``StreamScheduler`` on the paper network until drained, one slot a
    stream (``tiers``: ``(name, chunk_len, n_slots)`` geometries, each
    stream on ``tier_of(sid)``); ``kw`` go to the scheduler. Gates: every
    stream retired with N_WINDOWS predictions and finite final deltas;
    ``nm_spmm``, ``nm_spmm_fused``, ``lif`` and ``wu_outer_slots`` launched
    grid steps x C x L times summed over the tiers, ``wu_outer`` and the
    attention kernels never. Returns ``(record, launches, digest,
    scheduler)``."""
    from repro_torch.serving import StreamScheduler, StreamSession, TierConfig
    cfg = paper_config("kernels")
    sids = list(range(N_STREAMS)) if sids is None else list(sids)
    geometry = ([TierConfig(*t) for t in tiers] if tiers else
                [TierConfig("default", chunk_len, len(sids))])
    t0 = time.perf_counter()
    sources = stream_sources(task, sids, aer)
    sched = StreamScheduler(params, cfg, n_slots=len(sids),
                            chunk_len=chunk_len, device="cuda",
                            tiers=geometry if tiers else None, **kw)
    try:
        for sid, src in zip(sids, sources):
            sched.submit(StreamSession(sid=sid, source=src),
                         tier=tier_of(sid) if tier_of else None)
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counters()
        t0 = time.perf_counter()
        done = sched.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
    finally:
        sched.close()
    steps = sched.grid.stats["steps"]
    # on a slot mesh every entry launches the kernels for its own slots
    shards = 1 if sched.mesh is None else sched.mesh.size
    per_step = cfg.n_layers * shards * sum(
        sched.tier_grid(t.name).stats["steps"] * t.chunk_len
        for t in geometry)
    # serving keeps its base weights frozen: the batch-summed update never
    # launches, the per-slot one once per layer-timestep (in place, into the
    # slots' deltas), every nm_spmm launch carries the slots' deltas, and the
    # SNN has no attention
    want = {"nm_spmm": per_step, "nm_spmm_fused": per_step, "lif": per_step,
            "wu_outer": 0, "wu_outer_slots": per_step, **NO_ATTN,
            **NO_ADAMW}
    if len(done) != len(sids):
        raise AssertionError(f"{tag}: {len(done)} of {len(sids)} streams "
                             "retired")
    short = [s.sid for s in done if len(s.predictions) != N_WINDOWS]
    if short:
        raise AssertionError(f"{tag}: streams without {N_WINDOWS} "
                             f"predictions: {short[:8]}")
    if launches != want:
        raise AssertionError(f"{tag} launched {launches}, want {want} "
                             f"(grid steps x C x {cfg.n_layers} x {shards} "
                             f"shards summed over the tiers for nm_spmm, lif "
                             f"and wu_outer_slots)")
    if not bool(torch.isfinite(sched.deltas).all()):
        raise AssertionError(f"{tag}: non-finite serving deltas")
    if not all(bool(np.isfinite(s.final_deltas).all()) for s in done):
        raise AssertionError(f"{tag}: non-finite final deltas")
    roll = sched.telemetry.rollup()
    rec = {"streams": len(sids), "windows_per_stream": N_WINDOWS,
           "grid_steps": steps, "chunk_len": chunk_len,
           "n_slots": sched.n_slots, "shards": shards,
           "pipeline_depth": sched.pipeline_depth, "aer": aer,
           "ingest": sched.ingest is not None, "launches": launches,
           "wall_s": wall, "setup_s": setup_s, "events_in": roll["events_in"],
           "timesteps": roll["timesteps"],
           "events_per_s": roll["events_per_s"],
           "timesteps_per_s": roll["timesteps_per_s"],
           "p50_step_ms": roll["p50_ms"], "p99_step_ms": roll["p99_ms"],
           "overlap_ratio": roll["overlap_ratio"],
           "phases": sched.telemetry.phase_percentiles(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "deltas_bytes": sched.deltas.numel() * 4}
    if tiers:
        rec["tiers"] = [list(t) for t in tiers]
    log(f"{tag} {json.dumps(rec)}")
    return rec, launches, fleet_digest(done), sched


# phase 19e: every 4th stream on a short-chunk tier, the rest on a long one
RUNTIME_TIERS = (("interactive", 2, N_STREAMS // 4),
                 ("bulk", CHUNK_LEN, N_STREAMS - N_STREAMS // 4))
TRACE_PAIRS = 1          # 19d's untraced / traced pairs (cut from 2)
RUNTIME_SPANS = ("sched.step", "sched.stage", "sched.poll_sources",
                 "sched.dispatch", "sched.retire", "sched.device_wait")


def runtime(torch, params, task, ref):
    """Phase 19 (module docstring): the serving runtime on phase 4's fleet,
    each run held bit for bit against phase 4's digest ``ref`` (19e's
    tiered run against its two single-grid runs)."""
    from repro_torch.obs import (Tracer, parse_prometheus_text,
                                 prometheus_text, write_chrome_trace)
    from repro_torch.serving import (AutopilotConfig, DepthAutopilot,
                                     IngestConfig)
    out, launches = {}, {}

    def run(tag, **kw):
        rec, n, digest, sched = run_fleet(torch, params, task, tag, **kw)
        launches[tag] = n
        return rec, digest, sched

    # 19a: AER sources, depth 1, ingestion off then on
    rec_off, d_off, _ = run("runtime_aer_inline", aer=True, pipeline_depth=1)
    rec_on, d_on, sched = run("runtime_aer_ingest", aer=True,
                              pipeline_depth=1, ingest=True)
    check_same(d_off, d_on, "19a: ingestion on against off")
    check_same(ref, d_off, "19a: AER sources against phase 4")
    stats = sched.ingest.stats()
    if stats["chunks_queued"] <= 0 or stats["attached"] != 0:
        raise AssertionError(f"19a: ingest worker stats {stats}: it queued "
                             "nothing or a stream stayed attached")
    parsed = parse_prometheus_text(prometheus_text(sched.telemetry.registry))
    rec_on.update(ingest_stats=stats,
                  ingest_chunks_total=parsed["serving_ingest_chunks_total"],
                  ingest_queue_peak=parsed["serving_ingest_queue_peak_chunks"])
    # for the record: the worker idle-waits 0.5 ms between polling rounds
    # over every stream; the same run with a 50 ms idle wait (a drain wakes
    # it at once either way)
    rec_idle, digest, _ = run("runtime_aer_ingest_idle50ms", aer=True,
                              pipeline_depth=1,
                              ingest=IngestConfig(idle_wait_s=0.05))
    check_same(ref, digest, "19a: ingestion with a 50 ms idle wait")
    out["ingest"] = {"inline": rec_off, "ingest": rec_on,
                     "ingest_idle50ms": rec_idle}
    del sched, d_off, d_on

    # 19b: depth 2, ingestion on
    out["depth2"], digest, _ = run("runtime_depth2", pipeline_depth=2,
                                   ingest=True)
    check_same(ref, digest, "19b: depth 2 against phase 4")
    # for the record: depth 2 with the sources polled inline, phase 4's
    # fleet but for the depth
    out["depth2_inline"], digest, _ = run("runtime_depth2_inline",
                                          pipeline_depth=2)
    check_same(ref, digest, "19b: depth 2 inline against phase 4")

    # 19c: the default autopilot from depth 1, ingestion on; its decisions
    # recorded into a tracer of its own
    ap_tracer = Tracer(capacity=1 << 16)
    ap = DepthAutopilot(AutopilotConfig(), tracer=ap_tracer)
    rec, digest, sched = run("runtime_autopilot", pipeline_depth=1,
                             ingest=True, autopilot=ap)
    check_same(ref, digest, "19c: the autopilot's run against phase 4")
    actions = {}
    for sp in ap_tracer.spans("autopilot.decision"):
        actions[sp.attr("action")] = actions.get(sp.attr("action"), 0) + 1
    if len(ap.depths_visited()) < 2 and not actions:
        raise AssertionError("19c: the autopilot neither moved nor recorded "
                             "a decision")
    rec.update(timeline=[list(t) for t in ap.timeline],
               depths_visited=list(ap.depths_visited()), overlap_ema=ap.ema,
               decisions=actions, final_depth=sched.pipeline_depth,
               config=dict(vars(ap.cfg)))
    out["autopilot"] = rec
    log(f"runtime_autopilot_decisions {json.dumps(actions)} timeline "
        f"{rec['timeline']} ema {ap.ema}")
    del sched

    # 19d: phase 4's fleet with and without a tracer, interleaved
    walls = {"untraced": [], "traced": []}
    for i in range(TRACE_PAIRS):
        rec, digest, _ = run(f"runtime_untraced_{i}", pipeline_depth=1)
        check_same(ref, digest, "19d: untraced run against phase 4")
        walls["untraced"].append(rec["wall_s"])
        tracer = Tracer(capacity=1 << 16)
        rec, digest, sched = run(f"runtime_traced_{i}", pipeline_depth=1,
                                 tracer=tracer)
        check_same(ref, digest, "19d: traced run against phase 4")
        walls["traced"].append(rec["wall_s"])
        steps = sched.grid.stats["steps"]
        if tracer.n_dropped:
            raise AssertionError(f"19d: the tracer dropped {tracer.n_dropped}")
        for name in RUNTIME_SPANS:
            got = sorted(sp.attr("grid_step") for sp in tracer.spans(name))
            if got != list(range(1, steps + 1)):
                raise AssertionError(f"19d: {name} spans name grid steps "
                                     f"{got[:6]}..., want one each of "
                                     f"1..{steps}")
        parsed = parse_prometheus_text(
            prometheus_text(sched.telemetry.registry))
        if parsed.get("serving_grid_steps_total") != steps:
            raise AssertionError("19d: the Prometheus scrape does not parse "
                                 "back to the run's grid steps")
    span_ms = {}
    for name in RUNTIME_SPANS:
        durs = sorted(sp.dur_s * 1e3 for sp in tracer.spans(name))
        span_ms[name] = {"p50": durs[len(durs) // 2], "max": durs[-1],
                         "total": sum(durs)}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    write_chrome_trace(os.path.join(ROOT, "chiprun_out",
                                    "runtime_trace.json"), tracer)
    cost = sum(walls["traced"]) / sum(walls["untraced"]) - 1.0
    out["tracer"] = {"walls_s": walls, "cost": cost, "allowance": 0.25,
                     "spans": tracer.n_recorded, "span_ms": span_ms,
                     "scrape_samples": len(parsed)}
    log(f"runtime_tracer {json.dumps(out['tracer'])}")
    del sched, tracer

    # 19e: two tiers against single-grid runs of each tier's geometry
    def tier_of(sid):
        return "interactive" if sid % 4 == 0 else "bulk"
    rec, tiered, sched = run("runtime_tiers", tiers=RUNTIME_TIERS,
                             tier_of=tier_of, ingest=True, pipeline_depth=1)
    if sched.n_compiles_by_tier != {name: 1 for name, _, _ in RUNTIME_TIERS}:
        raise AssertionError(f"19e: chunk fns run per tier "
                             f"{sched.n_compiles_by_tier}, want 1 each")
    per_tier = sched.telemetry.per_tier()
    rec.update(tier_latency=sched.telemetry.tier_percentiles(),
               tier_events_per_s={name: t["events_in"] / rec["wall_s"]
                                  for name, t in per_tier.items()},
               n_compiles_by_tier=sched.n_compiles_by_tier)
    del sched
    solo, solo_recs = {}, {}
    for name, c, n in RUNTIME_TIERS:
        solo_recs[name], digest, _ = run(
            f"runtime_solo_{name}", chunk_len=c, pipeline_depth=1,
            sids=[sid for sid in range(N_STREAMS) if tier_of(sid) == name])
        solo.update(digest)
    check_same(solo, tiered, "19e: tiered streams against their tier's "
               "single grid")
    rec["solo"] = solo_recs
    out["tiers"] = rec
    log(f"runtime_tiers_summary {json.dumps({k: rec[k] for k in ('tier_latency', 'tier_events_per_s', 'events_per_s')})}")
    total = {name: sum(n[name] for n in launches.values())
             for name in kernel_counters()}
    out["launches_by_run"] = launches
    _SOURCES.clear()
    return out, total


SYNC_STEPS = 20
# what a compact serving chunk step launches, C x L times each (a fused
# nm_spmm launch counts on both of its counters, as in phase 4)
SERVING_KERNELS = ("nm_spmm", "nm_spmm_fused", "lif", "wu_outer_slots")


def sync_check(torch, params, task, runs, total, phase):
    """Phase 20c's check, for each of ``runs`` (scheduler keywords by tag):
    SYNC_STEPS grid steps of phase 4's fleet with the stage-side phases
    under the sync debug mode (``guard_syncs``), launches added to
    ``total``; a sync in a guarded phase or launches other than SYNC_STEPS
    x C x L (summed over tiers, times the mesh's entries) fail ``phase``."""
    from repro_torch.analysis.sync_guard import GUARDED_PHASES, guard_syncs
    from repro_torch.serving import StreamScheduler, StreamSession
    cfg = paper_config("kernels")

    def tier_of(sid):
        return "interactive" if sid % 4 == 0 else "bulk"
    out = {}
    sids = list(range(N_STREAMS))
    for tag, kw in runs.items():
        sched = StreamScheduler(params, cfg, n_slots=N_STREAMS,
                                chunk_len=CHUNK_LEN, device="cuda", **kw)
        try:
            for sid, src in zip(sids, stream_sources(task, sids, False)):
                sched.submit(StreamSession(sid=sid, source=src),
                             tier=tier_of(sid) if "tiers" in kw else None)
            guard_syncs(sched)
            counters = reset_counters()
            t0 = time.perf_counter()
            errors = []
            for _ in range(SYNC_STEPS):
                try:
                    sched.step()
                except RuntimeError as e:
                    errors.append(str(e)[:300])
                    break
            if not errors:
                sched.flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            sched.close()
        launches = {n: c.launches for n, c in counters.items() if c.launches}
        for n, k in launches.items():
            total[n] += k
        chunk = sum(t.chunk_len for t in kw["tiers"]) if "tiers" in kw \
            else CHUNK_LEN
        shards = kw["mesh"].size if "mesh" in kw else 1
        want = {n: SYNC_STEPS * chunk * cfg.n_layers * shards
                for n in SERVING_KERNELS}
        if not errors and launches != want:
            raise AssertionError(f"{phase} {tag}: launched {launches}, want "
                                 f"{want}")
        out[tag] = {"grid_steps": SYNC_STEPS, "syncs": len(errors),
                    "errors": errors, "guarded": list(GUARDED_PHASES),
                    "wall_s": wall, "launches": launches,
                    "pipeline_depth": sched.pipeline_depth, "shards": shards}
        if errors:
            raise AssertionError(f"{phase} {tag}: a device sync in a guarded "
                                 f"phase: {errors[0]}")
    return out


def analysis(torch, params, task):
    """Phase 20 (module docstring): the static checks on the card."""
    from repro_torch.analysis import dispatch_contracts as dc
    from repro_torch.analysis import registry
    from repro_torch.core.snn import (init_stream_deltas, init_stream_state,
                                      serving_params)
    from repro_torch.serving import AutopilotConfig, TierConfig, make_chunk_fn
    out = {"registry": {}}
    total = {name: 0 for name in kernel_counters()}

    # (a) every registry entry at its small geometry, launches read around
    # each checked call; the compact SNN entries launch the serving kernels
    # C x L times a call
    small = registry.snn_cfg()
    for name in registry.names():
        fn, args, contracts, kwargs = registry.build(name, "cuda")
        torch.cuda.synchronize()
        counters = reset_counters()
        t0 = time.perf_counter()
        rep = dc.check(fn, args, contracts, kwargs=kwargs, name=name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        for n in total:
            total[n] += launches[n]
        if not rep.ok:
            raise AssertionError(f"20a: {rep}")
        per_call = {n: k / rep.calls for n, k in launches.items() if k}
        if name.startswith("launch."):
            want = {}                 # the decode step reads its cache plainly
        else:                         # args: (params, deltas, state, events, ..)
            # the dense layout: the base product unfused, the per-slot
            # update a masked outer product in plain torch
            # a sharded entry's every mesh entry launches them
            mesh = getattr(fn, "mesh", None)
            shards = 1 if mesh is None else mesh.size
            want = {n: float(args[3].shape[0] * small.n_layers * shards)
                    for n in (("nm_spmm", "lif") if "dense" in name
                              else SERVING_KERNELS)}
        if per_call != want:
            raise AssertionError(f"20a: {name} launched {per_call} a call, "
                                 f"want {want}")
        out["registry"][name] = {"contracts": list(rep.contracts),
                                 "calls": rep.calls, "launches": launches,
                                 "launches_per_call": per_call,
                                 "wall_s": wall}
    log(f"analysis_registry {json.dumps(out['registry'])}")

    # (b) the contract set at full width, on phase 4's chunk fn (1024 slots,
    # C 8, the paper network) with the factors off (as phase 4 serves) and on
    cfg = paper_config("kernels")
    g = torch.Generator(device="cuda").manual_seed(0)
    S = N_STREAMS
    args = (serving_params(params, cfg), init_stream_deltas(cfg, S, "cuda"),
            init_stream_state(cfg, S, "cuda"),
            (torch.rand((CHUNK_LEN, S, cfg.n_in), device="cuda", generator=g)
             < 0.05).float(),
            torch.ones((CHUNK_LEN, S), dtype=torch.bool, device="cuda"),
            torch.ones(S, dtype=torch.bool, device="cuda"))
    k_max = max(cfg.layer_fanins)
    out["full_width"] = {
        "slots": S, "chunk_len": CHUNK_LEN,
        "dense_deltas_bytes": S * cfg.n_layers * k_max * cfg.n_hidden * 4,
        "compact_deltas_bytes": args[1].numel() * 4}
    for want_factors in (False, True):
        fn = registry.counted(make_chunk_fn(cfg, want_factors=want_factors))
        contracts = registry.chunk_contracts(cfg, S, CHUNK_LEN, compact=True,
                                             want_factors=want_factors)
        fn(*args)
        torch.cuda.synchronize()
        plain = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            plain.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        n_ops = len(dc.record(fn, args).ops)
        torch.cuda.synchronize()
        recorded = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counters()
        t0 = time.perf_counter()
        rep = dc.check(fn, args, contracts, name="phase4.chunk_fn")
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        for n in total:
            total[n] += launches[n]
        if not rep.ok:
            raise AssertionError(f"20b (want_factors={want_factors}): {rep}")
        want = {n: rep.calls * CHUNK_LEN * cfg.n_layers
                for n in SERVING_KERNELS}
        got = {n: k for n, k in launches.items() if k}
        if got != want:
            raise AssertionError(f"20b: the checked calls launched {got}, "
                                 f"want {want}")
        rec = {"contracts": list(rep.contracts), "calls": rep.calls,
               "launches": got, "ops_recorded": n_ops,
               "unchecked_ms": sorted(plain)[1] * 1e3,
               "recorded_ms": recorded * 1e3,
               "recorded_over_unchecked": recorded / sorted(plain)[1],
               "check_ms": check_s * 1e3,
               "peak_bytes": torch.cuda.max_memory_allocated()}
        out["full_width"]["factors" if want_factors else "frozen"] = rec
    del args
    log(f"analysis_full_width {json.dumps(out['full_width'])}")

    # (c) 20 grid steps of phase 4's fleet per run with the stage-side
    # phases under the sync debug mode: depth 1 polled inline, depth 2 with
    # ingestion and the autopilot, phase 19e's two tiers
    runs = {"depth1_inline": dict(pipeline_depth=1),
            "depth2_ingest_autopilot": dict(pipeline_depth=2, ingest=True,
                                            autopilot=AutopilotConfig()),
            "tiers": dict(pipeline_depth=1, ingest=True,
                          tiers=[TierConfig(*t) for t in RUNTIME_TIERS])}
    out["sync_check"] = sync_check(torch, params, task, runs, total, "20c")
    out["launches"] = total
    log(f"analysis {json.dumps(out)}")
    _SOURCES.clear()
    return out, total


def step_breakdown(torch, params, want_factors=False, mesh=None,
                   tag="step_breakdown"):
    """Where one full-grid chunk step goes (1024 slots, all valid, 8
    timesteps). One untraced call gives the host's enqueue time and its wall
    to completion; one call under ``torch.profiler`` gives the device busy
    time (summed kernel durations), the device span (first kernel start to
    last kernel end) and that same call's wall, from which the idle share
    is taken; with the largest kernels by name. ``want_factors``: the chunk
    accumulates the DSST factors a live topology service reads. ``mesh``:
    the slot-sharded step, its arguments placed on the mesh beforehand (as
    the scheduler holds them), so the call is the shards' steps alone."""
    from repro_torch.core.snn import (init_stream_deltas, init_stream_state,
                                      serving_params)
    from repro_torch.launch import sharding
    from repro_torch.serving import make_chunk_fn
    cfg = paper_config("kernels")
    fn = make_chunk_fn(cfg, want_factors=want_factors, mesh=mesh)
    g = torch.Generator(device="cuda").manual_seed(0)
    S = N_STREAMS
    args = (serving_params(params, cfg), init_stream_deltas(cfg, S, "cuda"),
            init_stream_state(cfg, S, "cuda"),
            (torch.rand((CHUNK_LEN, S, cfg.n_in), device="cuda", generator=g)
             < 0.05).float(),
            torch.ones((CHUNK_LEN, S), dtype=torch.bool, device="cuda"),
            torch.ones(S, dtype=torch.bool, device="cuda"))
    if mesh is not None:
        args = sharding.place_args(
            args, sharding.chunk_step_specs(want_factors)[0], mesh)
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    rec = {"slots": S, "chunk_len": CHUNK_LEN, "want_factors": want_factors,
           "shards": 1 if mesh is None else mesh.size,
           "wall_ms": step_ms, "enqueue_ms": enqueue_ms,
           **trace_summary(torch, lambda: fn(*args))}
    log(f"{tag} {json.dumps(rec)}")
    return rec


def record_lif(cfg, run):
    """Run ``run()`` with every LIF call through the engine's seam recorded:
    returns ``(result, spikes, pre-reset membranes)``, stacked per call."""
    import torch
    from repro_torch.core import engine
    spikes, pre = [], []
    orig = engine.lif

    def recording_lif(*args, **kw):
        res = orig(*args, **kw)
        v, _, s = res
        spikes.append(s)
        pre.append(v + s * cfg.theta)      # membrane before the reset
        return res
    engine.lif = recording_lif
    try:
        out = run()
    finally:
        engine.lif = orig
    return out, torch.stack(spikes), torch.stack(pre)


def spike_rule(torch, sk, sr, pr, theta):
    """The LIF calls must agree on every spike until a first call where
    they differ, and there every flipped neuron's membrane must lie within
    1e-5 of θ; a flip there may change what follows, so from then on
    agreement is counted over the neuron-steps where either side spiked
    (not over all of them, where silent neurons would hide flips)."""
    calls_equal = [bool(torch.equal(a, b)) for a, b in zip(sk, sr)]
    first = calls_equal.index(False) if False in calls_equal else None
    near_theta = True
    if first is not None:
        flips = sk[first] != sr[first]
        near_theta = bool(((pr[first] - theta).abs()[flips] < 1e-5).all())
    fired = (sk > 0) | (sr > 0)
    agree = (float((sk == sr)[fired].float().mean()) if bool(fired.any())
             else 1.0)
    return {"lif_calls": len(sk), "spike_agreement_where_fired": agree,
            "first_differing_call": first, "first_flips_near_theta": near_theta,
            "spikes": float(sk.sum()), "fired_either": int(fired.sum())}


def path_parity(torch, params, task):
    """One chunk through backend "kernels" and backend "ref", under the
    spike rule of :func:`spike_rule` (agreement >= 99.9 %).

    The windows start one step before the ``tr_pc`` snapshot (t 24 of 50),
    so the chunk (t 24-31) latches it and reaches the weight update (t >= 30)
    with a non-zero modulator: the per-slot update must run (``sop_wu`` > 0,
    deltas non-zero) and the deltas agree. Both backends take the same
    ``nm_spmm`` and ``wu_outer_slots`` kernels, so they differ only in how
    ``αv + I`` is rounded (the Triton kernel may fuse it into one FMA)."""
    import numpy as np
    from repro_torch.core.snn import (init_stream_deltas, init_stream_state,
                                      run_chunk, serving_params)
    n_slots = 64
    cfg = paper_config("kernels")
    t0 = int(cfg.t_steps * cfg.pc_snapshot_frac) - 1
    t_wu = int(cfg.t_steps * cfg.wu_start_frac)
    if not t0 + CHUNK_LEN > t_wu:
        raise AssertionError(f"the chunk from t {t0} never reaches t_wu {t_wu}")
    rng = np.random.default_rng(0)
    ev = np.stack([task.sample(rng, 1)[0][t0:t0 + CHUNK_LEN, 0]
                   for _ in range(n_slots)], axis=1)           # [C, S, n_in]
    events = torch.from_numpy(ev).cuda()
    valid = torch.ones((CHUNK_LEN, n_slots), dtype=torch.bool, device="cuda")
    out = {}
    for backend in ("kernels", "ref"):
        cfg = paper_config(backend)
        state = init_stream_state(cfg, n_slots, "cuda")._replace(
            t_in_window=torch.full((n_slots,), t0, dtype=torch.int32,
                                   device="cuda"))
        out[backend] = record_lif(cfg, lambda: run_chunk(
            serving_params(params, cfg),
            init_stream_deltas(cfg, n_slots, "cuda"), state, events, valid,
            cfg))
    ((dk, _, mk), sk, _), ((dr, _, mr), sr, pr) = out["kernels"], out["ref"]
    err = max_err(mk.logits, mr.logits)
    ok = (torch.allclose(mk.logits, mr.logits, atol=1e-4, rtol=1e-4)
          and torch.allclose(dk, dr, atol=1e-6, rtol=1e-4))
    rec = {"slots": n_slots, "chunk_len": CHUNK_LEN, "t_in_window": t0,
           "t_wu": t_wu, "logits_max_abs_err": err,
           "sop_wu": float(mk.sop_wu.sum()),
           "deltas_nonzero": int((dk != 0).sum()),
           "deltas_max_abs": float(dk.abs().max()),
           "deltas_max_abs_err": max_err(dk, dr),
           **spike_rule(torch, sk, sr, pr, cfg.theta)}
    log(f"path_parity {json.dumps(rec)}")
    if not ok or not rec["first_flips_near_theta"] \
            or rec["spike_agreement_where_fired"] < 0.999 \
            or not rec["sop_wu"] > 0 or not rec["deltas_nonzero"]:
        raise AssertionError(f"kernels vs ref path: {rec}")
    return rec


def train(torch, task):
    """The paper network learns TRAIN_SAMPLES gesture samples through
    ``make_train_fn`` (two DSST epochs), then one ``make_eval_fn`` call;
    raises unless every kernel launched once per layer-timestep, each epoch
    kept the N:M invariant and recycled L x G x J x k units, and the
    weights are finite and exactly zero off the mask."""
    import numpy as np
    from repro_torch.core import engine, topology
    from repro_torch.core.snn import (accuracy, init_params, init_state,
                                      make_eval_fn, make_train_fn)
    cfg = paper_config("kernels")
    spec = cfg.spec(cfg.n_in)
    kb, jj = spec.unit_counts(cfg.n_in, cfg.n_hidden)
    params = init_params(1, cfg, device="cuda")
    state = init_state(cfg, TRAIN_BATCH, "cuda")
    step, eval_fn = make_train_fn(cfg), make_eval_fn(cfg)
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    data = [tuple(torch.from_numpy(a).cuda() for a in task.sample(rng, TRAIN_BATCH))
            for _ in range(TRAIN_SAMPLES)]
    ev_e, lab_e = (torch.from_numpy(a).cuda()
                   for a in task.sample(np.random.default_rng(7), EVAL_BATCH))
    setup_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    epochs = []
    t0 = time.perf_counter()
    for i, (ev, lab) in enumerate(data):
        before = params["hidden"]["mask"]
        params, state, m = step(params, state, ev, lab)
        if cfg.dsst.is_update_step(i):          # host int: no device read
            epochs.append((i, before, params["hidden"]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, me = eval_fn(params, init_state(cfg, EVAL_BATCH, "cuda"), ev_e)
    acc = float(accuracy(me.logits, lab_e))
    eval_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    want = (TRAIN_SAMPLES + 1) * cfg.t_steps * cfg.n_layers
    for name, n in launches.items():
        if n != (0 if name in NO_ATTN or name in NO_ADAMW
                 or name in ("nm_spmm_fused", "wu_outer_slots") else want):
            raise AssertionError(f"{name} launched {n} times in training, want "
                                 f"{want} (= {TRAIN_SAMPLES} + 1 samples x "
                                 f"{cfg.t_steps} x {cfg.n_layers}; flash and "
                                 f"the per-slot deltas and AdamW 0)")
    if [i for i, _, _ in epochs] != [39, 79]:
        raise AssertionError(f"DSST epochs after samples {[e[0] for e in epochs]}")
    epoch_recs = []
    for i, before, hidden in epochs + [(None, None, params["hidden"])]:
        mask, w = hidden["mask"], hidden["w"]
        if not topology.check(mask, cfg):
            raise AssertionError(f"N:M invariant broken after sample {i}")
        off = engine.dense_masks(mask, cfg) == 0
        if not bool(torch.isfinite(w).all()) or float(w[off].abs().max()) != 0.0:
            raise AssertionError(f"weights non-finite or non-zero off the mask "
                                 f"after sample {i}")
        if before is None:
            continue
        k = cfg.dsst.k_per_group(spec, i)
        pruned = int((before & ~mask).sum())
        regrown = int((~before & mask).sum())
        expect = cfg.n_layers * (kb // spec.m) * jj * k
        if pruned != expect or regrown != expect:
            raise AssertionError(f"epoch after sample {i}: pruned {pruned}, "
                                 f"regrown {regrown}, want {expect}")
        epoch_recs.append({"after_sample": i, "k_per_group": k,
                           "recycled": pruned})

    # one training sample under the profiler, for where the time goes
    ev, lab = data[0]
    profiled = trace_summary(torch, lambda: step(params, state, ev, lab))
    rec = {"batch": TRAIN_BATCH, "samples": TRAIN_SAMPLES,
           "t_steps": cfg.t_steps, "n_layers": cfg.n_layers,
           "setup_s": setup_s, "train_s": train_s,
           "samples_per_s": TRAIN_SAMPLES / train_s,
           "ms_per_sample": train_s / TRAIN_SAMPLES * 1e3,
           "eval_batch": EVAL_BATCH, "eval_s": eval_s, "eval_accuracy": acc,
           "max_memory_allocated": peak, "launches": launches,
           "epochs": epoch_recs, "profiled_sample": profiled}
    log(f"training {json.dumps(rec)}")
    return rec, launches


def train_parity(torch, task):
    """One 8-row training sample through backend "kernels" (compact rep:
    ``nm_spmm``, ``lif``, ``wu_outer``) and "ref" (dense rep: ``pre @ w``,
    plain LIF, masked dense WU), taken as the last sample of a DSST period
    so that one topology epoch runs under both: logits within 1e-4, the
    updated dense weights within 1e-5, the masks after the epoch equal, and
    spikes under the rule of :func:`spike_rule`."""
    import numpy as np
    from repro_torch.core.snn import init_params, init_state, run_sample
    rows = 8
    ev, lab = (torch.from_numpy(a).cuda()
               for a in task.sample(np.random.default_rng(3), rows))
    params = init_params(2, paper_config("ref"), device="cuda")
    out = {}
    for backend in ("kernels", "ref"):
        cfg = paper_config(backend)
        state = init_state(cfg, rows, "cuda")._replace(
            sample_idx=cfg.dsst.period - 1)
        out[backend] = record_lif(cfg, lambda: run_sample(
            params, state, ev, lab, cfg))
    ((pk, _, mk), sk, _), ((pr_, _, mr), sr, pr) = out["kernels"], out["ref"]
    wk, wr = pk["hidden"]["w"], pr_["hidden"]["w"]
    mask0, mask_k, mask_r = (p["hidden"]["mask"] for p in (params, pk, pr_))
    rec = {"rows": rows, "sample_idx": cfg.dsst.period - 1,
           "logits_max_abs_err": max_err(mk.logits, mr.logits),
           "weights_max_abs_err": max_err(wk, wr),
           "weights_max_abs_update": max_err(wr, params["hidden"]["w"]),
           "mask_units_differing": int((mask_k != mask_r).sum()),
           "mask_units_recycled": int((mask0 & ~mask_r).sum()),
           **spike_rule(torch, sk, sr, pr, cfg.theta)}
    log(f"train_parity {json.dumps(rec)}")
    ok = (torch.allclose(mk.logits, mr.logits, atol=1e-4, rtol=1e-4)
          and torch.allclose(wk, wr, atol=1e-5, rtol=1e-5)
          and rec["mask_units_differing"] == 0
          and rec["mask_units_recycled"] > 0)
    if not ok or not rec["first_flips_near_theta"] \
            or rec["spike_agreement_where_fired"] < 0.999:
        raise AssertionError(f"training kernels vs ref path: {rec}")
    return rec


def lm_model(torch, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           device="cuda")
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def lm_prompts(torch, cfg, b, s, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s), generator=g, device="cuda")


def lm_serve(torch, cfg, params, tag="lm_serving"):
    """``generate`` at full width: 4 prompts of 2048 tokens, 32 greedy
    tokens; then, for the record, the same work step by step (prefill and
    decode timed apart, synchronised) and one prefill and one decode step
    under the profiler."""
    from repro_torch.launch.serve import generate, make_serve_step
    from repro_torch.models import transformer as T
    prompt = lm_prompts(torch, cfg, LM_BATCH, LM_PROMPT, 1)
    max_seq = LM_PROMPT + LM_NEW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompt, LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {"nm_spmm": 0, "nm_spmm_fused": 0, "lif": 0, "wu_outer": 0,
            "wu_outer_slots": 0, **NO_ATTN, "flash_fwd": attn_calls(cfg),
            **NO_ADAMW}
    if launches != want:
        raise AssertionError(f"LM serving launched {launches}, want {want} "
                             f"(one prefill of {attn_calls(cfg)} attention "
                             f"layers, none in decode)")
    new = out[:, LM_PROMPT:]
    if tuple(out.shape) != (LM_BATCH, LM_PROMPT + LM_NEW) \
            or not torch.equal(out[:, :LM_PROMPT], prompt) \
            or int(new.min()) < 0 or int(new.max()) >= cfg.vocab:
        raise AssertionError(f"generate returned {tuple(out.shape)}, tokens "
                             f"in [{int(new.min())}, {int(new.max())}]")

    step = make_serve_step(cfg)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = T.prefill(params, cfg, prompt, max_seq)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(last).all()):
            raise AssertionError("non-finite last-position logits")
        toks, step_ms = [last.argmax(-1)], []
        for _ in range(1, LM_NEW):
            t0 = time.perf_counter()
            logits, cache = step(params, cache, toks[-1])
            toks.append(logits.argmax(-1))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite decode logits")
        p50 = sorted(step_ms)[len(step_ms) // 2]
        prof_prefill = trace_summary(
            torch, lambda: T.prefill(params, cfg, prompt, max_seq))
        prof_decode = trace_summary(torch, lambda: step(params, cache, toks[-1]))
    nparams = cfg.param_count()
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    cache_bytes = sum(t.numel() * t.element_size()
                      for k, t in cache.items() if k != "pos")
    # the recurrent state (Mamba2's conv window and SSM state) is also
    # written back whole every step; a K/V cache only at one position
    state_bytes = sum(cache[k].numel() * cache[k].element_size()
                      for k in ("conv", "ssm") if k in cache)
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "batch": LM_BATCH, "prompt_len": LM_PROMPT, "new_tokens": LM_NEW,
           "param_count": nparams, "weight_bytes": weight_bytes,
           "cache_bytes": cache_bytes, "state_write_bytes": state_bytes,
           "launches": launches,
           "generate_s": gen_s, "max_memory_allocated": peak,
           "tokens_equal_step_by_step": bool(torch.equal(
               torch.stack(toks, 1), new)),
           "prefill_ms": prefill_ms,
           "prompt_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_ms * 1e3,
           "decode_ms_p50": p50, "decode_ms": step_ms,
           "generated_tokens_per_s": LM_BATCH / p50 * 1e3,
           # decode reads every weight and the cache once per step, and
           # writes the recurrent state
           "decode_bound_ms": (weight_bytes + cache_bytes + state_bytes)
           / HBM_BYTES_PER_S * 1e3,
           "prefill_trace": prof_prefill, "decode_trace": prof_decode}
    log(f"{tag} {json.dumps({k: v for k, v in rec.items() if k != 'decode_ms'})}")
    return rec, launches


def attn_calls(cfg):
    """``flash_fwd`` launches in one prefill: one per attention layer (the
    hybrid's shared-block calls; none for ssm)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def bf16_ulp(x):
    """The spacing of bf16 values at ``|x|`` (8 significant bits)."""
    return math.ldexp(1.0, math.frexp(x)[1] - 8)


def greedy_trace(torch, cfg, params, prompt, n_new, attn):
    """Greedy decoding as ``generate`` does it, keeping every step's logits."""
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models import transformer as T
    step = make_serve_step(cfg)
    with torch.no_grad():
        logits, cache = T.prefill(params, cfg, prompt, prompt.shape[1] + n_new,
                                  attn=attn)
        out = [logits.float()]
        for _ in range(1, n_new):
            logits, cache = step(params, cache, out[-1].argmax(-1))
            out.append(logits.float())
    return torch.stack([lg.argmax(-1) for lg in out], 1), out


def lm_parity(torch, cfg, params, tag="lm_parity"):
    """Flash against plain attention on the full-width model, under the rule
    in the module docstring (phase 9; phase 18b for Zamba2)."""
    from repro_torch.launch.serve import generate
    prompt = lm_prompts(torch, cfg, PARITY_BATCH, PARITY_PROMPT, 2)
    tok_f, lg_f = greedy_trace(torch, cfg, params, prompt, PARITY_NEW, "flash")
    tok_p, lg_p = greedy_trace(torch, cfg, params, prompt, PARITY_NEW, "plain")
    via_generate = generate(params, cfg, prompt, PARITY_NEW)[:, PARITY_PROMPT:]
    d = lg_f[0] - lg_p[0]
    rel_l2 = float(d.norm() / lg_p[0].norm())
    max_logit = float(lg_p[0].abs().max())
    rec = {"batch": PARITY_BATCH, "prompt_len": PARITY_PROMPT,
           "new_tokens": PARITY_NEW, "logits_rel_l2": rel_l2,
           "logits_max_abs_err": float(d.abs().max()), "max_abs_logit": max_logit,
           "generate_equals_trace": bool(torch.equal(via_generate, tok_f)),
           "rows": []}
    ok = rel_l2 <= PARITY_REL_L2 and rec["generate_equals_trace"]
    for r in range(PARITY_BATCH):
        differ = (tok_f[r] != tok_p[r]).nonzero()
        first = int(differ[0]) if len(differ) else None
        row = {"first_divergence": first}
        if first is not None:
            top2 = lg_p[first][r].topk(2).values
            gap = float(top2[0] - top2[1])
            band = PARITY_GAP_ULPS * bf16_ulp(float(top2[0]))
            row.update(plain_top2_gap=gap, band=band)
            ok &= gap <= band
        rec["rows"].append(row)
    log(f"{tag} {json.dumps(rec)}")
    if not ok:
        raise AssertionError(f"flash vs plain LM path ({tag}): {rec}")
    return rec


def param_leaves(tree):
    return [x for x in leaves(tree) if x.is_floating_point()]


def active_matmul_params(cfg, params):
    """The matmul params one token's forward touches: every float leaf of
    the layers (norms and the SSM's small vectors included, as phase 10
    counts them), of a MoE layer's experts only its top k of E, the hybrid's
    shared block once per call, and the head."""
    n = sum(x.numel() for x in param_leaves(params["layers"]))
    if cfg.family == "moe":
        moe = params["layers"]["moe"]
        experts = sum(moe[m]["w"].numel() for m in ("w1", "w2", "w3") if m in moe)
        n -= experts - experts * cfg.moe_top_k // cfg.moe_experts
    if "shared" in params:
        n += attn_calls(cfg) * sum(x.numel() for x in param_leaves(params["shared"]))
    return n + params["lm_head"].numel()


def train_flops(cfg, params, b, s):
    """Model flops of one training step: 6 x the active matmul params x
    tokens, plus 6 x each attention call's score products (QKᵀ and PV, 2·dh
    a visible pair and head). The SSD's own products (f32, on the CUDA
    cores) are not counted."""
    score = 2 * cfg.head_dim * causal_pairs(s, cfg.swa_window) * b * cfg.n_heads
    return (6 * active_matmul_params(cfg, params) * b * s
            + 6 * score * attn_calls(cfg))


def eval_ce(torch, cfg, params, batches, loss_chunk):
    """The next-token cross entropy of ``params`` on each of ``batches``,
    without autograd."""
    from repro_torch.models import transformer as T
    chunked = bool(loss_chunk) and not cfg.tie_embeddings
    out = []
    with torch.no_grad():
        for b in batches:
            h, _ = T.forward(params, cfg, tokens=b["tokens"], want_hidden=chunked)
            ce = (T.lm_loss_chunked(h, params["lm_head"], b["labels"], loss_chunk)
                  if chunked else T.lm_loss(h, b["labels"]))
            out.append(float(ce))
            del h
    return out


def lm_train(torch, cfg=None, hp=None, tag="lm_training", loss_chunk=None,
             same_batches=False):
    """Phase 10 (and 21, 22 with their configs): the model trains
    TRAIN_STEPS steps of ``make_train_step`` from ``init_train_state`` on a
    CUDA generator seeded 0, batch TRAIN_B x TRAIN_S from ``TokenPipeline``;
    raises unless every step's loss, grad norm and params are finite and
    launched exactly ``attn_calls`` ``flash_bwd_dkv`` and ``flash_bwd_dq``
    and twice as many ``flash_fwd`` under remat (the SNN kernels never), and
    the model learned: the last loss below the first (phase 10), or with
    ``same_batches`` the mean cross entropy over the run's batches after
    the steps below the initial model's over the same batches (the
    pipeline's batches differ in difficulty by more than 8 steps of
    learning: an untrained model's CE moves by up to 1 nat from one batch
    to the next). Returns (record, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.core.gating import GatingConfig
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.train import (TrainHParams, init_train_state,
                                          make_train_step)
    from repro_torch.optim import AdamWConfig, adamw_update
    cfg = cfg or get_config(TRAIN_ARCH)
    hp = hp or TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=100),
                            gating=GatingConfig())
    torch.cuda.synchronize()
    held = allocation(torch)
    t0 = time.perf_counter()
    params, opt_state, sparse_state = init_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg, hp, "cuda")
    torch.cuda.synchronize()
    # what the state took from the allocator (phase 23c's dry-run gate)
    init_allocated = allocation_growth(torch, held,
                                       (params, opt_state, sparse_state))
    step = make_train_step(cfg, hp, loss_chunk=loss_chunk)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                        global_batch=TRAIN_B))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = sum(x.numel() * x.element_size() for x in
                      param_leaves(params) + param_leaves(opt_state.m)
                      + param_leaves(opt_state.v))
    L, calls = cfg.n_layers, attn_calls(cfg)
    want = {"nm_spmm": 0, "nm_spmm_fused": 0, "lif": 0, "wu_outer": 0,
            "wu_outer_slots": 0, "flash_fwd": (2 if cfg.remat else 1) * calls,
            "flash_bwd_dkv": calls, "flash_bwd_dq": calls,
            **adamw_launches(1)}
    batches = [{k: torch.from_numpy(v).to("cuda", torch.long)
                for k, v in next(pipe)[1].items()} for _ in range(TRAIN_STEPS)]
    ce_before = eval_ce(torch, cfg, params, batches, loss_chunk) \
        if same_batches else None
    steps = []
    total = {name: 0 for name in want}
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        counters = reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, sparse_state, m = step(params, opt_state,
                                                  sparse_state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {name: c.launches for name, c in counters.items()}
        rec = {"step": i, "ms": ms, "loss": float(m["loss"]),
               "ce": float(m["ce"]),
               "grad_norm": float(m["grad_norm"]), "lr": m["lr"],
               "gate_frac": float(m["gate_frac"]),
               "moe_dropped": float(m["moe_dropped"]), "launches": launches,
               "params_finite": all(bool(torch.isfinite(x).all())
                                    for x in param_leaves(params))}
        steps.append(rec)
        for name, n in launches.items():
            total[name] += n
        if launches != want or not rec["params_finite"] \
                or not all(math.isfinite(rec[k]) for k in ("loss", "grad_norm")):
            raise AssertionError(f"{tag} step {i}: {rec}; launches want "
                                 f"{want}")
    peak = torch.cuda.max_memory_allocated()
    learned = {"last_loss_below_first": steps[-1]["loss"] < steps[0]["loss"]}
    if same_batches:
        ce_after = eval_ce(torch, cfg, params, batches, loss_chunk)
        learned.update(ce_before=ce_before, ce_after=ce_after,
                       mean_ce_before=sum(ce_before) / len(ce_before),
                       mean_ce_after=sum(ce_after) / len(ce_after))
        fell = learned["mean_ce_after"] < learned["mean_ce_before"]
    else:
        fell = learned["last_loss_below_first"]
    if not fell:
        raise AssertionError(f"{tag}: loss did not fall: {learned}; "
                             f"losses "
                             f"{[r['loss'] for r in steps]}; ce "
                             f"{[r['ce'] for r in steps]}; moe_dropped "
                             f"{[r['moe_dropped'] for r in steps]}; step ms "
                             f"{[r['ms'] for r in steps]}")
    timed = sorted(r["ms"] for r in steps[1:])
    ms = timed[len(timed) // 2]
    tokens = TRAIN_B * TRAIN_S
    n_mat = active_matmul_params(cfg, params)
    model_flops = train_flops(cfg, params, TRAIN_B, TRAIN_S)
    _, batch = next(pipe)
    batch = {k: torch.from_numpy(v).to("cuda", torch.long) for k, v in batch.items()}
    holder = {"state": (params, opt_state, sparse_state)}

    def one_step():
        p, o, sp = holder["state"]
        p, o, sp, _ = step(p, o, sp, batch)
        holder["state"] = (p, o, sp)
    profiled = trace_summary(torch, one_step)
    # the step's two halves timed apart: loss and gradients, then AdamW
    p, o, _ = holder["state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = step.loss_and_grads(p, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(grads, p, o, hp.opt)
    torch.cuda.synchronize()
    split = {"loss_and_grads_ms": (t1 - t0) * 1e3,
             "adamw_ms": (time.perf_counter() - t1) * 1e3}
    del grads, p, o, holder, params, opt_state, sparse_state
    rec = {"arch": cfg.name, "family": cfg.family, "n_layers": L,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
           "batch": TRAIN_B, "seq": TRAIN_S, "steps": TRAIN_STEPS,
           "loss_chunk": loss_chunk, "init_s": init_s,
           "init_allocated": init_allocated,
           "param_count": cfg.param_count(), "matmul_params": n_mat,
           "state_bytes": state_bytes, "ms_per_step": ms,
           "tokens_per_s": tokens / ms * 1e3, "model_flops": model_flops,
           "mfu": model_flops / (ms * 1e-3) / PEAK_BF16,
           "bound_ms_at_peak": model_flops / PEAK_BF16 * 1e3,
           "max_memory_allocated": peak, "losses": [r["loss"] for r in steps],
           "ce": [r["ce"] for r in steps],
           "gate_frac": [r["gate_frac"] for r in steps],
           "moe_dropped": [r["moe_dropped"] for r in steps],
           "grad_norms": [r["grad_norm"] for r in steps],
           "step_ms": [r["ms"] for r in steps],
           "launches_per_step": want, "launches": total, **split,
           "learned": learned, "profiled_step": profiled}
    log(f"{tag} {json.dumps(rec)}")
    return rec, total


def allocation(torch):
    """(bytes allocated, bytes requested) from the caching allocator: the
    blocks it handed out, and the sizes asked for before its rounding."""
    return (torch.cuda.memory_allocated(),
            torch.cuda.memory_stats()["requested_bytes.all.current"])


def allocation_growth(torch, before, tree):
    """What a new state tree took from the allocator since ``before``, with
    the most its rounding may add: a block is a multiple of ALLOC_ROUND
    bytes, and one above 1 MiB (the large pool) keeps a remainder of up to
    1 MiB that is not split off (PyTorch's ``CUDACachingAllocator``)."""
    from repro_torch.launch.dryrun import tensors
    alloc, req = allocation(torch)
    sizes = [x.numel() * x.element_size() for x in tensors(tree)]
    return {"bytes": alloc - before[0], "requested_bytes": req - before[1],
            "tensor_leaves": len(sizes),
            "rounding_bound": sum(ALLOC_ROUND - 1 + (1 << 20 if n > 1 << 20
                                                     else 0) for n in sizes)}


def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def lm_train_parity(torch):
    """Phase 11 (module docstring)."""
    import dataclasses
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.launch.train import (TrainHParams, init_train_state,
                                          make_train_step)
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_PARITY_LAYERS)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100))
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_PARITY_S),
                              generator=g, device="cuda")
             for k in ("tokens", "labels")}
    params, opt_state, sparse_state = init_train_state(
        torch.Generator(device="cuda").manual_seed(1), cfg, hp, "cuda")
    out = {}
    for attn in ("flash", "plain"):
        step = make_train_step(cfg, hp, attn=attn)
        loss, _, grads = step.loss_and_grads(params, batch)
        out[attn] = (float(loss), {"/".join(k): v for k, v in flat(grads).items()
                                   if v is not None})
    (lf, gf), (lp, gp) = out["flash"], out["plain"]
    grad_err = {k: rel_l2(gf[k], gp[k]) for k in gp}
    rec = {"layers": cfg.n_layers, "batch": TRAIN_B, "seq": TRAIN_PARITY_S,
           "loss_flash": lf, "loss_plain": lp,
           "loss_rel_err": abs(lf - lp) / abs(lp), "grad_rel_l2": grad_err,
           "grad_rel_l2_max": max(grad_err.values()),
           "grad_rel_l2_bound": TRAIN_GRAD_REL_L2}
    del out, gf, gp
    # one full step on the flash route: updated params finite
    params, *_ = make_train_step(cfg, hp)(params, opt_state, sparse_state, batch)
    rec["updated_params_finite"] = all(bool(torch.isfinite(x).all())
                                       for x in param_leaves(params))
    del params, opt_state, sparse_state

    # OSSL local mode: block 0's CE gradient is exactly zero
    hp_l = dataclasses.replace(hp, mode="local")
    p_l, o_l, s_l = init_train_state(torch.Generator(device="cuda").manual_seed(2),
                                     cfg, hp_l, "cuda")
    leaf = {"wq0": p_l["layers"]["attn"]["wq"]["w"], "lm_head": p_l["lm_head"]}
    tracked = {k: v.detach().requires_grad_() for k, v in leaf.items()}
    p_t = dict(p_l, lm_head=tracked["lm_head"])
    p_t["layers"] = dict(p_l["layers"], attn=dict(p_l["layers"]["attn"],
                                                  wq={"w": tracked["wq0"]}))
    logits, aux = T.forward(p_t, cfg, tokens=batch["tokens"], local_mode=True)
    g_wq, g_head = torch.autograd.grad(T.lm_loss(logits, batch["labels"]),
                                       list(tracked.values()),
                                       allow_unused=True, materialize_grads=True)
    del logits
    _, _, _, m_l = make_train_step(cfg, hp_l)(p_l, o_l, s_l, batch)
    rec["local"] = {"block0_ce_grad_max": float(g_wq[0].abs().max()),
                    "readout_ce_grad_max": float(g_head.abs().max()),
                    "local_loss": float(aux["local_loss"].detach()),
                    "step_loss": float(m_l["loss"])}
    del p_l, o_l, s_l, p_t, tracked, g_wq, g_head

    # masked N:M with a DSST event after the step
    sp = SparsityConfig(n=2, m=8, block=32, targets=("mlp",), mode="masked")
    cfg_s = cfg.with_sparsity(sp)
    hp_s = dataclasses.replace(hp, dsst_every=1)
    p_s, o_s, s_s = init_train_state(torch.Generator(device="cuda").manual_seed(3),
                                     cfg_s, hp_s, "cuda")
    before = {k: p_s["layers"]["mlp"][k]["umask"].clone() for k in ("w1", "w2", "w3")}
    p_s, _, _, m_s = make_train_step(cfg_s, hp_s)(p_s, o_s, s_s, batch)
    masks = {}
    for k, um in before.items():
        new = p_s["layers"]["mlp"][k]["umask"]
        groups = new.reshape(new.shape[0], -1, sp.m).sum(-1)
        masks[k] = {"shape": list(new.shape),
                    "n_per_group_exact": bool((groups == sp.n).all()),
                    "units_moved": int((new & ~um).sum())}
    rec["masked"] = {"masks": masks, "dsst_mask_change": float(m_s["dsst_mask_change"]),
                     "loss": float(m_s["loss"])}
    log(f"lm_train_parity {json.dumps(rec)}")
    ok = (rec["loss_rel_err"] <= 0.01 and rec["grad_rel_l2_max"] <= TRAIN_GRAD_REL_L2
          and rec["updated_params_finite"]
          and rec["local"]["block0_ce_grad_max"] == 0.0
          and rec["local"]["readout_ce_grad_max"] > 0.0
          and math.isfinite(rec["local"]["step_loss"])
          and all(v["n_per_group_exact"] and v["units_moved"] > 0
                  for v in masks.values()))
    if not ok:
        raise AssertionError(f"LM training parity: {rec}")
    return rec

# phases 12-14: the live topology service, the dense delta layout, checkpoints
TOPO_EVERY, TOPO_MERGE_TOP = 25, 1
PARITY_SLOTS = 64
DENSE_WINDOWS, DENSE_EPOCH_EVERY = 2, 4
DENSE_ATOL = 1e-5            # tests/test_compact_serving.py's layout tolerance
RESUME_LAYERS, RESUME_S, RESUME_STEPS, RESUME_CKPT_AFTER = 2, 1024, 6, 3


def watch_epochs(torch, sched):
    """Wrap ``sched.maybe_evolve_topology`` so that every epoch that runs is
    checked by :func:`check_epoch` right after its swap, against the mask
    and deltas it read (an epoch writes neither). The check is only
    enqueued on the card, behind the swap and ahead of the next chunk
    (which updates the deltas in place), with no host wait, in slices of
    slots (no full-size temporaries, so the run's peak memory is the
    fleet's); :func:`read_epoch_check` reads its verdict after the serve.
    The host time spent enqueuing is summed in ``checks["s"]``."""
    checks = {"epochs": [], "s": 0.0}
    orig = sched.maybe_evolve_topology

    def watched(*args, **kw):
        old_mask, old_deltas = sched.params["hidden"]["mask"], sched.deltas
        event = orig(*args, **kw)
        if event is not None:
            t0 = time.perf_counter()
            checks["epochs"].append(check_epoch(
                torch, sched.cfg, event, old_mask, old_deltas,
                sched.params["hidden"]["mask"], sched.deltas))
            checks["s"] += time.perf_counter() - t0
        return event
    sched.maybe_evolve_topology = watched
    return checks


def check_epoch(torch, cfg, event, old_mask, old_deltas, new_mask, new_deltas,
                slots_per_slice=128):
    """One live epoch's gates, enqueued on the card without a host read:
    the N:M invariant, pruned = regrown = L x G x J x k (k from
    ``k_for_event`` at the epoch index), and compact deltas remapped by
    kept ids: every lane outside the merged one keeps its surviving blocks'
    bits (old and new ids compared), regrown blocks and the merged lane are
    exactly zero. Returns the pending verdicts (0-d device tensors) for
    :func:`read_epoch_check`."""
    from repro_torch.core import topology
    from repro_torch.core.sparsity import check_unit_mask
    spec = cfg.spec(cfg.n_in)
    kb, jj = spec.unit_counts(cfg.n_in, cfg.n_hidden)
    k = cfg.dsst.k_for_event(spec, event.epoch)
    old_ids = topology.stacked_kept_ids(old_mask, cfg)
    new_ids = topology.stacked_kept_ids(new_mask, cfg)
    eq = new_ids[..., :, None] == old_ids[..., None, :]          # [L, J, T, T]
    hit, pos = eq.any(-1), eq.to(torch.uint8).argmax(-1)
    lanes = torch.ones(new_deltas.shape[0], dtype=torch.bool,
                       device=new_deltas.device)
    for slot in event.merged_slots:
        lanes[slot] = False
    ok = torch.ones((), dtype=torch.bool, device=new_deltas.device)
    survivors, regrown_zero, merged_zero = ok, ok, ok
    for s0 in range(0, new_deltas.shape[0], slots_per_slice):
        nd = new_deltas[s0:s0 + slots_per_slice]
        od = torch.take_along_dim(old_deltas[s0:s0 + slots_per_slice],
                                  pos[None, ..., None, None], dim=3)
        lane = lanes[s0:s0 + slots_per_slice][:, None, None, None, None, None]
        kept = hit[None, ..., None, None]
        survivors = survivors & ((nd == od) | ~(lane & kept)).all()
        regrown_zero = regrown_zero & ~torch.where(kept, 0.0, nd).any()
        merged_zero = merged_zero & ~torch.where(lane, 0.0, nd).any()
    return {"event": event, "k_per_group": k,
            "expect": cfg.n_layers * (kb // spec.m) * jj * k,
            "pruned": (old_mask & ~new_mask).sum(),
            "regrown": (~old_mask & new_mask).sum(),
            "nm": check_unit_mask(new_mask, spec),
            "survivors": survivors, "regrown_zero": regrown_zero,
            "merged_zero": merged_zero, "surviving_blocks": hit.sum(),
            "regrown_blocks": (~hit).sum()}


def read_epoch_check(pending):
    """Read one :func:`check_epoch` verdict back and raise on a failed
    gate; returns the epoch's record."""
    event, expect = pending["event"], pending["expect"]
    pruned, regrown = int(pending["pruned"]), int(pending["regrown"])
    if not (event.pruned == event.regrown == pruned == regrown == expect):
        raise AssertionError(f"epoch {event.epoch}: pruned {pruned} "
                             f"({event.pruned}), regrown {regrown} "
                             f"({event.regrown}), want {expect}")
    if not bool(pending["nm"]):
        raise AssertionError(f"epoch {event.epoch}: N:M invariant broken")
    survivors, regrown_zero, merged_zero = (
        bool(pending[key])
        for key in ("survivors", "regrown_zero", "merged_zero"))
    if not (survivors and regrown_zero and merged_zero):
        raise AssertionError(f"epoch {event.epoch}: survivors bitwise "
                             f"{survivors}, regrown zero {regrown_zero}, "
                             f"merged lanes zero {merged_zero}")
    return {"epoch": event.epoch, "grid_step": event.grid_step,
            "k_per_group": pending["k_per_group"], "pruned": pruned,
            "regrown": regrown, "mask_change": event.mask_change,
            "merged_slots": list(event.merged_slots),
            "surviving_blocks": int(pending["surviving_blocks"]),
            "regrown_blocks": int(pending["regrown_blocks"])}


def live_topology(torch, params, task):
    """Phase 12 (module docstring): the paper network serves N_STREAMS
    gesture streams with a live TopologyService."""
    from repro_torch.serving import (StreamScheduler, StreamSession,
                                     TaskStreamSource, TopologyService,
                                     TopologyServiceConfig)
    cfg = paper_config("kernels")
    svc = TopologyService(cfg, TopologyServiceConfig(
        epoch_every=TOPO_EVERY, merge_top=TOPO_MERGE_TOP))
    t0 = time.perf_counter()
    sched = StreamScheduler(params, cfg, n_slots=N_STREAMS,
                            chunk_len=CHUNK_LEN, pipeline_depth=1,
                            device="cuda", topology=svc)
    for sid in range(N_STREAMS):
        sched.submit(StreamSession(sid=sid, source=TaskStreamSource(
            task, N_WINDOWS, seed=sid)))
    setup_s = time.perf_counter() - t0
    checks = watch_epochs(torch, sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    done = sched.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    steps = sched.grid.stats["steps"]
    per_step = steps * CHUNK_LEN * cfg.n_layers
    want = {"nm_spmm": per_step, "nm_spmm_fused": per_step, "lif": per_step,
            "wu_outer": 0, "wu_outer_slots": per_step, **NO_ATTN,
            **NO_ADAMW}
    if len(done) != N_STREAMS:
        raise AssertionError(f"{len(done)} of {N_STREAMS} streams retired")
    short = [s.sid for s in done if len(s.predictions) != N_WINDOWS]
    if short:
        raise AssertionError(f"streams without {N_WINDOWS} predictions: "
                             f"{short[:8]}")
    if launches != want:
        raise AssertionError(f"live topology serving launched {launches}, "
                             f"want {want}")
    if sched.n_compiles != 1:
        raise AssertionError(f"{sched.n_compiles} chunk fns built, want 1")
    epochs = [read_epoch_check(pending) for pending in checks["epochs"]]
    if len(svc.events) < 3 or len(epochs) != len(svc.events):
        raise AssertionError(f"{len(svc.events)} epochs under traffic "
                             f"({len(epochs)} swaps checked), want >= 3")
    for rec, tel in zip(epochs, sched.telemetry.topology_epochs):
        rec["wall_s"] = tel["wall_s"]
    if not bool(torch.isfinite(sched.deltas).all()):
        raise AssertionError("non-finite deltas after live epochs")
    roll = sched.telemetry.rollup()
    rec = {"streams": N_STREAMS, "windows_per_stream": N_WINDOWS,
           "grid_steps": steps, "chunk_len": CHUNK_LEN, "pipeline_depth": 1,
           "epoch_every": TOPO_EVERY, "merge_top": TOPO_MERGE_TOP,
           "n_compiles": sched.n_compiles, "launches": launches,
           "wall_s": wall, "setup_s": setup_s,
           "events_in": roll["events_in"],
           "events_per_s": roll["events_per_s"],
           "timesteps_per_s": roll["timesteps_per_s"],
           "p50_step_ms": roll["p50_ms"], "p99_step_ms": roll["p99_ms"],
           "overlap_ratio": roll["overlap_ratio"],
           "phases": sched.telemetry.phase_percentiles(),
           "epochs": epochs, "epoch_checks_s": checks["s"],
           "topology": sched.telemetry.topology_rollup(),
           "max_memory_allocated": peak,
           "deltas_bytes": sched.deltas.numel() * 4}
    log(f"live_topology {json.dumps(rec)}")
    return rec, launches, sched


def topology_parity(torch, params, task):
    """Phase 13 (module docstring): a forced epoch between two chunks
    through both backends; then the dense and compact fleets with epochs."""
    import numpy as np
    from repro_torch.core import engine, topology
    from repro_torch.core.snn import (init_stream_deltas, init_stream_state,
                                      serving_params)
    from repro_torch.serving import (StreamScheduler, StreamSession,
                                     TaskStreamSource, TopologyService,
                                     TopologyServiceConfig, make_chunk_fn)
    S, C = PARITY_SLOTS, CHUNK_LEN
    cfg = paper_config("kernels")
    t0 = int(cfg.t_steps * cfg.pc_snapshot_frac) - 1
    rng = np.random.default_rng(0)
    ev = np.stack([task.sample(rng, 1)[0][t0:t0 + 2 * C, 0]
                   for _ in range(S)], axis=1)                # [2C, S, n_in]
    events = torch.from_numpy(ev).cuda()
    valid = torch.ones((C, S), dtype=torch.bool, device="cuda")
    amask = torch.ones(S, dtype=torch.bool, device="cuda")
    out = {}
    for backend in ("kernels", "ref"):
        bcfg = paper_config(backend)
        fn = make_chunk_fn(bcfg)
        svc = TopologyService(bcfg, TopologyServiceConfig(epoch_every=1))
        state = init_stream_state(bcfg, S, "cuda")._replace(
            t_in_window=torch.full((S,), t0, dtype=torch.int32,
                                   device="cuda"))

        def run(fn=fn, svc=svc, bcfg=bcfg, state=state):
            d1, st1, m1 = fn(serving_params(params, bcfg),
                             init_stream_deltas(bcfg, S, "cuda"), state,
                             events[:C], valid, amask)
            svc.observe(m1)
            p2, d2, event = svc.evolve(params, d1, grid_step=1)
            d3, _, m2 = fn(serving_params(p2, bcfg), d2, st1, events[C:],
                           valid, amask)
            return p2, d2, d3, m1, m2, event
        out[backend] = record_lif(bcfg, run)
    ((pk, d2k, d3k, m1k, m2k, ek), sk, _) = out["kernels"]
    ((pr_, d2r, d3r, m1r, m2r, er), sr, pr) = out["ref"]
    swap = {"slots": S, "chunk_len": C, "t_in_window": t0,
            "pruned": ek.pruned, "pruned_ref": er.pruned,
            "mask_units_differing": int((pk["hidden"]["mask"]
                                         != pr_["hidden"]["mask"]).sum()),
            "logits_max_abs_err": max(max_err(m1k.logits, m1r.logits),
                                      max_err(m2k.logits, m2r.logits)),
            "deltas_max_abs_err": max_err(d3k, d3r),
            "projected_max_abs_err": max_err(d2k, d2r),
            "sop_wu": float(m2k.sop_wu.sum()),
            "deltas_max_abs": float(d3k.abs().max()),
            **spike_rule(torch, sk, sr, pr, cfg.theta)}
    log(f"topology_parity {json.dumps(swap)}")
    ok = (swap["mask_units_differing"] == 0 and ek.pruned == er.pruned > 0
          and all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                  for a, b in ((m1k.logits, m1r.logits),
                               (m2k.logits, m2r.logits)))
          and torch.allclose(d3k, d3r, atol=1e-6, rtol=1e-4)
          and swap["sop_wu"] > 0 and swap["first_flips_near_theta"]
          and swap["spike_agreement_where_fired"] >= 0.999)
    if not ok:
        raise AssertionError(f"kernels vs ref across a swap: {swap}")
    del out

    # the dense delta layout against the compact one, with live epochs
    def drive(compact):
        svc = TopologyService(cfg, TopologyServiceConfig(
            epoch_every=DENSE_EPOCH_EVERY, merge_top=1))
        sched = StreamScheduler(params, cfg, n_slots=S, chunk_len=C,
                                pipeline_depth=1, device="cuda",
                                topology=svc, compact=compact)
        for sid in range(S):
            sched.submit(StreamSession(sid=sid, source=TaskStreamSource(
                task, DENSE_WINDOWS, seed=sid)))
        counters = reset_counters()
        done = {x.sid: x for x in sched.run_until_drained()}
        torch.cuda.synchronize()
        return sched, svc, done, {n: c.launches for n, c in counters.items()}
    sc, vc, dc, lc = drive(True)
    sd, vd, dd, ld = drive(False)
    per_step = sd.grid.stats["steps"] * C * cfg.n_layers
    want_dense = {"nm_spmm": per_step, "nm_spmm_fused": 0, "lif": per_step,
                  "wu_outer": 0, "wu_outer_slots": 0, **NO_ATTN,
                  **NO_ADAMW}
    per_step_c = sc.grid.stats["steps"] * C * cfg.n_layers
    want_compact = {"nm_spmm": per_step_c, "nm_spmm_fused": per_step_c,
                    "lif": per_step_c, "wu_outer": 0,
                    "wu_outer_slots": per_step_c, **NO_ATTN,
                    **NO_ADAMW}
    mask = sc.params["hidden"]["mask"]
    idx = topology.stacked_kept_ids(mask, cfg)
    logit_err = max(float(np.abs(a.logits - b.logits).max())
                    for sid in dc for a, b in zip(dc[sid].predictions,
                                                  dd[sid].predictions))
    off = (engine.dense_masks(mask, cfg) == 0)[None].expand_as(sd.deltas)
    layouts = {"slots": S, "windows_per_stream": DENSE_WINDOWS,
               "epoch_every": DENSE_EPOCH_EVERY,
               "grid_steps": sd.grid.stats["steps"],
               "epochs": len(vc.events), "epochs_dense": len(vd.events),
               "same_epochs": [(e.pruned, e.regrown, e.merged_slots)
                               for e in vc.events]
               == [(e.pruned, e.regrown, e.merged_slots) for e in vd.events],
               "masks_equal": bool(torch.equal(mask,
                                               sd.params["hidden"]["mask"])),
               "logits_max_abs_err": logit_err,
               "deltas_max_abs_err_at_kept": max_err(
                   engine.densify_deltas(sc.deltas, idx, cfg), sd.deltas),
               "dense_off_mask_nonzero": int((sd.deltas[off] != 0).sum()),
               "predictions": sum(len(x.predictions) for x in dd.values()),
               "launches_compact": lc, "launches_dense": ld,
               "bytes_held_compact": sc.telemetry.bytes_held()["total"],
               "bytes_held_dense": sd.telemetry.bytes_held()["total"],
               "tolerance": DENSE_ATOL}
    log(f"layout_parity {json.dumps(layouts)}")
    ok = (layouts["epochs"] >= 2 and layouts["same_epochs"]
          and layouts["masks_equal"] and logit_err <= DENSE_ATOL
          and layouts["deltas_max_abs_err_at_kept"] <= DENSE_ATOL
          and layouts["dense_off_mask_nonzero"] == 0
          and layouts["predictions"] == S * DENSE_WINDOWS
          and all(len(dc[sid].predictions) == len(dd[sid].predictions)
                  for sid in dc)
          and ld == want_dense and lc == want_compact
          and sc.n_compiles == sd.n_compiles == 1)
    if not ok:
        raise AssertionError(f"dense vs compact fleets: {layouts}")
    return {"swap": swap, "layouts": layouts}


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(path) for f in fs)


def leaves_equal(torch, a, b):
    """Keys of the leaves of two trees that differ (tensors bit for bit
    with their dtypes, host ints by value)."""
    from repro_torch.checkpoint.checkpoint import _flatten
    fa, fb = _flatten(a), _flatten(b)
    return [k for (k, x), (_, y) in zip(fa, fb)
            if not (x.dtype == y.dtype and torch.equal(x, y)
                    if isinstance(x, torch.Tensor) else x == y)] \
        if [k for k, _ in fa] == [k for k, _ in fb] else ["<structure>"]


def fleet_checkpoint(torch, sched, workdir):
    """Phase 14, the fleet: phase 12's evolved fleet saved and restored at
    full width, one chunk from each compared, and the layout migrations."""
    from repro_torch.core import engine, topology
    from repro_torch.core.snn import serving_params
    from repro_torch.serving import make_chunk_fn, restore_fleet, save_fleet
    cfg = sched.cfg
    params, deltas, state = sched.params, sched.deltas, sched.state
    step = sched.grid.stats["steps"]
    base = os.path.join(workdir, "fleet")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_fleet(base, step, params, deltas, state, keep=1)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rstep, p2, d2, s2, extra = restore_fleet(base, cfg, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    differ = leaves_equal(torch, (params, deltas, state), (p2, d2, s2))
    # one chunk from the live fleet and from the restored one
    g = torch.Generator(device="cuda").manual_seed(14)
    S = deltas.shape[0]
    events = (torch.rand((CHUNK_LEN, S, cfg.n_in), device="cuda",
                         generator=g) < 0.05).float()
    valid = torch.ones((CHUNK_LEN, S), dtype=torch.bool, device="cuda")
    amask = torch.ones(S, dtype=torch.bool, device="cuda")
    fn = make_chunk_fn(cfg)
    live = fn(serving_params(params, cfg), deltas, state, events, valid, amask)
    back = fn(serving_params(p2, cfg), d2, s2, events, valid, amask)
    chunk_differ = leaves_equal(torch, live, back)
    del live, back, p2, s2
    # migration: the compact checkpoint into a dense fleet, and back
    idx = topology.stacked_kept_ids(params["hidden"]["mask"], cfg)
    t0 = time.perf_counter()
    _, _, dd, _, _ = restore_fleet(base, cfg, compact=False, device="cuda")
    torch.cuda.synchronize()
    dense_restore_s = time.perf_counter() - t0
    off = (engine.dense_masks(params["hidden"]["mask"], cfg) == 0)
    dense_ok = (bool(torch.equal(engine.compact_deltas(dd, idx, cfg), deltas))
                and not bool(dd[off[None].expand_as(dd)].any()))
    dense_base = os.path.join(workdir, "fleet_dense")
    t0 = time.perf_counter()
    save_fleet(dense_base, step, params, dd, state, keep=1)
    dense_save_s = time.perf_counter() - t0
    dense_bytes = dir_bytes(dense_base)
    del dd
    _, _, dc, _, extra_d = restore_fleet(dense_base, cfg, compact=True,
                                         device="cuda")
    back_ok = bool(torch.equal(dc, deltas)) and extra_d["delta_layout"] == "dense"
    rec = {"slots": S, "step": rstep, "extra": extra, "bytes": dir_bytes(path),
           "deltas_bytes": deltas.numel() * deltas.element_size(),
           "save_s": save_s, "restore_s": restore_s,
           "leaves_differing": differ, "chunk_leaves_differing": chunk_differ,
           "dense_restore_s": dense_restore_s, "dense_save_s": dense_save_s,
           "dense_bytes": dense_bytes, "dense_migration_bitwise": dense_ok,
           "compact_from_dense_bitwise": back_ok}
    log(f"fleet_checkpoint {json.dumps(rec)}")
    if differ or chunk_differ or not dense_ok or not back_ok \
            or rstep != step or extra["delta_layout"] != "compact":
        raise AssertionError(f"fleet checkpoint: {rec}")
    return rec


def lm_resume(torch, workdir):
    """Phase 14, LM training: RESUME_STEPS steps straight through against a
    run checkpointed once, after step RESUME_CKPT_AFTER, and resumed to
    RESUME_STEPS from a replayed pipeline, deterministic algorithms on:
    the last loss and every param and AdamW moment bit for bit."""
    import dataclasses
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.gating import GatingConfig
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.train import TrainHParams, run_training
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RESUME_LAYERS)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                      gating=GatingConfig())

    def pipeline():
        return TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=RESUME_S,
                                            global_batch=TRAIN_B))
    walls = {"save_s": [], "restore_s": []}
    orig = {"save": ckpt.save, "restore": ckpt.restore}

    def timed(name):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](*args, **kw)
            torch.cuda.synchronize()
            walls[f"{name}_s"].append(time.perf_counter() - t0)
            return out
        return call
    base = os.path.join(workdir, "lm")
    torch.use_deterministic_algorithms(True)
    ckpt.save, ckpt.restore = timed("save"), timed("restore")
    try:
        counters = reset_counters()
        straight, h_ref = run_training(cfg, hp, pipeline(), RESUME_STEPS,
                                       log_every=1, device="cuda")
        run_training(cfg, hp, pipeline(), RESUME_CKPT_AFTER + 1, ckpt_dir=base,
                     ckpt_every=RESUME_CKPT_AFTER + 1,
                     log_every=1, device="cuda")
        written = dir_bytes(base)
        replay = pipeline()
        for _ in range(RESUME_CKPT_AFTER + 1):
            next(replay)
        resumed, h_res = run_training(cfg, hp, replay, RESUME_STEPS,
                                      ckpt_dir=base,
                                      ckpt_every=RESUME_CKPT_AFTER + 1,
                                      log_every=1, device="cuda")
        torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
    finally:
        ckpt.save, ckpt.restore = orig["save"], orig["restore"]
        torch.use_deterministic_algorithms(False)
    L = cfg.n_layers
    steps = 2 * RESUME_STEPS        # straight, then interrupted + resumed
    want = {"nm_spmm": 0, "nm_spmm_fused": 0, "lif": 0, "wu_outer": 0,
            "wu_outer_slots": 0, "flash_fwd": 2 * L * steps,
            "flash_bwd_dkv": L * steps, "flash_bwd_dq": L * steps,
            **adamw_launches(steps)}
    differ = leaves_equal(torch, (straight[0], straight[1].m, straight[1].v),
                          (resumed[0], resumed[1].m, resumed[1].v))
    rec = {"arch": TRAIN_ARCH, "layers": L, "batch": TRAIN_B, "seq": RESUME_S,
           "steps": RESUME_STEPS, "checkpoint_after_step": RESUME_CKPT_AFTER,
           "resumed_steps": h_res["step"], "loss_straight": h_ref["loss"][-1],
           "loss_resumed": h_res["loss"][-1],
           "adamw_step": [straight[1].step, resumed[1].step],
           "leaves": len(ckpt.checkpoint._flatten(straight)),
           "leaves_differing": differ, "bytes_written": written,
           "save_s": walls["save_s"], "restore_s": walls["restore_s"],
           "launches": launches}
    log(f"lm_resume {json.dumps(rec)}")
    if (differ or h_res["loss"][-1] != h_ref["loss"][-1]
            or h_res["step"] != list(range(RESUME_CKPT_AFTER + 1,
                                           RESUME_STEPS))
            or straight[1].step != resumed[1].step or launches != want
            or len(walls["save_s"]) != 1 or len(walls["restore_s"]) != 1):
        raise AssertionError(f"LM resume: {rec}; launches want {want}")
    return rec, launches


# ---------------------------------------------------------------------------
# phases 15-16: the MoE family (Moonlight-16B-A3B) on the LM serving path
# ---------------------------------------------------------------------------

class RouterSpy:
    """While open, records every MoE call in call order (the layers of one
    step, then the next step; none for a model without MoE layers, where
    ``keep_logits`` alone is of use): its router logits (bf16) and top-k expert
    ids, slots, capacity and ``moe_dropped``, on the host, by wrapping
    ``models.moe._dispatch``; the module's results pass through unchanged.
    The logits are recomputed from the call's own inputs with the same
    product shape, so they are the module's. ``keep_first`` also keeps the
    first call's input and output (on the card); ``keep_logits`` every
    ``transformer.decode_step``'s logits (f32, on the host)."""

    def __init__(self, torch, keep_first=False, keep_logits=False):
        from repro_torch.models import moe, transformer
        self.torch, self.moe, self.T = torch, moe, transformer
        self.keep_first, self.keep_logits = keep_first, keep_logits
        self.calls, self.first, self.step_logits = [], None, []

    def __enter__(self):
        torch, moe = self.torch, self.moe
        self.real = (moe._dispatch, moe.moe_apply, self.T.decode_step)
        real_dispatch, real_apply, real_step = self.real

        def dispatch(flat, router_w, cfg, c):
            slot, gate, aux = real_dispatch(flat, router_w, cfg, c)
            logits = flat @ router_w.to(flat.dtype)
            ids = moe._top_k_ids(torch.softmax(logits.float(), -1),
                                 cfg.moe_top_k)
            self.calls.append({"logits": logits.cpu(), "ids": ids.cpu(),
                               "slot": slot.cpu(), "c": c,
                               "dropped": float(aux["moe_dropped"])})
            return slot, gate, aux

        def apply(p, x, cfg):
            out, aux = real_apply(p, x, cfg)
            if self.keep_first and self.first is None:
                self.first = (x, out)
            return out, aux

        def step(params, cache, tokens, cfg):
            logits, cache = real_step(params, cache, tokens, cfg)
            if self.keep_logits:
                self.step_logits.append(logits.float().cpu())
            return logits, cache
        moe._dispatch, moe.moe_apply, self.T.decode_step = dispatch, apply, step
        return self

    def __exit__(self, *exc):
        self.moe._dispatch, self.moe.moe_apply, self.T.decode_step = self.real
        return False


def moe_route_checks(torch, cfg, params):
    """Phase 15's MoE gates, on one more prefill of phase 15's prompts under
    a ``RouterSpy``: every layer's ``moe_dropped`` is the host's count of
    its trash slots over N·K, and for MOE_LOOP_TOKENS sampled tokens of
    layer 0 the layer's output equals a loop through each token's top-k
    experts one at a time (gates renormalised over the top k, a dropped
    choice adds 0). The loop rounds where the layer does, so the two differ
    by the products' summation orders: per element within
    ``ref.bf16_out_tolerance`` of the loop's f32 sum."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ref
    from repro_torch.models import transformer as T
    prompt = lm_prompts(torch, cfg, LM_BATCH, LM_PROMPT, 1)
    with torch.no_grad(), RouterSpy(torch, keep_first=True) as spy:
        T.prefill(params, cfg, prompt, LM_PROMPT + LM_NEW)
    n, e, k = LM_BATCH * LM_PROMPT, cfg.moe_experts, cfg.moe_top_k
    if len(spy.calls) != cfg.n_layers:
        raise AssertionError(f"{len(spy.calls)} MoE calls in one prefill, "
                             f"want {cfg.n_layers}")
    drops = []
    for i, call in enumerate(spy.calls):
        # the share is an f32 quotient (the card divides by a reciprocal, so
        # it may differ from the host's by an ulp); the counts must be equal
        trash = int((call["slot"] == e * call["c"]).sum())
        if round(call["dropped"] * n * k) != trash:
            raise AssertionError(f"layer {i}: moe_dropped {call['dropped']} "
                                 f"of {n * k} choices, but {trash} trash slots")
        drops.append(call["dropped"])

    x, out = spy.first
    c = spy.calls[0]["c"]
    flat, out = x.reshape(n, -1), out.reshape(n, -1)
    w = {m: T.layer_view(params["layers"], 0)["moe"][m]["w"]
         for m in ("w1", "w2", "w3")}
    probs = torch.softmax(spy.calls[0]["logits"].float(), -1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    slot = spy.calls[0]["slot"].reshape(n, k)
    sample = torch.randperm(n, generator=torch.Generator().manual_seed(4))
    want, got, kept, wrong_expert = [], [], 0, 0
    with torch.no_grad():
        for t in sample[:MOE_LOOP_TOKENS].tolist():
            g = top.values[t, :k] / top.values[t, :k].sum()
            acc = torch.zeros(flat.shape[1], device="cuda")
            for j in range(k):
                sl, ex = int(slot[t, j]), int(top.indices[t, j])
                if sl == e * c:
                    continue                                  # dropped
                kept += 1
                wrong_expert += sl // c != ex
                xt = flat[t:t + 1]
                y = (F.silu(xt @ w["w1"][ex]) * (xt @ w["w3"][ex])) @ w["w2"][ex]
                acc += (y * g[j].to("cuda", y.dtype))[0].float()
            want.append(acc)
            got.append(out[t])
    want, got = torch.stack(want), torch.stack(got)
    over = float(((got.float() - want).abs()
                  / ref.bf16_out_tolerance(want)).max())
    rec = {"layers": len(drops), "capacity": c,
           "moe_dropped_mean": sum(drops) / len(drops),
           "moe_dropped_min": min(drops), "moe_dropped_max": max(drops),
           "loop_tokens": MOE_LOOP_TOKENS, "loop_kept_choices": kept,
           "loop_dropped_choices": MOE_LOOP_TOKENS * k - kept,
           "loop_wrong_expert": wrong_expert,
           "loop_max_abs_err": max_err(got, want), "loop_err_over_tol": over}
    log(f"moe_routing {json.dumps(rec)}")
    if wrong_expert or not over <= 1.0:
        raise AssertionError(f"MoE layer against the per-token loop: {rec}")
    return rec


def route_flips(a_calls, b_calls, n_layers, row_of):
    """Tokens whose top-k expert sets differ between two runs' MoE calls,
    run b the reference. ``a_calls``, ``b_calls``: per call, in call order,
    the compared tokens' router logits ``[T, E]`` and top-k ids ``[T, k]``,
    aligned token by token; ``row_of(step, tok)`` the compared row (a
    prompt row, a request) a token belongs to. Until a row's first flip the
    two runs differ by rounding only, so every flip in the call that holds
    a row's first must be a near-tie of run b; later calls of that row carry
    the flip on (the token's deeper layers, the cache its row's later tokens
    read) and are counted only. Returns the counts with the largest
    near-tie gap in bf16 ulps (the k-th expert's logit less the best logit
    the other run chose instead), each row's first flip as (step, layer),
    and the set of flipped (step, token)."""
    first, tokens = {}, set()
    near = later = 0
    max_gap = 0.0
    for i, ((la, ia), (lb, ib)) in enumerate(zip(a_calls, b_calls)):
        step, layer = divmod(i, n_layers)
        differ = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        for tok in differ.nonzero()[:, 0].tolist():
            tokens.add((step, tok))
            row = row_of(step, tok)
            if first.setdefault(row, (step, layer)) != (step, layer):
                later += 1
                continue
            near += 1
            sa, sb = set(ia[tok].tolist()), set(ib[tok].tolist())
            kth = float(lb[tok, list(sb)].float().min())
            gap = kth - float(lb[tok, list(sa - sb)].float().max())
            max_gap = max(max_gap, gap / bf16_ulp(abs(kth)))
    return ({"tokens_flipped": len(tokens), "first_call_flips": near,
             "later_flips": later, "rows_flipped": len(first),
             "max_gap_ulps": max_gap}, first, tokens)


def first_divergence(toks_a, toks_b, logits_b, flip_step):
    """Where two greedy token rows first differ, and whether that is
    allowed: at a near-tie of run b's logits (its top two within
    PARITY_GAP_ULPS bf16 ulps of its top logit, phase 9's rule), or at or
    after the row's first routing flip (``flip_step``, None if none).
    ``logits_b(j)``: run b's logits that chose token j."""
    differ = [j for j, (x, y) in enumerate(zip(toks_a, toks_b)) if x != y]
    if not differ:
        return {"first_divergence": None}, True
    j = differ[0]
    top2 = logits_b(j).topk(2).values
    gap = float(top2[0] - top2[1])
    band = PARITY_GAP_ULPS * bf16_ulp(float(top2[0]))
    after_flip = flip_step is not None and flip_step <= j
    return ({"first_divergence": j, "top2_gap": gap, "band": band,
             "after_routing_flip": after_flip},
            gap <= band or after_flip)


def first_layers(tree, n):
    if isinstance(tree, dict):
        return {k: first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def moe_parity(torch, cfg, params):
    """Phase 16a (module docstring): Moonlight's first MOE_PARITY_LAYERS
    layers, flash against plain attention, under ``route_flips`` and
    ``first_divergence``; the last logits within PARITY_REL_L2 on the rows
    whose last prompt token kept its experts in every layer."""
    import dataclasses
    cut = dataclasses.replace(cfg, n_layers=MOE_PARITY_LAYERS)
    cut_params = dict(params, layers=first_layers(params["layers"],
                                                  MOE_PARITY_LAYERS))
    prompt = lm_prompts(torch, cut, PARITY_BATCH, PARITY_PROMPT, 2)
    runs = {}
    for attn in ("flash", "plain"):
        with RouterSpy(torch) as spy:
            toks, lgs = greedy_trace(torch, cut, cut_params, prompt,
                                     PARITY_NEW, attn)
        runs[attn] = (toks, lgs, [(c["logits"], c["ids"]) for c in spy.calls])
    (tok_f, lg_f, calls_f), (tok_p, lg_p, calls_p) = runs["flash"], runs["plain"]
    s = PARITY_PROMPT

    def row_of(step, tok):
        return tok // s if step == 0 else tok
    flips, first, flipped = route_flips(calls_f, calls_p, cut.n_layers, row_of)
    gated = [r for r in range(PARITY_BATCH) if (0, r * s + s - 1) not in flipped]
    rel = rel_l2(lg_f[0][gated], lg_p[0][gated]) if gated else None
    rec = {"n_layers": cut.n_layers, "batch": PARITY_BATCH,
           "prompt_len": PARITY_PROMPT, "new_tokens": PARITY_NEW,
           "routing": flips, "logits_rows_gated": gated,
           "logits_rel_l2": rel,
           "logits_rel_l2_all_rows": rel_l2(lg_f[0], lg_p[0]), "rows": []}
    ok = (flips["max_gap_ulps"] <= ROUTER_GAP_ULPS and bool(gated)
          and rel <= PARITY_REL_L2)
    for r in range(PARITY_BATCH):
        row, fine = first_divergence(tok_f[r].tolist(), tok_p[r].tolist(),
                                     lambda j: lg_p[j][r],
                                     first.get(r, (None,))[0])
        rec["rows"].append(row)
        ok &= fine
    log(f"moe_parity {json.dumps(rec)}")
    if not ok:
        raise AssertionError(f"flash vs plain MoE path: {rec}")
    return rec


def lm_batcher(torch, cfg, params, tag):
    """Phase 16b on Moonlight and 18c on Mamba2 (module docstring). Returns
    the record and the timed run's launches."""
    from repro_torch.launch.batching import ContinuousBatcher, Request
    gen = torch.Generator().manual_seed(5)
    lens = torch.randint(BATCH_PROMPT_MIN, BATCH_PROMPT_MAX + 1,
                         (BATCH_REQUESTS,), generator=gen).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
               for n in lens]

    def run(n_slots, rids):
        b = ContinuousBatcher(params, cfg, n_slots, BATCH_MAX_SEQ,
                              device="cuda")
        for i in rids:
            b.submit(Request(rid=i, prompt=prompts[i], max_new=BATCH_NEW))
        step_ms = []
        while not b.grid.drained:
            t0 = time.perf_counter()
            b.step()               # ends in the step's read of its tokens
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if len(step_ms) > 10 * BATCH_MAX_SEQ:
                raise AssertionError("the batcher did not drain")
        return b, {r.rid: r.out for r in b.finished}, step_ms

    torch.cuda.synchronize()
    counters = reset_counters()
    t0 = time.perf_counter()
    b, outs, step_ms = run(BATCH_SLOTS, range(BATCH_REQUESTS))
    wall_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"the batcher launched {launches}, want none")
    stats = dict(b.grid.stats)
    toks = [t for out in outs.values() for t in out]
    if (sorted(outs) != list(range(BATCH_REQUESTS))
            or any(len(o) != BATCH_NEW for o in outs.values())
            or not b.grid.drained
            or not stats["admitted"] == stats["retired"] == BATCH_REQUESTS
            or min(toks) < 0 or max(toks) >= cfg.vocab):
        raise AssertionError(f"batcher: {stats}, outputs {outs}")

    # the requests admitted at step 0 into slots 0 and 1 against their lone
    # 1-slot runs, under first_divergence (and for MoE route_flips, on a
    # second, spied run of the batch)
    moe = cfg.family == "moe"
    outs_b, first = outs, {}
    if moe:
        with RouterSpy(torch) as spy_b:
            _, outs_b, _ = run(BATCH_SLOTS, range(BATCH_REQUESTS))
    lone = []
    for r in (0, 1):
        with RouterSpy(torch, keep_logits=True) as spy_l:
            _, outs_l, _ = run(1, [r])
        flips = None
        if moe:
            flips, first, _ = route_flips(
                [(c["logits"][r:r + 1], c["ids"][r:r + 1])
                 for c in spy_b.calls[:len(spy_l.calls)]],
                [(c["logits"], c["ids"]) for c in spy_l.calls],
                cfg.n_layers, lambda step, tok: r)
        p = lens[r]
        row, fine = first_divergence(
            outs_b[r], outs_l[r],
            lambda j: spy_l.step_logits[p - 1 + j][0],
            None if r not in first else first[r][0] - (p - 1))
        row.update(rid=r, prompt_len=p, routing=flips,
                   equal=outs_b[r] == outs_l[r])
        lone.append(row)
        if not (fine and (flips is None
                          or flips["max_gap_ulps"] <= ROUTER_GAP_ULPS)):
            raise AssertionError(f"{tag} request {r} against its lone run: "
                                 f"{row}")
    rec = {"slots": BATCH_SLOTS, "requests": BATCH_REQUESTS,
           "new_tokens": BATCH_NEW, "prompt_lens": lens,
           "max_seq": BATCH_MAX_SEQ, "grid": stats,
           "utilization": b.utilization, "tokens_out": b.stats["tokens_out"],
           "wall_s": wall_s, "tokens_per_s": b.stats["tokens_out"] / wall_s,
           "step_ms_p50": sorted(step_ms)[len(step_ms) // 2],
           "step_ms_max": max(step_ms), "launches": launches,
           "spied_run_equals_timed": outs_b == outs, "lone_runs": lone}
    log(f"{tag} {json.dumps(rec)}")
    return rec, launches


# ---------------------------------------------------------------------------
# phases 17-18: the ssm and hybrid families (Mamba2-2.7B, Zamba2-1.2B)
# ---------------------------------------------------------------------------

def ssd_record(torch, cfg, serving):
    """One layer's chunked SSD (``mamba2._ssd``, f32) at the prefill shape,
    on random inputs of the shapes the layer gives it: device time, its
    operations' bound at the f32 peak, and the share of the profiled
    prefill's busy time that ``n_layers`` such calls take."""
    from repro_torch.models import mamba2 as M
    g = torch.Generator(device="cuda").manual_seed(6)
    b, s, q = LM_BATCH, LM_PROMPT, cfg.ssm_chunk
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xdt = torch.randn((b, s, h, p), generator=g, device="cuda")
    da = -0.1 * torch.rand((b, s, h), generator=g, device="cuda")
    bm, cm = (torch.randn((b, s, n), generator=g, device="cuda")
              for _ in range(2))
    ms = device_ms(torch, lambda: M._ssd(xdt, da, bm, cm, q))
    # C·Bᵀ, (C·Bᵀ ⊙ L)·xdt, the chunk end states and the inter-chunk term
    flops = 2 * b * (s // q) * (q * q * n + h * q * q * p + 2 * h * q * p * n)
    bound_ms, bound_by = bound(0, flops, "float32")
    busy = serving["prefill_trace"]["device_busy_ms"]
    rec = {"layer_ms": ms, "flops": flops, "bound_ms": bound_ms,
           "bound_by": bound_by, "layers": cfg.n_layers,
           "share_of_prefill_busy": cfg.n_layers * ms / busy}
    log(f"ssd {json.dumps(rec)}")
    return rec


def ssm_prefill_parity(torch, cfg, params, n_layers, tag):
    """Phase 18a (module docstring): on the model cut to ``n_layers``, the
    chunked prefill against the reference's algorithm, the prompt replayed
    token by token through ``decode_step``."""
    import dataclasses
    from repro_torch.models import transformer as T
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    cut_params = dict(params, layers=first_layers(params["layers"], n_layers))
    prompt = lm_prompts(torch, cut, PARITY_BATCH, PARITY_PROMPT, 2)
    max_seq = PARITY_PROMPT + PARITY_NEW
    with torch.no_grad():
        counters = reset_counters()
        lg_c, cache_c = T.prefill(cut_params, cut, prompt, max_seq)
        flash = counters["flash_fwd"].launches
        cache_r = T.init_cache(cut, PARITY_BATCH, max_seq, "cuda")
        for t in range(PARITY_PROMPT):
            lg_r, cache_r = T.decode_step(cut_params, cache_r, prompt[:, t], cut)
        every = cut.hybrid_attn_every
        rel, over = {}, {}       # per cache key: largest rel L2 and rel/bound
        for k, t in cache_r.items():
            if k == "pos":
                continue
            errs = [rel_l2(cache_c[k][i], t[i]) for i in range(len(t))]
            depth = [(i + 1) * (every if k.startswith("shared") else 1)
                     for i in range(len(t))]
            rel[k] = max(errs)
            over[k] = max(e / (d * CACHE_REL_L2_PER_LAYER)
                          for e, d in zip(errs, depth))
        logits_rel = rel_l2(lg_c, lg_r)
        runs = {}
        for name, lg, cache in (("chunked", lg_c, cache_c),
                                ("replay", lg_r, cache_r)):
            out = [lg.float()]
            for _ in range(1, PARITY_NEW):
                lg, cache = T.decode_step(cut_params, cache, out[-1].argmax(-1),
                                          cut)
                out.append(lg.float())
            runs[name] = (torch.stack([x.argmax(-1) for x in out], 1), out)
    (tok_c, _), (tok_r, lg_rs) = runs["chunked"], runs["replay"]
    rec = {"n_layers": n_layers, "batch": PARITY_BATCH,
           "prompt_len": PARITY_PROMPT, "new_tokens": PARITY_NEW,
           "flash_fwd_launches": flash, "logits_rel_l2": logits_rel,
           "cache_rel_l2": rel, "cache_rel_l2_over_bound": over,
           "pos": [cache_c["pos"], cache_r["pos"]], "rows": []}
    ok = (flash == attn_calls(cut) and cache_c["pos"] == cache_r["pos"]
          and logits_rel <= PARITY_REL_L2
          and all(v <= 1.0 for v in over.values()))
    for r in range(PARITY_BATCH):
        row, fine = first_divergence(tok_c[r].tolist(), tok_r[r].tolist(),
                                     lambda j: lg_rs[j][r], None)
        rec["rows"].append(row)
        ok &= fine
    log(f"{tag} {json.dumps(rec)}")
    if not ok:
        raise AssertionError(f"chunked prefill vs replay ({tag}): {rec}")
    return rec


# ---------------------------------------------------------------------------
# phases 21-22: MoE, ssm and hybrid training
# ---------------------------------------------------------------------------

class RoutePin:
    """Pins the MoE routing of one run to another's. Without ``replay`` it
    keeps the expert choice (``moe._top_k_ids``) of every MoE call in call
    order in ``ids``; with ``replay`` (another pin's ``ids``) each call takes
    the recorded choice instead of its own, and ``flipped`` counts the
    tokens whose own top-k set differed (under remat the forward's calls
    come first, then the recompute's, in the same order on both routes)."""

    def __init__(self, torch, replay=None):
        self.torch, self.replay, self.ids, self.flipped = torch, replay, [], 0

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe._top_k_ids
        self.i = 0

        def top_k(x, k):
            ids = self.real(x, k)
            if self.replay is None:
                self.ids.append(ids)
                return ids
            want = self.replay[self.i]
            self.i += 1
            sort = self.torch.sort
            self.flipped += int((sort(ids, -1).values != sort(want, -1).values)
                                .any(-1).sum())
            return want
        moe._top_k_ids = top_k
        return self

    def __exit__(self, *exc):
        self.moe._top_k_ids = self.real
        return False


def route_grads(torch, cfg, params, batch, hp, pin=False):
    """``loss_and_grads`` through ``attn="flash"`` and ``attn="plain"`` from
    the same params and batch, under phase 11's rule: the record, and
    whether the loss lies within 1 % and every gradient leaf within
    TRAIN_GRAD_REL_L2. With ``pin`` the plain run takes the flash run's
    expert choices (``RoutePin``), so that the routes differ by rounding
    only: at a capacity that drops, one near-tie flip re-ranks its
    experts' queues and moves which later tokens are dropped."""
    from repro_torch.launch.train import make_train_step
    out, chosen, flipped = {}, None, None
    for attn in ("flash", "plain"):
        pinned = RoutePin(torch, chosen)
        with (pinned if pin else contextlib.nullcontext()):
            loss, _, grads = make_train_step(cfg, hp, attn=attn).loss_and_grads(
                params, batch)
        chosen, flipped = pinned.ids, pinned.flipped
        out[attn] = (float(loss), {"/".join(k): v for k, v in flat(grads).items()
                                   if v is not None})
        del grads
    (lf, gf), (lp, gp) = out["flash"], out["plain"]
    grad_err = {k: rel_l2(gf[k], gp[k]) for k in gp}
    rec = {"loss_flash": lf, "loss_plain": lp,
           "loss_rel_err": abs(lf - lp) / abs(lp), "grad_rel_l2": grad_err,
           "grad_rel_l2_max": max(grad_err.values()),
           "grad_rel_l2_bound": TRAIN_GRAD_REL_L2}
    if pin:
        rec["routing_pinned"] = True
        rec["plain_route_own_choices_differing"] = flipped
    ok = rec["loss_rel_err"] <= 0.01 and rec["grad_rel_l2_max"] <= TRAIN_GRAD_REL_L2
    return rec, ok


def moe_loop_grads(torch, cfg, params):
    """Phase 21a's per-token check: MOE_LOOP_TOKENS tokens through layer 0's
    MoE at a capacity that drops nothing, and the vector-Jacobian products
    of its output (against a random cotangent) with respect to the input,
    the router and w1, w2, w3, against a loop through each token's top-k
    experts in f32 on the same bf16 values (the module's expert choice,
    the gates renormalised over them). Each row of the input's gradient,
    each expert's slice of w1, w2, w3 and each router column is held to
    MOE_LOOP_GRAD_REL_L2."""
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.models import moe as MOE, transformer as T
    loop_cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.moe_experts))
    lp = T.layer_view(params["layers"], 0)["moe"]
    g = torch.Generator(device="cuda").manual_seed(7)
    n, d, k = MOE_LOOP_TOKENS, cfg.d_model, cfg.moe_top_k
    x = torch.randn((1, n, d), generator=g, device="cuda").to(getattr(torch, cfg.dtype))
    cot = torch.randn((1, n, d), generator=g, device="cuda")
    names = ("w1", "w2", "w3")
    leaves_ = {"x": x, "router": lp["router"], **{m: lp[m]["w"] for m in names}}
    mod = {m: v.detach().requires_grad_() for m, v in leaves_.items()}
    p = {"router": mod["router"], **{m: {"w": mod[m]} for m in names}}
    out, aux = MOE.moe_apply(p, mod["x"], loop_cfg)
    got = dict(zip(mod, torch.autograd.grad((out.float() * cot).sum(),
                                            list(mod.values()))))
    dropped = float(aux["moe_dropped"])
    del out
    with torch.no_grad():
        ids = MOE._top_k_ids(torch.softmax((x[0] @ lp["router"]).float(), -1), k)
    ref = {m: v.detach().float().requires_grad_() for m, v in leaves_.items()}
    probs = torch.softmax(ref["x"][0] @ ref["router"], -1)
    gate = torch.gather(probs, -1, ids)
    gate = gate / gate.sum(-1, keepdim=True)
    rows = []
    for t in range(n):
        xt = ref["x"][0, t:t + 1]
        acc = 0
        for j in range(k):
            e = int(ids[t, j])
            h = F.silu(xt @ ref["w1"][e]) * (xt @ ref["w3"][e])
            acc = acc + gate[t, j] * (h @ ref["w2"][e])
        rows.append(acc)
    want = dict(zip(ref, torch.autograd.grad(
        (torch.cat(rows)[None] * cot).sum(), list(ref.values()))))
    del ref, rows, probs, gate

    def worst(a, b, dim):
        """The largest relative L2 over slices of ``dim`` that the oracle's
        gradient reaches."""
        a, b = a.float().movedim(dim, 0), b.float().movedim(dim, 0)
        a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        nb = b.norm(dim=1)
        live = nb > 0
        return float(((a - b).norm(dim=1)[live] / nb[live]).max()), int(live.sum())
    errs = {"x": worst(got["x"][0], want["x"][0], 0),
            "router": worst(got["router"], want["router"], 1),
            **{m: worst(got[m], want[m], 0) for m in names}}
    rec = {"tokens": n, "moe_dropped": dropped,
           "capacity": MOE.capacity(n, loop_cfg),
           "worst_rel_l2": {m: e for m, (e, _) in errs.items()},
           "slices": {m: c for m, (_, c) in errs.items()},
           "bound": MOE_LOOP_GRAD_REL_L2}
    ok = dropped == 0.0 and all(e <= MOE_LOOP_GRAD_REL_L2 for e, _ in errs.values())
    return rec, ok


def moe_train_parity(torch):
    """Phase 21a (module docstring)."""
    import dataclasses
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.launch.train import (TrainHParams, init_train_state,
                                          make_train_step)
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_PARITY_LAYERS)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100))
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_PARITY_S),
                              generator=g, device="cuda")
             for k in ("tokens", "labels")}
    params, _, _ = init_train_state(
        torch.Generator(device="cuda").manual_seed(1), cfg, hp, "cuda")
    rec = {"layers": cfg.n_layers, "batch": TRAIN_B, "seq": TRAIN_PARITY_S}
    # the same loss_and_grads twice, deterministic algorithms off: the
    # dispatch and the combine backward by gathers, bit for bit
    step = make_train_step(cfg, hp)
    runs = [step.loss_and_grads(params, batch) for _ in range(2)]
    g1, g2 = (flat(r[2]) for r in runs)
    differ = [k for k, v in g1.items() if v is not None
              and not torch.equal(v, g2[k])]
    rec["repeat"] = {"loss": [float(r[0]) for r in runs],
                     "moe_dropped": float(runs[0][1][1]["moe_dropped"]),
                     "leaves": sum(v is not None for v in g1.values()),
                     "leaves_differing": ["/".join(k) for k in differ]}
    ok = not differ and rec["repeat"]["loss"][0] == rec["repeat"]["loss"][1]
    del runs, g1, g2
    torch.use_deterministic_algorithms(True)
    try:
        rec["routes"], fine = route_grads(torch, cfg, params, batch, hp,
                                          pin=True)
        # for the record: each route choosing its own experts
        rec["routes_unpinned"], _ = route_grads(torch, cfg, params, batch, hp)
    finally:
        torch.use_deterministic_algorithms(False)
    ok &= fine
    rec["loop"], fine = moe_loop_grads(torch, cfg, params)
    ok &= fine
    del params

    # masked experts with a DSST event after the step
    # d_ff 1408 is 44 blocks of 32: groups of 4 blocks
    sp = SparsityConfig(n=2, m=4, block=32, targets=("expert",), mode="masked")
    cfg_s = cfg.with_sparsity(sp)
    hp_s = dataclasses.replace(hp, dsst_every=1)
    p_s, o_s, s_s = init_train_state(torch.Generator(device="cuda").manual_seed(3),
                                     cfg_s, hp_s, "cuda")
    before = {m: p_s["layers"]["moe"][m]["umask"].clone() for m in ("w1", "w2", "w3")}
    p_s, _, _, m_s = make_train_step(cfg_s, hp_s)(p_s, o_s, s_s, batch)
    masks = {}
    for m, um in before.items():
        node = p_s["layers"]["moe"][m]
        new, w = node["umask"], node["w"]
        groups = new.reshape(new.shape[0], -1, sp.m).sum(-1)
        off = ~new.repeat_interleave(w.shape[-2] // new.shape[-2], dim=-2)
        masks[m] = {"umask_shape": list(new.shape), "w_shape": list(w.shape),
                    "n_per_group_exact": bool((groups == sp.n).all()),
                    "units_moved": int((new & ~um).sum()),
                    "max_abs_w_off_mask": float(
                        torch.where(off[:, None], w, 0).abs().max())}
    rec["masked"] = {"masks": masks,
                     "dsst_mask_change": float(m_s["dsst_mask_change"]),
                     "loss": float(m_s["loss"])}
    del p_s, o_s, s_s
    ok &= (all(v["n_per_group_exact"] and v["units_moved"] > 0
               and v["max_abs_w_off_mask"] == 0.0 for v in masks.values())
           and rec["masked"]["dsst_mask_change"] > 0
           and math.isfinite(rec["masked"]["loss"]))
    log(f"moe_train_parity {json.dumps(rec)}")
    if not ok:
        raise AssertionError(f"MoE training parity: {rec}")
    return rec


def ssd_train_record(torch, cfg, training):
    """One layer's chunked SSD (``mamba2._ssd``, f32) at the training shape
    (TRAIN_B x TRAIN_S), on random inputs of the layer's shapes: its
    forward and its forward + backward time (CUDA events over back-to-back
    calls: each call moves GBs, so a warm L2 changes nothing, and a few
    dozen launches leave no gaps worth counting), and the share of the
    profiled training step's busy time that ``n_layers`` layers take (under
    remat each layer runs its forward twice and its backward once)."""
    from repro_torch.models import mamba2 as M
    g = torch.Generator(device="cuda").manual_seed(8)
    b, s, q = TRAIN_B, TRAIN_S, cfg.ssm_chunk
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xs = [torch.randn((b, s, h, p), generator=g, device="cuda"),
          -0.1 * torch.rand((b, s, h), generator=g, device="cuda"),
          torch.randn((b, s, n), generator=g, device="cuda"),
          torch.randn((b, s, n), generator=g, device="cuda")]
    xs = [x.requires_grad_() for x in xs]
    gy = torch.randn((b, s, h, p), generator=g, device="cuda")

    def fwd():
        with torch.no_grad():
            M._ssd(*xs, q)

    def fwd_bwd():
        y, _ = M._ssd(*xs, q)
        torch.autograd.grad(y, xs, gy)
    fwd_ms, fb_ms = wall_ms(torch, fwd), wall_ms(torch, fwd_bwd)
    busy = training["profiled_step"]["device_busy_ms"]
    rec = {"layer_fwd_ms": fwd_ms, "layer_fwd_bwd_ms": fb_ms,
           "layers": cfg.n_layers,
           "share_of_step_busy": cfg.n_layers * (fwd_ms + fb_ms) / busy}
    log(f"ssd_training {json.dumps(rec)}")
    return rec


def ssm_train_parity(torch):
    """Phase 22a (module docstring): the card's ``loss_and_grads`` on
    Mamba2 cut to SSM_PARITY_LAYERS layers in f32 against the same call on
    the host from the same params and batch."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import (TrainHParams, init_train_state,
                                          make_train_step)
    from repro_torch.optim.optimizer import tree_map
    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=SSM_PARITY_LAYERS,
                              dtype="float32")
    hp = TrainHParams()
    g = torch.Generator(device="cuda").manual_seed(9)
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_PARITY_S),
                              generator=g, device="cuda")
             for k in ("tokens", "labels")}
    params, _, _ = init_train_state(
        torch.Generator(device="cuda").manual_seed(2), cfg, hp, "cuda")
    step = make_train_step(cfg, hp)
    t0 = time.perf_counter()
    loss_c, _, grads_c = step.loss_and_grads(params, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_h, _, grads_h = step.loss_and_grads(tree_map(lambda x: x.cpu(), params),
                                             {k: v.cpu() for k, v in batch.items()})
    host_s = time.perf_counter() - t0
    gc_, gh = flat(grads_c), flat(grads_h)
    err = {"/".join(k): rel_l2(v.cpu(), gh[k]) for k, v in gc_.items()
           if v is not None}
    rec = {"layers": cfg.n_layers, "dtype": cfg.dtype, "batch": TRAIN_B,
           "seq": TRAIN_PARITY_S, "loss_card": float(loss_c),
           "loss_host": float(loss_h),
           "loss_rel_err": abs(float(loss_c) - float(loss_h)) / abs(float(loss_h)),
           "grad_rel_l2": err, "grad_rel_l2_max": max(err.values()),
           "bound": SSM_GRAD_REL_L2, "card_s": card_s, "host_s": host_s,
           "host_threads": torch.get_num_threads()}
    log(f"ssm_train_parity {json.dumps(rec)}")
    if not (rec["loss_rel_err"] <= SSM_GRAD_REL_L2
            and rec["grad_rel_l2_max"] <= SSM_GRAD_REL_L2):
        raise AssertionError(f"Mamba2 training on the card against the host: {rec}")
    return rec


def hybrid_train_parity(torch):
    """Phase 22b (module docstring): Zamba2 cut to HYBRID_PARITY_LAYERS
    layers, flash against plain under phase 11's rule."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainHParams, init_train_state
    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              n_layers=HYBRID_PARITY_LAYERS)
    hp = TrainHParams()
    g = torch.Generator(device="cuda").manual_seed(10)
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_PARITY_S),
                              generator=g, device="cuda")
             for k in ("tokens", "labels")}
    params, _, _ = init_train_state(
        torch.Generator(device="cuda").manual_seed(4), cfg, hp, "cuda")
    counters = reset_counters()
    rec, ok = route_grads(torch, cfg, params, batch, hp)
    calls = attn_calls(cfg)
    rec.update(layers=cfg.n_layers, shared_calls=calls, batch=TRAIN_B,
               seq=TRAIN_PARITY_S,
               launches={n: c.launches for n, c in counters.items()})
    # the flash route's one backward: 2 forwards (remat) and one backward a call
    ok &= rec["launches"]["flash_fwd"] == 2 * calls and \
        rec["launches"]["flash_bwd_dkv"] == rec["launches"]["flash_bwd_dq"] == calls
    log(f"hybrid_train_parity {json.dumps(rec)}")
    if not ok:
        raise AssertionError(f"Zamba2 training, flash vs plain: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 24: the slot-sharded serving fleet, 4 mesh entries of the one card
# ---------------------------------------------------------------------------

SHARDS = 4


def serving_mesh(n=SHARDS):
    """A ``("slots",)`` mesh of ``n`` entries of the one card: the shards
    run one after another on its stream, through the code that runs them on
    distinct cards."""
    from repro_torch.launch.mesh import make_serving_mesh
    return make_serving_mesh(devices=["cuda:0"] * n)


def sharded_serving(torch, params, task, digest, analysis_rec):
    """Phase 24a, with 24c's sync guard and registry count (module
    docstring): phase 4's fleet on 4 shards of 256, held bit for bit
    against phase 4's digest."""
    mesh = serving_mesh()
    rec, launches, got, sched = run_fleet(torch, params, task,
                                          "sharded_serving",
                                          pipeline_depth=1, mesh=mesh)
    check_same(digest, got, "24a: the 4-shard fleet against phase 4")
    if sched.n_compiles != 1 or sched.n_slots != N_STREAMS:
        raise AssertionError(f"24a: {sched.n_compiles} chunk fns, "
                             f"{sched.n_slots} slots; want 1 and {N_STREAMS}")
    del sched, got
    rec["n_compiles"] = 1
    rec["step_breakdown"] = step_breakdown(torch, params, mesh=mesh,
                                           tag="sharded_step_breakdown")
    total = dict(launches)
    rec["sync_check"] = sync_check(
        torch, params, task, {"sharded_depth1": dict(pipeline_depth=1,
                                                     mesh=mesh)},
        total, "24c")
    names = sorted(analysis_rec["registry"])
    if len(names) != 9 or "serving.chunk_fn[sharded]" not in names:
        raise AssertionError(f"24c: the registry ran {names} on the card, "
                             "want 9 entries with serving.chunk_fn[sharded]")
    rec["registry_entries"] = names
    log(f"sharded_serving_checks {json.dumps({k: rec[k] for k in ('n_compiles', 'sync_check', 'registry_entries')})}")
    _SOURCES.clear()
    return rec, total


def npz_equal(a, b):
    """Two ``.npz`` files hold the same arrays, name for name, bit for bit
    (their zip headers carry write times, so their bytes may differ)."""
    with np.load(a) as fa, np.load(b) as fb:
        return sorted(fa.files) == sorted(fb.files) and all(
            fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
            and fa[k].tobytes() == fb[k].tobytes() for k in fa.files)


def sharded_topology(torch, params, task, fleet, workdir):
    """Phase 24b and 24c's checkpoint and remesh checks (module docstring):
    phase 12's live topology fleet on 4 shards against phase 12's run."""
    from repro_torch.launch import sharding
    from repro_torch.runtime import elastic_remesh
    from repro_torch.serving import (StreamScheduler, StreamSession,
                                     TaskStreamSource, TopologyService,
                                     TopologyServiceConfig, restore_fleet,
                                     save_fleet)
    cfg = paper_config("kernels")
    mesh = serving_mesh()
    svc = TopologyService(cfg, TopologyServiceConfig(
        epoch_every=TOPO_EVERY, merge_top=TOPO_MERGE_TOP))
    sched = StreamScheduler(params, cfg, n_slots=N_STREAMS,
                            chunk_len=CHUNK_LEN, pipeline_depth=1,
                            topology=svc, mesh=mesh)
    for sid in range(N_STREAMS):
        sched.submit(StreamSession(sid=sid, source=TaskStreamSource(
            task, N_WINDOWS, seed=sid)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    done = sched.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    per_step = sched.grid.stats["steps"] * CHUNK_LEN * cfg.n_layers * SHARDS
    want = {"nm_spmm": per_step, "nm_spmm_fused": per_step, "lif": per_step,
            "wu_outer": 0, "wu_outer_slots": per_step, **NO_ATTN,
            **NO_ADAMW}
    if launches != want:
        raise AssertionError(f"24b launched {launches}, want {want}")

    def epochs(service):
        return [(e.epoch, e.grid_step, e.pruned, e.regrown, e.mask_change,
                 e.merged_slots) for e in service.events]
    if epochs(svc) != epochs(fleet.topology) or len(svc.events) < 3:
        raise AssertionError(f"24b: epochs {epochs(svc)} against phase "
                             f"12's {epochs(fleet.topology)}")
    differ = leaves_equal(torch, fleet.params, sched.params)
    if differ or not torch.equal(fleet.deltas, sched.deltas):
        raise AssertionError(f"24b: params {differ} or deltas differ from "
                             "phase 12's")
    check_same(fleet_digest(fleet.retired), fleet_digest(done),
               "24b: the 4-shard live topology fleet against phase 12")
    if sched.n_compiles != 1:
        raise AssertionError(f"24b: {sched.n_compiles} chunk fns, want 1")
    roll = sched.telemetry.rollup()
    rec = {"streams": N_STREAMS, "shards": SHARDS,
           "grid_steps": sched.grid.stats["steps"], "epochs": len(svc.events),
           "epoch_records": epochs(svc), "n_compiles": 1,
           "launches": launches, "wall_s": wall,
           "events_per_s": roll["events_per_s"],
           "p50_step_ms": roll["p50_ms"], "p99_step_ms": roll["p99_ms"],
           "max_memory_allocated": torch.cuda.max_memory_allocated()}

    # 24c: the two fleets' checkpoints file for file; the sharded one read
    # back onto the mesh
    step = fleet.grid.stats["steps"]
    one, four = os.path.join(workdir, "one"), os.path.join(workdir, "four")
    p1 = save_fleet(one, step, fleet.params, fleet.deltas, fleet.state,
                    keep=1)
    t0 = time.perf_counter()
    p4 = save_fleet(four, step, sched.params, sched.deltas, sched.state,
                    keep=1)
    save_s = time.perf_counter() - t0
    files = sorted(os.listdir(p1))
    if files != sorted(os.listdir(p4)) or not all(
            (npz_equal(os.path.join(p1, f), os.path.join(p4, f))
             if f.endswith(".npz") else
             open(os.path.join(p1, f), "rb").read()
             == open(os.path.join(p4, f), "rb").read()) for f in files):
        raise AssertionError(f"24c: the 4-shard fleet's checkpoint {files} "
                             "differs from the 1-device fleet's")
    t0 = time.perf_counter()
    _, _, d4, s4, _ = restore_fleet(four, cfg, mesh=mesh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if not (isinstance(d4, sharding.SlotSharded)
            and torch.equal(d4.full(), sched.deltas)
            and not leaves_equal(torch, sharding.gather(s4), sched.state)):
        raise AssertionError("24c: the restored sharded fleet differs")
    del d4, s4
    rec["checkpoint"] = {"files": files, "save_s": save_s,
                         "restore_s": restore_s}

    # 24c: elastic_remesh from 4 shards to 2 and back, bit for bit
    def spec_fn(path):
        return None if path[0] == "params" else sharding.slot_spec(0)
    tree = {"params": sched.params, "deltas": sched.deltas,
            "state": sched.state}
    t0 = time.perf_counter()
    on4 = elastic_remesh(tree, mesh, spec_fn)
    on2 = elastic_remesh(on4, serving_mesh(2), spec_fn)
    back = elastic_remesh(on2, mesh, spec_fn)
    torch.cuda.synchronize()
    remesh_s = time.perf_counter() - t0
    if not (on2["deltas"].width == N_STREAMS // 2
            and back["deltas"].width == N_STREAMS // SHARDS):
        raise AssertionError("24c: remesh widths")
    differ = leaves_equal(torch, tree, sharding.gather(back))
    if differ:
        raise AssertionError(f"24c: 4 -> 2 -> 4 shards changed {differ}")
    rec["remesh"] = {"shards": [SHARDS, 2, SHARDS], "wall_s": remesh_s}
    del tree, on4, on2, back, sched, done
    log(f"sharded_topology {json.dumps(rec)}")
    return rec, launches


# ---------------------------------------------------------------------------
# phase 24d: shards of 1 and 2 slots at the paper's width
# ---------------------------------------------------------------------------

def narrow_shards(torch, params, task):
    """Phase 24d (module docstring): the chunk step on 4 shards of 1 and of
    2 slots and the fleet at 2 slots a shard, both delta layouts, against
    the 1-device ones, bit for bit."""
    from repro_torch.core.snn import (init_stream_deltas, init_stream_state,
                                      serving_params)
    from repro_torch.launch import sharding
    from repro_torch.serving import StreamScheduler, StreamSession
    from repro_torch.serving.adapt import AdaptConfig, make_chunk_fn
    cfg = paper_config("kernels")
    adapt = AdaptConfig(delta_decay=0.95, delta_clip=0.3)
    mesh = serving_mesh()
    rng = np.random.default_rng(24)
    # chunks enough for a window: the OSSL update runs from t_wu on
    n_chunks = -(-cfg.t_steps // CHUNK_LEN) + 1
    rec = {"steps": {}, "fleets": {}, "chunks": n_chunks}
    t0 = time.perf_counter()
    for compact in (True, False):
        layout = "compact" if compact else "dense"
        ex = serving_params(params, cfg, compact=compact)
        fn1 = make_chunk_fn(cfg, adapt)
        fn4 = make_chunk_fn(cfg, adapt, mesh=mesh)
        for width in (1, 2):
            S = SHARDS * width
            st1 = st4 = init_stream_state(cfg, S, device="cuda")
            dl1 = dl4 = init_stream_deltas(cfg, S, device="cuda",
                                           compact=compact)
            differ, sop_wu = [], 0.0
            for c in range(n_chunks):
                ev = torch.tensor(rng.random((CHUNK_LEN, S, cfg.n_in)) < 0.05,
                                  dtype=torch.float32, device="cuda")
                va = torch.tensor(rng.random((CHUNK_LEN, S)) < 0.9,
                                  device="cuda")
                am = torch.ones(S, dtype=torch.bool, device="cuda")
                dl1, st1, m1 = fn1(ex, dl1, st1, ev, va, am)
                dl4, st4, m4 = fn4(ex, dl4, st4, ev, va, am)
                sop_wu += float(m1.sop_wu.sum())
                if not torch.equal(dl1, dl4.full()):
                    differ.append(f"chunk {c} deltas")
                differ += [f"chunk {c} {k}" for k in leaves_equal(
                    torch, {"state": st1, "metrics": m1._asdict()},
                    {"state": sharding.gather(st4),
                     "metrics": sharding.gather(m4)._asdict()})]
            rec["steps"][f"{layout}_{width}"] = {
                "slots": S, "differ": differ, "sop_wu": sop_wu}
            if differ or not sop_wu > 0:
                raise AssertionError(f"24d: {layout} layout, {width} slot(s) "
                                     f"a shard: {differ[:8]}, sop_wu "
                                     f"{sop_wu}")
        digests = []
        for m in (None, mesh):
            sids = list(range(2 * SHARDS))
            sched = StreamScheduler(params, cfg, n_slots=len(sids),
                                    chunk_len=CHUNK_LEN, pipeline_depth=1,
                                    compact=compact, mesh=m, device="cuda")
            try:
                for sid, src in zip(sids, stream_sources(task, sids, False)):
                    sched.submit(StreamSession(sid=sid, source=src))
                done = sched.run_until_drained()
            finally:
                sched.close()
            digests.append(fleet_digest(done))
        check_same(digests[0], digests[1],
                   f"24d: the {layout} fleet at 2 slots a shard")
        rec["fleets"][layout] = {"streams": 2 * SHARDS, "shards": SHARDS}
    _SOURCES.clear()
    rec["wall_s"] = time.perf_counter() - t0
    log(f"narrow_shards {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# phase 25: data-parallel LM training across processes (slice 16)
# ---------------------------------------------------------------------------

# Qwen2-VL-2B at full width cut to 2 of its 28 layers (phase 23a's state),
# phase 10's batch (B 2 x S 4096), the gate on, the flash route
DP_LAYERS, DP_STEPS_A, DP_STEPS_B, DP_WORLD_B = 2, 4, 2, 2
# 25b against the 1-process step: the step-0 gradients (all-reduced) of
# every leaf within TRAIN_GRAD_REL_L2, the bound phase 11 holds the card's
# training gradients to; the losses within DP_LOSS_REL (the two sum one
# batch's bf16 rows in other orders); the params after DP_STEPS_B steps
# within DP_PARAM_REL_L2 of their norm (a rank that gathered a wrong block
# or skipped an update moves a leaf by O(1) of its update, a stale block by
# O(1) of the leaf)
DP_LOSS_REL, DP_PARAM_REL_L2 = 1e-3, 1e-2


def dp_setup(torch):
    """What the DP processes and the 1-process reference share: (config,
    hparams, pipeline config)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.gating import GatingConfig
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.launch.train import TrainHParams
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=DP_LAYERS)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                      gating=GatingConfig())
    return cfg, hp, PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                   global_batch=TRAIN_B)


def dp_batch(torch, pcfg, step, ranks, world):
    """The batch of ``ranks`` (concatenated in rank order) at ``step``,
    on the card."""
    from repro_torch.data.pipeline import synthetic_lm_batch
    parts = [synthetic_lm_batch(pcfg, step, r, world) for r in ranks]
    return {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
            .to("cuda", torch.long) for k in parts[0]}


def collective_totals(counts):
    """What a ``spmd.count_collectives()`` counter has counted so far,
    flat: ``{op: calls, op + "_elems": elements, op + "_bytes": bytes}``
    of the tensors handed in, for each op it counts."""
    out = {}
    for op, d in counts.per_op.items():
        out.update({op: d["count"],
                    op + "_elems": counts.inputs[op]["elems"],
                    op + "_bytes": counts.inputs[op]["bytes"]})
    return out


def collectives_since(counts, before):
    """What the counter counted since ``before`` (its
    :func:`collective_totals` then), in the same keys."""
    return {k: v - before[k] for k, v in collective_totals(counts).items()}


def event_ms(torch, fn):
    """(result, ms of ``fn`` by CUDA events)."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def dp_child():
    """One process of phase 25 (``python -c`` from the repo root): argv
    ``[mode, out_path]``; joins the group through ``fleet_init``'s
    variables. ``a``: one rank over NCCL, the DP step against
    ``make_train_step``; ``b``: one of two ranks on ``cuda:0`` over gloo,
    ZeRO-1 off and on. Writes its record as JSON (rank 0 of ``b`` also its
    tensors for the parent's comparison)."""
    import statistics
    import torch
    sys.path.insert(0, SRC)
    import torch.distributed as dist
    from repro_torch.launch import spmd
    from repro_torch.launch.launcher import fleet_init
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import init_train_state, make_train_step
    import dataclasses
    mode, out = sys.argv[1], sys.argv[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    backend = "nccl" if mode == "a" else "gloo"
    rank, world = fleet_init("cuda", backend=backend)
    with spmd.count_collectives() as counts:
        mesh = make_host_mesh(device="cuda")
        cfg, hp, pcfg = dp_setup(torch)
        rec = {"mode": mode, "rank": rank, "world": world,
               "backend": dist.get_backend(), "mesh": dict(zip(
                   mesh.mesh_dim_names, mesh.shape)),
               "device": torch.cuda.get_device_name(0)}

        def fresh(hp_, m):
            return init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                    cfg, hp_, "cuda", mesh=m)

        def run(step_fn, state, n, ranks, world_):
            losses, ms = [], []
            for i in range(n):
                batch = dp_batch(torch, pcfg, i, ranks, world_)
                torch.cuda.synchronize()
                (p, o, s, m), t = event_ms(torch, lambda: step_fn(*state, batch))
                state = (p, o, s)
                losses.append(float(m["loss"]))
                ms.append(t)
            return state, losses, ms

        opts = dict(flash_attn=True, seq_shard=True)
        if mode == "a":
            hp1 = dataclasses.replace(hp, zero1=True)
            plain, plain_losses, plain_ms = run(
                make_train_step(cfg, hp1, attn="flash"), fresh(hp1, None),
                DP_STEPS_A, [0], 1)
            with spmd.activate(mesh, **opts):
                step = make_train_step(cfg, hp1, mesh=mesh)
                state = fresh(hp1, mesh)
                torch.cuda.synchronize()
                counters = reset_counters()
                before = collective_totals(counts)
                state, losses, ms = run(step, state, DP_STEPS_A, [0], 1)
                launches = {n: c.launches for n, c in counters.items()}
            rec.update(
                steps=DP_STEPS_A, zero1=True, losses=losses,
                plain_losses=plain_losses, dp_ms=ms, plain_ms=plain_ms,
                dp_median_ms=statistics.median(ms),
                plain_median_ms=statistics.median(plain_ms),
                dp_overhead_ms=statistics.median(ms) - statistics.median(plain_ms),
                launches=launches,
                collectives=collectives_since(counts, before),
                leaves_differing=leaves_equal(torch, state, plain),
                losses_equal=losses == plain_losses,
                max_memory_allocated=torch.cuda.max_memory_allocated())
        else:
            import hashlib
            digests, runs = {}, {}
            launches = None
            for zero1 in (False, True):
                key = "on" if zero1 else "off"
                hpz = dataclasses.replace(hp, zero1=zero1)
                with spmd.activate(mesh, **opts):
                    step = make_train_step(cfg, hpz, mesh=mesh)
                    state = fresh(hpz, mesh)
                    if not zero1:
                        # every rank joins the all-reduce; rank 0 keeps it
                        g0 = step.dp.mean_grads(step.loss_and_grads(
                            state[0], dp_batch(torch, pcfg, 0, [rank], world))[2])
                        if rank == 0:
                            torch.save({"grads": {k: v.cpu() for k, v in
                                                  flat(g0).items()
                                                  if v is not None}},
                                       out + ".grads.pt")
                        del g0
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    counters = reset_counters()
                    before = collective_totals(counts)
                    t0 = time.perf_counter()
                    state, losses, ms = run(step, state, DP_STEPS_B, [rank], world)
                    wall = time.perf_counter() - t0
                    got = {n: c.launches for n, c in counters.items()}
                    launches = got if launches is None else \
                        {n: launches[n] + got[n] for n in got}
                params = flat(state[0])
                digests[key] = hashlib.sha256(b"".join(
                    v.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
                    for v in params.values())).hexdigest()
                runs[key] = {
                    "losses": losses, "step_ms": ms, "wall_s": wall,
                    "moment_elems": sum(v.numel() for v in flat(state[1].m)
                                        .values()),
                    "collectives": collectives_since(counts, before),
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
                if not zero1 and rank == 0:
                    torch.save({"params": {k: v.cpu() for k, v in params.items()}},
                               out + ".params.pt")
                del state, params
            rec.update(steps=DP_STEPS_B, runs=runs, digests=digests,
                       zero1_equal=digests["off"] == digests["on"],
                       launches=launches)
        with open(out, "w") as f:
            json.dump(rec, f)
        dist.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ranks started ahead of their phase by :func:`prestart`, by spawn mode
_WARM = {}


def prestart(mode, world):
    """Starts the ``world`` processes that ``spawn_dp(mode, world, ...)``
    will run, while the phase before uses the card: each imports torch and
    the port and opens its CUDA context (most of a short child's wall),
    then waits in :func:`warm_child` for ``spawn_dp`` to name its entry.
    Killed at exit if never used."""
    import atexit
    import tempfile
    d = tempfile.mkdtemp(prefix=f"chip_smoke_ranks_{mode}_")
    env = dict(os.environ, PYTHONPATH=SRC,
               COORDINATOR_ADDRESS=f"localhost:{free_port()}",
               PROCESS_COUNT=str(world))
    procs, logs = [], []
    for r in range(world):
        logs.append(os.path.join(d, f"rank{r}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke; "
                 "chip_smoke.warm_child()", os.path.join(d, f"go{r}.json")],
                env=dict(env, PROCESS_ID=str(r)), cwd=ROOT, stdout=f,
                stderr=subprocess.STDOUT))
    _WARM[mode] = {"world": world, "dir": d, "procs": procs, "logs": logs}

    def stop():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    atexit.register(stop)


def warm_child():
    """A process from :func:`prestart` (argv ``[go_path]``): the imports
    and the CUDA context first, then, once ``go_path`` appears, the entry
    it names with argv ``[mode, out_path]``; exits if its parent ends
    first."""
    import torch
    sys.path.insert(0, SRC)
    import repro_torch.launch.launcher  # noqa: F401
    import repro_torch.launch.train  # noqa: F401
    torch.zeros(1, device="cuda")
    go, parent = sys.argv[1], os.getppid()
    while not os.path.exists(go):
        if os.getppid() != parent:
            sys.exit(3)
        time.sleep(0.05)
    with open(go) as f:
        job = json.load(f)
    sys.argv = [sys.argv[0], job["mode"], job["out"]]
    globals()[job["entry"]]()


def spawn_dp(mode, world, workdir, timeout=600, entry="dp_child"):
    """``world`` processes of :func:`dp_child` (or another ``entry`` of
    this script that reads the same ``[mode, out_path]`` argv) joined
    through the scheduler's variables, the ones :func:`prestart` started
    for ``mode`` where it did; waits for all (killing any left at the
    timeout) and returns their records in rank order."""
    outs = [os.path.join(workdir, f"dp_{mode}_{r}.json") for r in range(world)]
    warm = _WARM.pop(mode, None)
    procs = []
    t0 = time.time()
    try:
        if warm is not None and warm["world"] == world:
            procs, logs = warm["procs"], warm["logs"]
            for r in range(world):
                go = os.path.join(warm["dir"], f"go{r}.json")
                with open(go + ".tmp", "w") as f:
                    json.dump({"entry": entry, "mode": mode, "out": outs[r]},
                              f)
                os.replace(go + ".tmp", go)
        else:
            env = dict(os.environ, PYTHONPATH=SRC,
                       COORDINATOR_ADDRESS=f"localhost:{free_port()}",
                       PROCESS_COUNT=str(world))
            code = f"import chip_smoke; chip_smoke.{entry}()"
            logs = [o + ".log" for o in outs]
            for r in range(world):
                with open(logs[r], "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", code, mode, outs[r]],
                        env=dict(env, PROCESS_ID=str(r)), cwd=ROOT, stdout=f,
                        stderr=subprocess.STDOUT))
        for p in procs:
            try:
                p.wait(timeout=max(1.0, timeout - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for r in range(len(procs)):
        with open(logs[r]) as f:
            texts.append(f.read())
    bad = [(r, p.returncode, t[-4000:]) for r, (p, t) in
           enumerate(zip(procs, texts)) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{entry} {mode}: processes failed {bad}")
    recs = []
    for path in outs:
        with open(path) as f:
            recs.append(json.load(f))
    return recs, time.time() - t0


def dp_reference(torch):
    """The 1-process step on 25b's global batch (both ranks' halves
    concatenated), from the same seed: step-0 gradients, losses and the
    params after DP_STEPS_B steps, on the host."""
    from repro_torch.launch.train import init_train_state, make_train_step
    cfg, hp, pcfg = dp_setup(torch)
    torch.use_deterministic_algorithms(True)
    try:
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                 cfg, hp, "cuda")
        step = make_train_step(cfg, hp, attn="flash")
        ranks = list(range(DP_WORLD_B))
        g0 = step.loss_and_grads(state[0], dp_batch(torch, pcfg, 0, ranks,
                                                    DP_WORLD_B))[2]
        grads = {k: v.cpu() for k, v in flat(g0).items() if v is not None}
        del g0
        losses = []
        for i in range(DP_STEPS_B):
            p, o, s, m = step(*state, dp_batch(torch, pcfg, i, ranks,
                                               DP_WORLD_B))
            state = (p, o, s)
            losses.append(float(m["loss"]))
        params = {k: v.cpu() for k, v in flat(state[0]).items()}
        init = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                cfg, hp, "cuda")[0]
        params0 = {k: v.cpu() for k, v in flat(init).items()}
        del state, init
    finally:
        torch.use_deterministic_algorithms(False)
    return grads, losses, params, params0


def dp_bytes_per_device(multi_pod, global_batch, seq_len):
    """25c's own sum: each argument leaf's local block from ``placements``
    on the production mesh (an axis-size mesh; each ``Shard(d)`` divides
    dim d by its mesh dim's size), over the full Qwen2-VL-2B's params,
    ZeRO-1 moments, gating state and batch on ``meta``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.dryrun import input_specs
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import SparseTrainState, adamw_init
    from repro_torch.configs.base import ShapeConfig
    from torch.distributed.tensor import Shard
    cfg = get_config(TRAIN_ARCH)
    shape = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    mesh = AbstractMesh(*shape)
    params = T.init_params_shaped(cfg)
    opt = adamw_init(params)
    sparse = SparseTrainState.init(cfg.n_layers, cfg.d_model, "meta")
    batch = input_specs(cfg, ShapeConfig("validate", seq_len, global_batch,
                                         "train"))
    pairs = [(params, SH.tree_shardings(params, cfg, mesh)),
             (opt, SH.opt_state_shardings(opt, params, cfg, mesh)),
             (sparse, SH.tree_map_with_path(lambda p, x: SH.replicated(mesh),
                                            sparse)),
             (batch, SH.batch_shardings(batch, mesh))]

    def local_bytes(x, sh):
        dims = list(x.shape)
        for size, pl in zip(mesh.shape, SH.placements(sh.spec, mesh)):
            if isinstance(pl, Shard):
                dims[pl.dim] //= size
        return math.prod(dims) * x.element_size()
    from repro_torch.launch.dryrun import _leaf_pairs
    return sum(local_bytes(x, sh) for tree, shardings in pairs
               for x, sh in _leaf_pairs(tree, shardings)
               if isinstance(x, torch.Tensor))


def start_validate25(workdir):
    """25c's CPU tool (``launcher --validate --multi-pod``), started ahead
    of phase 25 (it gates no time); killed at exit if still running."""
    import atexit
    tool = start_tool(["repro_torch.launch.launcher", "--arch", TRAIN_ARCH,
                       "--validate", "--multi-pod"], workdir, "validate25",
                      nice=True)

    def stop():
        if tool[0].poll() is None:
            tool[0].kill()
            tool[0].wait()
    atexit.register(stop)
    return tool


def dp_phase(torch, validate_tool=None):
    """Phase 25 (module docstring). Returns (record, launches).
    ``validate_tool``: 25c's tool where :func:`start_validate25` started it
    ahead (else it starts here, beside 25a and 25b)."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    rec = {"arch": TRAIN_ARCH, "layers": DP_LAYERS, "batch": TRAIN_B,
           "seq": TRAIN_S}
    # 25c's CPU tool runs while the card is used
    validate_tool = validate_tool or start_validate25(workdir)
    try:
        # 25a: one rank over NCCL, against make_train_step, bit for bit
        (a,), wall_a = spawn_dp("a", 1, workdir)
        L = DP_LAYERS
        flash_want = {"flash_fwd": 2 * L, "flash_bwd_dkv": L,
                      "flash_bwd_dq": L}
        want_a = {n: 0 for n in a["launches"]}
        want_a.update({k: v * DP_STEPS_A for k, v in flash_want.items()},
                      **adamw_launches(DP_STEPS_A))
        a["wall_s"] = wall_a
        rec["a"] = a
        log(f"lm_dp_nccl {json.dumps(a)}")
        if (a["leaves_differing"] or not a["losses_equal"]
                or a["backend"] != "nccl" or a["launches"] != want_a
                or any(a["collectives"].values())):
            raise AssertionError(f"25a: {a}; launches want {want_a}")

        # 25b: two ranks on cuda:0 over gloo, against the 1-process step
        t0 = time.perf_counter()
        grads, ref_losses, ref_params, params0 = dp_reference(torch)
        ref_s = time.perf_counter() - t0
        free_before(torch, "phase 25b's processes")
        b, wall_b = spawn_dp("b", DP_WORLD_B, workdir)
        r0 = os.path.join(workdir, "dp_b_0.json")
        got_g = torch.load(r0 + ".grads.pt")["grads"]
        got_p = torch.load(r0 + ".params.pt")["params"]
        grad_rel = {"/".join(k): rel_l2(got_g[k].float(), g.float())
                    for k, g in grads.items()}
        param_rel = {"/".join(k): rel_l2(got_p[k].float(), p.float())
                     for k, p in ref_params.items() if p.is_floating_point()}
        upd_rel = {"/".join(k): rel_l2(got_p[k].float() - params0[k].float(),
                                       p.float() - params0[k].float())
                   for k, p in ref_params.items()
                   if p.is_floating_point() and not torch.equal(p, params0[k])}
        losses_b = b[0]["runs"]["off"]["losses"]
        loss_rel = [abs(x - y) / abs(y) for x, y in zip(losses_b, ref_losses)]
        want_b = {n: 0 for n in b[0]["launches"]}
        want_b.update({k: 2 * v * DP_STEPS_B for k, v in flash_want.items()},
                      **adamw_launches(2 * DP_STEPS_B))
        launches = {n: a["launches"][n] + sum(r["launches"][n] for r in b)
                    for n in a["launches"]}
        rec["b"] = {
            "ranks": b, "wall_s": wall_b, "reference_s": ref_s,
            "reference_losses": ref_losses, "loss_rel": loss_rel,
            "grad_rel_l2_max": max(grad_rel.values()),
            "grad_rel_l2": grad_rel, "param_rel_l2_max": max(param_rel.values()),
            "update_rel_l2": upd_rel,
            "tolerance": {"grad_rel_l2": TRAIN_GRAD_REL_L2,
                          "loss_rel": DP_LOSS_REL,
                          "param_rel_l2": DP_PARAM_REL_L2},
            "ranks_equal": [b[0]["digests"][z] == b[1]["digests"][z]
                            for z in ("off", "on")],
            "zero1_equal": [r["zero1_equal"] for r in b],
            "peak_bytes": [r["runs"][z]["max_memory_allocated"]
                           for r in b for z in ("off", "on")],
            "step_ms": [r["runs"][z]["step_ms"] for r in b
                        for z in ("off", "on")]}
        log(f"lm_dp_gloo {json.dumps({k: v for k, v in rec['b'].items() if k not in ('grad_rel_l2', 'update_rel_l2', 'ranks')})}")
        log(f"lm_dp_gloo_ranks {json.dumps(b)}")
        if (not all(rec["b"]["ranks_equal"]) or not all(rec["b"]["zero1_equal"])
                or any(r["backend"] != "gloo" for r in b)
                or rec["b"]["grad_rel_l2_max"] > TRAIN_GRAD_REL_L2
                or max(loss_rel) > DP_LOSS_REL
                or rec["b"]["param_rel_l2_max"] > DP_PARAM_REL_L2
                or any(r["launches"] != want_b for r in b)
                or any(r["runs"]["on"]["moment_elems"]
                       >= r["runs"]["off"]["moment_elems"] for r in b)
                or any(r["runs"]["on"]["collectives"]["all_gather"] == 0
                       for r in b)):
            raise AssertionError(f"25b: {rec['b']}; launches want {want_b}")
        # phase 27a holds the tensor-parallel step to the same reference
        _DP_REF["b"] = (grads, ref_losses, ref_params, params0)
        del grads, ref_params, params0, got_g, got_p

        # 25c: the launcher's --validate on a fake 512-rank group against
        # this script's own sum of local blocks
        rc, text, wall_c = finish_tool(validate_tool, 600)
        line = [l for l in text.splitlines() if "validate OK" in l]
        want_c = dp_bytes_per_device(True, 256, 4096)
        got_c = int(line[-1].split("argument bytes/dev ")[1].split()[0]) \
            if line else None
        rec["c"] = {"rc": rc, "wall_s": wall_c, "line": line[-1] if line
                    else text[-2000:], "argument_bytes_per_device": got_c,
                    "script_sum": want_c,
                    "single_pod_sum": dp_bytes_per_device(False, 256, 4096)}
        log(f"lm_dp_validate {json.dumps(rec['c'])}")
        if rc != 0 or got_c != want_c or "2x16x16" not in rec["c"]["line"]:
            raise AssertionError(f"25c: {rec['c']}")
    finally:
        proc = validate_tool[0]
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"lm_dp_phase_s {rec['phase_s']}")
    return rec, launches


# ---------------------------------------------------------------------------
# phase 26: the MoE family data-parallel (slice 17): the shard-mapped
# dispatch, EP at full width, the compressed DP mean, elastic_remesh
# ---------------------------------------------------------------------------

# Moonlight at full width cut to 1 of its 48 layers (~1.2 B params: the
# embedding and head dominate; 2 layers until phase 27 needed the time),
# phase 10's batch (B 2 x S 4096, one row a rank), the gate on, the flash
# route, the loss in phase 21's slabs
DP_MOE_LAYERS, DP_MOE_STEPS, DP_MOE_WORLD = 1, 1, 2
# 26b: one MoE layer on a (data 1, model 2) mesh against the 1-process
# layer. The ranks' partial combines are each rounded to bf16 and their sum
# rounded again (the 1-process layer rounds one sum over k once), and the
# input and router gradients sum two bf16 partials the same way: one or
# two more roundings of 2^-9 relative on a path of about eight. 2^-6
# relative L2 leaves that 8x room; a rank that missed its partial (or
# summed the cotangent twice) moves a tensor by O(1).
EP_REL_L2 = 2 ** -6
# 26c: the compressed mean of the card against the host on these leaves
# (the whole tree's payloads are held card against host in phase 23b)
DP_COMPRESS_GATE = (("layers", "mlp", "w1", "w"), ("layers", "mlp", "w2", "w"))


def tensor_digest(torch, x):
    """Two 64-bit checksums of ``x``'s bits, computed on its device: the
    sum of its elements' bit patterns and their sum weighted by odd
    position factors (integer sums wrap, in any order): any difference in
    the bits of a few elements changes the pair."""
    flat_ = x.detach().contiguous().reshape(-1)
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[flat_.element_size()]
    v = flat_.view(bits).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) * 2 + 1
    return [int(v.sum()), int((v * w).sum()), str(x.dtype), list(x.shape)]


def tree_digests(torch, tree):
    return {"/".join(k): tensor_digest(torch, v) for k, v in flat(tree).items()
            if isinstance(v, torch.Tensor)}


def moe_dp_setup(torch):
    """(config, hparams, pipeline config) of 26a."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.gating import GatingConfig
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.launch.train import TrainHParams
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=DP_MOE_LAYERS)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                      gating=GatingConfig())
    return cfg, hp, PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                   global_batch=TRAIN_B)


def moe_dp_reference(torch, workdir):
    """26a's yardsticks, in this process with deterministic algorithms on:
    the 1-process ``grad_step`` on each rank's half alone, and the digests
    of ``((g0.float() + g1.float()) / 2).to(dtype)`` a leaf (written for
    the ranks); the halves' losses and ``moe_dropped``; and one 1-process
    step on the whole batch, its ``moe_dropped`` beside the DP one."""
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.optim.optimizer import tree_map
    cfg, hp, pcfg = moe_dp_setup(torch)
    torch.use_deterministic_algorithms(True)
    rec = {}
    try:
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                 cfg, hp, "cuda")
        step = make_train_step(cfg, hp, attn="flash", loss_chunk=MOE_LOSS_CHUNK)
        halves = []
        for r in range(DP_MOE_WORLD):
            loss, (_, aux), g = step.loss_and_grads(
                state[0], dp_batch(torch, pcfg, 0, [r], DP_MOE_WORLD))
            halves.append((float(loss), float(aux["moe_dropped"]), g))
        mean = tree_map(lambda a, b: None if a is None else
                        ((a.float() + b.float()) / 2).to(a.dtype),
                        halves[0][2], halves[1][2])
        rec["grad_digests"] = tree_digests(torch, mean)
        rec["half_losses"] = [h[0] for h in halves]
        rec["half_moe_dropped"] = [h[1] for h in halves]
        del mean, halves
        batch = dp_batch(torch, pcfg, 0, list(range(DP_MOE_WORLD)),
                         DP_MOE_WORLD)
        # 26e's yardstick: the whole batch's step-0 gradients, for the ranks
        _, (_, aux), g = step.loss_and_grads(state[0], batch)
        torch.save({"/".join(k): v.cpu() for k, v in flat(g).items()
                    if v is not None}, os.path.join(workdir, "whole_grads.pt"))
        del g, aux
        torch.cuda.synchronize()
        (_, _, _, m), ms = event_ms(torch, lambda: step(*state, batch))
        rec.update(whole_batch_loss=float(m["loss"]),
                   whole_batch_moe_dropped=float(m["moe_dropped"]),
                   whole_batch_step_ms=ms)
        del state, step, batch, m
    finally:
        torch.use_deterministic_algorithms(False)
    with open(os.path.join(workdir, "moe_ref.json"), "w") as f:
        json.dump(rec, f)
    return rec


def moe_ep_check(torch, mesh_ep, counts):
    """26b in one rank: one Moonlight MoE layer at full width (64 experts,
    top 6, d_ff 1408), x [TRAIN_B, TRAIN_S, 2048] bf16, through
    ``moe_apply`` under ``shardmap_moe`` on the (1, 2) mesh and alone;
    ``counts``: the child's ``spmd.count_collectives()`` counter."""
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.launch import spmd
    from repro_torch.models import moe as MOE
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(7)
    p = MOE.moe_init(gen, cfg, torch.bfloat16)
    x = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), generator=gen,
                    device="cuda", dtype=torch.bfloat16)
    wt = torch.randn(x.shape, generator=gen, device="cuda")
    leaves = [p["router"]] + [p[k]["w"] for k in ("w1", "w2", "w3")]
    for t in [x] + leaves:
        t.requires_grad_()

    def fwd_bwd():
        out, aux = MOE.moe_apply(p, x, cfg)
        loss = (out.float() * wt).mean() + aux["moe_aux"]
        return out.detach(), {k: v.detach() for k, v in aux.items()}, \
            torch.autograd.grad(loss, [x] + leaves)

    one = fwd_bwd()                                  # warm-up, and the yardstick
    ms_one = statistics.median(event_ms(torch, fwd_bwd)[1] for _ in range(3))
    with spmd.activate(mesh_ep, shardmap_moe=True):
        m = spmd.model_rank(mesh_ep)
        before = collective_totals(counts)
        ep = fwd_bwd()
        moved = collectives_since(counts, before)
        ms_ep = statistics.median(event_ms(torch, fwd_bwd)[1]
                                  for _ in range(3))
    el = cfg.moe_experts // spmd.model_size(mesh_ep)
    rel = {"out": rel_l2(ep[0], one[0]), "x": rel_l2(ep[2][0], one[2][0]),
           "router": rel_l2(ep[2][1], one[2][1])}
    outside = 0
    for i, k in enumerate(("w1", "w2", "w3")):
        got, want = ep[2][i + 2], one[2][i + 2]
        rel[k] = rel_l2(got.narrow(0, m * el, el), want.narrow(0, m * el, el))
        outside += int(got.ne(0).sum()) - int(got.narrow(0, m * el, el)
                                              .ne(0).sum())
    aux_equal = all(torch.equal(ep[1][k], one[1][k]) for k in one[1])
    return {"model_rank": m, "experts_local": el, "rel_l2": rel,
            "aux_equal": aux_equal, "grad_outside_block": outside,
            "moe_dropped": float(one[1]["moe_dropped"]),
            "ms_fwd_bwd": ms_ep, "ms_fwd_bwd_one_process": ms_one,
            "all_reduce_calls": moved["all_reduce"],
            "all_reduce_bytes": moved["all_reduce_bytes"],
            "bound": EP_REL_L2}


def moe_compressed_check(torch, mesh, rank, workdir, counts):
    """26c in one rank: phase 23b's gradient tree (Qwen2-VL-2B, 2 layers,
    B 2 x S 4096), each element scaled by ``1 + 0.01 n`` with ``n`` drawn
    from this rank's seed, through ``compressed_mean`` over the DP groups,
    int8 and top-k 5 %: ms a tree, bytes, digests; the gate leaves' inputs
    and (rank 0) means go to ``workdir`` for the host's check."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig, synthetic_lm_batch
    from repro_torch.launch import spmd
    from repro_torch.launch.train import (TrainHParams, init_train_state,
                                          make_train_step)
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.runtime.compression import (CompressionConfig,
                                                 compressed_mean)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RECOVERY_LAYERS)
    hp = TrainHParams()
    pcfg = PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B)
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, hp, "cuda")
    batch = {k: torch.from_numpy(v).to("cuda", torch.long)
             for k, v in synthetic_lm_batch(pcfg, 0).items()}
    grads = make_train_step(cfg, hp).loss_and_grads(state[0], batch)[2]
    del state
    gen = torch.Generator(device="cuda").manual_seed(1000 + rank)
    live = [g for g in tree_leaves(grads) if g is not None]
    for g in live:
        g.copy_(g.float() * (1 + 0.01 * torch.randn(
            g.shape, generator=gen, device="cuda")))
    n = sum(g.numel() for g in live)
    fg = flat(grads)
    torch.save({"/".join(k): fg[k].cpu() for k in DP_COMPRESS_GATE},
               os.path.join(workdir, f"compress_in_{rank}.pt"))
    groups = spmd.dp_groups(mesh)
    rec = {"elements": n, "f32_bytes": 4 * n, "grad_dtype": str(live[0].dtype)}
    for kind, frac in COMPRESS_KINDS:
        ccfg = CompressionConfig(kind=kind, topk_frac=frac)
        ms = []
        for _ in range(2):
            before = collective_totals(counts)
            (mean, _), t = event_ms(torch, lambda: compressed_mean(
                grads, ccfg, groups))
            ms.append(t)
            moved = collectives_since(counts, before)
        fm = flat(mean)
        if rank == 0:
            torch.save({"/".join(k): fm[k].cpu() for k in DP_COMPRESS_GATE},
                       os.path.join(workdir, f"compress_out_{kind}.pt"))
        rec[kind] = {"ms_per_tree": ms, "all_gather_calls": moved["all_gather"],
                     "payload_bytes": moved["all_gather_bytes"],
                     "gathered_bytes": moved["all_gather_bytes"]
                     * DP_MOE_WORLD,
                     "payload_to_f32": moved["all_gather_bytes"] / (4 * n),
                     "digests": tree_digests(torch, mean)}
        del mean, fm
    del grads, live, fg
    return rec


def moe_dp_child():
    """One process of phase 26 (``python -c`` from the repo root): argv
    ``[mode, out_path]``; one of two gloo ranks on ``cuda:0``, joined
    through ``fleet_init``'s variables. (a) and (d) on ``make_host_mesh()``
    (data 2), (b) on ``make_host_mesh(model=2)``, (c) on (a)'s mesh, one
    after another, each freeing its tensors. Writes its record as JSON."""
    import faulthandler
    import gc
    import torch
    sys.path.insert(0, SRC)
    import dataclasses
    import torch.distributed as dist
    faulthandler.enable()
    from repro_torch.launch import spmd
    from repro_torch.launch.launcher import fleet_init
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.runtime.fault_tolerance import elastic_remesh
    _, out = sys.argv[1], sys.argv[2]
    workdir = os.path.dirname(out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = fleet_init("cuda", backend="gloo")
    with spmd.count_collectives() as counts:
        mesh = make_host_mesh(device="cuda")
        cfg, hp, pcfg = moe_dp_setup(torch)
        with open(os.path.join(workdir, "moe_ref.json")) as f:
            ref = json.load(f)
        rec = {"rank": rank, "world": world, "backend": dist.get_backend(),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}

        # (a) and (d): the DP step, ZeRO-1 off then on, deterministic algorithms
        torch.use_deterministic_algorithms(True)
        batch0 = dp_batch(torch, pcfg, 0, [rank], world)
        launches, runs, moments = None, {}, None
        t_a = time.perf_counter()
        for zero1 in (False, True):
            key = "on" if zero1 else "off"
            hpz = dataclasses.replace(hp, zero1=zero1)
            run = {}
            with spmd.activate(mesh, flash_attn=True, shardmap_moe=True):
                step = make_train_step(cfg, hpz, mesh=mesh,
                                       loss_chunk=MOE_LOSS_CHUNK)
                state = init_train_state(torch.Generator(device="cuda")
                                         .manual_seed(0), cfg, hpz, "cuda",
                                         mesh=mesh)
                if not zero1:
                    loss, (_, aux), g = step.loss_and_grads(state[0], batch0)
                    run["half_loss"] = float(loss)
                    g = step.dp.mean_grads(g)
                    got = tree_digests(torch, g)
                    run["grads_differing"] = [k for k, d in ref["grad_digests"]
                                              .items() if got.get(k) != d]
                    run["grad_leaves"] = len(got)
                    del g, got
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                counters = reset_counters()
                before = collective_totals(counts)
                losses, dropped, ms = [], [], []
                for i in range(DP_MOE_STEPS):
                    batch = dp_batch(torch, pcfg, i, [rank], world)
                    (p, o, s, m), t = event_ms(torch, lambda: step(*state, batch))
                    state = (p, o, s)
                    losses.append(float(m["loss"]))
                    dropped.append(float(m["moe_dropped"]))
                    ms.append(t)
                got_l = {n: c.launches for n, c in counters.items()}
                launches = got_l if launches is None else \
                    {n: launches[n] + got_l[n] for n in got_l}
            run.update(losses=losses, moe_dropped=dropped, step_ms=ms,
                       collectives=collectives_since(counts, before),
                       max_memory_allocated=torch.cuda.max_memory_allocated(),
                       moment_elems=sum(v.numel() for v in
                                        tree_leaves(state[1].m)),
                       param_digests=tree_digests(torch, state[0]))
            if not zero1:
                moments = tree_digests(torch, {"m": state[1].m, "v": state[1].v})
            else:
                # (d): the ZeRO-1 moments placed on the mesh, remeshed a leaf at
                # a time onto one device, against the replicated run's
                layout = step.dp.zero1_layout(state[0])
                placed = step.dp.placed_opt_state(state[1], layout)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                differ = []
                for k, leaf in flat({"m": placed.m, "v": placed.v}).items():
                    whole = elastic_remesh({"x": leaf}, torch.device("cuda"),
                                           lambda path: None)["x"]
                    if tensor_digest(torch, whole) != moments["/".join(k)]:
                        differ.append("/".join(k))
                    del whole
                torch.cuda.synchronize()
                rec["d"] = {"leaves": len(moments), "differing": differ,
                            "wall_s": time.perf_counter() - t0}
                del placed
            runs[key] = run
            del state, step, p, o, s, m
            gc.collect()
            torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(False)
        rec["a"] = {"runs": runs, "launches": launches,
                    "zero1_equal": runs["off"]["param_digests"]
                    == runs["on"]["param_digests"],
                    "wall_s": time.perf_counter() - t_a}

        # (b): expert parallelism on (data 1, model 2)
        t0 = time.perf_counter()
        rec["b"] = moe_ep_check(torch, make_host_mesh(model=DP_MOE_WORLD,
                                                      device="cuda"), counts)
        rec["b"]["wall_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()

        # (c): the compressed DP mean
        t0 = time.perf_counter()
        rec["c"] = moe_compressed_check(torch, mesh, rank, workdir, counts)
        rec["c"]["wall_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()

        # (e): the global-batch dispatch (no shardmap_moe) against the
        # 1-process step on the whole batch
        t0 = time.perf_counter()
        rec["e"] = moe_global_check(torch, mesh, cfg, hp, batch0, workdir, counts)
        rec["e"]["wall_s"] = time.perf_counter() - t0
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        with open(out, "w") as f:
            json.dump(rec, f)
        dist.destroy_process_group()


def moe_global_check(torch, mesh, cfg, hp, batch, workdir, counts):
    """26e in a rank: the DP step's loss and gradients with one dispatch
    over the global batch (``spmd.activate`` without ``shardmap_moe``),
    the gradients all-reduced, against the 1-process step on the whole
    batch (``whole_grads.pt``, written by the parent): each leaf's relative
    L2, the loss and ``moe_dropped``; the collectives of the step."""
    from repro_torch.launch import spmd
    from repro_torch.launch.train import init_train_state, make_train_step
    with spmd.activate(mesh, flash_attn=True):
        step = make_train_step(cfg, hp, mesh=mesh, loss_chunk=MOE_LOSS_CHUNK)
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                 cfg, hp, "cuda", mesh=mesh)
        before = collective_totals(counts)
        loss, (_, aux), g = step.loss_and_grads(state[0], batch)
        g = step.dp.mean_grads(g)
        red = step.dp.mean_stats({"loss": loss,
                                  "moe_dropped": aux["moe_dropped"]})
        moved = collectives_since(counts, before)
    want = torch.load(os.path.join(workdir, "whole_grads.pt"))
    rel = {k: rel_l2(v.float(), want["/".join(k)].to(v.device).float())
           for k, v in flat(g).items() if v is not None}
    del g, state, step, want
    return {"loss": float(red["loss"]),
            "moe_dropped": float(red["moe_dropped"]),
            "rank_moe_dropped": float(aux["moe_dropped"]),
            "grad_rel_l2_max": max(rel.values()),
            "grad_rel_l2": {"/".join(k): v for k, v in rel.items()},
            "collectives": moved}


def host_compressed_mean(torch, ins, kind, frac):
    """The compressed mean of ``ins`` (one tensor a rank, in rank order) on
    the host, as ``compressed_mean`` computes it: each rank's f32
    reconstruction summed in rank order, divided by a tensor of the rank
    count, in the input's dtype."""
    from repro_torch.runtime.compression import (CompressionConfig, compress,
                                                 decompress)
    cfg = CompressionConfig(kind=kind, topk_frac=frac)
    total = None
    for g in ins:
        rec = decompress(compress(g.float(), cfg), cfg).float()
        total = rec if total is None else total.add_(rec)
    return total.div_(torch.full_like(total, float(len(ins)))).to(ins[0].dtype)


def moe_dp_phase(torch):
    """Phase 26 (module docstring). Returns (record, launches)."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_moe_dp_")
    try:
        t0 = time.perf_counter()
        ref = moe_dp_reference(torch, workdir)
        ref["wall_s"] = time.perf_counter() - t0
        free_before(torch, "phase 26's processes")
        ranks, wall = spawn_dp("moe", DP_MOE_WORLD, workdir,
                               entry="moe_dp_child")
        L = DP_MOE_LAYERS
        steps = 2 * DP_MOE_STEPS                  # ZeRO-1 off and on
        want = {n: 0 for n in ranks[0]["a"]["launches"]}
        want.update({"flash_fwd": 2 * L * steps, "flash_bwd_dkv": L * steps,
                     "flash_bwd_dq": L * steps, **adamw_launches(steps)})
        launches = {n: sum(r["a"]["launches"][n] for r in ranks)
                    for n in want}
        a_runs = [r["a"]["runs"] for r in ranks]
        dp_loss = a_runs[0]["off"]["losses"][0]
        dp_dropped = a_runs[0]["off"]["moe_dropped"][0]
        half_loss = sum(ref["half_losses"]) / DP_MOE_WORLD
        half_dropped = sum(ref["half_moe_dropped"]) / DP_MOE_WORLD
        a = {"arch": MOE_ARCH, "layers": L, "batch": TRAIN_B, "seq": TRAIN_S,
             "steps": DP_MOE_STEPS, "reference": ref, "wall_s": wall,
             "grads_differing": [r["a"]["runs"]["off"]["grads_differing"]
                                 for r in ranks],
             "grad_leaves": a_runs[0]["off"]["grad_leaves"],
             "dp_loss": dp_loss, "halves_mean_loss": half_loss,
             "dp_moe_dropped": dp_dropped,
             "halves_mean_moe_dropped": half_dropped,
             "whole_batch_moe_dropped": ref["whole_batch_moe_dropped"],
             "ranks_equal": [a_runs[0][z]["param_digests"]
                             == a_runs[1][z]["param_digests"]
                             for z in ("off", "on")],
             "zero1_equal": [r["a"]["zero1_equal"] for r in ranks],
             "losses": [[x[z]["losses"] for z in ("off", "on")]
                        for x in a_runs],
             "step_ms": [[x[z]["step_ms"] for z in ("off", "on")]
                         for x in a_runs],
             "peak_bytes": [[x[z]["max_memory_allocated"]
                             for z in ("off", "on")] for x in a_runs],
             "moment_elems": [[x[z]["moment_elems"] for z in ("off", "on")]
                              for x in a_runs],
             "collectives": [[x[z]["collectives"] for z in ("off", "on")]
                             for x in a_runs],
             "launches": launches}
        log(f"moe_dp {json.dumps(a)}")
        if (any(a["grads_differing"]) or not all(a["ranks_equal"])
                or not all(a["zero1_equal"])
                or abs(dp_loss - half_loss) > 1e-5 * abs(half_loss)
                or abs(dp_dropped - half_dropped) > 1e-6
                or any(r["backend"] != "gloo" for r in ranks)
                or any(r["a"]["launches"] != want for r in ranks)
                or any(x["on"]["moment_elems"] >= x["off"]["moment_elems"]
                       for x in a_runs)):
            raise AssertionError(f"26a: {a}; launches want {want} a rank")

        b = [r["b"] for r in ranks]
        log(f"moe_ep {json.dumps(b)}")
        if (sorted(x["model_rank"] for x in b) != [0, 1]
                or any(max(x["rel_l2"].values()) > EP_REL_L2 for x in b)
                or not all(x["aux_equal"] for x in b)
                or any(x["grad_outside_block"] for x in b)
                or any(x["all_reduce_calls"] != 3 for x in b)):
            raise AssertionError(f"26b: {b}")

        c = {"ranks": [r["c"] for r in ranks], "host": {}}
        ins = [torch.load(os.path.join(workdir, f"compress_in_{i}.pt"))
               for i in range(DP_MOE_WORLD)]
        for kind, frac in COMPRESS_KINDS:
            got = torch.load(os.path.join(workdir, f"compress_out_{kind}.pt"))
            t0 = time.perf_counter()
            equal = {k: torch.equal(host_compressed_mean(
                torch, [x[k] for x in ins], kind, frac), got[k]) for k in got}
            c["host"][kind] = {"equal": equal,
                               "host_s": time.perf_counter() - t0}
        c["ranks_equal"] = {kind: ranks[0]["c"][kind]["digests"]
                            == ranks[1]["c"][kind]["digests"]
                            for kind, _ in COMPRESS_KINDS}
        log(f"moe_dp_compressed {json.dumps({k: v for k, v in c.items() if k != 'ranks'})} "
            f"{json.dumps([{kind: {k: v for k, v in r['c'][kind].items() if k != 'digests'} for kind, _ in COMPRESS_KINDS} for r in ranks])}")
        if (not all(c["ranks_equal"].values())
                or any(len(h["equal"]) != len(DP_COMPRESS_GATE)
                       or not all(h["equal"].values())
                       for h in c["host"].values())):
            raise AssertionError(f"26c: {c}")

        d = [r["d"] for r in ranks]
        log(f"moe_dp_remesh {json.dumps(d)}")
        if any(x["differing"] or x["leaves"] == 0 for x in d):
            raise AssertionError(f"26d: {d}")

        e = {"ranks": [{k: v for k, v in r["e"].items() if k != "grad_rel_l2"}
                       for r in ranks],
             "whole_batch_loss": ref["whole_batch_loss"],
             "whole_batch_moe_dropped": ref["whole_batch_moe_dropped"],
             "tolerance": {"grad_rel_l2": TRAIN_GRAD_REL_L2,
                           "loss_rel": DP_LOSS_REL}}
        log(f"moe_dp_global {json.dumps(e)}")
        if any(x["grad_rel_l2_max"] > TRAIN_GRAD_REL_L2
               or abs(x["loss"] - ref["whole_batch_loss"])
               > DP_LOSS_REL * abs(ref["whole_batch_loss"])
               or abs(x["moe_dropped"] - ref["whole_batch_moe_dropped"])
               > DP_LOSS_REL
               or x["rank_moe_dropped"] != x["moe_dropped"]
               for x in e["ranks"]):
            raise AssertionError(f"26e: {e}")
        rec = {"a": a, "b": b, "c": c, "d": d, "e": e, "ranks": ranks}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"moe_dp_phase_s {rec['phase_s']}")
    return rec, launches


# ---------------------------------------------------------------------------
# phase 27: tensor parallelism on (data 1, model 2) for the attention
# families (slice 18)
# ---------------------------------------------------------------------------

# 27a: phase 25's Qwen2-VL-2B (2 layers, B 2 x S 4096, the gate on, flash,
# sequence-parallel) on (data 1, model 2), each rank on the whole batch,
# against 25b's 1-process step (the same batch, seed and steps): its
# gradients, losses and params bounds (TRAIN_GRAD_REL_L2, DP_LOSS_REL,
# DP_PARAM_REL_L2). 27b: Phi-3-medium-14B at full width cut to TP_LAYERS
# of its 40 layers, LM_BATCH x LM_PROMPT, prefill and TP_NEW greedy decode
# steps. The ranks sum each row-parallel product (wo, w2) from two bf16
# partials that each rank rounded, and the sum is rounded again: one more
# rounding of 2^-9 relative on each of the 2 x TP_LAYERS sublayer outputs
# that feed the residual stream, about 2^-9 x 2 x 2 relative on the final
# stream, which the head carries into the logits; 2^-5 relative L2 leaves
# 4x room. A lost head block, a misplaced cache slot or a wrong vocab
# offset moves the logits by O(1). A greedy token may differ from the
# 1-process token only where that run's top two logits lie within
# TP_GAP_ULPS bf16 ulps of its top logit (4x phase 9's PARITY_GAP_ULPS:
# the extra roundings above, a few ulps of a logit).
TP_WORLD, TP_LAYERS, TP_NEW = 2, 2, 16
TP_LOGIT_REL_L2, TP_GAP_ULPS = 2 ** -5, 8
_DP_REF = {}


def tp_serve_setup(torch):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TP_LAYERS)
    return cfg, lm_prompts(torch, cfg, LM_BATCH, LM_PROMPT, 27)


def tp_serve_reference(torch):
    """27b's yardstick in this process: the 1-process prefill and greedy
    decode (``greedy_trace``) of 2-layer Phi-3 from phase 8's seed: the
    tokens and every step's logits on the host."""
    from repro_torch.models import transformer as T
    cfg, prompt = tp_serve_setup(torch)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           device="cuda")
    toks, logits = greedy_trace(torch, cfg, params, prompt, TP_NEW, "flash")
    del params
    return toks.cpu(), [lg.cpu() for lg in logits]


def tp_child():
    """One of two gloo ranks of phase 27 on ``cuda:0`` (``python -c`` from
    the repo root): argv ``[mode, out_path]``; (a) the tensor-parallel
    step, (b) tensor-parallel serving on ``make_host_mesh(model=2)``.
    Writes its record as JSON and its local blocks (step-0 gradients,
    params after the steps, the last prefill logits) beside it."""
    import faulthandler
    import gc
    import statistics
    import torch
    sys.path.insert(0, SRC)
    import torch.distributed as dist
    faulthandler.enable()
    from repro_torch.launch import spmd
    from repro_torch.launch.launcher import fleet_init
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import (init_train_state, make_train_step,
                                          place_params)
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import tree_leaves
    _, out = sys.argv[1], sys.argv[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = fleet_init("cuda", backend="gloo")
    with spmd.count_collectives() as counts:
        mesh = make_host_mesh(model=TP_WORLD, device="cuda")
        rec = {"rank": rank, "world": world, "backend": dist.get_backend(),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "model_rank": mesh.get_local_rank("model")}

        def blocks(tree):
            return {"/".join(k): (v.to_local().cpu(), spmd.model_dim(v))
                    for k, v in flat(tree).items() if v is not None}

        # (a) the step, DP_STEPS_B steps, ZeRO-1 off
        cfg, hp, pcfg = dp_setup(torch)
        batches = [dp_batch(torch, pcfg, i, list(range(DP_WORLD_B)), DP_WORLD_B)
                   for i in range(DP_STEPS_B)]
        t_a = time.perf_counter()
        with spmd.activate(mesh, flash_attn=True, seq_shard=True):
            step = make_train_step(cfg, hp, mesh=mesh)
            state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                     cfg, hp, "cuda", mesh=mesh)
            rec["state_bytes"] = sum(
                v.to_local().numel() * v.to_local().element_size()
                for v in tree_leaves(state[0]) + tree_leaves(state[1].m)
                + tree_leaves(state[1].v) if hasattr(v, "to_local"))
            g0 = step.dp.mean_grads(step.loss_and_grads(state[0], batches[0])[2])
            rec["grad_placements_equal"] = all(
                tuple(g.placements) == tuple(p.placements) for g, p in
                zip(tree_leaves(g0), tree_leaves(state[0])) if g is not None)
            rec["moment_shapes_equal"] = all(
                m.to_local().shape == p.to_local().shape for m, p in
                zip(tree_leaves(state[1].m), tree_leaves(state[0]))
                if p.is_floating_point())
            torch.save(blocks(g0), out + ".grads.pt")
            del g0
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counters = reset_counters()
            before = collective_totals(counts)
            losses, ms = [], []
            for b in batches:
                (p, o, s, m), t = event_ms(torch, lambda: step(*state, b))
                state = (p, o, s)
                losses.append(float(m["loss"]))
                ms.append(t)
            rec["a"] = {"losses": losses, "step_ms": ms,
                        "launches": {n: c.launches for n, c in counters.items()},
                        "collectives": {
                            k: v // DP_STEPS_B for k, v in
                            collectives_since(counts, before).items()},
                        "max_memory_allocated": torch.cuda.max_memory_allocated(),
                        "wall_s": time.perf_counter() - t_a}
        rec["replicated_digests"] = {
            "/".join(k): tensor_digest(torch, v.to_local())
            for k, v in flat(state[0]).items() if spmd.model_dim(v) is None}
        torch.save(blocks(state[0]), out + ".params.pt")
        del state, step, p, o, s, m, batches
        gc.collect()
        torch.cuda.empty_cache()

        # (b) serving: prefill and TP_NEW greedy decode steps
        t_b = time.perf_counter()
        cfg_s, prompt = tp_serve_setup(torch)
        params = place_params(T.init_params(torch.Generator(device="cuda")
                                            .manual_seed(0), cfg_s,
                                            device="cuda"), cfg_s, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()      # (b)'s own peak, not (a)'s
        with torch.no_grad():
            counters = reset_counters()
            before = collective_totals(counts)
            (logits, cache), t_pre = event_ms(torch, lambda: T.prefill(
                params, cfg_s, prompt, LM_PROMPT + TP_NEW, attn="flash"))
            pre_moved = collectives_since(counts, before)
            launches = {n: c.launches for n, c in counters.items()}
            tp = spmd.tensor_parallel(logits)
            torch.save({"logits": logits.to_local().float().cpu()},
                       out + ".prefill.pt")
            toks, dec_ms = [], []
            before = collective_totals(counts)
            for _ in range(TP_NEW):
                tok = spmd.vocab_argmax(logits.to_local(), tp)
                toks.append(tok)
                (logits, cache), t = event_ms(torch, lambda: T.decode_step(
                    params, cache, tok, cfg_s))
                dec_ms.append(t)
            dec_moved = {k: v / TP_NEW for k, v in
                         collectives_since(counts, before).items()}
        rec["b"] = {"prefill_ms": t_pre, "decode_ms": dec_ms,
                    "decode_ms_p50": statistics.median(dec_ms),
                    "tokens": torch.stack(toks, 1).tolist(),
                    "launches": launches, "prefill_collectives": pre_moved,
                    "decode_collectives_per_step": dec_moved,
                    "decode_bytes_per_token": (dec_moved["all_reduce_bytes"]
                                               + dec_moved["all_gather_bytes"])
                    / LM_BATCH,
                    "cache_model_dim": spmd.model_dim(cache["k"]),
                    "cache_local_shape": list(cache["k"].to_local().shape),
                    "wall_s": time.perf_counter() - t_b}
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        with open(out, "w") as f:
            json.dump(rec, f)
        dist.destroy_process_group()


def whole_blocks(ranks):
    """``{leaf: whole tensor}`` from the ranks' ``(block, model dim)``
    pairs, in model-rank order."""
    out = {}
    for k, (t, d) in ranks[0].items():
        out[k] = t if d is None else \
            torch_cat([r[k][0] for r in ranks], d)
    return out


def torch_cat(parts, dim):
    import torch
    return torch.cat(parts, dim=dim)


def tp_phase(torch):
    """Phase 27 (module docstring). Returns (record, training launches,
    serving launches)."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        grads, ref_losses, ref_params, _ = _DP_REF.pop("b", None) or \
            dp_reference(torch)
        ref_toks, ref_logits = tp_serve_reference(torch)
        free_before(torch, "phase 27's processes")
        ranks, wall = spawn_dp("tp", TP_WORLD, workdir, entry="tp_child")
        paths = [os.path.join(workdir, f"dp_tp_{r}.json") for r in
                 range(TP_WORLD)]
        order = sorted(range(TP_WORLD), key=lambda r: ranks[r]["model_rank"])
        loaded = {kind: [torch.load(paths[r] + kind) for r in order]
                  for kind in (".grads.pt", ".params.pt")}
        got_g, got_p = (whole_blocks(loaded[k]) for k in (".grads.pt",
                                                           ".params.pt"))
        # on the card, which the ranks have left free
        grad_rel = {"/".join(k): rel_l2(got_g["/".join(k)].cuda(), g.cuda())
                    for k, g in grads.items()}
        param_rel = {"/".join(k): rel_l2(got_p["/".join(k)].cuda(), p.cuda())
                     for k, p in ref_params.items() if p.is_floating_point()}
        L = DP_LAYERS
        want_a = {n: 0 for n in ranks[0]["a"]["launches"]}
        want_a.update({"flash_fwd": 2 * L * DP_STEPS_B,
                       "flash_bwd_dkv": L * DP_STEPS_B,
                       "flash_bwd_dq": L * DP_STEPS_B,
                       **adamw_launches(DP_STEPS_B)})
        losses = ranks[0]["a"]["losses"]
        loss_rel = [abs(x - y) / abs(y) for x, y in zip(losses, ref_losses)]
        a = {"arch": TRAIN_ARCH, "layers": L, "batch": TRAIN_B, "seq": TRAIN_S,
             "steps": DP_STEPS_B, "mesh": ranks[0]["mesh"],
             "losses": losses, "reference_losses": ref_losses,
             "loss_rel": loss_rel, "grad_rel_l2_max": max(grad_rel.values()),
             "param_rel_l2_max": max(param_rel.values()),
             "grad_rel_l2": grad_rel,
             "ranks_equal": ranks[0]["replicated_digests"]
             == ranks[1]["replicated_digests"],
             "replicated_leaves": len(ranks[0]["replicated_digests"]),
             "grad_placements_equal": [r["grad_placements_equal"]
                                       for r in ranks],
             "moment_shapes_equal": [r["moment_shapes_equal"] for r in ranks],
             "step_ms": [r["a"]["step_ms"] for r in ranks],
             "peak_bytes": [r["a"]["max_memory_allocated"] for r in ranks],
             "state_bytes_per_rank": [r["state_bytes"] for r in ranks],
             "collectives_per_step": [r["a"]["collectives"] for r in ranks],
             "launches": [r["a"]["launches"] for r in ranks],
             "tolerance": {"grad_rel_l2": TRAIN_GRAD_REL_L2,
                           "loss_rel": DP_LOSS_REL,
                           "param_rel_l2": DP_PARAM_REL_L2}}
        log(f"lm_tp_training {json.dumps({k: v for k, v in a.items() if k != 'grad_rel_l2'})}")
        if (a["grad_rel_l2_max"] > TRAIN_GRAD_REL_L2
                or max(loss_rel) > DP_LOSS_REL
                or a["param_rel_l2_max"] > DP_PARAM_REL_L2
                or not a["ranks_equal"] or not a["replicated_leaves"]
                or not all(a["grad_placements_equal"])
                or not all(a["moment_shapes_equal"])
                or any(r["backend"] != "gloo" for r in ranks)
                or any(r["a"]["launches"] != want_a for r in ranks)):
            raise AssertionError(f"27a: {a}; launches want {want_a} a rank")
        del grads, ref_params, got_g, got_p, loaded

        pre = [torch.load(paths[r] + ".prefill.pt")["logits"] for r in order]
        got = torch.cat(pre, dim=-1)
        want = ref_logits[0].float()
        b_rel = rel_l2(got, want)
        toks = [r["b"]["tokens"] for r in ranks]
        rows = []
        ok = b_rel <= TP_LOGIT_REL_L2 and toks[0] == toks[1]
        for i in range(LM_BATCH):
            mine = toks[0][i]
            theirs = ref_toks[i, :TP_NEW].tolist()
            row, fine = first_divergence(mine, theirs,
                                         lambda j: ref_logits[j][i], None)
            band = TP_GAP_ULPS / PARITY_GAP_ULPS
            if row["first_divergence"] is not None:
                row["band"] *= band
                fine = row["top2_gap"] <= row["band"]
            rows.append(row)
            ok &= fine
        want_b = {n: 0 for n in ranks[0]["b"]["launches"]}
        want_b["flash_fwd"] = TP_LAYERS
        b = {"arch": LM_ARCH, "layers": TP_LAYERS, "batch": LM_BATCH,
             "prompt": LM_PROMPT, "new_tokens": TP_NEW,
             "prefill_logits_rel_l2": b_rel, "bound": TP_LOGIT_REL_L2,
             "rows": rows, "ranks_tokens_equal": toks[0] == toks[1],
             "prefill_ms": [r["b"]["prefill_ms"] for r in ranks],
             "decode_ms_p50": [r["b"]["decode_ms_p50"] for r in ranks],
             "decode_bytes_per_token": [r["b"]["decode_bytes_per_token"]
                                        for r in ranks],
             "decode_collectives_per_step": [
                 r["b"]["decode_collectives_per_step"] for r in ranks],
             "prefill_collectives": [r["b"]["prefill_collectives"]
                                     for r in ranks],
             "cache": [r["b"]["cache_model_dim"] for r in ranks],
             "cache_local_shape": ranks[0]["b"]["cache_local_shape"],
             "peak_bytes": [r["max_memory_allocated"] for r in ranks],
             "launches": [r["b"]["launches"] for r in ranks]}
        log(f"lm_tp_serving {json.dumps(b)}")
        if (not ok or any(r["b"]["launches"] != want_b for r in ranks)):
            raise AssertionError(f"27b: {b}; launches want {want_b} a rank")
        launches_a = {n: sum(r["a"]["launches"][n] for r in ranks)
                      for n in want_a}
        launches_b = {n: sum(r["b"]["launches"][n] for r in ranks)
                      for n in want_b}
        rec = {"a": a, "b": b, "wall_s": wall}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"lm_tp_phase_s {rec['phase_s']}")
    return rec, launches_a, launches_b


# ---------------------------------------------------------------------------
# phase 28: tensor parallelism for the moe, ssm and hybrid families on
# (data 1, model 2), and checkpoints of a tensor-parallel state (slice 19)
# ---------------------------------------------------------------------------

# part: (arch, layers, train steps, seq_shard, loss chunk). Full width,
# depth cut to fit the phase's time: Moonlight one of 48 layers (EP: 32 of
# 64 experts and 8 of 16 heads a rank), Mamba2 two of 64 (40 of 80 heads'
# P halves a rank), Zamba2 six of 38, so that the shared block runs once
# (16 of 32 heads a rank). Phase 10's batch (B 2 x S 4096), the gate on,
# the flash route; each rank on the whole batch. The bounds are phase
# 27's: the ranks sum each row-parallel product from two bf16 partials.
TP_FAMILY_PARTS = {"moe": (MOE_ARCH, 1, 1, False, MOE_LOSS_CHUNK),
                   "ssm": (SSM_ARCH, 2, 3, True, None),
                   "hybrid": (HYBRID_ARCH, 6, 1, True, None)}
TP_FAMILY_NEW = 8       # greedy decode steps after each 4 x 2048 prefill
# moe_dropped: the same on both ranks, and within TP_DROPPED_ABS of the
# 1-process value. Not equal: the ranks' stream differs from the
# 1-process stream by the partial sums' rounding, and the router then
# orders two experts otherwise where they nearly tie (``router_flips``,
# a ``--gate-faults`` run on the H100: 178 of 49,152 choices move,
# each at a top-k gap at most 1.76x its probabilities' largest difference
# between the runs; over all tokens the medians are 2.2e-3 and 3.9e-4), and
# the moves that cross the capacity net 6 choices, 1.22e-4. A capacity one
# rounding step (8) short reads 2.32e-3 in the same run. The limit sits
# between the two, a factor of ~4.5 from each.
TP_DROPPED_ABS = 2 ** -11
# A leaf drawn at zero (the mixer's conv_b) holds only the steps' updates,
# so its DP_PARAM_REL_L2 reads its update's difference, which no initial
# value dilutes (runs on the H100). AdamW's first update is
# lr x sign(g): on Zamba2 (1 step) 22 of 25,344 conv_b elements take the
# other sign, each with |g| below the two runs' gradient difference, and
# carry 98.6 % of the 4.95 %. On Mamba2 (3 steps) 25 of 10,752 flip alike
# and carry 17.6 % of the 3.55 %; the rest is the later steps' m / sqrt(v),
# which differs by a median 3.38 % over every leaf's update
# (``--gate-faults``: ``update_rel_l2``). Every other leaf keeps
# DP_PARAM_REL_L2; a leaf drawn at zero is held to TP_ZERO_INIT_REL_L2 of
# its norm, between those readings and the same run's planted faults:
# Mamba2's step 1 skipped 61.0 %, conv_b's gradient not summed over the
# ranks 71.6 %.
TP_ZERO_INIT_REL_L2 = 2 ** -3
TP_CKPT_STEP = 1        # 28d: the ssm run saved after this step, resumed


# ``--gate-faults``: phase 28's ssm and moe training clean and with a fault
# planted in memory (:func:`planted_fault`), read by phase 28's gates, so
# each limit above can be set between a correct run's reading and a faulty
# one's on the same call
GATE_FAULTS = (("ssm", None), ("ssm", "skip_step"), ("ssm", "conv_b_unsummed"),
               ("moe", None), ("moe", "capacity_minus_8"))


class RouterProbs:
    """Keeps the router's probabilities ``[N, E]`` (f32, on the host) of
    the first MoE dispatch inside the block, by wrapping
    ``models.moe._top_k_ids``; its results pass through unchanged."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.probs = moe, moe._top_k_ids, None

        def top_k(probs, k):
            if self.probs is None:
                self.probs = probs.detach().float().cpu()
            return self.real(probs, k)
        moe._top_k_ids = top_k
        return self

    def __exit__(self, *exc):
        self.moe._top_k_ids = self.real
        return False


@contextlib.contextmanager
def planted_fault(fault):
    """A deliberate fault in this process's port, undone on exit (for
    ``--gate-faults`` only): ``conv_b_unsummed`` keeps only this rank's
    partial gradient of the mixer's ``conv_b`` (its gather's backward a
    slice instead of the reduce-scatter), ``capacity_minus_8`` dispatches
    the MoE with a capacity one rounding step short; ``skip_step`` and
    ``None`` patch nothing (:func:`tp_family_train` drops the step)."""
    from repro_torch.launch import spmd
    from repro_torch.models import moe
    real = (spmd.TensorParallel.enter_cols, moe.capacity)

    def enter_cols(self, x):
        if x.dim() == 1 and self.size > 1:          # conv_b: 1-D a layer
            return spmd._GatherSliceGrad.apply(x, 0, self)
        return real[0](self, x)
    if fault == "conv_b_unsummed":
        spmd.TensorParallel.enter_cols = enter_cols
    elif fault == "capacity_minus_8":
        moe.capacity = lambda n, cfg: real[1](n, cfg) - 8
    try:
        yield
    finally:
        spmd.TensorParallel.enter_cols, moe.capacity = real


def zero_init_flips(torch, g_ref, g_tp, p_ref, p_tp):
    """Why a leaf drawn at zero moves more than the others: the elements
    whose step-0 update (AdamW's first step is lr·sign(g)) has the other
    sign in the TP run, their |g| against the two runs' gradient difference
    (the ranks' partial sums rounding otherwise), and the share of the
    params' squared difference that the elements whose sign differs after
    the steps carry."""
    g_ref, g_tp, p_ref, p_tp = (t.float().flatten()
                                for t in (g_ref, g_tp, p_ref, p_tp))
    diff = (g_tp - g_ref).abs()
    flip = torch.sign(g_tp) != torch.sign(g_ref)
    ratio = g_ref.abs()[flip] / diff[flip].clamp_min(1e-30)
    pflip = torch.sign(p_tp) != torch.sign(p_ref)
    err = (p_tp - p_ref).square()
    return {"n": g_ref.numel(), "step0_sign_flips": int(flip.sum()),
            "flips_with_abs_g_below_diff": int((ratio <= 1).sum()),
            "max_abs_g_over_diff_at_flips": float(ratio.max())
            if ratio.numel() else 0.0,
            "median_abs_g": float(g_ref.abs().median()),
            "median_abs_diff": float(diff.median()),
            "param_sign_flips": int(pflip.sum()),
            "param_sq_err_share_of_flips": float(err[pflip].sum()
                                                 / err.sum().clamp_min(1e-30))}


def router_flips(torch, p_ref, p_tp, k):
    """Why ``moe_dropped`` differs: the tokens whose top-``k`` experts
    differ between the 1-process and the TP router (f32 probabilities of
    the same step-0 tokens), the choices that moved, and each moved
    token's gap between its ``k``-th and ``k+1``-th probability in the
    1-process run against the largest difference of its probabilities
    between the two runs."""
    from repro_torch.core.dsst import _top_k_ids
    ids_ref = _top_k_ids(p_ref, k).sort(-1).values
    ids_tp = _top_k_ids(p_tp, k).sort(-1).values
    moved = (ids_ref != ids_tp).any(-1)
    srt = p_ref.sort(-1, descending=True).values
    gap = srt[:, k - 1] - srt[:, k]
    noise = (p_tp - p_ref).abs().amax(-1)
    ratio = gap[moved] / noise[moved].clamp_min(1e-30)
    return {"tokens": p_ref.shape[0], "choices": p_ref.shape[0] * k,
            "tokens_moved": int(moved.sum()),
            "choices_moved": int(sum(len(set(a.tolist()) - set(b.tolist()))
                                     for a, b in zip(ids_tp[moved],
                                                     ids_ref[moved]))),
            "max_gap_over_diff_at_moved": float(ratio.max())
            if ratio.numel() else 0.0,
            "median_gap": float(gap.median()),
            "median_max_diff": float(noise.median())}


def tp_family_cfg(part):
    """One part's config and the attention layers its forward runs (the
    flash kernels' launches a pass)."""
    import dataclasses
    from repro_torch.configs import get_config
    arch, layers, _, _, _ = TP_FAMILY_PARTS[part]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    n_attn = {"moe": layers, "ssm": 0,
              "hybrid": layers // (cfg.hybrid_attn_every or layers + 1)}
    return cfg, n_attn[cfg.family]


def tp_family_setup(torch, part):
    """(config, hparams, the steps' batches on the card) of one part."""
    from repro_torch.core.gating import GatingConfig
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.launch.train import TrainHParams
    from repro_torch.optim import AdamWConfig
    steps = TP_FAMILY_PARTS[part][2]
    cfg, _ = tp_family_cfg(part)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                      gating=GatingConfig())
    pcfg = PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                          global_batch=TRAIN_B)
    return cfg, hp, [dp_batch(torch, pcfg, i, [0], 1) for i in range(steps)]


def tp_family_reference(torch, part, keep_init=False):
    """One part's yardsticks in this process, from the seed the ranks draw,
    deterministic algorithms on: the 1-process step-0 gradients and
    ``moe_dropped``, the router's probabilities, the losses and the params
    after the steps (on the host), and the greedy trace of the same seed's
    params (tokens, each step's logits). ``keep_init``: the initial params
    too, where a leaf is drawn at zero (``--gate-faults``)."""
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import transformer as T
    cfg, hp, batches = tp_family_setup(torch, part)
    torch.use_deterministic_algorithms(True)
    try:
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                 cfg, hp, "cuda")
        zero_init = ["/".join(k) for k, v in flat(state[0]).items()
                     if v.is_floating_point() and not v.any()]
        init = {"/".join(k): v.cpu() for k, v in flat(state[0]).items()
                if v.is_floating_point()} if zero_init and keep_init else None
        step = make_train_step(cfg, hp, attn="flash",
                               loss_chunk=TP_FAMILY_PARTS[part][4])
        with RouterProbs() as router:
            _, (_, aux), g0 = step.loss_and_grads(state[0], batches[0])
        grads = {"/".join(k): v.cpu() for k, v in flat(g0).items()
                 if v is not None}
        dropped = float(aux["moe_dropped"])
        del g0, aux
        losses = []
        for b in batches:
            p, o, s, m = step(*state, b)
            state = (p, o, s)
            losses.append(float(m["loss"]))
        params = {"/".join(k): v.cpu() for k, v in flat(state[0]).items()}
        del state, step, p, o, s, m
        prompt = lm_prompts(torch, cfg, LM_BATCH, LM_PROMPT, 28)
        sp = T.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           device="cuda")
        toks, logits = greedy_trace(torch, cfg, sp, prompt, TP_FAMILY_NEW,
                                    "flash")
        del sp
    finally:
        torch.use_deterministic_algorithms(False)
    return {"grads": grads, "losses": losses, "params": params,
            "zero_init": zero_init, "init": init, "moe_dropped": dropped,
            "router_probs": router.probs,
            "tokens": toks.cpu(),
            "logits": [lg.cpu() for lg in logits]}


def local_digests(torch, tree):
    """``{leaf key: digest of this rank's block}`` of a train state (the
    checkpoint's leaf keys; host ints as they are)."""
    from repro_torch.checkpoint.checkpoint import _flatten
    return {k: tensor_digest(torch, v.to_local() if hasattr(v, "to_local")
                             else v) if isinstance(v, torch.Tensor) else v
            for k, v in _flatten(tree)}


def tp_family_train(torch, part, mesh, counts, out, shardmap=False,
                    fault=None):
    """One part's tensor-parallel training in a rank (phase 28 in the
    module docstring): the step-0 gradients (blocks saved beside ``out``
    unless ``shardmap``; digests) and the router's probabilities, then the
    steps; for ``ssm``, 28d. ``fault`` (``--gate-faults`` only): the run
    under :func:`planted_fault`, with no 28d; ``skip_step`` drops step 1's
    update."""
    import gc
    from repro_torch.launch import spmd
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.optim.optimizer import tree_leaves
    cfg, hp, batches = tp_family_setup(torch, part)
    _, _, steps, seq, chunk = TP_FAMILY_PARTS[part]
    tag = part + ("_shardmap" if shardmap else "") + (
        f"_{fault}" if fault else "")
    t0 = time.perf_counter()
    r = {}
    with spmd.activate(mesh, flash_attn=True, seq_shard=seq,
                       shardmap_moe=shardmap, loss_chunk=chunk or 0):
        step = make_train_step(cfg, hp, mesh=mesh)
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                 cfg, hp, "cuda", mesh=mesh)
        with RouterProbs() as router:
            _, (_, aux), g0 = step.loss_and_grads(state[0], batches[0])
        g0 = step.dp.mean_grads(g0)
        if router.probs is not None and not shardmap:
            torch.save(router.probs, f"{out}.{tag}.router.pt")
        r["moe_dropped"] = float(aux["moe_dropped"])
        r["grad_placements_equal"] = all(
            tuple(g.placements) == tuple(p.placements) for g, p in
            zip(tree_leaves(g0), tree_leaves(state[0])) if g is not None)
        r["grad_digests"] = {"/".join(k): tensor_digest(torch, v.to_local())
                             for k, v in flat(g0).items() if v is not None}
        if not shardmap:
            torch.save({"/".join(k): (v.to_local().cpu(), spmd.model_dim(v))
                        for k, v in flat(g0).items() if v is not None},
                       f"{out}.{tag}.grads.pt")
        del g0, aux
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counters()
        moved = dict.fromkeys(collective_totals(counts), 0)
        losses, ms = [], []
        for i, b in enumerate(batches):
            if fault == "skip_step" and i == 1:
                continue            # the step updates its state in place
            before = collective_totals(counts)
            (p, o, s, m), t = event_ms(torch, lambda: step(*state, b))
            state = (p, o, s)
            losses.append(float(m["loss"]))
            ms.append(t)
            for k, v in collectives_since(counts, before).items():
                moved[k] += v
            if (part == "ssm" and not shardmap and not fault
                    and i == TP_CKPT_STEP):
                r["d"] = tp_checkpoint(torch, cfg, hp, state, mesh,
                                       os.path.dirname(out))
                r["d"]["resume_from"] = (r["d"]["resume_from"],
                                         batches[i + 1])
        r.update(losses=losses, step_ms=ms,
                 launches={n: c.launches for n, c in counters.items()},
                 collectives_per_step={k: v / steps for k, v in moved.items()},
                 max_memory_allocated=torch.cuda.max_memory_allocated(),
                 param_digests=local_digests(torch, state[0]),
                 replicated_digests={
                     "/".join(k): tensor_digest(torch, v.to_local())
                     for k, v in flat(state[0]).items()
                     if spmd.model_dim(v) is None})
        if "d" in r:
            # 28d: the step after the checkpoint, from the restored state
            restored, b = r["d"].pop("resume_from")
            p, o, s, m = step(*restored, b)
            r["d"]["resumed_equal"] = local_digests(torch, p) \
                == r["param_digests"]
            r["d"]["resumed_loss"] = float(m["loss"])
            del restored, p, o, s, m
        if not shardmap:
            torch.save({"/".join(k): (v.to_local().cpu(), spmd.model_dim(v))
                        for k, v in flat(state[0]).items()},
                       f"{out}.{tag}.params.pt")
    r["wall_s"] = time.perf_counter() - t0
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return r


def tp_checkpoint(torch, cfg, hp, state, mesh, workdir):
    """28d in a rank: the TP state saved (every rank gathers, rank 0
    writes), restored into the 1-process template (rank 0) against the
    gathered leaves' digests, and into the placed template against this
    rank's blocks. Returns the record and, under ``resume_from``, the
    state restored onto the ranks."""
    import torch.distributed as dist
    from repro_torch import checkpoint as ckpt
    from repro_torch import placed
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.launch.train import init_train_state
    d = os.path.join(workdir, "tp_ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(d, TP_CKPT_STEP, state)
    save_s = time.perf_counter() - t0
    whole = {k: tensor_digest(torch, placed.full_tensor(v) if hasattr(
        v, "to_local") else v) for k, v in _flatten(state)
        if isinstance(v, torch.Tensor)}
    rec = {"save_s": save_s, "bytes": dir_bytes(d), "leaves": len(whole)}
    if dist.get_rank() == 0:
        tpl = init_train_state(torch.Generator(device="cuda").manual_seed(1),
                               cfg, hp, "cuda")
        t0 = time.perf_counter()
        _, one, _ = ckpt.restore(d, tpl)
        rec["restore_one_s"] = time.perf_counter() - t0
        got = {k: tensor_digest(torch, v) for k, v in _flatten(one)
               if isinstance(v, torch.Tensor)}
        rec["one_process_equal"] = got == whole
        del tpl, one
    tpl = init_train_state(torch.Generator(device="cuda").manual_seed(1), cfg,
                           hp, "cuda", mesh=mesh)
    t0 = time.perf_counter()
    _, back, _ = ckpt.restore(d, tpl)
    rec["restore_tp_s"] = time.perf_counter() - t0
    rec["tp_equal"] = local_digests(torch, back) == local_digests(torch, state)
    rec["resume_from"] = back
    dist.barrier()      # the next step's ms is its own, not rank 0's wait
    return rec


def tp_family_serve(torch, part, mesh, counts, out):
    """One part's tensor-parallel serving in a rank: the prefill of
    LM_BATCH x LM_PROMPT prompts and TP_FAMILY_NEW greedy decode steps over
    caches placed by ``cache_shardings``; the last prefill logits (blocks)
    saved beside ``out``."""
    import gc
    import statistics
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import spmd
    from repro_torch.launch.train import place_params
    from repro_torch.models import transformer as T
    cfg, _, _ = tp_family_setup(torch, part)
    t0 = time.perf_counter()
    params = place_params(T.init_params(torch.Generator(device="cuda")
                                        .manual_seed(0), cfg, device="cuda"),
                          cfg, mesh)
    prompt = lm_prompts(torch, cfg, LM_BATCH, LM_PROMPT, 28)
    with torch.no_grad():
        counters = reset_counters()
        before = collective_totals(counts)
        (logits, cache), t_pre = event_ms(torch, lambda: T.prefill(
            params, cfg, prompt, LM_PROMPT + TP_FAMILY_NEW, attn="flash"))
        pre_moved = collectives_since(counts, before)
        launches = {n: c.launches for n, c in counters.items()}
        tp = spmd.tensor_parallel(logits)
        torch.save({"logits": logits.to_local().float().cpu()},
                   f"{out}.{part}.prefill.pt")
        toks, dec_ms = [], []
        before = collective_totals(counts)
        for _ in range(TP_FAMILY_NEW):
            tok = spmd.vocab_argmax(logits.to_local(), tp)
            toks.append(tok)
            (logits, cache), t = event_ms(torch, lambda: T.decode_step(
                params, cache, tok, cfg))
            dec_ms.append(t)
        dec_moved = {k: v / TP_FAMILY_NEW for k, v in
                     collectives_since(counts, before).items()}
    leaves = {k: v for k, v in cache.items() if k != "pos"}
    meta = {k: torch.empty(v.shape, device="meta") for k, v in leaves.items()}
    want = SH.cache_shardings(meta, cfg, mesh)
    rec = {"prefill_ms": t_pre, "decode_ms": dec_ms,
           "decode_ms_p50": statistics.median(dec_ms),
           "tokens": torch.stack(toks, 1).tolist(), "launches": launches,
           "prefill_collectives": pre_moved,
           "decode_collectives_per_step": dec_moved,
           "decode_bytes_per_token": (dec_moved["all_reduce_bytes"]
                                      + dec_moved["all_gather_bytes"]
                                      + dec_moved["all_to_all_single_bytes"])
           / LM_BATCH,
           "cache_placed": all(tuple(v.placements) == SH.placements(
               want[k].spec, mesh) for k, v in leaves.items()),
           "cache_model_dims": {k: spmd.model_dim(v)
                                for k, v in leaves.items()},
           "wall_s": time.perf_counter() - t0}
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def tp_ssd_ms(torch, cfg):
    """The SSD (``mamba2._ssd``, f32) at one rank's share of the training
    shape, this rank's ``P`` block of every head, beside the whole ``P``:
    device ms (CUDA events, the mean of 3 after one warm-up)."""
    from repro_torch.models.mamba2 import _ssd
    b, s, h, pd, n = TRAIN_B, TRAIN_S, cfg.ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for name, p in (("p_block", pd // TP_WORLD), ("whole", pd)):
        xdt = torch.randn((b, s, h, p), generator=g, device="cuda")
        da = -torch.rand((b, s, h), generator=g, device="cuda") * 0.1
        bm, cm = (torch.randn((b, s, n), generator=g, device="cuda")
                  for _ in range(2))
        with torch.no_grad():
            _ssd(xdt, da, bm, cm, cfg.ssm_chunk)
            ms = [event_ms(torch, lambda: _ssd(xdt, da, bm, cm,
                                               cfg.ssm_chunk))[1]
                  for _ in range(3)]
        out[name] = {"shape": [b, s, h, p, n], "ms": sum(ms) / 3}
        del xdt, da, bm, cm
    return out


def tp_family_child():
    """One of two gloo ranks of phase 28 on ``cuda:0`` (``python -c`` from
    the repo root): argv ``[mode, out_path]``; every part on
    ``make_host_mesh(model=2)``, one after another, deterministic
    algorithms on. Writes its record as JSON and its blocks beside it."""
    import faulthandler
    import torch
    sys.path.insert(0, SRC)
    import torch.distributed as dist
    faulthandler.enable()
    from repro_torch.launch import spmd
    from repro_torch.launch.launcher import fleet_init
    from repro_torch.launch.mesh import make_host_mesh
    mode, out = sys.argv[1], sys.argv[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = fleet_init("cuda", backend="gloo")
    with spmd.count_collectives() as counts:
        mesh = make_host_mesh(model=TP_WORLD, device="cuda")
        rec = {"rank": rank, "world": world, "backend": dist.get_backend(),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "model_rank": mesh.get_local_rank("model")}
        torch.use_deterministic_algorithms(True)
        for part, fault in GATE_FAULTS if mode == "faults" else ():
            with planted_fault(fault):
                rec[f"{part}_{fault}"] = tp_family_train(torch, part, mesh, counts,
                                                         out, fault=fault)
        for part in TP_FAMILY_PARTS if mode != "faults" else ():
            rec[part] = tp_family_train(torch, part, mesh, counts, out)
            if part == "moe":
                rec["moe_shardmap"] = tp_family_train(torch, part, mesh, counts,
                                                      out, shardmap=True)
            if part == "ssm":
                rec[part]["ssd"] = tp_ssd_ms(torch, tp_family_cfg(part)[0])
            rec[part]["serve"] = tp_family_serve(torch, part, mesh, counts, out)
        torch.use_deterministic_algorithms(False)
        with open(out, "w") as f:
            json.dump(rec, f)
        dist.destroy_process_group()


def tp_train_reading(torch, part, ref, paths, order, rs, tag):
    """Phase 28's training gates on one part's run (``rs``: the ranks'
    records; the blocks saved under ``tag``) against its 1-process
    reference. Returns (reading, whether a gate failed, the launches
    wanted a rank)."""
    import statistics
    arch, layers, steps, seq, _ = TP_FAMILY_PARTS[part]
    got_g, got_p = (whole_blocks([torch.load(f"{paths[r]}.{tag}.{k}")
                                  for r in order])
                    for k in ("grads.pt", "params.pt"))
    # on the card, which the ranks have left free
    grad_rel = {k: rel_l2(got_g[k].cuda(), g.cuda())
                for k, g in ref["grads"].items()}
    param_rel = {k: rel_l2(got_p[k].cuda(), p.cuda())
                 for k, p in ref["params"].items() if p.is_floating_point()}
    flips = {k: zero_init_flips(torch, ref["grads"][k], got_g[k],
                                ref["params"][k], got_p[k])
             for k in ref["zero_init"] if k in ref["grads"]}
    # every leaf's update (the steps' change) against the 1-process one's:
    # a leaf drawn at zero holds nothing else
    upd = {k: rel_l2(got_p[k].float() - x.float(),
                     ref["params"][k].float() - x.float())
           for k, x in (ref["init"] or {}).items()
           if not torch.equal(ref["params"][k], x)}
    del got_g, got_p
    losses = rs[0]["losses"]
    loss_rel = [abs(x - y) / abs(y) for x, y in zip(losses, ref["losses"])]
    n_attn = tp_family_cfg(part)[1]
    want = {n: 0 for n in rs[0]["launches"]}
    want.update({"flash_fwd": 2 * n_attn * steps,
                 "flash_bwd_dkv": n_attn * steps,
                 "flash_bwd_dq": n_attn * steps, **adamw_launches(steps)})
    a = {"arch": arch, "layers": layers, "batch": TRAIN_B,
         "seq": TRAIN_S, "steps": steps, "seq_shard": seq,
         "losses": losses, "reference_losses": ref["losses"],
         "loss_rel": loss_rel,
         "grad_rel_l2_max": max(grad_rel.values()),
         "param_rel_l2_max": max(v for k, v in param_rel.items()
                                 if k not in ref["zero_init"]),
         "zero_init_rel_l2": {k: param_rel[k] for k in ref["zero_init"]},
         "zero_init_flips": flips,

         "worst": {n: sorted(t.items(), key=lambda kv: -kv[1])[:4]
                   for n, t in (("grads", grad_rel), ("params", param_rel))},
         "moe_dropped": [x["moe_dropped"] for x in rs],
         "reference_moe_dropped": ref["moe_dropped"],
         "ranks_equal": rs[0]["replicated_digests"]
         == rs[1]["replicated_digests"],
         "replicated_leaves": len(rs[0]["replicated_digests"]),
         "grad_placements_equal": [x["grad_placements_equal"] for x in rs],
         "step_ms": [x["step_ms"] for x in rs],
         "peak_bytes": [x["max_memory_allocated"] for x in rs],
         "collectives_per_step": [x["collectives_per_step"] for x in rs],
         "launches": [x["launches"] for x in rs],
         "wall_s": [x["wall_s"] for x in rs],
         "reference_wall_s": ref["wall_s"]}
    if upd:
        a["update_rel_l2"] = {"max": max(upd.values()),
                              "median": statistics.median(upd.values()),
                              "worst": sorted(upd.items(),
                                              key=lambda kv: -kv[1])[:4]}
    if ref["router_probs"] is not None:
        from repro_torch.configs import get_config
        a["router_flips"] = router_flips(
            torch, ref["router_probs"],
            torch.load(f"{paths[order[0]]}.{tag}.router.pt"),
            get_config(arch).moe_top_k)
    bad = (a["grad_rel_l2_max"] > TRAIN_GRAD_REL_L2
           or max(loss_rel) > DP_LOSS_REL
           or a["param_rel_l2_max"] > DP_PARAM_REL_L2
           or any(v > TP_ZERO_INIT_REL_L2
                  for v in a["zero_init_rel_l2"].values())
           or not a["ranks_equal"] or not a["replicated_leaves"]
           or not all(a["grad_placements_equal"])
           or len(set(a["moe_dropped"])) != 1
           or abs(a["moe_dropped"][0] - ref["moe_dropped"]) > TP_DROPPED_ABS
           or any(x["launches"] != want for x in rs))
    return a, bad, want


def gate_faults(torch):
    """``--gate-faults``: the 1-process references of phase 28's ssm and
    moe parts, then two gloo ranks running each of GATE_FAULTS; logs
    phase 28's training reading of each (gates read, none raised) and
    writes them to ``chiprun_out/gate_faults.json``."""
    import shutil
    import tempfile
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(fa_kernel.build), pool.submit(fa_kernel.build_bwd)]:
            f.result()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_gate_faults_")
    out = {}
    try:
        refs = {part: tp_family_reference(torch, part, keep_init=True)
                for part in dict(GATE_FAULTS)}
        for ref in refs.values():
            ref["wall_s"] = None
        ranks, wall = spawn_dp("faults", TP_WORLD, workdir,
                               entry="tp_family_child")
        paths = [os.path.join(workdir, f"dp_faults_{r}.json")
                 for r in range(TP_WORLD)]
        order = sorted(range(TP_WORLD), key=lambda r: ranks[r]["model_rank"])
        for part, fault in GATE_FAULTS:
            tag = part + (f"_{fault}" if fault else "")
            a, bad, _ = tp_train_reading(
                torch, part, refs[part], paths, order,
                [r[f"{part}_{fault}"] for r in ranks], tag)
            keep = ("loss_rel", "grad_rel_l2_max", "param_rel_l2_max",
                    "zero_init_rel_l2", "zero_init_flips", "update_rel_l2",
                    "moe_dropped",
                    "reference_moe_dropped", "router_flips")
            out[tag] = dict({k: a[k] for k in keep if k in a},
                            gates_failed=bool(bad))
            log(f"gate_fault {tag} {json.dumps(out[tag])}")
        out["ranks_wall_s"] = wall
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gate_faults.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def tp_family_phase(torch):
    """Phase 28 (module docstring). Returns (record, launches by path:
    ``lm_tp_moe``, ``lm_tp_ssm``, ``lm_tp_hybrid``)."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tp_family_")
    try:
        refs = {}
        for part in TP_FAMILY_PARTS:
            t0 = time.perf_counter()
            refs[part] = tp_family_reference(torch, part)
            refs[part]["wall_s"] = time.perf_counter() - t0
            free_before(torch, f"phase 28's {part} reference")
        ranks, wall = spawn_dp("fam", TP_WORLD, workdir,
                               entry="tp_family_child")
        paths = [os.path.join(workdir, f"dp_fam_{r}.json")
                 for r in range(TP_WORLD)]
        order = sorted(range(TP_WORLD), key=lambda r: ranks[r]["model_rank"])
        rec, launches = {"wall_s": wall}, {}
        for part, (arch, layers, steps, seq, _) in TP_FAMILY_PARTS.items():
            ref = refs[part]
            rs = [r[part] for r in ranks]
            a, bad, want = tp_train_reading(torch, part, ref, paths, order,
                                            rs, part)
            n_attn = tp_family_cfg(part)[1]
            if part == "moe":
                sm = [r["moe_shardmap"] for r in ranks]
                a["shardmap_equal"] = [
                    x["grad_digests"] == y["grad_digests"]
                    and x["param_digests"] == y["param_digests"]
                    and x["losses"] == y["losses"]
                    and x["moe_dropped"] == y["moe_dropped"]
                    for x, y in zip(rs, sm)]
                a["shardmap_step_ms"] = [x["step_ms"] for x in sm]
                bad = bad or not all(a["shardmap_equal"]) or any(
                    x["launches"] != want for x in sm)
            log(f"lm_tp_{part}_training {json.dumps(a)}")
            if part == "ssm":
                d = [x["d"] for x in rs]
                log(f"lm_tp_checkpoint {json.dumps(d)}")
            if bad or any(r["backend"] != "gloo" for r in ranks):
                raise AssertionError(f"28 {part} training: {a}; launches "
                                     f"want {want} a rank")
            if part == "ssm":
                if (not d[0].get("one_process_equal")      # rank 0's check
                        or not all(x["tp_equal"] and x["resumed_equal"]
                                   for x in d)):
                    raise AssertionError(f"28d: {d}")
                rec["checkpoint"] = d

            sv = [x["serve"] for x in rs]
            pre = torch.cat([torch.load(f"{paths[r]}.{part}.prefill.pt")
                             ["logits"] for r in order], dim=-1)
            b_rel = rel_l2(pre, ref["logits"][0].float())
            rows, ok = [], b_rel <= TP_LOGIT_REL_L2 and \
                sv[0]["tokens"] == sv[1]["tokens"]
            for i in range(LM_BATCH):
                row, fine = first_divergence(
                    sv[0]["tokens"][i], ref["tokens"][i, :TP_FAMILY_NEW]
                    .tolist(), lambda j: ref["logits"][j][i], None)
                if row["first_divergence"] is not None:
                    row["band"] *= TP_GAP_ULPS / PARITY_GAP_ULPS
                    fine = row["top2_gap"] <= row["band"]
                rows.append(row)
                ok &= fine
            want_b = {n: 0 for n in sv[0]["launches"]}
            want_b["flash_fwd"] = n_attn
            b = {"arch": arch, "layers": layers, "batch": LM_BATCH,
                 "prompt": LM_PROMPT, "new_tokens": TP_FAMILY_NEW,
                 "prefill_logits_rel_l2": b_rel, "bound": TP_LOGIT_REL_L2,
                 "rows": rows, "cache_placed": [x["cache_placed"] for x in sv],
                 "cache_model_dims": sv[0]["cache_model_dims"],
                 **{k: [x[k] for x in sv] for k in (
                     "prefill_ms", "decode_ms_p50", "decode_bytes_per_token",
                     "decode_collectives_per_step", "prefill_collectives",
                     "launches", "wall_s")}}
            log(f"lm_tp_{part}_serving {json.dumps(b)}")
            if (not ok or not all(b["cache_placed"])
                    or any(x["launches"] != want_b for x in sv)):
                raise AssertionError(f"28 {part} serving: {b}; launches "
                                     f"want {want_b} a rank")
            rec[part] = {"a": a, "b": b}
            launches[f"lm_tp_{part}"] = {
                n: sum(x["launches"][n] + x["serve"]["launches"][n]
                       + (r["moe_shardmap"]["launches"][n]
                          if part == "moe" else 0)
                       for x, r in zip(rs, ranks)) for n in want}
        rec["ssd"] = [r["ssm"]["ssd"] for r in ranks]
        log(f"lm_tp_ssd {json.dumps(rec['ssd'])}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"lm_tp_family_phase_s {rec['phase_s']} ranks_s {rec['wall_s']} "
        f"references_s {[refs[p]['wall_s'] for p in refs]}")
    return rec, launches


# ---------------------------------------------------------------------------
# phase 29: the head cut on the card, and the port's demos
# ---------------------------------------------------------------------------

# 29a: Qwen2-VL-2B at full width cut to CUT_LAYERS of its 28 layers on
# (data 1, model CUT_WORLD): 8 is the smallest model axis that cuts its
# heads (12 % 8 != 0; its 1536 query columns split 192 a rank, 1.5 heads;
# its 256 K/V columns 32 a rank, inside a head). One training step (B
# CUT_B x S CUT_S: the traffic cut, not the width) against the 1-process
# step, then a prefill of CUT_B x CUT_S and CUT_NEW greedy tokens against
# the 1-process greedy trace, under phase 27's bounds unchanged.
CUT_WORLD, CUT_LAYERS, CUT_B, CUT_S, CUT_NEW = 8, 2, 1, 2048, 4


def cut_setup(torch):
    """What 29a's ranks and its reference share: (config, hparams, the
    training batch, the prompt)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.gating import GatingConfig
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.launch.train import TrainHParams
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=CUT_LAYERS)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                      gating=GatingConfig())
    pcfg = PipelineConfig(vocab=cfg.vocab, seq_len=CUT_S, global_batch=CUT_B)
    return (cfg, hp, dp_batch(torch, pcfg, 0, [0], 1),
            lm_prompts(torch, cfg, CUT_B, CUT_S, 29))


def cut_reference(torch):
    """29a's yardsticks in this process, deterministic algorithms on: the
    1-process step-0 gradients, the loss and the params after one step
    (host), and the greedy trace of the same seed's params."""
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import transformer as T
    cfg, hp, batch, prompt = cut_setup(torch)
    torch.use_deterministic_algorithms(True)
    try:
        state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                 cfg, hp, "cuda")
        step = make_train_step(cfg, hp, attn="flash")
        g0 = step.loss_and_grads(state[0], batch)[2]
        grads = {"/".join(k): v.cpu() for k, v in flat(g0).items()
                 if v is not None}
        del g0
        p, o, s, m = step(*state, batch)
        loss = float(m["loss"])
        params = {"/".join(k): v.cpu() for k, v in flat(p).items()}
        del state, step, p, o, s, m
        sp = T.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           device="cuda")
        toks, logits = greedy_trace(torch, cfg, sp, prompt, CUT_NEW, "flash")
        del sp
    finally:
        torch.use_deterministic_algorithms(False)
    return grads, loss, params, toks.cpu(), [lg.cpu() for lg in logits]


def cut_child():
    """One of CUT_WORLD gloo ranks of phase 29a on ``cuda:0`` (``python -c``
    from the repo root): argv ``[mode, out_path]``. One training step and
    the prefill and greedy decode of 2-layer Qwen2-VL-2B with its heads cut
    over the model axis; writes its record as JSON and its local blocks
    (step-0 gradients, params after the step, the prefill's logits)."""
    import faulthandler
    import torch
    sys.path.insert(0, SRC)
    import torch.distributed as dist
    faulthandler.enable()
    from repro_torch.launch import spmd
    from repro_torch.launch.launcher import fleet_init
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import (init_train_state, make_train_step,
                                          place_params)
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import tree_leaves
    out = sys.argv[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = fleet_init("cuda", backend="gloo")
    with spmd.count_collectives() as counts:
        mesh = make_host_mesh(model=CUT_WORLD, device="cuda")
        cfg, hp, batch, prompt = cut_setup(torch)
        tp = spmd.TensorParallel(mesh, mesh.get_group("model"),
                                 mesh.get_local_rank("model"), CUT_WORLD)
        rec = {"rank": rank, "world": world, "backend": dist.get_backend(),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "model_rank": tp.rank, "q_span": list(L.q_span(cfg, tp))}

        def blocks(tree):
            return {"/".join(k): (v.to_local().cpu(), spmd.model_dim(v))
                    for k, v in flat(tree).items() if v is not None}

        t_a = time.perf_counter()
        with spmd.activate(mesh, flash_attn=True, seq_shard=True):
            step = make_train_step(cfg, hp, mesh=mesh)
            state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                     cfg, hp, "cuda", mesh=mesh)
            rec["wq_model_dim"] = spmd.model_dim(state[0]["layers"]["attn"]["wq"]
                                                 ["w"])
            g0 = step.loss_and_grads(state[0], batch)[2]
            rec["grad_placements_equal"] = all(
                tuple(g.placements) == tuple(p.placements) for g, p in
                zip(tree_leaves(g0), tree_leaves(state[0])) if g is not None)
            torch.save(blocks(g0), out + ".grads.pt")
            del g0
            counters = reset_counters()
            before = collective_totals(counts)
            (p, o, s, m), t = event_ms(torch, lambda: step(*state, batch))
            rec["a"] = {"loss": float(m["loss"]), "step_ms": t,
                        "launches": {n: c.launches for n, c in counters.items()},
                        "collectives": collectives_since(counts, before),
                        "wall_s": time.perf_counter() - t_a}
        rec["replicated_digests"] = {
            "/".join(k): tensor_digest(torch, v.to_local())
            for k, v in flat(p).items() if spmd.model_dim(v) is None}
        torch.save(blocks(p), out + ".params.pt")
        del state, step, p, o, s, m

        t_b = time.perf_counter()
        params = place_params(T.init_params(torch.Generator(device="cuda")
                                            .manual_seed(0), cfg, device="cuda"),
                              cfg, mesh)
        with torch.no_grad():
            counters = reset_counters()
            (logits, cache), t_pre = event_ms(torch, lambda: T.prefill(
                params, cfg, prompt, CUT_S + CUT_NEW, attn="flash"))
            launches = {n: c.launches for n, c in counters.items()}
            torch.save({"logits": logits.to_local().float().cpu()},
                       out + ".prefill.pt")
            tpl = spmd.tensor_parallel(logits)
            toks, dec_ms = [spmd.vocab_argmax(logits.to_local(), tpl)], []
            for _ in range(1, CUT_NEW):
                (logits, cache), t = event_ms(torch, lambda: T.decode_step(
                    params, cache, toks[-1], cfg))
                dec_ms.append(t)
                toks.append(spmd.vocab_argmax(logits.to_local(), tpl))
        rec["b"] = {"prefill_ms": t_pre, "decode_ms": dec_ms,
                    "tokens": torch.stack(toks, 1).tolist(), "launches": launches,
                    "cache_model_dim": spmd.model_dim(cache["k"]),
                    "wall_s": time.perf_counter() - t_b}
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        with open(out, "w") as f:
            json.dump(rec, f)
        dist.destroy_process_group()


def cut_phase(torch):
    """Phase 29a (module docstring). Returns (record, training launches,
    serving launches), each summed over the ranks."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cut_")
    try:
        grads, ref_loss, ref_params, ref_toks, ref_logits = \
            cut_reference(torch)
        free_before(torch, "phase 29a's processes")
        ranks, wall = spawn_dp("cut", CUT_WORLD, workdir, entry="cut_child")
        paths = [os.path.join(workdir, f"dp_cut_{r}.json") for r in
                 range(CUT_WORLD)]
        order = sorted(range(CUT_WORLD), key=lambda r: ranks[r]["model_rank"])
        loaded = {kind: [torch.load(paths[r] + kind) for r in order]
                  for kind in (".grads.pt", ".params.pt")}
        got_g, got_p = (whole_blocks(loaded[k]) for k in (".grads.pt",
                                                           ".params.pt"))
        grad_rel = {k: rel_l2(got_g[k].cuda(), g.cuda())
                    for k, g in grads.items()}
        param_rel = {k: rel_l2(got_p[k].cuda(), p.cuda())
                     for k, p in ref_params.items() if p.is_floating_point()}
        del got_g, got_p, loaded, grads, ref_params
        loss = ranks[0]["a"]["loss"]
        want_a = {n: 0 for n in ranks[0]["a"]["launches"]}
        want_a.update({"flash_fwd": 2 * CUT_LAYERS,
                       "flash_bwd_dkv": CUT_LAYERS,
                       "flash_bwd_dq": CUT_LAYERS, **adamw_launches(1)})
        digests = [r["replicated_digests"] for r in ranks]
        a = {"arch": TRAIN_ARCH, "layers": CUT_LAYERS, "batch": CUT_B,
             "seq": CUT_S, "mesh": ranks[0]["mesh"], "ranks_wall_s": wall,
             "rank_walls_s": [r["a"]["wall_s"] for r in ranks],
             "q_spans": [ranks[r]["q_span"] for r in order],
             "wq_model_dim": ranks[0]["wq_model_dim"],
             "loss": loss, "reference_loss": ref_loss,
             "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
             "grad_rel_l2_max": max(grad_rel.values()),
             "param_rel_l2_max": max(param_rel.values()),
             "grad_rel_l2": grad_rel,
             "ranks_equal": all(d == digests[0] for d in digests),
             "replicated_leaves": len(digests[0]),
             "grad_placements_equal": [r["grad_placements_equal"]
                                       for r in ranks],
             "step_ms": [r["a"]["step_ms"] for r in ranks],
             "collectives": ranks[0]["a"]["collectives"],
             "peak_bytes": [r["max_memory_allocated"] for r in ranks],
             "launches": [r["a"]["launches"] for r in ranks],
             "tolerance": {"grad_rel_l2": TRAIN_GRAD_REL_L2,
                           "loss_rel": DP_LOSS_REL,
                           "param_rel_l2": DP_PARAM_REL_L2}}
        log(f"lm_cut_training {json.dumps({k: v for k, v in a.items() if k != 'grad_rel_l2'})}")
        if (a["grad_rel_l2_max"] > TRAIN_GRAD_REL_L2
                or a["loss_rel"] > DP_LOSS_REL
                or a["param_rel_l2_max"] > DP_PARAM_REL_L2
                or not a["ranks_equal"] or not a["replicated_leaves"]
                or not all(a["grad_placements_equal"])
                or a["wq_model_dim"] != 2
                or any(r["backend"] != "gloo" for r in ranks)
                or any(r["a"]["launches"] != want_a for r in ranks)):
            raise AssertionError(f"29a training: {a}; launches want {want_a} "
                                 "a rank")

        pre = [torch.load(paths[r] + ".prefill.pt")["logits"] for r in order]
        b_rel = rel_l2(torch.cat(pre, dim=-1), ref_logits[0].float())
        toks = [r["b"]["tokens"] for r in ranks]
        ok = b_rel <= TP_LOGIT_REL_L2 and all(t == toks[0] for t in toks)
        rows = []
        for i in range(CUT_B):
            row, fine = first_divergence(toks[0][i], ref_toks[i].tolist(),
                                         lambda j: ref_logits[j][i], None)
            if row["first_divergence"] is not None:
                row["band"] *= TP_GAP_ULPS / PARITY_GAP_ULPS
                fine = row["top2_gap"] <= row["band"]
            rows.append(row)
            ok &= fine
        want_b = {n: 0 for n in ranks[0]["b"]["launches"]}
        want_b["flash_fwd"] = CUT_LAYERS
        b = {"prefill_logits_rel_l2": b_rel, "bound": TP_LOGIT_REL_L2,
             "rows": rows, "tokens": toks[0],
             "ranks_tokens_equal": all(t == toks[0] for t in toks),
             "prefill_ms": [r["b"]["prefill_ms"] for r in ranks],
             "decode_ms": ranks[0]["b"]["decode_ms"],
             "cache_model_dim": ranks[0]["b"]["cache_model_dim"],
             "launches": [r["b"]["launches"] for r in ranks]}
        log(f"lm_cut_serving {json.dumps(b)}")
        if not ok or any(r["b"]["launches"] != want_b for r in ranks):
            raise AssertionError(f"29a serving: {b}; launches want {want_b} "
                                 "a rank")
        launches_a = {n: sum(r["a"]["launches"][n] for r in ranks)
                      for n in want_a}
        launches_b = {n: sum(r["b"]["launches"][n] for r in ranks)
                      for n in want_b}
        rec = {"a": a, "b": b, "wall_s": wall}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"lm_cut_phase_s {rec['phase_s']}")
    return rec, launches_a, launches_b


# 29b: the seven demos of examples/torch on the card, each a process of its
# own, one after another while phases 23 to 29a run (none of their times is
# gated). name: (flags, the line that proves the reference demo's
# contract, the kernels each must have launched)
SNN_SERVING = ("nm_spmm_fused", "lif", "wu_outer_slots")
FLASH_TRAIN = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
LM_TRAIN = FLASH_TRAIN + tuple(NO_ADAMW)
DEMOS = {
    "quickstart": (["--steps", "30"], r"^done", LM_TRAIN),
    "train_lm": (["--preset", "cpu-small", "--steps", "30"],
                 r"^final: loss", LM_TRAIN),
    "serve_decode": ([], r"^first sequence: \[", ("flash_fwd",)),
    "snn_ossl_demo": (["--full-size", "--samples", "20"],
                      r"^modeled power", ("nm_spmm", "lif", "wu_outer")),
    "stream_serving_demo": ([], r"compiled variants 1$", SNN_SERVING),
    "obs_smoke": ([], r"^OK$", SNN_SERVING),
    "elastic_recovery_demo": ([], r"^  final states bitwise identical: True$",
                              LM_TRAIN),
}


# the slot grids of the two SNN serving demos: (case, slots, layer width)
DEMO_SLOT_GRIDS = (("demo_stream_serving", 4, 64), ("demo_obs_smoke", 3, 32))
DEMO_TRAINING = ("demo_quickstart", "demo_train_lm", "demo_elastic_recovery")


def demo_flash_shapes():
    """The flash kernels' shapes in 29b's LM demos on the card, for phase 3
    (case, dtype, B, S, H, KV, dh, window): the reduced configs as the
    demos widen them (``configs.flash_ready``), f32, at the demos' batch and
    sequence length; ``train_lm --preset cpu-small`` is 4 heads over 2 of
    64. ``serve_decode``'s Mixtral prefills 16 tokens under its window."""
    import torch
    from repro_torch.configs import flash_ready, get_reduced

    def reduced(case, arch, b, s):
        c = flash_ready(get_reduced(arch))
        return (case, torch.float32, b, s, c.n_heads, c.n_kv_heads,
                c.head_dim, c.swa_window)
    return [reduced("demo_quickstart", "stablelm_12b", 8, 64),
            ("demo_train_lm", torch.float32, 8, 256, 4, 2, 64, None),
            reduced("demo_serve_decode", "mixtral_8x7b", 4, 16),
            reduced("demo_elastic_recovery", "phi3_medium_14b", 4, 32)]


def start_demos(workdir):
    """Phase 29b's demos, one after another in a thread: returns it and
    the dict it fills (name: exit code, output, wall s). A demo still
    running at exit is killed."""
    import atexit
    import threading
    out, running = {}, []

    def run():
        env = dict(os.environ, PYTHONPATH=SRC)
        for name, (flags, _, _) in DEMOS.items():
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "examples", "torch",
                                              name + ".py"), *flags],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=workdir, preexec_fn=_niced)
            running.append(proc)
            try:
                text, _ = proc.communicate(timeout=300)
                rc = proc.returncode
            except subprocess.TimeoutExpired:
                proc.kill()
                text, rc = proc.communicate()[0], "timeout"
            out[name] = (rc, text[-8000:], time.perf_counter() - t0)

    def stop():
        for proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    atexit.register(stop)
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, out


def demos_check(demos, timeout=600):
    """Phase 29b: each demo exited 0, printed its contract line and a
    ``kernels`` line with every kernel it runs launched on the card; the
    losses of the training demos fell."""
    import re
    thread, out = demos
    thread.join(timeout)
    rec, bad = {}, []
    for name, (_, contract, kernels) in DEMOS.items():
        rc, text, wall = out.get(name, ("not run", "", 0.0))
        lines = text.splitlines()
        kern = [json.loads(l[len("kernels "):]) for l in lines
                if l.startswith("kernels ")]
        falls = [float(b) < float(a) for a, b in
                 re.findall(r"loss ([\d.]+) -> ([\d.]+)", text)]
        r = {"rc": rc, "wall_s": wall, "kernels": kern[0] if kern else None,
             "contract": any(re.search(contract, l) for l in lines),
             "losses_fall": falls, "tail": lines[-6:]}
        rec[name] = r
        if (rc != 0 or not r["contract"] or not kern
                or any(kern[0].get(k, 0) <= 0 for k in kernels)
                or not all(falls)
                or (name in ("quickstart", "train_lm") and not falls)):
            bad.append((name, r, text[-3000:]))
    log(f"demos {json.dumps({k: {x: v[x] for x in ('rc', 'wall_s', 'kernels', 'contract', 'losses_fall')} for k, v in rec.items()})}")
    if bad:
        raise AssertionError(f"29b demos: {bad}")
    return rec


# ---------------------------------------------------------------------------
# phase 23: the runtime and the launcher (recovery, compression, dry run, CLI)
# ---------------------------------------------------------------------------

# (a) Qwen2-VL-2B at full width cut to 2 of its 28 layers (the whole
# model's state, ~18 GB, would take ~20 s a save), phase 10's traffic
RECOVERY_LAYERS, RECOVERY_STEPS, RECOVERY_EVERY = 2, 6, 4
RECOVERY_FAIL_AT = {1: 1, 5: 1}
# beside the states: cuBLAS's workspaces and the step's small leftovers
# (76 MB on the first run); a second state would be 5.6 GB
RECOVERY_SLACK = 256 << 20
COMPRESS_KINDS = (("int8", 0.05), ("topk", 0.05))
# (c) the dry run: every cell on both fake production meshes (the CLI
# shares the cells among its workers); one arch a family logged
DRYRUN_MESHES = ("16x16", "2x16x16")
# the CPU priority the side runs give up (the dry run, --validate, the
# demos: none of their times is gated), so that the phases beside them
# keep the host's cores
SIDE_NICE = 10
DRYRUN_FAMILY_CELLS = ("stablelm_12b", "qwen2_vl_2b", "musicgen_large",
                       "moonshot_v1_16b_a3b", "mamba2_2p7b", "zamba2_1p2b")
ALLOC_ROUND = 512              # the caching allocator's block granularity


def _niced():
    """Run in a side process before it starts: its CPU priority lowered
    by SIDE_NICE, so that it takes what the phases beside it leave."""
    os.nice(SIDE_NICE)


def start_tool(args, workdir, name, nice=False):
    """A ``python -m`` tool of the port in a process of its own (CPU only:
    the dry run and ``--validate`` compute on ``meta``), its output to a
    file, at a lower CPU priority with ``nice``; returns (process, output
    path, start time)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = os.path.join(workdir, name + ".log")
    f = open(out, "w")
    proc = subprocess.Popen([sys.executable, "-m"] + args, stdout=f,
                            stderr=subprocess.STDOUT, env=env, cwd=ROOT,
                            preexec_fn=_niced if nice else None)
    f.close()
    return proc, out, time.time()


def finish_tool(tool, timeout):
    """(exit code, output, wall s from the start to the tool's last line:
    its output file's modification time, not when it was collected)."""
    proc, out, t0 = tool
    try:
        rc = proc.wait(timeout=max(1.0, timeout - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    with open(out) as f:
        text = f.read()
    return rc, text, os.path.getmtime(out) - t0


def recovery(torch, workdir):
    """Phase 23a (module docstring). Returns (record, launches, state,
    step function, first batch)."""
    import copy
    import dataclasses
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.gating import GatingConfig
    from repro_torch.data.pipeline import PipelineConfig, synthetic_lm_batch
    from repro_torch.launch.train import (TrainHParams, init_train_state,
                                          make_train_step)
    from repro_torch.optim import AdamWConfig
    from repro_torch.launch.dryrun import tensors
    from repro_torch.runtime import run_with_recovery
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RECOVERY_LAYERS)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                      gating=GatingConfig())
    pcfg = PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B)
    step = make_train_step(cfg, hp)

    def batch_of(i):
        return {k: torch.from_numpy(v).to("cuda", torch.long)
                for k, v in synthetic_lm_batch(pcfg, i).items()}

    def step_fn(state, i):
        p, o, sp = state
        p, o, sp, m = step(p, o, sp, batch_of(i))
        return (p, o, sp), {"loss": m["loss"]}

    torch.cuda.synchronize()
    held0 = torch.cuda.memory_allocated()
    init = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                            cfg, hp, "cuda")
    state_bytes = sum(x.numel() * x.element_size()
                      for x in tensors(init))
    calls = {"save": [], "restore": []}
    orig = {"save": ckpt.save, "restore": ckpt.restore}

    def save(base, s, tree, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = orig["save"](base, s, tree, **kw)
        calls["save"].append({"step": s, "s": time.perf_counter() - t0,
                              "bytes": dir_bytes(path)})
        return path

    def restore(base, tpl, step=None, device=None):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = orig["restore"](base, tpl, step=step, device=device)
        torch.cuda.synchronize()
        calls["restore"].append({
            "step": out[0], "s": time.perf_counter() - t0,
            "bytes": dir_bytes(os.path.join(base, f"step_{out[0]:09d}")),
            "allocated_before": held,
            "max_memory_allocated": torch.cuda.max_memory_allocated()})
        return out

    base = os.path.join(workdir, "recovery")
    torch.use_deterministic_algorithms(True)
    ckpt.save, ckpt.restore = save, restore
    try:
        counters = reset_counters()
        straight = copy.deepcopy(init)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(RECOVERY_STEPS):
            straight, _ = step_fn(straight, i)
        torch.cuda.synchronize()
        straight_s = time.perf_counter() - t0
        straight_launches = {n: c.launches for n, c in counters.items()}
        t0 = time.perf_counter()
        out, rlog = run_with_recovery(step_fn, init, RECOVERY_STEPS, base,
                                     ckpt_every=RECOVERY_EVERY,
                                     fail_at=RECOVERY_FAIL_AT)
        torch.cuda.synchronize()
        recovered_s = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
    finally:
        ckpt.save, ckpt.restore = orig["save"], orig["restore"]
        torch.use_deterministic_algorithms(False)
    del init
    differ = leaves_equal(torch, out, straight)
    # step executions: 0, [lost at 1], 0-4, [lost at 5], 4-5
    runs = RECOVERY_STEPS
    replays = 1 + 5 + 2
    L = cfg.n_layers
    want = {n: 0 for n in launches}
    want.update(flash_fwd=2 * L * (runs + replays),
                flash_bwd_dkv=L * (runs + replays),
                flash_bwd_dq=L * (runs + replays),
                **adamw_launches(runs + replays))
    restores_ok = all(
        r["allocated_before"] <= held0 + state_bytes + RECOVERY_SLACK
        and r["max_memory_allocated"] <= held0 + 2 * state_bytes + RECOVERY_SLACK
        for r in calls["restore"])
    rec = {"arch": TRAIN_ARCH, "layers": L, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "batch": TRAIN_B, "seq": TRAIN_S,
           "steps": RECOVERY_STEPS, "ckpt_every": RECOVERY_EVERY,
           "fail_at": {str(k): v for k, v in RECOVERY_FAIL_AT.items()},
           "log": rlog, "state_bytes": state_bytes, "held_before": held0,
           "saves": calls["save"], "restores": calls["restore"],
           "straight_s": straight_s, "recovered_s": recovered_s,
           "lost_s": recovered_s - straight_s,
           "step_executions": {"straight": runs, "recovered": replays},
           "leaves_differing": differ,
           "restores_hold_one_state": restores_ok,
           "launches_straight": straight_launches, "launches": launches,
           "launches_want": want}
    log(f"runtime_recovery {json.dumps(rec)}")
    if (differ or rlog != {"restarts": 2, "restored_from": [-1, 3]}
            or launches != want or not restores_ok
            or [c["step"] for c in calls["save"]] != [-1, 3]
            or [c["step"] for c in calls["restore"]] != [-1, 3]):
        raise AssertionError(f"recovery: {rec}")
    del straight
    return rec, launches, out, step, batch_of(0)


def compression(torch, state, step, batch):
    """Phase 23b (module docstring): error-feedback compression over one
    step's gradient tree, timed on the card, gated against the host on the
    embedding's gradient and a stacked MLP leaf."""
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.runtime.compression import (CompressionConfig,
                                                 ErrorFeedback, compress,
                                                 compressed_bytes)
    _, _, grads = step.loss_and_grads(state[0], batch)
    torch.cuda.synchronize()
    leaves_ = [g for g in tree_leaves(grads) if g is not None]
    n = sum(g.numel() for g in leaves_)
    f32_bytes = 4 * n
    gate_leaves = {"embed/tok": grads["embed"]["tok"],
                   "layers/mlp/w1/w": grads["layers"]["mlp"]["w1"]["w"]}
    host = {k: g.cpu() for k, g in gate_leaves.items()}
    out = {"elements": n, "grad_dtype": str(leaves_[0].dtype),
           "f32_bytes": f32_bytes}
    for kind, frac in COMPRESS_KINDS:
        cfg = CompressionConfig(kind=kind, topk_frac=frac)
        ef = ErrorFeedback.init(grads)
        _, ef = ef.step(grads, cfg)                 # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec_, ef = ef.step(grads, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del rec_
        del ef
        nbytes = sum(compressed_bytes(compress(g, cfg), cfg) for g in leaves_)
        gates = {}
        for k, g in gate_leaves.items():
            t0 = time.perf_counter()
            ch = compress(host[k], cfg)
            host_s = time.perf_counter() - t0
            cc = compress(g, cfg)
            gates[k] = {"elements": g.numel(), "host_s": host_s,
                        "payload_equal": all(
                            h.dtype == c.dtype and torch.equal(h, c.cpu())
                            for h, c in zip(ch.payload, cc.payload))}
            del ch, cc
        out[kind] = {"frac": frac if kind == "topk" else None,
                     "ms_per_tree": sorted(times)[1], "ms_all": times,
                     "compressed_bytes": nbytes,
                     "ratio_to_f32": nbytes / f32_bytes, "host_gate": gates}
    del grads
    log(f"runtime_compression {json.dumps(out)}")
    bad = [(kind, k) for kind, _ in COMPRESS_KINDS
           for k, g in out[kind]["host_gate"].items() if not g["payload_equal"]]
    if bad or not (0.25 < out["int8"]["ratio_to_f32"] < 0.26
                   and 0.099 < out["topk"]["ratio_to_f32"] < 0.101):
        raise AssertionError(f"compression on the card: {out}")
    return out


def dryrun_check(torch, tool, workdir, lm_training, timeout):
    """Phase 23c (module docstring): the dry-run CLI's result, its Qwen2-VL-2B
    argument bytes against phase 10's allocation, and its peak estimate at
    phase 10's cell beside the peak measured there."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.gating import GatingConfig
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.train import TrainHParams
    from repro_torch.optim import AdamWConfig
    # phase 10's cell, on meta in this process while the CLI runs
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100),
                      gating=GatingConfig())
    phase10 = lower_cell(get_config(TRAIN_ARCH),
                         ShapeConfig("phase10", TRAIN_S, TRAIN_B, "train"), hp=hp)
    rc, text, wall = finish_tool(tool, timeout)
    outdir = os.path.join(workdir, "dryrun")
    cells = {}
    for name in sorted(os.listdir(outdir)):
        if name.endswith(".json"):
            with open(os.path.join(outdir, name)) as f:
                r = json.load(f)
            cells[name[:-5]] = ({"skipped": r["skipped"]} if "skipped" in r else
                                {"argument_bytes": r["memory"]["argument_bytes"],
                                 "peak_estimate_bytes":
                                     r["memory"]["peak_estimate_bytes"],
                                 "flops_per_device": r["flops_per_device"],
                                 "flash_flops": r["flash_flops"],
                                 "lower_s": r["lower_s"],
                                 "tp_lower_s": r.get("tp_lower_s_by_mesh"),
                                 "collectives": {
                                     m: {op: [d["count"], d["payload_bytes"],
                                              d["wire_bytes"]]
                                         for op, d in c["per_op"].items()}
                                     for m, c in r.get(
                                         "collectives_by_mesh", {}).items()},
                                 "peak_bytes_per_device": r["memory"].get(
                                     "peak_estimate_bytes_per_device_by_mesh",
                                     {})})
    with open(os.path.join(outdir, f"{TRAIN_ARCH}__train_4k__1.json")) as f:
        parts = json.load(f)["memory"]["argument_bytes_by_part"]
    state_bytes = parts["params"] + parts["opt_state"] + parts["sparse_state"]
    alloc = lm_training["init_allocated"]
    done = [l for l in text.splitlines() if l.startswith("done:")]
    rec = {"rc": rc, "wall_s": wall, "summary": done[-1] if done else None,
           "cells": cells, "n_cells": len(cells),
           "qwen2_vl_2b_state_bytes": state_bytes,
           "phase10_requested_bytes": alloc["requested_bytes"],
           "phase10_allocated_bytes": alloc["bytes"],
           "allocated_minus_dryrun": alloc["bytes"] - state_bytes,
           "rounding_bound": alloc["rounding_bound"],
           "tensor_leaves": alloc["tensor_leaves"],
           "phase10_cell": {"argument_bytes": phase10["memory"]["argument_bytes"],
                            "temp_bytes": phase10["memory"]["temp_bytes"],
                            "peak_estimate_bytes":
                                phase10["memory"]["peak_estimate_bytes"],
                            "flops_per_device": phase10["flops_per_device"],
                            "flash_flops": phase10["flash_flops"],
                            "lower_s": phase10["lower_s"],
                            "measured_max_memory_allocated":
                                lm_training["max_memory_allocated"]}}
    # each family's train, prefill and decode cell on 16 x 16: calls and
    # wire bytes a device by op, the peak a device
    shown = {f"{arch}__{kind}": {
        "calls_wire": {op: v[::2] for op, v in
                       cells[f"{arch}__{kind}__1"]["collectives"]
                       .get("16x16", {}).items()},
        "peak_bytes_per_device": cells[f"{arch}__{kind}__1"][
            "peak_bytes_per_device"].get("16x16")}
        for arch in DRYRUN_FAMILY_CELLS
        for kind in ("train_4k", "prefill_32k", "decode_32k")}
    log(f"runtime_dryrun_collectives_16x16 {json.dumps(shown)}")
    rec["family_cells_16x16"] = shown
    log(f"runtime_dryrun {json.dumps({k: v for k, v in rec.items() if k not in ('cells', 'family_cells_16x16')})}")
    unmeshed = [c for c, v in cells.items() if "skipped" not in v and (
        set(v["collectives"]) != set(DRYRUN_MESHES)
        or set(v["peak_bytes_per_device"]) != set(DRYRUN_MESHES)
        or any(sum(x[0] for x in ops.values()) <= 0 or
               sum(x[2] for x in ops.values()) <= 0
               for ops in v["collectives"].values())
        or any(b <= 0 for b in v["peak_bytes_per_device"].values()))]
    from repro_torch.configs import ARCH_IDS, shape_applicable
    want_skip = sum(not shape_applicable(get_config(a), s)[0]
                    for a in ARCH_IDS for s in SHAPES.values())
    skipped = sum(1 for c in cells.values() if "skipped" in c)
    if (rc != 0 or not done or done[-1] != (
            f"done: ok={len(ARCH_IDS) * len(SHAPES) - want_skip} "
            f"skip={want_skip} fail=0")
            or len(cells) != len(ARCH_IDS) * len(SHAPES) or skipped != want_skip
            or unmeshed
            or alloc["requested_bytes"] != state_bytes
            or not 0 <= alloc["bytes"] - state_bytes <= alloc["rounding_bound"]):
        raise AssertionError(f"dry run: {rec}; cells without collectives "
                             f"or a peak on both meshes: {unmeshed}\n"
                             f"{text[-4000:]}")
    return rec


def launcher_check(torch, train_tool, validate_tool, timeout):
    """Phase 23d (module docstring): the launcher's CLI on the card (started
    with phase 23, run while (a) and (b) use the card)."""
    rc_t, text_t, train_s = finish_tool(train_tool, timeout)
    rc, text, validate_s = finish_tool(validate_tool, timeout)
    rec = {"train": {"rc": rc_t, "wall_s": train_s,
                     "stdout": text_t[-2000:]},
           "validate": {"rc": rc, "wall_s": validate_s,
                        "stdout": text[-2000:]}}
    log(f"runtime_launcher {json.dumps(rec)}")
    if (rc_t != 0 or "loss" not in text_t or "device=cuda" not in text_t
            or rc != 0 or "validate OK" not in text):
        raise AssertionError(f"launcher: {rec}\n{text_t[-4000:]}")
    return rec


def start_side_runs():
    """Runs started early so that they go on while phases 20 to 7 use the
    card: phase 23's CPU-only tools (the dry run, ``--validate``) and phase
    3's card tests (``--noconftest``: the repository's conftest imports
    jax, which the port never needs). Returns (workdir, dry run,
    validate, card tests); all are killed, and the workdir removed, at
    exit wherever the script stops."""
    import atexit
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    dry = start_tool(["repro_torch.launch.dryrun", "--arch", "all",
                      "--shape", "all", "--mesh", "both", "--out",
                      os.path.join(workdir, "dryrun"), "--force"],
                     workdir, "dryrun", nice=True)
    val = start_tool(["repro_torch.launch.launcher", "--arch", TRAIN_ARCH,
                      "--validate"], workdir, "validate", nice=True)
    card = start_tool(["pytest", "--noconftest", "-q", "-p",
                       "no:cacheprovider",
                       os.path.join("tests", "test_torch_cuda.py")],
                      workdir, "card_tests")

    def stop():
        for proc, _, _ in (dry, val, card):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    atexit.register(stop)
    return workdir, dry, val, card


def runtime_phase(torch, lm_training, tools):
    """Phase 23: recovery, compression, the dry run and the launcher. The
    dry run and ``--validate`` (CPU only, ``tools`` from
    :func:`start_side_runs`) have run in processes of their own while the
    phases before used the card."""
    import shutil
    workdir, dry, val, _ = tools
    t0 = time.perf_counter()
    train = start_tool(["repro_torch.launch.launcher", "--arch",
                        "stablelm_12b", "--steps", "4", "--seq-len", "32",
                        "--global-batch", "4", "--opt", "zero1"], workdir,
                       "launcher_train")
    try:
        try:
            rec = {}
            rec["recovery"], launches, state, step, batch = recovery(
                torch, workdir)
            rec["compression"] = compression(torch, state, step, batch)
            del state, step, batch
            import gc
            gc.collect()
            torch.cuda.empty_cache()
            rec["dryrun"] = dryrun_check(torch, dry, workdir, lm_training, 600)
            rec["launcher"] = launcher_check(torch, train, val, 600)
        finally:
            for proc, _, _ in (dry, val, train):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t0
    log(f"runtime_phase_s {rec['phase_s']}")
    return rec, launches


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def free_before(torch, what):
    """Frees what the phases before left behind, and raises unless at most
    MOE_HELD_BYTES stay allocated before ``what`` is drawn; returns the
    bytes still allocated."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held > MOE_HELD_BYTES:
        raise AssertionError(f"{held} bytes still allocated before drawing "
                             f"{what}")
    return held


def main() -> int:
    # phase 14 runs LM training with deterministic algorithms on, which
    # needs cuBLAS's fixed workspace; it is read at cuBLAS's first use
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core.snn import init_params
    from repro_torch.core.sparsity import NMSpec, paper_spec_4groups
    from repro_torch.data.events import make_task
    from repro_torch.kernels import _build
    from repro_torch.kernels.adamw import kernel as adamw_kernel
    from repro_torch.kernels.flash_attn import kernel as fa_kernel
    from repro_torch.kernels.lif.kernel import lif_cuda
    from repro_torch.kernels.nm_spmm import kernel as nm_kernel
    from repro_torch.kernels.wu_outer import kernel as wu_kernel

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    if sys.argv[1:] == ["--gate-faults"]:
        gate_faults(torch)
        return 0

    # 2. build: one nvcc per CUDA source, started together, and Triton's
    # compile of the LIF kernel meanwhile
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def build_lif():
        z = torch.zeros((1024, 512), device="cuda")
        lif_cuda(z, z, z, alpha=0.9, beta=0.85, theta=1.0)
        torch.cuda.synchronize()

    with ThreadPoolExecutor(4) as pool:
        builds = {"nm_spmm": pool.submit(timed, nm_kernel.build),
                  "wu_outer": pool.submit(timed, wu_kernel.build),
                  "adamw": pool.submit(timed, adamw_kernel.build),
                  "flash_attn": pool.submit(timed, fa_kernel.build),
                  "flash_bwd": pool.submit(timed, fa_kernel.build_bwd)}
        record["build_s"] = {"lif": timed(build_lif)}
        record["build_s"].update({k: f.result() for k, f in builds.items()})
    record["ptxas"] = {}
    for name in ("nm_spmm", "wu_outer", "adamw", "flash_attn", "flash_bwd"):
        text = _build.load_library.ptxas_log.get(name, "")
        record["ptxas"][name] = ptxas_instances(text)
        for line in text.splitlines():
            if "warning" in line:
                log(f"ptxas {name}: {line.strip()}")
    wgmma = []
    for name, inst in record["ptxas"].items():
        for k in inst:
            if "wgmma" in k["kernel"]:
                cfg = (fa_kernel.launch_config(1, 1, 1, k["dh"], torch.bfloat16)
                       if "fwd" in k["kernel"] else fa_kernel.bwd_launch_config(
                           "dq" if "dq" in k["kernel"] else "dkv", 1, 1, 1, 1,
                           1, k["dh"], torch.bfloat16))
                k["dynamic_smem_bytes"] = cfg.smem_bytes
                wgmma.append(k)
            log(f"ptxas {name} {json.dumps(k)}")
    spilled = [k for k in wgmma if k["spill_stores"] or k["spill_loads"]]
    if len(wgmma) != 9 or spilled:
        raise AssertionError(f"ptxas: want 9 wgmma instances without spills, "
                             f"got {wgmma}")
    log(f"build {json.dumps(record['build_s'])}")

    # 3. kernel parity on the card
    paper = paper_spec_4groups(512, 0.8)
    tiled = NMSpec(n=2, m=8, block=16, out_tile=32)
    nm_recs = [nm_case(torch, name, dt, 1024, 512, 512, spec, sparse)
               for name, spec, sparse in (("paper", paper, True),
                                          ("tiled", tiled, False))
               for dt in (torch.float32, torch.bfloat16)]
    # phase 19e's interactive tier runs the serving kernels at 256 slots
    fused_recs = [nm_fused_case(torch, name, b)
                  for name, b in (("serving", N_STREAMS), ("ragged1000", 1000),
                                  ("interactive", N_STREAMS // 4))]
    lif_recs = [lif_case(torch, shape) for shape in (
        (1024, 512), (1000, 500), (N_STREAMS // 4, 512))]
    wu_recs = [wu_case(torch, name, dt, b, spec)
               for name, dt, b, spec in (
                   ("paper", torch.float32, TRAIN_BATCH, paper),
                   ("paper", torch.bfloat16, TRAIN_BATCH, paper),
                   ("tiled", torch.float32, 128, tiled),
                   ("ragged", torch.float32, 13, paper))]
    slot_recs = [wu_slots_case(torch, name, frac, s)
                 for name, frac, s in (("all_open", 1.0, N_STREAMS),
                                       ("open40", 0.4, N_STREAMS),
                                       ("interactive", 1.0, N_STREAMS // 4))]
    # 29b's SNN demos, at the shapes they launch (held, not timed):
    # snn_ossl_demo --full-size trains at B 16 and evaluates at B 64 on
    # 512 -> 512 layers; stream_serving_demo serves 4 slots of 64 -> 64
    # layers (T 12), obs_smoke 3 slots of 32 -> 32 (T 8)
    for name, b in (("demo_snn_ossl_train", TRAIN_BATCH),
                    ("demo_snn_ossl_eval", EVAL_BATCH)):
        nm_recs.append(nm_case(torch, name, torch.float32, b, 512, 512,
                               paper, True, timed=False))
        wu_recs.append(wu_case(torch, name, torch.float32, b, paper,
                               timed=False))
    for name, s_, k_ in DEMO_SLOT_GRIDS:
        fused_recs.append(nm_fused_case(torch, name, s_, k=k_, timed=False))
        slot_recs.append(wu_slots_case(torch, name, 1.0, s_, k=k_,
                                       timed=False))
    lif_recs += [lif_case(torch, shape, timed=False) for shape in (
        (TRAIN_BATCH, 512), (EVAL_BATCH, 512),
        *((s_, k_) for _, s_, k_ in DEMO_SLOT_GRIDS))]
    bf16 = torch.bfloat16
    from repro_torch.configs import get_config
    hybrid_window = get_config(HYBRID_ARCH).swa_window
    fa_recs = [flash_case(torch, *case) for case in (
        ("prefill", bf16, LM_BATCH, LM_PROMPT, 40, 10, 128, None),
        ("train", bf16, TRAIN_B, TRAIN_S, 12, 2, 128, None),
        ("small_f32", torch.float32, 2, 256, 8, 2, 64, None),
        ("window512", bf16, 2, 2048, 40, 10, 128, 512),
        ("ragged1000", bf16, 2, 1000, 40, 10, 128, None),
        ("mqa", bf16, 2, 2048, 40, 1, 128, None),
        # Moonlight's prefill: 16 query and 16 KV heads (group 1)
        ("moonlight_prefill", bf16, LM_BATCH, LM_PROMPT, 16, 16, 128, None),
        # windows off the key-tile edges, StableLM's dh 160, dh 64
        ("window500", bf16, 2, 2048, 40, 10, 128, 500),
        ("dh160_ragged_window65", bf16, 2, 1000, 32, 8, 160, 65),
        ("dh64_ragged_mqa", bf16, 2, 1000, 16, 1, 64, None),
        ("f32_dh160_window37", torch.float32, 1, 300, 4, 4, 160, 37),
        # Zamba2's shared block at its prefill: 32 query and 32 KV heads of
        # 64 (group 1), its window of 4096 past S
        ("zamba2_prefill", bf16, LM_BATCH, LM_PROMPT, 32, 32, 64,
         hybrid_window),
        # the training shapes of phases 21 and 22: Moonlight (group 1, dh
        # 128) and Zamba2's shared block (group 1, dh 64, window 4096 = S)
        ("moonlight_train", bf16, TRAIN_B, TRAIN_S, 16, 16, 128, None),
        ("zamba2_train", bf16, TRAIN_B, TRAIN_S, 32, 32, 64, hybrid_window),
        # phase 27's local heads on (data 1, model 2): Qwen2-VL's 6 of 12
        # query heads over 1 of 2 KV heads, Phi-3's 20 of 40 over 5 of 10
        ("tp_train", bf16, TRAIN_B, TRAIN_S, 6, 1, 128, None),
        ("tp_prefill", bf16, LM_BATCH, LM_PROMPT, 20, 5, 128, None),
        # phase 28's local heads: Moonlight's 8 of 16 (dh 128), Zamba2's
        # shared block's 16 of 32 (dh 64, its window), training and prefill
        ("tp_moonlight_train", bf16, TRAIN_B, TRAIN_S, 8, 8, 128, None),
        ("tp_moonlight_prefill", bf16, LM_BATCH, LM_PROMPT, 8, 8, 128, None),
        ("tp_zamba2_train", bf16, TRAIN_B, TRAIN_S, 16, 16, 64,
         hybrid_window),
        ("tp_zamba2_prefill", bf16, LM_BATCH, LM_PROMPT, 16, 16, 64,
         hybrid_window),
        # phase 29a's head cut: each rank's span of Qwen2-VL's heads, 2
        # query heads over 1 KV head, at its training and prefill shape
        ("tp_cut", bf16, CUT_B, CUT_S, 2, 1, 128, None))]
    fa_recs += [flash_case(torch, *case, timed=False)
                for case in demo_flash_shapes()]
    bwd_recs = [flash_bwd_case(torch, *case) for case in (
        ("train", bf16, TRAIN_B, TRAIN_S, 12, 2, 128, None),
        ("f32", torch.float32, 2, 256, 8, 2, 64, None),
        ("window500", bf16, 2, 2048, 12, 2, 128, 500),
        ("ragged1000", bf16, 2, 1000, 12, 2, 128, None),
        ("mqa", bf16, 2, 2048, 12, 1, 128, None),
        ("dh160_ragged_window65", bf16, 2, 1000, 32, 8, 160, 65),
        ("dh64_ragged", bf16, 2, 1000, 16, 4, 64, None),
        ("moonlight_train", bf16, TRAIN_B, TRAIN_S, 16, 16, 128, None),
        ("zamba2_train", bf16, TRAIN_B, TRAIN_S, 32, 32, 64, hybrid_window),
        ("tp_train", bf16, TRAIN_B, TRAIN_S, 6, 1, 128, None),
        ("tp_moonlight_train", bf16, TRAIN_B, TRAIN_S, 8, 8, 128, None),
        ("tp_zamba2_train", bf16, TRAIN_B, TRAIN_S, 16, 16, 64,
         hybrid_window),
        ("tp_cut", bf16, CUT_B, CUT_S, 2, 1, 128, None))]
    bwd_recs += [flash_bwd_case(torch, *case, timed=False)
                 for case in demo_flash_shapes() if case[0] in DEMO_TRAINING]
    record["parity"] = {"nm_spmm": nm_recs, "nm_spmm_fused": fused_recs,
                        "lif": lif_recs,
                        "wu_outer": wu_recs, "wu_outer_slots": slot_recs,
                        "flash_fwd": fa_recs,
                        "flash_bwd_dkv": [r["dkv"] for r in bwd_recs],
                        "flash_bwd_dq": [r["dq"] for r in bwd_recs],
                        # no TPU kernel: the fused AdamW (PERF.md's row 7)
                        "adamw": [adamw_case(torch)]}
    adamw_rec = record["parity"]["adamw"][0]

    # 4. serving at full width
    cfg = paper_config("kernels")
    params = init_params(0, cfg, device="cuda")
    task = make_task("gesture", n_in=cfg.n_in, t_steps=cfg.t_steps)
    record["serving"], serve_launches, serve_digest, _ = run_fleet(
        torch, params, task, "serving", pipeline_depth=1)
    record["step_breakdown"] = step_breakdown(torch, params)

    # 19. the serving runtime on phase 4's fleet, held against phase 4's run
    record["runtime"], runtime_launches = runtime(torch, params, task,
                                                  serve_digest)

    # phase 3's card tests and phase 23's CPU-only tools run while phases
    # 20 to 7 use the card (none of their times is gated)
    side_runs = start_side_runs()

    # 20. the static checks on the card, on phase 4's params and task
    record["analysis"], analysis_launches = analysis(torch, params, task)

    # 24a (and 24c's sync guard and registry count): phase 4's fleet on a
    # 4-shard slot mesh, held against phase 4's run
    record["sharded_serving"], sharded_launches = sharded_serving(
        torch, params, task, serve_digest, record["analysis"])
    del serve_digest
    # 24d: shards of 1 and 2 slots, both layouts, against the 1-device ones
    record["narrow_shards"] = narrow_shards(torch, params, task)

    # 5. path parity
    record["path_parity"] = path_parity(torch, params, task)

    # 6. training at full width
    record["training"], train_launches = train(torch, task)

    # 7. training path parity
    record["train_parity"] = train_parity(torch, task)
    record["card_tests"] = card_tests(side_runs[3])

    # 8. LM serving at full width, after freeing the SNN phases' tensors
    del params, task
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    lm_cfg, lm_params, record["lm_init_s"] = lm_model(torch, LM_ARCH)
    record["lm_serving"], lm_launches = lm_serve(torch, lm_cfg, lm_params)

    # 9. LM path parity
    record["lm_parity"] = lm_parity(torch, lm_cfg, lm_params)

    # 10. LM training at full width, after freeing Phi-3's tensors
    del lm_params
    gc.collect()
    torch.cuda.empty_cache()
    record["lm_training"], lm_train_launches = lm_train(torch)
    gc.collect()
    torch.cuda.empty_cache()

    # 11. LM training parity
    record["lm_train_parity"] = lm_train_parity(torch)
    gc.collect()
    torch.cuda.empty_cache()

    # 12. live topology under serving, at full width
    cfg = paper_config("kernels")
    params = init_params(0, cfg, device="cuda")
    task = make_task("gesture", n_in=cfg.n_in, t_steps=cfg.t_steps)
    record["live_topology"], topo_launches, fleet = live_topology(
        torch, params, task)
    record["step_breakdown_factors"] = step_breakdown(torch, params,
                                                      want_factors=True)
    base_bd, fac_bd = record["step_breakdown"], record["step_breakdown_factors"]
    record["factor_cost"] = {
        "device_busy_ms": [base_bd["device_busy_ms"], fac_bd["device_busy_ms"]],
        "device_launches": [base_bd["device_launches"],
                            fac_bd["device_launches"]],
        "added_busy_ms": fac_bd["device_busy_ms"] - base_bd["device_busy_ms"],
        "added_launches": fac_bd["device_launches"] - base_bd["device_launches"]}
    log(f"factor_cost {json.dumps(record['factor_cost'])}")

    # 13. serving parity across a swap; the dense layout against the compact
    record["topology_parity"] = topology_parity(torch, params, task)

    # 14. checkpoints: phase 12's fleet, then LM training resumed; first
    # 24b (and 24c's checkpoint and remesh checks): phase 12's live topology
    # on a 4-shard slot mesh, held against phase 12's fleet
    import shutil
    import tempfile
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        record["sharded_topology"], sharded_topo_launches = sharded_topology(
            torch, params, task, fleet, workdir)
        gc.collect()
        torch.cuda.empty_cache()
        record["fleet_checkpoint"] = fleet_checkpoint(torch, fleet, workdir)
        del fleet, params, task
        gc.collect()
        torch.cuda.empty_cache()
        record["lm_resume"], resume_launches = lm_resume(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # 15. MoE serving at full size, once phases 8-14 have freed their models
    held = free_before(torch, MOE_ARCH)
    moe_cfg, moe_params, record["moe_init_s"] = lm_model(torch, MOE_ARCH)
    record["moe_held_bytes_before_init"] = held
    record["moe_serving"], moe_launches = lm_serve(torch, moe_cfg, moe_params,
                                                   tag="moe_serving")
    record["moe_routing"] = moe_route_checks(torch, moe_cfg, moe_params)

    # 16. MoE parity (2 layers), then the continuous batcher
    # (BATCH_MOE_LAYERS layers)
    import dataclasses
    record["moe_parity"] = moe_parity(torch, moe_cfg, moe_params)
    record["moe_batcher"], batcher_launches = lm_batcher(
        torch, dataclasses.replace(moe_cfg, n_layers=BATCH_MOE_LAYERS),
        dict(moe_params, layers=first_layers(moe_params["layers"],
                                             BATCH_MOE_LAYERS)),
        "moe_batcher")
    del moe_params

    # 21. MoE training at full width (4 layers), once Moonlight's serving
    # weights are freed; then its parity checks (2 layers)
    t_train = time.perf_counter()
    free_before(torch, MOE_ARCH)
    record["moe_training"], moe_train_launches = lm_train(
        torch, dataclasses.replace(moe_cfg, n_layers=MOE_TRAIN_LAYERS),
        tag="moe_training", loss_chunk=MOE_LOSS_CHUNK, same_batches=True)
    free_before(torch, MOE_ARCH)
    record["moe_train_parity"] = moe_train_parity(torch)
    record["moe_training_phases_s"] = time.perf_counter() - t_train
    log(f"moe_training_phases_s {record['moe_training_phases_s']}")

    # 17-18. ssm and hybrid serving at full size, each with its parity
    # checks, once Moonlight is freed; one model on the card at a time
    gc.collect()
    torch.cuda.empty_cache()
    t_ssm = time.perf_counter()
    ssm_cfg, ssm_params, record["ssm_init_s"] = lm_model(torch, SSM_ARCH)
    record["ssm_serving"], ssm_launches = lm_serve(torch, ssm_cfg, ssm_params,
                                                   tag="ssm_serving")
    record["ssm_serving"]["ssd"] = ssd_record(torch, ssm_cfg,
                                              record["ssm_serving"])
    record["ssm_prefill_parity"] = ssm_prefill_parity(
        torch, ssm_cfg, ssm_params, SSM_PARITY_LAYERS, "ssm_prefill_parity")
    record["ssm_batcher"], ssm_batcher_launches = lm_batcher(
        torch, ssm_cfg, ssm_params, "ssm_batcher")
    del ssm_params
    gc.collect()
    torch.cuda.empty_cache()
    hy_cfg, hy_params, record["hybrid_init_s"] = lm_model(torch, HYBRID_ARCH)
    record["hybrid_serving"], hybrid_launches = lm_serve(
        torch, hy_cfg, hy_params, tag="hybrid_serving")
    record["hybrid_prefill_parity"] = ssm_prefill_parity(
        torch, hy_cfg, hy_params, HYBRID_PARITY_LAYERS, "hybrid_prefill_parity")
    record["hybrid_parity"] = lm_parity(
        torch, dataclasses.replace(hy_cfg, n_layers=HYBRID_PARITY_LAYERS),
        dict(hy_params, layers=first_layers(hy_params["layers"],
                                            HYBRID_PARITY_LAYERS)),
        tag="hybrid_parity")
    del hy_params
    record["ssm_hybrid_phases_s"] = time.perf_counter() - t_ssm
    log(f"ssm_hybrid_phases_s {record['ssm_hybrid_phases_s']}")

    # 22. ssm and hybrid training at full size, one model at a time; then
    # their parity checks
    t_train = time.perf_counter()
    free_before(torch, SSM_ARCH)
    record["ssm_training"], ssm_train_launches = lm_train(
        torch, ssm_cfg, tag="ssm_training", same_batches=True)
    record["ssm_training"]["ssd"] = ssd_train_record(torch, ssm_cfg,
                                                     record["ssm_training"])
    free_before(torch, HYBRID_ARCH)
    record["hybrid_training"], hybrid_train_launches = lm_train(
        torch, hy_cfg, tag="hybrid_training", same_batches=True)
    flash_ms = record["hybrid_training"]["profiled_step"][
        "device_ms_by_class"].get("flash", 0.0)
    record["hybrid_training"]["shared_block_flash_ms"] = flash_ms
    log(f"hybrid_training shared_block_flash_ms {flash_ms}")
    free_before(torch, "the ssm parity model")
    record["ssm_train_parity"] = ssm_train_parity(torch)
    free_before(torch, "the hybrid parity model")
    record["hybrid_train_parity"] = hybrid_train_parity(torch)
    record["ssm_hybrid_training_phases_s"] = time.perf_counter() - t_train
    log(f"ssm_hybrid_training_phases_s {record['ssm_hybrid_training_phases_s']}")

    # 23. the runtime and the launcher, once phase 22's models are freed:
    # recovery at full width (2 layers), compression of its gradients, the
    # dry run against phase 10's allocation, the launcher's CLI
    free_before(torch, "phase 23's training state")
    prestart("a", 1)
    prestart("b", DP_WORLD_B)
    # 29b's demos run one after another from here on, and 25c's CPU tool
    # (no time is gated)
    import tempfile
    demo_dir = tempfile.mkdtemp(prefix="chip_smoke_demos_")
    demos = start_demos(demo_dir)
    validate25 = start_validate25(demo_dir)
    record["runtime_launcher"], recovery_launches = runtime_phase(
        torch, record["lm_training"], side_runs)

    # 25. data-parallel LM training across processes: one NCCL rank against
    # make_train_step, two gloo ranks on the card against the 1-process
    # step, the launcher's dry run on a fake 512-rank group
    free_before(torch, "phase 25's processes")
    prestart("moe", DP_MOE_WORLD)
    record["lm_dp_training"], dp_launches = dp_phase(torch, validate25)

    # 26. the MoE family data-parallel: the shard-mapped step (two gloo
    # ranks on the card against the 1-process halves), expert parallelism
    # at full width, the compressed DP mean, elastic_remesh of ZeRO-1
    free_before(torch, "phase 26's reference state")
    prestart("tp", TP_WORLD)
    record["lm_dp_moe_training"], moe_dp_launches = moe_dp_phase(torch)

    # 27. tensor parallelism on (data 1, model 2): two gloo ranks on the
    # card train Qwen2-VL-2B (2 layers) against 25b's 1-process step and
    # serve Phi-3-medium-14B (2 layers) against the 1-process run
    free_before(torch, "phase 27's reference state")
    prestart("fam", TP_WORLD)
    record["lm_tp"], tp_train_launches, tp_serve_launches = tp_phase(torch)

    # 28. tensor parallelism for the moe, ssm and hybrid families on (data
    # 1, model 2): Moonlight, Mamba2 and Zamba2 at full width against their
    # 1-process runs, and a checkpoint of the TP state
    free_before(torch, "phase 28's reference state")
    prestart("cut", CUT_WORLD)
    record["lm_tp_families"], fam_launches = tp_family_phase(torch)

    # 29. (a) the head cut: eight gloo ranks on the card train and serve
    # Qwen2-VL-2B (2 layers) with its 12 heads over a model axis of 8,
    # against the 1-process runs; (b) the port's seven demos, each a process
    free_before(torch, "phase 29's reference state")
    record["lm_cut"], cut_train_launches, cut_serve_launches = \
        cut_phase(torch)
    try:
        record["demos"] = demos_check(demos)
    finally:
        shutil.rmtree(demo_dir, ignore_errors=True)

    by_path = {name: {"serving": serve_launches[name],
                      "runtime": runtime_launches[name],
                      "analysis": analysis_launches[name],
                      "training": train_launches[name],
                      "lm_serving": lm_launches[name],
                      "lm_training": lm_train_launches[name],
                      "live_topology": topo_launches[name],
                      "lm_resume": resume_launches[name],
                      "moe_serving": moe_launches[name],
                      "moe_batcher": batcher_launches[name],
                      "ssm_serving": ssm_launches[name],
                      "ssm_batcher": ssm_batcher_launches[name],
                      "hybrid_serving": hybrid_launches[name],
                      "moe_training": moe_train_launches[name],
                      "ssm_training": ssm_train_launches[name],
                      "hybrid_training": hybrid_train_launches[name],
                      "runtime_recovery": recovery_launches[name],
                      "sharded_serving": sharded_launches[name],
                      "sharded_topology": sharded_topo_launches[name],
                      "lm_dp_training": dp_launches[name],
                      "lm_dp_moe_training": moe_dp_launches[name],
                      "lm_tp_training": tp_train_launches[name],
                      "lm_tp_serving": tp_serve_launches[name],
                      **{path: fam[name] for path, fam in
                         fam_launches.items()},
                      "lm_cut_training": cut_train_launches[name],
                      "lm_cut_serving": cut_serve_launches[name],
                      **{"demo_" + demo: r["kernels"][name] for demo, r in
                         record["demos"].items()}}
               for name in kernel_counters()}

    def row(name, route, source, replaces, rec):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces,
                "launches": sum(by_path[name].values()),
                "launches_by_path": by_path[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
    kernels = {"kernels": [
        row("nm_spmm", "cuda", "src/repro_torch/kernels/nm_spmm/nm_spmm.cu",
            "src/repro/kernels/nm_spmm/kernel.py:47", nm_recs[0]),
        row("nm_spmm_fused", "cuda", "src/repro_torch/kernels/nm_spmm/nm_spmm.cu",
            "src/repro/kernels/nm_spmm/kernel.py:47", fused_recs[0]),
        row("lif", "triton", "src/repro_torch/kernels/lif/kernel.py",
            "src/repro/kernels/lif/kernel.py:27", lif_recs[0]),
        row("wu_outer", "cuda", "src/repro_torch/kernels/wu_outer/wu_outer.cu",
            "src/repro/kernels/wu_outer/kernel.py:42", wu_recs[0]["fused"]),
        # the per-slot update has no Pallas kernel: it serves the jnp
        # wu_outer_slots (src/repro/kernels/wu_outer/ref.py:26) in place
        row("wu_outer_slots", "cuda",
            "src/repro_torch/kernels/wu_outer/wu_outer.cu",
            "src/repro/kernels/wu_outer/kernel.py:42", slot_recs[0]),
        row("flash_fwd", "cuda", "src/repro_torch/kernels/flash_attn/flash_attn.cu",
            "src/repro/kernels/flash_attn/kernel.py:73", fa_recs[0]),
        row("flash_bwd_dkv", "cuda", "src/repro_torch/kernels/flash_attn/flash_bwd.cu",
            "src/repro/kernels/flash_attn/kernel.py:161", bwd_recs[0]["dkv"]),
        row("flash_bwd_dq", "cuda", "src/repro_torch/kernels/flash_attn/flash_bwd.cu",
            "src/repro/kernels/flash_attn/kernel.py:180", bwd_recs[0]["dq"]),
        # no Pallas kernel: they serve the jnp AdamW (XLA fuses it)
        row("adamw_norm", "cuda", "src/repro_torch/kernels/adamw/adamw.cu",
            ADAMW_JNP, adamw_rec["norm"]),
        row("adamw_update", "cuda", "src/repro_torch/kernels/adamw/adamw.cu",
            ADAMW_JNP, adamw_rec["update"])]}
    record.update(kernels)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(kernels))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
