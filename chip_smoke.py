#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (modalities_tpu_torch) on one
NVIDIA H100: the quickest proof that the port builds, serves and trains on the
card.

    python3 chip_smoke.py

Phases (each raises on failure, so any failed phase exits non-zero):
  0. the card's name and power limit; sm_90 required; build the kernels from
     modalities_tpu_torch/csrc (one nvcc per source, in parallel) and report
     the build time and ptxas's registers and spills of the seven wgmma kernels
     (flash forward, dq and dk/dv; fused-CE forward, and dh and dW on a
     cluster of 8 CTAs, 16 at E = 4096; the dequant-matmul on a cluster of up
     to 8), of the RMSNorm forward and backward kernels and the backward's
     column sum; and how many fused-CE dh / dW clusters the card holds at once
     at each width.
  1. every kernel against its plain PyTorch version on the card, at the shapes
     the serving and training paths give it, with stated tolerances, and each
     backward kernel and both forwards called twice for bitwise-identical
     results, and the RMSNorm forward batch invariant (the rows of x[64, 2560]
     normalised 1, 8 and 64 at a time equal them among 2048 rows, bitwise);
     per-kernel times (kernel, plain version, one library call as a
     yardstick, least possible). Flash outputs are held row by row to each
     row's own norm, and that check must reject a forward that drops 64 keys
     or one 128-key tile, a dq that drops one 64-key tile of one 128-query
     block, and a dk/dv that drops one 64-query tile near the diagonal; flash
     and RMSNorm also at
     the 32k config's shapes (q [1, 12, 32768, 128], k/v [1, 4, 32768, 128],
     checked head by head, flash timed there beside SDPA; x [32768, 1536])
     and at the 7B's (phase 8: q [4, 32, 4096, 128], k/v [4, 8, 4096, 128]
     head by head, and one tp-8 rank's q [1, 4, 4096, 128], k/v [1, 1, 4096,
     128]; x [16384, 4096] and [512, 4096], forward and backward).
     The fused-CE kernels at the 32k training shape (N 32768, V 50304, E 1536,
     bf16), at the 7B 32k warmstart recipe's (E 4096: one rank's h [8192,
     4096] against a vocab shard of 6288, and the recipe on one card, h
     [32768, 4096] against W [50304, 4096]) and on small ragged f32 and bf16
     cases: lse, corr and total against the plain version, dh and dW of the
     total per row against autograd of it; those checks must reject a forward
     that skips 128 vocab columns, a dh that skips one 64-column vocab tile, a
     dW that skips one 64-token tile, and a dh and a dW whose partial-s sum
     leaves out one cluster rank's slice of E; dh and dW are also timed beside
     autograd's dh alone and dW alone. The
     dequant-matmul at every serving shape (q/c_proj, k/v, W/V, W_2, the fp32
     head), int8 and fp8, bf16 and fp32 x, M 1..100: against the plain
     version; bitwise batch invariant (the rows of x[64, K] 1, 8 and 64 at a
     time) and repeatable; its check must reject a product with one 64-deep k
     tile or one cluster rank's k range left out; timed at M 8 and 64 beside
     torch.matmul + scale, with the 225 calls of a forward summed. The 2.7B
     witness at 8 x 1024 (phase 4) also runs the plain path in fp32. A small GPT2
     then runs prefill + decode on the card and on the CPU with the same
     weights (logits agree), and takes 3 optimizer steps on the card and on
     the CPU from the same parameters (losses and parameters agree); a tiny
     bf16 GPT2 takes 3 steps through the kernels and through the plain path on
     the card (gradients, losses and parameter moves agree).
  2. serve the 2.7B GPT2 of configs/config_2p7b_dp.yaml (full width, cut to
     SERVE_LAYERS = 12 of its 32 layers for the script's time, random weights
     from a seed) with bf16 weights: 9 requests through 8 slots of a
     2048-token ring cache. Every request finishes; the RMSNorm kernel ran
     25 times per forward (PER_FORWARD: two a block and the head's); one greedy request re-served alone gets bitwise its
     batched tokens.
  3. the same weights quantized to int8 and to fp8: every request finishes and
     the dequant-matmul kernel ran 85 times per forward (7 a block and the head); the profiled decode
     step gives the dequant-matmul's device ms a step.
 3b. the paged engine on the same weights, 8 slots, blocks of 16, max_len
     2048 (a table of 128 blocks), every run's launches counted from 0 and
     held to 25 RMSNorm and (int8 weights) 85 dequant-matmul launches per
     forward, packed prefill, decode and verify alike: (a) phase 2's
     requests from the default pool of 1024 blocks, bf16 and int8 weights,
     every request finishing "budget" or "eod", request 0 alone bitwise its
     batched tokens, the tokens against phase 2's ring tokens and a profiled
     paged decode step beside the ring's; (b) the same through a pool of 128
     blocks (the smallest the engine takes at that max_len): preemptions,
     tokens bitwise (a)'s; (c) four requests sharing a donor's 256-token
     prefix, arriving after its prefill (one whose whole window matches):
     prefix hits and a copy-on-write copy, tokens bitwise those with sharing
     off; (d) n-gram speculative decoding at k = 4 on prompts that repeat a
     pattern, bf16 and int8 weights, against spec off: proposals, two
     decode-side shapes, the greedy tokens bitwise spec off's (a divergence
     would print the plain path's top-2 logit gap there), the accepted share
     and the tokens per forward; (e) int8 weights and int8 KV: the pool's data
     half of bf16's (scales apart), the tokens against (a)'s int8 run, and
     its preemption replay on 128 blocks bitwise.
 3c. the serving front end on the same weights, int8, the paged cache: one
     engine with two tenants (interactive: weight 3, max_slots 6; bulk:
     weight 1, 16 tokens/s, burst 64) behind the port's ServingHTTPServer on
     an ephemeral loopback port, its launches counted from 0 and held to 25
     and 85 a forward: (a) phase 2's 9 requests POSTed at once, each
     request's SSE tokens bitwise its JSONL-replay tokens (run_requests on the
     same engine); /healthz, /stats and /metrics answer and /metrics'
     counters equal stats(); (b) 24 requests of both tenants queued at once
     on a stepped clock: the order they get their first token equals the
     port's scheduler on the CPU (a 2-layer model of the same config: with
     eod off the order is the model's business nowhere), and with the clock
     held a bulk request over its token rate gets 429 with Retry-After its
     bucket's refill time; (c) a request whose 300 ms deadline is shorter
     than its decode finishes "deadline" and the pool audit holds; (d) with
     `max_queue_depth` and then a queue brownout, new POSTs get 429 with
     Retry-After >= 1, the brownout sheds queued work ("shed") and the shed
     counter matches; (e) the same weights swapped in mid-flight through
     request_swap: every SSE token bitwise (a)'s, nothing dropped, one decode
     shape; a NaN generation finishes requests "error", and the donor's
     weights swapped back serve (a)'s tokens again; (f) stop() lets the
     in-flight requests finish and a new POST gets 503.
 3d. the serving fleet on the same weights (int8, paged): two workers behind
     the port's FleetRouter on loopback, booted by FleetServingComponent's
     run_fleet, every launch of both counted from 0 and held to 25 and 85
     a forward: (a) phase 2's 9 requests POSTed to the router at once,
     tokens bitwise 3c's replay, both workers picked; (d) /fleet and the
     router's /metrics against the workers' stats(); (c) a rollout of the
     donor weights as generation 1 through RolloutController.deploy with
     requests in flight (the canary swapped mid-flight, then promoted to
     both workers; tokens bitwise the replay), then a NaN generation whose
     canary request finishes "error" and is rolled back (the donor serves
     the replay's tokens again); (b) last, since it kills a worker: a
     worker's server closed mid-stream, and the client gets one answer
     bitwise the replay with fleet_failovers_total up by 1.
 3e. disaggregated prefill/decode on the same weights (int8, paged): (a) a
     DisaggPair (a prefill and a decode engine in process) on phase 2's 9
     requests at bf16 KV and at int8 KV, tokens bitwise the combined
     engine's (3c's replay; 3b (e)'s int8-KV run), 9 handoffs exported and
     imported, no decode shape on the prefill tier and no prefill shape on
     the decode tier; (b) every record's payload exactly n_blocks x 12 x 16
     x 8 x (2 x 80 x 2) bytes at bf16 KV and x (80 + 4) x 2 at int8 KV; (c)
     DisaggServingComponent's tiers behind the DisaggRouter over HTTP: the
     requests whose import body fits the server's 16 MiB body limit bitwise
     the replay; one over the limit takes the path the CPU test found (the
     decode worker closes the connection, counts as dead, one replay through
     a fresh prefill, an SSE error "no healthy decode workers"), then the
     health loop brings the worker back; (d) a record with one flipped byte
     rejected as digest_mismatch and a cross-generation record as
     generation_mismatch at the decode worker, and a corrupted export
     through the router replayed bitwise with the decode worker kept in
     rotation; (e) the handoff's export, wire and import seconds (p50, max)
     and each tier's host ms a forward. Launches held to 25 and 85 a
     forward over every engine of the phase.
 3f. serving under telemetry and SLOs on the same weights (int8), every
     launch of the phase counted from 0 and held to 25 and 85 a forward,
     each config a copy of the shipped file with its model node swapped
     (MODEL_2P7B), a word-level tokenizer, int8 weights and 2048-token caches,
     its `slo` block as shipped: (a) phase 2's 9 requests through `serve()`
     (the CLI's JSONL replay, the ring as config_serve.yaml sets it) with
     MODALITIES_TPU_SERVE_TELEMETRY_DIR: every request that finishes
     "budget" bitwise phase 2's int8 ring tokens (one the SLO-only brownout
     shed must follow an slo/breach event in the sink), 9 serve_request
     records agreeing with the rows, stats() and the registry's exposition,
     and `data analyze_serve` / `data check_slo` rendering that sink; (b) the
     config's component (the paged cache) behind the HTTP front end, its SLO
     engine (the
     file's objectives plus `error_rate_live` over the live
     serve_requests_submitted_total: the file's error_rate names
     serve_requests_total, which only check_slo's replay builds) sampled on
     a stepped clock: a NaN generation's error breaches it (slo_breaches_total
     1, /healthz "degraded"), the SLO-only brownout sheds 100 queued arrivals
     and answers a new POST 429, and with the donor back and the clock past
     the slow window it recovers (/healthz "ok", the donor bitwise 3c's
     replay); (c)
     config_fleet.yaml's two workers, one SLO engine each: a canary fed 16
     prompts of 2000 tokens (its 8 slots twice over; the SLO-only brownout
     may shed the queued ones once it breaches) during probation burns
     ttft_p99 and rolls back
     with stage "slo", /healthz and the router mark it degraded, the donor
     generation answers through the router bitwise 3c's replay, and `data
     analyze_fleet` stitches one trace per routed request; (d) a decode
     dispatch wedged past a 0.5 s watchdog deadline dumps one artifact with
     the thread stacks, the engine's stats and the card's memory under the
     JAX keys; (e) the host ms a decode step with telemetry on and off in
     turns, and the sink's records and bytes a request.
 3g. text generation on phase 2's weights (the 2.7B at SERVE_LAYERS of its
     32 layers, bf16): `TextInferenceComponent`
     (inference/text/inference_component.py) greedy on three of phase 2's
     prompts, NEW_TOKENS new tokens each: a second call gives the same first
     GEN_REPEAT tokens, the
     RMSNorm forward kernel runs 65 times a forward (each `decode_step`),
     decode_step's last logits after each prompt's prefill against the full
     forward's: within GEN_F32_REL in fp32 compute, and in bf16 no farther
     from the fp32 forward than GEN_BF16_FACTOR x the bf16 forward is; the
     host ms and device ms a token, and the tokens' agreement with phase 2's
     ring engine on these weights.
  4. train that 2.7B GPT2 through `modalities_tpu_torch.main.Main` (what
     `python -m modalities_tpu_torch run` calls) from a copy of
     configs/config_2p7b_dp.yaml cut to one card, on a seeded synthetic .pbin
     corpus: 3 optimizer steps of 2 x 2 sequences of 4096 tokens. Losses and
     grad norms finite, step 0's loss within 0.5 of ln(50304) + 2560 * 0.02^2 / 2
     (the expected loss of the initial random logits), every kernel of the path
     launched the expected number of times per step; a profiled step. The run
     has the default telemetry (no `telemetry` node) with the profiler window
     armed at step 2 and the allocator snapshot at step 3: every interval
     carries the JAX trainer's throughput keys, the step-2 Chrome trace holds
     each kernel of the path at one step's launch count, the snapshot exists,
     `data analyze_telemetry` prints the sink's tables, and the static report
     the fits check held is printed beside max_memory_allocated; its unsharded
     witness runs with `telemetry: {enabled: false}` and is bitwise the run.
     The fits check refuses the built step at the YAML's 4 x 4096 (no remat)
     in the trainer's preflight, before any dispatch, naming its levers. Then 5
     steps on one repeated batch at lr 1.6e-5 with no warmup: the loss falls at
     every step. Then the config's lr 1.6e-4 on one repeated batch, at full
     width and cut depth or length, through the kernels and through the plain
     path on the card: the two loss curves agree at every step.
  5. train the 32k long-context GPT2 of configs/config_long_context_32k.yaml
     through Main (full width and depth: 24 layers of 1536, one sequence of
     32768 a step, full remat, the fused-CE head), on a seeded synthetic
     .pbin: 3 steps with finite losses, step 0's loss within 0.5 of
     ln(50304) + 1536 * 0.02^2 / 2, exact launch counts per step (the
     remat's second forwards included), peak memory within the written
     reckoning (LONG_PEAK_GB) and the static report's predicted peak beside
     it, a profiled step; 5 steps on one repeated
     batch at lr 2e-5 (the loss falls at every step); the config's lr 2e-4
     at full width and 4 layers x 4096 through the kernels and through the
     plain path (chunked-scan head): the loss curves agree at every step.
     The 3 steps also run with the tensor-parallel plan applied on a
     (dp_shard 1, tp 1) mesh with loss parallelism (the fused-CE head on
     vocab shards): the path's launches, losses and grad norms within
     TP_ONE_TOL.
  6. checkpointing at full width, the 32k config cut to 4 of its 24 layers
     (CKPT_LAYERS; the script's time). Run A: the 32k config through
     Main for 52 steps with its own checkpointing interval (50) and k (2):
     it saves and seals the step-50 folder (DCP files, topology.json,
     manifest.json, then last_checkpoint_info.json) and goes on to step 52;
     bytes on disk, save, dcp.save, manifest and verification seconds are
     printed. Run B: the `warmstart` entry point's function on a warmstart
     config derived from the same file (number_conversion nodes, app_state
     `dcp`, warmstart_checkpoint_paths) resumes from the pointer and runs
     steps 51-52: their losses, grad norms and lr, and the final parameters,
     equal run A's bitwise, and each step launches the remat counts; run
     B's final state saved again with `use_async` (dcp.async_save) reads back
     bitwise, its pointer written only after the commit. Then
     `serve` from the step-50 folder (a config derived from
     configs/config_serve.yaml at the 32k model's widths, 4 requests, bf16
     and int8): every request finishes, RMSNorm and dequant-matmul launch
     their per-forward counts for CKPT_LAYERS layers, and the greedy tokens equal
     those of the step-50 parameters handed over in memory, bitwise (which
     the folder's model tensors equal, bitwise). A copy of the folder with
     one byte flipped is refused by the loader (run B's train step left as
     it was), the warmstart's resolution and the serving loader.
  7. context and data parallelism. The flash ring of
     modalities_tpu_torch/parallel/ring_attention.py at the 32k config's
     attention widths with cp 4 (q [1, 12, 32768, 128], k/v [1, 4, 32768,
     128] bf16, 4 contiguous chunks of 8192), forward and backward driven
     rank by rank in this process through the module's own hop functions,
     held against one flash call on the whole sequence (out, dq, dk, dv row
     by row as in phase 1; lse within 1e-4); exactly 10 forward (4 causal, 6
     full), 10 dq and 10 dk/dv launches, none for the 6 skipped hops; each
     rank's hop times beside the whole call's (informational). Then the 32k
     config cut to 2 steps through Main here and through `python -m
     torch.distributed.run --standalone --nproc_per_node 1 -m
     modalities_tpu_torch run` in a subprocess: losses, grad norms and lr
     bitwise equal.
  8. tensor parallelism. (a) configs/config_7b_tp_fsdp.yaml through Main at
     full width (E 4096, 32/8 heads of 128, SwiGLU 14336, vocab 50304,
     untied, the gpt2_llama3_like init with depth_init), cut where one card
     forces it: world 1 and tp 1 (no loss parallelism), 4 of 32 layers, the
     file's micro-batch of 4 x 4096: 3 steps with finite losses, step 0's
     loss within 0.5 of ln(50304) + 0.5 x 0.973 (the Llama3 head's logits),
     exact flash and RMSNorm launches per step, peak memory within the
     written reckoning (SEVEN_B_PEAK_GB), the same steps without a mesh
     bitwise (step 0's loss 11.30021), the same steps with the
     tensor-parallel plan applied on a (dp_shard 1, tp 1) mesh with loss
     parallelism (DTensor parameters under 2-D FSDP2, the loss-parallel CE;
     the path's launches, losses and grad norms within TP_ONE_TOL), a
     profiled step with its ms and MFU; the run saves its step-3 checkpoint
     (interval 3), the pretrain folder of (d). (b) One 7B block at tp 8
     on x [1, 4096, 4096] bf16, driven rank by rank in this process through
     parallel/tensor_parallel.py's `tp_in_process` (each rank's 512 rows
     under SP, its 4/1 heads, its eighth of the MLP; partials summed in rank
     order): output, dx and every weight gradient against the unsharded
     block row by row; exactly 8 flash forward, dq and dk/dv launches at q
     [1, 4, 4096, 128], k/v [1, 1, 4096, 128] and 16 RMSNorm forward and
     backward launches. (c) The fused CE on 8 vocab shards of 6288 at the
     32k CE shape (h [32768, 1536], W [50304, 1536]) and at one rank of the
     7B 32k warmstart recipe (h [8192, 4096], W [50304, 4096]): 8 forward, 8
     dh and 8 dW launches and the combine against one whole-vocabulary call
     (lse within 1e-4, dh within phase 1's bound, the dW shards against the
     whole dW's rows), the shards' summed time beside the whole call's. (d)
     The recipe's chain, pretrain to warmstart: the `warmstart` entry
     point's function on configs/config_7b_warmstart_32k.yaml from (a)'s
     folder, cut to world 1 and 4 of 32 layers (full width, SwiGLU 14336,
     RoPE base 500000, full remat, the fused-CE head at E 4096, one sequence
     of 32768), 3 steps: the progress read from the folder's name, the
     loaded parameters bitwise (a)'s saved ones, finite losses within 0.5 of
     (a)'s last, exact launches per step, peak memory within WARM_7B_PEAK_GB,
     a profiled step; then the same config at 4 layers x 4096 through the
     kernels and through the plain path (chunked-scan head) from step 0.
  9. pipeline parallelism at the 7B's width: (a)'s config at 4 layers and
     its first step's 4 sequences, split over pp 2 (device 0 the embeddings
     and the first layers, device 1 the rest and the head; blocks under
     their global names) and run by the port's executor over the in-process
     transport (parallel/pipeline_scheduled.py `pp_in_process`, every stage
     in this process, tensors handed over by reference; each stage a root of
     `fully_shard` on the world-1 group), each sequence a microbatch (M 4),
     for gpipe, 1f1b, interleaved_1f1b (2 chunks a device) and zbv: loss,
     grad norm and every parameter after the step against (a)'s unpipelined
     step within PP_LOSS_REL, PP_NORM_REL and PP_MOVE_REL, and against the
     same step over 4 accumulation microbatches (differences printed;
     bitwise where they are); exact flash and RMSNorm launches per schedule
     (16 flash forwards a step where (a) launches 4; zbv's input-gradient
     pass runs the backward kernels again); each schedule's step ms, peak
     memory and busy share; the 1F1B tables with two microbatches' B ops
     swapped refused before any launch.
 10. ZeRO-1, cross-slice data parallelism and the row-parallel bias, each
     path's launches counted from 0 just before it: (a) the 2.7B with
     `zero_stage: 1` and `dcn_parallel_degree: -1` through Main, 3 steps
     bitwise phase 4's (inert at dp_replicate 1, one slice); (b) one 2.7B
     step with ZeRO-1 over 4 replicas in this process
     (`TrainStep(zero_in_process=4)`: parallel/zero.py's `Zero1`, the
     train step's ZeRO path, over `InProcessReplicas`) against the stage-0
     step on the same batch: the loss bitwise, every replica's moment
     chunks and the gathered parameters bitwise the unsplit AdamW on the
     same clipped gradient, the norm within NORM_REL of stage 0's, against
     stage 0 bitwise when the norm bits agree and else within one bf16 ulp;
     the moment bytes a replica holds at stage 0 and at R 4, the peak
     memory; (c) one 2.7B step over 2
     slices in this process (`TrainStep(dcn_in_process=2)`), slice 0's rows
     masked to a quarter, against a per-slice reference by autograd on the
     same model (loss and norm within NORM_REL, parameters within one bf16
     ulp), the gap between the per-slice mean and the global token mean
     printed; (d) phase 8b's 7B block with `bias: true` (biases drawn from
     N(0, 0.02)) at tp 8 within the same row bounds.
 11. training resilience and the quick start, each path's launches counted
     from 0 just before it (phase_quick_start, phase_skip,
     phase_resilience): (a) the README's quick start, each command a
     process of its own: `run --test_comm` over
     configs/config_lorem_ipsum_tpu.yaml cut to world 1 with its
     `resilience` block, then `generate_text` over
     configs/config_generate_text.yaml from its last folder, prompts on
     stdin; (b) the anomaly skip at the 2.7B through Main: phase 4's
     config and corpus with `skip_step` and `nan_grads@2`, its steps 1-2 and
     step 3's loss bitwise phase 4's (no component: the raise path), step 3
     skipped (parameters, both moments and AdamW's step counts bitwise as
     after step 2), each step's peak memory within SKIP_PEAK_REL of phase
     4's; (c) at phase 6's widths (4 of the 32k config's 24
     layers) through the CLI: the stop ballot
     at world 1 (`stop_consensus: on`, `sigterm_at_step@1`: the forced save
     at step 3), `sigterm_at_step@2` (the forced save at step 2, exit 75,
     error_rank_0.json resumable), `warmstart` from it bitwise the unbroken
     step 3, `oom@2` (memscope's OOM dump, exit 75 with the resumable
     OutOfMemory), and `run --resilient` with the rollback policy restarting
     once from the step-2 folder to step 4. They run after phase 10, one after
     another, each alone on the card.
 12. the profiling harness (phase_profile, its launches counted from 0 just
     before it): `profile distributed` on configs/config_profile_gpt2.yaml as
     the file stands (12 layers of 768, head dim 64, 4 x 2048, the full fp32
     head), through the CLI's `main` in a temporary working directory, so
     `./profiler_out` lands outside the checkout: each flash kernel launched
     n_layer times a step and each RMSNorm kernel 2 n_layer + 1 times, over
     its 6 steps; the Chrome trace of steps 4-6 names those kernels at 3
     steps' launches (its device ms a step and each kernel's total printed);
     memory_stats.jsonl holds 6 lines with non-zero peaks; the allocator's
     snapshot exists; the static walk of the same config (`data
     analyze_perfscope`'s engine, in this process on fake CPU tensors) names
     the same kernels at one step's launches. Phase 3's fp8 engine also runs the
     serving OOM drill: `oom@N` at its next dispatch round leaves the dump
     (levers, the card's memory) and raises the resumable OutOfMemory (its
     launches are not counted).
 13. the multimodal models, each path alone on the card, its launches
     counted from 0 just before it: (a) `run` over
     configs/config_example_coca_tpu.yaml with its mesh cut to world 1 (its
     token target with it: 8 steps of one rank's 4 x 16 tokens) and its
     paths into a folder of the phase, a process of its own: step 8, every
     logged train loss within 0.05 of ln 512 (the JAX e2e test's oracle), a
     step-8 checkpoint folder, the eval's rows, and each flash kernel (fp32:
     the config trains in float32) launched 9 times a training step (the ViT
     2, the pooling 1, the text decoder 2, the multimodal decoder 2 x 2),
     the forward 9 times each eval batch besides; (b) the ViT at the JAX
     defaults (224^2 images in patches of 16, 768 over 8 heads: head dim 96,
     12 layers, 1000 classes) in bf16 on 64 seeded images, a cross entropy's
     forward and backward through the flash kernels and through the plain
     attention from the same parameters: loss and gradients within
     VIT_BF16_TOL, 12 launches of each kernel, none on the plain arm. Their
     flash calls are held to the plain versions in phase 1 at their shapes
     (the ViT's q [64,8,197,96] and CoCa's, Sq != Sk among them, f32 and
     bf16) and timed there beside SDPA and their bound.
 14. one JSON line naming the kernels (launches summed over the paths, and
     per path: serve, serve_paged, serve_paged_int8kv, serve_spec, serve_http, serve_fleet, serve_disagg,
     serve_observed, generate_2p7b, train_2p7b, train_32k, train_32k_resume, ring_cp4,
     train_32k_torchrun, train_7b, tp8, train_7b_32k_warmstart, pp2_gpipe,
     pp2_1f1b, pp2_interleaved_1f1b, pp2_zbv, train_2p7b_zero1,
     zero4_in_process, dcn2_in_process, tp8_bias, quickstart_train,
     quickstart_generate, skip_2p7b, consensus_32k, preempt_32k,
     resume_32k, oom_32k, resilient_32k, profile_gpt2, train_coca, train_vit,
     serve_ckpt; the fused-CE and flash kernels' times at every shape of
     phase 1 under `shapes`), then the card's name and power limit, then the
     device line (last line).
     `[timing]` lines give the script's wall time after each phase.

Phases 4-10 run on the world-1 NCCL process group that `run` builds without
a launcher (held across them), so every training run goes through
`fully_shard` (the configs' `fsdp2_wrapped`); phases 4, 5 and 8a also run
their 3 steps with the train step built without a mesh and hold every
step's loss, grad norm and lr bitwise equal (step 0's losses 11.34302,
11.13179 and 11.30021 in phases 4, 5 and 8a).

Exits non-zero, printing no result, without a CUDA device or without the rest
of the repository beside it.
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
from pathlib import Path
from typing import Any

import numpy as np

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989.4e12  # dense tensor-core bf16, the peak of the port's MFU table (utils/mfu.py)
PEAK_F32_FLOPS = 67e12  # fp32 outside the tensor cores
L2_FLUSH_BYTES = 128 * 2**20  # > the 50 MB L2: every timed call starts cold, as in a decode step
SPIN_CYCLES = 2_000_000  # ~1 ms at 1.98 GHz: covers the host's enqueue of one timed call

MODEL_2P7B = {  # config_serve.yaml's model node at configs/config_2p7b_dp.yaml's widths
    "sample_key": "input_ids",
    "prediction_key": "logits",
    "poe_type": "NOPE",
    "sequence_length": 4096,
    "vocab_size": 50304,
    "n_layer": 32,
    "n_head_q": 32,
    "n_head_kv": 8,
    "n_embd": 2560,
    "ffn_hidden": 11520,
    "dropout": 0.0,
    "bias": False,
    "attention_config": {
        "qkv_transforms": [
            {"type_hint": "RotaryTransform", "config": {"n_embd": 2560, "n_head": 32, "base_freq": 10000}}
        ]
    },
    "attention_implementation": "manual",
    "activation_type": "swiglu",
    "attention_norm_config": {"norm_type": "rms_norm", "config": {"ndim": 2560, "bias": False, "epsilon": 1e-5}},
    "ffn_norm_config": {"norm_type": "rms_norm", "config": {"ndim": 2560, "bias": False, "epsilon": 1e-5}},
    "lm_head_norm_config": {"norm_type": "rms_norm", "config": {"ndim": 2560, "bias": False, "epsilon": 1e-5}},
    "use_weight_tying": False,
}
# phases 2-3f serve the 2.7B at full width cut to SERVE_LAYERS of its 32 layers: the serving phases are host-bound
# (a decode step's host time grows with its layers), and at 32 layers the script outran its 1200 s limit on a slow
# host. 12 is the least depth at which 3e (c) still has a request on each side of the 16 MiB import body limit.
# Phase 3g generates on the same weights (at 32 layers until the script neared 1100 s of its 1200 s limit).
SERVE_LAYERS = 12
# NEW_TOKENS: each serving request's budget; 48 (64 before phase 13 was added), to pay for phase 13 inside the limit:
# every serving check's threshold sits below it (3c (e) swaps after 20 decode steps, 3d (c) deploys after 10, 3d (b)
# fails over after FAILOVER_AFTER tokens; 3b (b)'s 128 blocks still preempt: the 9 requests need 196)
SLOTS, CAPACITY, NEW_TOKENS = 8, 2048, 48
TRAIN_SHAPE = (2, 4096, 32, 8, 80)  # (B, S, Hq, Hkv, D) of one 2.7B training microbatch
# (1, 2048, 12, 4, 128) is the 32k config's heads (GQA group 3, D 128) at a length whose plain scores fit;
# (1, 4096, 4, 1, 128) one tp-8 rank's heads of the 7B (phase 8b)
FLASH_PROFILE = (4, 2048, 12, 12, 64)  # phase 12's attention (configs/config_profile_gpt2.yaml): no GQA, D 64
FLASH_SHAPES = [TRAIN_SHAPE, (1, 1000, 8, 2, 64), (2, 256, 4, 4, 128), (1, 1, 4, 1, 80), (1, 2048, 12, 4, 128),
                (1, 4096, 4, 1, 128), FLASH_PROFILE]
FLASH_LONG = (1, 32768, 12, 4, 128)  # (B, S, Hq, Hkv, D) of the 32k config's attention, checked head by head
FLASH_7B = (4, 4096, 32, 8, 128)  # the 7B's attention on one card (phase 8a), checked head by head
# Flash attention against the plain version, per output row relative to the
# row's own norm (_row_check). bf16: the kernels round P and dS to bf16 before
# their tensor-core products and round each output to bf16, while the plain
# version stays fp32 on the same bf16 inputs; the worst row measured 5.2e-3
# on the H100, a kernel that drops one key tile 0.53.
FLASH_ROW_REL = {"float32": 1e-4, "bfloat16": 1e-2}
# The tiny bf16 GPT2 through the kernels against the plain path on the card:
# relative differences of the first gradients (per tensor), each step's loss
# and grad norm, and each parameter's move over 3 steps; 3-4x what the
# H100 showed (0.013, 6.9e-6, 2.9e-4, 0.032).
TINY_BF16_TOL = {"grads": 4e-2, "loss": 3e-5, "grad_norm": 1e-3, "params": 0.1}
# (layers, sequence length) of the lr-1.6e-4 witness runs, kernels vs plain
# path, and the largest loss difference allowed between them at any step
# (the H100 showed 0.031-0.042 at 32 x 1024; the 2.7B's witness is cut to 8 of its 32 layers for the script's
# time: its three arms at 32 layers took 41-72 s, launch-bound)
LR_WITNESS = [(8, 1024), (4, 4096)]
LR_WITNESS_TOL = 0.1
# The tp plan at tp 1 on the card against the unsharded route of the same run: each step's loss (absolute) and
# grad norm (relative). Both routes give the same sums in another order; a fault of the plan's route (a wrong
# shard offset, a lost or doubled exchange) moves them by O(1)
TP_ONE_TOL = 1e-3
RMS_ROWS = (1, 4, 8, 16, 64, 1000, 8192)  # 8192 = 2 x 4096 rows of a training microbatch
RMS_LONG = (32768, 1536)  # (rows, width) of the 32k config's norms: one sequence of 32768 at width 1536
RMS_7B = ((16384, 4096), (512, 4096))  # the 7B's norms: 8a's 4 x 4096 rows; one tp-8 rank's 512 rows under SP (8b)
RMS_PROFILE = (8192, 768)  # phase 12's norms (configs/config_profile_gpt2.yaml): 4 x 2048 rows at width 768
QMM_SHAPES = [(2560, 2560), (2560, 640), (2560, 7680), (7680, 2560), (2560, 50304)]  # (K, N) per decode step
CE_SHAPE = (32768, 50304, 1536)  # (N, V, E) of one 32k training microbatch: rows, vocab, width
# (N, V, E) of the 7B 32k warmstart recipe's head (config_7b_warmstart_32k.yaml): one rank of its dp_shard 2 x cp 4
# x tp 8 mesh (its cp chunk of 8192 rows gathered over tp, a vocab shard of 6288), and the recipe cut to one card
CE_7B_SHAPES = [(8192, 6288, 4096), (32768, 50304, 4096)]
# Small fused-CE cases (N, V, E, h dtype, w dtype, ignored rows): ragged rows and vocab on both
# paths, ignored rows, all rows ignored, widths up to the 7B's, bf16 h with fp32 w
CE_SMALL = [(100, 300, 64, "float32", "float32", 7), (37, 129, 128, "float32", "float32", 0),
            (16, 128, 32, "float32", "float32", 16), (100, 300, 128, "bfloat16", "bfloat16", 7),
            (37, 129, 256, "bfloat16", "bfloat16", 0), (45, 1000, 1536, "bfloat16", "bfloat16", 3),
            (16, 128, 128, "bfloat16", "bfloat16", 16), (32, 256, 64, "bfloat16", "float32", 2),
            (45, 1000, 4096, "bfloat16", "bfloat16", 3), (129, 63, 4096, "bfloat16", "bfloat16", 7)]
# Fused CE against the plain version (fp32 logits from the same inputs): lse and corr 1e-4
# absolute (fp32 sums of E products in another order; |lse| ~ 11); total rtol 1e-5; dh and dW of
# the total held per row to the row's own norm (_row_check), by the gradient's dtype: f32 1e-4
# (fp32 sums in another order), bf16 2.5e-3 (ds reaches the tensor cores as bf16 hi + lo, about
# 16 bits; what is left is mostly the rounding of every bf16 gradient to bf16 at the end).
CE_ROW_REL = {"float32": 1e-4, "bfloat16": 2.5e-3}
LONG_CONFIG = "config_long_context_32k.yaml"
LONG_MODEL = {"seq": 32768, "vocab": 50304, "width": 1536, "layers": 24}  # the 32k config's model, uncut
LONG_PEAK_GB = 20.0  # the written reckoning of the 32k step's peak memory (PERF.md, section 6): 12-18 GB, at most 20
LONG_WITNESS = (4, 4096)  # (layers, sequence length) of the 32k config's witness runs, kernels vs plain path
TRAIN_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "rms_fwd", "rms_bwd")
# the wgmma kernels (sm_90a; dh and dW on a cluster of 8 CTAs), the RMSNorm forward (a warp a row) and backward
# (a row ring) at every instantiation, and the backward's column sum
REDESIGNED = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16", "ce_fwd_bf16", "ce_dh_bf16", "ce_dw_bf16",
              "rms_norm_fwd_warp", "rms_norm_fwd_team", "rms_norm_bwd_ring", "column_sum_kernel", "quant_mm_tc")
LONG_KERNELS = TRAIN_KERNELS + ("ce_fwd", "ce_dh", "ce_dw")


def log(msg: str) -> None:
    print(msg, flush=True)


_START = time.perf_counter()


def mark(what: str) -> None:
    """A line with the script's wall time so far, after `what` (the time budget's breakdown)."""
    log(f"[timing] {what} done at {time.perf_counter() - _START:.1f} s")


class _IdTok:
    """Identity tokenizer: prompts and completions stay token-id lists."""

    def tokenize(self, ids):
        return list(ids)

    def decode(self, ids):
        return list(ids)

    def get_token_id(self, token):
        return -1


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of `fn` over `reps` calls, each after an L2 flush,
    measured with CUDA events around the call alone. A spin kernel queued
    before the start event keeps the card busy while the host enqueues `fn`,
    so host-side wrapper time does not show up as device time."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def warm_up(torch, seconds: float = 1.0) -> None:
    """Keep the card busy for `seconds` before the first timing: after the
    kernel build the card has idled for minutes, and the first timed call
    read 8x slower in one run."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        torch.matmul(a, a)
        torch.cuda.synchronize()


def host_us(torch, fn, reps: int = 200) -> float:
    """Host time per call of `fn` (enqueue only, no synchronisation inside the
    loop): what a call costs the host in an eager decode step."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return 1e6 * elapsed / reps


def check_close(torch, got, want, atol: float, rtol: float, what: str) -> float:
    """Raise unless |got - want| <= atol + rtol*|want| elementwise; returns the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside atol={atol:g} rtol={rtol:g}, "
                             f"max abs err {float(err.max()):g}")
    return float(err.max())


# ---------------------------------------------------------------- phase 1
def phase_kernels(torch) -> dict:
    import torch.nn.functional as F

    from modalities_tpu_torch.ops.rmsnorm import reference_rms_norm, rms_norm

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain version is full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    out: dict[str, Any] = {}

    # RMSNorm. Tolerances: f32 atol/rtol 1e-5 (the kernel's warp-tree sum vs
    # torch's mean: a few f32 ulps); bf16 two bf16 ulps (rtol 2^-6) on the
    # output rounded from those fp32 values.
    e, eps, err_max, cases = 2560, 1e-5, 0.0, 0
    # decode 8, prefill ladder 64/16/4/1 and many rows at the 2.7B width; the 32k, 7B and profiling shapes
    shapes = [(n, e) for n in (1, 4, 8, 16, 64, 1000)] + [RMS_LONG, *RMS_7B, RMS_PROFILE]
    for dtype, tol in ((torch.float32, (1e-5, 1e-5)), (torch.bfloat16, (1e-6, 2**-6))):
        for n, e in shapes:
            x = torch.randn(n, e, generator=g, device=dev).to(dtype)
            for affine in (False, True):
                s = torch.randn(e, generator=g, device=dev) if affine else None
                b = torch.randn(e, generator=g, device=dev) if affine else None
                y, r = rms_norm(x, s, b, eps=eps, residual=True)
                torch.cuda.synchronize()
                err_max = max(err_max, check_close(torch, y, reference_rms_norm(x, s, b, eps=eps), *tol,
                                                   f"rms_norm {dtype} N={n} affine={affine}"))
                r_ref = torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + eps)
                check_close(torch, r, r_ref, 0.0, 1e-5, f"rms_norm residual {dtype} N={n}")
                cases += 1
    # batch invariance (the serve engine's promise): the rows of x[64,2560] normalised 1, 8 and 64 at a time
    # (the team kernel) and among 2048 rows (a warp a row), bitwise
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2048, 2560, generator=g, device=dev).to(dtype)
        for s in (None, torch.randn(2560, generator=g, device=dev)):
            y, r = rms_norm(x, s, None, eps=eps, residual=True)
            for n in (1, 8, 64):
                for i0 in range(0, 64, n):
                    yi, ri = rms_norm(x[i0:i0 + n].clone(), s, None, eps=eps, residual=True)
                    if not (torch.equal(yi, y[i0:i0 + n]) and torch.equal(ri, r[i0:i0 + n])):
                        raise AssertionError(f"rms_norm {dtype} scale={s is not None}: rows {i0}..{i0 + n} "
                                             f"normalised {n} at a time differ from the same rows among 2048")
    e = 2560
    timings = []
    for n in (8, 64):  # decode rows, largest prefill chunk
        x = torch.randn(n, e, generator=g, device=dev).to(torch.bfloat16)
        s = torch.randn(e, generator=g, device=dev)
        s_lib = s.to(torch.bfloat16)
        nbytes = 2 * n * e * 2 + 4 * e + 4 * n  # x in, y out, scale, r
        bound = 1e3 * max(nbytes / PEAK_BYTES_S, 4.0 * n * e / PEAK_F32_FLOPS)
        timings.append({
            "shape": f"x[{n},{e}] bf16, scale f32",
            "ms": time_ms(torch, lambda: rms_norm(x, s, eps=eps)),
            "plain_ms": time_ms(torch, lambda: reference_rms_norm(x, s, eps=eps)),
            "library_ms": time_ms(torch, lambda: F.rms_norm(x, (e,), s_lib, eps)),
            "bound_ms": bound,
        })
    out["rmsnorm"] = {"max_abs_err": err_max, "timings": timings}
    x = torch.randn(8, e, generator=g, device=dev).to(torch.bfloat16)
    s = torch.randn(e, generator=g, device=dev)
    s_lib = s.to(torch.bfloat16)
    log(f"[phase 1] host us per call at x[8,{e}] bf16: "
        f"rms_norm wrapper {host_us(torch, lambda: rms_norm(x, s, eps=eps)):.1f}, "
        f"plain version {host_us(torch, lambda: reference_rms_norm(x, s, eps=eps)):.1f}, "
        f"F.rms_norm {host_us(torch, lambda: F.rms_norm(x, (e,), s_lib, eps)):.1f}, "
        f"one torch.add {host_us(torch, lambda: torch.add(x, x)):.1f}")
    for t in timings:
        log(f"[phase 1] rms_norm {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"F.rms_norm {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms (bytes)")
    log(f"[phase 1] rms_norm: {cases} cases ({shapes}, f32 and bf16) agree, max abs err {err_max:g}; "
        f"batch invariant: the rows of x[64,2560] normalised 1, 8 and 64 at a time equal them among 2048 rows "
        f"bitwise (f32 and bf16, with and without scale)")

    out.update(phase_quant_matmul(torch))
    return out


# Dequant-matmul shapes (K, N) with their calls per served forward: q, k, v, c_proj, W, V, W_2 in each of the 32
# layers, and the untied head (fp32 x)
QMM_PER_FORWARD = {(2560, 2560): 64, (2560, 640): 64, (2560, 7680): 64, (7680, 2560): 32, (2560, 50304): 1}


def _rejects(fn, error: type = AssertionError) -> str:
    """The message of the `error` `fn` raises; raises if it passes."""
    try:
        fn()
    except error as e:
        return str(e)
    raise AssertionError("a check passed what it must reject")


def phase_quant_matmul(torch) -> dict:
    """The dequant-matmul against its plain version at every serving shape,
    mode, x dtype and row count; batch invariance and repeatability, bitwise;
    the check's sensitivity to a dropped k tile and a dropped cluster rank;
    times beside the bound, the plain version and torch.matmul + scale."""
    from modalities_tpu_torch.ops.quant_matmul import (
        PreparedWeight,
        quant_matmul,
        rank_k_tiles,
        reference_quant_matmul,
        split_k,
    )
    from modalities_tpu_torch.quant.core import quantize_fp8, quantize_per_channel

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    # Tolerances: f32 x |err| <= 1e-5*max|ref| (fp32 sums of up to 7680
    # products in another order, the tensor cores' over 64 k at a time, the
    # head's x as bf16 hi + mid + lo); bf16 x the same plus two bf16 ulps
    # (rtol 2^-6) for the final rounding of values near a boundary.
    def tol(want, dtype):
        return 1e-5 * float(want.float().abs().max()), (2**-6 if dtype == torch.bfloat16 else 0.0)

    err_max, cases = 0.0, 0
    share = {torch.bfloat16: 0.0, torch.float32: 0.0}  # the largest error as a share of what the tolerance allows
    weights = {}
    for k, n in QMM_SHAPES:
        w = torch.randn(n, k, generator=g, device=dev) * 0.02  # [out, in] rows -> per-out scales
        q8, s8 = quantize_per_channel(w)
        qf, sf = quantize_fp8(w)
        ws = {"int8": (q8.t().contiguous(), s8[:, 0].contiguous()),
              "fp8": (qf.t().contiguous(), sf[:, 0].contiguous()), "bf16": w.t().contiguous().bfloat16()}
        for mode in ("int8", "fp8"):
            ws[mode + "_prepared"] = PreparedWeight(*ws[mode])
        weights[(k, n)] = ws
    for (k, n), ws in weights.items():
        for mode in ("int8", "fp8"):
            wq, scale = ws[mode]
            for m in (1, 4, 8, 16, 64, 100):  # decode 8, prefill ladder 64/16/4/1, and more rows than one CTA's 64
                for dtype in (torch.bfloat16, torch.float32):
                    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
                    got = quant_matmul(x, wq, scale, ws[mode + "_prepared"])
                    torch.cuda.synchronize()
                    want = reference_quant_matmul(x, wq, scale)
                    atol, rtol = tol(want, dtype)
                    err_max = max(err_max, check_close(torch, got, want, atol, rtol,
                                                       f"quant_matmul {mode} {dtype} M={m} K={k} N={n}"))
                    allowed = atol + rtol * want.float().abs()
                    share[dtype] = max(share[dtype], float(((got.float() - want.float()).abs() / allowed).max()))
                    cases += 1
            # bitwise: the rows of x[64, K] computed 1, 8 and 64 at a time are equal, and two calls give equal bits
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(64, k, generator=g, device=dev).to(dtype)
                y = quant_matmul(x, wq, scale, ws[mode + "_prepared"])
                if not torch.equal(y, quant_matmul(x, wq, scale, ws[mode + "_prepared"])):
                    raise AssertionError(f"quant_matmul {mode} {dtype} K={k} N={n}: two calls differ")
                for rows in (1, 8):
                    for i0 in range(0, 64, rows):
                        yi = quant_matmul(x[i0:i0 + rows].clone(), wq, scale, ws[mode + "_prepared"])
                        if not torch.equal(yi, y[i0:i0 + rows]):
                            raise AssertionError(f"quant_matmul {mode} {dtype} K={k} N={n}: rows {i0}..{i0 + rows} "
                                                 f"computed {rows} at a time differ from the same rows among 64")
    log(f"[phase 1] quant_matmul: {cases} cases (5 shapes x int8/fp8 x M 1/4/8/16/64/100 x bf16/f32) agree, "
        f"max abs err {err_max:g}, the largest error {share[torch.float32]:.3f} of the f32 tolerance and "
        f"{share[torch.bfloat16]:.3f} of the bf16 one; bitwise batch invariant (the rows of x[64,K] 1, 8 and 64 at "
        f"a time) and repeatable at every shape, int8/fp8 x bf16/f32")

    # the check rejects a product with one 64-deep k tile left out, and one with one cluster rank's k range left out
    for k, n in QMM_SHAPES:
        dtype = torch.float32 if n == 50304 else torch.bfloat16
        wq, scale = weights[(k, n)]["int8"]
        x = torch.randn(8, k, generator=g, device=dev).to(dtype)
        got = quant_matmul(x, wq, scale, weights[(k, n)]["int8_prepared"])
        want = reference_quant_matmul(x, wq, scale)
        check_close(torch, got, want, *tol(want, dtype), f"quant_matmul int8 {dtype} M=8 K={k} N={n}")
        ranks = rank_k_tiles(k, n)
        tile = (k // 64) // 2
        r = len(ranks) // 2
        for what, (a, b) in ((f"k tile {tile}", (tile, tile + 1)), (f"rank {r} of {len(ranks)} (k tiles {ranks[r]})", ranks[r])):
            xm = x.clone()
            xm[:, a * 64:b * 64] = 0
            mutant = reference_quant_matmul(xm, wq, scale)
            msg = _rejects(lambda: check_close(torch, mutant, want, *tol(want, dtype), "mutant"))
            log(f"[phase 1] quant_matmul check at x[8,{k}] {str(dtype)[6:]} @ int8[{k},{n}] (split {split_k(k, n)}) "
                f"rejects a product with {what} left out: {msg}")

    timings = []
    for m in (8, 64):
        for k, n in QMM_SHAPES:
            x_dtype = torch.float32 if n == 50304 else torch.bfloat16  # the untied head runs in fp32
            w_lib = weights[(k, n)]["bf16"].to(x_dtype)
            x = torch.randn(m, k, generator=g, device=dev).to(x_dtype)
            xb = x.element_size()
            nbytes = m * k * xb + k * n + 4 * n + m * n * xb  # x, wq (1 byte), scale in; y out
            # fp32 x: three bf16 products on the tensor cores (the CUDA-core bound it replaces beside it)
            flops, peak = (3 * 2.0 * m * k * n, PEAK_BF16_FLOPS) if xb == 4 else (2.0 * m * k * n, PEAK_BF16_FLOPS)
            bound = 1e3 * max(nbytes / PEAK_BYTES_S, flops / peak)
            library_ms = time_ms(torch, lambda: torch.matmul(x, w_lib) * weights[(k, n)]["int8"][1])
            for mode in ("int8", "fp8"):
                wq, scale = weights[(k, n)][mode]
                pw = weights[(k, n)][mode + "_prepared"]
                timings.append({
                    "shape": f"x[{m},{k}] {str(x_dtype)[6:]} @ {mode}[{k},{n}]",
                    "m": m, "k": k, "n": n, "mode": mode,
                    "ms": time_ms(torch, lambda: quant_matmul(x, wq, scale, pw)),
                    "plain_ms": time_ms(torch, lambda: reference_quant_matmul(x, wq, scale)),
                    "library_ms": library_ms,
                    "bound_ms": bound,
                    "bound_by": "bytes" if nbytes / PEAK_BYTES_S >= flops / peak else "operations",
                    "cuda_core_bound_ms": 1e3 * max(nbytes / PEAK_BYTES_S, 2.0 * m * k * n / PEAK_F32_FLOPS)
                    if xb == 4 else None,
                })
    ws = weights[(2560, 2560)]
    wq, scale = ws["int8"]
    x = torch.randn(8, 2560, generator=g, device=dev).to(torch.bfloat16)
    log(f"[phase 1] host us per call at x[8,2560] bf16 @ int8[2560,2560]: quant_matmul with the prepared weight "
        f"(QuantLinear's call) {host_us(torch, lambda: quant_matmul(x, wq, scale, ws['int8_prepared'])):.1f}, "
        f"preparing the weight each call {host_us(torch, lambda: quant_matmul(x, wq, scale)):.1f}, "
        f"plain version {host_us(torch, lambda: reference_quant_matmul(x, wq, scale)):.1f}, "
        f"bf16 torch.matmul {host_us(torch, lambda: torch.matmul(x, ws['bf16'])):.1f}")
    for t in timings:
        extra = f", CUDA-core bound {t['cuda_core_bound_ms']:.5f} ms" if t["cuda_core_bound_ms"] else ""
        log(f"[phase 1] quant_matmul {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"matmul+scale {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}{extra}), "
            f"{t['bound_ms'] / t['ms']:.3f} of it, {t['ms'] / t['library_ms']:.2f}x the library")
    for m in (8, 64):
        for mode in ("int8", "fp8"):
            row = {(t["k"], t["n"]): t for t in timings if t["m"] == m and t["mode"] == mode}
            step = {key: sum(calls * row[kn][key] for kn, calls in QMM_PER_FORWARD.items())
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
            log(f"[phase 1] quant_matmul, all 225 calls of one forward at M={m} ({mode}): kernel {step['ms']:.3f} ms, "
                f"plain {step['plain_ms']:.3f} ms, matmul+scale {step['library_ms']:.3f} ms, "
                f"bound {step['bound_ms']:.3f} ms")
    return {"quant_matmul": {"max_abs_err": err_max, "timings": timings}}


def phase_small_model_reference(torch) -> None:
    """A small GPT2 (f32 compute) on the card, through both kernels, against the
    same module on the CPU (plain versions): prefill + decode logits agree."""
    from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
    from modalities_tpu_torch.quant.weights import quantize_params, quantized_model

    cfg = dict(MODEL_2P7B, vocab_size=256, n_layer=2, n_head_q=4, n_head_kv=2, n_embd=128, ffn_hidden=256,
               sequence_length=64)
    for key in ("attention_norm_config", "ffn_norm_config", "lm_head_norm_config"):
        cfg[key] = {"norm_type": "rms_norm", "config": {"ndim": 128, "bias": False, "epsilon": 1e-5}}
    cfg["attention_config"] = {"qkv_transforms": [{"type_hint": "RotaryTransform",
                                                   "config": {"n_embd": 128, "n_head": 4}}]}
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, 256, size=(1, 11)))
    steps = [torch.as_tensor(rng.integers(0, 256, size=(4, 1))) for _ in range(4)]
    for mode in ("none", "int8"):
        model = GPT2LLM(**cfg).with_spec_updates(compute_dtype="float32")
        params = model.init_params(torch.Generator().manual_seed(0))
        if mode != "none":
            model, params = quantized_model(model, mode), quantize_params(params, mode)
        logits = {}
        for dev in ("cpu", "cuda"):
            module = model.build_module({k: v.to(dev) for k, v in params.items()})
            cache = module.init_slot_cache(4, 32)
            with torch.inference_mode():
                outs = [module.prefill_slot(cache, prompt.to(dev), 2, 0)]
                pos = torch.tensor([3, 5, 11, 0], device=dev)
                for toks in steps:
                    outs.append(module.decode_slots(cache, toks.to(dev), pos))
                    pos = pos + 1
            logits[dev] = [o.cpu() for o in outs]
        for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
            check_close(torch, a, b, 1e-4, 1e-4, f"small GPT2 ({mode}) forward {i}: card vs CPU")
    log("[phase 1] small GPT2 (f32, plain and int8): card logits agree with the CPU reference (atol 1e-4)")


# ---------------------------------------------------------------- phase 1: training kernels
def _rel_check(torch, got, want, rel, atol, what: str) -> float:
    """Raise unless max|got - want| <= rel * max|want| + atol; returns the max abs error."""
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > rel * float(want.abs().max()) + atol:
        raise AssertionError(f"{what}: max abs err {err:g} above {rel:g} x max|ref| {float(want.abs().max()):g} "
                             f"+ {atol:g}")
    return err


def _row_check(torch, got, want, rel: float, what: str) -> tuple[float, float, float]:
    """Hold every row (the last axis: one query's output or dq, one key's dk or
    dv) to its own size, not to the tensor's largest value:
        ||got_r - want_r|| <= rel * max(||want_r||, floor) + 1e-5 * sqrt(D),
    floor = 1e-3 x the RMS row norm (rows that nearly cancel), 1e-5 * sqrt(D)
    for rows that are 0 in exact arithmetic (one key: p = 1, dp = delta).
    Raises otherwise. Returns (the worst relative error among the rows where the
    relative term dominates, the largest share of its allowance any row used,
    the max abs error)."""
    got, want = got.detach().float(), want.detach().float()
    diff = got - want
    err, size = diff.norm(dim=-1), want.norm(dim=-1)
    size = size.clamp_min(1e-3 * float(size.square().mean().sqrt()))
    atol = 1e-5 * math.sqrt(want.shape[-1])
    allowed = rel * size + atol
    used = float((err / allowed).max())
    sized = rel * size >= atol
    worst = float((err[sized] / size[sized]).max()) if bool(sized.any()) else 0.0
    if not bool(torch.isfinite(got).all()) or used > 1.0:
        raise AssertionError(f"{what}: {int((err > allowed).sum())} of {err.numel()} rows outside rel {rel:g} of "
                             f"their own norm; worst row rel err {worst:g}, allowance used {used:g}")
    return worst, used, float(diff.abs().max())


def _plain_probs(torch, q, k, causal: bool, drop_from=None, width: int = 64):
    """fp32 softmax probabilities [B, Hq, Sq, Sk] of the plain attention
    ([B, H, S, D] inputs, scale 1/sqrt(D)); with `drop_from`, keys
    [drop_from, drop_from + width) are hidden from every query past them."""
    group = q.shape[1] // k.shape[1]
    s = torch.matmul(q.float() / math.sqrt(q.shape[-1]), k.float().repeat_interleave(group, 1).transpose(-1, -2))
    if causal:
        n, m = s.shape[-2:]
        keep = torch.arange(m, device=q.device)[None, :] <= torch.arange(n, device=q.device)[:, None]
        if drop_from is not None:
            keep[drop_from + width:, drop_from:drop_from + width] = False
        s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, dim=-1)


def _tile_dropped_attention(torch, q, k, v, start: int, width: int):
    """The plain causal forward ([B, H, S, D]) with keys [start, start +
    width) hidden from every query past them: what a kernel that skips one key
    tile of those rows would return."""
    p = _plain_probs(torch, q, k, True, drop_from=start, width=width)
    return torch.matmul(p, v.float().repeat_interleave(q.shape[1] // k.shape[1], 1)).to(q.dtype)


def _with_kernel_delta(torch, q, k, do, out_ref, out_kernel, dq, dk, causal: bool):
    """Autograd's dq and dk of the fp32 plain attention ([B, H, S, D]), moved
    to the delta that the kernels' backward reads: delta = sum_D dO * out from
    the out the forward kernel returned (bf16 in bf16, as in the JAX kernels),
    not from the exact out. dq and dk are linear in delta (dS_ij =
    P_ij (dP_ij - delta_i)), so with e = delta_kernel - delta_exact they move
    exactly by -scale * e_i * sum_j P_ij k_j and -scale * sum_i P_ij e_i q_i.
    Where a row of dq nearly cancels, that move is far larger than the row's
    own rounding."""
    group = q.shape[1] // k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _plain_probs(torch, q, k, causal)
    e = (do.float() * (out_kernel.float() - out_ref.float())).sum(-1, keepdim=True)  # [B, Hq, Sq, 1]
    dq = dq.float() - scale * e * torch.matmul(p, k.float().repeat_interleave(group, 1))
    per_head = torch.matmul(p.transpose(-1, -2), e * q.float())  # [B, Hq, Sk, D]
    b, hq, sk, d = per_head.shape
    return dq, dk.float() - scale * per_head.reshape(b, hq // group, group, sk, d).sum(2)


def _flash_work(b, s, hq, hkv, d) -> dict:
    """(operations, bytes) of each flash kernel on causal bf16 inputs: 2 FLOPs
    a multiply-add over the S (S + 1) / 2 causal pairs, 2 / 3 / 4 matmuls;
    each input read once and each output written once."""
    mm = 2.0 * b * hq * (s * (s + 1) / 2) * d  # one of the kernels' matmuls
    qb, kvb, st = b * hq * s * d * 2, b * hkv * s * d * 2, b * hq * s * 4
    return {"fwd": (2 * mm, 2 * qb + 2 * kvb + st), "dq": (3 * mm, 3 * qb + 2 * kvb + 2 * st),
            "dkv": (4 * mm, 2 * qb + 4 * kvb + 2 * st)}


def _flash_case(torch, q, k, v, w, causal: bool, shape: str, seen: dict, errs: dict) -> None:
    """One flash case on q/w [B, Sq, Hq, D] and k/v [B, Sk, Hkv, D] (the
    model layout), every output row held to its own norm (_row_check) at
    FLASH_ROW_REL: FlashAttentionFn against autograd of the fp32 plain
    attention, dq and dk taken at the delta the kernels read
    (_with_kernel_delta); the [B, H, S, D] entries against their plain
    versions given the same global (lse, delta), lse 1e-4 absolute (fp32 in
    both), two backward calls bitwise equal. Records the worst row of each
    (dtype, check, output) in `seen` and the max abs errors in `errs`."""
    from modalities_tpu_torch.ops import flash_attention as fa

    dname = str(q.dtype)[6:]
    rel = FLASH_ROW_REL[dname]
    what = f"flash {dname} causal={causal} {shape}"

    def held(got, want, check, name):
        row_rel, used, abs_err = _row_check(torch, got, want, rel, f"{what} {check} {name}")
        slot = seen.setdefault((dname, check, name), [0.0, 0.0])
        slot[0], slot[1] = max(slot[0], row_rel), max(slot[1], used)
        key = {"out": "fwd", "dq": "dq"}.get(name, "dkv")
        errs[key] = max(errs[key], abs_err)

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.FlashAttentionFn.apply(*leaves, causal, 1.0 / math.sqrt(q.shape[-1]))
    o.backward(w)
    plain = [t.float().clone().requires_grad_(True) for t in (q, k, v)]
    ref = fa.reference_attention(*plain, causal=causal)
    ref.backward(w.float())
    torch.cuda.synchronize()
    bhsd = lambda t: t.detach().transpose(1, 2)  # noqa: E731
    want_dq, want_dk = _with_kernel_delta(torch, bhsd(q), bhsd(k), bhsd(w), bhsd(ref), bhsd(o),
                                          bhsd(plain[0].grad), bhsd(plain[1].grad), causal)
    held(o, ref, "autograd", "out")
    held(bhsd(leaves[0].grad), want_dq, "autograd", "dq")
    held(bhsd(leaves[1].grad), want_dk, "autograd", "dk")
    held(leaves[2].grad, plain[2].grad, "autograd", "dv")
    del o, ref, leaves, plain, want_dq, want_dk
    # the [B, H, S, D] entries with an explicit global (lse, delta); two calls bitwise equal
    qt, kt, vt, wt = (t.transpose(1, 2) for t in (q, k, v, w))
    o1, lse = fa.flash_fwd_out_lse(qt, kt, vt, causal=causal)
    o_ref, lse_ref = fa.reference_flash_fwd_out_lse(qt, kt, vt, causal=causal)
    held(o1, o_ref, "given", "out")
    lse_err = _rel_check(torch, lse, lse_ref, 0.0, 1e-4, f"{what} lse")
    slot = seen.setdefault((dname, "given", "lse"), [0.0, 0.0])
    slot[0], slot[1] = max(slot[0], lse_err), max(slot[1], lse_err / 1e-4)
    delta = (wt.float() * o1.float()).sum(-1, keepdim=True)
    grads = [fa.flash_bwd_dq(qt, kt, vt, wt, lse, delta, causal=causal),
             *fa.flash_bwd_dkv(qt, kt, vt, wt, lse, delta, causal=causal)]
    again = [fa.flash_bwd_dq(qt, kt, vt, wt, lse, delta, causal=causal),
             *fa.flash_bwd_dkv(qt, kt, vt, wt, lse, delta, causal=causal)]
    if not all(torch.equal(a, b2) for a, b2 in zip(grads, again)):
        raise AssertionError(f"{what}: two backward calls differ")
    want = [fa.reference_flash_bwd_dq(qt, kt, vt, wt, lse, delta, causal=causal),
            *fa.reference_flash_bwd_dkv(qt, kt, vt, wt, lse, delta, causal=causal)]
    for got, ref_g, name in zip(grads, want, ("dq", "dk", "dv")):
        held(got, ref_g, "given", name)


def _log_flash_held(seen: dict, phase: str) -> None:
    checks = {"autograd": "FlashAttentionFn vs autograd of the fp32 plain attention",
              "given": "flash_fwd_out_lse / flash_bwd_dq / flash_bwd_dkv vs their plain versions, same (lse, delta)"}
    for dname in ("float32", "bfloat16"):
        for check, text in checks.items():
            parts = [f"{name} {seen[(dname, check, name)][0]:.3g} ({seen[(dname, check, name)][1]:.2f})"
                     for name in ("out", "dq", "dk", "dv", "lse") if (dname, check, name) in seen]
            if parts:
                log(f"[{phase}] flash {dname}, {text}: worst row rel err (share of allowance used) "
                    f"{', '.join(parts)}; bound rel {FLASH_ROW_REL[dname]:g} of the row's own norm"
                    f"{'; lse: max abs err, bound 1e-4' if check == 'given' else ''}")


def phase_train_kernels(torch) -> dict:
    """RMSNorm backward and the three flash kernels against autograd of their
    plain versions (fp32, on the same inputs), twice-called backward kernels
    bitwise equal, and their times at the 2.7B training shapes."""
    import torch.nn.functional as F

    from modalities_tpu_torch.ops import flash_attention as fa
    from modalities_tpu_torch.ops.rmsnorm import (
        fused_rms_norm,
        reference_rms_norm,
        reference_rms_norm_backward,
        rms_norm,
        rms_norm_backward,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    out: dict[str, Any] = {}

    # RMSNorm backward. Tolerances (relative to the largest reference value,
    # plus 1e-5 absolute): f32 1e-5 (fp32 sums in another order); bf16 dx 2^-6
    # (two bf16 ulps of the rounded gradient); dscale/dbias are fp32 column
    # sums (1e-5), 2^-7 when returned in a bf16 parameter's dtype.
    eps, err_max, cases = 1e-5, 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for n, e in [(n, 2560) for n in RMS_ROWS] + [RMS_LONG, *RMS_7B, RMS_PROFILE]:
            x = torch.randn(n, e, generator=g, device=dev).to(dtype)
            dy = torch.randn(n, e, generator=g, device=dev).to(dtype)
            for pdtype in (None, torch.float32, torch.bfloat16):
                params = [None, None] if pdtype is None else [
                    torch.randn(e, generator=g, device=dev).to(pdtype) for _ in range(2)]
                leaves = [t.clone().requires_grad_(True) if t is not None else None for t in (x, *params)]
                fused_rms_norm(*leaves, eps=eps).backward(dy)
                plain = [t.float().clone().requires_grad_(True) if t is not None else None for t in (x, *params)]
                reference_rms_norm(*plain, eps=eps).backward(dy.float())
                torch.cuda.synchronize()
                for i, (got, want) in enumerate(zip(leaves, plain)):
                    if got is None:
                        continue
                    low = got.dtype == torch.bfloat16
                    rel = (2**-6 if low else 1e-5) if i == 0 else (2**-7 if low else 1e-5)
                    err_max = max(err_max, _rel_check(torch, got.grad, want.grad, rel, 1e-5,
                                                      f"rms_norm backward d{'x sb'[i]} {dtype} N={n} E={e} "
                                                      f"params {pdtype}"))
                cases += 1
            _, r = rms_norm(x, None, None, eps=eps, residual=True)
            s32 = torch.randn(e, generator=g, device=dev)
            first = rms_norm_backward(dy, x, s32, r)
            second = rms_norm_backward(dy, x, s32, r)
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise AssertionError(f"rms_norm backward N={n} E={e} {dtype}: two calls differ")
    log(f"[phase 1] rms_norm backward: {cases} cases (E 2560 at N {RMS_ROWS}; N {RMS_LONG[0]} at E {RMS_LONG[1]}; "
        f"the 7B's (N, E) {list(RMS_7B)}; phase 12's {RMS_PROFILE}) agree with autograd of the plain version (f32 rel 1e-5; "
        f"bf16 dx rel 2^-6, bf16 dscale/dbias rel 2^-7; + atol 1e-5), max abs err {err_max:g}; "
        f"a second call is bitwise identical")
    n, e = 8192, 2560
    x = torch.randn(n, e, generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn(n, e, generator=g, device=dev).to(torch.bfloat16)
    s32 = torch.randn(e, generator=g, device=dev)
    _, r = rms_norm(x, s32, None, eps=eps, residual=True)
    xl = x.clone().requires_grad_(True)
    wl = s32.to(torch.bfloat16).requires_grad_(True)
    y_lib = F.rms_norm(xl, (e,), wl, eps)
    out["rmsnorm_fwd_train"] = {  # the 2.7B path's forward, as residual=True runs there
        "shape": f"x[{n},{e}] bf16, scale f32", "ms": time_ms(torch, lambda: rms_norm(x, s32, None, eps=eps,
                                                                                     residual=True), reps=10),
        "plain_ms": time_ms(torch, lambda: reference_rms_norm(x, s32, None, eps=eps), reps=10),
        "library_ms": time_ms(torch, lambda: F.rms_norm(x, (e,), wl.detach(), eps), reps=10),
        "bound_ms": 1e3 * (2 * n * e * 2 + 4 * e + 4 * n) / PEAK_BYTES_S, "bound_by": "bytes"}
    nbytes = 3 * n * e * 2 + 4 * n + 2 * 4 * e  # x, dy in; dx out; r, scale in; dscale out
    out["rmsnorm_bwd"] = {"max_abs_err": err_max, "timings": [{
        "shape": f"x[{n},{e}] bf16, scale f32",
        "ms": time_ms(torch, lambda: rms_norm_backward(dy, x, s32, r, want_dbias=False), reps=10),
        "plain_ms": time_ms(torch, lambda: reference_rms_norm_backward(dy, x, s32, r), reps=10),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(y_lib, (xl, wl), dy, retain_graph=True), reps=10),
        "bound_ms": 1e3 * nbytes / PEAK_BYTES_S,
        "bound_by": "bytes",
    }]}
    for name, t in (("forward", out["rmsnorm_fwd_train"]), ("backward", out["rmsnorm_bwd"]["timings"][0])):
        lib_name = "F.rms_norm" if name == "forward" else "autograd of F.rms_norm"
        log(f"[phase 1] rms_norm {name} {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"{lib_name} {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms (bytes), "
            f"{t['bound_ms'] / t['ms']:.3f} of it")
    n, e = RMS_LONG
    x = torch.randn(n, e, generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn(n, e, generator=g, device=dev).to(torch.bfloat16)
    s32 = torch.randn(e, generator=g, device=dev)
    _, r = rms_norm(x, s32, None, eps=eps, residual=True)
    xl = x.clone().requires_grad_(True)
    wl = s32.to(torch.bfloat16).requires_grad_(True)
    y_lib = F.rms_norm(xl, (e,), wl, eps)
    shape = f"x[{n},{e}] bf16, scale f32"
    out["rmsnorm_fwd_long"] = {  # the 32k path's forward (row 1's second shape), as residual=True runs there
        "shape": shape, "ms": time_ms(torch, lambda: rms_norm(x, s32, None, eps=eps, residual=True), reps=10),
        "plain_ms": time_ms(torch, lambda: reference_rms_norm(x, s32, None, eps=eps), reps=10),
        "library_ms": time_ms(torch, lambda: F.rms_norm(x, (e,), wl.detach(), eps), reps=10),
        "bound_ms": 1e3 * (2 * n * e * 2 + 4 * e + 4 * n) / PEAK_BYTES_S, "bound_by": "bytes"}
    out["rmsnorm_bwd"]["timings"].append({
        "shape": shape, "ms": time_ms(torch, lambda: rms_norm_backward(dy, x, s32, r, want_dbias=False), reps=10),
        "plain_ms": time_ms(torch, lambda: reference_rms_norm_backward(dy, x, s32, r), reps=10),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(y_lib, (xl, wl), dy, retain_graph=True), reps=10),
        "bound_ms": 1e3 * (3 * n * e * 2 + 4 * n + 2 * 4 * e) / PEAK_BYTES_S, "bound_by": "bytes"})
    for name, t in (("forward", out["rmsnorm_fwd_long"]), ("backward", out["rmsnorm_bwd"]["timings"][-1])):
        lib_name = "F.rms_norm" if name == "forward" else "autograd of F.rms_norm"
        log(f"[phase 1] rms_norm {name} at the 32k shape {t['shape']}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, {lib_name} {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms (bytes), "
            f"{t['bound_ms'] / t['ms']:.3f} of it")
    del x, dy, xl, wl, y_lib, r

    # Flash attention, every output row held to its own norm (_row_check) at
    # FLASH_ROW_REL: against autograd of the fp32 plain attention, dq and dk
    # taken at the delta the kernels read (_with_kernel_delta), and the
    # backward kernels against their plain versions given the same global
    # (lse, delta). lse 1e-4 absolute (fp32 in both).
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    seen: dict[tuple[str, str, str], list[float]] = {}  # (dtype, check, output) -> [worst row rel err, share used]
    cases = 0
    for b, s, hq, hkv, d in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, w = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype) for h in (hq, hkv, hkv, hq))
            for causal in (True, False):
                _flash_case(torch, q, k, v, w, causal, f"(B,S,Hq,Hkv,D)=({b},{s},{hq},{hkv},{d})", seen, errs)
                cases += 1
            del q, k, v, w
            torch.cuda.empty_cache()
    log(f"[phase 1] flash attention: {cases} cases (shapes {FLASH_SHAPES}, causal and not, f32 and bf16) agree "
        f"with autograd of the plain attention and, for the backward kernels, with their plain versions given a "
        f"global (lse, delta); two backward calls bitwise identical; max abs err out {errs['fwd']:g}, "
        f"dq {errs['dq']:g}, dk/dv {errs['dkv']:g}")
    _log_flash_held(seen, "phase 1")

    b, s, hq, hkv, d = TRAIN_SHAPE
    q, k, v, w = (torch.randn(b, hh, s, d, generator=g, device=dev).to(torch.bfloat16) for hh in (hq, hkv, hkv, hq))
    o, lse = fa.flash_fwd_out_lse(q, k, v, causal=True)
    o2, lse2 = fa.flash_fwd_out_lse(q, k, v, causal=True)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError("flash bf16 forward at the 2.7B shape: two calls differ")
    del o2, lse2
    # the check can see a kernel that skips 64 keys near the end of the sequence, or one of its 128-key tiles
    o_ref = fa.reference_flash_fwd_out_lse(q, k, v, causal=True)[0]
    _row_check(torch, o, o_ref, FLASH_ROW_REL["bfloat16"], "flash bf16 out at the 2.7B shape")
    for start, width in ((s - 192, 64), (s - 256, 128)):
        mutant = _tile_dropped_attention(torch, q, k, v, start=start, width=width)
        old_err = float((mutant.float() - o_ref.float()).abs().max())
        old_allowed = 2e-2 * float(o_ref.float().abs().max()) + 1e-5
        try:
            _row_check(torch, mutant, o_ref, FLASH_ROW_REL["bfloat16"], "mutant")
        except AssertionError as e:
            log(f"[phase 1] flash bf16 check against a forward with keys [{start}, {start + width}) dropped for "
                f"queries past them: rejected ({e}); the global check 2e-2 x max|ref| would "
                f"{'pass' if old_err <= old_allowed else 'reject'} it (max abs err {old_err:.4g} vs "
                f"{old_allowed:.4g})")
        else:
            raise AssertionError(f"flash bf16 row check passes a forward with keys [{start}, {start + width}) dropped")
        del mutant
    log("[phase 1] flash bf16 forward at the 2.7B shape: a second call is bitwise identical")
    del o_ref
    torch.cuda.empty_cache()
    delta = (w.float() * o.float()).sum(-1, keepdim=True)
    work = _flash_work(b, s, hq, hkv, d)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    y_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(y_lib, (ql, kl, vl), w, retain_graph=True), reps=5)
    calls = {
        "fwd": (lambda: fa.flash_fwd_out_lse(q, k, v, causal=True),
                lambda: fa.reference_flash_fwd_out_lse(q, k, v, causal=True),
                time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True), reps=5)),
        "dq": (lambda: fa.flash_bwd_dq(q, k, v, w, lse, delta, causal=True),
               lambda: fa.reference_flash_bwd_dq(q, k, v, w, lse, delta, causal=True), lib_bwd),
        "dkv": (lambda: fa.flash_bwd_dkv(q, k, v, w, lse, delta, causal=True),
                lambda: fa.reference_flash_bwd_dkv(q, k, v, w, lse, delta, causal=True), lib_bwd),
    }
    for name, (kernel, plain, lib) in calls.items():
        flops, nbytes = work[name]
        t = {"shape": f"q[{b},{hq},{s},{d}] k/v[{b},{hkv},{s},{d}] bf16 causal", "ms": time_ms(torch, kernel, reps=5),
             "plain_ms": time_ms(torch, plain, reps=3), "library_ms": lib,
             "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S),
             "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES_S else "bytes"}
        out[f"flash_{name}"] = {"max_abs_err": errs[name], "timings": [t]}
        lib_name = "F.scaled_dot_product_attention" if name == "fwd" else "its backward (dq, dk, dv in one call)"
        log(f"[phase 1] flash {name} {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"{lib_name} {lib:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"{flops / t['ms'] / 1e9:.1f} TFLOP/s")
    # the dk/dv check can see a kernel that drops one 64-query tile of one head near the diagonal
    dk, dv = fa.flash_bwd_dkv(q, k, v, w, lse, delta, causal=True)
    want = fa.reference_flash_bwd_dkv(q, k, v, w, lse, delta, causal=True)
    for got, ref, name in zip((dk, dv), want, ("dk", "dv")):
        _row_check(torch, got, ref, FLASH_ROW_REL["bfloat16"], f"flash bf16 {name} at the 2.7B shape")
    kb, head = s - 256, hq - 1
    mutants = _dkv_tile_dropped(torch, q, k, v, w, lse, delta, want, head=head, q0=kb + 64, kb=kb)
    for mutant, ref, name in zip(mutants, want, ("dk", "dv")):
        try:
            _row_check(torch, mutant, ref, FLASH_ROW_REL["bfloat16"], "mutant")
        except AssertionError as e:
            log(f"[phase 1] flash bf16 {name} check against a dkv that drops queries [{kb + 64}, {kb + 128}) of "
                f"head {head} for keys [{kb}, {kb + 128}): rejected ({e})")
        else:
            raise AssertionError(f"flash bf16 {name} row check passes a dkv with one query tile dropped")
    # the dq check can see a kernel that drops one 64-key tile of one 128-query block
    dq = fa.flash_bwd_dq(q, k, v, w, lse, delta, causal=True)
    want_dq = fa.reference_flash_bwd_dq(q, k, v, w, lse, delta, causal=True)
    _row_check(torch, dq, want_dq, FLASH_ROW_REL["bfloat16"], "flash bf16 dq at the 2.7B shape")
    q0 = s - 256
    mutant = _dq_tile_dropped(torch, q, k, v, w, lse, delta, want_dq, head=head, q0=q0, kb=q0 - 64)
    try:
        _row_check(torch, mutant, want_dq, FLASH_ROW_REL["bfloat16"], "mutant")
    except AssertionError as e:
        log(f"[phase 1] flash bf16 dq check against a dq that drops keys [{q0 - 64}, {q0}) for queries "
            f"[{q0}, {q0 + 128}) of head {head}: rejected ({e})")
    else:
        raise AssertionError("flash bf16 dq row check passes a dq with one key tile dropped")
    del q, k, v, w, o, lse, delta, ql, kl, vl, y_lib, dk, dv, want, mutants, dq, want_dq, mutant
    torch.cuda.empty_cache()
    return out


def _dq_tile_dropped(torch, q, k, v, do, lse, delta, want, head: int, q0: int, kb: int):
    """dq `want` ([B, Hq, S, D], causal, scale 1/sqrt(D)) without the
    contribution of keys [kb, kb + 64) to queries [q0, q0 + 128) of q head
    `head`: what a dq kernel that skips that key tile of one query block
    would return (fp32)."""
    hk = head // (q.shape[1] // k.shape[1])
    scale = 1.0 / math.sqrt(q.shape[-1])
    rows, keys = slice(q0, q0 + 128), slice(kb, kb + 64)
    qs, dos = q[:, head, rows].float(), do[:, head, rows].float()  # [B, 128, D]
    ks, vs = k[:, hk, keys].float(), v[:, hk, keys].float()  # [B, 64, D]
    keep = torch.arange(kb, kb + 64, device=q.device)[None, :] <= torch.arange(q0, q0 + 128, device=q.device)[:, None]
    p = torch.exp(torch.matmul(qs, ks.transpose(-1, -2)) * scale - lse[:, head, rows].float()) * keep
    ds = p * (torch.matmul(dos, vs.transpose(-1, -2)) - delta[:, head, rows].float()) * scale
    dq = want.float().clone()
    dq[:, head, rows] -= torch.matmul(ds, ks)
    return dq


def _dkv_tile_dropped(torch, q, k, v, do, lse, delta, want, head: int, q0: int, kb: int):
    """(dk, dv) `want` ([B, Hkv, S, D], causal, scale 1/sqrt(D)) without the
    contribution of queries [q0, q0 + 64) of q head `head` to keys [kb, kb +
    128): what a dk/dv kernel that skips that query tile of one key block
    would return (fp32)."""
    hk = head // (q.shape[1] // k.shape[1])
    scale = 1.0 / math.sqrt(q.shape[-1])
    rows, keys = slice(q0, q0 + 64), slice(kb, kb + 128)
    qs, dos = q[:, head, rows].float(), do[:, head, rows].float()  # [B, 64, D]
    ks, vs = k[:, hk, keys].float(), v[:, hk, keys].float()  # [B, 128, D]
    keep = torch.arange(kb, kb + 128, device=q.device)[None, :] <= torch.arange(q0, q0 + 64, device=q.device)[:, None]
    p = torch.exp(torch.matmul(qs, ks.transpose(-1, -2)) * scale - lse[:, head, rows].float()) * keep
    ds = p * (torch.matmul(dos, vs.transpose(-1, -2)) - delta[:, head, rows].float()) * scale
    dk, dv = want[0].float().clone(), want[1].float().clone()
    dk[:, hk, keys] -= torch.matmul(ds.transpose(-1, -2), qs)
    dv[:, hk, keys] -= torch.matmul(p.transpose(-1, -2), dos)
    return dk, dv


def flash_by_head(torch, shape, seed: int, phase: str = "phase 1"):
    """Flash at a shape too large for the plain scores of every head at
    once: (B, S, Hq, Hkv, D), bf16, causal. The forward, dq and dk/dv
    kernels run once on the whole shape; their outputs are held, every row to
    its own norm, against the plain versions given the same global (lse,
    delta), one head at a time (all B rows) so that the plain fp32 scores
    fit: each q head's out, lse and dq, and each kv head's dk and dv against
    the sum of the plain dk/dv of its q heads (fp32). Two forward and two dq
    calls bitwise equal. Returns (q, k, v, w, lse, delta) [B, H, S, D]."""
    from modalities_tpu_torch.ops import flash_attention as fa

    b, s, hq, hkv, d = shape
    group = hq // hkv
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, w = (torch.randn(b, h, s, d, generator=g, device="cuda").to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    what = f"flash bf16 causal q [{b}, {hq}, {s}, {d}] k/v [{b}, {hkv}, {s}, {d}]"
    rel = FLASH_ROW_REL["bfloat16"]
    o, lse = fa.flash_fwd_out_lse(q, k, v, causal=True)
    o2, lse2 = fa.flash_fwd_out_lse(q, k, v, causal=True)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{what}: two forward calls differ")
    del o2, lse2
    delta = (w.float() * o.float()).sum(-1, keepdim=True)
    dq = fa.flash_bwd_dq(q, k, v, w, lse, delta, causal=True)
    if not torch.equal(dq, fa.flash_bwd_dq(q, k, v, w, lse, delta, causal=True)):
        raise AssertionError(f"{what}: two dq calls differ")
    dk, dv = fa.flash_bwd_dkv(q, k, v, w, lse, delta, causal=True)
    torch.cuda.synchronize()
    seen: dict[str, list[float]] = {}  # output -> [worst row rel err, share of allowance used]

    def held(got, want, name, head):
        row_rel, used, _ = _row_check(torch, got, want, rel, f"{what} {name} head {head}")
        slot = seen.setdefault(name, [0.0, 0.0])
        slot[0], slot[1] = max(slot[0], row_rel), max(slot[1], used)

    lse_err = 0.0
    for hk in range(hkv):
        ks, vs = k[:, hk:hk + 1], v[:, hk:hk + 1]
        want_dk = want_dv = 0.0
        for h in range(hk * group, (hk + 1) * group):
            qs, ws, lse_h, delta_h = q[:, h:h + 1], w[:, h:h + 1], lse[:, h:h + 1], delta[:, h:h + 1]
            o_ref, lse_ref = fa.reference_flash_fwd_out_lse(qs, ks, vs, causal=True)
            held(o[:, h:h + 1], o_ref, "out", h)
            lse_err = max(lse_err, _rel_check(torch, lse_h, lse_ref, 0.0, 1e-4, f"{what} lse head {h}"))
            del o_ref, lse_ref
            held(dq[:, h:h + 1], fa.reference_flash_bwd_dq(qs, ks, vs, ws, lse_h, delta_h, causal=True), "dq", h)
            # fp32 operands: the plain per-head dk/dv stay fp32 until the group's sum
            dk_h, dv_h = fa.reference_flash_bwd_dkv(qs.float(), ks.float(), vs.float(), ws.float(), lse_h, delta_h,
                                                    causal=True)
            want_dk, want_dv = want_dk + dk_h, want_dv + dv_h
            del dk_h, dv_h
            torch.cuda.empty_cache()
        held(dk[:, hk:hk + 1], want_dk, "dk", hk)
        held(dv[:, hk:hk + 1], want_dv, "dv", hk)
        del want_dk, want_dv
    log(f"[{phase}] {what}: kernels on the whole shape vs their plain versions given the same (lse, delta), "
        f"head by head (dk/dv: each kv head against the fp32 sum over its {group} q heads): worst row rel err "
        f"(share of allowance used) {', '.join(f'{n} {r[0]:.3g} ({r[1]:.2f})' for n, r in seen.items())}, "
        f"bound rel {rel:g}; lse max abs err {lse_err:.3g} (bound 1e-4); two forward calls and two dq calls bitwise "
        f"identical")
    del dq, dk, dv, o
    torch.cuda.empty_cache()
    return q, k, v, w, lse, delta


def phase_flash_long(torch) -> dict:
    """Flash at the 32k config's attention shape: q [1, 12, 32768, 128], k/v
    [1, 4, 32768, 128] bf16 (GQA group 3), held head by head
    (`flash_by_head`: the plain fp32 scores take 4.3 GB a head). Then the
    three kernels' times at this shape beside SDPA's (forward; backward with
    dq, dk, dv) and, for dk/dv, the plain version run head by head. Returns
    those timings."""
    import torch.nn.functional as F

    from modalities_tpu_torch.ops import flash_attention as fa

    b, s, hq, hkv, d = FLASH_LONG
    group = hq // hkv
    q, k, v, w, lse, delta = flash_by_head(torch, FLASH_LONG, seed=4)

    def plain_dkv():  # head by head: the plain fp32 scores of all 12 heads would take 51 GB
        for h in range(hq):
            hk = h // group
            fa.reference_flash_bwd_dkv(q[:, h:h + 1], k[:, hk:hk + 1], v[:, hk:hk + 1], w[:, h:h + 1],
                                       lse[:, h:h + 1], delta[:, h:h + 1], causal=True)

    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    y_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(y_lib, (ql, kl, vl), w, retain_graph=True), reps=3)
    del y_lib, ql, kl, vl
    calls = {
        "fwd": (lambda: fa.flash_fwd_out_lse(q, k, v, causal=True), None,
                time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
                        reps=3)),
        "dq": (lambda: fa.flash_bwd_dq(q, k, v, w, lse, delta, causal=True), None, lib_bwd),
        "dkv": (lambda: fa.flash_bwd_dkv(q, k, v, w, lse, delta, causal=True), plain_dkv, lib_bwd),
    }
    out = {}
    for name, (kernel, plain, lib) in calls.items():
        flops, nbytes = _flash_work(b, s, hq, hkv, d)[name]
        t = {"shape": f"q[{b},{hq},{s},{d}] k/v[{b},{hkv},{s},{d}] bf16 causal", "ms": time_ms(torch, kernel, reps=3),
             "plain_ms": time_ms(torch, plain, reps=1) if plain is not None else None, "library_ms": lib,
             "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S),
             "bound_by": "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES_S else "bytes"}
        out[f"flash_{name}"] = t
        plain_txt = f"plain (head by head) {t['plain_ms']:.3f} ms, " if plain is not None else ""
        lib_name = "F.scaled_dot_product_attention" if name == "fwd" else "its backward (dq, dk, dv in one call)"
        log(f"[phase 1] flash {name} {t['shape']}: kernel {t['ms']:.3f} ms, {plain_txt}{lib_name} {lib:.3f} ms, "
            f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}); {flops / t['ms'] / 1e9:.1f} TFLOP/s")
    del q, k, v, w, lse, delta
    torch.cuda.empty_cache()
    return out


def _ce_inputs(torch, g, n, v, e, h_dtype, w_dtype, ignored):
    """h ~ N(0, 1) (RMS-normalized hidden states), w ~ N(0, 0.02) (the
    head's init), labels uniform over the vocab with `ignored` rows at -100."""
    h = torch.randn(n, e, generator=g, device="cuda").to(getattr(torch, h_dtype))
    w = (0.02 * torch.randn(v, e, generator=g, device="cuda")).to(getattr(torch, w_dtype))
    labels = torch.randint(0, v, (n,), generator=g, device="cuda")
    if ignored:
        labels[torch.randperm(n, generator=g, device="cuda")[:ignored]] = -100
    return h, w, labels


def _ce_check(torch, h, w, labels, what: str, drop_tile=None, drop_tokens=None, drop_vocab=None,
              drop_slice=None) -> dict:
    """The kernels against the plain version on the same inputs: lse, corr
    and total (FusedCEFn) against reference_fused_ce_forward; dh and dW (one
    backward of total) against autograd of plain_sum_and_count in fp32, per
    row; every kernel twice, bitwise. The gradients are those of the
    sum, not of the mean: their rows are O(1), where the row check's
    absolute floor (1e-5 sqrt(E)) would hide the rows of the mean's (1/count
    smaller). With `drop_tile`, the dh check must reject what a kernel that
    skips vocab columns [drop_tile, drop_tile + 64) (one of its tiles) would
    return; with
    `drop_tokens`, the dW check must reject what a kernel that skips tokens
    [drop_tokens, drop_tokens + 64) would return; with `drop_vocab`, the lse
    check must reject what a forward that skips vocab columns [drop_vocab,
    drop_vocab + 128) would return; with `drop_slice` (columns [c0, c1) of E:
    one cluster rank's slice), the dh and the dW check must each reject what a
    kernel whose partial-s sum leaves that rank's share out would return (dh
    on the first 128 rows, dW on the first 128 vocab rows: one cluster's
    block). Returns the worst errors."""
    from modalities_tpu_torch.ops import fused_ce as fce

    rel_h, rel_w = (CE_ROW_REL[str(t.dtype).removeprefix("torch.")] for t in (h, w))  # by the gradient's dtype
    lse, corr = fce.fused_ce_forward(h, w, labels)
    lse_ref, corr_ref = fce.reference_fused_ce_forward(h, w, labels)
    errs = {"lse": _rel_check(torch, lse, lse_ref, 0.0, 1e-4, f"{what} lse"),
            "corr": _rel_check(torch, corr, corr_ref, 0.0, 1e-4, f"{what} corr")}
    del corr_ref
    again = fce.fused_ce_forward(h, w, labels)
    if not (torch.equal(lse, again[0]) and torch.equal(corr, again[1])):
        raise AssertionError(f"{what}: two forward calls differ")
    del again
    if drop_vocab is not None:  # lse without the columns' share of the exp-sum
        cols = slice(drop_vocab, drop_vocab + 128)
        share = torch.exp(h.float() @ w[cols].float().t() - lse_ref[:, None]).sum(-1)
        mutant = lse_ref + torch.log1p(-share)
        try:
            _rel_check(torch, mutant, lse_ref, 0.0, 1e-4, "mutant")
        except AssertionError as e:
            errs["mutant_fwd"] = f"rejected ({e})"
        else:
            raise AssertionError(f"{what}: the lse check passes a forward with vocab columns {cols} dropped")
        del share, mutant
    hl, wl = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    total, count = fce.FusedCEFn.apply(hl, wl, labels, -100)
    total.backward()
    hp, wp = h.float().requires_grad_(True), w.float().requires_grad_(True)
    total_ref, count_ref = fce.plain_sum_and_count(hp, wp, labels)
    total_ref.backward()
    torch.cuda.synchronize()
    total, total_ref = float(total.detach()), float(total_ref.detach())
    errs["total"] = abs(total - total_ref) / max(abs(total_ref), 1e-30)
    if float(count) != float(count_ref) or errs["total"] > 1e-5:
        raise AssertionError(f"{what}: total {float(total)} count {float(count)} vs plain {float(total_ref)} "
                             f"{float(count_ref)}")
    if hl.grad.dtype != h.dtype or wl.grad.dtype != w.dtype:
        raise AssertionError(f"{what}: gradient dtypes {hl.grad.dtype}/{wl.grad.dtype} for {h.dtype}/{w.dtype}")
    errs["dh"] = _row_check(torch, hl.grad, hp.grad, rel_h, f"{what} dh")
    errs["dw"] = _row_check(torch, wl.grad, wp.grad, rel_w, f"{what} dW")
    for name, got, want, rel in (("dh", hl.grad, hp.grad, rel_h), ("dw", wl.grad, wp.grad, rel_w)):
        # the floor: the exact gradient's own rounding to the output dtype; and where the kernel's rounding differs
        errs[f"{name}_floor"] = _row_check(torch, want.to(got.dtype), want, rel, f"{what} {name} rounded")[0]
        errs[f"{name}_flips"] = float((got.float() != want.to(got.dtype).float()).float().mean())
    gm = (labels != -100).float()
    if drop_tile is not None:
        cols = slice(drop_tile, drop_tile + 64)
        ds = torch.exp(hp.detach() @ wp.detach()[cols].t() - lse_ref[:, None])
        hit = (labels >= drop_tile) & (labels < drop_tile + 64)
        ds[hit, labels[hit] - drop_tile] -= 1.0
        mutant = hp.grad - (ds * gm[:, None]) @ wp.detach()[cols]
        try:
            _row_check(torch, mutant, hp.grad, rel_h, "mutant")
        except AssertionError as e:
            errs["mutant"] = f"{int(hit.sum())} rows with their label in the tile; rejected ({e})"
        else:
            raise AssertionError(f"{what}: the dh row check passes a dh with vocab columns {cols} dropped")
        del ds, mutant
    if drop_tokens is not None:
        rows = slice(drop_tokens, drop_tokens + 64)
        ds = torch.exp(hp.detach()[rows] @ wp.detach().t() - lse_ref[rows, None])
        lab = labels[rows]
        hit = lab >= 0
        ds[torch.arange(64, device=ds.device)[hit], lab[hit]] -= 1.0
        mutant = wp.grad - (ds * gm[rows, None]).t() @ hp.detach()[rows]
        try:
            _row_check(torch, mutant, wp.grad, rel_w, "mutant")
        except AssertionError as e:
            errs["mutant_dw"] = f"rejected ({e})"
        else:
            raise AssertionError(f"{what}: the dW row check passes a dW with tokens {rows} dropped")
        del ds, mutant
    if drop_slice is not None:
        sl = slice(*drop_slice)
        hd, wd = hp.detach(), wp.detach()

        def ds_without_slice(hr, wr, lse_r, lab):  # ds of rows hr against vocab rows wr, s missing the slice
            ds = torch.exp(hr @ wr.t() - hr[:, sl] @ wr[:, sl].t() - lse_r[:, None])
            hit = (lab >= 0) & (lab < wr.shape[0])
            ds[torch.arange(hr.shape[0], device=ds.device)[hit], lab[hit]] -= 1.0
            return ds

        rows = slice(0, 128)
        mutant = (ds_without_slice(hd[rows], wd, lse_ref[rows], labels[rows]) * gm[rows, None]) @ wd
        vocab = slice(0, 128)
        mutant_w = (ds_without_slice(hd, wd[vocab], lse_ref, labels) * gm[:, None]).t() @ hd
        for name, got, want, rel in (("mutant_slice_dh", mutant, hp.grad[rows], rel_h),
                                     ("mutant_slice_dw", mutant_w, wp.grad[vocab], rel_w)):
            try:
                _row_check(torch, got, want, rel, "mutant")
            except AssertionError as e:
                errs[name] = f"rejected ({e})"
            else:
                raise AssertionError(f"{what}: the {name[-2:]} row check passes a kernel that leaves columns "
                                     f"{drop_slice} of E out of the partial-s sum")
        del mutant, mutant_w
    del hp, wp, total_ref, lse_ref
    for fn, name in ((fce.fused_ce_backward_dh, "dh"), (fce.fused_ce_backward_dw, "dW")):
        if not torch.equal(fn(h, w, labels, lse, gm), fn(h, w, labels, lse, gm)):
            raise AssertionError(f"{what}: two {name} calls differ")
    return errs


def phase_fused_ce(torch) -> dict:
    """The three fused-CE kernels against their plain versions: small f32 and
    bf16 cases (ragged rows and vocab, ignored rows, all rows ignored), then
    the 32k training shape and the 7B's two (CE_7B_SHAPES) in bf16, with
    their times."""
    from modalities_tpu_torch.ops import fused_ce as fce

    g = torch.Generator(device="cuda").manual_seed(5)
    worst: dict[str, dict[str, Any]] = {}
    for n, v, e, hd, wd, ignored in CE_SMALL:
        what = f"fused CE h {hd} w {wd} N={n} V={v} E={e} ignored={ignored}"
        errs = _ce_check(torch, *_ce_inputs(torch, g, n, v, e, hd, wd, ignored), what)
        key = f"h {hd} w {wd}"
        for name, err in errs.items():  # dh/dW: the worst row's relative error
            slot = worst.setdefault(key, {})
            slot[name] = max(slot.get(name, 0.0), err[0] if isinstance(err, tuple) else err)
    log(f"[phase 1] fused CE: {len(CE_SMALL)} small cases (ragged rows and vocab, ignored rows, all ignored; "
        f"f32 path and bf16 path, E up to 4096) agree with the plain version: {worst} (lse/corr max abs err, "
        f"bound 1e-4; dh/dW worst row rel err, bound by the gradient's dtype {CE_ROW_REL}); all three kernels "
        f"bitwise repeatable")
    out: dict[str, dict[str, Any]] = {}
    for shape in (CE_SHAPE, *CE_7B_SHAPES):
        for name, (t, err) in _ce_shape(torch, g, *shape).items():
            entry = out.setdefault(f"fused_ce_{name}", {"max_abs_err": 0.0, "timings": []})
            entry["timings"].append(t)
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return out


def _ce_shape(torch, g, n: int, v: int, e: int) -> dict[str, tuple[dict, float]]:
    """One bf16 shape: `_ce_check` with every mutant (vocab columns dropped
    from the forward, a vocab tile from dh, a token tile from dW, one cluster
    rank's E-slice from dh and dW), then each kernel's time beside the plain
    version, the library's call and the bound. Returns {kernel: (timing,
    max abs err)}."""
    import torch.nn.functional as F

    from modalities_tpu_torch.ops import fused_ce as fce

    h, w, labels = _ce_inputs(torch, g, n, v, e, "bfloat16", "bfloat16", n // 16)
    cl = fce.clusters("dh", e)[0]  # dW's clusters split E alike
    rank = cl // 2 + 1  # a middle rank's slice of E
    drop_slice = (rank * e // cl, (rank + 1) * e // cl)
    what = f"fused CE bf16 h[{n},{e}] w[{v},{e}], {n // 16} rows ignored"
    errs = _ce_check(torch, h, w, labels, what, drop_tile=64 * (v // 128), drop_tokens=64 * (n // 128),
                     drop_vocab=128 * (v // 256), drop_slice=drop_slice)
    torch.cuda.empty_cache()
    log(f"[phase 1] {what}: lse max abs err {errs['lse']:.3g}, corr {errs['corr']:.3g} (bound 1e-4); total rel "
        f"err {errs['total']:.3g} (bound 1e-5); gradients of the total: worst row rel err (share of allowance used) "
        f"dh {errs['dh'][0]:.4g} ({errs['dh'][1]:.2f}), dW {errs['dw'][0]:.4g} ({errs['dw'][1]:.2f}), bound "
        f"{CE_ROW_REL['bfloat16']:g}; the fp32 plain gradient rounded to bf16 has worst rows dh "
        f"{errs['dh_floor']:.4g}, dW {errs['dw_floor']:.4g}; elements unequal to it: dh {errs['dh_flips']:.4g}, "
        f"dW {errs['dw_flips']:.4g}; all three kernels bitwise repeatable; a forward that skips vocab columns "
        f"[{128 * (v // 256)}, {128 * (v // 256) + 128}): {errs['mutant_fwd']}; a dh that skips vocab columns "
        f"[{64 * (v // 128)}, {64 * (v // 128) + 64}): {errs['mutant']}; a dW that skips tokens "
        f"[{64 * (n // 128)}, {64 * (n // 128) + 64}): {errs['mutant_dw']}; a dh / dW whose partial-s sum "
        f"leaves out cluster rank {rank} of {cl} (E columns {drop_slice}): {errs['mutant_slice_dh']} / "
        f"{errs['mutant_slice_dw']}")
    lse, _ = fce.fused_ce_forward(h, w, labels)
    mask = (labels != -100).float()
    gm = mask / mask.sum()
    hl, wl = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    loss_lib = F.cross_entropy(F.linear(hl, wl).float(), labels, ignore_index=-100, reduction="sum")
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(loss_lib, (hl, wl), retain_graph=True), reps=3)
    del loss_lib
    torch.cuda.empty_cache()
    loss_w = F.cross_entropy(F.linear(h, wl).float(), labels, ignore_index=-100, reduction="sum")  # h: no grad
    lib_dw = time_ms(torch, lambda: torch.autograd.grad(loss_w, (wl,), retain_graph=True), reps=3)
    del loss_w
    torch.cuda.empty_cache()
    loss_h = F.cross_entropy(F.linear(hl, w).float(), labels, ignore_index=-100, reduction="sum")  # W: no grad
    lib_dh = time_ms(torch, lambda: torch.autograd.grad(loss_h, (hl,), retain_graph=True), reps=3)
    del loss_h
    torch.cuda.empty_cache()
    lib_fwd = time_ms(torch, lambda: F.cross_entropy(F.linear(h, w).float(), labels, ignore_index=-100,
                                                     reduction="sum"), reps=3)
    plain_bwd = time_ms(torch, lambda: fce.reference_fused_ce_backward(h, w, labels, lse, gm), reps=2)
    flops = 2.0 * n * v * e  # one h . W^T over every (row, vocab) pair
    nbytes = {"fwd": 2 * (n + v) * e + 4 * n + 2 * 4 * n, "dh": 2 * (n + v) * e + 3 * 4 * n + 2 * n * e,
              "dw": 2 * (n + v) * e + 3 * 4 * n + 2 * v * e}
    calls = {
        "fwd": (lambda: fce.fused_ce_forward(h, w, labels), lambda: fce.reference_fused_ce_forward(h, w, labels),
                lib_fwd, flops),
        "dh": (lambda: fce.fused_ce_backward_dh(h, w, labels, lse, gm), None, lib_dh, 2 * flops),
        "dw": (lambda: fce.fused_ce_backward_dw(h, w, labels, lse, gm), None, lib_dw, 2 * flops),
    }
    out = {}
    for name, (kernel, plain, lib, ops) in calls.items():
        t = {"shape": f"h[{n},{e}] w[{v},{e}] bf16", "ms": time_ms(torch, kernel, reps=3),
             "plain_ms": time_ms(torch, plain, reps=2) if plain is not None else plain_bwd, "library_ms": lib,
             "bound_ms": 1e3 * max(ops / PEAK_BF16_FLOPS, nbytes[name] / PEAK_BYTES_S),
             "bound_by": "operations" if ops / PEAK_BF16_FLOPS >= nbytes[name] / PEAK_BYTES_S else "bytes"}
        max_abs = max(errs["lse"], errs["corr"]) if name == "fwd" else errs[name][2]
        out[name] = (t, max_abs)
        lib_name = {"fwd": "F.linear (bf16) + fp32 F.cross_entropy(reduction='sum')",
                    "dh": f"its dh alone (W not requiring grad; dh and dW: {lib_bwd:.3f} ms)",
                    "dw": f"its dW alone (h not requiring grad; dh and dW: {lib_bwd:.3f} ms)"}[name]
        plain_name = "plain" if name == "fwd" else "plain backward (dh and dW together)"
        log(f"[phase 1] fused CE {name} {t['shape']}: kernel {t['ms']:.3f} ms, {plain_name} {t['plain_ms']:.3f} ms, "
            f"{lib_name} {lib:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"{ops / t['ms'] / 1e9:.1f} TFLOP/s")
    del h, w, labels, lse, gm, hl, wl
    torch.cuda.empty_cache()
    return out


def _tiny_train_parts(dtype: str = "float32", attention: str = "dao_flash", width: int = 128, heads=(4, 2),
                      seq: int = 64):
    """A tiny GPT2 (2 layers) with the 2.7B config's kind of optimizer,
    schedule and clipper: params and compute in `dtype`, fp32 accumulation."""
    from modalities_tpu_torch.loss_functions import CLMCrossEntropyLoss
    from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM, MixedPrecisionSpec
    from modalities_tpu_torch.optimizers.optimizer_factory import OptimizerFactory
    from modalities_tpu_torch.optimizers.scheduler_factory import LinearWarmupCosineAnnealingLRScheduler
    from modalities_tpu_torch.training.gradient_clipping import GradientClipper

    cfg = dict(MODEL_2P7B, vocab_size=256, n_layer=2, n_head_q=heads[0], n_head_kv=heads[1], n_embd=width,
               ffn_hidden=2 * width, sequence_length=seq, attention_implementation=attention)
    for key in ("attention_norm_config", "ffn_norm_config", "lm_head_norm_config"):
        cfg[key] = {"norm_type": "rms_norm", "config": {"ndim": width, "bias": False, "epsilon": 1e-5}}
    cfg["attention_config"] = {"qkv_transforms": [{"type_hint": "RotaryTransform",
                                                   "config": {"n_embd": width, "n_head": heads[0]}}]}
    model = GPT2LLM(**cfg).update_train_spec(mixed_precision=MixedPrecisionSpec(dtype, dtype, "float32"))
    opt = OptimizerFactory.get_adam_w(1e-3, (0.9, 0.95), 1e-8, 0.1, ["embedding", "norm"], model)
    sched = LinearWarmupCosineAnnealingLRScheduler(opt, warmup_steps=2, total_steps=10, initial_lr=0.0,
                                                   final_lr=1e-4, max_lr=1e-3)
    return model, CLMCrossEntropyLoss("target_ids", "logits"), opt, sched, GradientClipper(max_norm=1.0)


def phase_small_model_training(torch) -> None:
    """3 optimizer steps (2 microbatches each) of a tiny f32 GPT2 on the card
    (flash and RMSNorm kernels) and on the CPU (plain versions) from the same
    parameters: per-step losses, grad norms and the final parameters agree."""
    from modalities_tpu_torch.training.train_step import TrainStep

    params = _tiny_train_parts()[0].init_train_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, size=(3, 2, 2, 65))
    runs = {}
    for dev in ("cpu", "cuda"):
        model, loss_fn, opt, sched, clip = _tiny_train_parts()
        step = TrainStep(model, loss_fn, opt, sched, device=dev, gradient_acc_steps=2, grad_clipper=clip,
                         params={k: v.clone() for k, v in params.items()})
        metrics = []
        for t in tokens:
            t = torch.as_tensor(t, device=dev)
            m = step({"samples": {"input_ids": t[..., :-1]}, "targets": {"target_ids": t[..., 1:]}})
            metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        runs[dev] = (np.asarray(metrics), {k: v.detach().cpu() for k, v in step.state_dict().items()})
    (m_cpu, p_cpu), (m_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    if not np.allclose(m_gpu, m_cpu, rtol=0, atol=1e-4):
        raise AssertionError(f"small GPT2 training: card metrics {m_gpu.tolist()} vs CPU {m_cpu.tolist()}")
    err = max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    if err > 1e-4:
        raise AssertionError(f"small GPT2 training: parameters differ by {err:g} after 3 steps")
    log(f"[phase 1] small GPT2 training (f32, dao_flash, 2 layers, D 32; 3 steps x 2 microbatches, AdamW, "
        f"warmup-cosine, clip 1.0): card and CPU agree, losses {m_gpu[:, 0].round(6).tolist()}, "
        f"max |metric diff| {float(np.abs(m_gpu - m_cpu).max()):g}, max |param diff| {err:g} (atol 1e-4)")


@contextlib.contextmanager
def plain_norms():
    """RMSNorm layers take autograd of the plain `reference_rms_norm` on the
    card while the context lasts: the plain path that the kernels are held
    to, for comparisons only (the port itself has no such switch)."""
    from modalities_tpu_torch.models.components import layer_norms
    from modalities_tpu_torch.ops.rmsnorm import reference_rms_norm

    saved, layer_norms.fused_rms_norm = layer_norms.fused_rms_norm, reference_rms_norm
    try:
        yield
    finally:
        layer_norms.fused_rms_norm = saved


def _rel_norm(torch, a, b) -> float:
    """||a - b|| / ||b||."""
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def phase_small_model_training_bf16(torch) -> None:
    """The bf16 training path against the plain path on the same card: a tiny
    bf16 GPT2 (2 layers, width 640, head dim 80 and GQA 8/2 as in the 2.7B, 256 tokens: four
    key tiles and causal tile skipping) from the same parameters, once through
    the kernels (dao_flash, fused RMSNorm) and once through the plain path
    (manual attention, autograd of the plain RMSNorm). The first microbatch's
    gradients, each of 3 steps' loss and grad norm (2 microbatches each) and
    how far the steps moved each parameter agree within TINY_BF16_TOL."""
    from modalities_tpu_torch.training.train_step import TrainStep

    shape = {"width": 640, "heads": (8, 2), "seq": 256}
    params = _tiny_train_parts("bfloat16", **shape)[0].init_train_params(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(6).integers(0, 256, size=(3, 2, 2, 257)), device="cuda")
    runs = {}
    for arm, attention in (("kernels", "dao_flash"), ("plain", "manual")):
        model, loss_fn, opt, sched, clip = _tiny_train_parts("bfloat16", attention, **shape)
        with plain_norms() if arm == "plain" else contextlib.nullcontext():
            _reset_counts()
            step = TrainStep(model, loss_fn, opt, sched, device="cuda", gradient_acc_steps=2, grad_clipper=clip,
                             params={k: v.clone() for k, v in params.items()})
            first = tokens[0, 0]
            loss = loss_fn({"logits": step.module(first[:, :-1])}, {"target_ids": first[:, 1:]})
            grads = [g.float() for g in torch.autograd.grad(loss, step.params)]
            metrics = []
            for t in tokens:
                m = step({"samples": {"input_ids": t[..., :-1]}, "targets": {"target_ids": t[..., 1:]}})
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
            torch.cuda.synchronize()
            launched = _launch_counts()
        runs[arm] = (grads, np.asarray(metrics), {k: v.detach().float() for k, v in step.state_dict().items()},
                     launched)
    (g_k, m_k, p_k, n_k), (g_p, m_p, p_p, n_p) = runs["kernels"], runs["plain"]
    if any(v for v in n_p.values()) or not all(n_k.values()):
        raise AssertionError(f"tiny bf16 training: launches with the kernels {n_k}, on the plain path {n_p}")
    p0 = {k: v.to("cuda").float() for k, v in params.items()}
    seen = {
        "grads": max(_rel_norm(torch, a, b) for a, b in zip(g_k, g_p)),
        "loss": float(np.abs(m_k[:, 0] / m_p[:, 0] - 1).max()),
        "grad_norm": float(np.abs(m_k[:, 1] / m_p[:, 1] - 1).max()),
        "params": max(_rel_norm(torch, p_k[k] - p0[k], p_p[k] - p0[k]) for k in p0),
    }
    log(f"[phase 1] tiny bf16 GPT2 training, kernels vs the plain path on the card (3 steps x 2 microbatches): "
        f"losses {m_k[:, 0].round(5).tolist()} vs {m_p[:, 0].round(5).tolist()}, grad norms "
        f"{m_k[:, 1].round(5).tolist()} vs {m_p[:, 1].round(5).tolist()}; worst per-tensor ||g_k - g_p|| / ||g_p|| "
        f"of the first microbatch {seen['grads']:.4g}, worst loss rel diff {seen['loss']:.4g}, grad norm "
        f"{seen['grad_norm']:.4g}, worst per-tensor ||move_k - move_p|| / ||move_p|| {seen['params']:.4g}; "
        f"bounds {TINY_BF16_TOL}")
    for key, bound in TINY_BF16_TOL.items():
        if not seen[key] <= bound:
            raise AssertionError(f"tiny bf16 training: {key} differ by {seen[key]:g}, bound {bound:g}")


# ---------------------------------------------------------------- phase 4
def _train_config(tmp: Path, name: str, corpus: np.ndarray, steps: int, extra: dict, seq: int = 4096,
                  base: str = "config_2p7b_dp.yaml", micro: int = 2, acc: int = 2, phase: str = "phase 4",
                  keep_checkpointing: bool = False) -> Path:
    """A copy of configs/`base` cut to one card (micro x acc sequences of
    `seq` a step); prints every override. The checkpointing interval is put
    out of reach unless `keep_checkpointing` (then the file's interval, k
    and last-step rule stand)."""
    import yaml

    repo = Path(__file__).resolve().parent
    cfg = yaml.safe_load((repo / "configs" / base).read_text())
    from modalities_tpu_torch.dataloader.packed_data import write_pbin_file

    data = tmp / f"{name}.pbin"
    write_pbin_file(data, [corpus], 2)
    per_step = micro * acc * seq
    overrides = {
        "settings.step_profile.sequence_length": seq,
        "device_mesh.config.data_parallel_shard_degree": 1,
        "device_mesh.config.world_size": 1,
        "settings.step_profile.local_train_micro_batch_size": micro,
        "settings.step_profile.gradient_accumulation_steps": acc,
        "settings.training_target.num_target_steps": steps,
        "settings.training_target.num_target_tokens": steps * per_step,
        "settings.intervals.training_log_interval_in_steps": 1,
        "settings.intervals.evaluation_interval_in_steps": steps,
        **({} if keep_checkpointing else {"settings.intervals.checkpointing_interval_in_steps": 1_000_000,
                                          "settings.consistency_enforcement.enforce_last_step_checkpointed": False}),
        "settings.paths.train_dataset_path": str(data),
        "settings.paths.checkpoint_saving_path": str(tmp / "checkpoints"),
        "settings.paths.experiments_root_path": str(tmp / "experiments"),
        **extra,
    }
    for dotted, value in overrides.items():
        node = cfg
        *parents, leaf = dotted.split(".")
        for key in parents:
            node = node[key]
        node[leaf] = value
        log(f"[{phase}] {name}: {dotted} = {value}")
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def remat_launches(layers: int) -> dict[str, int]:
    """Kernel launches a step of a one-sequence, full-remat, fused-CE config
    (the 32k config, the 7B warmstart) at `layers`: remat runs every block's
    forward twice (flash and both block norms), the head norm and CE once."""
    return {"flash_fwd": 2 * layers, "flash_dq": layers, "flash_dkv": layers, "rms_fwd": 4 * layers + 1,
            "rms_bwd": 2 * layers + 1, "ce_fwd": 1, "ce_dh": 1, "ce_dw": 1}


def _launch_counts(keys=TRAIN_KERNELS) -> dict[str, int]:
    from modalities_tpu_torch.ops import launch_counts

    counts = launch_counts()
    return {k: counts[k] for k in keys}


def _reset_counts() -> None:
    from modalities_tpu_torch.ops import flash_attention as fa
    from modalities_tpu_torch.ops import fused_ce as fce
    from modalities_tpu_torch.ops.rmsnorm import rms_norm, rms_norm_backward

    fa.flash_fwd_out_lse.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
    rms_norm.launches = rms_norm_backward.launches = 0
    fce.fused_ce_forward.launches = fce.fused_ce_backward_dh.launches = fce.fused_ce_backward_dw.launches = 0


def fsdp_witness(torch, cfg: Path, tmp: Path, sharded: list[dict], want_step0: str, phase: str,
                 telemetry_off: bool = False) -> None:
    """The same config and data through Main with its train step built without
    a mesh (no fully_shard, no collective: the port's world-1 step before
    FSDP2): every step's loss, grad norm and lr must equal the sharded run's
    (`sharded`, run on the world-1 NCCL group) bitwise, and step 0's loss
    must print as `want_step0` (the value the unsharded kernels' path gives).
    With `telemetry_off` the witness runs with `telemetry: {enabled: false}`
    (the sharded run had the default telemetry and its capture windows): the
    same bits then also show that telemetry changes no step."""
    from modalities_tpu_torch.main import Main
    from modalities_tpu_torch.training.train_step import TrainStep

    main = Main(cfg, experiments_root_path=tmp / "experiments", device="cuda")
    if telemetry_off:
        main.config_dict["telemetry"] = {"component_key": "telemetry", "variant_key": "default",
                                         "config": {"enabled": False}}

    def unsharded(components):
        app_state = components.app_state
        return TrainStep(app_state.model, components.loss_fn, app_state.optimizer, app_state.lr_scheduler,
                         device=main.device,
                         gradient_acc_steps=components.settings.step_profile.gradient_accumulation_steps,
                         grad_clipper=components.gradient_clipper)

    main.build_train_step = unsharded
    plain = _step_metrics(main.run())
    got = _step_metrics(sharded)
    if telemetry_off and (main.telemetry.enabled or main.telemetry.sink_path is not None):
        raise AssertionError(f"{phase}: the witness's telemetry is on")
    del main
    gc.collect()
    torch.cuda.empty_cache()
    step0 = f"{got[1][0]:.5f}"
    if got != plain or step0 != want_step0:
        raise AssertionError(f"{phase}: fully_shard on the world-1 group {got} != without it {plain}, or step 0's "
                             f"loss {step0} != {want_step0}")
    log(f"[{phase}] fully_shard on a world-1 NCCL group: steps 1-{len(got)} (loss, grad norm, lr) "
        f"{[got[k] for k in sorted(got)]} bitwise those of the same run without fully_shard; step 0's loss "
        f"{step0} as the unsharded path gives it"
        + ("; the witness ran with telemetry off, the sharded run with the default telemetry, its profiler "
           "window and its snapshot: telemetry changed no bit" if telemetry_off else ""))


def _tp_one_mesh():
    """The port's DeviceMesh on the world-1 group with its tp axis built at
    size 1 ((dp_shard 1, tp 1)) and loss parallelism on. The config's
    validator, as the JAX one, builds no size-1 axis and wants tp > 1 for
    loss parallelism; here the train step still takes the tensor-parallel
    route with every exchange over one rank."""
    from modalities_tpu_torch.running_env.device_mesh import DeviceMesh

    class TpOne(DeviceMesh):
        @property
        def mesh_axes(self) -> dict[str, int]:
            return {"dp_shard": 1, "tp": 1}

    mesh = TpOne(world_size=1)
    mesh.enable_loss_parallel = True
    return mesh


def tp_one_witness(torch, cfg: Path, tmp: Path, reference: list[dict], counts: dict[str, int], phase: str) -> None:
    """The same config and data through Main with its train step built over
    a (dp_shard 1, tp 1) mesh with loss parallelism (`_tp_one_mesh`): the
    tensor-parallel plan applies on the card (the parameters become DTensors
    over tp, FSDP2 shards them over dp_shard of the same 2-D mesh, the
    module bodies and kernel wrappers see their local tensors, the
    vocab-parallel lookup, the loss-parallel CE or the fused-CE head on
    vocab shards, the tp sum of the replicated gradients). Its launches must
    equal the path's (`counts`), and each step's loss and grad norm must be
    within TP_ONE_TOL of the path's run (`reference`; the grad norm
    relative), its lr equal: the loss-parallel CE sums its exponentials, and
    the global norm its tp-sharded and tp-replicated gradients, in another
    order than the unsharded route."""
    from torch.distributed.tensor import DTensor

    from modalities_tpu_torch.main import Main
    from modalities_tpu_torch.training.train_step import TrainStep

    main = Main(cfg, experiments_root_path=tmp / "experiments", device="cuda")

    def over_tp_one(components):
        app_state = components.app_state
        return TrainStep(app_state.model, components.loss_fn, app_state.optimizer, app_state.lr_scheduler,
                         device=main.device,
                         gradient_acc_steps=components.settings.step_profile.gradient_accumulation_steps,
                         grad_clipper=components.gradient_clipper, device_mesh=_tp_one_mesh())

    main.build_train_step = over_tp_one
    _reset_counts()
    got = _step_metrics(main.run())
    launched = _launch_counts(tuple(counts))
    module = main.train_step.module
    kernel = module.blocks[0].attn.q_attn.kernel
    route = "the fused-CE head on vocab shards" if main.train_step.fused_ce else "the loss-parallel CE on fp32 logits"
    placed = (isinstance(kernel, DTensor) and kernel.device_mesh.mesh_dim_names == ("dp_shard", "tp")
              and module.tp is not None and module.tp.loss_parallel)
    del main, module, kernel
    gc.collect()
    torch.cuda.empty_cache()
    want = _step_metrics(reference)
    diffs = {k: (abs(got[k][0] - want[k][0]), abs(got[k][1] - want[k][1]) / want[k][1]) for k in want if k in got}
    worst = max(max(d) for d in diffs.values()) if diffs else math.inf
    if (not placed or launched != counts or sorted(got) != sorted(want) or worst > TP_ONE_TOL
            or any(got[k][2] != want[k][2] for k in want)):
        raise AssertionError(f"{phase}: the tp plan on a (dp_shard 1, tp 1) mesh: placed {placed}, launches "
                             f"{launched} (the path's {counts}), steps {got} against {want} (bound {TP_ONE_TOL:g})")
    log(f"[{phase}] the same run with the tp plan applied on a (dp_shard 1, tp 1) mesh of the world-1 NCCL group, "
        f"loss parallelism on ({route}; parameters DTensors over (dp_shard, tp)): launches {launched}, as the "
        f"path's; steps 1-{len(got)} (loss, grad norm, lr) {[got[k] for k in sorted(got)]}; largest |loss diff| "
        f"{max(d[0] for d in diffs.values()):.3g}, grad norm rel diff {max(d[1] for d in diffs.values()):.3g} "
        f"(bound {TP_ONE_TOL:g}); bitwise the path's: {got == want}")


def _profiled(torch, fn) -> tuple[list[tuple[float, int, str]], float, float]:
    """fn() under torch.profiler: its kernels as (device ms, launches, name),
    most time first; their summed device ms; the wall ms. Kernels only: user
    annotations (Optimizer.step#...) also carry device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - w0)
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        annotation = getattr(ev, "is_user_annotation", False) or "#" in ev.key
        if ev.device_type == DeviceType.CUDA and dev_us > 0 and not annotation:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows), wall_ms


def profile_train_step(torch, main, smi: str, phase: str = "phase 4") -> None:
    """One warm train step under torch.profiler: device busy share and the top
    device ops (informational)."""
    from modalities_tpu_torch.trainer import stack_microbatches

    loader = iter(main.components.train_dataloader)
    batch = stack_microbatches([next(loader) for _ in range(main.train_step.acc_steps)], torch.device("cuda"))
    main.train_step(batch)
    rows, device_ms, wall_ms = _profiled(torch, lambda: main.train_step(batch))
    log(f"[{phase}] profiled step ({smi}): {device_ms:.1f} ms of kernels ({sum(r[1] for r in rows)} launches) "
        f"in a {wall_ms:.1f} ms step under the profiler -> device busy {device_ms / wall_ms:.3f} (informational)")
    for ms, count, key in rows[:12]:
        log(f"[{phase}]   {ms:.2f} ms in {count} x {key[:100]}")
    for name, marks in (("RMSNorm forward", ("rms_norm_fwd",)), ("RMSNorm backward", ("rms_norm_bwd", "column_sum"))):
        mine = [r for r in rows if any(m in r[2] for m in marks)]
        log(f"[{phase}]   {name}: {sum(r[0] for r in mine):.3f} ms in {sum(r[1] for r in mine)} launches "
            f"({', '.join(f'{r[1]} x {r[2][:60]} {r[0]:.3f} ms' for r in mine)})")


def lr_witness(torch, tmp: Path, rng, n_layer: int, seq: int, *, lr: float, vocab: int, keys, phase: str,
               plain_extra: dict, fp32_arm: bool = False, **shape) -> None:
    """The config's `lr` with no warmup (warmup_steps 1, then its cosine) on
    one repeated batch, at full width and `n_layer` layers x `seq`, through
    Main twice from the same seed: with the kernels (dao_flash, fused RMSNorm
    and whatever else the config runs; `keys` name their counters) and with
    the plain path on the card (manual attention, autograd of the plain
    RMSNorm, and `plain_extra`'s overrides). `shape` goes to _train_config.
    The two loss curves agree within LR_WITNESS_TOL at every step, whether or
    not they fall. With `fp32_arm`, a third run takes the plain path with
    parameters and compute in float32: its gap to the plain bf16 run (printed,
    gating nothing) is how far bf16 rounding alone moves the curve on any
    path, the yardstick for the kernels' gap."""
    from modalities_tpu_torch.main import Main
    from modalities_tpu_torch.models.gpt2.gpt2_model import MixedPrecisionSpec

    repeat = np.tile(rng.integers(0, vocab, size=seq), 24)[: seq + 1 + 19 * seq]
    extra = {"scheduler.config.warmup_steps": 1, "scheduler.config.initial_lr": lr, "model_raw.config.n_layer": n_layer}
    curves, launched = {}, {}
    arms = [("kernels", "dao_flash"), ("plain", "manual")] + ([("plain_fp32", "manual")] if fp32_arm else [])
    for arm, attention in arms:
        name = f"witness_{n_layer}x{seq}_{arm}"
        arm_extra = {**extra, "model_raw.config.attention_implementation": attention,
                     **(plain_extra if arm != "kernels" else {})}
        cfg = _train_config(tmp, name, repeat, 5, arm_extra, seq=seq, phase=phase, **shape)
        with plain_norms() if arm != "kernels" else contextlib.nullcontext():
            _reset_counts()
            main = Main(cfg, experiments_root_path=tmp / "experiments", device="cuda")
            components = main.build_components()
            if arm == "plain_fp32":  # the config's policy has no compute dtype: set both on the model's spec
                components.app_state.model.update_train_spec(
                    mixed_precision=MixedPrecisionSpec("float32", "float32", "float32"))
            curves[arm] = [r["losses"]["train loss last"] for r in main.run(components)]
            launched[arm] = _launch_counts(keys)
        del main, components
        gc.collect()
        torch.cuda.empty_cache()
    if any(any(launched[arm].values()) for arm in curves if arm != "kernels") or not all(launched["kernels"].values()):
        raise AssertionError(f"lr witness: launches by arm {launched}")
    k, p = curves["kernels"], curves["plain"]
    diff = max(abs(a - b) for a, b in zip(k, p))
    falls = {arm: all(b < a for a, b in zip(c, c[1:])) for arm, c in curves.items()}
    fp32_txt = ""
    if fp32_arm:
        f32 = curves["plain_fp32"]
        fp32_txt = (f"; plain path in fp32 {[round(x, 5) for x in f32]}, its max |loss diff| to the plain bf16 path "
                    f"{max(abs(a - b) for a, b in zip(f32, p)):.4g} and to the kernels "
                    f"{max(abs(a - b) for a, b in zip(f32, k)):.4g} (informational)")
    log(f"[{phase}] lr witness, {n_layer} layers x seq {seq}, lr {lr:g} with no warmup on one "
        f"repeated batch: "
        f"kernels {[round(x, 5) for x in k]}, plain path {[round(x, 5) for x in p]}; falls at every step: {falls}; "
        f"max |loss diff| {diff:.4g} (bound {LR_WITNESS_TOL:g}){fp32_txt}")
    if not diff <= LR_WITNESS_TOL:
        raise AssertionError(f"lr witness: kernels {k} and plain path {p} differ by {diff:g}")


# phase 4's capture switches: the profiler window at step 2, the allocator snapshot after step 3
CAPTURE_ENV = {"MODALITIES_TPU_PROFILE_AT_STEP": "2", "MODALITIES_TPU_MEMSCOPE_AT_STEP": "3"}
# the JAX trainer's interval keys (modalities_tpu/trainer.py:585-623); the goodput buckets' are added below
INTERVAL_KEYS = ("train steps/s", "tokens/s", "tokens/s (wall)", "tokens/s (device)", "host stall [s]",
                 "boundary stall [s]", "MFU", "MFU (wall)", "MFU (device)", "peak memory [MB]", "HBM headroom [MB]",
                 "goodput [%]")
# a TRAIN_KERNELS counter -> the name its kernel carries in a torch profiler trace (one kernel a launch)
TRACE_NAMES = {"flash_fwd": "flash_fwd_", "flash_dq": "flash_bwd_dq_", "flash_dkv": "flash_bwd_dkv_",
               "rms_fwd": "rms_norm_fwd_", "rms_bwd": "rms_norm_bwd_ring"}
FITS_REFUSED = (4, 4096)  # (microbatch, sequence): the 2.7B without remat at the YAML's own microbatch


@contextlib.contextmanager
def _env(values: dict):
    """Set environment variables for the block, then restore them."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_telemetry(torch, main, results: list[dict], per_step: dict, smi: str, phase: str = "phase 4") -> None:
    """The sharded run's telemetry (the default one, no `telemetry` node):
    every interval carries the JAX trainer's keys; the profiler window's
    Chrome trace exists and holds each kernel of the path at one step's
    launch count; the allocator snapshot exists; `data analyze_telemetry`
    prints the sink's goodput table and waterfall."""
    import io

    from modalities_tpu_torch.__main__ import main as cli
    from modalities_tpu_torch.telemetry.goodput import BUCKETS

    keys = set(INTERVAL_KEYS) | {f"goodput/{bucket} [s]" for bucket in BUCKETS}
    missing = [sorted(keys - set(r["throughput_metrics"])) for r in results]
    if any(missing):
        raise AssertionError(f"{phase}: interval keys missing: {missing}")
    folder = main.telemetry.sink_path.parent
    window = main.trainer.profile_window
    if window is None or window.trace_path is None or not window.trace_path.is_file():
        raise AssertionError(f"{phase}: the profiler window at step 2 left no trace in {sorted(folder.iterdir())}")
    events = json.loads(window.trace_path.read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    in_trace = {key: sum(mark in name for name in kernels) for key, mark in TRACE_NAMES.items()}
    if in_trace != per_step:
        raise AssertionError(f"{phase}: the step-2 trace names the kernels {in_trace} times, one step launches "
                             f"{per_step}")
    snapshot = folder / "memscope_live_arrays_step_3.json"
    blocks = json.loads(snapshot.read_text()) if snapshot.is_file() else {}
    if not blocks.get("count"):
        raise AssertionError(f"{phase}: no allocator snapshot after step 3 ({snapshot}: {blocks})")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli(["data", "analyze_telemetry", "--sink_path", str(folder)])
    table = out.getvalue()
    if code != 0 or "combined goodput" not in table or "MFU waterfall" not in table:
        raise AssertionError(f"{phase}: data analyze_telemetry exit {code}: {table}")
    last = results[-1]["throughput_metrics"]
    log(f"[{phase}] telemetry on (the default): step-2 trace {window.trace_path.name} "
        f"({window.trace_path.stat().st_size} bytes, {len(kernels)} kernels) names the path's kernels {in_trace} "
        f"times, one step's launches; allocator snapshot after step 3: {blocks['count']} blocks, "
        f"{blocks['total_bytes'] / 1e9:.2f} GB; step {results[-1]['num_train_steps_done']}: tokens/s wall "
        f"{last['tokens/s (wall)']:.1f} device {last['tokens/s (device)']:.1f}, host stall {last['host stall [s]']:.4f} s, "
        f"boundary stall {last['boundary stall [s]']:.4f} s, peak memory {last['peak memory [MB]']:.1f} MB, HBM "
        f"headroom {last['HBM headroom [MB]']:.1f} MB, goodput {last['goodput [%]']:.2f} % ({smi}; informational)")
    for line in table.splitlines():
        log(f"[{phase}] analyze_telemetry | {line}")


def memscope_line(torch, main, phase: str) -> None:
    """The static report the trainer's fits check held before the first
    dispatch, its predicted peak beside the run's max_memory_allocated."""
    report = main.trainer.memscope_report
    if report is None:
        raise AssertionError(f"{phase}: no static memory report: the fits check did not run on the card")
    gb = {k: round(v / 1e9, 2) for k, v in report["buckets"].items() if v}
    limit = torch.cuda.mem_get_info()[1]
    log(f"[{phase}] memscope: predicted peak {report['predicted_peak_bytes'] / 1e9:.2f} GB ({gb}) against "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; budget {limit / 1e9:.2f} GB "
        f"(mem_get_info total): fits")


def fits_refusal(torch, main, smi: str) -> None:
    """Phase 4's built step through the trainer's own preflight with the
    microbatch set to FITS_REFUSED (the YAML's 4 x 4096, no remat): the fits
    check must raise before any dispatch, naming its levers."""
    from modalities_tpu_torch.dataloader.dataloader import DatasetBatch
    from modalities_tpu_torch.logging_broker.subscribers import DummySubscriber
    from modalities_tpu_torch.telemetry import Telemetry
    from modalities_tpu_torch.telemetry.memscope import FitsCheckFailure
    from modalities_tpu_torch.trainer import Trainer
    from modalities_tpu_torch.training.training_progress import TrainingProgress

    step = main.train_step
    dispatched: list = []

    class Counted:
        memscope_report = staticmethod(step.memscope_report)

        def __call__(self, batch):
            dispatched.append(batch)
            return step(batch)

    class Loader(list):
        dataloader_tag = "train"

    micro, seq = FITS_REFUSED
    rows = np.zeros((micro, seq), np.int64)
    loader = Loader([DatasetBatch({"input_ids": rows}, {"target_ids": rows})] * step.acc_steps)
    trainer = Trainer(DummySubscriber(), DummySubscriber(), torch.device(TRAIN_DEVICE),
                      gradient_acc_steps=step.acc_steps, global_num_tokens_per_train_step=micro * seq * step.acc_steps,
                      telemetry=Telemetry(enabled=False))
    try:
        trainer.train(Counted(), loader, TrainingProgress(0, 0, 1, micro * seq * step.acc_steps), lambda s: None,
                      lambda p, force=False: None)
    except FitsCheckFailure as e:
        message = str(e)
    else:
        raise AssertionError(f"phase 4: the fits check let {micro} x {seq} without remat through")
    if dispatched or "- remat:" not in message or "- gradient_accumulation_steps:" not in message:
        raise AssertionError(f"phase 4: the fits check at {micro} x {seq}: {len(dispatched)} dispatches, {message}")
    log(f"[phase 4] fits check at {micro} x {seq} without remat, phase 4's built step through the trainer's "
        f"preflight ({smi}): refused before any dispatch: " + " | ".join(message.splitlines()))


def phase_train(torch, smi: str) -> tuple[dict[str, int], dict, float]:
    """The 2.7B training path through Main; returns its kernel launch counts,
    its steps' (loss, grad norm, lr) and its peak GB (max_memory_allocated)."""
    from modalities_tpu_torch.main import Main

    rng = np.random.default_rng(2027)
    seq = 4096
    steps = 3
    scratch = Path(__file__).resolve().parent / "build"  # gitignored, inside the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        corpus = rng.integers(0, MODEL_2P7B["vocab_size"], size=seq + 1 + (4 * steps + 3) * seq)
        cfg = _train_config(tmp, "train", corpus, steps, {})
        torch.cuda.reset_peak_memory_stats()
        main = Main(cfg, experiments_root_path=tmp / "experiments", device="cuda")
        main.components = main.build_components()
        _reset_counts()
        t0 = time.perf_counter()
        with _env(CAPTURE_ENV):  # the default telemetry (no `telemetry` node) and both capture windows
            results = main.run(main.components)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reserved_gb = torch.cuda.max_memory_reserved() / 1e9
        losses = [r["losses"]["train loss last"] for r in results]
        norms = [r["metrics"]["grad norm last"] for r in results]
        if len(results) != steps or not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"training: {len(results)} steps, losses {losses}, grad norms {norms}")
        # random logits of std sigma give an expected loss of ln V + sigma^2 / 2; the head's N(0, 0.02) kernel
        # over RMS-normalized hidden states of width 2560 gives sigma^2 = 2560 * 0.02^2 (the JAX init, too)
        expected = math.log(MODEL_2P7B["vocab_size"]) + MODEL_2P7B["n_embd"] * 0.02**2 / 2
        if abs(losses[0] - expected) > 0.5:
            raise AssertionError(f"training: step 0 loss {losses[0]} not within 0.5 of ln(50304) + "
                                 f"2560 * 0.02^2 / 2 = {expected:.3f}")
        per_step = {"flash_fwd": 64, "flash_dq": 64, "flash_dkv": 64, "rms_fwd": 130, "rms_bwd": 130}
        for key, want in per_step.items():
            if counts[key] != want * steps:
                raise AssertionError(f"training: {key} launched {counts[key]} times in {steps} steps, expected "
                                     f"{want} per step")
        check_telemetry(torch, main, results, per_step, smi)
        memscope_line(torch, main, "phase 4")
        fits_refusal(torch, main, smi)
        log(f"[phase 4] step 0 loss {losses[0]:.5f}: expected {expected:.5f} = ln(50304) + 2560 * 0.02^2 / 2 "
            f"(ln(50304) = {math.log(MODEL_2P7B['vocab_size']):.5f}), within 0.5")
        sharded_results = results
        log(f"[phase 4] 2.7B training through Main: {steps} steps in {wall:.1f} s (build included); losses "
            f"{[round(x, 5) for x in losses]}, grad norms {[round(x, 5) for x in norms]}; launches per step "
            f"{ {k: v // steps for k, v in counts.items()} }; peak memory {peak_gb:.1f} GB "
            f"(torch.cuda.max_memory_allocated), {reserved_gb:.1f} GB reserved (max_memory_reserved)")
        for r in results[1:]:
            th = r["throughput_metrics"]
            log(f"[phase 4] step {r['num_train_steps_done']}: {1e3 / th['train steps/s']:.1f} ms, "
                f"{th['tokens/s']:.1f} tokens/s, MFU {th['MFU']:.4f} vs 989.4 TFLOP/s ({smi}; informational)")
        profile_train_step(torch, main, smi)
        del main, results
        gc.collect()
        torch.cuda.empty_cache()
        fsdp_witness(torch, cfg, tmp, sharded_results, "11.34302", "phase 4", telemetry_off=True)

        # one batch repeated: no warmup (fn(0) = initial_lr, not 0), and an lr of 1.6e-5. At the config's
        # 1.6e-4 the loss does not fall at every step; lr_witness shows the plain path doing the same
        repeat = np.tile(rng.integers(0, MODEL_2P7B["vocab_size"], size=seq), 24)[: seq + 1 + 19 * seq]
        lrs = {"scheduler.config.warmup_steps": 1, "scheduler.config.initial_lr": 0.000016,
               "scheduler.config.max_lr": 0.000016, "scheduler.config.final_lr": 0.0000016}
        cfg = _train_config(tmp, "repeat", repeat, 5, lrs)
        main = Main(cfg, experiments_root_path=tmp / "experiments", device="cuda")
        losses = [r["losses"]["train loss last"] for r in main.run()]
        if not all(b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"training on one repeated batch: the loss did not fall at every step: {losses}")
        log(f"[phase 4] 5 steps on one repeated batch (warmup_steps 1, lr 1.6e-5 cosine to 1.6e-6): losses "
            f"{[round(x, 5) for x in losses]} fall at every step")
        del main
        gc.collect()
        torch.cuda.empty_cache()
        for n_layer, wseq in LR_WITNESS:
            lr_witness(torch, tmp, rng, n_layer, wseq, lr=0.00016, vocab=MODEL_2P7B["vocab_size"], keys=TRAIN_KERNELS,
                       phase="phase 4", plain_extra={}, fp32_arm=(n_layer, wseq) == LR_WITNESS[0])
    return counts, _step_metrics(sharded_results), peak_gb


def phase_train_long(torch, smi: str) -> dict[str, int]:
    """The 32k long-context config through Main: full width and depth (24
    layers of 1536, one sequence of 32768 a step), full remat, the fused-CE
    head. Returns the kernel launch counts of its 3-step run."""
    from modalities_tpu_torch.main import Main

    rng = np.random.default_rng(2028)
    steps = 3
    seq, vocab, width, layers = (LONG_MODEL[k] for k in ("seq", "vocab", "width", "layers"))
    shape = {"base": LONG_CONFIG, "micro": 1, "acc": 1}
    scratch = Path(__file__).resolve().parent / "build"  # gitignored, inside the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        cfg = _train_config(tmp, "long", rng.integers(0, vocab, size=seq + 1 + (steps + 2) * seq), steps, {}, seq=seq,
                            phase="phase 5", **shape)
        torch.cuda.reset_peak_memory_stats()
        main = Main(cfg, experiments_root_path=tmp / "experiments", device="cuda")
        main.components = main.build_components()
        _reset_counts()
        t0 = time.perf_counter()
        results = main.run(main.components)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launch_counts(LONG_KERNELS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reserved_gb = torch.cuda.max_memory_reserved() / 1e9
        losses = [r["losses"]["train loss last"] for r in results]
        norms = [r["metrics"]["grad norm last"] for r in results]
        if len(results) != steps or not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"32k training: {len(results)} steps, losses {losses}, grad norms {norms}")
        # the tied head: N(0, 0.02) wte rows over RMS-normalized hidden states of width 1536
        expected = math.log(vocab) + width * 0.02**2 / 2
        if abs(losses[0] - expected) > 0.5:
            raise AssertionError(f"32k training: step 0 loss {losses[0]} not within 0.5 of ln({vocab}) + "
                                 f"{width} * 0.02^2 / 2 = {expected:.3f}")
        for key, want in remat_launches(layers).items():
            if counts[key] != want * steps:
                raise AssertionError(f"32k training: {key} launched {counts[key]} times in {steps} steps, expected "
                                     f"{want} per step")
        if peak_gb > LONG_PEAK_GB:
            raise AssertionError(f"32k training: peak memory {peak_gb:.2f} GB above the reckoning's {LONG_PEAK_GB} GB")
        memscope_line(torch, main, "phase 5")
        log(f"[phase 5] step 0 loss {losses[0]:.5f}: expected {expected:.5f} = ln({vocab}) + {width} * 0.02^2 / 2, "
            f"within 0.5")
        log(f"[phase 5] 32k training through Main ({main.train_step.num_parameters / 1e9:.3f} B parameters, full "
            f"remat, fused-CE head): {steps} steps in {wall:.1f} s; losses {[round(x, 5) for x in losses]}, grad "
            f"norms {[round(x, 5) for x in norms]}; launches per step {({k: v // steps for k, v in counts.items()})}; "
            f"peak memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated; reckoning at most {LONG_PEAK_GB} GB), "
            f"{reserved_gb:.2f} GB reserved")
        for r in results[1:]:
            th = r["throughput_metrics"]
            log(f"[phase 5] step {r['num_train_steps_done']}: {1e3 / th['train steps/s']:.1f} ms, "
                f"{th['tokens/s']:.1f} tokens/s, MFU {th['MFU']:.4f} vs 989.4 TFLOP/s ({smi}; informational)")
        profile_train_step(torch, main, smi, phase="phase 5")
        sharded_results = results
        del main, results
        gc.collect()
        torch.cuda.empty_cache()
        fsdp_witness(torch, cfg, tmp, sharded_results, "11.13179", "phase 5")
        tp_one_witness(torch, cfg, tmp, sharded_results, counts, "phase 5")

        repeat = np.tile(rng.integers(0, vocab, size=seq), 8)[: seq + 1 + 6 * seq]
        lrs = {"scheduler.config.warmup_steps": 1, "scheduler.config.initial_lr": 0.00002,
               "scheduler.config.max_lr": 0.00002, "scheduler.config.final_lr": 0.000002}
        main = Main(_train_config(tmp, "long_repeat", repeat, 5, lrs, seq=seq, phase="phase 5", **shape),
                    experiments_root_path=tmp / "experiments", device="cuda")
        losses = [r["losses"]["train loss last"] for r in main.run()]
        if not all(b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"32k training on one repeated batch: the loss did not fall at every step: {losses}")
        log(f"[phase 5] 5 steps on one repeated batch (warmup_steps 1, lr 2e-5 cosine to 2e-6): losses "
            f"{[round(x, 5) for x in losses]} fall at every step")
        del main
        gc.collect()
        torch.cuda.empty_cache()
        lr_witness(torch, tmp, rng, *LONG_WITNESS, lr=0.0002, vocab=vocab, keys=LONG_KERNELS, phase="phase 5",
                   plain_extra={"model_raw.config.lm_head_fused_ce": "off"}, **shape)
    return counts


# ---------------------------------------------------------------- phase 6
CKPT_STEPS = 52  # run A: the 32k config two steps past its step-50 checkpoint (the file's interval 50 and k 2)
CKPT_LAYERS = 4  # phase 6's depth: the 32k config cut to 4 of its 24 layers (at 12 the script outran its limit)
CKPT_SERVE = {"requests": 4, "new_tokens": 32, "slots": 4, "capacity": 1024, "prompt_len": (32, 257)}


def _warmstart_config(run_config: Path, out: Path) -> Path:
    """The run's config as a warmstart config, in the pattern of
    configs/config_lorem_ipsum_tpu_warmstart.yaml: training progress read
    from the checkpoint folder's name by `number_conversion` nodes, the app
    state (`dcp`) loaded from that folder, `warmstart_checkpoint_paths` from
    `${warmstart_env:...}`. Prints every change."""
    import yaml

    cfg = yaml.safe_load(run_config.read_text())
    folder = "${settings.warmstart_checkpoint_paths.checkpoint_folder_path}"

    def conversion(variant, **config):
        return {"component_key": "number_conversion", "variant_key": variant, "config": config}

    changes = {
        "settings.training_progress": {
            "global_num_seen_tokens": conversion("global_num_seen_tokens_from_checkpoint_path", checkpoint_path=folder),
            "num_seen_steps": conversion("num_seen_steps_from_checkpoint_path", checkpoint_path=folder),
            "num_seen_samples": conversion("num_samples_from_num_tokens",
                                           num_tokens="${settings.training_progress.global_num_seen_tokens}",
                                           sequence_length="${settings.step_profile.sequence_length}"),
            "last_step": conversion("last_step_from_checkpoint_path", checkpoint_path=folder),
        },
        "settings.warmstart_checkpoint_paths": {"checkpoint_folder_path": "${warmstart_env:checkpoint_folder_path}"},
        "app_state_raw": cfg["app_state"],
        "app_state": {"component_key": "app_state", "variant_key": "dcp", "config": {
            "raw_app_state": {"instance_key": "app_state_raw", "pass_type": "BY_REFERENCE"},
            "checkpoint_dir_path": folder}},
    }
    for dotted, value in changes.items():
        node = cfg
        *parents, leaf = dotted.split(".")
        for key in parents:
            node = node[key]
        node[leaf] = value
        log(f"[phase 6] warmstart config: {dotted} = {json.dumps(value)}")
    out.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return out


@contextlib.contextmanager
def _timed(owner, name: str, into: list):
    """Record the wall seconds of each call of owner.name while inside."""
    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        into.append(time.perf_counter() - t0)
        return out

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def _host_copy(train_step) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in train_step.state_dict().items()}


def _step_metrics(results: list[dict]) -> dict[int, tuple[float, float, float]]:
    """step -> (loss, grad norm, lr) of a run logged every step."""
    return {r["num_train_steps_done"]: (r["losses"]["train loss last"], r["metrics"]["grad norm last"],
                                        r["metrics"]["lr mean"]) for r in results}


def _word_tokenizer(folder: Path, vocab_size: int) -> None:
    """A word-level tokenizer saved to `folder`: word "t<i>" is id i, and the
    last id is <eod>."""
    import tokenizers
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    vocab = {f"t{i}": i for i in range(vocab_size - 1)}
    vocab["<eod>"] = vocab_size - 1
    tok = tokenizers.Tokenizer(WordLevel(vocab, unk_token="t0"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="t0", eos_token="<eod>").save_pretrained(folder)


def _serve_ckpt_config(tmp: Path, run_config: Path, folder: Path, quant: str) -> Path:
    """configs/config_serve.yaml serving `folder`: the 32k model's node (its
    widths), 4 slots of a 1024-token ring, 32 new tokens, greedy, `quant`
    weights, a word-level tokenizer; `slo` null (refused by the port)."""
    import yaml

    from modalities_tpu_torch.config.yaml_interp import load_app_config_dict

    repo = Path(__file__).resolve().parent
    cfg = yaml.safe_load((repo / "configs" / "config_serve.yaml").read_text())
    node = cfg["serving_component"]["config"]
    model = load_app_config_dict(run_config, experiment_id="serve")["model_raw"]["config"]
    changes = {"max_batch_slots": CKPT_SERVE["slots"], "cache_capacity": CKPT_SERVE["capacity"],
               "max_new_tokens": CKPT_SERVE["new_tokens"], "quant": {"weights": quant}, "slo": None}
    node.update(changes)
    node["model"]["config"] = model
    node["tokenizer"]["config"]["pretrained_model_name_or_path"] = str(tmp / "tokenizer")
    cfg["settings"]["checkpoint_folder_path"] = str(folder)
    log(f"[phase 6] serve config ({quant}): {json.dumps(changes)}, model node of {LONG_CONFIG}, "
        f"checkpoint_folder_path = {folder.name}")
    path = tmp / f"serve_{quant}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def phase_checkpoint(torch, smi: str) -> dict[str, dict[str, int]]:
    """The 32k config at CKPT_LAYERS layers past its step-50 checkpoint (run
    A), the warmstart from it (run B), an async save that training
    overtakes, serving from the checkpoint, and the refusal of a corrupted
    copy. Returns the launch counts of run B and of serving from the
    checkpoint."""
    device = "cuda"
    sync = torch.cuda.synchronize

    from modalities_tpu_torch.__main__ import warmstart
    from modalities_tpu_torch.checkpointing.checkpoint_saving import CheckpointSaving
    from modalities_tpu_torch.checkpointing.checkpoint_saving_strategies import SaveKMostRecentCheckpointsStrategy
    from modalities_tpu_torch.checkpointing.dcp import dcp_checkpoint_saving
    from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_saving import DCPCheckpointSaving
    from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import (
        CheckpointingError,
        DCPCheckpointLoading,
        restore_tree_single_device,
    )
    from modalities_tpu_torch.checkpointing.stateful.app_state import AppState
    from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
    from modalities_tpu_torch.main import Main
    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm
    from modalities_tpu_torch.resilience.manifest import resolve_resume_folder, verify_manifest
    from modalities_tpu_torch.serving.serve import build_serving_components, load_serving_params, serve
    from modalities_tpu_torch.training.training_progress import TrainingProgress

    import torch.distributed.checkpoint as dcp

    rng = np.random.default_rng(2029)
    seq, vocab, layers = LONG_MODEL["seq"], LONG_MODEL["vocab"], CKPT_LAYERS
    per_step = remat_launches(layers)
    shape = {"base": LONG_CONFIG, "micro": 1, "acc": 1}
    scratch = Path(__file__).resolve().parent / "build"  # gitignored, inside the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        corpus = rng.integers(0, vocab, size=seq + 1 + (CKPT_STEPS + 2) * seq)
        cfg = _train_config(tmp, "ckpt", corpus, CKPT_STEPS, {"model_raw.config.n_layer": layers}, seq=seq,
                            phase="phase 6", keep_checkpointing=True, **shape)

        # run A: 52 steps through Main, saving at step 50 with the file's interval and k
        main = Main(cfg, experiments_root_path=tmp / "experiments", device=device)
        main.components = main.build_components()
        execution = main.components.checkpoint_saving.checkpoint_saving_execution
        saved: dict = {}
        save_s, dcp_s, manifest_s = [], [], []

        def snapshot_then_save(app_state, training_progress):
            sync()
            saved["params"] = _host_copy(app_state.train_step)  # the step-50 parameters, in memory
            saved["step"] = training_progress.num_seen_steps_total
            t0 = time.perf_counter()
            original(app_state=app_state, training_progress=training_progress)
            save_s.append(time.perf_counter() - t0)

        original = execution._save_checkpoint
        execution._save_checkpoint = snapshot_then_save
        _reset_counts()
        t0 = time.perf_counter()
        with _timed(dcp, "save", dcp_s), _timed(dcp_checkpoint_saving, "write_manifest", manifest_s):
            results_a = main.run(main.components)
        sync()
        wall_a = time.perf_counter() - t0
        counts_a = _launch_counts(LONG_KERNELS)
        metrics_a = _step_metrics(results_a)
        final_a = _host_copy(main.train_step)
        if len(results_a) != CKPT_STEPS or saved.get("step") != 50 or len(save_s) != 1:
            raise AssertionError(f"run A: {len(results_a)} steps, saves at {saved.get('step')} ({len(save_s)} saves); "
                                 f"expected {CKPT_STEPS} steps and one save at step 50")
        for key, want in per_step.items():
            if counts_a[key] != want * CKPT_STEPS:
                raise AssertionError(f"run A: {key} launched {counts_a[key]} times in {CKPT_STEPS} steps, "
                                     f"expected {want} per step")
        ckpts = tmp / "checkpoints"
        info = ckpts / "last_checkpoint_info.json"
        folder = Path(json.loads(info.read_text())["checkpoint_folder_path"])
        folders = [p for p in ckpts.iterdir() if p.is_dir()]
        if folders != [folder] or "seen_steps_50-" not in folder.name:
            raise AssertionError(f"run A: checkpoint folders {[p.name for p in folders]}, pointer {folder.name}")
        files = sorted(p for p in folder.rglob("*") if p.is_file())
        nbytes = sum(p.stat().st_size for p in files)
        t0 = time.perf_counter()
        check = verify_manifest(folder)
        verify_s = time.perf_counter() - t0
        if not check.ok or not (folder / "topology.json").is_file():
            raise AssertionError(f"run A: the step-50 folder is not sealed: {check.reason}")
        log(f"[phase 6] run A: {CKPT_STEPS} steps of {LONG_CONFIG} at {layers} layers through Main in {wall_a:.1f} s "
            f"(checkpointing interval 50, k 2, as the file has them); losses of steps 49-52 "
            f"{[metrics_a[s][0] for s in (49, 50, 51, 52)]}; launches per step "
            f"{({k: v // CKPT_STEPS for k, v in counts_a.items()})}")
        log(f"[phase 6] checkpoint at step 50 ({smi}): {folder.name}; {len(files)} files, {nbytes} bytes on disk "
            f"({', '.join(f'{p.name} {p.stat().st_size}' for p in files)}); save {save_s[0]:.2f} s in all, of it "
            f"dcp.save {dcp_s[0]:.2f} s and write_manifest (sha256 of every file) {manifest_s[0]:.2f} s; "
            f"verify_manifest {verify_s:.2f} s")
        del main, results_a
        gc.collect()
        torch.cuda.empty_cache()

        # run B: the warmstart entry point from last_checkpoint_info.json, steps 51-52
        warm = _warmstart_config(cfg, tmp / "ckpt_warmstart.yaml")
        load_s = []
        _reset_counts()
        t0 = time.perf_counter()
        with _timed(DCPCheckpointLoading, "load_app_state", load_s):
            main_b, results_b = warmstart(warm, info, experiments_root_path=tmp / "experiments", device=device)
        sync()
        wall_b = time.perf_counter() - t0
        counts_b = _launch_counts(LONG_KERNELS)
        metrics_b = _step_metrics(results_b)
        log(f"[phase 6] run B ({smi}): warmstart from {info.name} in {wall_b:.1f} s (load_app_state {load_s[0]:.2f} s: "
            f"manifest, shape gate, dcp.load, set_state_dict); steps {sorted(metrics_b)}; launches per step "
            f"{({k: v // 2 for k, v in counts_b.items()})}")
        if sorted(metrics_b) != [51, 52] or len(load_s) != 1:
            raise AssertionError(f"run B: steps {sorted(metrics_b)}, {len(load_s)} loads; expected 51, 52 after one")
        for key, want in per_step.items():
            if counts_b[key] != want * 2:
                raise AssertionError(f"run B: {key} launched {counts_b[key]} times in 2 steps, expected {want} per "
                                     "step")
        for s in (51, 52):
            if metrics_b[s] != metrics_a[s]:
                raise AssertionError(f"run B step {s} (loss, grad norm, lr) {metrics_b[s]} != run A's {metrics_a[s]}")
        final_b = _host_copy(main_b.train_step)
        unequal = [k for k in final_a if not torch.equal(final_a[k], final_b[k])]
        if unequal or set(final_a) != set(final_b):
            raise AssertionError(f"run B's final parameters differ from run A's: {unequal[:5]} ({len(unequal)})")
        log(f"[phase 6] steps 51-52 (loss, grad norm, lr) bitwise equal in runs A and B: "
            f"{[metrics_b[s] for s in (51, 52)]}; all {len(final_a)} final parameter tensors bitwise equal")

        # run B's final state saved again with use_async: dcp.async_save stages the tensors to the host and
        # writes in the background; the pointer waits for the commit. One more training step runs before the
        # commit is awaited, so the folder must hold the state as it was at the save, not the live one.
        async_root = tmp / "async"
        saving = CheckpointSaving(SaveKMostRecentCheckpointsStrategy(k=1),
                                  DCPCheckpointSaving(async_root, "async", use_async=True))
        progress = TrainingProgress(2, 2 * seq, CKPT_STEPS, CKPT_STEPS * seq, 50, 50 * seq)
        t0 = time.perf_counter()
        saving.save_checkpoint(progress, AppState(main_b.train_step))
        staged_s = time.perf_counter() - t0
        if (async_root / "last_checkpoint_info.json").exists():
            raise AssertionError("async save: the resume pointer was written before the commit")
        t = torch.as_tensor(rng.integers(0, vocab, size=(1, 1, seq + 1)), device=device)
        main_b.train_step({"samples": {"input_ids": t[..., :-1]}, "targets": {"target_ids": t[..., 1:]}})
        sync()
        step_s = time.perf_counter() - t0 - staged_s
        after_step = _host_copy(main_b.train_step)
        moved = [k for k in final_b if not torch.equal(after_step[k], final_b[k])]
        if not moved:
            raise AssertionError("async save: the training step after the save changed no parameter")
        t1 = time.perf_counter()
        saving.wait_until_finished()
        wait_s = time.perf_counter() - t1
        async_folder = Path(json.loads((async_root / "last_checkpoint_info.json").read_text())["checkpoint_folder_path"])
        t0 = time.perf_counter()
        restored = restore_tree_single_device(async_folder, device=device)
        sync()
        restore_s = time.perf_counter() - t0
        unequal = [k for k in final_b if not torch.equal(restored[k].cpu(), final_b[k])]
        if not verify_manifest(async_folder).ok or unequal or set(restored) != set(final_b):
            raise AssertionError(f"async save: the folder does not verify or differs from the state at the save: "
                                 f"{unequal[:5]} ({len(unequal)})")
        log(f"[phase 6] async save of run B's final state ({smi}): save_checkpoint returned after {staged_s:.2f} s "
            f"(staged to the host, no pointer yet); one more training step ({step_s:.2f} s) changed "
            f"{len(moved)} of {len(final_b)} parameter tensors; wait_until_finished (commit and seal) {wait_s:.2f} s; "
            f"the folder's model parameters, read back onto the {device} in {restore_s:.2f} s, are bitwise those "
            "at the save")
        del restored
        shutil.rmtree(async_root)

        # a copy of the folder with one byte flipped: loading, warmstart and serving refuse it
        broken_root = tmp / "broken"
        broken = broken_root / folder.name
        shutil.copytree(folder, broken)
        data = broken / "__0_0.distcp"
        with open(data, "r+b") as f:
            f.seek(data.stat().st_size // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x01]))
        (broken_root / "last_checkpoint_info.json").write_text(json.dumps({"checkpoint_folder_path": str(broken)}))
        refusals = {
            "load_app_state": (CheckpointingError, lambda: DCPCheckpointLoading().load_app_state(
                AppState(main_b.train_step), broken)),
            "warmstart's resolve_resume_folder": (FileNotFoundError, lambda: resolve_resume_folder(
                broken_root / "last_checkpoint_info.json")),
            "load_serving_params": (ValueError, lambda: load_serving_params(broken, device=device)),
        }
        for what, (error, fn) in refusals.items():
            log(f"[phase 6] corrupted copy (one byte of __0_0.distcp flipped): {what} refused: {_rejects(fn, error)[:200]}")
        unequal = [k for k, v in _host_copy(main_b.train_step).items() if not torch.equal(v, after_step[k])]
        if unequal:
            raise AssertionError(f"the refused load changed the train step's parameters: {unequal[:5]}")
        shutil.rmtree(broken_root)
        del main_b, results_b, final_a, final_b, after_step
        gc.collect()
        torch.cuda.empty_cache()

        # serving from the step-50 folder, against the same parameters handed over in memory
        restored = restore_tree_single_device(folder, device="cpu")
        unequal = [k for k in saved["params"] if not torch.equal(restored[k], saved["params"][k])]
        if unequal or set(restored) != set(saved["params"]):
            raise AssertionError(f"the folder's model parameters differ from step 50's in memory: {unequal[:5]}")
        del restored
        _word_tokenizer(tmp / "tokenizer", vocab)
        prompts = [" ".join(f"t{i}" for i in rng.integers(0, vocab - 1, size=int(n)))
                   for n in rng.integers(*CKPT_SERVE["prompt_len"], size=CKPT_SERVE["requests"])]
        requests = tmp / "requests.jsonl"
        requests.write_text("".join(json.dumps({"prompt": p}) + "\n" for p in prompts))
        serve_counts = {"rms_fwd": 0, "quant_matmul": 0}
        for quant in ("none", "int8"):
            serve_cfg = _serve_ckpt_config(tmp, cfg, folder, quant)
            out = tmp / f"served_{quant}.jsonl"
            rms0, qmm0 = rms_norm.launches, quant_matmul.launches
            t0 = time.perf_counter()
            with own_registry():  # the default registry's gauges would keep the engine (and its memory) alive
                stats = serve(serve_cfg, requests, out, device=device)
            wall = time.perf_counter() - t0
            rms, qmm = rms_norm.launches - rms0, quant_matmul.launches - qmm0
            serve_counts["rms_fwd"] += rms
            serve_counts["quant_matmul"] += qmm
            rows = [json.loads(line) for line in out.read_text().splitlines()]
            fwd = stats["forward_calls"]
            want_qmm = 7 * layers * fwd if quant == "int8" else 0  # q, k, v, c_proj, W, V, W_2; the tied head stays
            if (rms != (2 * layers + 1) * fwd or qmm != want_qmm):
                raise AssertionError(f"serve {quant} from the checkpoint: rms_norm {rms}, quant_matmul {qmm} launches "
                                     f"in {fwd} forwards; expected {2 * layers + 1} and {want_qmm // max(fwd, 1)} each")
            if len(rows) != CKPT_SERVE["requests"] or any(r["finish_reason"] not in ("budget", "eod") for r in rows):
                raise AssertionError(f"serve {quant} from the checkpoint: {[r['finish_reason'] for r in rows]}")
            component = build_serving_components(load_app_config_dict(serve_cfg)).serving_component
            component.device, component.params = torch.device(device), saved["params"]
            in_memory = component.run_requests([{"prompt": p} for p in prompts])
            del component
            if [r["tokens"] for r in rows] != [r["tokens"] for r in in_memory]:
                raise AssertionError(f"serve {quant}: the checkpoint's tokens differ from those of the same "
                                     "parameters in memory")
            log(f"[phase 6] serve {quant if quant != 'none' else 'bf16'} from the step-50 folder in {wall:.1f} s "
                f"(manifest, read, {'quantize, ' if quant != 'none' else ''}engine, {len(rows)} requests of "
                f"{CKPT_SERVE['new_tokens']} tokens): every request finished; launches rms_norm {rms} = "
                f"{2 * layers + 1} x {fwd} forwards, quant_matmul {qmm}; greedy tokens bitwise those of the same "
                "parameters in memory")
            gc.collect()
            torch.cuda.empty_cache()

    return {"train_32k_resume": counts_b, "serve_ckpt": serve_counts}


# ---------------------------------------------------------------- phases 2-3
# ---------------------------------------------------------------- phase 7
RING_CP = 4  # the ring's ranks: the 32k sequence in 4 contiguous chunks of 8192
RING_STEPS = 2  # the 32k config cut to 2 steps, in process and under the launcher


def phase_ring(torch, smi: str) -> dict:
    """The flash ring's hops at the 32k config's attention widths (q [1, 12,
    32768, 128], k/v [1, 4, 32768, 128] bf16) with cp 4, driven rank by rank
    in this process through parallel/ring_attention.py's own hop functions
    (`ring_in_process`), against one flash call on the whole sequence: out,
    dq, dk and dv held row by row (FLASH_ROW_REL), lse within 1e-4. The ring
    launches 4 causal and 6 full forward hops, 10 dq and 10 dk/dv, and none
    for its 6 skipped hops. Then each rank's hop time and the whole call's
    (informational: the contiguous chunks' imbalance). Returns the ring's
    launch counts."""
    from modalities_tpu_torch.ops import flash_attention as fa
    from modalities_tpu_torch.parallel import ring_attention as ra

    b, s, hq, hkv, d = FLASH_LONG
    g = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device="cuda").to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
    out_ref, lse_ref = fa.flash_fwd_out_lse(q, k, v, causal=True)
    delta = (do.float() * out_ref.float()).sum(-1, keepdim=True)
    dq_ref = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal=True)
    dk_ref, dv_ref = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal=True)
    torch.cuda.synchronize()
    _reset_counts()
    out, lse, dq, dk, dv = ra.ring_in_process(q, k, v, do, RING_CP, causal=True)
    torch.cuda.synchronize()
    counts = _launch_counts(("flash_fwd", "flash_dq", "flash_dkv"))
    if counts != {"flash_fwd": 10, "flash_dq": 10, "flash_dkv": 10}:
        raise AssertionError(f"ring cp {RING_CP}: launches {counts}, expected 10 forward (4 causal, 6 full), 10 dq, "
                             "10 dk/dv and none for the 6 skipped hops")
    what = f"ring cp {RING_CP} at q [{b}, {hq}, {s}, {d}] k/v [{b}, {hkv}, {s}, {d}] bf16 causal"
    rel = FLASH_ROW_REL["bfloat16"]
    seen = {}
    for name, got, want in (("out", out, out_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        seen[name] = _row_check(torch, got, want, rel, f"{what} {name} against one flash call on the whole sequence")
    lse_err = _rel_check(torch, lse, lse_ref, 0.0, 1e-4, f"{what} lse")
    log(f"[phase 7] {what}, driven rank by rank through the module's hop functions: launches {counts} (4 causal and "
        f"6 full forward hops, 6 skipped); against one flash call on the whole sequence, worst row rel err (share of "
        f"allowance used, max abs err) "
        f"{', '.join(f'{n} {r[0]:.3g} ({r[1]:.2f}, {r[2]:.3g})' for n, r in seen.items())}, "
        f"bound rel {rel:g}; lse max abs err {lse_err:.3g} (bound 1e-4)")
    del out, lse, dq, dk, dv, dq_ref, dk_ref, dv_ref

    chunk = s // RING_CP
    sm_scale = 1.0 / math.sqrt(d)
    qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(RING_CP, dim=2)] for t in (q, k, v, do))
    lses = [lse_ref[:, :, i * chunk:(i + 1) * chunk].contiguous() for i in range(RING_CP)]
    deltas = [delta[:, :, i * chunk:(i + 1) * chunk].contiguous() for i in range(RING_CP)]

    def rank_fwd(i):
        return ra.forward_hops(qs[i], ks[i], vs[i], i, RING_CP, True, sm_scale,
                               lambda r, k_, v_: (ks[(i - r - 1) % RING_CP], vs[(i - r - 1) % RING_CP]))

    def rank_bwd(i):
        for r in range(RING_CP):
            j = (i - r) % RING_CP
            ra.hop_backward(qs[i], ks[j], vs[j], dos[i], lses[i], deltas[i], ra.branch(True, i, j), sm_scale)

    fwd_ms = [time_ms(torch, lambda i=i: rank_fwd(i), reps=3) for i in range(RING_CP)]
    bwd_ms = [time_ms(torch, lambda i=i: rank_bwd(i), reps=3) for i in range(RING_CP)]
    whole_fwd = time_ms(torch, lambda: fa.flash_fwd_out_lse(q, k, v, causal=True), reps=3)
    whole_bwd = time_ms(torch, lambda: (fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal=True),
                                        fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal=True)), reps=3)
    log(f"[phase 7] ring hop times by rank ({smi}; informational, no exchange): forward (hops merged) "
        f"{[round(t, 3) for t in fwd_ms]} ms, backward (dq and dk/dv a hop) {[round(t, 3) for t in bwd_ms]} ms; "
        f"the slowest rank {max(fwd_ms) + max(bwd_ms):.3f} ms against one whole-sequence forward {whole_fwd:.3f} ms "
        f"+ dq and dk/dv {whole_bwd:.3f} ms; rank i runs i + 1 hops (contiguous chunks, no load balancing)")
    del q, k, v, do, out_ref, lse_ref, delta, qs, ks, vs, dos, lses, deltas
    torch.cuda.empty_cache()
    return counts


def phase_launcher(torch, smi: str) -> dict[str, int]:
    """The 32k config cut to RING_STEPS steps through Main in this process,
    then through `python -m torch.distributed.run --standalone
    --nproc_per_node 1 -m modalities_tpu_torch run` in a subprocess (its own
    world-1 NCCL group, the library this process built): the same losses,
    grad norms and lr, bitwise. Returns the subprocess's kernel launches
    (its `[train] kernel launches` line)."""
    from modalities_tpu_torch.main import Main

    rng = np.random.default_rng(2030)
    seq, vocab = LONG_MODEL["seq"], LONG_MODEL["vocab"]
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        corpus = rng.integers(0, vocab, size=seq + 1 + (RING_STEPS + 2) * seq)
        cfg = _train_config(tmp, "launcher", corpus, RING_STEPS, {}, seq=seq, base=LONG_CONFIG, micro=1, acc=1,
                            phase="phase 7")
        main = Main(cfg, experiments_root_path=tmp / "in_process", device="cuda")
        in_process = _step_metrics(main.run())
        del main
        gc.collect()
        torch.cuda.empty_cache()
        import yaml

        launcher_cfg = yaml.safe_load(cfg.read_text())  # the same config, its results in a folder of their own
        launcher_cfg["settings"]["paths"]["experiments_root_path"] = str(tmp / "launcher")
        (tmp / "launcher.yaml").write_text(yaml.safe_dump(launcher_cfg, sort_keys=False))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", "-m",
               "modalities_tpu_torch", "run", "--config_file_path", str(tmp / "launcher.yaml")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"launcher run exited {proc.returncode}: {proc.stderr[-3000:]}")
        rows = [json.loads(line) for f in (tmp / "launcher").rglob("evaluation_results.jsonl")
                for line in f.read_text().splitlines()]
        launched = _step_metrics(rows)
        counts_line = [line for line in proc.stdout.splitlines() if line.startswith("[train] kernel launches")]
        if launched != in_process or len(counts_line) != 1:
            raise AssertionError(f"launcher run: steps {launched} != in process {in_process} "
                                 f"({len(counts_line)} launch lines)\n{proc.stdout[-3000:]}")
        counts = json.loads(counts_line[0].split(": ", 1)[1])
        step_lines = [line for line in proc.stdout.splitlines() if line.startswith("[train] step")]
        log(f"[phase 7] {LONG_CONFIG} cut to {RING_STEPS} steps under `torch.distributed.run --standalone "
            f"--nproc_per_node 1` ({wall:.1f} s with the process start; {smi}): (loss, grad norm, lr) "
            f"{[launched[s] for s in sorted(launched)]} bitwise those of the same config through Main in this process; "
            f"its launches {counts}; its lines: {step_lines}")
    return counts


# ---------------------------------------------------------------- phase 8
SEVEN_B_CONFIG = "config_7b_tp_fsdp.yaml"
SEVEN_B = {"layers": 4, "micro": 4, "seq": 4096, "vocab": 50304, "width": 4096}  # the 7B cut to 4 of its 32 layers
# The written reckoning of the 7B step's peak memory at 4 layers (PERF.md, section 4): 1.284 B parameters at 12
# bytes each (bf16 parameter and gradient, fp32 accumulator, two bf16 Adam moments: 15.4 GB), about 3 GB of block
# activations a layer (12 GB) and about 14 GB for the fp32 head (logits, log-softmax and their gradient at
# 16384 x 50304, the head kernel widened to fp32): about 42 GB, at most 55
SEVEN_B_PEAK_GB = 55.0
SEVEN_B_STEP0 = "11.30021"  # 8a's step-0 loss as the unsharded kernels' path gives it on the H100
TP_DEGREE = 8  # config_7b_tp_fsdp.yaml's tp
# 8c's shapes (N, V, E): the 32k CE shape, and one rank of the 7B 32k warmstart recipe (its cp chunk of 8192 rows
# gathered over tp) with the whole vocabulary, cut into the tp 8 shards
TP_CE_SHAPES = [CE_SHAPE, (8192, 50304, 4096)]
MODEL_7B_BLOCK = {**MODEL_2P7B, "n_layer": 1, "n_embd": 4096, "ffn_hidden": 21504,
                  "attention_implementation": "dao_flash",
                  "attention_config": {"qkv_transforms": [{"type_hint": "RotaryTransform",
                                                           "config": {"n_embd": 4096, "n_head": 32,
                                                                      "base_freq": 500000}}]},
                  **{f"{n}_norm_config": {"norm_type": "rms_norm", "config": {"ndim": 4096, "bias": False,
                                                                               "epsilon": 1e-5}}
                     for n in ("attention", "ffn", "lm_head")}}
# the variance of a unit normal truncated at +-3 (the Llama3 head's init: truncN(0, 1/sqrt(E)) at +-3/sqrt(E))
TRUNC3_VAR = 1.0 - 6.0 * math.exp(-4.5) / math.sqrt(2.0 * math.pi) / math.erf(3.0 / math.sqrt(2.0))


def phase_train_7b(torch, smi: str, tmp: Path) -> tuple[dict[str, int], dict]:
    """8a: configs/config_7b_tp_fsdp.yaml through Main at full width (E 4096,
    32/8 heads of 128, SwiGLU 14336, vocab 50304, untied head, the
    gpt2_llama3_like init with depth_init), cut where one card forces it:
    world 1 and tp 1 (so no loss parallelism, which needs tp > 1), 4 layers
    of 32, the file's micro-batch of 4 x 4096. 3 steps with finite losses,
    step 0's loss within 0.5 of ln(50304) + 0.5 x TRUNC3_VAR, exact flash and
    RMSNorm launches per step, peak memory within SEVEN_B_PEAK_GB, a
    profiled step; the run saves its step-3 checkpoint (checkpointing
    interval 3, the file's k and last-step rule) under `tmp`, the pretrain
    folder phase 8d warmstarts from. The same steps without a mesh bitwise
    (step 0's loss SEVEN_B_STEP0) and with the tp plan on a (dp_shard 1, tp 1)
    mesh within TP_ONE_TOL (`tp_one_witness`), both without a checkpoint in
    reach. Returns the launch counts and the saved parameters (host copies)."""
    import torch.distributed.checkpoint as dcp

    from modalities_tpu_torch.checkpointing.dcp import dcp_checkpoint_saving
    from modalities_tpu_torch.main import Main

    rng = np.random.default_rng(2031)
    steps = 3
    layers, micro, seq, vocab = (SEVEN_B[k] for k in ("layers", "micro", "seq", "vocab"))
    corpus = rng.integers(0, vocab, size=seq + 1 + micro * (steps + 3) * seq)
    cuts = {"device_mesh.config.tensor_parallel_degree": 1, "device_mesh.config.enable_loss_parallel": False,
            "model_raw.config.n_layer": layers}
    cfg = _train_config(tmp, "train_7b", corpus, steps, cuts, seq=seq, base=SEVEN_B_CONFIG, micro=micro, acc=1,
                        phase="phase 8a")
    cfg_ckpt = _train_config(tmp, "train_7b_ckpt", corpus, steps,
                             {**cuts, "settings.intervals.checkpointing_interval_in_steps": steps}, seq=seq,
                             base=SEVEN_B_CONFIG, micro=micro, acc=1, phase="phase 8a", keep_checkpointing=True)
    torch.cuda.reset_peak_memory_stats()
    main = Main(cfg_ckpt, experiments_root_path=tmp / "experiments", device="cuda")
    main.components = main.build_components()
    _reset_counts()
    save_s, dcp_s, manifest_s = [], [], []
    execution = main.components.checkpoint_saving.checkpoint_saving_execution
    t0 = time.perf_counter()
    with (_timed(execution, "_save_checkpoint", save_s), _timed(dcp, "save", dcp_s),
          _timed(dcp_checkpoint_saving, "write_manifest", manifest_s)):
        results = main.run(main.components)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    saved = _host_copy(main.train_step)  # the step-3 state: the folder's parameters
    folder = Path(json.loads((tmp / "checkpoints" / "last_checkpoint_info.json").read_text())[
        "checkpoint_folder_path"])
    nbytes = sum(f.stat().st_size for f in folder.rglob("*") if f.is_file())
    if len(save_s) != 1 or f"seen_steps_{steps}-" not in folder.name:
        raise AssertionError(f"7B training: {len(save_s)} saves, pointer {folder.name}; expected one save at "
                             f"step {steps}")
    log(f"[phase 8a] checkpoint at step {steps} ({smi}): {folder.name}, {nbytes} bytes; save {save_s[0]:.2f} s "
        f"(dcp.save {dcp_s[0]:.2f} s, write_manifest {manifest_s[0]:.2f} s; inside step {steps}'s wall time)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    losses = [r["losses"]["train loss last"] for r in results]
    norms = [r["metrics"]["grad norm last"] for r in results]
    if len(results) != steps or not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"7B training: {len(results)} steps, losses {losses}, grad norms {norms}")
    # the head's logits: rows of std 1/sqrt(E) truncated at 3 sigma over unit-RMS hidden states of width E
    expected = math.log(vocab) + TRUNC3_VAR / 2
    if abs(losses[0] - expected) > 0.5:
        raise AssertionError(f"7B training: step 0 loss {losses[0]} not within 0.5 of ln({vocab}) + "
                             f"{TRUNC3_VAR:.5f} / 2 = {expected:.3f}")
    per_step = {"flash_fwd": layers, "flash_dq": layers, "flash_dkv": layers, "rms_fwd": 2 * layers + 1,
                "rms_bwd": 2 * layers + 1}
    for key, want in per_step.items():
        if counts[key] != want * steps:
            raise AssertionError(f"7B training: {key} launched {counts[key]} times in {steps} steps, expected "
                                 f"{want} per step")
    if peak_gb > SEVEN_B_PEAK_GB:
        raise AssertionError(f"7B training: peak memory {peak_gb:.2f} GB above the reckoning's "
                             f"{SEVEN_B_PEAK_GB} GB")
    log(f"[phase 8a] {SEVEN_B_CONFIG} through Main at full width, cut to world 1 / tp 1 (no loss parallelism) "
        f"and {layers} of 32 layers, micro-batch {micro} x {seq} ({main.train_step.num_parameters / 1e9:.3f} B "
        f"parameters, gpt2_llama3_like with depth_init): {steps} steps in {wall:.1f} s; losses "
        f"{[round(x, 5) for x in losses]}, grad norms {[round(x, 5) for x in norms]}; step 0 expected "
        f"{expected:.5f} = ln({vocab}) + {TRUNC3_VAR:.5f} / 2, within 0.5; launches per step "
        f"{ {k: v // steps for k, v in counts.items()} }; peak memory {peak_gb:.2f} GB "
        f"(torch.cuda.max_memory_allocated; reckoning at most {SEVEN_B_PEAK_GB} GB), {reserved_gb:.2f} GB "
        f"reserved")
    for r in results[1:]:
        th = r["throughput_metrics"]
        log(f"[phase 8a] step {r['num_train_steps_done']}: {1e3 / th['train steps/s']:.1f} ms, "
            f"{th['tokens/s']:.1f} tokens/s, MFU {th['MFU']:.4f} vs 989.4 TFLOP/s ({smi}; informational)")
    profile_train_step(torch, main, smi, phase="phase 8a")
    sharded_results = results
    del main, results
    gc.collect()
    torch.cuda.empty_cache()
    fsdp_witness(torch, cfg, tmp, sharded_results, SEVEN_B_STEP0, "phase 8a")
    tp_one_witness(torch, cfg, tmp, sharded_results, counts, "phase 8a")
    return counts, {"params": saved, "steps": steps, "tokens": steps * micro * seq, "loss": losses[-1]}


def phase_tp_block(torch, smi: str, bias: bool = False, phase: str = "phase 8b") -> dict[str, int]:
    """8b: one 7B block (E 4096, 32/8 heads of 128, SwiGLU 14336, bf16, the
    Llama3 init; with `bias` (10d) `bias: true`, the default N(0, 0.02) init,
    which the Llama3 one refuses with biases, and every dense bias drawn
    from N(0, 0.02), so that a row-parallel bias added once per rank before
    the sum, not once after it, moves the output) on x [1, 4096, 4096] at
    tp 8, driven rank by rank in this
    process through parallel/tensor_parallel.py's `tp_in_process`: each
    rank's norms on its 512 rows (SP), its 4/1 heads and its 1/8 of the MLP;
    the partial outputs summed in rank order in fp32, as the reduce-scatter
    sums them. The output, dx and every weight gradient against the
    unsharded block, row by row (FLASH_ROW_REL); exactly
    8 flash forward, dq and dk/dv launches at q [1, 4, 4096, 128], k/v [1, 1,
    4096, 128], and 16 RMSNorm forward and backward launches. Returns the
    launch counts."""
    from modalities_tpu_torch.models.gpt2.gpt2_model import GPT2LLM
    from modalities_tpu_torch.nn.llama3_initialization import Llama3Initializer
    from modalities_tpu_torch.ops import flash_attention as fa
    from modalities_tpu_torch.parallel import tensor_parallel as tpm

    model = GPT2LLM(**{**MODEL_7B_BLOCK, "bias": bias})
    model.with_spec_updates(param_dtype="bfloat16", compute_dtype="bfloat16")
    if not bias:  # the Llama3 init refuses biases (as the JAX one does): the default N(0, 0.02) init then
        model.update_train_spec(init_routines=(Llama3Initializer(num_layers=1, n_embd=4096),))
    module = model.build_train_module(model.init_train_params(torch.Generator(device="cuda").manual_seed(11)))
    block = module.blocks[0]
    if bias:
        g = torch.Generator(device="cuda").manual_seed(17)
        with torch.no_grad():
            for name, p in block.named_parameters():
                if name.endswith(".bias") and "norm" not in name:
                    p.copy_(0.02 * torch.randn(p.shape, generator=g, device="cuda"))
    s, e = MODEL_7B_BLOCK["sequence_length"], MODEL_7B_BLOCK["n_embd"]
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(1, s, e, generator=g, device="cuda").to(torch.bfloat16)
    dy = torch.randn(1, s, e, generator=g, device="cuda").to(torch.bfloat16)
    cos, sin = module._rope_tables(s)
    x_ref = x.clone().requires_grad_(True)
    out_ref = block.train_forward(x_ref, cos, sin)
    out_ref.backward(dy)
    torch.cuda.synchronize()
    shapes = []
    kernel = fa._fwd_kernel

    def recording(q, k, *rest):  # the forward kernel's q and k shapes ([B, H, S, D]) on the tp path
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return kernel(q, k, *rest)

    _reset_counts()
    fa._fwd_kernel = recording
    try:
        x_tp = x.clone().requires_grad_(True)
        out, ranks = tpm.tp_in_process(block, x_tp, cos, sin, TP_DEGREE)
        out.backward(dy)
        torch.cuda.synchronize()
    finally:
        fa._fwd_kernel = kernel
    counts = _launch_counts()
    want = {"flash_fwd": TP_DEGREE, "flash_dq": TP_DEGREE, "flash_dkv": TP_DEGREE, "rms_fwd": 2 * TP_DEGREE,
            "rms_bwd": 2 * TP_DEGREE}
    want_shapes = [((1, 4, s, 128), (1, 1, s, 128))] * TP_DEGREE
    if counts != want or shapes != want_shapes:
        raise AssertionError(f"tp {TP_DEGREE} block: launches {counts} (expected {want}), flash shapes {shapes}")
    rel = FLASH_ROW_REL["bfloat16"]
    what = f"7B block{' with biases' if bias else ''} at tp {TP_DEGREE}, x [1, {s}, {e}] bf16"
    grads = tpm.gather_rank_grads(block, ranks)
    pairs = {"out": (out, out_ref), "dx": (x_tp.grad, x_ref.grad),
             **{f"d {name}": (grads[name], p.grad) for name, p in block.named_parameters()}}
    seen, failed = {}, []
    for name, (got, ref) in pairs.items():  # every tensor checked before any failure is raised
        try:
            seen[name] = _row_check(torch, got, ref, rel, f"{what}: {name}")
        except AssertionError as err:
            failed.append(str(err))
    if failed:
        raise AssertionError("; ".join(failed) + f" (the others: {seen})")
    worst = max(seen.items(), key=lambda kv: kv[1][1])
    log(f"[{phase}] {what}, driven rank by rank through tensor_parallel.tp_in_process: launches {counts} (flash "
        f"q/k {shapes[0]} a rank; RMSNorm on {s // TP_DEGREE}-row chunks under SP); against the unsharded block, "
        f"worst row rel err (share of allowance used, max abs err) "
        f"{', '.join(f'{n} {r[0]:.3g} ({r[1]:.2f}, {r[2]:.3g})' for n, r in seen.items())}; most used: "
        f"{worst[0]} {worst[1][1]:.2f}; bound rel {rel:g}")
    del module, block, ranks, out, out_ref, x_ref, x_tp, grads
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_tp_fused_ce(torch, smi: str, shape=CE_SHAPE) -> dict[str, int]:
    """8c: the fused CE on TP_DEGREE vocab shards at `shape`: the 32k CE shape
    (h [32768, 1536], W [50304, 1536] bf16), or the 7B warmstart recipe's rank
    (h [8192, 4096], W [50304, 4096]): shards of 6288 rows, no multiple of
    the kernels' 64-column tile; 8 forward, 8 dh and 8 dW launches and the
    combine (parallel/vocab_parallel_ce.py:fused_ce_in_process), against one
    whole-vocabulary call: lse and corr within 1e-4; dh held per row to the
    plain fp32 gradient with phase 1's bound (CE_ROW_REL) as the whole
    call's is; the dW shards against the whole dW's rows (bitwise or not,
    printed; and with the whole call's lse). Labels sit on every shard
    boundary. The shard calls' summed time beside the whole call's
    (informational). Returns the launch counts."""
    from modalities_tpu_torch.ops import fused_ce as fce
    from modalities_tpu_torch.parallel import vocab_parallel_ce as vce

    n, v, e = shape
    shard = v // TP_DEGREE
    g = torch.Generator(device="cuda").manual_seed(19)
    h, w, labels = _ce_inputs(torch, g, n, v, e, "bfloat16", "bfloat16", n // 16)
    edges = torch.tensor([r * shard + d for r in range(TP_DEGREE) for d in (-1, 0) if 0 <= r * shard + d < v],
                         device="cuda")
    labels[:edges.numel()] = edges
    gm = (labels != -100).float()  # the gradient of the sum, as phase 1 holds it
    lse_w, corr_w = fce.fused_ce_forward(h, w, labels)
    dh_w = fce.fused_ce_backward_dh(h, w, labels, lse_w, gm)
    dw_w = fce.fused_ce_backward_dw(h, w, labels, lse_w, gm)
    torch.cuda.synchronize()
    _reset_counts()
    lse, corr, dh, dw = vce.fused_ce_in_process(h, w, labels, TP_DEGREE, gm)
    torch.cuda.synchronize()
    counts = _launch_counts(("ce_fwd", "ce_dh", "ce_dw"))
    if counts != {"ce_fwd": TP_DEGREE, "ce_dh": TP_DEGREE, "ce_dw": TP_DEGREE}:
        raise AssertionError(f"fused CE at tp {TP_DEGREE}: launches {counts}")
    what = f"fused CE on {TP_DEGREE} vocab shards of {shard}, h[{n},{e}] w[{v},{e}] bf16"
    lse_err = check_close(torch, lse, lse_w, 1e-4, 0.0, f"{what}: lse against the whole call")
    corr_err = check_close(torch, corr, corr_w, 1e-4, 0.0, f"{what}: corr against the whole call")
    lse_p, _ = fce.reference_fused_ce_forward(h, w, labels)
    dh_p, dw_p = fce.reference_fused_ce_backward(h.float(), w.float(), labels, lse_p, gm)
    del lse_p
    rel = CE_ROW_REL["bfloat16"]
    dh_err = _row_check(torch, dh, dh_p, rel, f"{what}: dh against the plain fp32 gradient")
    dh_whole = _row_check(torch, dh_w, dh_p, rel, f"{what}: the whole call's dh against the plain fp32 gradient")
    dw_err = _row_check(torch, dw, dw_p, rel, f"{what}: dW against the plain fp32 gradient")
    bitwise = bool(torch.equal(dw, dw_w))
    same_lse = torch.cat([fce.fused_ce_backward_dw(h, s_, labels.long() - r * shard, lse_w, gm)
                          for r, s_ in enumerate(w.chunk(TP_DEGREE, dim=0))])
    bitwise_same_lse = bool(torch.equal(same_lse, dw_w))
    del dh_p, dw_p, same_lse
    torch.cuda.empty_cache()
    shard_ms = time_ms(torch, lambda: vce.fused_ce_in_process(h, w, labels, TP_DEGREE, gm), reps=3)
    whole_ms = time_ms(torch, lambda: (fce.fused_ce_forward(h, w, labels),
                                       fce.fused_ce_backward_dh(h, w, labels, lse_w, gm),
                                       fce.fused_ce_backward_dw(h, w, labels, lse_w, gm)), reps=3)
    log(f"[phase 8c] {what}: launches {counts}; against one whole-vocabulary call lse max abs err {lse_err:.3g}, "
        f"corr {corr_err:.3g} (bound 1e-4); dh worst row rel err (share of allowance used) {dh_err[0]:.4g} "
        f"({dh_err[1]:.2f}) against the plain fp32 gradient (the whole call's {dh_whole[0]:.4g} ({dh_whole[1]:.2f})), "
        f"bound {rel:g}; dW {dw_err[0]:.4g} ({dw_err[1]:.2f}); the dW shards bitwise the whole dW's rows: {bitwise} "
        f"(max abs diff {float((dw.float() - dw_w.float()).abs().max()):.3g}); with the whole call's lse: "
        f"{bitwise_same_lse}")
    log(f"[phase 8c] {TP_DEGREE} shards' forward, dh and dW and the combine, one after another: {shard_ms:.3f} ms, "
        f"against one whole-vocabulary forward, dh and dW {whole_ms:.3f} ms ({smi}; informational)")
    del h, w, labels, gm, lse, corr, dh, dw, lse_w, corr_w, dh_w, dw_w
    torch.cuda.empty_cache()
    return counts


WARM_7B_CONFIG = "config_7b_warmstart_32k.yaml"
WARM_7B = {"layers": 4, "seq": 32768, "steps": 3}  # the recipe cut to 4 of its 32 layers, 3 steps of one sequence
# The written reckoning of the warmstart step's peak memory (PERF.md, section 6), before its first run: 15.4 GB of
# parameters, gradients and optimizer state (8a's 1.284 B parameters at 12 bytes), ~1.1 GB of layer-boundary
# activations (4 x 32768 x 4096 bf16), one layer's recompute at 32768 (~6 GB: q/k/v, the SwiGLU's 3 x 14336-wide
# activations, norms) and the fused head's h, dh and bf16 dW (~1 GB): about 25 GB, at most 40
WARM_7B_PEAK_GB = 40.0
WARM_7B_LR = 0.00006  # the file's max_lr: the witness's lr


def _run_form(warm_config: Path, out: Path) -> Path:
    """The warmstart config as a config that runs from step 0 (for the
    witness runs, which have no checkpoint): training progress 0, the raw app
    state, no warmstart paths; cp and tp 1 (one card)."""
    import yaml

    cfg = yaml.safe_load(warm_config.read_text())
    cfg["settings"]["training_progress"] = {"global_num_seen_tokens": 0, "num_seen_steps": 0, "num_seen_samples": 0,
                                            "last_step": -1}
    del cfg["settings"]["warmstart_checkpoint_paths"]
    cfg["app_state"] = cfg.pop("app_state_raw")
    cfg["device_mesh"]["config"].update(context_parallel_degree=1, tensor_parallel_degree=1)
    out.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return out


def phase_warmstart_7b(torch, smi: str, tmp: Path, pretrain: dict) -> dict[str, int]:
    """8d: the recipe's chain, pretrain to warmstart. `warmstart` (the
    `__main__.warmstart` function) on configs/config_7b_warmstart_32k.yaml
    from the folder 8a saved (`pretrain`: 8a's saved parameters, steps,
    tokens, last loss), cut where one card forces it: world 1 (dp_shard 1, cp
    1, tp 1), 4 of 32 layers, the targets (3 steps past 8a's) and intervals
    (no checkpoint of its own: a second ~10 GB save would not fit the
    script's time). Everything else as the file has it: full width, SwiGLU
    14336, RoPE base 500000, full remat, lm_head_chunk_size 2048 (the
    fused-CE head at E 4096), the untied head, one sequence of 32768 a step.
    Checks: the progress (steps, tokens) read from the folder's name; the
    loaded parameters bitwise 8a's saved ones; losses finite, the first
    within 0.5 of 8a's last; exact launches per step (remat: flash forward 2
    a layer; RMSNorm 4 a layer + 1 forward, 2 a layer + 1 backward; CE 1
    each); peak memory within WARM_7B_PEAK_GB; a profiled step. Then the same
    config at full width, 4 layers x 4096, through the kernels and through
    the plain path (chunked-scan head) from step 0 (`lr_witness`). Returns
    the warmstart's launch counts."""
    from modalities_tpu_torch.__main__ import warmstart
    from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_loading import DCPCheckpointLoading
    from modalities_tpu_torch.main import Main

    rng = np.random.default_rng(2033)
    layers, seq, steps = (WARM_7B[k] for k in ("layers", "seq", "steps"))
    vocab = SEVEN_B["vocab"]
    seen_steps, seen_tokens = pretrain["steps"], pretrain["tokens"]
    cuts = {"device_mesh.config.context_parallel_degree": 1, "device_mesh.config.tensor_parallel_degree": 1,
            "model_raw.config.n_layer": layers,
            "settings.training_target.num_target_steps": seen_steps + steps,
            "settings.training_target.num_target_tokens": seen_tokens + steps * seq}
    corpus = rng.integers(0, vocab, size=seq + 1 + (steps + 3) * seq)
    cfg = _train_config(tmp, "warm_7b", corpus, steps, cuts, seq=seq, base=WARM_7B_CONFIG, micro=1, acc=1,
                        phase="phase 8d")
    info = tmp / "checkpoints" / "last_checkpoint_info.json"
    loaded: dict = {}
    load_s = []
    load = DCPCheckpointLoading.load_app_state

    build = Main.build_components

    def load_then_copy(self, app_state, folder):
        t0 = time.perf_counter()
        load(self, app_state, folder)
        load_s.append(time.perf_counter() - t0)
        loaded.update(_host_copy(app_state.train_step))

    def build_and_keep(self):  # the run's components, for its progress and the profiled step
        self.components = build(self)
        return self.components

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    DCPCheckpointLoading.load_app_state, Main.build_components = load_then_copy, build_and_keep
    try:
        t0 = time.perf_counter()
        main, results = warmstart(cfg, info, experiments_root_path=tmp / "experiments", device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        DCPCheckpointLoading.load_app_state, Main.build_components = load, build
    counts = _launch_counts(LONG_KERNELS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    progress = main.components.settings.training_progress
    losses = [r["losses"]["train loss last"] for r in results]
    norms = [r["metrics"]["grad norm last"] for r in results]
    done = [r["num_train_steps_done"] for r in results]
    consumed = results[-1]["metrics"]["consumed tokens"] if results else None
    if (progress.num_seen_steps, progress.global_num_seen_tokens) != (seen_steps, seen_tokens) or \
            done != list(range(seen_steps + 1, seen_steps + steps + 1)) or consumed != seen_tokens + steps * seq:
        raise AssertionError(f"7B warmstart: progress from the folder (steps, tokens) "
                             f"{(progress.num_seen_steps, progress.global_num_seen_tokens)}, steps run {done}, "
                             f"consumed tokens {consumed}; expected {(seen_steps, seen_tokens)}, steps "
                             f"{seen_steps + 1}..{seen_steps + steps}, {seen_tokens + steps * seq}")
    unequal = [k for k in pretrain["params"] if not torch.equal(pretrain["params"][k], loaded.get(k))]
    if len(load_s) != 1 or unequal or set(loaded) != set(pretrain["params"]):
        raise AssertionError(f"7B warmstart: {len(load_s)} loads; parameters unequal to 8a's saved ones: "
                             f"{unequal[:5]} ({len(unequal)}), keys equal: {set(loaded) == set(pretrain['params'])}")
    if not all(math.isfinite(x) for x in losses + norms) or abs(losses[0] - pretrain["loss"]) > 0.5:
        raise AssertionError(f"7B warmstart: losses {losses}, grad norms {norms}; the first not within 0.5 of "
                             f"8a's last {pretrain['loss']}")
    for key, want in remat_launches(layers).items():
        if counts[key] != want * steps:
            raise AssertionError(f"7B warmstart: {key} launched {counts[key]} times in {steps} steps, expected "
                                 f"{want} per step")
    if peak_gb > WARM_7B_PEAK_GB:
        raise AssertionError(f"7B warmstart: peak memory {peak_gb:.2f} GB above the reckoning's {WARM_7B_PEAK_GB} GB")
    log(f"[phase 8d] {WARM_7B_CONFIG} through `warmstart` from 8a's step-{seen_steps} folder, cut to world 1 "
        f"(dp_shard 1, cp 1, tp 1) and {layers} of 32 layers, one sequence of {seq}, full remat, fused-CE head "
        f"({main.train_step.num_parameters / 1e9:.3f} B parameters): {steps} steps in {wall:.1f} s (load_app_state "
        f"{load_s[0]:.2f} s: manifest, shape gate, dcp.load, set_state_dict); progress from the folder's name: "
        f"{seen_steps} steps, {seen_tokens} tokens; steps {done}, consumed tokens {consumed}; all "
        f"{len(loaded)} loaded parameter tensors bitwise 8a's saved ones; losses {[round(x, 5) for x in losses]} "
        f"(8a's last {pretrain['loss']:.5f}), grad norms {[round(x, 5) for x in norms]}; launches per step "
        f"{({k: v // steps for k, v in counts.items()})}; peak memory {peak_gb:.2f} GB "
        f"(torch.cuda.max_memory_allocated; reckoning at most {WARM_7B_PEAK_GB} GB), {reserved_gb:.2f} GB reserved")
    for r in results[1:]:
        th = r["throughput_metrics"]
        log(f"[phase 8d] step {r['num_train_steps_done']}: {1e3 / th['train steps/s']:.1f} ms, "
            f"{th['tokens/s']:.1f} tokens/s, MFU {th['MFU']:.4f} vs 989.4 TFLOP/s ({smi}; informational)")
    profile_train_step(torch, main, smi, phase="phase 8d")
    del main, results, loaded
    pretrain.pop("params")
    gc.collect()
    torch.cuda.empty_cache()
    run_cfg = _run_form(Path(__file__).resolve().parent / "configs" / WARM_7B_CONFIG, tmp / "warm_7b_run_form.yaml")
    lr_witness(torch, tmp, rng, *LONG_WITNESS, lr=WARM_7B_LR, vocab=vocab, keys=LONG_KERNELS, phase="phase 8d",
               plain_extra={"model_raw.config.lm_head_fused_ce": "off"}, base=run_cfg, micro=1, acc=1)
    return counts


# ---------------------------------------------------------------- phase 9
# the schedules phase 9 runs in one process over pp 2, 4 microbatches of 1 x 4096: (name, virtual chunks)
PP_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("interleaved_1f1b", 2), ("zbv", 2))
PP_DEGREE, PP_MICROBATCHES = 2, 4
# Bounds against 8a's step (the 4 sequences as one microbatch). The pipelined step runs each sequence as a
# microbatch of its own: its bf16 weight gradients are rounded once per microbatch and summed in fp32, where 8a
# rounds one product over all 16384 rows once (each element's partial off by up to 2^-9 relative), and its fp32
# loss adds 4 partial sums. So the loss within 1e-5 of 8a's (relative; its logits are the same rows' fp32 head),
# the grad norm within 1e-3 (a norm averages the elements' rounding), and each parameter's move (Adam's first step
# moves an element by about lr, its sign the gradient's) within 0.25 of 8a's move in norm: elements whose four
# partials nearly cancel may flip sign (each flip 2 lr); a stage whose move went missing or wrong reads 1 or more.
PP_LOSS_REL, PP_NORM_REL, PP_MOVE_REL = 1e-5, 1e-3, 0.25


def pp_launches(layers: int, microbatches: int, stages: int, deferred_w: bool) -> dict[str, int]:
    """A pipelined step's launches at `layers` (no remat): every block's forward
    and backward once a microbatch; ZBV's input-gradient pass runs the
    backward of every global stage but the first once more (its blocks, and
    the head norm on the last)."""
    counts = {"flash_fwd": layers, "flash_dq": layers, "flash_dkv": layers, "rms_fwd": 2 * layers + 1,
              "rms_bwd": 2 * layers + 1}
    if deferred_w:
        again = layers - layers // stages
        counts.update(flash_dq=layers + again, flash_dkv=layers + again, rms_bwd=2 * (layers + again) + 1 + 1)
    return {k: v * microbatches for k, v in counts.items()}


def phase_pipeline_7b(torch, smi: str, tmp: Path) -> dict[str, dict[str, int]]:
    """9: pipeline parallelism at the 7B's full width, in one process. The
    8a config (configs/config_7b_tp_fsdp.yaml at world 1, 4 of 32 layers,
    the 4 sequences of 4096 of its first step, the same init) split over pp
    2 (parallel/pipeline.py: device 0 the embeddings and the first layers,
    device 1 the rest, lm_head_norm and the head), run by
    parallel/pipeline_scheduled.py's executor over the in-process transport
    (`pp_in_process`, through `TrainStep(pp_in_process=2)` on 8a's world-1
    mesh: each stage a root of FSDP2 on the world-1 NCCL group, so the head
    runs inside the stage's FSDP forward and every B op's gradients go
    through FSDP2's reduction), each sequence a microbatch (M 4), for gpipe, 1f1b, interleaved_1f1b (2 chunks a device,
    a layer a chunk) and zbv. Each schedule's step against 8a's unpipelined
    world-1 step (the same weights and sequences): loss, grad norm and every
    parameter after the step within the stated bounds; and against the same
    unpipelined step taking the 4 sequences as 4 accumulation microbatches
    (what the pipeline computes per microbatch), where any difference is the
    order of fp32 sums (printed; bitwise where it is). The warmup's first
    rate is 0, which would move nothing, so the schedule starts at the
    file's max_lr. Exact flash and RMSNorm launches per schedule; each
    schedule's second step timed, with its peak memory and a profiled step's
    busy share. The 1F1B tables with two microbatches' B ops swapped are
    refused before any launch."""
    from torch.distributed.fsdp import FSDPModule

    from modalities_tpu_torch.main import Main
    from modalities_tpu_torch.parallel.pipeline_scheduled import mutant_tables, pp_in_process
    from modalities_tpu_torch.running_env.device_mesh import DeviceMesh
    from modalities_tpu_torch.trainer import stack_microbatches
    from modalities_tpu_torch.training.train_step import TrainStep

    rng = np.random.default_rng(2031)  # 8a's corpus
    layers, micro, seq, vocab = (SEVEN_B[k] for k in ("layers", "micro", "seq", "vocab"))
    corpus = rng.integers(0, vocab, size=seq + 1 + micro * (3 + 3) * seq)
    max_lr = 3e-4
    cfg = _train_config(tmp, "pp_7b", corpus, 3, {"device_mesh.config.tensor_parallel_degree": 1,
                                                   "device_mesh.config.enable_loss_parallel": False,
                                                   "model_raw.config.n_layer": layers,
                                                   "scheduler.config.initial_lr": max_lr},
                        seq=seq, base=SEVEN_B_CONFIG, micro=micro, acc=1, phase="phase 9")
    main = Main(cfg, experiments_root_path=tmp / "experiments", device="cuda")
    comp = main.build_components()
    spec = comp.app_state
    model = spec.model
    batch = stack_microbatches([next(iter(comp.train_dataloader))], torch.device("cuda"))  # 8a's first step
    as_acc = {part: {k: v.reshape(micro, 1, seq) for k, v in d.items()} for part, d in batch.items()}
    mp = model.train_spec.mixed_precision  # TrainStep's own draw: in the policy's dtypes, from the model's seed
    model.with_spec_updates(param_dtype=mp.param_dtype, compute_dtype=mp.compute_dtype)
    init = model.init_train_params(torch.Generator(device="cuda").manual_seed(model.seed))
    mesh = comp.device_mesh or DeviceMesh(world_size=1)  # 8a's: the world-1 NCCL group, every stage under FSDP2

    def step_of(acc: int = 1, pipeline=None):
        if pipeline is not None:
            model.with_spec_updates(pp_schedule=pipeline[0], pp_num_microbatches=PP_MICROBATCHES,
                                    pp_num_virtual=pipeline[1])
        return TrainStep(model, comp.loss_fn, spec.optimizer, spec.lr_scheduler, device=torch.device("cuda"),
                         gradient_acc_steps=acc, grad_clipper=comp.gradient_clipper,
                         params={k: v.clone() for k, v in init.items()}, device_mesh=mesh,
                         pp_in_process=PP_DEGREE if pipeline is not None else None)

    def run(step, b):
        m = step(b)
        return [float(m[k]) for k in ("loss", "grad_norm", "lr")], {k: v.detach().clone() for k, v in
                                                                     step.state_dict().items()}

    ref, ref_params = run(step_of(), batch)
    if f"{ref[0]:.5f}" != SEVEN_B_STEP0:
        raise AssertionError(f"phase 9: the unpipelined step's loss {ref[0]:.5f} is not 8a's {SEVEN_B_STEP0}")
    gc.collect()
    acc_ref, acc_params = run(step_of(acc=micro), as_acc)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase 9] {SEVEN_B_CONFIG} at 4 layers, world 1 ({smi}): 8a's step {ref} (loss, grad norm, lr at the "
        f"schedule's first rate {max_lr}); the 4 sequences as 4 accumulation microbatches {acc_ref}")

    counts: dict[str, dict[str, int]] = {}
    for name, virtual in PP_SCHEDULES:
        step = step_of(pipeline=(name, virtual))
        if not all(isinstance(st.module, FSDPModule) for st in step.stages):
            raise AssertionError(f"phase 9 {name}: a stage is not sharded with fully_shard")
        tables = step._tables(PP_DEGREE, PP_MICROBATCHES)
        if name == "1f1b":  # a swapped pair of B ops: refused before any launch
            _reset_counts()
            rejected = _rejects(lambda: pp_in_process(step.stages, mutant_tables(tables, 0, 0, 1),
                                                      list(batch["samples"]["input_ids"][0].chunk(PP_MICROBATCHES)),
                                                      lambda module, hidden, m: hidden.sum()), ValueError)
            if any(_launch_counts().values()):
                raise AssertionError("phase 9: the refused tables launched kernels")
            log(f"[phase 9] 1f1b with device 0's B ops of microbatches 0 and 1 swapped: refused ({rejected})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        got, got_params = run(step, batch)
        counts[name] = _launch_counts()
        want = pp_launches(layers, PP_MICROBATCHES, tables.num_stages_global, tables.deferred_w)
        if counts[name] != want:
            raise AssertionError(f"phase 9 {name}: launches {counts[name]}, expected {want}")
        loss_rel, norm_rel = abs(got[0] / ref[0] - 1), abs(got[1] / ref[1] - 1)
        moves = {k: float((got_params[k].float() - ref_params[k].float()).norm()
                          / (ref_params[k].float() - init[k].float()).norm().clamp(min=1e-30)) for k in ref_params}
        worst = max(moves, key=moves.get)
        if set(got_params) != set(ref_params) or loss_rel > PP_LOSS_REL or norm_rel > PP_NORM_REL \
                or moves[worst] > PP_MOVE_REL or got[2] != ref[2]:
            raise AssertionError(f"phase 9 {name}: {got} against 8a's {ref} (loss rel {loss_rel:.3e} > "
                                 f"{PP_LOSS_REL}? norm rel {norm_rel:.3e} > {PP_NORM_REL}?), worst move {worst} "
                                 f"{moves[worst]:.4f} (bound {PP_MOVE_REL})")
        bitwise = [k for k in acc_params if torch.equal(got_params[k], acc_params[k])]
        acc_move = max(float((got_params[k].float() - acc_params[k].float()).norm()
                             / (acc_params[k].float() - init[k].float()).norm().clamp(min=1e-30)) for k in acc_params)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del got_params
        # timing: the second step (warm), then a profiled third
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        busy, device_ms, wall_ms = _busy_share(torch, lambda: step(batch))
        log(f"[phase 9] {name} (pp {PP_DEGREE}, {tables.num_virtual} chunk(s) a device, M {PP_MICROBATCHES}, "
            f"{tables.num_ticks} ticks, bubble {tables.bubble_fraction:.3f}, at most {tables.max_inflight} "
            f"microbatches in flight): {got}; against 8a loss rel {loss_rel:.3e}, grad norm rel {norm_rel:.3e}, "
            f"worst parameter move {worst} {moves[worst]:.4f} of its own; against the 4 accumulation microbatches "
            f"loss {'bitwise' if got[0] == acc_ref[0] else f'rel {abs(got[0] / acc_ref[0] - 1):.3e}'}, grad norm "
            f"{'bitwise' if got[1] == acc_ref[1] else f'rel {abs(got[1] / acc_ref[1] - 1):.3e}'}, {len(bitwise)} of "
            f"{len(acc_params)} parameters bitwise (worst move {acc_move:.2e} of its own); launches {counts[name]}")
        log(f"[phase 9] {name}: step {step_ms:.1f} ms, peak {peak:.2f} GB (torch.cuda.max_memory_allocated), "
            f"profiled {device_ms:.1f} ms of kernels in {wall_ms:.1f} ms -> busy {busy:.3f} ({smi}; in one process "
            "the stages take turns: no bubble, no exchange)")
        del step
        gc.collect()
        torch.cuda.empty_cache()
    del main, comp, init, ref_params, acc_params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 10
# ZeRO-1, cross-slice data parallelism and the row-parallel bias, on configs/config_2p7b_dp.yaml at full width and
# depth (2 microbatches of 2 x 4096, as phase 4 runs it). 10b and 10c take one step at the warmup-free rates of
# phase 4's repeated-batch run (lr 1.6e-5 at step 1; the config's own schedule starts at 0, which would leave the
# parameters where they were)
ZERO_REPLICAS = 4
DCN_SLICES = 2
ONE_STEP_RATES = {"scheduler.config.warmup_steps": 1, "scheduler.config.initial_lr": 0.000016,
                  "scheduler.config.max_lr": 0.000016, "scheduler.config.final_lr": 0.0000016}
# The global p2 norm summed over ZeRO chunks (or over the slices' averaged gradients) against one summed over the
# whole leaves: the same fp32 squares added in another order, each leaf's sum of up to 1.3e8 squares; 1e-5
# relative is ~100 fp32 ulps, and a chunk or slice that was lost or counted twice moves it by O(1)
NORM_REL = 1e-5
# A bf16 parameter or moment updated with a clip coefficient or gradient that differs in its last fp32 bits can
# round to the neighbouring bf16 value: one bf16 ulp, at most 2^-7 of the value (2^-133 absolute near 0 is below
# every element here). A wrong chunk, a stale chunk or an update applied twice is off by ~lr or more
BF16_ULP_REL = 2.0 ** -7


def _ulp_check(torch, got, want, what: str) -> float:
    """Largest |got - want| / |want| (elements equal count 0); raises when an
    element differs by more than one bf16 ulp of |want|."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs()
    bad = diff > BF16_ULP_REL * scale
    if bad.any():
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"{what}: {int(bad.sum())} elements differ by more than one bf16 ulp (first: "
                             f"{got.flatten()[i].item()} vs {want.flatten()[i].item()})")
    return float((diff / scale.clamp_min(1e-30)).max()) if diff.numel() else 0.0


def _expect_launches(counts: dict[str, int], per_pass: dict[str, int], passes: int, what: str) -> None:
    """Exact launches of `passes` forward/backward passes of a path."""
    want = {k: v * passes for k, v in per_pass.items()}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want} ({passes} passes of {per_pass})")


# one forward/backward pass of the 2.7B (32 blocks, 65 RMSNorms: two a block and the head's)
PASS_2P7B = {"flash_fwd": 32, "flash_dq": 32, "flash_dkv": 32, "rms_fwd": 65, "rms_bwd": 65}


def _one_step_batch(torch, main, components, acc: int):
    from modalities_tpu_torch.trainer import stack_microbatches

    loader = iter(components.train_dataloader)
    return stack_microbatches([next(loader) for _ in range(acc)], torch.device("cuda"))


def phase_zero_inert(torch, smi: str, tmp: Path, want: dict) -> dict[str, int]:
    """10a: the 2.7B config with `zero_stage: 1` and `dcn_parallel_degree:
    -1` through Main, phase 4's corpus and 3 steps: at dp_replicate 1 ZeRO-1
    is the stage-0 program (JAX train_step.py:268-272) and -1 is one slice,
    so every step's (loss, grad norm, lr) is bitwise phase 4's; the same
    launches a step."""
    from modalities_tpu_torch.main import Main

    seq, steps = 4096, 3
    corpus = np.random.default_rng(2027).integers(0, MODEL_2P7B["vocab_size"], size=seq + 1 + (4 * steps + 3) * seq)
    cfg = _train_config(tmp, "train_zero1", corpus, steps, {"device_mesh.config.zero_stage": 1,
                                                             "device_mesh.config.dcn_parallel_degree": -1},
                        phase="phase 10a")
    main = Main(cfg, experiments_root_path=tmp / "experiments", device="cuda")
    main.components = main.build_components()
    _reset_counts()
    t0 = time.perf_counter()
    results = main.run(main.components)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    got = _step_metrics(results)
    if main.train_step.zero is not None or main.train_step.mesh.mesh_axes != {"dp_shard": 1}:
        raise AssertionError(f"zero_stage 1 at world 1: ZeRO active or mesh {main.train_step.mesh.mesh_axes}")
    if got != want:
        raise AssertionError(f"zero_stage 1 at dp_replicate 1: steps {got} != phase 4's {want}")
    _expect_launches(counts, PASS_2P7B, 2 * steps, "zero_stage 1 at world 1")
    ms = [1e3 / r["throughput_metrics"]["train steps/s"] for r in results[1:]]
    log(f"[phase 10a] 2.7B with zero_stage 1, dcn_parallel_degree -1 through Main (mesh {{'dp_shard': 1}}, ZeRO "
        f"inert at dp_replicate 1): steps 1-{steps} (loss, grad norm, lr) {[got[k] for k in sorted(got)]} bitwise "
        f"phase 4's; launches {counts} ({ {k: v // steps for k, v in counts.items()} } a step); step ms "
        f"{[round(x, 1) for x in ms]} ({smi}); {wall:.1f} s")
    del main, results
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _phase10_step(main, components, **kw):
    """A world-1 TrainStep of `components`, built as Main builds it, from the
    model's seeded initial parameters (the same in every step so built)."""
    from modalities_tpu_torch.running_env.device_mesh import DeviceMesh
    from modalities_tpu_torch.training.train_step import TrainStep

    app_state = components.app_state
    return TrainStep(app_state.model, components.loss_fn, app_state.optimizer, app_state.lr_scheduler,
                     device=main.device, gradient_acc_steps=components.settings.step_profile.gradient_accumulation_steps,
                     grad_clipper=components.gradient_clipper, device_mesh=DeviceMesh(world_size=1), **kw)


def phase_zero4_in_process(torch, smi: str, tmp: Path) -> dict[str, int]:
    """10b: one step of the 2.7B with ZeRO-1 over 4 dp_replicate replicas in
    this process (`TrainStep(zero_in_process=4)` on the world-1 group: the
    train step's ZeRO path, parallel/zero.py's `Zero1` over
    `InProcessReplicas`: the rule on the parameters' placements, the chunk
    buffers refreshed from the parameters, the reduce-scatter (the replicas'
    chunks of the one accumulator, which holds every replica's rows), the
    norm over the chunks, clipping, the chunks' AdamW, the gather back into
    the parameters; its launches counted), against the stage-0 step of the
    same config from the same initial parameters on the same batch, run
    first, whose accumulated gradient, parameters before the update and
    results are kept on the host. Held: the loss bitwise; the norm within
    NORM_REL of stage 0's; every replica's moment chunks and the gathered
    parameters bitwise an unsplit AdamW on the stage-0 gradient clipped by
    the chunks' norm (leaf by leaf); against the stage-0 step itself bitwise
    where the two norms' bits agree, else within one bf16 ulp (BF16_ULP_REL).
    The NCCL reduce-scatter and all-gather of `ReplicaGroup` do not run: one
    card. Prints the moment bytes a replica holds at stage 0 and at R = 4,
    and the ZeRO step's peak memory."""
    from modalities_tpu_torch.main import Main
    from modalities_tpu_torch.parallel.zero import chunk
    from modalities_tpu_torch.training import train_step as ts

    seq = 4096
    corpus = np.random.default_rng(2031).integers(0, MODEL_2P7B["vocab_size"], size=seq + 1 + 6 * seq)
    cfg = _train_config(tmp, "zero4", corpus, 1, ONE_STEP_RATES, phase="phase 10b")
    main = Main(cfg, experiments_root_path=tmp / "experiments", device="cuda")
    components = main.build_components()
    spec, max_norm = components.app_state.optimizer, components.gradient_clipper.max_norm
    step = _phase10_step(main, components)
    batch = _one_step_batch(torch, main, components, step.acc_steps)
    names = [n for n, _ in step.module.named_parameters()]
    host = {}
    clip = ts.clip_

    def recording(grads, norm, max_norm, mode):  # the stage-0 gradient and parameters before it clips and updates
        host.update(grads=[ts._local(g).detach().cpu() for g in grads],
                    before=[ts._local(p).detach().cpu() for p in step.params])
        return clip(grads, norm, max_norm, mode)

    ts.clip_ = recording
    try:
        want = step(batch)
    finally:
        ts.clip_ = clip
    stage0_norm = want["grad_norm"].clone()
    host["after"] = [ts._local(p).detach().cpu() for p in step.params]
    host["moments"] = [{k: ts._local(v).cpu() for k, v in step.optimizer.state[p].items() if k != "step"}
                       for p in step.params]
    stage0_bytes = sum(t.numel() * t.element_size() for m in host["moments"] for t in m.values())
    del step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    step = _phase10_step(main, components, zero_in_process=ZERO_REPLICAS)
    zero = step.zero
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(batch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _expect_launches(counts, PASS_2P7B, step.acc_steps, "zero4 in process")
    lr, norm = float(metrics["lr"]), metrics["grad_norm"]
    if not torch.equal(metrics["loss"], want["loss"]) or lr != float(want["lr"]):
        raise AssertionError(f"zero4: loss {float(metrics['loss'])}, lr {lr} vs stage 0's {float(want['loss'])}, "
                             f"{float(want['lr'])}")
    rank_bytes = [sum(t.numel() * t.element_size() for (i, r), b in zip(zero.slots, zero.buffers) if r in (None, rep)
                      for k, t in step.optimizer.state[b].items() if k != "step") for rep in range(ZERO_REPLICAS)]
    norm_rel = abs(float(norm) - float(stage0_norm)) / float(stage0_norm)
    if norm_rel > NORM_REL:
        raise AssertionError(f"zero4: the chunks' norm {float(norm)} vs stage 0's {float(stage0_norm)}")
    bits_agree = torch.equal(norm, stage0_norm)
    step._acc = None  # the accumulators: room for the references
    slots_of: dict[int, list] = {}
    for (i, r), b in zip(zero.slots, zero.buffers):
        slots_of.setdefault(i, []).append((r, b))
    worst = 0.0
    for i, (name, d) in enumerate(zip(names, zero.dims)):
        # the unsplit update on the stage-0 gradient, clipped by the chunks' norm: bitwise the gathered chunks
        whole = host["before"][i].cuda()
        whole.grad = host["grads"][i].cuda()
        clip([whole.grad], norm, max_norm, ts.GradientClippingMode.P2_NORM)
        reference = spec.build([(name, whole)])
        for group in reference.param_groups:
            group["lr"] = lr
        reference.step()
        got = ts._local(step.params[i]).detach()
        if not torch.equal(got, whole):
            raise AssertionError(f"zero4 {name}: the gathered chunks differ from the unsplit update")
        for key in ("exp_avg", "exp_avg_sq"):
            ref = reference.state[whole][key]
            stage0 = host["moments"][i][key].cuda()
            for r, b in slots_of[i]:
                mine = step.optimizer.state[b][key]
                if not torch.equal(mine, ref if r is None else chunk(ref, d, ZERO_REPLICAS, r)):
                    raise AssertionError(f"zero4 {name} {key}: replica {r}'s chunk differs from the unsplit moment")
            if bits_agree and not torch.equal(ref, stage0):
                raise AssertionError(f"zero4 {name} {key}: differs from stage 0's with the same norm bits")
            worst = max(worst, _ulp_check(torch, ref, stage0, f"zero4 {name} {key} vs stage 0"))
        after = host["after"][i].cuda()
        if bits_agree and not torch.equal(got, after):
            raise AssertionError(f"zero4 {name}: differs from stage 0's parameter with the same norm bits")
        worst = max(worst, _ulp_check(torch, got, after, f"zero4 {name} vs stage 0"))
        del whole, reference, stage0, after
    split = sum(d is not None for d in zero.dims)
    log(f"[phase 10b] ZeRO-1 over {ZERO_REPLICAS} replicas in this process (TrainStep(zero_in_process="
        f"{ZERO_REPLICAS}), one 2.7B step, lr {lr:g}): {split} of {len(zero.dims)} leaves split (the others keep the "
        f"whole leaf on every replica); loss {float(metrics['loss']):.6f} bitwise stage 0's; grad norm "
        f"{float(norm):.6f} over the chunks vs {float(stage0_norm):.6f} at stage 0 (rel {norm_rel:.2e}, bound "
        f"{NORM_REL:g}; bits {'agree' if bits_agree else 'differ'}); every replica's moment chunks and the gathered "
        f"parameters bitwise the unsplit AdamW on the same clipped gradient; against stage 0 largest rel diff "
        f"{worst:.3g} (bound one bf16 ulp, {BF16_ULP_REL:g}; bitwise required when the norm bits agree); moment "
        f"bytes a replica holds: {stage0_bytes / 1e9:.3f} GB at stage 0, {max(rank_bytes) / 1e9:.3f} GB at R = "
        f"{ZERO_REPLICAS} ({max(rank_bytes) / stage0_bytes:.4f} of stage 0); peak memory {peak_gb:.1f} GB with the "
        f"4 replicas' state in one process; launches {counts}, {step_ms:.1f} ms with its first-call warmup ({smi})")
    del step, zero, main, components, batch, host, slots_of
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_dcn2_in_process(torch, smi: str, tmp: Path) -> dict[str, int]:
    """10c: one step of the 2.7B with its 2 microbatches of 2 rows split over
    2 slices in this process (`TrainStep(dcn_in_process=2)` on the world-1
    group: slice k takes row k of each microbatch), slice 0's rows keeping
    only the first quarter of their targets, so the slices' token counts
    differ and each slice's loss is normalized by its own. Against a
    reference built on the card from the same model and initial parameters:
    each slice's rows run through the unsharded module as a world-1 step of
    their own (loss = its sum over its count, gradients by autograd,
    accumulated in fp32 over the microbatches), the slices' gradients
    averaged by hand, divided by the microbatches, the p2 norm, clipping and
    an AdamW of the config's at the step's rate. Held: loss and grad norm
    within NORM_REL, every parameter within one bf16 ulp (BF16_ULP_REL;
    bitwise is printed when it holds). Prints the mean of the slices'
    losses against the global token mean of the same rows."""
    from modalities_tpu_torch.main import Main
    from modalities_tpu_torch.training.gradient_clipping import GradientClippingMode, clip_
    from modalities_tpu_torch.training.train_step import _local

    seq = 4096
    corpus = np.random.default_rng(2033).integers(0, MODEL_2P7B["vocab_size"], size=seq + 1 + 6 * seq)
    cfg = _train_config(tmp, "dcn2", corpus, 1, ONE_STEP_RATES, phase="phase 10c")
    main = Main(cfg, experiments_root_path=tmp / "experiments", device="cuda")
    components = main.build_components()
    app_state = components.app_state
    acc = components.settings.step_profile.gradient_accumulation_steps
    step = _phase10_step(main, components, dcn_in_process=DCN_SLICES)
    batch = _one_step_batch(torch, main, components, acc)
    target_key = components.loss_fn.target_key
    kept = batch["targets"][target_key].shape[-1] // 4
    batch["targets"][target_key][:, 0, kept:] = components.loss_fn.ignore_index  # slice 0: a quarter of its tokens
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(batch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    counts = _launch_counts()
    _expect_launches(counts, PASS_2P7B, acc * DCN_SLICES, "dcn2 in process (a pass a slice a microbatch)")
    loss, norm, lr = (float(metrics[k]) for k in ("loss", "grad_norm", "lr"))
    after = {name: _local(p).detach() for name, p in step.module.named_parameters()}
    model, loss_fn, spec = app_state.model, components.loss_fn, app_state.optimizer
    max_norm = components.gradient_clipper.max_norm
    del step, main, components, app_state
    gc.collect()
    torch.cuda.empty_cache()

    # the reference: the same model's module, unsharded, from the same seeded initial parameters
    module = model.build_train_module(model.init_train_params(torch.Generator(device="cuda").manual_seed(model.seed)))
    named = list(module.named_parameters())
    params = [p for _, p in named]
    total = [torch.zeros(p.shape, dtype=torch.float32, device="cuda") for p in params]
    slice_losses, sums, token_counts = [], [], []
    for k in range(DCN_SLICES):
        mine = [torch.zeros_like(t) for t in total]
        slice_loss = torch.zeros((), device="cuda")
        for i in range(acc):
            rows = slice(k * 2 // DCN_SLICES, (k + 1) * 2 // DCN_SLICES)
            total_k, count_k = loss_fn.sum_and_count(module(batch["samples"][model.sample_key][i, rows]),
                                                     batch["targets"][target_key][i, rows])
            mb_loss = total_k / torch.clamp(count_k.float(), min=1.0)
            for a, g in zip(mine, torch.autograd.grad(mb_loss, params)):
                a.add_(g.float())
            slice_loss = slice_loss + mb_loss.detach()
            sums.append(float(total_k.detach()))
            token_counts.append(float(count_k))
        for t, a in zip(total, mine):
            t.add_(a)
        slice_losses.append(float(slice_loss) / acc)
        del mine
    grads = [((t / DCN_SLICES) / acc).to(p.dtype) for t, p in zip(total, params)]
    del total
    ref_norm = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in grads]).sum().sqrt()
    clip_(grads, ref_norm, max_norm, GradientClippingMode.P2_NORM)
    optimizer = spec.build(named)
    for group in optimizer.param_groups:
        group["lr"] = lr
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    ref_loss = sum(slice_losses) / DCN_SLICES
    for what, got, want in (("loss", loss, ref_loss), ("grad norm", norm, float(ref_norm))):
        if abs(got - want) > NORM_REL * abs(want):
            raise AssertionError(f"dcn2 in process: {what} {got} vs the per-slice reference {want}")
    worst, bitwise = 0.0, True
    for name, p in named:
        worst = max(worst, _ulp_check(torch, after[name], p.detach(), f"dcn2 {name} vs the reference"))
        bitwise = bitwise and torch.equal(after[name], p.detach())
    global_mean = sum(sums) / sum(token_counts)
    if abs(ref_loss - global_mean) < 1e-4:
        raise AssertionError(f"dcn2: the mask did not bite: mean of slices {ref_loss} vs global {global_mean}")
    log(f"[phase 10c] dcn_in_process at {DCN_SLICES} slices, one 2.7B step (2 microbatches of 2 x {seq}, slice k "
        f"row k; slice 0 keeps {kept} targets a row): slices' losses {[round(x, 6) for x in slice_losses]}, "
        f"their mean {loss:.6f} vs the reference's {ref_loss:.6f}; grad norm {norm:.6f} vs {float(ref_norm):.6f} "
        f"(bound rel {NORM_REL:g}); parameters {'bitwise' if bitwise else 'within one bf16 ulp'} the reference's "
        f"(largest rel diff {worst:.3g}, bound {BF16_ULP_REL:g}); the global token mean of the same rows "
        f"{global_mean:.6f}: the per-slice mean is {ref_loss - global_mean:+.6f} from it; launches {counts}, "
        f"{step_ms:.1f} ms with its first-call warmup ({smi})")
    del module, named, params, grads, optimizer, after
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_parallel_knobs(torch, smi: str, phase4_steps: dict) -> dict[str, dict[str, int]]:
    """Phase 10: ZeRO-1 inert at world 1 through Main (10a), ZeRO-1's chunked
    update for 4 virtual replicas (10b), two dcn slices in one process (10c),
    a 7B block with biases at tp 8 (10d); each path's launches counted from
    0 just before it."""
    scratch = Path(__file__).resolve().parent / "build"
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        counts = {"train_2p7b_zero1": phase_zero_inert(torch, smi, tmp, phase4_steps)}
        mark("phase 10a")
        counts["zero4_in_process"] = phase_zero4_in_process(torch, smi, tmp)
        mark("phase 10b")
        counts["dcn2_in_process"] = phase_dcn2_in_process(torch, smi, tmp)
        mark("phase 10c")
    counts["tp8_bias"] = phase_tp_block(torch, smi, bias=True, phase="phase 10d")
    mark("phase 10d")
    for path, c in counts.items():
        if any(v == 0 for v in c.values()):
            raise AssertionError(f"phase 10: a kernel of the {path} path was never launched: {c}")
    return counts


def _busy_share(torch, fn) -> tuple[float, float, float]:
    """fn() under torch.profiler: (device busy share, kernels' ms, wall ms)."""
    _, device_ms, wall_ms = _profiled(torch, fn)
    return device_ms / wall_ms, device_ms, wall_ms


def build_model(overrides: dict | None = None):
    """The 2.7B GPT2 of MODEL_2P7B, or with `overrides` (widths, depth,
    vocabulary; the norms and RoPE follow the width and heads)."""
    from modalities_tpu_torch.config.component_factory import ComponentFactory
    from modalities_tpu_torch.registry.components import COMPONENTS
    from modalities_tpu_torch.registry.registry import Registry

    @dataclasses.dataclass
    class _ModelOnly:
        model: Any

    config = json.loads(json.dumps(MODEL_2P7B))
    if overrides:
        config.update(overrides)
        width, heads = config["n_embd"], config["n_head_q"]
        config["attention_config"]["qkv_transforms"][0]["config"].update(n_embd=width, n_head=heads)
        for norm in ("attention_norm_config", "ffn_norm_config", "lm_head_norm_config"):
            config[norm]["config"]["ndim"] = width
    node = {"component_key": "model", "variant_key": "gpt2", "config": config}
    return ComponentFactory(Registry(COMPONENTS)).build_components({"model": node}, _ModelOnly).model


def make_requests() -> list[dict]:
    rng = np.random.default_rng(2024)
    reqs = []
    for i in range(9):
        length = int(rng.integers(32, 513))
        reqs.append({
            "prompt": rng.integers(0, MODEL_2P7B["vocab_size"], size=length).tolist(),
            "temperature": 0.8 if i in (2, 6) else 0.0,  # 7 greedy, 2 sampled
            "seed": 100 + i,
        })
    return reqs


def serve_phase(torch, model, params, quant: str, reqs: list[dict], device: str = "cuda") -> dict:
    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm
    from modalities_tpu_torch.serving.serve import ServingComponent

    component = ServingComponent(model, _IdTok(), max_batch_slots=SLOTS, cache_capacity=CAPACITY,
                                 max_new_tokens=NEW_TOKENS, quant={"weights": quant})
    component.device, component.params = torch.device(device), params
    rms0, qmm0 = rms_norm.launches, quant_matmul.launches
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    engine = component.build_engine()
    if device == "cuda":
        torch.cuda.synchronize()
    t_build = time.perf_counter() - t_build
    rids = [engine.submit(r["prompt"], NEW_TOKENS, temperature=r["temperature"], seed=r["seed"]) for r in reqs]
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    stats = dict(engine.stats())
    res = [results[r] for r in rids]
    for i, r in enumerate(res):
        if r.finish_reason not in ("budget", "eod"):
            raise AssertionError(f"{quant}: request {i} finished {r.finish_reason!r}")
    first_finish = min(r.finish_s for r in res[:SLOTS])
    if res[SLOTS].first_token_s < first_finish:
        raise AssertionError("the 9th request was admitted before any slot was freed")
    out = {
        "tokens": [r.tokens for r in res],
        "ttft_s": [r.ttft_s for r in res],
        "stats": stats,
        "wall_s": wall,
        "build_s": t_build,
    }
    if quant == "none":  # batch invariance: a greedy request alone == its batched tokens
        alone_rid = engine.submit(reqs[0]["prompt"], NEW_TOKENS, temperature=0.0, seed=reqs[0]["seed"])
        alone = engine.run()[alone_rid].tokens
        if alone != res[0].tokens:
            raise AssertionError("batch invariance: request 0 alone differs from its batched tokens")
    out["profile"] = profile_decode(torch, engine, reqs) if device == "cuda" else None
    out["forward_calls"] = engine.stats()["forward_calls"]
    out["rms_launches"] = rms_norm.launches - rms0
    out["qmm_launches"] = quant_matmul.launches - qmm0
    if quant == "fp8" and device == "cuda":  # the last engine of phases 2-3: its OOM forensics, not counted
        counted = rms_norm.launches, quant_matmul.launches
        serving_oom_drill(torch, engine, reqs[0]["prompt"])
        rms_norm.launches, quant_matmul.launches = counted
    if device == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del engine, component
        torch.cuda.empty_cache()
    return out


def serving_oom_drill(torch, engine, prompt: list) -> None:
    """The serving engine's OOM forensics on the card (JAX
    serving/engine.py:2553-2566): `oom@N` armed at the engine's next
    dispatch round; the run raises the resumable OutOfMemory and leaves
    `oom_dump_rank_0_step_N.json` (no telemetry sink: in the working
    directory, here a temporary one) with the levers and the card's memory."""
    from modalities_tpu_torch.resilience import faults
    from modalities_tpu_torch.resilience.errors import OutOfMemory

    step = engine._dispatch_seq + 1
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        faults.clear_faults()
        faults.arm_faults(f"oom@{step}")
        os.chdir(tmp)
        try:
            engine.submit(prompt, NEW_TOKENS, temperature=0.0, seed=0)
            try:
                engine.run()
            except OutOfMemory as e:
                error = str(e)
            else:
                raise AssertionError(f"phase 3: oom@{step} did not fire in the serving engine")
        finally:
            os.chdir(cwd)
            faults.clear_faults()
        dump = json.loads((Path(tmp) / f"oom_dump_rank_0_step_{step}.json").read_text())
    card = dump["device_memory"].get("cuda:0", {})
    if dump["event"] != "oom" or dump["step"] != step or not dump["suggested_levers"] or not card.get("bytes_limit"):
        raise AssertionError(f"phase 3: the serving OOM dump is incomplete: {sorted(dump)}, {card}")
    log(f"[phase 3] serving OOM drill: oom@{step} raised OutOfMemory ({error[:80]}...) and dumped the levers "
        f"{dump['suggested_levers'][:3]}, the card at {card['bytes_in_use'] / 1e9:.2f} GB in use of "
        f"{card['bytes_limit'] / 1e9:.2f} GB")


def profile_decode(torch, engine, reqs: list[dict], steps: int = 8) -> dict:
    """Where a decode step's time goes: torch.profiler over `steps` batched
    decode steps with all slots busy (prompts cut to one 64-token chunk).
    busy = summed device time of the window's kernels / the window's wall time."""
    for r in reqs[:SLOTS]:
        engine.submit(r["prompt"][:64], steps + 2, temperature=0.0, seed=r["seed"])
    t0 = time.monotonic()
    engine.step(t0)  # admissions (prefill) and the first decode step stay outside the window
    rows, device_ms, wall_ms = _profiled(torch, lambda: [engine.step(t0) for _ in range(steps)])
    engine.run()  # drain
    rows = [(ms / steps, count / steps, key) for ms, count, key in rows]  # per decode step
    device_ms /= steps
    qmm = [r for r in rows if "quant_mm" in r[2]]  # the dequant-matmul kernel's rows (none with bf16 weights)
    return {"wall_ms": wall_ms / steps, "device_ms": device_ms, "launches": sum(r[1] for r in rows), "top": rows[:8],
            "qmm_ms": sum(r[0] for r in qmm), "qmm_launches": sum(r[1] for r in qmm)}


def report_profile(name: str, r: dict) -> None:
    """Device time per decode step (profiled window) against the unprofiled
    run's host time per step: busy = device / host-step time."""
    p, s = r["profile"], r["stats"]
    step_ms = 1e3 * s["decode_seconds"] / s["decode_steps"]
    log(f"[{name}] decode step: {p['device_ms']:.3f} ms of kernels ({p['launches']:.0f} launches) per "
        f"{step_ms:.2f} ms step -> device busy {p['device_ms'] / step_ms:.3f} "
        f"(profiled window: {p['wall_ms']:.2f} ms/step under the profiler)")
    for ms, count, key in p["top"]:
        log(f"[{name}]   {ms:.4f} ms/step in {count:.0f} x {key[:90]}")
    if p["qmm_launches"]:
        log(f"[{name}] dequant-matmul: {p['qmm_ms']:.3f} ms of kernels per decode step in {p['qmm_launches']:.0f} "
            f"launches (phase 1 sums the bound of the uncut forward's 225 calls at M=8)")


def report_serve(name: str, r: dict) -> None:
    s = r["stats"]
    ttft = np.asarray(r["ttft_s"]) * 1e3
    log(f"[{name}] {s['decode_tokens']} decode tokens in {s['decode_steps']} steps, "
        f"{s['prefill_chunks']} prefill chunks; decode {s['decode_tokens'] / s['decode_seconds']:.1f} tokens/s "
        f"over this short trace (informational, not a throughput measurement) "
        f"({1e3 * s['decode_seconds'] / s['decode_steps']:.2f} ms/step, occupancy {s['slot_occupancy']:.3f}); "
        f"TTFT ms p50 {np.percentile(ttft, 50):.1f} max {ttft.max():.1f}; "
        f"prefill {s['prefill_seconds']:.2f} s, run wall {r['wall_s']:.2f} s; "
        f"KV cache {s['kv_pool_bytes'] / 1e9:.3f} GB, weights {s['weights_bytes'] / 1e9:.3f} GB, "
        f"peak mem {r['peak_mem_gb']:.1f} GB; engine build {r['build_s']:.1f} s")


def greedy_agreement(reqs, base, other) -> float:
    same = total = 0
    for req, a, b in zip(reqs, base, other):
        if req["temperature"] == 0.0:
            total += len(a)
            same += sum(x == y for x, y in zip(a, b))
    return same / total


# ---------------------------------------------------------------- phase 3b
PAGED_BLOCK = 16  # block size of phase 3b's pools; max_len CAPACITY (2048): a table of 128 blocks
# (b): the smallest pool the engine takes at max_len 2048 (one table of 128 blocks; the JAX guard refuses fewer)
PAGED_TIGHT_BLOCKS = 128
SPEC_K = 4
SHARED_PREFIX = 256  # (c): tokens the sharing requests have in common, 16 full blocks
SIDE_NEW_TOKENS = 32  # (c), (d): budgets of the sharing and speculation requests
# kernel launches a forward of a GPT2 of n layers: two RMSNorms a block + lm_head_norm; 7 dense layers a block + the head
def per_forward(layers: int) -> dict[str, int]:
    return {"rms": 2 * layers + 1, "qmm": 7 * layers + 1}


PER_FORWARD = per_forward(SERVE_LAYERS)  # phases 2-3f


def paged_engine(torch, model, params, quant: str, kv: str = "none", **knobs):
    """The paged engine at phase 2's slots and max_len, through the `serve` component's knobs."""
    from modalities_tpu_torch.serving.serve import ServingComponent

    component = ServingComponent(model, _IdTok(), max_batch_slots=SLOTS, cache_capacity=CAPACITY,
                                 max_new_tokens=NEW_TOKENS, kv_cache="paged", paged_block_size=PAGED_BLOCK,
                                 quant={"weights": quant, "kv": kv}, **knobs)
    component.device, component.params = torch.device("cuda"), params
    return component.build_engine()


def paged_run(torch, engine, quant: str, reqs: list[dict], budget: int, late=(), alone: bool = False,
              profile: bool = False) -> dict:
    """Serve `reqs` (then `late`, submitted once the first request decodes) on
    `engine`, with the kernels' launch counters set to 0 just before and read
    just after: each must have launched its per-forward count on every
    forward (prefill, decode and verify alike). Every request must finish
    "budget" or "eod"."""
    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm

    rms_norm.launches = quant_matmul.launches = 0
    t0 = time.perf_counter()
    rids = [engine.submit(r["prompt"], budget, temperature=r["temperature"], seed=r["seed"]) for r in reqs]
    if late:
        tick = engine._now()
        while not any(s is not None and s.phase == "decode" for s in engine._slot_states):
            engine.step(tick)
        rids += [engine.submit(r["prompt"], budget, temperature=r["temperature"], seed=r["seed"]) for r in late]
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = [results[r] for r in rids]
    bad = [(i, r.finish_reason) for i, r in enumerate(res) if r.finish_reason not in ("budget", "eod")]
    if bad:
        raise AssertionError(f"paged serving: requests finished {bad}")
    out = {"tokens": [r.tokens for r in res], "stats": dict(engine.stats()), "wall_s": wall}
    if alone:  # batch invariance: a greedy request alone == its batched tokens
        rid = engine.submit(reqs[0]["prompt"], budget, temperature=0.0, seed=reqs[0]["seed"])
        if engine.run()[rid].tokens != res[0].tokens:
            raise AssertionError("paged batch invariance: request 0 alone differs from its batched tokens")
    if profile:
        out["profile"] = profile_paged_decode(torch, engine, reqs)
    forwards = engine.stats()["forward_calls"]
    out.update(forward_calls=forwards, rms_launches=rms_norm.launches, qmm_launches=quant_matmul.launches)
    want = {"rms": PER_FORWARD["rms"] * forwards, "qmm": PER_FORWARD["qmm"] * forwards if quant != "none" else 0}
    if (out["rms_launches"], out["qmm_launches"]) != (want["rms"], want["qmm"]):
        raise AssertionError(f"paged {quant}: launches rms_norm {out['rms_launches']}, quant_matmul "
                             f"{out['qmm_launches']} over {forwards} forwards; expected {want}")
    return out


def profile_paged_decode(torch, engine, reqs: list[dict], steps: int = 8) -> dict:
    """profile_decode's window on the paged engine: 8 requests (prompts cut to
    64 tokens) are prefilled first, then `steps` decode steps with every slot
    busy run under torch.profiler."""
    for r in reqs[:SLOTS]:
        engine.submit(r["prompt"][:64], steps + 8, temperature=0.0, seed=r["seed"])
    t0 = engine._now()
    while engine._queue or engine._prefilling_slots():
        engine.step(t0)
    rows, device_ms, wall_ms = _profiled(torch, lambda: [engine.step(t0) for _ in range(steps)])
    engine.run()
    rows = [(ms / steps, count / steps, key) for ms, count, key in rows]
    return {"wall_ms": wall_ms / steps, "device_ms": device_ms / steps, "launches": sum(r[1] for r in rows),
            "top": rows[:6]}


def _agreement(base: list, other: list) -> tuple[int, str]:
    """(requests whose tokens are equal, where the first other one diverges)."""
    same = sum(a == b for a, b in zip(base, other))
    for i, (a, b) in enumerate(zip(base, other)):
        if a != b:
            at = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            return same, f"request {i} at token {at}"
    return same, "none"


def _top2_gap(torch, module, prompt: list, tokens: list, at: int) -> float:
    """The plain path's top-2 logit gap where a run diverged: the logits after
    prompt + tokens[:at] from one ring prefill."""
    ids = torch.tensor([prompt + tokens[:at]], device=module.device)
    with torch.inference_mode():
        cache = module.init_slot_cache(1, ids.shape[1])
        top = module.prefill_slot(cache, ids, 0, 0)[0, -1].topk(2).values
    return float(top[0] - top[1])


def make_shared_requests() -> tuple[dict, list[dict]]:
    """(c): a donor with a 256-token prefix and four requests arriving after
    its prefill: the prefix alone (its whole window matches: copy-on-write of
    its last block, one re-forwarded token), the prefix with tails of 40 and
    3 tokens, and half the prefix with a tail of 100."""
    rng = np.random.default_rng(7)
    v = MODEL_2P7B["vocab_size"]
    prefix = rng.integers(0, v, size=SHARED_PREFIX).tolist()
    tail = lambda n: rng.integers(0, v, size=n).tolist()  # noqa: E731
    donor = {"prompt": prefix + tail(32), "temperature": 0.0, "seed": 300}
    late = [prefix, prefix + tail(40), prefix + tail(3), prefix[:128] + tail(100)]
    return donor, [{"prompt": p, "temperature": 0.0, "seed": 301 + i} for i, p in enumerate(late)]


def make_spec_requests() -> list[dict]:
    """(d): 7 greedy requests whose prompts repeat a random pattern of 4-11
    tokens (the drafter has something to propose) and one sampled rider."""
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(SLOTS):
        pattern = rng.integers(0, MODEL_2P7B["vocab_size"], size=int(rng.integers(4, 12))).tolist()
        length = int(rng.integers(64, 257))
        reqs.append({"prompt": (pattern * (length // len(pattern) + 1))[:length],
                     "temperature": 0.8 if i == 5 else 0.0, "seed": 400 + i})
    return reqs


def phase_serve_paged(torch, model, params, reqs: list[dict], ring_tokens: dict, smi: str,
                      replays: dict) -> dict[str, dict]:
    """Phase 3b: the paged engine on the 2.7B weights at phase 2's 8 slots and
    max_len 2048 (blocks of 16, a table of 128). (a) phase 2's requests from
    the default pool of 1024 blocks, bf16 and int8 weights; (b) the same
    through a pool of 128 blocks (preemption), bitwise (a); (c) prefix
    sharing on and off, bitwise; (d) speculative decoding at k = 4 against
    spec off, bf16 and int8 weights; (e) int8 weights and KV, and its
    preemption replay, bitwise. Returns each path's launches: serve_paged,
    serve_paged_int8kv, serve_spec (each run counted from 0). (e)'s tokens go
    into `replays["int8kv"]` (phase 3e is held to them)."""
    counts = {path: {"rms_fwd": 0, "quant_matmul": 0} for path in ("serve_paged", "serve_paged_int8kv", "serve_spec")}

    def count(path, r):
        counts[path]["rms_fwd"] += r["rms_launches"]
        counts[path]["quant_matmul"] += r["qmm_launches"]

    def report(name, r):
        s = r["stats"]
        log(f"[phase 3b] {name}: {s['decode_tokens']} decode tokens in {s['decode_steps']} decode-side forwards "
            f"({s['verify_steps']} verify), {s['prefill_chunk_count']} prefill rows in "
            f"{s['forward_calls'] - s['decode_steps']} packed dispatches, preemptions {s['preemptions']}, prefix hits {s['prefix_hit_requests']} "
            f"({s['prefix_hit_tokens']} tokens), copy-on-write {s['cow_copies']}; launches rms_norm "
            f"{r['rms_launches']}, quant_matmul {r['qmm_launches']} over {r['forward_calls']} forwards; "
            f"run {r['wall_s']:.2f} s ({smi})")

    runs = {}
    # (a) phase 2's requests from the default pool, bf16 and int8 weights
    for quant in ("none", "int8"):
        engine = paged_engine(torch, model, params, quant)
        if engine.num_blocks != SLOTS * CAPACITY // PAGED_BLOCK:
            raise AssertionError(f"default pool {engine.num_blocks} blocks")
        r = runs[quant] = paged_run(torch, engine, quant, reqs, NEW_TOKENS, alone=quant == "none", profile=True)
        count("serve_paged", r)
        name = "bf16" if quant == "none" else quant
        report(f"(a) {name}", r)
        same, where = _agreement(ring_tokens[quant], r["tokens"])
        gap = ""
        if same < len(reqs):  # the ring path's top-2 logit gap where the first request diverges
            i = next(i for i, (a, b) in enumerate(zip(ring_tokens[quant], r["tokens"])) if a != b)
            at = next((j for j, (x, y) in enumerate(zip(ring_tokens[quant][i], r["tokens"][i])) if x != y),
                      min(len(ring_tokens[quant][i]), len(r["tokens"][i])))
            gap = f" (top-2 logit gap there {_top2_gap(torch, engine.module, reqs[i]['prompt'], ring_tokens[quant][i], at):.6g})"
        log(f"[phase 3b] (a) {name}: paged tokens against phase 2's ring tokens: {same} of {len(reqs)} requests "
            f"equal; first divergence: {where}{gap}")
        p, ring_p = r["profile"], ring_tokens[f"{quant}_profile"]
        log(f"[phase 3b] (a) {name}: one paged decode step {p['device_ms']:.3f} ms of kernels in "
            f"{p['launches']:.0f} launches (profiled window {p['wall_ms']:.2f} ms/step); phase 2's ring step "
            f"{ring_p['device_ms']:.3f} ms in {ring_p['launches']:.0f} launches ({smi})")
        for ms, n, key in p["top"]:
            log(f"[phase 3b]   {ms:.4f} ms/step in {n:.0f} x {key[:90]}")
        del engine
        torch.cuda.empty_cache()
    log("[phase 3b] (a) batch invariance: request 0 served alone matches its batched tokens bitwise")
    bf16_data = runs["none"]["stats"]["kv_pool_bytes"]

    # (b) preemption: the smallest pool the engine takes
    engine = paged_engine(torch, model, params, "none", paged_num_blocks=PAGED_TIGHT_BLOCKS)
    r = paged_run(torch, engine, "none", reqs, NEW_TOKENS)
    count("serve_paged", r)
    report(f"(b) bf16, {PAGED_TIGHT_BLOCKS} blocks", r)
    if r["stats"]["preemptions"] == 0:
        raise AssertionError("(b): the tight pool preempted nothing")
    if r["tokens"] != runs["none"]["tokens"]:
        raise AssertionError(f"(b): tokens under preemption differ from (a): {_agreement(runs['none']['tokens'], r['tokens'])}")
    log(f"[phase 3b] (b) {r['stats']['preemptions']} preemptions; every request's tokens bitwise (a)'s")
    del engine
    torch.cuda.empty_cache()

    # (c) prefix sharing on and off
    donor, late = make_shared_requests()
    shared = {}
    for sharing in (True, False):
        engine = paged_engine(torch, model, params, "none", prefix_sharing=sharing)
        r = shared[sharing] = paged_run(torch, engine, "none", [donor], SIDE_NEW_TOKENS, late=late)
        count("serve_paged", r)
        report(f"(c) prefix sharing {'on' if sharing else 'off'}", r)
        del engine
        torch.cuda.empty_cache()
    on = shared[True]["stats"]
    if on["prefix_hit_requests"] == 0 or on["cow_copies"] == 0:
        raise AssertionError(f"(c): prefix hits {on['prefix_hit_requests']}, copy-on-write {on['cow_copies']}")
    if shared[True]["tokens"] != shared[False]["tokens"]:
        raise AssertionError(f"(c): tokens with sharing differ: {_agreement(shared[False]['tokens'], shared[True]['tokens'])}")
    log(f"[phase 3b] (c) {on['prefix_hit_requests']} prefix hits, {on['prefix_hit_blocks']} blocks, "
        f"{on['cow_copies']} copy-on-write; tokens bitwise those with sharing off")

    # (d) speculative decoding against spec off, bf16 and int8 weights
    spec_reqs = make_spec_requests()
    spec = {}
    for quant in ("none", "int8"):
        name = "bf16" if quant == "none" else quant
        plain_engine = paged_engine(torch, model, params, quant)
        plain = paged_run(torch, plain_engine, quant, spec_reqs, SIDE_NEW_TOKENS)
        count("serve_paged", plain)
        engine = paged_engine(torch, model, params, quant, spec_decode={"k": SPEC_K})
        r = spec[quant] = paged_run(torch, engine, quant, spec_reqs, SIDE_NEW_TOKENS)
        count("serve_spec", r)
        report(f"(d) spec k={SPEC_K} {name}", r)
        s = r["stats"]
        if s["spec_proposed"] == 0 or s["decode_executables"] + s["verify_executables"] != 2:
            raise AssertionError(f"(d) {name}: proposed {s['spec_proposed']}, decode-side shapes "
                                 f"{s['decode_executables']} + {s['verify_executables']}")
        greedy = [i for i, q in enumerate(spec_reqs) if q["temperature"] == 0.0]
        diverged = [i for i in greedy if r["tokens"][i] != plain["tokens"][i]]
        r["diverged"], r["gap"] = diverged, None
        if diverged:
            i = diverged[0]
            at = next((j for j, (x, y) in enumerate(zip(plain["tokens"][i], r["tokens"][i])) if x != y),
                      min(len(plain["tokens"][i]), len(r["tokens"][i])))
            r["gap"] = _top2_gap(torch, plain_engine.module, spec_reqs[i]["prompt"], plain["tokens"][i], at)
            r["diverged_at"] = (i, at)
        rider = [i for i, q in enumerate(spec_reqs) if q["temperature"] > 0.0]
        log(f"[phase 3b] (d) {name}: greedy requests diverging from spec off: {len(diverged)} of {len(greedy)}"
            + (f" (first: request {r['diverged_at'][0]} at token {r['diverged_at'][1]}, the plain path's top-2 "
               f"logit gap there {r['gap']:.6g})" if diverged else "")
            + f"; the sampled rider equal: {all(r['tokens'][i] == plain['tokens'][i] for i in rider)}; accepted "
            f"{s['spec_accepted']} of {s['spec_proposed']} proposed ({s['spec_accepted'] / s['spec_proposed']:.3f}); "
            f"{s['decode_tokens'] / s['decode_steps']:.3f} tokens per decode-side forward ({s['decode_steps']} "
            f"forwards) against {plain['stats']['decode_tokens'] / plain['stats']['decode_steps']:.3f} with spec "
            f"off ({plain['stats']['decode_steps']} forwards)")
        if diverged:  # bitwise on the H100, bf16 and int8 weights (PERF.md, section 6): held as a gate
            raise AssertionError(f"(d) {name}: greedy spec tokens differ from spec off in requests {diverged}")
        del engine, plain_engine
        torch.cuda.empty_cache()

    # (e) int8 weights and int8 KV, then its preemption replay
    engine = paged_engine(torch, model, params, "int8", kv="int8")
    r = paged_run(torch, engine, "int8", reqs, NEW_TOKENS)
    count("serve_paged_int8kv", r)
    report("(e) int8 weights, int8 KV", r)
    replays["int8kv"] = r["tokens"]
    s = r["stats"]
    data = s["kv_pool_bytes"] - s["kv_scale_bytes"]
    if data * 2 != bf16_data:
        raise AssertionError(f"(e): int8 pool data {data} B is not half of bf16's {bf16_data} B")
    same, where = _agreement(runs["int8"]["tokens"], r["tokens"])
    log(f"[phase 3b] (e) pool {s['kv_pool_bytes'] / 1e9:.4f} GB: data {data / 1e9:.4f} GB = "
        f"{data / bf16_data:.2f} of bf16's {bf16_data / 1e9:.4f} GB, scales {s['kv_scale_bytes'] / 1e9:.4f} GB apart; "
        f"tokens against bf16 KV (int8 weights, (a)): {same} of {len(reqs)} requests equal, first divergence: {where}")
    del engine
    torch.cuda.empty_cache()
    engine = paged_engine(torch, model, params, "int8", kv="int8", paged_num_blocks=PAGED_TIGHT_BLOCKS)
    tight = paged_run(torch, engine, "int8", reqs, NEW_TOKENS)
    count("serve_paged_int8kv", tight)
    report(f"(e) int8 KV, {PAGED_TIGHT_BLOCKS} blocks", tight)
    if tight["stats"]["preemptions"] == 0 or tight["tokens"] != r["tokens"]:
        raise AssertionError(f"(e): preemptions {tight['stats']['preemptions']}, replay "
                             f"{_agreement(r['tokens'], tight['tokens'])}")
    log(f"[phase 3b] (e) {tight['stats']['preemptions']} preemptions on the int8 pool; tokens bitwise (e)'s")
    del engine
    torch.cuda.empty_cache()
    log(f"[phase 3b] launches by path: {counts}")
    if any(v == 0 for c in counts.values() for v in c.values()):
        raise AssertionError(f"a kernel of a paged serving path was never launched: {counts}")
    return counts


# ---------------------------------------------------------------- phase 3c
HTTP_TENANTS = {"interactive": {"class": "interactive", "weight": 3, "max_slots": 6},
                "bulk": {"class": "bulk", "weight": 1, "rate": 16.0, "burst": 64.0}}
ORDER_REQUESTS = 24  # (b): the saturated queue, both tenants
HTTP_DEADLINE_MS = 300.0  # (c): far shorter than a 1000-token decode at tens of ms a step


class _IntTok:
    """Space-separated token ids: the HTTP prompts' text."""

    def tokenize(self, text):
        return [int(t) for t in text.split()]

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    def get_token_id(self, token):
        return -1  # eod off: every request runs its budget


def _http(port: int, method: str, path: str, body=None, headers=None):
    """(status, the SSE events or the JSON body or the text, the headers)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        raw, got = resp.read(), dict(resp.getheaders())
        ctype = got.get("Content-Type", "")
        if ctype.startswith("text/event-stream"):
            return resp.status, [json.loads(c[6:]) for c in raw.split(b"\n\n") if c.startswith(b"data: ")], got
        return resp.status, json.loads(raw) if ctype.startswith("application/json") else raw.decode(), got
    finally:
        conn.close()


def _post_all(port: int, bodies: list, headers=None) -> list:
    """POST every body at once from threads; the outcomes in body order."""
    import threading

    out = [None] * len(bodies)

    def post(i):
        out[i] = _http(port, "POST", "/generate", bodies[i], headers)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    return threads, out


def _wait(predicate, what: str, seconds: float = 300.0, phase: str = "3c") -> None:
    end = time.monotonic() + seconds
    while not predicate():
        if time.monotonic() > end:
            raise AssertionError(f"phase {phase}: timed out waiting for {what}")
        time.sleep(0.005)


def _done(outcome, what: str, phase: str = "3c") -> dict:
    status, events, _ = outcome
    if status != 200 or not isinstance(events, list) or not events or not events[-1].get("done"):
        last = events[-1] if isinstance(events, list) and events else events
        raise AssertionError(f"phase {phase} {what}: HTTP {status}, last event {last}")
    done = events[-1]
    if [e["token_id"] for e in events if "token_id" in e] != done["token_ids"]:
        raise AssertionError(f"phase {phase} {what}: the streamed token events differ from the done event's "
                             "token_ids")
    return done


def order_requests() -> list[dict]:
    """(b): 24 short requests alternating interactive and bulk, ids < 256."""
    rng = np.random.default_rng(33)
    return [{"prompt": rng.integers(0, 256, size=int(rng.integers(4, 21))).tolist(),
             "budget": int(rng.integers(2, 9)), "tenant": "interactive" if i % 2 == 0 else "bulk"}
            for i in range(ORDER_REQUESTS)]


def tenant_order(engine, reqs: list[dict]) -> list[int]:
    """Queue `reqs` at once on `engine` (its clock a counter stepping 10 ms a
    read), run it, and return the request indices in the order they got
    their first token."""
    clock = {"t": 0.0}

    def tick():
        clock["t"] += 0.01
        return clock["t"]

    firsts, prior_now, prior_token = [], engine._now, engine._on_token
    engine._now = tick
    engine._on_token = lambda rid, tok: firsts.append(rid) if rid not in firsts else None
    rids = [engine.submit(r["prompt"], r["budget"], temperature=0.0, seed=i, tenant=r["tenant"])
            for i, r in enumerate(reqs)]
    results = engine.run()
    engine._now, engine._on_token = prior_now, prior_token
    if any(results[r].finish_reason != "budget" for r in rids):
        raise AssertionError("phase 3c (b): a queued tenant request did not finish its budget")
    index = {rid: i for i, rid in enumerate(rids)}
    return [index[r] for r in firsts]


@contextlib.contextmanager
def own_registry():
    """Engines built inside write their metrics into a registry of their own
    (a disabled Telemetry's), as the engine of each `serve` run does; without
    it they share the process's default registry with every earlier phase's."""
    from modalities_tpu_torch.telemetry import Telemetry, set_active_telemetry

    prior = set_active_telemetry(Telemetry(enabled=False))
    try:
        yield
    finally:
        set_active_telemetry(prior)


def http_component(torch, model, params, device: str):
    from modalities_tpu_torch.serving.serve import ServingComponent

    component = ServingComponent(model, _IntTok(), max_batch_slots=SLOTS, cache_capacity=CAPACITY,
                                 max_new_tokens=NEW_TOKENS, kv_cache="paged", paged_block_size=PAGED_BLOCK,
                                 quant={"weights": "int8"}, tenants=HTTP_TENANTS)
    component.device, component.params = torch.device(device), params
    return component


def phase_serve_http(torch, model, params, reqs: list[dict], smi: str) -> tuple[dict[str, dict[str, int]], list]:
    """Phase 3c (see the module docstring): the HTTP front end over one
    int8 paged engine with tenants. Returns the path's launches, counted
    from 0 just before its first forward and read after its last, and the
    JSONL replay's tokens (what phases 3d and 3e are held to)."""
    import threading

    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm
    from modalities_tpu_torch.quant.weights import quantize_params
    from modalities_tpu_torch.serving.resilience import BrownoutController
    from modalities_tpu_torch.serving.server import ServingHTTPServer
    from modalities_tpu_torch.telemetry.metrics import parse_prometheus_text

    tok = _IntTok()
    rows = [{"prompt": tok.decode(r["prompt"]), "max_new_tokens": NEW_TOKENS, "temperature": r["temperature"],
             "seed": r["seed"]} for r in reqs]
    t_phase = time.perf_counter()
    rms_norm.launches = quant_matmul.launches = 0
    component = http_component(torch, model, params, "cuda")
    with own_registry():  # (a) and (d) hold /metrics to this engine's stats()
        engine = component.build_engine()
    # (b) the tenants' admission order on a stepped clock, against the port's scheduler on the CPU; first, while
    # the engine's DRR rotation is as fresh as the CPU engine's
    order_reqs = order_requests()
    card_order = tenant_order(engine, order_reqs)
    cpu_model = build_model({"n_layer": 2, "n_head_q": 4, "n_head_kv": 2, "n_embd": 128, "ffn_hidden": 128,
                             "vocab_size": 256})
    cpu_component = http_component(torch, cpu_model, cpu_model.init_params(torch.Generator().manual_seed(0)), "cpu")
    with own_registry():
        cpu_order = tenant_order(cpu_component.build_engine(), order_reqs)
    tenant_of = [r["tenant"] for r in order_reqs]
    if card_order != cpu_order:
        raise AssertionError(f"phase 3c (b): admission order {card_order} != the CPU scheduler's {cpu_order}")
    first8 = [tenant_of[i] for i in card_order[:8]]
    log(f"[phase 3c] (b) {ORDER_REQUESTS} queued requests: first-token order equal to the port's scheduler on the "
        f"CPU; tenants of the first 8: {first8.count('interactive')} interactive, {first8.count('bulk')} bulk")

    # (a) the JSONL replay on this engine: the tokens every SSE stream is held to
    t0 = time.perf_counter()
    replay = [row["tokens"] for row in component.run_requests(rows)]
    log(f"[phase 3c] (a) JSONL replay of phase 2's 9 requests: {time.perf_counter() - t0:.2f} s ({smi})")

    # every remaining check goes through HTTP; the shut gate holds the engine between steps (a known queue)
    gate = threading.Event()
    gate.set()
    step = engine.step
    engine.step = lambda t: step(t) if gate.is_set() else False
    server = ServingHTTPServer(engine, encode=component._encode, decode=tok.decode, port=0,
                               default_max_new_tokens=NEW_TOKENS)
    server.start()
    stats0 = engine.stats()
    executables = (stats0["decode_executables"], stats0["prefill_executables"])

    # (a) phase 2's requests at once over SSE
    t0 = time.perf_counter()
    threads, outs = _post_all(server.port, rows)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    dones = [_done(o, f"(a) request {i}") for i, o in enumerate(outs)]
    same, where = _agreement(replay, [d["token_ids"] for d in dones])
    if same != len(reqs):
        raise AssertionError(f"phase 3c (a): SSE tokens against the JSONL replay: {same} of {len(reqs)}, {where}")
    ttft = np.asarray([d["ttft_s"] for d in dones]) * 1e3
    status, health, _ = _http(server.port, "GET", "/healthz")
    status_s, stats, _ = _http(server.port, "GET", "/stats")
    status_m, text, _ = _http(server.port, "GET", "/metrics")
    if (status, health["status"], status_s, status_m) != (200, "ok", 200, 200):
        raise AssertionError(f"phase 3c (a): /healthz {status} {health}, /stats {status_s}, /metrics {status_m}")
    parsed = parse_prometheus_text(text)
    pairs = {"serve_decode_steps_total": stats["decode_steps"],
             "serve_prefill_chunks_total": stats["prefill_chunk_count"],
             "serve_preemptions_total": stats["preemptions"]}
    bad = {k: (parsed[k][()], v) for k, v in pairs.items() if parsed[k][()] != v}
    finished = sum(parsed["serve_requests_finished_total"].values())
    if bad or finished != len(rows) * 2 + ORDER_REQUESTS:
        raise AssertionError(f"phase 3c (a): /metrics against stats(): {bad}, finished {finished}")
    log(f"[phase 3c] (a) 9 SSE streams bitwise the replay's tokens in {wall:.2f} s; TTFT ms p50 "
        f"{np.percentile(ttft, 50):.1f} max {ttft.max():.1f} (9 at once into 8 slots); host "
        f"{1e3 * stats['decode_seconds'] / stats['decode_steps']:.2f} ms a decode step over the phase so far; "
        f"/metrics counters equal stats() ({smi})")

    # (b) the bulk tenant's token bucket over HTTP, the engine's clock held so nothing refills
    held = time.monotonic()
    engine._now = lambda: held
    bulk = {"prompt": rows[0]["prompt"], "max_new_tokens": 64}
    first = _http(server.port, "POST", "/generate", bulk, {"X-Tenant-Id": "bulk"})
    status, err, headers = _http(server.port, "POST", "/generate", bulk, {"X-Tenant-Id": "bulk"})
    want = max(1, math.ceil(engine._tenants._buckets["bulk"].retry_after_s(64.0, held)))
    inter = _http(server.port, "POST", "/generate", dict(bulk, max_new_tokens=4), {"X-Tenant-Id": "interactive"})
    engine._now = time.monotonic
    _done(first, "(b) bulk within its burst")
    _done(inter, "(b) interactive beside the limited bulk tenant")
    if (status, err.get("reason"), headers.get("Retry-After")) != (429, "rate_limited", str(want)) or want != 4:
        raise AssertionError(f"phase 3c (b): bulk over its rate: HTTP {status} {err}, Retry-After "
                             f"{headers.get('Retry-After')} (its bucket's refill: {want} s)")
    log(f"[phase 3c] (b) bulk over its 16 tokens/s: 429 rate_limited, Retry-After {headers['Retry-After']} s = the "
        f"bucket's refill time for 64 tokens")

    # (c) a deadline shorter than its decode
    done = _done(_http(server.port, "POST", "/generate", {"prompt": rows[1]["prompt"], "max_new_tokens": 1000},
                       {"X-Deadline-Ms": str(HTTP_DEADLINE_MS)}), "(c)")
    _wait(lambda: engine._active_count() == 0, "the engine to go idle")
    s = engine.stats()
    engine._table_state.check()  # free + the blocks the tables own == num_blocks
    if done["finish_reason"] != "deadline" or len(done["token_ids"]) >= 1000 or s["free_blocks"] != s["num_blocks"]:
        raise AssertionError(f"phase 3c (c): finish {done['finish_reason']}, {len(done['token_ids'])} tokens, "
                             f"free blocks {s['free_blocks']} of {s['num_blocks']}")
    log(f"[phase 3c] (c) a {HTTP_DEADLINE_MS:.0f} ms deadline on a 1000-token request: finish \"deadline\" after "
        f"{len(done['token_ids'])} tokens; free {s['free_blocks']} of {s['num_blocks']} blocks, the audit exact")

    # (d) overload: a full queue, then a brownout
    shed0 = engine.stats()["shed_requests"]
    long_body = lambda i: {"prompt": rows[i]["prompt"], "max_new_tokens": 8, "priority": i % 2}  # noqa: E731
    gate.clear()
    engine.max_queue_depth = 2
    queued = []
    for i in range(2):
        depth = len(engine._queue)
        queued.append(_post_all(server.port, [long_body(i)]))
        _wait(lambda: len(engine._queue) == depth + 1, "a request to queue")
    status_q, err_q, headers_q = _http(server.port, "POST", "/generate", long_body(2))
    engine.max_queue_depth = None
    engine.brownout = BrownoutController(queue_high=3)
    queued.append(_post_all(server.port, [long_body(3)]))
    _wait(lambda: len(engine._queue) == 3, "a third request to queue")
    engine.brownout.update(len(engine._queue))  # the queue sweep the shut gate holds back
    status_b, err_b, headers_b = _http(server.port, "POST", "/generate", long_body(4))
    gate.set()
    finishes = []
    for threads, out in queued:
        threads[0].join()
        finishes.append(_done(out[0], "(d) queued")["finish_reason"])
    _wait(lambda: engine._active_count() == 0, "the engine to go idle")
    engine.brownout = None
    shed = engine.stats()["shed_requests"] - shed0
    metrics = parse_prometheus_text(engine.metrics.render())["serve_shed_total"]
    checks = [(status_q, err_q.get("reason")) == (429, "queue_full"), int(headers_q.get("Retry-After", 0)) >= 1,
              (status_b, err_b.get("reason")) == (429, "brownout_reject"), int(headers_b.get("Retry-After", 0)) >= 1,
              finishes.count("shed") == 2, shed == 4, metrics.get((("reason", "brownout"),)) == 2.0]
    if not all(checks):
        raise AssertionError(f"phase 3c (d): checks {checks}: queue_full {status_q} {err_q} {headers_q}, brownout "
                             f"{status_b} {err_b} {headers_b}, queued finishes {finishes}, shed {shed}, {metrics}")
    log(f"[phase 3c] (d) max_queue_depth 2: 429 queue_full, Retry-After {headers_q['Retry-After']} s; brownout "
        f"(high 3, low 1): 429 brownout_reject, Retry-After {headers_b['Retry-After']} s; the queued finished "
        f"{finishes}; shed counter +{shed} (2 shed, 2 refused)")

    # (e) hot swap: the same weights mid-flight, then a NaN generation, then the donor back
    donor = quantize_params(params, "int8")
    steps0 = engine.stats()["decode_steps"]
    threads, outs = _post_all(server.port, rows)
    _wait(lambda: engine.stats()["decode_steps"] > steps0 + 20, "20 decode steps of the swap's requests")
    swap_event = engine.request_swap(donor)
    for t in threads:
        t.join()
    if not swap_event.is_set() or engine.swap_history[-1]["in_flight"] == 0:
        raise AssertionError(f"phase 3c (e): the swap was not installed mid-flight: {engine.swap_history}")
    in_flight, latency = engine.swap_history[-1]["in_flight"], engine.swap_history[-1]["latency_s"]
    swapped = [_done(o, f"(e) request {i}") for i, o in enumerate(outs)]
    same, where = _agreement(replay, [d["token_ids"] for d in swapped])
    if same != len(reqs) or any(d["finish_reason"] != "budget" for d in swapped):
        raise AssertionError(f"phase 3c (e): tokens across the swap: {same} of {len(reqs)}, {where}")
    engine.request_swap({k: torch.full_like(v, float("nan")) if v.is_floating_point() else v
                         for k, v in donor.items()}).wait()
    poisoned = _done(_http(server.port, "POST", "/generate", rows[0]), "(e) NaN generation")
    engine.request_swap(donor, generation=1).wait()
    restored = _done(_http(server.port, "POST", "/generate", rows[0]), "(e) donor back")
    s = engine.stats()
    if (poisoned["finish_reason"], poisoned["token_ids"], restored["token_ids"], restored["weights_generation"],
            (s["decode_executables"], s["prefill_executables"])) != ("error", [], replay[0], 1, executables):
        raise AssertionError(f"phase 3c (e): NaN generation {poisoned['finish_reason']}, restored tokens equal "
                             f"{restored['token_ids'] == replay[0]}, shapes {s['decode_executables']}, "
                             f"{s['prefill_executables']} against {executables}")
    del donor
    log(f"[phase 3c] (e) the same weights swapped in with {in_flight} requests "
        f"in flight ({latency * 1e3:.1f} ms to copy 2.7B int8 weights in): 9 of 9 streams bitwise, none dropped; "
        f"a NaN generation finished \"error\"; the donor back (generation 1) serves request 0 bitwise; "
        f"{s['decode_executables']} decode shape ({smi})")

    # (f) drain
    threads, outs = _post_all(server.port, rows[:2])
    _wait(lambda: engine._active_count() == 2, "two requests in flight")
    server.stop()
    status_d, err_d, headers_d = _http(server.port, "POST", "/generate", rows[2])
    for t in threads:
        t.join()
    drained = [_done(o, "(f)")["finish_reason"] for o in outs]
    final = server.serve_forever()
    if (status_d, headers_d.get("Retry-After"), drained) != (503, "1", ["budget", "budget"]) \
            or final["free_blocks"] != final["num_blocks"]:
        raise AssertionError(f"phase 3c (f): drain: new POST {status_d} {err_d}, in flight {drained}, "
                             f"free {final['free_blocks']} of {final['num_blocks']}")
    forwards = final["forward_calls"]
    counts = {"rms_fwd": rms_norm.launches, "quant_matmul": quant_matmul.launches}
    want = {"rms_fwd": PER_FORWARD["rms"] * forwards, "quant_matmul": PER_FORWARD["qmm"] * forwards}
    if counts != want:
        raise AssertionError(f"phase 3c: launches {counts} over {forwards} forwards; expected {want}")
    log(f"[phase 3c] (f) stop(): the 2 in-flight requests finished {drained}, a new POST got 503; final "
        f"{final['decode_steps']} decode steps, {final['decode_tokens']} decode tokens, host "
        f"{1e3 * final['decode_seconds'] / final['decode_steps']:.2f} ms a decode step")
    log(f"[phase 3c] launches: rms_norm {counts['rms_fwd']} = {PER_FORWARD['rms']} x {forwards} forwards, quant_matmul "
        f"{counts['quant_matmul']} = {PER_FORWARD['qmm']} x {forwards}; phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    del engine, component, server
    torch.cuda.empty_cache()
    return {"serve_http": counts}, replay


# ---------------------------------------------------------------- phase 3d
FLEET_WORKERS = 2
FLEET_PROBATION_S = 2.0  # (c): the canary's probation window
SERVE_DEVICE = "cuda"  # phases 3d and 3e (a CPU rehearsal of their logic sets "cpu")
FAILOVER_AFTER = 16  # (b): tokens the doomed stream has emitted when its worker's server closes


def _launches_held(torch, engines: list, phase: str, forwards: int = 0) -> dict[str, int]:
    """The kernels' launches since their reset, held to PER_FORWARD a forward
    over every forward of `engines` (each idle first) and `forwards` more
    (those of the phase's engines already gone)."""
    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm

    for e in engines:
        _wait(lambda e=e: e.stats()["active_slots"] == 0 and e.stats()["queue_depth"] == 0, "the engines to go idle",
              phase=phase)
    torch.cuda.synchronize()
    forwards += sum(e.stats()["forward_calls"] for e in engines)
    counts = {"rms_fwd": rms_norm.launches, "quant_matmul": quant_matmul.launches}
    want = {"rms_fwd": PER_FORWARD["rms"] * forwards, "quant_matmul": PER_FORWARD["qmm"] * forwards}
    if counts != want:
        raise AssertionError(f"phase {phase}: launches {counts} over {forwards} forwards; expected {want}")
    log(f"[phase {phase}] launches: rms_norm {counts['rms_fwd']} = {PER_FORWARD['rms']} x {forwards} forwards, quant_matmul "
        f"{counts['quant_matmul']} = {PER_FORWARD['qmm']} x {forwards}")
    return counts


def _start_fleet(torch, component, params, phase: str):
    """run_fleet() of `component` on a thread; returns (stop event, thread, result list) once its router is up."""
    import threading

    component.device, component.params = torch.device(SERVE_DEVICE), params
    stop = threading.Event()
    component.stop_fn = stop.is_set
    out = []
    thread = threading.Thread(target=lambda: out.append(component.run_fleet()), name="fleet", daemon=True)
    thread.start()
    _wait(lambda: getattr(component, "router", None) is not None or not thread.is_alive(), "the router",
          phase=phase)
    if not thread.is_alive():
        raise AssertionError(f"phase {phase}: run_fleet ended before its router came up")
    return stop, thread, out


def phase_serve_fleet(torch, model, params, reqs: list[dict], replay: list, smi: str) -> dict[str, dict[str, int]]:
    """Phase 3d (see the module docstring): two workers behind the router.
    Returns the path's launches, counted from 0 just before the workers
    boot and read once every worker is idle."""
    import threading

    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm
    from modalities_tpu_torch.quant.weights import quantize_params
    from modalities_tpu_torch.serving.fleet.component import FleetServingComponent
    from modalities_tpu_torch.telemetry.metrics import parse_prometheus_text

    tok = _IntTok()
    rows = [{"prompt": tok.decode(r["prompt"]), "max_new_tokens": NEW_TOKENS, "temperature": r["temperature"],
             "seed": r["seed"]} for r in reqs]
    t_phase = time.perf_counter()
    rms_norm.launches = quant_matmul.launches = 0
    component = FleetServingComponent(model, tok, num_workers=FLEET_WORKERS, max_batch_slots=SLOTS,
                                      cache_capacity=CAPACITY, max_new_tokens=NEW_TOKENS, kv_cache="paged",
                                      paged_block_size=PAGED_BLOCK, quant={"weights": "int8"},
                                      probation_s=FLEET_PROBATION_S, probation_tick_s=0.05, health_interval_s=0.2)
    stop, thread, out = _start_fleet(torch, component, params, "3d")
    router, controller, workers = component.router, component.controller, component.workers
    engines = [w.engine for w in workers]
    log(f"[phase 3d] {FLEET_WORKERS} workers (int8 weights, paged, {SLOTS} slots each) behind the router on port "
        f"{router.port}, booted in {time.perf_counter() - t_phase:.1f} s")

    def through_router(what: str) -> list:
        threads, outs = _post_all(router.port, rows)
        for t in threads:
            t.join()
        dones = [_done(o, f"{what} request {i}", "3d") for i, o in enumerate(outs)]
        same, where = _agreement(replay, [d["token_ids"] for d in dones])
        if same != len(rows):
            raise AssertionError(f"phase 3d {what}: tokens against 3c's replay: {same} of {len(rows)}, {where}")
        return dones

    # (a) phase 2's requests through the router, both workers picked
    t0 = time.perf_counter()
    through_router("(a)")
    picks = {w.name: w.picks for w in router.workers}
    if min(picks.values()) == 0:
        raise AssertionError(f"phase 3d (a): the router picked one worker only: {picks}")
    log(f"[phase 3d] (a) 9 requests through the router bitwise 3c's replay in {time.perf_counter() - t0:.2f} s; "
        f"picks {picks} ({smi})")

    # (d) /fleet and the router's /metrics against the workers' stats()
    router.health_round()
    _, table, _ = _http(router.port, "GET", "/fleet")
    _, text, _ = _http(router.port, "GET", "/metrics")
    parsed = parse_prometheus_text(text)
    rows_by = {w["name"]: w for w in table["workers"]}
    bad = []
    for w in workers:
        s = w.engine.stats()
        row = rows_by[w.name]
        if (row["healthy"], row["weights_generation"], row["load"]) != (True, s["weights_generation"],
                                                                      s["active_slots"] + s["queue_depth"]):
            bad.append((w.name, row, s["weights_generation"]))
        _, wtext, _ = _http(w.server.port, "GET", "/metrics")
        wp = parse_prometheus_text(wtext)
        if (wp["serve_decode_steps_total"][()], wp["serve_prefill_chunks_total"][()]) != (
                s["decode_steps"], s["prefill_chunk_count"]):
            bad.append((w.name, "metrics", wp["serve_decode_steps_total"][()], s["decode_steps"]))
    if bad or parsed["fleet_workers_healthy"][()] != FLEET_WORKERS or parsed["fleet_failovers_total"][()] != 0:
        raise AssertionError(f"phase 3d (d): /fleet or /metrics against stats(): {bad}, {parsed['fleet_workers_healthy']}")
    log(f"[phase 3d] (d) /fleet (health, generation, load) and every worker's /metrics equal its stats(); the "
        f"router's fleet_workers_healthy {parsed['fleet_workers_healthy'][()]:.0f}")

    # (c) a rollout of the donor weights as generation 1, requests in flight, then a NaN generation
    donor = quantize_params(params, "int8")
    steps0 = sum(e.stats()["decode_steps"] for e in engines)
    threads, outs = _post_all(router.port, rows)
    _wait(lambda: sum(e.stats()["decode_steps"] for e in engines) > steps0 + 10, "decode steps before the deploy",
          phase="3d")
    verdict = []
    t0 = time.perf_counter()
    deploy = threading.Thread(target=lambda: verdict.append(controller.deploy(donor, step=1)))
    deploy.start()
    for t in threads:
        t.join()
    deploy.join()
    dones = [_done(o, f"(c) request {i}", "3d") for i, o in enumerate(outs)]
    same, where = _agreement(replay, [d["token_ids"] for d in dones])
    gens = [e.weights_generation for e in engines]
    swaps = [e.swap_history[-1] for e in engines]
    if verdict != [True] or gens != [1] * FLEET_WORKERS or same != len(rows):
        raise AssertionError(f"phase 3d (c): deploy {verdict}, generations {gens}, tokens across it {same} of "
                             f"{len(rows)} {where}")
    through_router("(c) generation 1")
    swapped = ", ".join("%.1f ms with %d in flight" % (r["latency_s"] * 1e3, r["in_flight"]) for r in swaps)
    log(f"[phase 3d] (c) generation 1 promoted to both workers in {time.perf_counter() - t0:.2f} s (probation "
        f"{FLEET_PROBATION_S} s): swaps {swapped}; the 9 in-flight streams and 9 more bitwise the replay ({smi})")
    nan = {k: torch.full_like(v, float("nan")) if v.is_floating_point() else v for k, v in donor.items()}
    verdict = []
    deploy = threading.Thread(target=lambda: verdict.append(controller.deploy(nan, step=2)))
    deploy.start()
    _wait(lambda: any(e.weights_generation == 2 for e in engines) or not deploy.is_alive(), "the NaN canary",
          phase="3d")
    canary = next((w for w in workers if w.engine.weights_generation == 2), None)
    poisoned = _done(_http(canary.server.port, "POST", "/generate", rows[0]), "(c) NaN canary", "3d") \
        if canary is not None else None
    deploy.join()
    restored = _done(_http(canary.server.port, "POST", "/generate", rows[0]), "(c) donor back", "3d") \
        if canary is not None else None
    if (canary is None or verdict != [False] or poisoned["finish_reason"] != "error"
            or restored["token_ids"] != replay[0] or restored["weights_generation"] != 1
            or controller.generation != 1):
        raise AssertionError(f"phase 3d (c): NaN generation: canary {canary and canary.name}, deploy {verdict}, "
                             f"finish {poisoned and poisoned['finish_reason']}, restored "
                             f"{restored and restored['token_ids'] == replay[0]}")
    _, text, _ = _http(router.port, "GET", "/metrics")
    parsed = parse_prometheus_text(text)
    if (parsed["fleet_rollouts_total"][()], parsed["fleet_rollbacks_total"][()]) != (1.0, 1.0):
        raise AssertionError(f"phase 3d (c): rollouts/rollbacks {parsed['fleet_rollouts_total']} "
                             f"{parsed['fleet_rollbacks_total']}")
    log(f"[phase 3d] (c) NaN generation 2 on canary {canary.name}: its request finished \"error\", rolled back "
        f"({canary.engine.swap_history[-1]['latency_s'] * 1e3:.1f} ms swap back); the donor serves request 0 "
        f"bitwise; fleet_rollouts_total 1, fleet_rollbacks_total 1")
    del donor, nan

    # (b) last: a worker's server closed mid-stream, the answer spliced from a peer
    tokens0 = [e.stats()["decode_tokens"] for e in engines]
    threads, outs = _post_all(router.port, rows[:1])
    _wait(lambda: any(e.stats()["decode_tokens"] - t0_ >= FAILOVER_AFTER for e, t0_ in zip(engines, tokens0)),
          "tokens of the doomed stream", phase="3d")
    victim = next(w for w, e, t0_ in zip(workers, engines, tokens0)
                  if e.stats()["decode_tokens"] - t0_ >= FAILOVER_AFTER)
    victim.server.close()
    threads[0].join()
    done = _done(outs[0], "(b) across the failover", "3d")
    _, text, _ = _http(router.port, "GET", "/metrics")
    failovers = parse_prometheus_text(text)["fleet_failovers_total"][()]
    if done["token_ids"] != replay[0] or router.failovers != 1 or failovers != 1.0:
        raise AssertionError(f"phase 3d (b): tokens {done['token_ids'] == replay[0]}, failovers {router.failovers} "
                             f"(metric {failovers})")
    log(f"[phase 3d] (b) {victim.name}'s server closed after >= {FAILOVER_AFTER} decoded tokens: one answer bitwise the replay, "
        f"spliced on the peer; fleet_failovers_total {failovers:.0f}")
    counts = _launches_held(torch, engines, "3d")
    stop.set()
    thread.join(120)
    if thread.is_alive() or not out:
        raise AssertionError("phase 3d: run_fleet did not drain")
    log(f"[phase 3d] phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    del component, router, controller, workers, engines
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve_fleet": counts}


# ---------------------------------------------------------------- phase 3e
HEAD_DIM, KV_HEADS, N_LAYERS = 80, 8, SERVE_LAYERS  # the served model's K/V rows
BODY_LIMIT = 16 << 20  # serving/server.py _MAX_BODY_BYTES
WIRE_MARGIN = 64 << 10  # (c): an import body's bytes besides its payload's base64 (the window, the key), at most


def _block_bytes(kv: str) -> int:
    """One KV block's payload bytes: K and V, SERVE_LAYERS layers x 16 positions x 8 heads."""
    row = HEAD_DIM * 2 if kv == "none" else HEAD_DIM + 4  # bf16, or int8 + the row's float32 scale
    return N_LAYERS * PAGED_BLOCK * KV_HEADS * row * 2


def _disagg_engine(torch, model, params, role: str, kv: str):
    from modalities_tpu_torch.serving.engine import ServingEngine

    return ServingEngine(model, params, device=SERVE_DEVICE, max_batch_slots=SLOTS, cache_capacity=CAPACITY, eod_token_id=-1,
                         kv_cache="paged", paged_block_size=PAGED_BLOCK, quant_weights="int8", quant_kv=kv,
                         role=role, spec_decode={"k": 0})


def phase_serve_disagg(torch, model, params, reqs: list[dict], replays: dict, smi: str) -> dict[str, dict[str, int]]:
    """Phase 3e (see the module docstring): the tiers in process, then behind
    the DisaggRouter. Returns the path's launches (every engine of the phase,
    counted from 0 just before the first and read once all are idle)."""
    import base64

    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm
    from modalities_tpu_torch.serving.disagg.component import DisaggServingComponent
    from modalities_tpu_torch.serving.disagg.handoff import HandoffRecord
    from modalities_tpu_torch.serving.disagg.pair import DisaggPair
    from modalities_tpu_torch.telemetry.metrics import parse_prometheus_text

    t_phase = time.perf_counter()
    rms_norm.launches = quant_matmul.launches = 0
    forwards, records = 0, {}
    timings = {"export": [], "wire": [], "import": []}
    for kv, want in (("none", replays["int8"]), ("int8", replays["int8kv"])):
        name = "bf16" if kv == "none" else "int8"
        prefill, decode = _disagg_engine(torch, model, params, "prefill", kv), _disagg_engine(torch, model, params,
                                                                                             "decode", kv)
        pair = DisaggPair(prefill, decode)
        rids = [pair.submit(r["prompt"], NEW_TOKENS, temperature=r["temperature"], seed=r["seed"]) for r in reqs]
        t0 = time.perf_counter()
        with _timed(prefill, "_export_handoff", timings["export"]), _timed(decode, "_scatter_import",
                                                                               timings["import"]):
            results = pair.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = [results[r] for r in rids]
        same, where = _agreement(want, [r.tokens for r in got])
        ps, ds = prefill.stats(), decode.stats()
        shapes = (ps["decode_executables"], ds["prefill_executables"])
        if same != len(reqs) or pair.handoff_failures or (ps["handoffs_exported"], ds["handoffs_imported"]) != (9, 9) \
                or shapes != (0, 0):
            raise AssertionError(f"phase 3e (a) {name} KV: tokens {same} of {len(reqs)} {where}, failures "
                                 f"{pair.handoff_failures}, exported {ps['handoffs_exported']} imported "
                                 f"{ds['handoffs_imported']}, shapes {shapes}")
        # (b) the payload bytes, block for block
        recs = records[kv] = [r.prefill.handoff for r in got]
        wrong = [(i, rec.kv_bytes, rec.num_blocks) for i, rec in enumerate(recs)
                 if rec.kv_bytes != rec.num_blocks * _block_bytes(kv)]
        if wrong or sum(rec.kv_bytes for rec in recs) != ps["handoff_bytes_shipped"]:
            raise AssertionError(f"phase 3e (b) {name} KV: payload bytes {wrong}")
        forwards += ps["forward_calls"] + ds["forward_calls"]
        log(f"[phase 3e] (a) {name} KV: DisaggPair on 9 requests in {wall:.2f} s, tokens bitwise the combined "
            f"engine's; 9 handoffs exported and imported; decode shapes on the prefill tier {shapes[0]}, prefill "
            f"shapes on the decode tier {shapes[1]}; host ms a forward: prefill tier "
            f"{1e3 * ps['prefill_seconds'] / max(ps['forward_calls'], 1):.2f} ({ps['forward_calls']} packed "
            f"prefills), decode tier {1e3 * ds['decode_seconds'] / max(ds['decode_steps'], 1):.2f} "
            f"({ds['decode_steps']} decode steps) ({smi})")
        del prefill, decode, pair, results, got
        torch.cuda.empty_cache()
    for rec in records["none"]:  # the wire leg alone: the record to JSON text and back
        t0 = time.perf_counter()
        HandoffRecord.from_wire(json.loads(json.dumps(rec.to_wire()))).verify_digest()
        timings["wire"].append(time.perf_counter() - t0)
    ratio = sum(r.kv_bytes for r in records["int8"]) / sum(r.kv_bytes for r in records["none"])
    blocks = [r.num_blocks for r in records["none"]]
    if abs(ratio - _block_bytes("int8") / _block_bytes("none")) > 1e-12:  # (80 + 4) / 160 = 0.525 at head_dim 80
        raise AssertionError(f"phase 3e (b): int8 KV ships {ratio} of bf16's bytes")
    log(f"[phase 3e] (b) payloads: {blocks} blocks; {_block_bytes('none')} B a block at bf16 KV, "
        f"{_block_bytes('int8')} B at int8 KV: int8 ships {ratio:.3f} of bf16's bytes")
    for what, ts in timings.items():
        ms = np.asarray(ts) * 1e3
        log(f"[phase 3e] (e) handoff {what} ms over {len(ms)} records: p50 {np.percentile(ms, 50):.2f} max "
            f"{ms.max():.2f}" + (" (bf16 KV: to_wire, JSON text and back, digest)" if what == "wire" else ""))

    # (c) the tiers behind the DisaggRouter over HTTP, bf16 KV
    tok = _IntTok()
    rows = [{"prompt": tok.decode(r["prompt"]), "max_new_tokens": NEW_TOKENS, "temperature": r["temperature"],
             "seed": r["seed"]} for r in reqs]
    wire_bytes = [4 * -(-r.kv_bytes // 3) for r in records["none"]]  # the base64 of the payload alone
    fits = [i for i, b in enumerate(wire_bytes) if b + WIRE_MARGIN < BODY_LIMIT]
    over = [i for i, b in enumerate(wire_bytes) if b > BODY_LIMIT]
    if not fits or not over:
        raise AssertionError(f"phase 3e (c): import bodies {wire_bytes}: no request on one side of the limit")
    component = DisaggServingComponent(model, tok, max_batch_slots=SLOTS, cache_capacity=CAPACITY,
                                       max_new_tokens=NEW_TOKENS, kv_cache="paged", paged_block_size=PAGED_BLOCK,
                                       quant={"weights": "int8"}, health_interval_s=3600.0)
    # the health loop's first round runs at boot; later ones are this phase's own (router.health_round), so a
    # probe cannot revive the decode worker between the over-limit import and its replay
    stop, thread, out = _start_fleet(torch, component, params, "3e")
    router = component.router
    pworker, dworker = component.workers
    threads, outs = _post_all(router.port, [rows[i] for i in fits])
    for t in threads:
        t.join()
    dones = [_done(o, f"(c) request {i}", "3e") for i, o in zip(fits, outs)]
    same, where = _agreement([replays["int8"][i] for i in fits], [d["token_ids"] for d in dones])
    if same != len(fits) or router.failovers != 0:
        raise AssertionError(f"phase 3e (c): {same} of {len(fits)} requests bitwise over HTTP, {where}; failovers "
                             f"{router.failovers}")
    i = max(over, key=lambda j: wire_bytes[j])
    exported0 = pworker.engine.stats()["handoffs_exported"]
    status, events, _ = _http(router.port, "POST", "/generate", rows[i])
    healthy = {w.name: w.healthy for w in router.workers}
    router.health_round()  # the probe that brings the decode worker back
    _, text, _ = _http(router.port, "GET", "/metrics")
    peer_down = parse_prometheus_text(text)["disagg_handoff_failures_total"].get((("reason", "peer_down"),))
    path = [e.get("token_id", e.get("error")) for e in events] if isinstance(events, list) else events
    if (status, path, router.failovers, peer_down, healthy["decode0"],
            pworker.engine.stats()["handoffs_exported"] - exported0) != (
            200, [replays["int8"][i][0], "no healthy decode workers"], 1, 1.0, False, 2):
        raise AssertionError(f"phase 3e (c): the over-limit request: HTTP {status}, events {path}, failovers "
                             f"{router.failovers}, peer_down {peer_down}, healthy {healthy}, exported "
                             f"{pworker.engine.stats()['handoffs_exported'] - exported0}")
    if not all(w.healthy for w in router.workers):
        raise AssertionError(f"phase 3e (c): a health round left the decode worker out: {router.fleet_table()}")
    log(f"[phase 3e] (c) {len(fits)} requests whose import body fits 16 MiB (<= {max(blocks[j] for j in fits)} "
        f"blocks) bitwise the replay over HTTP; request {i} ({blocks[i]} blocks, import body "
        f"{wire_bytes[i] / 2**20:.1f} MiB of base64): token #1, then the decode worker closed the connection: "
        f"counted dead (peer_down 1, failovers 1), one replay through a fresh prefill, SSE error \"no healthy "
        f"decode workers\"; the next health round put it back in rotation ({smi})")

    # (d) rejections at the decode worker, then a corrupted export replayed through the router
    short = min(fits, key=lambda j: blocks[j])
    status, pbody, _ = _http(pworker.server.port, "POST", "/disagg/prefill", rows[short])
    wire = pbody["record"]
    flipped = json.loads(json.dumps(wire))
    raw = bytearray(base64.b64decode(flipped["payload"][0]["data"]))
    raw[0] ^= 0xFF
    flipped["payload"][0]["data"] = base64.b64encode(bytes(raw)).decode("ascii")
    skewed = HandoffRecord.from_wire(wire)
    skewed.generation += 1
    reasons = []
    for bad in (flipped, skewed.seal().to_wire()):
        status, events, _ = _http(dworker.server.port, "POST", "/disagg/import", {"record": bad})
        reasons.append((status, events[-1].get("reason"), events[-1].get("retryable")))
    if reasons != [(200, "digest_mismatch", True), (200, "generation_mismatch", True)]:
        raise AssertionError(f"phase 3e (d): rejections {reasons}")
    engine = pworker.engine
    export = engine._export_handoff
    corrupted = []

    def corrupt_once(*args, **kwargs):
        record = export(*args, **kwargs)
        if not corrupted:  # after the seal: the decode worker's digest check must catch it
            record.payload[0].view(torch.uint8).view(-1)[0] ^= 0xFF
            corrupted.append(record.rid)
        return record

    engine._export_handoff = corrupt_once
    failovers0 = router.failovers
    done = _done(_http(router.port, "POST", "/generate", rows[short]), "(d) a corrupted export", "3e")
    engine._export_handoff = export
    _, text, _ = _http(router.port, "GET", "/metrics")
    digest = parse_prometheus_text(text)["disagg_handoff_failures_total"].get((("reason", "digest_mismatch"),))
    if done["token_ids"] != replays["int8"][short] or router.failovers != failovers0 or digest != 1.0 \
            or not all(w.healthy for w in router.workers):
        raise AssertionError(f"phase 3e (d): replay tokens {done['token_ids'] == replays['int8'][short]}, failovers "
                             f"{router.failovers - failovers0}, digest_mismatch {digest}")
    log(f"[phase 3e] (d) a flipped payload byte: digest_mismatch; generation + 1 resealed: generation_mismatch "
        f"(both retryable); a corrupted export through the router: rejected, replayed through a fresh prefill, "
        f"tokens bitwise, the decode worker in rotation, no failover")
    counts = _launches_held(torch, [w.engine for w in component.workers], "3e", forwards)
    stop.set()
    thread.join(120)
    if thread.is_alive() or not out:
        raise AssertionError("phase 3e: run_fleet did not drain")
    log(f"[phase 3e] phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    del component, router
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve_disagg": counts}


# ---------------------------------------------------------------- main
# ---------------------------------------------------------------- phase 3f
OBSERVED_WATCHDOG_S = 0.5  # (d): the deadline of a dispatch; the first one gets 4x (the JAX first-step factor)
WEDGE_S = 3.0  # (d): how long the wedged decode dispatch stalls
CANARY_PROMPT = 2000  # (c): tokens of each of the canary's long prompts: packed prefill that takes the first TTFT
# to ~0.5 s at SERVE_LAYERS (1.2 s at 32 layers)
CANARY_WAVES = 2  # (c): the canary's slots filled twice over, so the queued wave's TTFT (>= 1 s) breaches ttft_p99;
# the SLO-only brownout may shed what is still queued once the breach is seen (as in (a) and (b))
LIVE_ERROR_RATE = ("error_rate_live", "serve_request_errors_total / serve_requests_submitted_total < 0.01")
COST_RUNS = 2  # (e): runs a side, telemetry on and off in turns


def _observed_config(tmp: Path, name: str, changes: dict, out: str = "") -> Path:
    """configs/<name>.yaml with the model node at MODEL_2P7B cut to SERVE_LAYERS, the phase's
    word-level tokenizer, int8 weights, 2048-token caches and `changes`;
    its `slo` block as shipped. Written to tmp/<out or name>.yaml."""
    import yaml

    repo = Path(__file__).resolve().parent
    cfg = yaml.safe_load((repo / "configs" / f"{name}.yaml").read_text())
    node = cfg["serving_component"]["config"]
    node["model"]["config"] = dict(json.loads(json.dumps(MODEL_2P7B)), n_layer=SERVE_LAYERS)
    node["tokenizer"]["config"]["pretrained_model_name_or_path"] = str(tmp / "tokenizer")
    node.update({"quant": {"weights": "int8"}, "cache_capacity": CAPACITY, **changes})
    path = tmp / f"{out or name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _words(ids) -> str:
    return " ".join(f"t{int(i)}" for i in ids)


def _sink_lines(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def _cli(argv: list) -> tuple[int, str]:
    """`python -m modalities_tpu_torch <argv>` in process: (exit code, stdout)."""
    import io

    from modalities_tpu_torch.__main__ import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    return rc, out.getvalue()


def phase_serve_observed(torch, model, params, reqs: list[dict], ring_int8: list, replay: list,
                         smi: str) -> dict[str, dict[str, int]]:
    """Phase 3f (see the module docstring): serving under telemetry and SLOs.
    Returns the path's launches, counted from 0 just before its first
    forward and read after its last."""
    import threading

    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm
    from modalities_tpu_torch.quant.weights import quantize_params
    from modalities_tpu_torch.serving.serve import build_serving_components, serve
    from modalities_tpu_torch.serving.server import ServingHTTPServer
    from modalities_tpu_torch.config.yaml_interp import load_app_config_dict
    from modalities_tpu_torch.telemetry import NOOP_TELEMETRY, Telemetry, set_active_telemetry
    from modalities_tpu_torch.telemetry.metrics import parse_prometheus_text
    from modalities_tpu_torch.telemetry.slo import SLOEngine, load_slo_spec, parse_objective

    t_phase = time.perf_counter()
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=scratch, prefix="observed_"))
    _word_tokenizer(tmp / "tokenizer", MODEL_2P7B["vocab_size"] + 1)  # <eod> past the vocabulary: never generated
    rows = [{"prompt": _words(r["prompt"]), "max_new_tokens": NEW_TOKENS, "temperature": r["temperature"],
             "seed": r["seed"]} for r in reqs]
    (tmp / "requests.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    forwards = 0
    rms_norm.launches = quant_matmul.launches = 0
    saved_env = {k: os.environ.get(k) for k in ("MODALITIES_TPU_SERVE_TELEMETRY_DIR", "MODALITIES_TPU_SERVE_KV_CACHE")}
    os.environ.pop("MODALITIES_TPU_SERVE_KV_CACHE", None)  # the ring, as the file sets it

    # (a) phase 2's requests through serve() with the telemetry dir: the CLI's replay path
    cfg_serve = _observed_config(tmp, "config_serve", {})
    os.environ["MODALITIES_TPU_SERVE_TELEMETRY_DIR"] = str(tmp / "sink_a")
    import modalities_tpu_torch.telemetry as telemetry_mod

    armed, set_active = [], telemetry_mod.set_active_telemetry
    telemetry_mod.set_active_telemetry = lambda t: (armed.append(t), set_active(t))[1]
    t0 = time.perf_counter()
    try:
        stats = serve(cfg_serve, tmp / "requests.jsonl", tmp / "out_a.jsonl", device=SERVE_DEVICE)
    finally:
        telemetry_mod.set_active_telemetry = set_active
        os.environ.pop("MODALITIES_TPU_SERVE_TELEMETRY_DIR")
    wall_a = time.perf_counter() - t0
    forwards += stats["forward_calls"]
    out_rows = _sink_lines(tmp / "out_a.jsonl")
    sink_a = tmp / "sink_a" / "telemetry_rank_0.jsonl"
    events_a = _sink_lines(sink_a)
    records = {r["rid"]: r for r in events_a if r.get("event") == "serve_request"}
    breaches = [e for e in events_a if e.get("event") == "resilience" and e.get("name") == "slo/breach"]
    telemetry_a = next(t for t in armed if t is not None and t is not NOOP_TELEMETRY)
    parsed = parse_prometheus_text(telemetry_a.metrics.render())
    served, shed = [], []
    for i, row in enumerate(out_rows):
        if row["finish_reason"] == "shed":  # the SLO-only brownout shed it while queued: a breach came first
            shed.append(i)
            continue
        if row["finish_reason"] != "budget" or row["tokens"] != ring_int8[i]:
            raise AssertionError(f"phase 3f (a): request {i} finished {row['finish_reason']} with tokens "
                                 f"{'equal' if row['tokens'] == ring_int8[i] else 'unequal'} to phase 2's int8 ring")
        served.append(i)
    by_reason = {}
    for r in records.values():
        by_reason[r["finish_reason"]] = by_reason.get(r["finish_reason"], 0) + 1
    checks = {
        "9 records": sorted(records) == [r["rid"] for r in out_rows] and len(records) == len(rows),
        "record tokens": all(records[r["rid"]]["tokens"] == len(r["tokens"]) and
                             records[r["rid"]]["finish_reason"] == r["finish_reason"] for r in out_rows),
        "shed after a breach": (not shed) or bool(breaches),
        "stats decode tokens": sum(len(r["tokens"]) for r in out_rows) == stats["decode_tokens"] + len(served),
        "metrics tokens": parsed["serve_tokens_generated_total"][()] == sum(len(r["tokens"]) for r in out_rows),
        "metrics finishes": {dict(k).get("reason"): v for k, v in parsed["serve_requests_finished_total"].items()}
                            == {k: float(v) for k, v in by_reason.items()},
        "metrics ttft": parsed["serve_ttft_seconds_count"][()] == float(len(served)),
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 3f (a): {checks}; finishes {by_reason}")
    same_replay, where = _agreement(replay, [out_rows[i]["tokens"] for i in range(len(rows))])
    rc_serve, text_serve = _cli(["data", "analyze_serve", "--sink_path", str(sink_a.parent)])
    rc_json, text_json = _cli(["data", "analyze_serve", "--sink_path", str(sink_a.parent), "--as_json"])
    spec = tmp / "slo_serve.yaml"
    spec.write_text(json.dumps(load_app_config_dict(cfg_serve)["serving_component"]["config"]["slo"]))
    rc_slo, text_slo = _cli(["data", "check_slo", "--slo_path", str(spec), "--sink_path", str(sink_a.parent)])
    summary = json.loads(text_json)
    if (rc_serve, rc_json) != (0, 0) or rc_slo not in (0, 1) or summary["requests"] != len(rows) \
            or "ttft_p99" not in text_slo or "requests: 9" not in text_serve:
        raise AssertionError(f"phase 3f (a): data commands exit {rc_serve}, {rc_json}, {rc_slo}: {text_slo}")
    lat = summary["latency"]
    log(f"[phase 3f] (a) serve() on config_serve.yaml (ring, int8, slo block as shipped) with "
        f"MODALITIES_TPU_SERVE_TELEMETRY_DIR: {len(served)} of 9 requests bitwise phase 2's int8 ring tokens, "
        f"{len(shed)} shed by the SLO brownout ({len(breaches)} slo/breach events before); against 3c's replay "
        f"{same_replay} of 9 ({where}); 9 serve_request records agree with the rows, stats() and /metrics; "
        f"{wall_a:.2f} s ({smi})")
    log(f"[phase 3f] (a) analyze_serve: TTFT p50 {lat['ttft_s']['p50'] * 1e3:.1f} ms p99 "
        f"{lat['ttft_s']['p99'] * 1e3:.1f} ms, e2e p50 {lat['e2e_s']['p50']:.3f} s, queue wait p99 "
        f"{lat['queue_wait_s']['p99'] * 1e3:.1f} ms, mean TPOT p50 {lat['tpot_mean_s']['p50'] * 1e3:.2f} ms; "
        f"check_slo exit {rc_slo}: " + " | ".join(line.strip() for line in text_slo.strip().splitlines()))
    n_lines, n_bytes = len(events_a), sink_a.stat().st_size
    del armed, telemetry_a  # its registry's gauges hold the engine
    gc.collect()

    # (b) a breach: a NaN generation on the config's component, its SLO engine on a stepped clock. The paged
    # cache: a NaN generation leaves NaN K/V in the ring rows its request wrote, and the masked attention
    # multiplies them by zero probabilities (NaN), in both packages; the paged engine scrubs V rows
    cfg_paged = _observed_config(tmp, "config_serve", {"kv_cache": "paged", "paged_block_size": PAGED_BLOCK},
                                 "config_serve_paged")
    clock = {"t": 0.0}
    telemetry_b = Telemetry(output_folder_path=tmp / "sink_b", watchdog_deadline_s=0.0)
    prior = set_active_telemetry(telemetry_b)
    try:
        comp = build_serving_components(load_app_config_dict(cfg_paged)).serving_component
        comp.device, comp.params = torch.device(SERVE_DEVICE), params
        objectives, options = load_slo_spec(comp.slo)
        objectives.append(parse_objective(*LIVE_ERROR_RATE))
        slo = SLOEngine(objectives, telemetry_b.metrics, time_fn=lambda: clock["t"], **options)  # no sampler thread
        comp.slo_engine = slo
        engine = comp.build_engine()
        if engine.brownout is None or engine.brownout.queue_high is not None:
            raise AssertionError("phase 3f (b): the SLO-only brownout is not wired")
        gate = threading.Event()
        gate.set()
        step = engine.step
        engine.step = lambda t: step(t) if gate.is_set() else False
        server = ServingHTTPServer(engine, encode=comp._encode, decode=comp.tokenizer.decode, port=0,
                                   default_max_new_tokens=NEW_TOKENS)
        server.slo_status_fn = slo.breaching
        server.start()
        donor = quantize_params(params, "int8")
        nan = {k: torch.full_like(v, float("nan")) if v.is_floating_point() else v for k, v in donor.items()}
        clock["t"] += 1.0
        first = slo.sample_once()
        health0 = _http(server.port, "GET", "/healthz")[1]
        engine.request_swap(nan).wait()
        poisoned = _done(_http(server.port, "POST", "/generate", rows[0]), "(b) NaN generation", "3f")
        # the shut gate holds the engine between steps, so no queue sweep consults the brownout until it opens
        gate.clear()
        clock["t"] += 1.0
        verdicts = slo.sample_once()
        breached = parse_prometheus_text(telemetry_b.metrics.render())["slo_breaches_total"]
        health1 = _http(server.port, "GET", "/healthz")[1]
        # the brownout: 100 arrivals queue behind the gate, then the first sweep sheds them
        dilute = [{"prompt": rows[i % len(rows)]["prompt"], "max_new_tokens": 1} for i in range(100)]
        threads, outs = _post_all(server.port, dilute)
        _wait(lambda: len(engine._queue) == len(dilute), "100 queued arrivals", phase="3f")
        gate.set()
        for t in threads:
            t.join()
        shed_b = [_done(o, "(b) queued", "3f")["finish_reason"] for o in outs]
        status_r, err_r, headers_r = _http(server.port, "POST", "/generate", rows[1])
        engine.request_swap(donor).wait()
        still = slo.breaching()
        clock["t"] += 700.0  # past the slow window: the bad sample ages out
        recovered = slo.sample_once()
        health2 = _http(server.port, "GET", "/healthz")[1]
        _wait(lambda: not engine.brownout.active, "the brownout to clear", phase="3f")
        restored = _done(_http(server.port, "POST", "/generate", rows[0]), "(b) donor back", "3f")
        server.stop()
        final_b = server.serve_forever()
    finally:
        telemetry_b.close()
        set_active_telemetry(prior)
    forwards += final_b["forward_calls"]
    events_b = [e["name"] for e in _sink_lines(tmp / "sink_b" / "telemetry_rank_0.jsonl")
                if e.get("event") == "resilience" and e["name"].startswith("slo/")]
    checks = {
        "quiet start": set(first.values()) == {None} and health0["status"] == "ok" and health0["slo_breaching"] == [],
        "NaN request error": poisoned["finish_reason"] == "error",
        "shipped error_rate unjudgeable live": verdicts["error_rate"] is None,
        "live error rate breaches": verdicts["error_rate_live"] is False
                                    and breached.get((("objective", "error_rate_live"),)) == 1.0,
        "degraded": (health1["status"], health1["slo_breaching"]) == ("degraded", ["error_rate_live"]),
        "brownout sheds the queue": shed_b == ["shed"] * len(dilute),
        "brownout rejects arrivals": (status_r, err_r.get("reason")) == (429, "brownout_reject"),
        "breach holds": still == ["error_rate_live"],
        "recovered": recovered["error_rate_live"] is True and health2["status"] == "ok"
                     and health2["slo_breaching"] == [],
        "donor bitwise": restored["finish_reason"] == "budget" and restored["token_ids"] == replay[0],
        "sink events": events_b == ["slo/breach", "slo/recovered"],
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 3f (b): {checks}; verdicts {verdicts}, health {health1}, {health2}, 429 "
                             f"{status_r} {err_r}, sink {events_b}")
    log(f"[phase 3f] (b) a NaN generation's request finished \"error\": the shipped error_rate objective is "
        f"unjudgeable live (its denominator serve_requests_total exists only in check_slo's replay); "
        f"{LIVE_ERROR_RATE[0]} ({LIVE_ERROR_RATE[1]}) breached on sample_once(), slo_breaches_total 1, /healthz "
        f"degraded {health1['slo_breaching']}; the SLO-only brownout shed the 100 queued arrivals and answered a new "
        f"POST 429 brownout_reject (Retry-After {headers_r.get('Retry-After')}); the donor swapped back, the clock "
        f"past the 600 s slow window: recovered (1 error in {1 + len(dilute)} submitted), /healthz ok, the "
        f"brownout cleared and the donor answered request 0 bitwise 3c's replay (the paged cache)")
    del telemetry_b, engine, comp, server, slo, donor, nan
    gc.collect()

    # (c) the fleet: two workers with config_fleet.yaml's slo block; a canary that burns ttft_p99 rolls back
    from modalities_tpu_torch.serving.fleet.component import FleetServingComponent  # noqa: F401 (the registry's)

    telemetry_c = Telemetry(output_folder_path=tmp / "sink_c", watchdog_deadline_s=0.0)
    prior = set_active_telemetry(telemetry_c)
    try:
        cfg_fleet = _observed_config(tmp, "config_fleet", {})
        fleet = build_serving_components(load_app_config_dict(cfg_fleet)).serving_component
        stop, thread, out = _start_fleet(torch, fleet, params, "3f")
        router, controller, workers = fleet.router, fleet.controller, fleet.workers
        engines = [w.engine for w in workers]
        if sorted(fleet.slo_engines) != ["worker0", "worker1"]:
            raise AssertionError(f"phase 3f (c): SLO engines {sorted(fleet.slo_engines)}")
        donor = quantize_params(params, "int8")
        verdict, ended = [], []
        deploy = threading.Thread(target=lambda: (verdict.append(controller.deploy(donor, step=1)),
                                                  ended.append(time.perf_counter())))
        t0 = time.perf_counter()
        deploy.start()
        _wait(lambda: any(e.weights_generation == 1 for e in engines) or not deploy.is_alive(), "the canary",
              phase="3f")
        swapped_at = time.perf_counter()
        canary = next(w for w in workers if w.engine.weights_generation == 1)
        rng = np.random.default_rng(3)
        long_rows = [{"prompt": _words(rng.integers(0, MODEL_2P7B["vocab_size"], size=CANARY_PROMPT)),
                      "max_new_tokens": 8} for _ in range(CANARY_WAVES * SLOTS)]
        threads, outs = _post_all(canary.server.port, long_rows)
        deploy.join()
        for t in threads:
            t.join()
        canary_rows = [_done(o, f"(c) canary request {i}", "3f") for i, o in enumerate(outs)]
        canary_done = [d["finish_reason"] for d in canary_rows]
        rollback_s, probation_s = ended[0] - t0, ended[0] - swapped_at
        health = _http(canary.server.port, "GET", "/healthz")[1]
        _wait(lambda: next(w for w in router.workers if w.name == canary.name).degraded, "the router to see "
              "the canary degraded", seconds=30.0, phase="3f")
        # the fleet's answer after the rollback: the donor generation, through the router
        threads, outs = _post_all(router.port, rows[:2])
        for t in threads:
            t.join()
        routed = [_done(o, f"(c) routed request {i}", "3f") for i, o in enumerate(outs)]
        for e in engines:
            _wait(lambda e=e: e.stats()["active_slots"] == 0 and e.stats()["queue_depth"] == 0, "the workers idle",
                  phase="3f")
        forwards_c = sum(e.stats()["forward_calls"] for e in engines)
        stop.set()
        thread.join(120)
        if thread.is_alive() or not out:
            raise AssertionError("phase 3f (c): run_fleet did not drain")
    finally:
        telemetry_c.close()
        set_active_telemetry(prior)
    forwards += forwards_c
    sink_c = tmp / "sink_c"
    rollbacks = [e for e in _sink_lines(sink_c / "telemetry_rank_0.jsonl")
                 if e.get("event") == "resilience" and e.get("name") == "fleet/rollback"]
    rc_fleet, text_fleet = _cli(["data", "analyze_fleet", "--sink_path", str(sink_c), "--as_json"])
    traces = {t["trace_id"]: t for t in json.loads(text_fleet)}
    routed_ids = [d["trace_id"] for d in routed]
    checks = {
        "rolled back": verdict == [False] and controller.generation == 0 and canary.engine.weights_generation == 0,
        "stage slo": [r.get("stage") for r in rollbacks] == ["slo"] and "ttft_p99" in rollbacks[0].get("reason", ""),
        "canary requests": set(canary_done) <= {"budget", "shed"} and canary_done.count("budget") >= SLOTS,
        "canary degraded": (health["status"], health["slo_breaching"]) == ("degraded", ["ttft_p99"]),
        "donor bitwise": [d["token_ids"] for d in routed] == [replay[0], replay[1]]
                         and all(d["weights_generation"] == 0 for d in routed),
        "one trace a routed request": rc_fleet == 0 and all(
            traces.get(tid, {}).get("router", {}).get("outcome") == "done"
            and len(traces[tid]["worker_legs"]) == 1 for tid in routed_ids),
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 3f (c): {checks}; canary finishes {canary_done}; rollbacks {rollbacks}, "
                             f"health {health}")
    ttfts = [d["ttft_s"] for d in canary_rows if d.get("ttft_s") is not None]  # a shed request has none
    log(f"[phase 3f] (c) config_fleet.yaml, 2 workers with per-worker SLO engines: canary {canary.name} took "
        f"{len(long_rows)} prompts of {CANARY_PROMPT} tokens during probation ({canary_done.count('budget')} "
        f"finished \"budget\", {canary_done.count('shed')} queued ones shed by the brownout after the breach), "
        f"burned ttft_p99 and rolled back with stage slo "
        f"({rollbacks[0].get('reason')}) {rollback_s:.2f} s after the deploy began ({probation_s:.2f} s after the "
        f"canary's swap, its first TTFT {min(ttfts) * 1e3:.1f} ms, its last {max(ttfts) * 1e3:.1f} ms); /healthz "
        f"degraded, the router "
        f"marked it degraded; 2 requests through the router answered by the donor generation bitwise; "
        f"analyze_fleet stitched each routed request into one trace (router record + 1 worker leg; "
        f"{len(traces)} traces in the sink)")
    del telemetry_c, fleet, router, controller, workers, engines, canary, donor
    gc.collect()

    # (d) the watchdog: a decode dispatch wedged on purpose dumps one artifact
    telemetry_d = Telemetry(output_folder_path=tmp / "sink_d", watchdog_deadline_s=OBSERVED_WATCHDOG_S)
    prior = set_active_telemetry(telemetry_d)
    try:
        comp = build_serving_components(load_app_config_dict(cfg_serve)).serving_component
        comp.device, comp.params = torch.device(SERVE_DEVICE), params
        engine = comp.build_engine()  # registers its stats() with the active telemetry's watchdog
        calls = {"n": 0}
        dispatch = engine._decode_dispatch

        def wedged(t0):
            calls["n"] += 1
            if calls["n"] == 3:
                time.sleep(WEDGE_S)
            return dispatch(t0)

        engine._decode_dispatch = wedged
        engine.submit(list(reqs[0]["prompt"][:64]), 8, temperature=0.0)
        engine.run()
        forwards += engine.stats()["forward_calls"]
        artifacts = telemetry_d.watchdog_artifacts
    finally:
        telemetry_d.close()
        set_active_telemetry(prior)
    del telemetry_d, engine, comp
    gc.collect()
    artifact = json.loads(artifacts[0].read_text()) if artifacts else {}
    memory = artifact.get("device_memory", {})
    stacks = "".join("".join(s) for s in artifact.get("thread_stacks", {}).values())
    want_keys = ({"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} if SERVE_DEVICE == "cuda" else set())
    checks = {
        "one artifact": len(artifacts) == 1,
        "keys": {"thread_stacks", "device_memory", "state", "metrics", "weights_generation", "armed_step"}
                <= set(artifact),
        "the wedged frame": "wedged" in stacks,
        "engine snapshot": artifact.get("state", {}).get("serving_engine", {}).get("kv_cache") == "ring",
        "memory keys": all(want_keys <= set(v) for v in memory.values()) and bool(memory),
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 3f (d): {checks}; {sorted(artifact)} {memory}")
    mem = next(iter(memory.values()))
    log(f"[phase 3f] (d) a decode dispatch wedged {WEDGE_S} s against a {OBSERVED_WATCHDOG_S} s deadline: one "
        f"artifact {artifacts[0].name} (armed step {artifact['armed_step']}, overdue {artifact['overdue_s']} s) "
        f"with {len(artifact['thread_stacks'])} thread stacks, the engine's published stats and the device "
        f"memory under the JAX keys: " + ", ".join(f"{k} {mem.get(k)}" for k in sorted(want_keys)))

    # (e) the cost: host ms a decode step with telemetry on and off, in turns on one engine
    comp = build_serving_components(load_app_config_dict(cfg_serve)).serving_component
    comp.device, comp.params = torch.device(SERVE_DEVICE), params
    engine = comp.build_engine()
    per_step = {"on": [], "off": []}
    for i in range(COST_RUNS):
        for mode in ("on", "off"):
            telemetry_e = Telemetry(output_folder_path=tmp / f"sink_e{i}", watchdog_deadline_s=300.0) \
                if mode == "on" else None
            prior = set_active_telemetry(telemetry_e)
            try:
                s0 = engine.stats()
                for r in reqs[:SLOTS]:
                    engine.submit(list(r["prompt"][:64]), 32, temperature=0.0, seed=r["seed"])
                engine.run()
                s1 = engine.stats()
            finally:
                if telemetry_e is not None:
                    telemetry_e.close()
                set_active_telemetry(prior)
            per_step[mode].append(1e3 * (s1["decode_seconds"] - s0["decode_seconds"])
                                  / (s1["decode_steps"] - s0["decode_steps"]))
    forwards += engine.stats()["forward_calls"]
    del engine, comp
    log(f"[phase 3f] (e) host ms a decode step (8 slots, int8, ring), telemetry on / off in turns: on "
        f"{', '.join('%.2f' % v for v in per_step['on'])}; off {', '.join('%.2f' % v for v in per_step['off'])}; "
        f"median on / off {np.median(per_step['on']) / np.median(per_step['off']):.3f}; the sink of (a): "
        f"{n_lines / len(rows):.1f} records and {n_bytes / len(rows):.0f} bytes a request ({smi})")

    if SERVE_DEVICE == "cuda":
        torch.cuda.synchronize()
    counts = {"rms_fwd": rms_norm.launches, "quant_matmul": quant_matmul.launches}
    want = {"rms_fwd": PER_FORWARD["rms"] * forwards, "quant_matmul": PER_FORWARD["qmm"] * forwards}
    if counts != want:
        raise AssertionError(f"phase 3f: launches {counts} over {forwards} forwards; expected {want}")
    log(f"[phase 3f] launches: rms_norm {counts['rms_fwd']} = {PER_FORWARD['rms']} x {forwards} forwards, quant_matmul "
        f"{counts['quant_matmul']} = {PER_FORWARD['qmm']} x {forwards}; phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    for k, v in saved_env.items():
        if v is not None:
            os.environ[k] = v
    shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if SERVE_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"serve_observed": counts}


# ---------------------------------------------------------------- phase 3g
GEN_PROMPTS = (0, 1, 3)  # phase 2's greedy requests
# decode_step's last prefill position against the full forward's, ||a - b|| / ||b|| of the logits row: in fp32
# compute the two paths hold FLASH_ROW_REL["float32"]; in bf16 the decode path's distance from the fp32 forward
# must stay within GEN_BF16_FACTOR x the bf16 forward's own (the pattern of the 32k witness, Queue 3 item 3: a
# path against the plain path's own bf16-vs-fp32 gap). Two bf16 paths differ in their GEMM shapes (prefill chunks
# of 64 / 16 / 4 / 1 rows against one 512-row forward; keys over the cache's 4096 rows), so their roundings differ.
GEN_F32_REL = FLASH_ROW_REL["float32"]
GEN_PROFILED = 8  # single-token decode steps profiled for the device ms a step
GEN_REPEAT = 16  # tokens of the second call, held bitwise to the first call's first ones
GEN_BF16_FACTOR = 2.0


def _ring_greedy(torch, model, params, prompts: list) -> list[list[int]]:
    """Greedy tokens of phase 2's ring engine (bf16 weights, SLOTS slots of a
    CAPACITY-token ring) on `prompts`, NEW_TOKENS each."""
    from modalities_tpu_torch.serving.serve import ServingComponent

    component = ServingComponent(model, _IdTok(), max_batch_slots=SLOTS, cache_capacity=CAPACITY,
                                 max_new_tokens=NEW_TOKENS, quant={"weights": "none"})
    component.device, component.params = torch.device(SERVE_DEVICE), params
    engine = component.build_engine()
    rids = [engine.submit(p, NEW_TOKENS, temperature=0.0, seed=0) for p in prompts]
    results = engine.run()
    tokens = [results[r].tokens for r in rids]
    del engine, component
    return tokens


def phase_generate(torch, model, params, reqs: list[dict], smi: str) -> dict[str, dict[str, int]]:
    """Text generation at the 2.7B's width (inference/text/inference_component.py):
    `TextInferenceComponent` greedy on three of phase 2's prompts, 64 new
    tokens each. Held: a second call gives the first GEN_REPEAT tokens
    bitwise; the RMSNorm forward
    kernel runs 65 times a forward (decode_step call); after each prompt's
    prefill (the (64, 16, 4, 1) ladder) decode_step's last logits against
    the full forward's at that position: within GEN_F32_REL in fp32
    compute, and in bf16 no farther from the fp32 forward than
    GEN_BF16_FACTOR x the bf16 forward is. Reported: the
    tokens' agreement with phase 2's ring engine on the same weights (run
    here, before the counts are reset) position by position, the
    host ms a token (the whole call, prefill included) and the device ms a
    decode step (GEN_PROFILED single-token steps under torch.profiler)."""
    from modalities_tpu_torch.inference.text.inference_component import TextInferenceComponent
    from modalities_tpu_torch.ops.rmsnorm import rms_norm

    t_phase = time.perf_counter()
    prompts = [reqs[i]["prompt"] for i in GEN_PROMPTS]
    ring_tokens = _ring_greedy(torch, model, params, prompts)
    per_fwd = per_forward(model.config_spec.n_layer)["rms"]
    component = TextInferenceComponent(model, _IdTok(), "{prompt}", MODEL_2P7B["sequence_length"], temperature=0.0,
                                       eod_token=None)
    component.device, component.params = torch.device(SERVE_DEVICE), params
    module = component.module
    forwards = [0]
    decode_step = module.decode_step

    def counted(*args, **kwargs):
        forwards[0] += 1
        return decode_step(*args, **kwargs)

    module.decode_step = counted
    component.generate_token_ids(prompts[0], 4)  # the first call's allocations, not counted
    torch.cuda.synchronize()
    rms_norm.launches, forwards[0] = 0, 0
    t0 = time.perf_counter()
    first = [component.generate_token_ids(p, NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fwd = rms_norm.launches, forwards[0]
    if launches != per_fwd * fwd:
        raise AssertionError(f"phase 3g: rms_norm launched {launches} times in {fwd} forwards, expected "
                             f"{per_fwd} a forward")
    if [len(t) for t in first] != [NEW_TOKENS] * len(prompts):
        raise AssertionError(f"phase 3g: {[len(t) for t in first]} tokens, expected {NEW_TOKENS} each")
    again = [component.generate_token_ids(p, GEN_REPEAT) for p in prompts]
    if again != [t[:GEN_REPEAT] for t in first]:
        raise AssertionError("phase 3g: two greedy calls on the same prompts gave different tokens")
    import copy

    model32 = copy.copy(model).with_spec_updates(compute_dtype="float32")
    module32 = model32.build_module(params)  # fp32 compute over the same tensors (nothing to cast)

    def prefilled(m, step, ids):
        cache, pos, n = m.init_decode_cache(1), 0, ids.shape[1]
        while pos < n:
            chunk = next(c for c in component._PREFILL_CHUNKS if c <= n - pos)
            logits, cache = step(cache, ids[:, pos:pos + chunk])
            pos += chunk
        return logits[0, -1]

    rels = []  # per prompt: (fp32 decode vs fp32 forward, bf16 decode vs bf16 forward, bf16 decode vs fp32
    # forward, bf16 forward vs fp32 forward)
    with torch.no_grad():
        for p in prompts:
            ids = torch.tensor([p], device=SERVE_DEVICE)
            fwd16, fwd32 = module(ids)[0, -1], module32(ids)[0, -1]
            dec16, dec32 = prefilled(module, decode_step, ids), prefilled(module32, module32.decode_step, ids)
            rels.append((_rel_norm(torch, dec32, fwd32), _rel_norm(torch, dec16, fwd16),
                         _rel_norm(torch, dec16, fwd32), _rel_norm(torch, fwd16, fwd32)))
    del module32, model32
    if any(r[0] > GEN_F32_REL or r[2] > GEN_BF16_FACTOR * r[3] for r in rels):
        raise AssertionError(f"phase 3g: decode_step's last logits against the forward's (fp32 vs fp32, bf16 vs "
                             f"bf16, bf16 vs fp32, the bf16 forward vs fp32): {rels}; bounds {GEN_F32_REL} and "
                             f"{GEN_BF16_FACTOR} x the last")
    with torch.no_grad():  # 8 single-token decode steps after the shortest prompt's prefill, under the profiler
        ids = torch.tensor([min(prompts, key=len)], device=SERVE_DEVICE)
        cache = module.init_decode_cache(1)
        _, cache = decode_step(cache, ids)
        tok = ids[:, -1:]
        rows, device_ms, profiled_ms = _profiled(torch, lambda: [decode_step(cache, tok) for _ in range(GEN_PROFILED)])
    agree = [sum(a == b for a, b in zip(mine, ring)) / len(ring) for mine, ring in zip(first, ring_tokens)]
    log(f"[phase 3g] generation at the 2.7B ({smi}): {len(prompts)} prompts of {[len(p) for p in prompts]} tokens, "
        f"{NEW_TOKENS} greedy tokens each in {wall:.2f} s: {1e3 * wall / (NEW_TOKENS * len(prompts)):.2f} host ms a "
        f"token (prefill included, {fwd} forwards); {device_ms / GEN_PROFILED:.3f} device ms a decode step "
        f"({sum(r[1] for r in rows) / GEN_PROFILED:.0f} launches; {GEN_PROFILED} steps under torch.profiler, "
        f"{profiled_ms / GEN_PROFILED:.2f} ms a step there); two calls "
        f"bitwise equal over {GEN_REPEAT} tokens; rms_norm {launches} = {per_fwd} x {fwd}; decode_step vs forward at the last "
        f"prompt position, relative (fp32 vs fp32 | bf16 vs bf16 | bf16 decode vs fp32 forward | bf16 forward vs "
        f"fp32 forward): {[' | '.join('%.2e' % x for x in r) for r in rels]} (bounds {GEN_F32_REL}; "
        f"{GEN_BF16_FACTOR} x the last); agreement with phase 2's ring engine on these weights "
        f"position by position {['%.3f' % a for a in agree]} (information only); {time.perf_counter() - t_phase:.1f} s")
    del component, module
    gc.collect()
    torch.cuda.empty_cache()
    return {"generate_2p7b": {"rms_fwd": launches}}


# ---------------------------------------------------------------- phase 11
RESILIENCE_LAYERS = CKPT_LAYERS  # phase 11c: the 32k config at phase 6's depth
TRAIN_DEVICE = "cuda"  # phases 11a-c (a CPU rehearsal of their logic sets "cpu")
SKIP_PEAK_REL = 0.05  # phase 11b: a skip_step step's peak memory within 5 % of the run without the skip's


def _parse_launches(out: str, what: str) -> dict[str, int]:
    """The summed `... kernel launches in this process: {...}` lines a subprocess printed."""
    lines = [json.loads(line.split(": ", 1)[1]) for line in out.splitlines() if "kernel launches in this process" in line]
    if not lines:
        raise AssertionError(f"{what}: no kernel launches line in its output")
    return {k: sum(c[k] for c in lines) for k in lines[0]}


def _subprocess(argv: list, cwd: Path, what: str, stdin: str = "", env: dict | None = None,
                timeout: int = 600, numpy_seed: int | None = None) -> subprocess.CompletedProcess:
    """`python -m modalities_tpu_torch *argv`; with `numpy_seed`, numpy's
    global generator is seeded with it before the module runs."""
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    entry = ["-m", "modalities_tpu_torch"] if numpy_seed is None else [
        "-c", f"import numpy, runpy; numpy.random.seed({numpy_seed}); "
              "runpy.run_module('modalities_tpu_torch', run_name='__main__', alter_sys=True)"]
    proc = subprocess.run([sys.executable, *entry, *argv], input=stdin, capture_output=True,
                          text=True, cwd=cwd, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": str(repo), **(env or {})})
    phase = " ".join(what.split()[:2])
    log(f"[{phase}] {what}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s (a process of its own)")
    return proc


def phase_quick_start(torch, smi: str) -> dict[str, dict[str, int]]:
    """Phase 11a, the README's quick start: `run --test_comm` over
    configs/config_lorem_ipsum_tpu.yaml with its mesh cut to world 1 (its
    token target with it: 8 steps of one rank's 8 x 64 tokens) and its paths
    pointed at a pbin and folders of this phase, its own `resilience` block in
    force; then `generate_text` over configs/config_generate_text.yaml from
    that run's last folder with a word-level tokenizer, prompts on stdin.
    Each a process of its own that reports its kernel launches."""
    import yaml

    from modalities_tpu_torch.dataloader.packed_data import write_pbin_file

    repo = Path(__file__).resolve().parent
    scratch = repo / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        cfg = yaml.safe_load((repo / "configs" / "config_lorem_ipsum_tpu.yaml").read_text())
        write_pbin_file(tmp / "lorem.pbin", [np.random.default_rng(2033).integers(0, 256, size=64 * 8 * 10)], 2)
        changes = {"settings.paths.train_dataset_path": str(tmp / "lorem.pbin"),
                   "settings.paths.checkpoint_saving_path": str(tmp / "checkpoints"),
                   "settings.paths.experiments_root_path": str(tmp / "experiments"),
                   "device_mesh.config.data_parallel_shard_degree": 1, "device_mesh.config.world_size": 1,
                   "settings.training_target.num_target_tokens": 8 * 8 * 64}
        for dotted, value in changes.items():
            node = cfg
            *parents, leaf = dotted.split(".")
            for key in parents:
                node = node[key]
            node[leaf] = value
            log(f"[phase 11a] config_lorem_ipsum_tpu.yaml: {dotted} = {value}")
        if cfg["resilience"]["config"]["anomaly_policy"] != "raise":
            raise AssertionError("phase 11a: the getting-started config's resilience block changed")
        (tmp / "lorem.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
        trained = _subprocess(["run", "--config_file_path", str(tmp / "lorem.yaml"), "--test_comm", "--device",
                               TRAIN_DEVICE], tmp,
                              "phase 11a run --test_comm")
        if trained.returncode != 0 or "[train] step 8:" not in trained.stdout:
            raise AssertionError(f"phase 11a: run failed: {trained.stdout[-2000:]} {trained.stderr[-3000:]}")
        comm = [line for line in trained.stdout.splitlines() if line.startswith("Communication test passed")]
        if len(comm) != 1 or not comm[0].startswith(f"Communication test passed over 1 rank(s) on {TRAIN_DEVICE}"):
            raise AssertionError(f"phase 11a: the communication test printed {comm}")
        train_counts = _parse_launches(trained.stdout, "phase 11a run")
        if any(train_counts[k] == 0 for k in TRAIN_KERNELS):
            raise AssertionError(f"phase 11a: a kernel of the quick start's training was never launched: "
                                 f"{train_counts}")
        losses = [line for line in trained.stdout.splitlines() if line.startswith("[train] step")]
        folder = json.loads((tmp / "checkpoints" / "last_checkpoint_info.json").read_text())["checkpoint_folder_path"]
        _word_tokenizer(tmp / "tokenizer", 256)
        gen = yaml.safe_load((repo / "configs" / "config_generate_text.yaml").read_text())
        gen["settings"]["checkpoint_folder_path"] = folder
        gen["tokenizer"]["config"]["pretrained_model_name_or_path"] = str(tmp / "tokenizer")
        (tmp / "generate.yaml").write_text(yaml.safe_dump(gen, sort_keys=False))
        log(f"[phase 11a] config_generate_text.yaml: settings.checkpoint_folder_path = {folder}; "
            f"tokenizer.config.pretrained_model_name_or_path = the word-level tokenizer of _word_tokenizer")
        generated = _subprocess(["generate_text", "--config_file_path", str(tmp / "generate.yaml"), "--device",
                                 TRAIN_DEVICE], tmp,
                                "phase 11a generate_text", stdin="t1 t2 t3\nt7 t8 t9 t10\n",
                                env={"HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1"})
        completions = [line.split("> ", 1)[1] for line in generated.stdout.splitlines()
                       if line.startswith("enter prompt> ")]
        if generated.returncode != 0 or len(completions) != 3 or not all(completions[:2]):
            raise AssertionError(f"phase 11a: generate_text failed: {generated.stdout[-2000:]} "
                                 f"{generated.stderr[-3000:]}")
        gen_counts = _parse_launches(generated.stdout, "phase 11a generate_text")
        if gen_counts["rms_fwd"] == 0:
            raise AssertionError(f"phase 11a: generate_text never launched the RMSNorm kernel: {gen_counts}")
    log(f"[phase 11a] quick start ({smi}): {losses[-1]}; {folder.rsplit('/', 1)[-1]}; completions "
        f"{[c[:60] for c in completions[:2]]}; launches: run {train_counts}, generate_text {gen_counts}")
    return {"quickstart_train": train_counts, "quickstart_generate": gen_counts}


def _state_by_name(torch, step) -> dict:
    """{name: [parameter, exp_avg, exp_avg_sq, step count]} of a train step's
    module and optimizer (this rank's local tensors)."""
    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    out = {}
    for name, p in step.module.named_parameters():
        st = step.optimizer.state[p]
        out[name] = [local(p), local(st["exp_avg"]), local(st["exp_avg_sq"]), local(st["step"])]
    return out


def phase_skip(torch, smi: str, phase4: dict) -> dict[str, dict[str, int]]:
    """Phase 11b, the anomaly skip at full width: phase 4's 2.7B config, corpus
    and 3 steps through Main with a `resilience` block, `skip_step` and
    `nan_grads@2` (the step whose count before the update is 2, the third,
    has NaN gradients). Phase 4 ran the same steps without the component,
    which is bitwise the `raise` policy (the same fused update, no flag).
    Held: steps 1-2 (loss, grad norm, lr) and step 3's loss, which reads the
    parameters after step 2, bitwise phase 4's; step 3 reports skipped_step 1
    and leaves the parameters, both moments and AdamW's step counts bitwise
    as after step 2; each step's peak memory within SKIP_PEAK_REL of phase
    4's run peak."""
    from modalities_tpu_torch.main import Main
    from modalities_tpu_torch.resilience import faults
    from modalities_tpu_torch.training.train_step import TrainStep

    seq, steps = 4096, 3
    corpus = np.random.default_rng(2027).integers(0, MODEL_2P7B["vocab_size"], size=seq + 1 + (4 * steps + 3) * seq)
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    call = TrainStep.__call__
    record: dict = {"metrics": [], "peak_gb": [], "held": None}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        block = {"component_key": "resilience", "variant_key": "default", "config": {"anomaly_policy": "skip_step"}}
        cfg = _train_config(tmp, "train", corpus, steps, {"resilience": block}, phase="phase 11b")
        faults.clear_faults()
        os.environ[faults.ENV_VAR] = "nan_grads@2"
        host: dict = {}

        def recording(self, batch):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            metrics = call(self, batch)
            torch.cuda.synchronize()
            record["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
            record["metrics"].append({k: float(v) for k, v in metrics.items()})
            state = _state_by_name(torch, self)
            if len(record["metrics"]) == 2:  # the state after step 2, on the host
                host.update({k: [t.detach().to("cpu", copy=True) for t in v] for k, v in state.items()})
            elif len(record["metrics"]) == 3:  # after the skipped step 3, tensor by tensor on the card
                record["held"] = all(torch.equal(t.detach(), h.to(t.device)) for k, v in state.items()
                                     for t, h in zip(v, host[k]))
            return metrics

        TrainStep.__call__ = recording
        try:
            main = Main(cfg, experiments_root_path=tmp / "experiments", device=TRAIN_DEVICE)
            main.components = main.build_components()
            _reset_counts()
            t0 = time.perf_counter()
            main.run(main.components)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _launch_counts()
        finally:
            TrainStep.__call__ = call
            faults.clear_faults()
            os.environ.pop(faults.ENV_VAR, None)
        del main
        gc.collect()
        torch.cuda.empty_cache()
    got = record["metrics"]
    want = [phase4["steps"][i] for i in (1, 2, 3)]
    if [m["skipped_step"] for m in got] != [0, 0, 1]:
        raise AssertionError(f"phase 11b: skipped_step {[m['skipped_step'] for m in got]}")
    if [(m["loss"], m["grad_norm"], m["lr"]) for m in got[:2]] != want[:2] or got[2]["loss"] != want[2][0]:
        raise AssertionError(f"phase 11b: steps {got} against phase 4's {want}")
    if record["held"] is not True or not math.isfinite(got[2]["loss"]) or math.isfinite(got[2]["grad_norm"]):
        raise AssertionError(f"phase 11b: after the skipped step, state bitwise {record['held']}; step 3 {got[2]}")
    per_step = {"flash_fwd": 64, "flash_dq": 64, "flash_dkv": 64, "rms_fwd": 130, "rms_bwd": 130}
    for key, n in per_step.items():
        if counts[key] != n * steps:
            raise AssertionError(f"phase 11b: {key} launched {counts[key]} times in {steps} steps")
    rel = [p / phase4["peak_gb"] - 1.0 for p in record["peak_gb"]]
    if max(rel) > SKIP_PEAK_REL:
        raise AssertionError(f"phase 11b: skip_step peaks {record['peak_gb']} GB against phase 4's "
                             f"{phase4['peak_gb']} GB")
    log(f"[phase 11b] the anomaly skip at the 2.7B ({smi}): 3 steps in {wall:.1f} s (build included); steps 1-2 "
        f"(loss, grad norm, lr) and step 3's loss bitwise phase 4's (the same steps without the component); step 3 "
        f"skipped_step 1 with grad norm {got[2]['grad_norm']}, parameters, both moments and AdamW step counts "
        f"bitwise as after step 2; lr {[m['lr'] for m in got]}; peak memory a step (max_memory_allocated, reset "
        f"before each step) {['%.2f' % p for p in record['peak_gb']]} GB against phase 4's run peak "
        f"{phase4['peak_gb']:.2f} GB: {['%+.4f' % r for r in rel]} (bound {SKIP_PEAK_REL})")
    return {"skip_2p7b": counts}


def _jsonl_steps(experiments: Path) -> dict[int, tuple[float, float, float]]:
    """step -> (loss, grad norm, lr) of the train rows a run's results subscriber wrote."""
    rows = [json.loads(line) for p in experiments.rglob("evaluation_results.jsonl") for line in
            p.read_text().splitlines()]
    return {r["num_train_steps_done"]: (r["losses"]["train loss last"], r["metrics"]["grad norm last"],
                                        r["metrics"]["lr mean"]) for r in rows if r["dataloader_tag"] == "train"}


def phase_resilience(torch, smi: str) -> dict[str, dict[str, int]]:
    """Phase 11c, preemption and rollback through the CLI at phase 6's widths
    (configs/config_long_context_32k.yaml at RESILIENCE_LAYERS of its 24
    layers, 4 steps):
    (a) `run` with `stop_consensus: on` at world 1 (the NCCL world-1 group)
        and `sigterm_at_step@1`: the vote rides step 2's ballot, the trainer
        reads it after step 3 and saves out of schedule there; exit 75;
    (b) `run` with `sigterm_at_step@2` (consensus off): the forced save at
        step 2, exit 75, error_rank_0.json with "resumable": true;
    (c) `warmstart` from (b)'s pointer: step 3 (loss, grad norm, lr) and the
        parameters after it bitwise (a)'s, which ran unbroken to step 3;
    (e) `run` with `oom@2`: step 2's dispatch fails as an allocation
        failure: memscope's dump (levers, the static report, the allocator's
        blocks) and exit 75 with the resumable OutOfMemory in the record;
    (a)-(c) and (e) run in this process through the CLI's `main`; (d) is
    `phase_resilient_run`."""
    from modalities_tpu_torch import __main__ as cli
    from modalities_tpu_torch.resilience import faults
    from modalities_tpu_torch.training.train_step import TrainStep

    rng = np.random.default_rng(2035)
    seq, vocab, layers, steps = LONG_MODEL["seq"], LONG_MODEL["vocab"], RESILIENCE_LAYERS, 4
    shape = {"base": LONG_CONFIG, "micro": 1, "acc": 1}
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    call = TrainStep.__call__
    counts: dict = {}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        corpus = rng.integers(0, vocab, size=seq + 1 + (steps + 2) * seq)
        relaxed = {"model_raw.config.n_layer": layers,
                   "settings.consistency_enforcement.enforce_last_step_logged": False,
                   "settings.consistency_enforcement.enforce_last_step_evaluated": False}

        def cli_run(name: str, argv: list, spec: str, resilience: dict, after=None) -> tuple[int, Path, dict]:
            """`main(argv)` of a config `name` in its own folder, `spec` armed; (exit code, folder, the
            parameters after step `after`)."""
            folder = tmp / name
            folder.mkdir()
            block = {"component_key": "resilience", "variant_key": "default", "config": resilience}
            cfg = _train_config(folder, "run", corpus, steps, {**relaxed, "resilience": block}, seq=seq,
                                phase="phase 11c", **shape)
            faults.clear_faults()
            os.environ.update({faults.ENV_VAR: spec, "MODALITIES_TPU_ERROR_LOG_DIR": str(folder / "errors")})
            seen: dict = {}

            def recording(self, batch):
                metrics = call(self, batch)
                seen["n"] = seen.get("n", 0) + 1
                if seen["n"] == after:
                    torch.cuda.synchronize()
                    seen["params"] = {k: v.detach().to("cpu", copy=True) for k, v in self.state_dict().items()}
                return metrics

            TrainStep.__call__ = recording
            _reset_counts()
            t0 = time.perf_counter()
            try:
                code = cli.main([*argv(cfg), "--device", TRAIN_DEVICE])
            except SystemExit as e:
                code = e.code
            finally:
                TrainStep.__call__ = call
                faults.clear_faults()
                os.environ.pop(faults.ENV_VAR, None)
            torch.cuda.synchronize()
            counts[f"{name}_32k"] = _launch_counts(LONG_KERNELS)
            log(f"[phase 11c] ({name}) exit {code} in {time.perf_counter() - t0:.1f} s; launches "
                f"{counts[f'{name}_32k']}")
            gc.collect()
            torch.cuda.empty_cache()
            return code, folder, seen.get("params")

        def run_argv(cfg):
            return ["run", "--config_file_path", str(cfg)]

        # (a) the ballot at world 1
        code, folder_a, params_a = cli_run("consensus", run_argv, "sigterm_at_step@1", {"stop_consensus": "on"},
                                           after=3)
        steps_a = _jsonl_steps(folder_a / "experiments")
        info_a = json.loads((folder_a / "checkpoints" / "last_checkpoint_info.json").read_text())
        if code != 75 or sorted(steps_a) != [1, 2, 3] or "-seen_steps_3-" not in info_a["checkpoint_folder_path"]:
            raise AssertionError(f"phase 11c (a): exit {code}, steps {sorted(steps_a)}, pointer {info_a}")
        # (b) the local preemption path, its forced save timed
        from modalities_tpu_torch.checkpointing.dcp.dcp_checkpoint_saving import DCPCheckpointSaving

        save_s: list = []
        with _timed(DCPCheckpointSaving, "_save_checkpoint", save_s):
            code, folder_b, _ = cli_run("preempt", run_argv, "sigterm_at_step@2", {})
        info_b = folder_b / "checkpoints" / "last_checkpoint_info.json"
        forced = Path(json.loads(info_b.read_text())["checkpoint_folder_path"])
        record = json.loads((folder_b / "errors" / "error_rank_0.json").read_text())
        files = [p for p in forced.rglob("*") if p.is_file()]
        if code != 75 or "-seen_steps_2-" not in forced.name or record["resumable"] is not True:
            raise AssertionError(f"phase 11c (b): exit {code}, folder {forced.name}, error record {record}")
        log(f"[phase 11c] (b) out-of-schedule save at step 2 ({smi}): {forced.name}, {len(files)} files, "
            f"{sum(p.stat().st_size for p in files)} bytes in {save_s} s (the save with its manifest and pointer); "
            f"error_rank_0.json: error {record['error']}, resumable {record['resumable']}")
        # (c) the warmstart from (b)'s forced save, held to (a)'s unbroken step 3
        warm = _warmstart_config(folder_b / "run.yaml", folder_b / "warmstart.yaml")
        code, _, params_c = cli_run(
            "resume", lambda cfg: ["warmstart", "--config_file_path", str(warm), "--last_checkpoint_info_file_path",
                                   str(info_b)], "", {}, after=1)
        steps_c = _jsonl_steps(folder_b / "experiments")
        if code != 0 or steps_c.get(3) != steps_a[3]:
            raise AssertionError(f"phase 11c (c): exit {code}; step 3 {steps_c.get(3)} against the unbroken "
                                 f"{steps_a[3]}")
        differ = sorted(set(params_a) ^ set(params_c)) or [k for k in params_a if not torch.equal(params_c[k],
                                                                                                 params_a[k])]
        if differ:
            raise AssertionError(f"phase 11c (c): the parameters after the resumed step 3 differ from the unbroken "
                                 f"run's: {differ[:8]} ({len(differ)} of {len(params_a)})")
        log(f"[phase 11c] (c) warmstart from the step-2 save: step 3 (loss, grad norm, lr) {steps_c[3]} and the "
            f"parameters after it bitwise the unbroken run's")
        # (e) an allocation failure at step 2's dispatch: memscope's dump, then the resumable OutOfMemory
        code, folder_e, _ = cli_run("oom", run_argv, "oom@2", {})
        dumps = list((folder_e / "experiments").rglob("oom_dump_rank_0_step_2.json"))
        record = json.loads((folder_e / "errors" / "error_rank_0.json").read_text())
        dump = json.loads(dumps[0].read_text()) if dumps else {}
        levers = [lever["lever"] for lever in dump.get("suggested_levers", [])]
        if (code != 75 or not dumps or "OutOfMemory" not in record["error"] or not record["resumable"]
                or not levers or not (dump.get("static_report") or {}).get("predicted_peak_bytes")):
            raise AssertionError(f"phase 11c (e): exit {code}, dumps {dumps}, error record {record}, levers {levers}")
        log(f"[phase 11c] (e) oom@2: exit {code}, {dumps[0].name} (levers {levers}; the static report's predicted "
            f"peak {dump['static_report']['predicted_peak_bytes'] / 1e9:.2f} GB; {dump['live_arrays']['count']} "
            f"allocator blocks, {dump['live_arrays']['total_bytes'] / 1e9:.2f} GB; {len(dump['timeline_tail'])} "
            f"timeline samples); error_rank_0.json: {record['error'][:160]}")
    if any(c[k] == 0 for c in counts.values() for k in ("flash_fwd", "rms_fwd", "ce_fwd")):
        raise AssertionError(f"phase 11c: a kernel of the 32k path was never launched: {counts}")
    return counts


def phase_resilient_run(torch, smi: str) -> dict[str, dict[str, int]]:
    """Phase 11c (d): `run --resilient` (a process of its own, its children
    too) at phase 11c's config with `anomaly_policy: rollback`,
    `skip_budget: 1`, saves every 2 steps and logs every 4, `nan_grads@1` and
    `loss_spike@2:nan` (steps 2 and 3 non-finite): the first child skips both
    and exits 75 at step 4 before saving; the supervisor restarts once from
    the step-2 folder, where step 3 is non-finite again (one anomaly, within
    the budget), and the run reaches step 4. Each child is a process of its
    own with its own counts."""
    from modalities_tpu_torch.resilience import faults

    rng = np.random.default_rng(2037)
    seq, vocab, layers, steps = LONG_MODEL["seq"], LONG_MODEL["vocab"], RESILIENCE_LAYERS, 4
    shape = {"base": LONG_CONFIG, "micro": 1, "acc": 1}
    relaxed = {"model_raw.config.n_layer": layers,
               "settings.consistency_enforcement.enforce_last_step_logged": False,
               "settings.consistency_enforcement.enforce_last_step_evaluated": False}
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    counts: dict = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        corpus = rng.integers(0, vocab, size=seq + 1 + (steps + 2) * seq)
        folder_d = tmp / "resilient"
        folder_d.mkdir()
        block = {"component_key": "resilience", "variant_key": "default",
                 "config": {"anomaly_policy": "rollback", "skip_budget": 1}}
        cfg = _train_config(folder_d, "run", corpus, steps, {
            **relaxed, "resilience": block, "settings.intervals.checkpointing_interval_in_steps": 2,
            "settings.intervals.training_log_interval_in_steps": 4}, seq=seq, phase="phase 11c", **shape)
        warm = _warmstart_config(cfg, folder_d / "warmstart.yaml")
        info_d = folder_d / "checkpoints" / "last_checkpoint_info.json"
        supervised = _subprocess(
            ["run", "--config_file_path", str(cfg), "--resilient", "--last_checkpoint_info_file_path", str(info_d),
             "--warmstart_config_file_path", str(warm), "--backoff_base_s", "0.5", "--max_restarts", "2",
             "--device", TRAIN_DEVICE],
            folder_d, "phase 11c (d) run --resilient",
            env={faults.ENV_VAR: "nan_grads@1,loss_spike@2:nan", "MODALITIES_TPU_ERROR_LOG_DIR": str(folder_d)})
        restarts = [line for line in supervised.stderr.splitlines() if "supervisor: child exited" in line]
        final = json.loads(info_d.read_text())["checkpoint_folder_path"] if info_d.is_file() else ""
        resumed = [line for line in supervised.stderr.splitlines() if "resuming from verified checkpoint" in line]
        if (supervised.returncode != 0 or len(restarts) != 1 or "restart 1/2 in 0.5s" not in restarts[0]
                or len(resumed) != 1 or "-seen_steps_2-" not in resumed[0] or "-seen_steps_4-" not in final):
            raise AssertionError(f"phase 11c (d): exit {supervised.returncode}, restarts {restarts}, resumed "
                                 f"{resumed}, final {final}: {supervised.stderr[-4000:]}")
        # the rolled-back child leaves by its exception before the trainer's launches line: the resumed one's
        counts["resilient_32k"] = _parse_launches(supervised.stdout, "phase 11c (d)")
        if any(counts["resilient_32k"][k] == 0 for k in LONG_KERNELS):
            raise AssertionError(f"phase 11c (d): a kernel of the 32k path was never launched: {counts}")
        log(f"[phase 11c] (d) run --resilient ({smi}): restarts 1 ({restarts[0].split('supervisor: ', 1)[1]}); "
            f"{resumed[0].split('supervisor: ', 1)[1]}; the run reached {final.rsplit('/', 1)[-1]}; launches of "
            f"the resumed child {counts['resilient_32k']}")
    log(f"[phase 11c] (d) {time.perf_counter() - t0:.1f} s")
    return counts


PROFILE_CONFIG = "configs/config_profile_gpt2.yaml"


def phase_profile(torch, smi: str) -> dict[str, dict[str, int]]:
    """Phase 12: `profile distributed` on the profiling config as it stands,
    in process through the CLI, from a temporary working directory (the
    config writes ./profiler_out), then its trace, memory lines and snapshot
    checked, and the static walk of the same config held to its launches."""
    import yaml

    from modalities_tpu_torch.__main__ import main as cli
    from modalities_tpu_torch.telemetry.perfscope import kernel_counts, perfscope_for_config

    config = Path(__file__).resolve().parent / PROFILE_CONFIG
    raw = yaml.safe_load(config.read_text())
    model = raw["model"]["config"]
    layers = model["n_layer"]
    batch = raw["steppable_component"]["config"]["batch_generator"]["config"]
    rows, heads = batch["micro_batch_size"] * model["sequence_length"], model["n_head_q"]
    shapes = {"rms": (rows, model["n_embd"]), "flash": (batch["micro_batch_size"], model["sequence_length"], heads,
                                                        model["n_head_kv"], model["n_embd"] // heads)}
    if shapes != {"rms": RMS_PROFILE, "flash": FLASH_PROFILE}:  # phase 1 holds the kernels at these shapes
        raise AssertionError(f"phase 12: the config's kernel shapes {shapes} are not phase 1's {RMS_PROFILE}, "
                             f"{FLASH_PROFILE}")
    # a step: n_layer flash calls of each kind; two norms a block and the head's, forward and backward
    per_step = {"flash_fwd": layers, "flash_dq": layers, "flash_dkv": layers, "rms_fwd": 2 * layers + 1,
                "rms_bwd": 2 * layers + 1}
    memory = next(p for p in raw["profiler"]["config"]["profilers"] if p["variant_key"] == "memory_profiler")
    steps = memory["config"]["max_steps"]
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        os.chdir(tmp)
        try:
            torch.cuda.reset_peak_memory_stats()  # the memory lines' peaks are this phase's
            _reset_counts()
            t = time.perf_counter()
            code = cli(["profile", "distributed", "--config_file_path", str(config)])
            wall = time.perf_counter() - t
            counts = _launch_counts()
        finally:
            os.chdir(cwd)
        want = {k: v * steps for k, v in per_step.items()}
        if code != 0 or counts != want:
            raise AssertionError(f"phase 12: profile distributed exit {code}, launches {counts}, {steps} steps of "
                                 f"{per_step} launch {want}")
        out = Path(tmp) / "profiler_out"
        traces = sorted(out.glob("kernel_trace_rank_0_steps_*.json"))
        if [p.name for p in traces] != ["kernel_trace_rank_0_steps_4-6.json"]:
            raise AssertionError(f"phase 12: one trace of steps 4-6 expected, found {sorted(out.iterdir())}")
        events = [e for e in json.loads(traces[0].read_text())["traceEvents"] if e.get("cat") == "kernel"]
        in_trace = {key: sum(mark in e["name"] for e in events) for key, mark in TRACE_NAMES.items()}
        if in_trace != {k: 3 * v for k, v in per_step.items()}:
            raise AssertionError(f"phase 12: the trace of steps 4-6 names the kernels {in_trace} times, 3 steps "
                                 f"launch {per_step} each")
        lines = [json.loads(line) for line in (out / "memory_stats.jsonl").read_text().splitlines()]
        if len(lines) != steps or not all(line.get("peak_bytes_in_use", 0) > 0 for line in lines):
            raise AssertionError(f"phase 12: memory_stats.jsonl holds {lines}")
        snapshot = out / "memory_snapshot.pickle"
        if not snapshot.is_file() or snapshot.stat().st_size == 0:
            raise AssertionError(f"phase 12: no allocator snapshot in {sorted(out.iterdir())}")
        snapshot_mb = snapshot.stat().st_size / 1e6
    device_ms = sum(e["dur"] for e in events) / 1e3 / 3
    by_kernel = {key: sum(e["dur"] for e in events if mark in e["name"]) / 1e3 / 3 for key, mark in TRACE_NAMES.items()}
    log(f"[phase 12] profile distributed {PROFILE_CONFIG} ({smi}): {steps} steps in {wall:.1f} s, launches {counts} "
        f"= {steps} x {per_step}; trace {traces[0].name}: {len(events)} kernels, {device_ms:.3f} device ms a step; "
        "each kernel's device ms a step: " + ", ".join(f"{k} {v:.3f}" for k, v in by_kernel.items()))
    log(f"[phase 12] memory_stats.jsonl: {steps} lines, peaks "
        f"{[round(line['peak_bytes_in_use'] / 1e9, 3) for line in lines]} GB; allocator snapshot {snapshot_mb:.1f} MB")
    t = time.perf_counter()
    static = perfscope_for_config(config)["executables"]["train_step"]  # no process group is held here
    walked = kernel_counts(static)
    if walked != per_step:
        raise AssertionError(f"phase 12: the static walk names the kernels {walked} times a step, a step launches "
                             f"{per_step}")
    log(f"[phase 12] the static walk (in process, fake CPU tensors, {time.perf_counter() - t:.1f} s) names {walked} a "
        "step; its buckets: " + ", ".join(f"{name} {b['est_time_s'] * 1e3:.3f} est ms" for name, b in static["buckets"].items()))
    return {"profile_gpt2": counts}


# ---------------------------------------------------------------- phases 1 and 13: the multimodal models
# The ViT at the JAX defaults (224 x 224 images in patches of 16 and the cls token: 197 positions; n_embd 768 over 8
# heads: head dim 96; 12 layers; 1000 classes), phase 13b's 64 images: its attention q/k/v [64, 197, 8, 96]
VIT_IMAGES = 64
VIT_FLASH = (VIT_IMAGES, 197, 197, 8, 8, 96)  # (B, Sq, Sk, Hq, Hkv, D), not causal
# configs/config_example_coca_tpu.yaml's attention at its microbatch of 4 (2 heads of 32): (Sq, Sk, causal) of the
# ViT (16 patches), the pooling (5 queries over 16), the text decoder (16 tokens and its cls), the multimodal
# decoder's self-attention and its cross-attention (16 over the 4 pooled vision tokens)
COCA_FLASH = [(16, 16, False), (5, 16, False), (17, 17, True), (16, 16, True), (16, 4, False)]
COCA_CONFIG = "configs/config_example_coca_tpu.yaml"
COCA_STEPS, COCA_MICRO, COCA_SEQ = 8, 4, 16  # phase 13a: 8 steps of one rank's 4 x 16 tokens
COCA_ATTENTION = 2 + 1 + 2 + 2 * 2  # attention calls in a CoCa forward: ViT, pooling, text, multimodal self + cross
COCA_LOSS_BAND = 0.05  # every train loss within this of ln 512 (the targets are uniform over the 512 tokens)
# the dummy dataset draws from numpy's global generator, which the JAX e2e test seeds with 0 before its run. Unseeded,
# at world 1 (4 sequences a step, an eighth of that test's batch) a loss left the band on 2 of 20 seeds in the port's
# exact fp32 on the CPU, once at the first logged loss (0.056 off, before training moves anything)
COCA_NUMPY_SEED = 0
# Phase 13b, the ViT at its defaults in bf16 through the kernels against the same module through the plain
# attention on the card: ||g_k - g_p|| / ||g_p|| per parameter tensor and the loss's relative difference. The
# attention's k biases are left out of the ratio: their exact gradient is 0 (a softmax row does not move when a
# constant is added to all its scores), so both arms give rounding noise (run 22.1: 15.6 apart, relative); their
# norms are logged beside the q biases'
VIT_BF16_TOL = {"grads": 5e-2, "loss": 1e-3}
ZERO_GRADIENT = "attention.k_attn.bias"
FLASH_KEYS = ("flash_fwd", "flash_dq", "flash_dkv")


def _flash_timings(torch, shape, causal: bool, dtype) -> dict[str, dict]:
    """fwd, dq and dkv at (B, Sq, Sk, Hq, Hkv, D): kernel, plain version and
    SDPA ms (its backward, dq, dk and dv in one call, beside dq and dkv) and
    the bound from static_walk.kernel_work (bf16 on the tensor cores, fp32
    on the CUDA cores)."""
    import torch.nn.functional as F

    from modalities_tpu_torch.ops import flash_attention as fa
    from modalities_tpu_torch.ops.static_walk import kernel_work

    b, sq, sk, hq, hkv, d = shape
    g = torch.Generator(device="cuda").manual_seed(sq * 1000 + sk)
    q, w = (torch.randn(b, hq, sq, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(b, hkv, sk, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    o, lse = fa.flash_fwd_out_lse(q, k, v, causal=causal)
    delta = (w.float() * o.float()).sum(-1, keepdim=True)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    y_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(y_lib, (ql, kl, vl), w, retain_graph=True), reps=10)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True),
                      reps=10)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    calls = {"fwd": (lambda: fa.flash_fwd_out_lse(q, k, v, causal=causal),
                     lambda: fa.reference_flash_fwd_out_lse(q, k, v, causal=causal), lib_fwd),
             "dq": (lambda: fa.flash_bwd_dq(q, k, v, w, lse, delta, causal=causal),
                    lambda: fa.reference_flash_bwd_dq(q, k, v, w, lse, delta, causal=causal), lib_bwd),
             "dkv": (lambda: fa.flash_bwd_dkv(q, k, v, w, lse, delta, causal=causal),
                     lambda: fa.reference_flash_bwd_dkv(q, k, v, w, lse, delta, causal=causal), lib_bwd)}
    out = {}
    label = f"q[{b},{hq},{sq},{d}] k/v[{b},{hkv},{sk},{d}] {'bf16' if dtype == torch.bfloat16 else 'f32'}"
    for name, (kernel, plain, lib) in calls.items():
        flops, nbytes = kernel_work(f"flash_{name}", b=b, hq=hq, hkv=hkv, sq=sq, sk=sk, d=d, el=q.element_size(),
                                    causal=causal)
        out[name] = {"shape": f"{label}{' causal' if causal else ''}",
                     "ms": time_ms(torch, kernel, reps=10), "plain_ms": time_ms(torch, plain, reps=3),
                     "library_ms": lib, "bound_ms": 1e3 * max(flops / peak, nbytes / PEAK_BYTES_S),
                     "bound_by": "operations" if flops / peak >= nbytes / PEAK_BYTES_S else "bytes"}
    return out


def phase_flash_multimodal(torch) -> tuple[dict[str, list[dict]], dict[str, float]]:
    """Phase 1 at the multimodal models' shapes: the flash kernels against
    their plain versions (_flash_case) at the ViT's (VIT_FLASH, head dim 96,
    not causal) and at CoCa's (COCA_FLASH: Sq != Sk, ragged 17, causal and
    not), f32 and bf16, then timed at the ViT's in bf16 (phase 13b's path)
    and at CoCa's in f32 (phase 13a's: the config trains in fp32)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    errs, seen, cases = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}, {}, []
    shapes = [(VIT_FLASH, False)] + [((4, sq, sk, 2, 2, 32), causal) for sq, sk, causal in COCA_FLASH]
    for (b, sq, sk, hq, hkv, d), causal in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q, w = (torch.randn(b, sq, hq, d, generator=g, device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype) for _ in range(2))
            _flash_case(torch, q, k, v, w, causal, f"(B,Sq,Sk,Hq,Hkv,D)=({b},{sq},{sk},{hq},{hkv},{d})", seen, errs)
            cases.append((sq, sk, d, causal))
            del q, k, v, w
    torch.cuda.empty_cache()
    log(f"[phase 1] flash attention at the multimodal shapes: {len(cases)} cases (the ViT's {VIT_FLASH}, CoCa's "
        f"(Sq, Sk, causal) {COCA_FLASH} at B 4, 2 heads of 32; f32 and bf16) agree with autograd of the plain "
        f"attention and with their plain versions given (lse, delta); max abs err out {errs['fwd']:g}, dq "
        f"{errs['dq']:g}, dk/dv {errs['dkv']:g}")
    _log_flash_held(seen, "phase 1")
    timings: dict[str, list[dict]] = {"fwd": [], "dq": [], "dkv": []}
    for shape, causal, dtype in [(VIT_FLASH, False, torch.bfloat16)] + [
            ((4, sq, sk, 2, 2, 32), causal, torch.float32) for sq, sk, causal in COCA_FLASH]:
        for name, t in _flash_timings(torch, shape, causal, dtype).items():
            timings[name].append(t)
            log(f"[phase 1] flash {name} {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                f"SDPA{' forward' if name == 'fwd' else ' backward'} {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.5f} ms ({t['bound_by']}), {t['bound_ms'] / t['ms']:.3f} of it")
    torch.cuda.empty_cache()
    return timings, errs


@contextlib.contextmanager
def plain_attention():
    """The multimodal models' attention (nn/attention.py) takes autograd of
    the plain `reference_attention` on the card while the context lasts: the
    plain path the kernels are held to in phase 13b, for comparisons only
    (the port itself has no such switch)."""
    from modalities_tpu_torch.nn import attention
    from modalities_tpu_torch.ops.flash_attention import reference_attention

    saved, attention.flash_attention = attention.flash_attention, reference_attention
    try:
        yield
    finally:
        attention.flash_attention = saved


def phase_coca_run(torch, smi: str) -> dict[str, dict[str, int]]:
    """Phase 13a: `run` over configs/config_example_coca_tpu.yaml with its
    mesh cut to world 1 (its token target with it: 8 steps of one rank's 4 x
    16 tokens) and its paths pointed at folders of this phase, a process of
    its own: it reaches step 8 with every logged train loss within 0.05 of
    ln 512 (the JAX e2e test's oracle; numpy's global generator seeded with
    0 first, as that test seeds it: COCA_NUMPY_SEED), saves its step-8
    checkpoint, runs its eval, and launched each flash kernel COCA_ATTENTION
    times a training forward and backward (fp32: the config trains in
    float32)."""
    import yaml

    repo = Path(__file__).resolve().parent
    scratch = repo / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        cfg = yaml.safe_load((repo / COCA_CONFIG).read_text())
        changes = {"settings.paths.checkpoint_saving_path": str(tmp / "checkpoints"),
                   "settings.paths.experiments_root_path": str(tmp / "experiments"),
                   "device_mesh.config.data_parallel_shard_degree": 1, "device_mesh.config.world_size": 1,
                   "settings.training_target.num_target_tokens": COCA_STEPS * COCA_MICRO * COCA_SEQ}
        for dotted, value in changes.items():
            node = cfg
            *parents, leaf = dotted.split(".")
            for key in parents:
                node = node[key]
            node[leaf] = value
            log(f"[phase 13a] {Path(COCA_CONFIG).name}: {dotted} = {value}")
        (tmp / "coca.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
        trained = _subprocess(["run", "--config_file_path", str(tmp / "coca.yaml"), "--device", TRAIN_DEVICE], tmp,
                              "phase 13a run", numpy_seed=COCA_NUMPY_SEED)
        if trained.returncode != 0 or f"[train] step {COCA_STEPS}:" not in trained.stdout:
            raise AssertionError(f"phase 13a: run failed: {trained.stdout[-2000:]} {trained.stderr[-3000:]}")
        lines = [line for line in trained.stdout.splitlines() if line.startswith("[train] step") and ": loss " in line]
        losses = [float(re.search(r"loss (\S+)", line).group(1)) for line in lines]
        if not losses or not all(abs(x - math.log(512)) < COCA_LOSS_BAND for x in losses):
            raise AssertionError(f"phase 13a: train losses {losses} not all within {COCA_LOSS_BAND} of ln 512")
        info = json.loads((tmp / "checkpoints" / "last_checkpoint_info.json").read_text())
        folder = Path(info["checkpoint_folder_path"])
        if f"-seen_steps_{COCA_STEPS}-" not in folder.name or not folder.is_dir():
            raise AssertionError(f"phase 13a: no step-{COCA_STEPS} checkpoint folder: {info}")
        rows = [json.loads(line) for path in (tmp / "experiments").rglob("evaluation_results.jsonl")
                for line in path.read_text().splitlines()]
        val = [r["losses"]["loss avg"] for r in rows if r["dataloader_tag"] == "val"]
        if not val or not all(math.isfinite(x) for x in val):
            raise AssertionError(f"phase 13a: the eval wrote {val}")
        counts = {k: v for k, v in _parse_launches(trained.stdout, "phase 13a run").items() if k in FLASH_KEYS}
        train_calls = COCA_ATTENTION * COCA_STEPS
        eval_calls = COCA_ATTENTION * (cfg["settings"]["coca_example_settings"]["val_num_samples"] // COCA_MICRO)
        if (counts["flash_dq"] != train_calls or counts["flash_dkv"] != train_calls
                or counts["flash_fwd"] <= train_calls or (counts["flash_fwd"] - train_calls) % eval_calls):
            raise AssertionError(f"phase 13a: launches {counts}: want dq = dk/dv = {train_calls} ({COCA_ATTENTION} a "
                                 f"step) and forwards {train_calls} + a multiple of {eval_calls} (an eval)")
    log(f"[phase 13a] config_example_coca_tpu.yaml on one rank ({smi}): {lines[-1]}; train losses "
        f"{[round(x, 5) for x in losses]} (ln 512 = {math.log(512):.5f}, band {COCA_LOSS_BAND}); val losses "
        f"{[round(x, 5) for x in val]}; {folder.name}; launches {counts}")
    return {"train_coca": counts}


def phase_vit(torch, smi: str) -> dict[str, dict[str, int]]:
    """Phase 13b: the ViT at the JAX defaults (VIT_FLASH's widths, head dim
    96) in bf16 (its parameters cast as FSDP2's bf16 policy casts them), a
    cross entropy over its 1000 classes on VIT_IMAGES seeded images, forward
    and backward, through the flash kernels and through the plain attention
    (plain_attention) from the same parameters: the loss and every gradient
    agree within VIT_BF16_TOL, the kernels arm launched each flash kernel once
    a layer and the plain arm none."""
    import torch.nn.functional as F

    from modalities_tpu_torch.models.vision_transformer.vision_transformer_model import VisionTransformer

    model = VisionTransformer(sample_key="images", prediction_key="logits")  # the JAX defaults
    params = {k: v.to(torch.bfloat16) for k, v in
              model.init_params(torch.Generator(device="cuda").manual_seed(0)).items()}
    rng = np.random.default_rng(13)
    images = torch.as_tensor(rng.standard_normal((VIT_IMAGES, *model.img_size, 3)), dtype=torch.float32,
                             device="cuda")
    labels = torch.as_tensor(rng.integers(0, 1000, VIT_IMAGES), device="cuda")
    runs = {}
    for arm in ("kernels", "plain"):
        with plain_attention() if arm == "plain" else contextlib.nullcontext():
            module = model.build_train_module({k: v.clone() for k, v in params.items()})
            times = []
            for _ in range(2):  # the second call timed alone: the first pays the allocator's and cuBLAS's start
                for p in module.parameters():
                    p.grad = None
                _reset_counts()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                loss = F.cross_entropy(module({"images": images})["logits"].float(), labels)
                loss.backward()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            runs[arm] = (float(loss.detach()), {n: p.grad.float() for n, p in module.named_parameters()},
                         _launch_counts(FLASH_KEYS), times[-1])
            del module, loss
    (l_k, g_k, n_k, ms_k), (l_p, g_p, n_p, ms_p) = runs["kernels"], runs["plain"]
    layers = model.spec["n_layer"]
    if n_k != {k: layers for k in FLASH_KEYS} or any(n_p.values()):
        raise AssertionError(f"phase 13b: launches with the kernels {n_k} (want {layers} each), plain {n_p}")
    held = [n for n in g_p if not n.endswith(ZERO_GRADIENT)]
    seen = {"grads": max(_rel_norm(torch, g_k[n], g_p[n]) for n in held), "loss": abs(l_k / l_p - 1)}
    worst = max(held, key=lambda n: _rel_norm(torch, g_k[n], g_p[n]))
    k_bias = max(float(g[n].norm() / g[n.replace("k_attn", "q_attn")].norm()) for g in (g_k, g_p) for n in g_p
                 if n.endswith(ZERO_GRADIENT))
    log(f"[phase 13b] the ViT at its defaults (224^2, patch 16, 768 / 8 heads: D 96, 12 layers, 1000 classes; "
        f"{model.num_parameters() / 1e6:.1f} M parameters, bf16) on {VIT_IMAGES} images ({smi}): loss kernels "
        f"{l_k:.6f} vs plain {l_p:.6f} (ln 1000 = {math.log(1000):.4f}), rel diff {seen['loss']:.3g}; worst "
        f"per-tensor ||g_k - g_p|| / ||g_p|| {seen['grads']:.3g} ({worst}; {len(held)} tensors; the k biases, "
        f"exactly 0 in exact arithmetic, at most {k_bias:.3g} of their q bias's gradient norm in either arm); "
        f"bounds {VIT_BF16_TOL}; a forward and backward {ms_k:.2f} ms through the kernels, {ms_p:.2f} ms plain "
        f"(the second call of each, information only); launches {n_k}")
    for key, bound in VIT_BF16_TOL.items():
        if not seen[key] <= bound:
            raise AssertionError(f"phase 13b: {key} differ by {seen[key]:g}, bound {bound:g}")
    return {"train_vit": n_k}


def training_phases(torch):
    """Phases 4-10 on the process group; returns each path's launch counts."""
    # phase 4: the training path. Counts start from 0 inside phase_train.
    smi_now = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    train_counts, train_steps, train_peak_gb = phase_train(torch, smi_now)
    mark("phase 4")
    if any(v == 0 for v in train_counts.values()):
        raise AssertionError(f"a kernel of the training path was never launched: {train_counts}")
    log(f"[phase 4] launches in the 3-step run: {train_counts}")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 5: the 32k long-context training path. Counts start from 0 inside phase_train_long.
    long_counts = phase_train_long(torch, smi_now)
    mark("phase 5")
    if any(v == 0 for v in long_counts.values()):
        raise AssertionError(f"a kernel of the 32k training path was never launched: {long_counts}")
    log(f"[phase 5] launches in the 3-step run: {long_counts}")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 6: checkpoint, warmstart and serving from a checkpoint. Counts start from 0 before each path inside.
    ckpt_counts = phase_checkpoint(torch, smi_now)
    mark("phase 6")
    log(f"[phase 6] launches: warmstart (2 steps) {ckpt_counts['train_32k_resume']}; serving from the checkpoint "
        f"{ckpt_counts['serve_ckpt']}")

    # phase 7: the ring's hops at the 32k widths (counts from 0 just before the ring), then the launcher
    ring_counts = phase_ring(torch, smi_now)
    mark("phase 7 ring")
    gc.collect()
    torch.cuda.empty_cache()
    launcher_counts = phase_launcher(torch, smi_now)
    mark("phase 7 launcher")
    if any(launcher_counts[k] == 0 for k in LONG_KERNELS):
        raise AssertionError(f"a kernel of the 32k path under the launcher was never launched: {launcher_counts}")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 8: tensor parallelism and the 7B chain. The 7B config on the card (counts from 0 inside; it saves the
    # pretrain folder), tp 8 rank by rank, then the 32k warmstart from that folder (counts from 0 inside)
    scratch = Path(__file__).resolve().parent / "build"  # gitignored, inside the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        seven_b_counts, pretrain = phase_train_7b(torch, smi_now, Path(tmp))
        mark("phase 8a")
        if any(v == 0 for v in seven_b_counts.values()):
            raise AssertionError(f"a kernel of the 7B training path was never launched: {seven_b_counts}")
        gc.collect()
        torch.cuda.empty_cache()
        tp8 = [phase_tp_block(torch, smi_now), *(phase_tp_fused_ce(torch, smi_now, shape) for shape in TP_CE_SHAPES)]
        tp8_counts = {k: sum(c.get(k, 0) for c in tp8) for c in tp8 for k in c}
        mark("phases 8b, 8c")
        gc.collect()
        torch.cuda.empty_cache()
        warm_counts = phase_warmstart_7b(torch, smi_now, Path(tmp), pretrain)
        mark("phase 8d")
        if any(v == 0 for v in warm_counts.values()):
            raise AssertionError(f"a kernel of the 7B 32k warmstart path was never launched: {warm_counts}")
        gc.collect()
        torch.cuda.empty_cache()
        # phase 9: pipeline parallelism at the 7B's width, each schedule's launches counted from 0 inside
        pp_counts = phase_pipeline_7b(torch, smi_now, Path(tmp))
        mark("phase 9")
        if any(v == 0 for counts in pp_counts.values() for v in counts.values()):
            raise AssertionError(f"a kernel of the pipelined 7B path was never launched: {pp_counts}")
    gc.collect()
    torch.cuda.empty_cache()
    # phase 10: ZeRO-1, dcn and the row-parallel bias (each path counted from 0 inside)
    knob_counts = phase_parallel_knobs(torch, smi_now, train_steps)
    return (train_counts, long_counts, ckpt_counts, ring_counts, launcher_counts, seven_b_counts, tp8_counts,
            warm_counts, pp_counts, knob_counts, {"steps": train_steps, "peak_gb": train_peak_gb})


def main() -> int:
    # what `python -m modalities_tpu_torch run` sets, before the first allocation
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    try:
        from modalities_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the modalities_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 2

    # phase 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[phase 0] {smi}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 card, got capability {cap}")
    log(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    log(f"[phase 0] kernels {'built in %.1f s' % built if built is not None else 'loaded'} "
        f"({time.perf_counter() - t:.1f} s) -> {_build.library_path()}")
    if _build.unit_seconds:  # each nvcc process's wall time from the build's start, all started together
        log("[phase 0] nvcc seconds by unit: " + ", ".join(f"{k} {v:.1f}" for k, v in _build.unit_seconds.items()))
    mark("phase 0 build")
    for kernel in REDESIGNED:  # registers and spills of the redesigned kernels, from ptxas -v
        for line in _build.ptxas_usage(kernel):
            log(f"[phase 0] {line}")
    from modalities_tpu_torch.ops import fused_ce as fce

    for e in fce.BF16_WIDTHS:  # the dh / dW clusters the card holds at once (one CTA an SM)
        (dh_ctas, dh_resident), (dw_ctas, dw_resident) = fce.clusters("dh", e), fce.clusters("dw", e)
        log(f"[phase 0] fused CE bf16 E={e}: dh clusters of {dh_ctas} CTAs, {dh_resident} resident at once; dW "
            f"clusters of {dw_ctas}, {dw_resident} resident (cudaOccupancyMaxActiveClusters)")

    # phase 1
    warm_up(torch)
    kernels = phase_kernels(torch)
    mark("phase 1 RMSNorm, dequant-matmul")
    kernels.update(phase_train_kernels(torch))
    mark("phase 1 training kernels")
    kernels["rmsnorm"]["timings"] += [kernels.pop("rmsnorm_fwd_train"), kernels.pop("rmsnorm_fwd_long")]
    for name, t in phase_flash_long(torch).items():  # the 32k shape, after the 2.7B one
        kernels[name]["timings"].append(t)
    multimodal, multimodal_errs = phase_flash_multimodal(torch)  # the ViT's and CoCa's shapes (phase 13)
    for name, ts in multimodal.items():
        kernels[f"flash_{name}"]["timings"] += ts
        kernels[f"flash_{name}"]["max_abs_err"] = max(kernels[f"flash_{name}"]["max_abs_err"], multimodal_errs[name])
    flash_by_head(torch, FLASH_7B, seed=6)  # the 7B's shape on one card (phase 8a)
    torch.cuda.empty_cache()
    mark("phase 1 flash at 32k and 7B")
    kernels.update(phase_fused_ce(torch))
    mark("phase 1 fused CE")
    phase_small_model_reference(torch)
    phase_small_model_training(torch)
    phase_small_model_training_bf16(torch)
    mark("phase 1 small models")

    # phases 2-3: the main path. Counts start from 0 here; launches above were comparisons.
    from modalities_tpu_torch.ops.quant_matmul import quant_matmul
    from modalities_tpu_torch.ops.rmsnorm import rms_norm

    # the serving phases' engines write into one registry of their own, dropped with them after phase 3f
    with own_registry():
        model = build_model({"n_layer": SERVE_LAYERS})
        t = time.perf_counter()
        params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        log(f"[phase 2] the 2.7B at {SERVE_LAYERS} of its 32 layers: params "
            f"({sum(p.numel() for p in params.values()) / 1e9:.3f} B, fp32) initialized on the card in "
            f"{time.perf_counter() - t:.1f} s")
        reqs = make_requests()
        log(f"[phase 2] 9 requests, prompt lengths {[len(r['prompt']) for r in reqs]}, {NEW_TOKENS} new tokens each")
        rms_norm.launches = 0
        quant_matmul.launches = 0
        runs = {}
        for quant, phase in (("none", "phase 2"), ("int8", "phase 3"), ("fp8", "phase 3")):
            r = serve_phase(torch, model, params, quant, reqs)
            runs[quant] = r
            fwd = r["forward_calls"]
            if r["rms_launches"] != PER_FORWARD["rms"] * fwd:
                raise AssertionError(f"{quant}: rms_norm launched {r['rms_launches']} times, expected "
                                     f"{PER_FORWARD['rms']} x {fwd}")
            want_qmm = 0 if quant == "none" else PER_FORWARD["qmm"] * fwd
            if r["qmm_launches"] != want_qmm:
                raise AssertionError(f"{quant}: quant_matmul launched {r['qmm_launches']} times, expected {want_qmm}")
            report_serve(f"{phase} {quant if quant != 'none' else 'bf16'}", r)
            report_profile(f"{phase} {quant if quant != 'none' else 'bf16'}", r)
            log(f"[{phase}] launches: rms_norm {r['rms_launches']} = {PER_FORWARD['rms']} x {fwd} forwards, "
                f"quant_matmul {r['qmm_launches']}")
            if quant != "none":
                log(f"[{phase}] {quant}: greedy tokens agreeing with bf16 position by position: "
                    f"{greedy_agreement(reqs, runs['none']['tokens'], r['tokens']):.3f} (information only)")
        log("[phase 2] batch invariance: request 0 served alone matches its batched tokens bitwise")
        mark("phases 2-3")
        rms_total, qmm_total = rms_norm.launches, quant_matmul.launches
        if rms_total == 0 or qmm_total == 0:
            raise AssertionError("a kernel of the serving path was never launched")

        # phase 3b: the paged engine on the same weights (each run's counts from 0 inside)
        ring = {**{q: runs[q]["tokens"] for q in ("none", "int8")}, **{f"{q}_profile": runs[q]["profile"] for q in ("none", "int8")}}
        replays = {}
        paged_counts = phase_serve_paged(torch, model, params, reqs, ring, smi, replays)
        mark("phase 3b")
        # phase 3c: the HTTP front end on the same weights (its counts from 0 inside)
        http_counts, replays["int8"] = phase_serve_http(torch, model, params, reqs, smi)
        paged_counts.update(http_counts)
        mark("phase 3c")
        # phases 3d and 3e: the fleet and disaggregation on the same weights (each path's counts from 0 inside)
        paged_counts.update(phase_serve_fleet(torch, model, params, reqs, replays["int8"], smi))
        mark("phase 3d")
        paged_counts.update(phase_serve_disagg(torch, model, params, reqs, replays, smi))
        mark("phase 3e")
        # phase 3f: serving under telemetry and SLOs on the same weights (its counts from 0 inside)
        paged_counts.update(phase_serve_observed(torch, model, params, reqs, runs["int8"]["tokens"], replays["int8"],
                                                 smi))
        mark("phase 3f")
        # phase 3g: text generation on the same weights (its counts from 0 inside)
        gen_counts = phase_generate(torch, model, params, reqs, smi)
        mark("phase 3g")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # phases 4-7 train on the world-1 NCCL group `run` builds without a launcher, held here across the runs
    # (each Main joins it; the profiled steps and phase 6's saves after a run use it too)
    from modalities_tpu_torch.running_env.env import process_group

    with process_group(torch.device("cuda")):
        paths = training_phases(torch)
    (train_counts, long_counts, ckpt_counts, ring_counts, launcher_counts, seven_b_counts, tp8_counts, warm_counts,
     pp_counts, knob_counts, phase4) = paths

    # phase 11: training resilience and the quick start, one path after another, each alone on the card and its
    # counts from 0 inside (Main, the CLI and the subprocesses build their own world-1 groups)
    gc.collect()
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    resilience_counts = phase_quick_start(torch, smi)
    mark("phase 11a")
    resilience_counts.update(phase_skip(torch, smi, phase4))
    mark("phase 11b")
    resilience_counts.update(phase_resilience(torch, smi))
    mark("phase 11c (a)-(c)")
    resilience_counts.update(phase_resilient_run(torch, smi))
    mark("phase 11c (d)")
    log(f"[phase 11] phases 11a-c in {time.perf_counter() - t11:.1f} s")

    # phase 12: the profiling harness, alone on the card, its counts from 0 inside (it builds its own world-1 group)
    gc.collect()
    torch.cuda.empty_cache()
    resilience_counts.update(phase_profile(torch, smi))
    mark("phase 12")

    # phase 13: the multimodal models, each path alone on the card, its counts from 0 inside (13a a process of its
    # own)
    gc.collect()
    torch.cuda.empty_cache()
    resilience_counts.update(phase_coca_run(torch, smi))
    mark("phase 13a")
    resilience_counts.update(phase_vit(torch, smi))
    mark("phase 13b")

    # the kernels line. `launches` sums the paths; `launches_by_path` gives each path's own run (each counted from 0)
    def by_path(key):
        paths = {"train_2p7b": train_counts, "train_32k": long_counts,
                 "train_32k_resume": ckpt_counts["train_32k_resume"], "ring_cp4": ring_counts,
                 "train_32k_torchrun": launcher_counts, "train_7b": seven_b_counts, "tp8": tp8_counts,
                 "train_7b_32k_warmstart": warm_counts,
                 **{f"pp2_{name}": counts for name, counts in pp_counts.items()}, **knob_counts, **resilience_counts}
        return {path: counts[key] for path, counts in paths.items() if key in counts}


    def entry(name, source, replaces, paths, k, pick=lambda ts: ts[0]):
        t = pick(kernels[k]["timings"])
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(paths.values()), "launches_by_path": paths,
               "max_abs_err": kernels[k]["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t.get("bound_by", "bytes"), "library_ms": t["library_ms"],
               "shape": t["shape"]}
        if k.startswith(("fused_ce", "flash")):  # the first shape above; every shape (the 7B's, the ViT's...) here
            out["shapes"] = kernels[k]["timings"]
        return out

    flash_src = "modalities_tpu_torch/csrc/flash_attention.cu"
    flash_tpu = "modalities_tpu/ops/pallas/flash_attention.py"
    ce_src = "modalities_tpu_torch/csrc/fused_ce.cu"
    ce_tpu = "modalities_tpu/ops/pallas/fused_ce.py"
    log(f"[timing] the whole run: {time.perf_counter() - _START:.1f} s")
    print(json.dumps({"kernels": [
        entry("fused_rmsnorm_fwd", "modalities_tpu_torch/csrc/fused_rmsnorm.cu",
              "modalities_tpu/ops/pallas/fused_rmsnorm.py:34",
              {"serve": rms_total, **{k: c["rms_fwd"] for k, c in paged_counts.items()},
               "generate_2p7b": gen_counts["generate_2p7b"]["rms_fwd"], **by_path("rms_fwd"),
               "serve_ckpt": ckpt_counts["serve_ckpt"]["rms_fwd"]}, "rmsnorm"),
        entry("fused_rmsnorm_bwd", "modalities_tpu_torch/csrc/fused_rmsnorm.cu",
              "modalities_tpu/ops/pallas/fused_rmsnorm.py:43", by_path("rms_bwd"), "rmsnorm_bwd"),
        entry("flash_attention_fwd", flash_src, f"{flash_tpu}:43", by_path("flash_fwd"), "flash_fwd"),
        entry("flash_attention_bwd_dq", flash_src, f"{flash_tpu}:88", by_path("flash_dq"), "flash_dq"),
        entry("flash_attention_bwd_dkv", flash_src, f"{flash_tpu}:130", by_path("flash_dkv"), "flash_dkv"),
        entry("fused_ce_fwd", ce_src, f"{ce_tpu}:59", by_path("ce_fwd"), "fused_ce_fwd"),
        entry("fused_ce_bwd_dh", ce_src, f"{ce_tpu}:141", by_path("ce_dh"), "fused_ce_dh"),
        entry("fused_ce_bwd_dw", ce_src, f"{ce_tpu}:158", by_path("ce_dw"), "fused_ce_dw"),
        entry("quant_matmul", "modalities_tpu_torch/csrc/quant_matmul.cu",
              "modalities_tpu/ops/pallas/quant_matmul.py:31",
              {"serve": qmm_total, **{k: c["quant_matmul"] for k, c in paged_counts.items()},
               "serve_ckpt": ckpt_counts["serve_ckpt"]["quant_matmul"]}, "quant_matmul",
              lambda ts: next(t for t in ts if t["m"] == 8 and (t["k"], t["n"]) == (2560, 7680) and t["mode"] == "int8")),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
