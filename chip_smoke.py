"""Smoke run of the PyTorch/CUDA port on one card: build, kernels, serve
(greedy and sampled), quantized serving, fleet-serve (bf16, int8, MoE),
SLO-monitored serving and training, train, fp8-train, LoRA, NanoGPT train and
eval, remat, MoE serve and train, context-parallel train, sharded training
(FSDP, tensor and expert parallelism on one rank), ViT-B/16 and
ResNet-50 train and eval, a plain-PyTorch Llama through the torch frontend,
training with frozen int8/NF4 linears, fp8 inference from a meta-built
model, the compiler extensions, resilient training (guard, checkpoints,
faults, loader), agree.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

1. build     — compile thunder_tpu_torch/csrc into the kernel library (nvcc,
               one process per source, all started together).
2. kernels   — each hand-written kernel against its plain PyTorch version at
               the shapes its path gives it, in bf16 and f32, then timed
               beside its bound, its plain version and, where one exists, the
               one PyTorch call that computes the same function. ``ms`` is
               device time: the launches captured in one CUDA graph and
               replayed between two CUDA events, inputs rotated through more
               than the 50 MB L2 so every launch reads device memory.
               ``eager_ms`` is the same launches issued one by one from
               Python, as the op-by-op paths issue them. The flash-RoPE
               forward and backward run at llama-350m's shape (B=4, H=16,
               T=2048, D=64) and llama-1b's GQA shape (B=1, H=16, Hkv=4,
               T=2048, D=128); the RoPE-free flash pair (sdpa's claim) at
               NanoGPT-124M's (B=8, H=12, T=1024, D=64, causal) and
               llama-1b's GQA heads, causal and full, beside SDPA and its
               autograd backward. In bf16 both forwards run the wgmma/TMA
               core of csrc/flash_fwd_sm90.cu (with RoPE after its
               prologue), in f32 the kernel of csrc/flash_rope_fwd.cu; both
               backwards run the one-pass wgmma kernels of
               csrc/flash_bwd_sm90.cu, in f32 the two-pass kernels of
               csrc/flash_rope_bwd.cu (the timings name the blocks and the
               scratch the wrappers allocate). dq, dk, dv and o are held to
               KERNEL_TOL and to FLASH_GRAD_TOL on three measures (max /
               max |ref|, l2 / l2 ref, the worst row's l2 / l2 ref), lse
               to KERNEL_TOL and FLASH_LSE_TOL (max |err|). The
               fused cross-entropy runs on (8192,
               50304) logits in bf16 and f32 and (8192, 32000) in bf16,
               every 97th row at ignore_index, beside F.cross_entropy. Paged
               attention (split kernel and combine) runs at Llama-3-1B's
               decode heads (B=8, H=32, Hkv=8, D=64, page 16, 128 pages a
               table) on a ragged set, a uniform 1,024-token set and one
               2,048-token sequence beside seven of length 1, in bf16, fp16
               and f32. Paged chunk attention (a split kernel over the
               keys on paged_chunk_plan's chunk or verify route, then the
               combine) runs at the fleet path's chunk shape (B=1, T=256
               from positions 0, 1024, 1792) and verify shape (B=8, T=3,
               ragged, one query past the table; and with rows that see no
               key, which must give zeros), Llama-3-1B heads (H=32, Hkv=8,
               D=64), page 16, in bf16, fp16 and f32; timed with the plan's
               route and splits and each kernel's device ms. The
               weight-only int8 and NF4 linears run at Llama-3-1B's decode
               linears (qkv 3072x2048, attn proj 2048x2048, fc_1/fc_2
               8192x2048, MLP proj 2048x8192, lm_head 128256x2048), int8 at
               M=8 (and the prefill buckets M=512 at fc_1, M=256 at qkv and
               MLP proj), NF4 at M=4 (and M=512 at fc_1), each with
               weight_only_plan's route, K splits and blocks; beside a bf16
               matmul against weights dequantized beforehand; in f32 (the
               split route; NF4 at M <= 16 the FMA kernel) at every case,
               timed at quant_train's shapes (M=512) and fc_1's decode
               (int8 M=8, NF4 M=4) beside the bf16 split operations' bound
               and the f32-FMA bound. rms_norm
               runs at Llama-3-1B's width (D=2048) at the serve wave's
               decode batches (1, 4, 8 rows) and prefill buckets (128, 512,
               1,024 rows) in bf16 and at 512 rows in f32, each with
               rms_norm_plan's launch, beside F.rms_norm and an empty
               kernel's launch (the floor). The AdamW kernel (adamw_update,
               csrc/adamw.cu; thunder_tpu's update is fused by XLA, so it
               replaces no Pallas kernel) is held against the _foreach chain
               (adamw_plain) over two updates at llama-350m's parameter
               shapes (p f32 or bf16, g f32 or bf16: ADAMW_TOL), then timed
               at moe_train's MoEGPT and train's llama-350m shapes beside
               the chain and torch._fused_adamw_; under the skip flag of a
               guarded step (0: p, m and v bit-equal; 1: the unflagged
               launch's bits) at llama-350m's shapes, and timed unflagged,
               flag 1 and flag 0 in turns at both shapes.
3. serve     — ServingEngine over Llama-3-1B at full width and depth in bf16
               (random weights from --seed): 16 greedy requests, prompts of
               128-1024 tokens, 64 new tokens each. Launch counters are zeroed
               just before and read just after; both kernels must have run.
4. profile   — torch.profiler over a short decode-heavy wave: device busy
               share, the kernels that take the time, and the paged
               attention kernels' device ms a decode step. Every profile
               phase profiles twice (profile_twice) and fails when the two
               disagree by more than PROFILE_RTOL at equal launch counts;
               each profile's device times are divided by its clock check
               (a spin timed by CUDA events and by the profiler).
5. agreement — 4 of the requests in f32 (TF32 off) through the engine and
               through the dense solo GPTInference: the streams must match,
               or differ only after a step where the solo top-2 logit gap is
               below AGREE_GAP.
   quant_serve — the serve phase's 16 requests through
               ServingEngine(quantize="int8") in bf16, beside the serve
               wave: int8_linear must launch 81 times a decode step plus 81
               (or 1, lm_head only, above 512 rows) a prefill, 0 compiles.
   quant_agreement — f32, TF32 off, int8-exact weights (integer codes
               times 2^-9): 4 greedy int8 streams must equal the
               unquantized engine's token for token; 4 sampled ones are held
               to its sampled streams under the sampled-agreement rule.
   nf4_inference (run before serve) — GPTInference over Llama-3-1B
               bf16 after QuantizeNF4Transform, B=4, 512-token prompts, 64
               new tokens; nf4_linear must launch 81 times a decode step
               (+1: prefill's lm_head); one decode call split into host
               enqueue and device wait. nf4_agreement: f32, 128-token
               prompts, against a GPT holding the dequantized f32 weights,
               under AGREE_GAP.
6. fleet     — the fleet engine over Llama-3-1B at full width and depth in
               bf16: ServingEngine(prefix_sharing=True, chunk_tokens=256,
               draft_gpt=gpt, spec_k=2), 32 requests drawn as
               benchmark_serving.py's mixed workload (half share a
               1024-token system prompt, one in eight are long batch-lane
               prompts, the rest 128-512 tokens; 32 new tokens each). The
               wave is replayed once to compile and warm the prefix cache,
               then the counters are zeroed and the wave submitted at once;
               paged_chunk_attention must launch n_layer x (chunk + verify
               programs) times (the self-draft's chunk programs too), with 0
               compiles. The same wave through the plain engine in the same
               call is printed beside it. fleet_profile: torch.profiler over
               the first 8 requests of the wave on the warm engine.
7. fleet_agreement — f32, TF32 off: Llama-3-1B with a 2-layer draft from
               another seed, prefix sharing, chunks and a 48-page pool that
               forces a preemption; 6 streams against solo GPTInference
               under the AGREE_GAP rule; then the same wave with four
               requests sampled (T 0.7 and 1.0, seeds at and above 2^32),
               each against solo GPTInference.generate(temperature=, seed=)
               under the sampled-agreement rule: both paths' logits are read
               at every draw; their CDFs must stay within SAMPLE_SHIFT of
               each other, each token must be its path's own draw at
               u(seed, position), and a stream may differ only after a draw
               whose solo margin is below the measured shift of the CDFs
               and below SAMPLE_MARGIN.
   sampler (in the kernels phase) — serving/sampling.py on the card: the
               draws' histogram against softmax (chi-square), card against
               CPU draws at (8, 128256), temperature 0 as the argmax, the
               engine's captured sampler program at 1, 8 and 24 rows held to
               the CPU over several replays with new inputs, and its device
               µs a call.
   sampled_serve (in the serve phase) — the serve wave all greedy and
               with half its requests sampled (T=0.8), in turns, on the
               serve engine: tokens/s, TTFT, TBOT, 0 captures and
               compiles, the greedy waves' launches equal to the serve
               wave's, the sampler's share of a decode step.
   quant_fleet — the fleet wave through ServingEngine(quantize="int8")
               with every fleet stage and the self-draft, beside the bf16
               fleet wave: int8_linear's launches by route against the
               program calls (chunks and verify on wgmma, decode on
               stream), 0 compiles and captures.
   quant_fleet_agreement — f32 at QUANT_FLEET_AGREE_LAYERS layers,
               int8-exact weights: fleet_agreement's waves (greedy and
               sampled) through the unquantized and the int8 fleet engines:
               greedy streams equal, sampled ones under the
               sampled-agreement rule.
   moe_fleet — MoEGPT under int8 and every fleet stage with a 2-layer
               dense draft, the fleet wave: grouped_mlp n_layer a target
               program call (so inside the chunk and verify graphs),
               int8_linear by route; then f32 at QUANT_FLEET_AGREE_LAYERS
               layers, fleet_agreement's waves against solo GPTInference of
               the same quantized MoEGPT.
   slo_serve — ServingEngine(slo=): tokens/s with a loose SLOPolicy
               attached to one engine and detached, in turns, beside a
               second engine without one (goodput 1.0); then, f32, an impossible
               p99 TTFT while batch-lane requests hold every slot: a
               slo.breach, burn-rate preemption, greedy streams equal to
               the wave without a policy.
8. train     — TrainStep(jit(GPTForCausalLM(llama-350m), transforms=
               [AutocastTransform()]), AdamW(lr=1e-4)) at full width and
               depth, f32 master weights, bf16 autocast, B=4, T=2048, one
               batch from np.random.RandomState(seed) every step (bench.py's
               setup): the first call timed as compile, 2 warm-up and 10
               timed steps. The flash-RoPE counters are zeroed just before
               the timed steps and must read 24 x 10 each just after; the
               losses must be finite and fall. ``bound_ms`` is the step's
               least time from shapes (step_bound) and ``mfu`` its
               operations over the step time at the bf16 peak. ``baseline`` is a
               hand-written plain-PyTorch step of the same model in bf16
               autocast with F.scaled_dot_product_attention, timed alike
               (the counterpart of bench.py's hand-written baseline; the
               port never calls it). train_slo: a TrainStep(slo=) on the
               same module, captured, in turns with the unmonitored step.
9. train_profile — torch.profiler over 2 train steps: device busy share,
               the kernels that take the time (by name, and per step by
               kind: attention, matmul, optimizer, ...), launches a step.
10. train_agreement — f32, TF32 off, llama-350m width at 2 layers, B=1,
               T=2048: 3 steps of the port's TrainStep against the
               hand-written reference step (its own module math, torch
               autograd, AdamW written out as thunder_tpu/optim.py does) from
               the same weights and batch. Losses within LOSS_RTOL; the
               parameters within PARAM_ATOL.
11. fp8_train — the train phase's step with [AutocastTransform(),
               FP8TrainingTransform()] (bench.py's BENCH_FP8 row): every
               linear (5 a layer + lm_head: 121, counted in the trace)
               through fp8_linear, the backward's products through
               torch._scaled_mm; first call timed as compile, 2 warm-up and
               10 timed steps, the counters zeroed just before: fp8_linear
               121 x 10, flash 24 x 10 each; losses finite and falling, every
               amax history filled; beside the bf16 train phase's ms a step
               and peak memory. fp8_train_profile: as train_profile.
               The kernels phase runs fp8_linear at the five llama-350m
               shapes (M=8192, x bf16 and f32; codes and amaxes equal to the
               plain version's, y within FP8_TOL, which a K sweep 1024 /
               2816 / 4096 prints), beside a bf16 matmul and
               torch._scaled_mm on operands quantized beforehand.
12. fp8_train_agreement — phase 10's setup with FP8TrainingTransform, against
               the reference step with ReferenceFP8Linear (the delayed-scaling
               linear written out in this script) on every linear: losses
               within FP8_LOSS_RTOL, histories within FP8_HIST_RTOL and the
               first step's weight amaxes equal, parameters within
               FP8_PARAM_ATOL.
13. lora_train — llama-350m with [AutocastTransform(), LORATransform(r=8,
               lora_alpha=16)], every base parameter frozen, a compile
               step, a capture step and 9 timed steps: only
               the 242 adapter parameters may change; losses fall.
14. nano_train — TrainStep(jit(NanoGPT(gpt2), [AutocastTransform()]),
               AdamW(lr=1e-4)) at bench.py's nanogpt-124m shape (B=8,
               T=1024), full width and depth: compile, 2 warm-up and 10 timed
               steps, flash_fwd and flash_bwd counted 12 x 10 each between
               zeroed counters; nano_train_profile over 2 steps; and the
               hand-written baseline (F.scaled_dot_product_attention,
               F.layer_norm, F.gelu(approximate="tanh")) in the same call.
15. nano_eval — jit(model)(idx, targets) with no gradient under autocast at
               the same shape: cross_entropy must launch once on the bf16
               logits, its loss within NANO_EVAL_RTOL of F.cross_entropy on
               the same logits.
16. nano_train_agreement — f32, TF32 off, gpt2 width at 2 layers, B=1,
               T=256: 3 steps against the hand-written step, as phase 10.
17. remat_train — GPTForCausalLM(llama-1b) at full width and depth, B=1,
               T=2048, bf16 autocast, AdamW (bench.py's llama-1b:1:2048 rows),
               with activation_checkpoint off and then on: ms a step, device
               ms a step (2 profiled steps each: remat_train_plain_profile,
               remat_train_ckpt_profile), peak memory from a clean start,
               saved-for-backward tensors, and
               flash_rope_fwd launches a step against the count the traces
               plan (the backward replays each checkpointed layer's
               forward). Then f32 losses over 3 steps at 2 layers, with and
               without remat, within REMAT_RTOL.
18. moe_serve — ServingEngine over MoEGPT: Llama-3-1B with every MLP
               replaced by 8 SwiGLU experts of width 1024, top-2, drop-free
               (benchmark_inference.py --moe), bf16: the serve phase's 16
               requests after one warm-up replay of them; grouped_mlp must
               launch n_layer times each prefill and decode call the engine
               counts, with 0 compiles; beside the dense serve wave of the
               same call. moe_serve_profile: as profile.
19. moe_agreement — f32, TF32 off: 4 MoE streams through the engine and solo
               GPTInference, under the AGREE_GAP rule.
20. moe_train — TrainStep(jit(MoEGPT(..., capacity_factor=1.0),
               [AutocastTransform()]), AdamW(lr=1e-4)) at B=1, T=2048 (bench.py's
               MoE row at Llama-3-1B widths): compile, 2 warm-up and 10 timed
               steps, grouped_mlp and the flash-RoPE pair n_layer x 10 each
               between zeroed counters (the kernel runs f32 here: autocast
               leaves grouped_mlp and rms_norm in f32), and the AdamW
               kernel once a step; losses falling; moe_train_profile over 2
               steps.
21. moe_train_agreement — f32, TF32 off, 2 layers, B=1, T=256: 3 steps on the
               grouped road (kernel and claimed grad rule) against the dense
               road (no kernel) from the same weights, losses within
               LOSS_RTOL, step-1 gradients within MOE_GRAD_RTOL and
               parameters within MOE_PARAM_ATOL (flip-prone elements,
               whose gradient is near 0 and below 10x the roads' gap,
               within ADAMW_FLIP_ATOL); then the grouped road captured
               against op by op over 3 new batches, bit for bit.
22. check_ring — the ring attention step kernels (ring_flash_fwd replaces
               pallasex.ring_flash_step, ring_flash_bwd pallasex.ring_flash_bwd_step):
               one process steps every rank's four-step ring over an
               8,192-token context (T_blk=2048), diagonal first, at
               llama-350m's heads (H=16, D=64), a GQA case (H=16, Hkv=4,
               D=128) and a full (non-causal) case, bf16 and f32: each step
               against the plain version (RING_TOL), the whole ring's out,
               lse, dq, dk, dv against the flash kernels on the whole
               sequence, each tensor within RING_TOL on max |err| / max
               |ref| and ||err|| / ||ref||; at cp_train's shape (the one
               diagonal step of T=8192) the kernels against the plain
               versions (RING_TOL); then timed (CUDA graph, inputs rotated
               past L2, and eager) there and at T_blk=2048 for a diagonal, a
               past and a future step, beside bound_ms, the plain versions,
               and on the same (q, shard) pair SDPA and the flash forward
               kernel (forward), the flash backward kernel and SDPA's
               autograd backward (backward). In bf16/fp16 the forward step
               runs the flash forward's wgmma core in ring mode
               (ring_forward_plan's items and blocks are printed) and the
               backward step the flash backward's wgmma core, both at the
               step's offsets.
23. cp_train — TrainStep over context_parallel(jit(GPTForCausalLM(llama-350m,
               block_size=8192), [AutocastTransform()]), make_mesh({"sp": 1}))
               on a one-rank NCCL process group (opened once for phases
               23-24 and the sharded phases after them, then destroyed),
               AdamW(lr=1e-4), B=1, T=8192:
               3 untimed steps and 10 timed ones between zeroed counters;
               ring_flash_fwd and ring_flash_bwd must read 24 x 10 each and
               the flash-RoPE pair 0; losses finite and falling; 2 steps
               profiled (the NCCL all-reduces of the loss and of every
               gradient: their device time and host calls). Beside it, the
               plain TrainStep (flash-RoPE kernels) on the same batch.
24. cp_train_agreement — f32, TF32 off, llama-350m at 2 layers, B=1, T=1024:
               3 AdamW steps of the sp=1 context-parallel step against the
               plain TrainStep from the same weights: losses within
               LOSS_RTOL, step-1 gradients within MOE_GRAD_RTOL, parameters
               within MOE_PARAM_ATOL (flip-prone elements within
               ADAMW_FLIP_ATOL), as moe_train_agreement; then the CP step
               captured against op by op over 3 new batches, bit for bit.
   fsdp_train — train's configuration (llama-350m, B=4, T=2048, bf16
               autocast, AdamW, captured) under fsdp(zero=3) over a
               one-rank mesh of the same NCCL group: 10 timed steps
               between zeroed counters (the flash-RoPE pair 24 x 10, AdamW
               10 over the rank's shards, 0 captures, 10 replays), its
               profile (each one-rank gather and reduce-scatter is one
               device copy), the plain step's profile and both in turns;
               the saved-for-backward bytes at zero=3 and zero=2, which
               must differ by exactly the gathered matmul weights' bf16
               copies (ZeRO-3 re-gathers).
   sharded_agreement — f32, TF32 off, llama-350m at 2 layers, B=1,
               T=1024: 3 captured steps under fsdp(zero=2), fsdp(zero=3), a
               1 x 1 dp x fsdp mesh with GradBucketingTransform,
               ddp(bucket_mb=) (both 64 MiB buckets, which must pack) and
               column/row tensor parallelism of the MLPs, each bit-equal to
               the plain captured step; a no_sync window under fsdp(zero=3)
               against the plain window (the MoE road agreement's bounds);
               3 windows captured against op by op, bit for bit.
   ep_moe    — moe_ep_forward at ep=1 (E=8, D=2048, H=1024, top-2, bf16,
               N=4,096 tokens): one grouped_mlp launch a call, device µs a
               call against MoEMLP's grouped road on the same tokens and
               weights; in f32 the output and the gradients of x, the
               router and the three panels within MOE_GRAD_RTOL of their
               largest of the function written out on grouped_mlp_plain.
25. vit_train — TrainStep(jit(ViTForClassification(vit-b16),
               [AutocastTransform()]), AdamW(lr=1e-4)) at B=64, 224x224
               (patch 16: T=197, 12 heads of 64, full attention), full width
               and depth, random images and labels from --seed: compile, 2
               warm-up and 10 timed steps (ms, images/s, MFU from the
               trace's shapes, peak memory), tt_flash_fwd and tt_flash_bwd
               12 x 10 each and AdamW 10 between zeroed counters, 0
               captures; vit_train_profile over 2 steps; the same-call pair;
               the hand-written baseline (F.conv2d, F.layer_norm,
               F.scaled_dot_product_attention) on the same weights, in
               turns with the captured step (baseline, port, port,
               baseline).
26. vit_eval — the eval-mode forward loss with no gradient, bf16, B=64:
               the cross-entropy kernel claims the (64, 1000) logits, once;
               within VIT_EVAL_RTOL of F.cross_entropy on the same logits.
27. vit_train_agreement — f32, TF32 off, vit-b16's width at depth 2, B=8:
               3 steps against the hand-written step with written-out
               attention (losses within LOSS_RTOL, parameters within
               PARAM_ATOL), then captured against op by op, bit for bit,
               cuDNN deterministic.
28. resnet_train — TrainStep(jit(ResNetLoss(resnet50)),
               [AutocastTransform()]), SGD(lr=0.1, momentum=0.9,
               weight_decay=1e-4): torchvision's recipe) at B=64, 224x224,
               full width and depth: as vit_train (every BatchNorm's f32
               running stats written each step), its profile, the pair and
               the captured step in turns with a hand-written
               F.conv2d/F.batch_norm baseline.
29. resnet_train_agreement — f32, TF32 off, cuDNN deterministic, resnet50's
               widths at one bottleneck a stage, B=8: a train-mode forward
               and 3 steps against the hand-written step, with AdamW
               (losses, parameters and running stats held) and with the
               recipe's SGD at lr 1e-3 (losses and running stats held, the
               parameters against the hand-written step in f64: no farther
               than SGD_F64_RATIO times the f32 hand-written step);
               model.eval() retraces once and matches the hand-written eval
               forward; then the recipe's SGD road captured against op by
               op, bit for bit, running stats included.
30. frontend_eval — TorchLlama (a Llama written in plain PyTorch in this
               script: nn.Embedding, nn.Linear, F.rms_norm, RoPE in tensor
               ops, F.scaled_dot_product_attention with enable_gqa, F.silu,
               F.cross_entropy) at Llama-3-1B, bf16, with the weights of a
               port GPTForCausalLM from --seed: tt.jit(model,
               cuda_graphs=True) must take the torch frontend
               (interop/torch_frontend.py); the loss at B=2, T=2048 within
               FRONTEND_EVAL_RTOL of the module run eagerly; per call 16
               tt_flash_fwd, 33 tt_rms_norm, 1 tt_cross_entropy, no
               torch_eager op, 0 captures and compiles after warm-up; the
               same-call pair with the port-native forward (frontend,
               native, native, frontend) and two profiles of each.
31. frontend_train — TorchLlama at llama-350m, f32 master weights, bf16
               autocast, B=4, T=2048, a user loop of tt.value_and_grad and
               AdamW.update (op by op): 3 untimed and 10 timed steps,
               tt_flash_fwd and tt_flash_bwd 24 a step; in turns with the
               port-native value_and_grad loop, two profiles of each; the
               captured TrainStep's ms a step beside it.
32. frontend_train_agreement — f32, train_agreement's config: 3 AdamW
               steps of the frontend road against the hand-written step
               (LOSS_RTOL, PARAM_ATOL).
33. quant_train — TrainStep(jit(GPTForCausalLM(Llama-3-1B),
               [QuantizeInt8Transform(mlp.fc_1, mlp.fc_2),
               QuantizeNF4Transform(mlp.proj), AutocastTransform()]),
               AdamW(lr=1e-4)) at full width and depth, f32 master weights,
               B=1, T=512 (M = QUANT_MAX_M: every frozen linear claimed;
               autocast leaves them f32 x, so they run the kernels' split
               route): compile, 2 warm-up and 10 timed steps, captured (0
               captures, 10 replays); int8_linear 32, nf4_linear 16 (all
               on the split route), the
               flash-RoPE pair 16 each and AdamW 1 a step between zeroed
               counters; every quantized linear of the forward trace claimed
               by its kernel; the codes, scales and absmax bit-equal after
               the steps and every trainable tensor moved; the trainable
               parameter count, the frozen weight bytes, peak memory;
               quant_train_profile over 2 steps. The kernels phase times
               both kernels at these shapes in bf16 and f32.
34. quant_train_agreement — f32, TF32 off, Llama-3-1B's widths at 2 layers,
               B=1, T=512, on two int8-exact data (QUANT_AGREE_DATA): 3
               steps of the TrainStep op by op against the hand-written
               step whose frozen linears are written out
               (FrozenLinearReference: the kernels' f32 function forward,
               thunder_tpu's bf16-rounded rules backward): on both data
               the step-1 loss within LOSS_RTOL and every step-1 gradient
               within QUANT_GRAD_RTOL of its tensor's norm, frozen tensors
               bit-equal; on the held data the 3 steps' losses within
               LOSS_RTOL and parameters within PARAM_ATOL; then the
               captured step bit-equal to op by op over 3 batches.
35. fp8_inference — Llama-3-1B built under meta_device() (nothing allocated)
               and materialized onto the card by MaterializationTransform
               (seed), twice; tt.jit(model, transforms=[FP8LinearInference()],
               cuda_graphs=True) at B=2, T=2048, bf16 (frontend_eval's
               shape), in turns with the bf16 forward of the other copy
               (fp8, bf16, bf16, fp8), each profiled twice: device and wall
               ms a call; weight bytes; torch._scaled_mm calls a forward
               (81, every linear); then one uncaptured forward whose every
               fp8 linear is held against thunder_tpu's _fp8_linear_impl
               written out on the same x (fp8_inference_err <= 1: f32
               accumulation, the tensor cores' FP8_MMA_EPS and the final
               cast), the logits being lm_head's.
36. extensions — ExtensionsNet (an autocast_ctx region, tt.custom_op with
               register_vjp, a diagonal ltorch.einsum and a scatter, a
               folded constant) through tt.jit(transforms=[ConstantFolding(),
               PrunePrologueChecks()]): the captured forward bit-equal to op
               by op, the trace holding each part; a captured TrainStep
               (its backward's torch.vjp_fallback for EINSUM and SCATTER
               and the custom vjp) bit-equal to op by op over 3 batches,
               its losses within EXT_LOSS_RTOL of the CPU's, its step-1
               gradients within EXT_GRAD_RTOL (of each tensor's norm) of
               the CPU's and of torch autograd's through extensions_plain
               (plain torch: torch.einsum, Tensor.scatter) on the card.
37. resilient_train — llama-350m at full width, B=4, T=2048, bf16 autocast,
               AdamW, captured, ``ScaledLoss`` (the loss times a float
               input of ones, which nan_loss poisons): a token file of
               RESILIENT_TOKENS uint16 tokens from --seed under build/, a
               native TokenLoader (its library must build) through
               prefetch_to_device, TrainStep(guard=StepGuard(
               GuardPolicy(on_nonfinite="skip", check_grad_norm=True,
               retry_transient=2))), CheckpointManager(every_n_steps=8,
               keep=2, async_save=True), the fault plan RESILIENT_PLAN.
               Step 5 is skipped (every parameter, moment, the device step
               and buffer bit-equal, compared on the card), step 9 retried
               twice, a SIGTERM after step 14 drains into a final save and
               Preempted; the counters of the flash-RoPE pair and AdamW,
               zeroed before, read 24 + 24 + 1 a step; 1 capture, at the
               second step. Then RESILIENT_CONTINUATIONS uninterrupted
               continuations from the saved state (written back in place),
               RESILIENT_STEPS steps each on the next batches, and a fresh
               TrainStep and manager restore the save (bit-equal to a device
               copy kept at the preemption; its loader cursor serves the
               same batches) and run those steps: within the
               continuations' spread of the nearest (the bf16 flash
               backward is not bit-reproducible). Prints the save's stall
               on the step loop, its write's seconds and GB, the restore's
               seconds, the native loader's batches/s, the device's idle
               share over 3 prefetched guarded steps (profiled), and the
               guarded and an unguarded step's ms in turns (unguarded,
               guarded, guarded, unguarded).
38. resilient_kill_resume — llama-350m at 2 layers, f32, B=1, T=512: three
               processes (KILL_RESUME_CHILD): 12 uninterrupted steps; 12
               steps under TT_FAULT=die@7 with a save every 4, killed by
               os._exit in step 7 (exit code 77, only the step-4 save);
               a restore of that save (loader cursor included) run to 12.
               The resumed losses must equal the uninterrupted run's, bit
               for bit (the f32 routes are bit-reproducible).
The kernels phase also holds the RoPE-free flash pair at vit_train's shape
(B=64, H=12, T=197, D=64, full) and over a ragged sweep (T of 50, 197,
257; flash_ragged_full), each against the plain versions.
CUDA graphs (executors/graphex.py). Every train, serve and inference
phase runs captured: TrainStep's whole step is one graph from its second
call, each engine's programs are captured by ServingEngine.warmup before its
wave, GPTInference's decode loop is one graph (scan_decode). Each phase
prints its graph_captures and graph_replays, fails without a replay, and a
wave after warmup must capture and compile nothing. The agreements that
read every step's gradients in Python (moe_train_agreement,
cp_train_agreement: GradRecorder) run op by op; each then holds its road
captured against op by op, bit for bit in f32 over 3 new batches
(``captured``). ``graphs`` lines are the
same-call pairs, captured against op by op in turns (graphs, op by op, op
by op, graphs: PAIR_ROUNDS): train, nano_train and moe_train (one TrainStep
with cuda_graphs switched: wall and device ms a step), serve and fleet (two
engines on one model: tokens/s, TTFT, TBOT, captures and compiles during
each wave) and nf4_generate (scan_decode on and off); each run's kernel
launches must agree. ``graphs_pdl`` replays the serve decode step's graph
with rms_norm's programmatic dependent launch on and off. nf4_inference
also prints where one uncaptured decode call spends its host time
(decode_enqueue_profile: torch.profiler's host rows and cProfile's).

The kernels phase also holds grouped_mlp against its plain version at the
paths' shapes (decode cap 8 and prefill cap 1024 in bf16, train cap 512 in
f32, a cap of 200), timed beside its bound, its plain version and the
torch.bmm chain of the decomposition, with its route and each stage's device
time (gate/up and down), as fp8_linear's quantize pass and product are.

Then the kernels line, the card's name and power limit, and the final
{"ok": true, ...} line. Any failure exits non-zero without the final line;
so does a machine without a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Two f32 paths through the same model differ only in summation order (paged
# kernel vs dense decomposition, bucket-padded vs exact prefill shapes), which
# moves a logit by ~1e-5 at these widths: a greedy choice may flip only where
# the top two logits are closer than this.
AGREE_GAP = 1e-3
KERNEL_TOL = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 1e-4}
# The flash kernels are held to KERNEL_TOL on |kernel - plain| / max(1,
# |plain|): absolute below 1, relative above (and to FLASH_GRAD_TOL and
# FLASH_LSE_TOL). In bf16 an output of magnitude ~4 is
# itself rounded to 2^-6 = 0.016, and the kernels round p and ds to bf16
# before their products as the TPU kernels do; the plain versions do not.
# Two f32 training runs of the same math in another summation order: losses
# within LOSS_RTOL. AdamW's step is ±lr wherever |g| >> eps, whatever |g|, so
# a gradient element near 0 whose sign the summation order flips moves its
# parameter by up to 2 lr a step: PARAM_ATOL is that bound over 3 steps.
LOSS_RTOL = 1e-4
TRAIN_LR = 1e-4
PARAM_ATOL = 2 * TRAIN_LR * 3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12,  # dense bf16 tensor; f32 non-tensor
            "float8": 1979e12}  # dense fp8 tensor
L2_BYTES = 50 * 2 ** 20


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "elapsed_s": time.perf_counter() - T_START}), flush=True)


def _event_ms(run) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def cuda_ms(fn, arg_sets, iters: int = 200) -> tuple[float, float]:
    """(device ms, eager ms) per call of fn over `iters` calls cycling
    through arg_sets (sized past the L2 cache, so each call reads cold
    inputs). Device time replays the calls captured in one CUDA graph, so
    no host gap sits between them; eager time issues them from Python."""
    def run_all():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for i in range(3):
            fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.current_stream().wait_stream(side)
    eager = _event_ms(run_all) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run_all()
    graph.replay()
    device = _event_ms(graph.replay) / iters
    del graph
    return device, eager


def copies(make, nbytes: int, most: int = 200) -> list:
    """Independent input sets exceeding twice the L2 cache (at most one per
    timed launch)."""
    return [make() for _ in range(min(most, max(2, math.ceil(2 * L2_BYTES / max(1, nbytes)))))]


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def dname(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


# rms_norm at Llama-3-1B's width: the serve wave's decode batches (1-8 rows)
# and prefill buckets (128-1,024 rows) in bf16, and 512 rows in f32
RMS_D = 2048
RMS_SHAPES = ((1, torch.bfloat16), (4, torch.bfloat16), (8, torch.bfloat16), (128, torch.bfloat16),
              (512, torch.bfloat16), (1024, torch.bfloat16), (512, torch.float32))


def rms_work(N: int, D: int, itemsize: int) -> tuple[float, float]:
    """(bytes, operations) of one rms_norm: x read and y written once, w
    read once; ~4 operations an element."""
    return 2 * N * D * itemsize + D * itemsize, 4 * N * D


def check_rms(cudaex, dev, gen) -> dict:
    """rms_norm against its plain version at RMS_SHAPES and in fp16
    (KERNEL_TOL), then timed at RMS_SHAPES beside its bound, its plain
    version, F.rms_norm and an empty kernel's launch (the floor), each with
    rms_norm_plan's launch."""
    D, eps = RMS_D, 1e-5
    errs, cases = [], []
    for N, dt in RMS_SHAPES + ((8, torch.float16), (512, torch.float16)):
        x = torch.randn(N, D, device=dev, generator=gen).to(dt)
        w = (1 + 0.1 * torch.randn(D, device=dev, generator=gen)).to(dt)
        out = cudaex.rms_norm(x, w, eps)
        torch.cuda.synchronize()
        err = (out.float() - cudaex.rms_norm_plain(x, w, eps).float()).abs().max().item()
        if not err <= KERNEL_TOL[dname(dt)]:
            raise AssertionError(f"rms_norm N={N} {dt}: max abs err {err}")
        errs.append(err)
        cases.append({"N": N, "D": D, "dtype": dname(dt), "max_abs_err": err})
    floor, floor_eager = cuda_ms(lambda: cudaex.empty_kernel(dev), [()])
    timings = {}
    for N, dt in RMS_SHAPES:
        nbytes, ops = rms_work(N, D, dt.itemsize)
        sets = copies(lambda: (torch.randn(N, D, device=dev, generator=gen).to(dt),
                               torch.randn(D, device=dev, generator=gen).to(dt)), nbytes)
        b, by = bound_ms(nbytes, ops, "float32" if dt == torch.float32 else "bfloat16")
        ms, eager = cuda_ms(lambda x, w: cudaex.rms_norm(x, w, eps), sets)
        plain, plain_eager = cuda_ms(lambda x, w: cudaex.rms_norm_plain(x, w, eps), sets)
        lib, lib_eager = cuda_ms(lambda x, w: torch.nn.functional.rms_norm(x, (D,), w, eps), sets)
        timings[f"N={N} {dname(dt)}"] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by, share_of_bound=b / ms,
            eager_ms=eager, plain_eager_ms=plain_eager, library_eager_ms=lib_eager,
            plan=cudaex.rms_norm_plan(N, D, dt))
    emit("kernels", kernel="rms_norm", cases=cases, empty_kernel_ms=floor, empty_kernel_eager_ms=floor_eager,
         timing=timings)
    return dict(max_abs_err=max(errs), shape="N=512 D=2048 bf16", **timings["N=512 bfloat16"])


def model_shapes(which: str) -> list:
    """The parameter shapes and dtypes of the model an AdamW timing stands
    for: ``moe`` moe_train's MoEGPT (Llama-3-1B, 8 experts of 1024; 1.50 B
    parameters), ``llama-350m`` the train phase's; f32 master weights both."""
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.models.moe import MoEGPT

    if which == "moe":
        cfg = Config.from_name("Llama-3-1B", block_size=2048)
        model = MoEGPT(cfg, moe_config(cfg, capacity_factor=1.0), torch.float32)
    else:
        model = GPTForCausalLM(Config.from_name(which, block_size=2048), torch.float32)
    shapes = [(tuple(p.shape), p.dtype) for p in model.parameters()]
    del model
    torch.cuda.empty_cache()
    return shapes


ADAMW_HYPER = dict(lr=TRAIN_LR, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


def adamw_inputs(dev, gen, shapes, g_dtype=None) -> tuple:
    """Parameters, gradients and f32 moments at `shapes`, random (v > 0)."""
    ps = [torch.randn(s, device=dev, generator=gen).mul_(0.02).to(dt) for s, dt in shapes]
    gs = [torch.randn(s, device=dev, generator=gen).mul_(1e-3).to(g_dtype or dt) for s, dt in shapes]
    ms = [torch.randn(s, device=dev, generator=gen).mul_(1e-4) for s, _ in shapes]
    vs = [torch.rand(s, device=dev, generator=gen).mul_(1e-6) for s, _ in shapes]
    return ps, gs, ms, vs


def adamw_errors(got: tuple, want: tuple) -> tuple[dict, dict]:
    """Largest |kernel - plain| of p, m and v, and each over its largest
    |plain|."""
    err, rel = {}, {}
    for name, a, b in zip("pmv", got, want):
        err[name] = max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b) if x.numel())
        rel[name] = err[name] / max(y.float().abs().max().item() for y in b if y.numel())
    return err, rel


# The AdamW kernel against adamw_plain after two updates: m, v and f32 p
# within ADAMW_TOL of their tensor set's largest |value| (both sides round
# each step once, in one order; the card's chain may divide by a reciprocal
# or leave a product unfused: an ulp, 6e-8 relative), bf16/fp16 p within one
# ulp at that largest value (a rounding that lands on the other side).
ADAMW_TOL = {"float32": 1e-6, "bfloat16": 2 ** -7, "float16": 2 ** -10}


def check_adamw(cudaex, dev, gen) -> dict:
    """adamw_update against adamw_plain over two updates at llama-350m's
    parameter shapes (f32 p and g; bf16 p with bf16 g; f32 p with bf16 g),
    then timed at moe_train's MoEGPT and train's llama-350m shapes beside its
    bound (each parameter's p, g, m, v read and p, m, v written once), the
    plain chain and torch._fused_adamw_ with the same hyper-parameters."""
    errs, cases = [], []
    small = model_shapes("llama-350m")
    for p_dt, g_dt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                       (torch.float32, torch.bfloat16)):
        shapes = [(s, p_dt) for s, _ in small]
        ker = adamw_inputs(dev, gen, shapes, g_dt)
        ref = tuple([t.clone() for t in ts] for ts in ker)
        for step in (1, 2):
            cudaex.adamw_update(*ker, step=step, **ADAMW_HYPER)
            cudaex.adamw_plain(*ref, step=step, **ADAMW_HYPER)
        torch.cuda.synchronize()
        err, rel = adamw_errors((ker[0], ker[2], ker[3]), (ref[0], ref[2], ref[3]))
        bar = dict(p=ADAMW_TOL[dname(p_dt)], m=ADAMW_TOL["float32"], v=ADAMW_TOL["float32"])
        if not all(rel[k] <= bar[k] for k in rel):
            raise AssertionError(f"adamw p {p_dt} g {g_dt}: errors {rel} against {bar}")
        errs.append(err["p"])
        cases.append({"p": dname(p_dt), "g": dname(g_dt), "max_abs_err": err, "rel_err": rel, "bar": bar})
        del ker, ref
    skip_case = check_adamw_skip_flag(cudaex, dev, gen, small)
    timings = {}
    for which in ("moe", "llama-350m"):
        shapes = model_shapes(which)
        ps, gs, ms, vs = args = adamw_inputs(dev, gen, shapes)
        n = sum(p.numel() for p in ps)
        nbytes = sum(p.numel() * (2 * p.element_size() + g.element_size() + 16) for p, g in zip(ps, gs))
        b, by = bound_ms(nbytes, 15 * n, "float32")
        step = iter(range(1, 10 ** 6))
        # the kernel reads its step on the card (the time does not depend on it)
        step_t = torch.ones((), dtype=torch.int32, device=dev)
        ms_k, eager = cuda_ms(lambda *a: cudaex.adamw_update(*a, step=step_t, **ADAMW_HYPER), [args], iters=10)
        plain, _ = cuda_ms(lambda *a: cudaex.adamw_plain(*a, step=next(step), **ADAMW_HYPER), [args], iters=5)
        # the skip flag of a guarded step, set (1: the full update) and
        # unset (0: nothing written), in turns with the unflagged launch
        flags = {"unflagged": None, "flag_1": torch.ones((), dtype=torch.int32, device=dev),
                 "flag_0": torch.zeros((), dtype=torch.int32, device=dev)}
        flag_ms = {}
        for name in ("unflagged", "flag_1", "flag_0", "flag_0", "flag_1", "unflagged"):
            flag_ms.setdefault(name, []).append(cuda_ms(
                lambda *a: cudaex.adamw_update(*a, step=step_t, finite=flags[name], **ADAMW_HYPER), [args],
                iters=10)[0])
        steps = [torch.ones((), device=dev) for _ in ps]
        h = ADAMW_HYPER
        lib, _ = cuda_ms(lambda *a: torch._fused_adamw_(*a, [], steps, lr=h["lr"], beta1=h["beta1"],
                                                        beta2=h["beta2"], weight_decay=h["weight_decay"],
                                                        eps=h["eps"], amsgrad=False, maximize=False),
                         [args], iters=10)
        timings[which] = dict(ms=ms_k, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
                              share_of_bound=b / ms_k, eager_ms=eager, params=n, tensors=len(ps),
                              chunks=int(cudaex.adamw_tables(ps, gs, ms, vs)[1].numel()),
                              skip_flag_ms=flag_ms)
        del ps, gs, ms, vs, args, steps
        torch.cuda.empty_cache()
    emit("kernels", kernel="adamw", cases=cases, skip_flag_case=skip_case, timing=timings)
    return dict(max_abs_err=max(errs), shape="MoEGPT (Llama-3-1B, 8 experts of 1024) f32 p and g",
                **timings["moe"], skip_flag={"case": skip_case,
                                             "ms_at_llama-350m": timings["llama-350m"]["skip_flag_ms"]})


def check_adamw_skip_flag(cudaex, dev, gen, shapes) -> dict:
    """The skip flag of a guarded step at llama-350m's parameter shapes (f32
    p and g): flag 0 leaves every p, m and v bit-equal; flag 1 writes the
    unflagged launch's bits."""
    ker = adamw_inputs(dev, gen, shapes)
    ref = tuple([t.clone() for t in ts] for ts in ker)
    before = [t.clone() for ts in (ker[0], ker[2], ker[3]) for t in ts]
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    cudaex.adamw_update(*ker, step=1, finite=flag, **ADAMW_HYPER)
    unchanged = all(torch.equal(a, b) for a, b in zip(before, (t for ts in (ker[0], ker[2], ker[3]) for t in ts)))
    flag.fill_(1)
    cudaex.adamw_update(*ker, step=1, finite=flag, **ADAMW_HYPER)
    cudaex.adamw_update(*ref, step=1, **ADAMW_HYPER)
    same = all(torch.equal(a, b) for a, b in zip((t for ts in (ker[0], ker[2], ker[3]) for t in ts),
                                                 (t for ts in (ref[0], ref[2], ref[3]) for t in ts)))
    moved = not torch.equal(before[0], ker[0][0])
    if not (unchanged and same and moved):
        raise AssertionError(f"adamw skip flag: flag 0 left p, m, v bit-equal: {unchanged}; flag 1 wrote the "
                             f"unflagged bits: {same}; flag 1 moved p: {moved}")
    del ker, ref, before
    torch.cuda.empty_cache()
    return {"flag_0_bit_equal": unchanged, "flag_1_equals_unflagged": same, "tensors": len(shapes)}


def paged_inputs(dev, gen, dt, seq_lens, B=8, H=32, Hkv=8, D=64, ps=16, npm=128):
    P = 1 + B * npm  # the engine's pool at max_batch=8, max_seq=2048
    kp = torch.randn(P, ps, Hkv, D, device=dev, generator=gen).to(dt)
    vp = torch.randn(P, ps, Hkv, D, device=dev, generator=gen).to(dt)
    q = torch.randn(B, H, D, device=dev, generator=gen).to(dt)
    perm = torch.randperm(P - 1, device=dev, generator=gen) + 1
    pt = torch.zeros(B, npm, dtype=torch.int32, device=dev)  # null page 0 past each sequence
    used = 0
    for b, L in enumerate(seq_lens):
        n = -(-L // ps)
        pt[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, sl


PAGED_KERNELS = ("paged_split_kernel", "paged_combine_kernel", "paged_chunk_split_kernel",
                 "paged_chunk_core")
PAGED_SETS = {"ragged": [1, 17, 300, 1024, 2048, 16, 777, 1500],  # seq_len 1, full table, partial pages
              "uniform1024": [1024] * 8, "long_one_short_rest": [2048] + [1] * 7}


def device_rows(prof) -> list:
    """(device us, name, count) of a torch.profiler run's device-side rows,
    largest first (operator rows would count their kernels twice)."""
    rows = []
    for e in prof.key_averages():
        # the attribute's name changed across torch releases
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if str(e.device_type).endswith("CUDA") and dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    return sorted(rows, reverse=True)


# The profiler's clock check. A session brackets ``run()`` between two spins
# (torch.cuda._sleep's spin_kernel): a ~10 ms one timed by CUDA events
# before it, and a short one after it. Two faults of the profiler's clock
# showed on the card: a session can read every device duration scaled by
# one factor (0.476 and 0.515 in two sessions of one run, ROADMAP queue C),
# and a session can lose the device events of its first ~10-100 ms. So the
# measured spin comes behind a lead-in of short spins, the
# rows are divided by its profiler/event ratio, and a session that lost the
# measured or the closing spin is retaken behind a longer lead-in.
CLOCK_SPIN_CYCLES = 20_000_000  # the measured spin, ~10 ms
CLOCK_SHORT_CYCLES = 1_000_000  # lead-in and closing spins, ~0.5 ms each
# Lead-in spins of each try: on an H100 a full run lost the measured spin
# behind 1 and 20 of them (0.5 and 10 ms) in 34 of 56 sessions, and none
# behind 200 (PERF.md §6).
CLOCK_LEAD_INS = (200, 1000)
CLOCK_KERNEL = "spin_kernel"
# Two profiles of one phase in one call must agree within PROFILE_RTOL on
# device ms where their launch counts agree within PROFILE_LAUNCH_RTOL.
PROFILE_RTOL = 0.05
PROFILE_LAUNCH_RTOL = 0.01


def profiled(run) -> dict:
    """torch.profiler (CPU and CUDA activities) over run() between the clock
    check's spins: the device rows corrected by the check's ratio (``rows``,
    the spins left out), the wall us of run() (``wall_us``), the ratio
    (``clock_ratio``: profiler us / event us of the measured spin), the
    profiler object (``prof``) and the sessions retaken because they lost
    the measured or the closing spin (``retaken``: the spins each recorded
    of those it launched)."""
    from torch.profiler import ProfilerActivity, profile

    retaken = []
    for lead_in in CLOCK_LEAD_INS:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(lead_in):
                torch.cuda._sleep(CLOCK_SHORT_CYCLES)
            start.record()
            torch.cuda._sleep(CLOCK_SPIN_CYCLES)
            stop.record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            torch.cuda._sleep(CLOCK_SHORT_CYCLES)
            torch.cuda.synchronize()
        spins = sorted((e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
                       if CLOCK_KERNEL in e.name and str(e.device_type).endswith("CUDA"))
        # the measured spin is the one 10x longer than the others; the
        # closing spin is the last and starts after it
        long = [i for i, (_, us) in enumerate(spins) if us > 5 * min(u for _, u in spins)] if spins else []
        if len(long) == 1 and long[0] < len(spins) - 1:
            break
        retaken.append({"lead_in": lead_in, "spins": len(spins), "launched": lead_in + 2})
    else:
        raise AssertionError(f"the profiler lost the clock check's spins in {len(CLOCK_LEAD_INS)} sessions: "
                             f"{retaken}")
    ratio = spins[long[0]][1] / (start.elapsed_time(stop) * 1e3)
    rows = [(us / ratio, k, c) for us, k, c in device_rows(prof) if CLOCK_KERNEL not in k]
    return {"rows": rows, "wall_us": wall_us, "clock_ratio": ratio, "prof": prof, "retaken": retaken}


def profile_twice(phase: str, run) -> tuple[dict, dict]:
    """Two profiled(run) in a row; raises if their device times differ by
    more than PROFILE_RTOL while their launch counts agree within
    PROFILE_LAUNCH_RTOL. Returns both and the comparison."""
    first, second = profiled(run), profiled(run)
    busy = [sum(r[0] for r in p["rows"]) for p in (first, second)]
    launches = [sum(r[2] for r in p["rows"]) for p in (first, second)]
    same_work = abs(launches[0] - launches[1]) <= PROFILE_LAUNCH_RTOL * max(launches)
    gap = abs(busy[0] - busy[1]) / max(busy) if max(busy) else 0.0
    check = dict(device_ms=[b / 1e3 for b in busy], launches=launches, gap=gap, same_work=same_work,
                 clock_ratio=[first["clock_ratio"], second["clock_ratio"]],
                 retaken=first["retaken"] + second["retaken"])
    if same_work and gap > PROFILE_RTOL:
        raise AssertionError(f"{phase}: two profiles disagree: {check}")
    return first, check


def kernel_ms(fn, arg_sets, marks, n: int = 20) -> dict:
    """Device ms a call of each kernel whose name holds one of marks, from
    torch.profiler over n eager calls cycling through arg_sets."""
    def run():
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])

    out = {}
    for us, key, _ in profiled(run)["rows"]:
        mark = next((m for m in marks if m in key), None)
        if mark:
            out[mark] = out.get(mark, 0.0) + us / 1e3 / n
    return out


def check_paged(cudaex, dev, gen) -> dict:
    """The paged decode against its plain version on PAGED_SETS in bf16,
    fp16 and f32 (KERNEL_TOL), then each set timed in bf16 beside its bytes
    bound (live K/V read once), its plain version and the plan's splits."""
    errs, cases = [], []
    for label, lens in PAGED_SETS.items():
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            args = paged_inputs(dev, gen, dt, lens)
            out = cudaex.paged_attention(*args)
            torch.cuda.synchronize()
            err = (out.float() - cudaex.paged_attention_plain(*args).float()).abs().max().item()
            if not err <= KERNEL_TOL[dname(dt)]:
                raise AssertionError(f"paged_attention {label} {dt}: max abs err {err}")
            errs.append(err)
            cases.append({"seq_lens": label, "dtype": dname(dt), "max_abs_err": err})
    timings = {}
    H, Hkv, D, B, ps, npm = 32, 8, 64, 8, 16, 128
    plan = cudaex.paged_attention_plan(B, H, Hkv, D, ps, npm, torch.bfloat16)
    for label, lens in PAGED_SETS.items():
        live = sum(lens)
        nbytes = 2 * live * Hkv * D * 2 + 2 * B * H * D * 2 + B * 4 + sum(-(-L // ps) for L in lens) * 4
        sets = copies(lambda: paged_inputs(dev, gen, torch.bfloat16, lens), 2 * 1025 * 16 * Hkv * D * 2)
        b, by = bound_ms(nbytes, 4 * live * H * D, "bfloat16")
        ms, eager = cuda_ms(cudaex.paged_attention, sets)
        plain, plain_eager = cuda_ms(cudaex.paged_attention_plain, sets, iters=50)
        live_blocks = Hkv * sum(-(-L // plan["split_tokens"]) for L in lens)
        timings[label] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b, bound_by=by,
                              eager_ms=eager, plain_eager_ms=plain_eager, live_tokens=live,
                              split_blocks=plan["blocks"], live_split_blocks=live_blocks,
                              combine_blocks=plan["combine_blocks"], n_split=plan["n_split"],
                              device_ms_by_kernel=kernel_ms(cudaex.paged_attention, sets, PAGED_KERNELS))
    emit("kernels", kernel="paged_attention", cases=cases, timing_bf16=timings)
    return dict(max_abs_err=max(errs), shape="B=8 H=32 Hkv=8 D=64 ps=16 ragged bf16",
                **timings["ragged"])


def chunk_inputs(dev, gen, dt, q_pos, H=32, Hkv=8, D=64, ps=16, npm=128):
    """Paged chunk attention's inputs at the engine's pool (max_batch 8,
    max_seq 2048): each row's table a random permutation of pool pages
    covering its largest position, null page 0 past it; rows 0 and 1
    share their first pages (prefix sharing)."""
    B, T = q_pos.shape
    P = 1 + 8 * npm
    kp = torch.randn(P, ps, Hkv, D, device=dev, generator=gen).to(dt)
    vp = torch.randn(P, ps, Hkv, D, device=dev, generator=gen).to(dt)
    q = torch.randn(B, H, T, D, device=dev, generator=gen).to(dt)
    perm = (torch.randperm(P - 1, device=dev, generator=gen) + 1).to(torch.int32)
    pt = torch.zeros(B, npm, dtype=torch.int32, device=dev)
    used = 0
    for b in range(B):
        n = min(npm, int(q_pos[b].max()) // ps + 1)
        pt[b, :n] = perm[used:used + n]
        used += n
    if B > 1:
        pt[1, :4] = pt[0, :4]
    return q, kp, vp, pt, q_pos.to(dev)


def chunk_work(q_pos, H=32, Hkv=8, D=64, ps=16, npm=128, itemsize=2) -> tuple[float, float]:
    """(bytes, operations) paged chunk attention needs for these positions:
    each sequence's live K/V (keys up to its largest position, capped at the
    table) read once, q and the page table and positions read once, o
    written once; 4·D operations per query head and live key."""
    B, T = q_pos.shape
    live = (q_pos.long() + 1).clamp(max=npm * ps)
    kv = sum(int(live[b].max()) for b in range(B)) * Hkv * D * 2 * itemsize
    nbytes = kv + 2 * B * H * T * D * itemsize + B * npm * 4 + B * T * 4
    return nbytes, 4.0 * H * D * float(live.sum())


CHUNK_POS = {"chunk_start0": torch.arange(256, dtype=torch.int32)[None],
             "chunk_start1024": 1024 + torch.arange(256, dtype=torch.int32)[None],
             "chunk_start1792": 1792 + torch.arange(256, dtype=torch.int32)[None],
             # ragged verify rows; the fifth reaches 2048, one past the table
             "verify": (torch.tensor([1, 17, 300, 1024, 2046, 16, 777, 1500], dtype=torch.int32)[:, None]
                        + torch.arange(3, dtype=torch.int32)),
             # rows of a batch slot that holds no sequence (position -1) see no key
             "verify_empty_rows": torch.tensor([[-1, -1, -1], [5, 6, 7], [-1, -1, -1], [1000, 1001, 1002],
                                                [1800, 1801, 1802], [-1, -1, -1], [64, 65, 66], [0, 1, 2]],
                                               dtype=torch.int32)}


def chunk_plan(cudaex, q_pos, dt=torch.bfloat16) -> dict:
    """paged_chunk_plan's route, rows a block, split, splits and blocks at
    chunk_inputs' shapes."""
    plan = cudaex.paged_chunk_plan(q_pos.shape[0], 32, 8, q_pos.shape[1], 64, 16, 128, dt)
    return {k: plan[k] for k in ("route", "rows_per_block", "split_tokens", "n_split", "blocks",
                                 "combine_blocks", "scratch_bytes")}


def check_chunk(cudaex, dev, gen) -> dict:
    """paged_chunk_attention against its plain version at CHUNK_POS in bf16,
    fp16 and f32 (KERNEL_TOL on max |kernel - plain|; rows with no live key
    must be zeros), then timed in bf16 with the plan's route and
    splits and each kernel's device ms. ``sdpa_pregathered_ms`` is a side
    number, not library_ms: F.scaled_dot_product_attention over K/V gathered
    beforehand into contiguous (B, Hkv, keys, D) with the position mask — no
    one PyTorch call gathers the pages."""
    errs, cases = [], []
    for label, qp in CHUNK_POS.items():
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            args = chunk_inputs(dev, gen, dt, qp)
            out = cudaex.paged_chunk_attention(*args)
            torch.cuda.synchronize()
            want = cudaex.paged_chunk_attention_plain(*args).float()
            err = (out.float() - want).abs().max().item()
            if not err <= KERNEL_TOL[dname(dt)]:
                raise AssertionError(f"paged_chunk_attention {label} {dt}: max abs err {err}")
            dead = (args[4] < 0)[:, None, :].expand(out.shape[:3])
            if out[dead].any():
                raise AssertionError(f"paged_chunk_attention {label} {dt}: a row with no live key is not 0")
            errs.append(err)
            cases.append({"shape": label, "dtype": dname(dt), "max_abs_err": err})
            del args, out, want
    torch.cuda.empty_cache()
    F = torch.nn.functional
    timings = {}
    for label in ("chunk_start1792", "verify"):
        qp = CHUNK_POS[label]
        nbytes, ops = chunk_work(qp)
        b, by = bound_ms(nbytes, ops, "bfloat16")
        sets = copies(lambda: chunk_inputs(dev, gen, torch.bfloat16, qp), 2 * 1025 * 16 * 8 * 64 * 2)
        ms, eager = cuda_ms(cudaex.paged_chunk_attention, sets)
        plain, plain_eager = cuda_ms(cudaex.paged_chunk_attention_plain, sets[:1], iters=20)
        pre = []
        for q, kp, vp, pt, qpos in sets:  # gathered once, outside the timing
            S = min(int(qpos.max()) + 1, pt.shape[1] * 16)
            keys = pt.long().repeat_interleave(16, 1)[:, :S]
            slots = torch.arange(S, device=dev) % 16
            k = kp[keys, slots].permute(0, 2, 1, 3).contiguous()
            v = vp[keys, slots].permute(0, 2, 1, 3).contiguous()
            mask = torch.arange(S, device=dev)[None, None, None, :] <= qpos[:, None, :, None]
            pre.append((q, k, v, mask))
        lib, lib_eager = cuda_ms(lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m, enable_gqa=True), pre, iters=50)
        timings[label] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b, bound_by=by,
                              eager_ms=eager, plain_eager_ms=plain_eager,
                              sdpa_pregathered_ms=lib, sdpa_pregathered_eager_ms=lib_eager,
                              bytes=nbytes, operations=ops, plan=chunk_plan(cudaex, qp),
                              device_ms_by_kernel=kernel_ms(cudaex.paged_chunk_attention, sets,
                                                            PAGED_KERNELS))
        del sets, pre
        torch.cuda.empty_cache()
    emit("kernels", kernel="paged_chunk_attention", cases=cases, timing_bf16=timings)
    return dict(max_abs_err=max(errs), shape="B=1 H=32 Hkv=8 T=256 D=64 ps=16 start 1792 bf16",
                verify=timings["verify"], **timings["chunk_start1792"])


FLASH_SHAPES = {"llama-350m": dict(B=4, H=16, Hkv=16, T=2048, D=64),
                "llama-1b": dict(B=1, H=16, Hkv=4, T=2048, D=128)}
# The RoPE-free kernels (sdpa's claim): NanoGPT-124M's attention at the
# nano_train shape, llama-1b's GQA heads, causal and full, and ViT-B/16's at
# vit_train's (B=64, T=197 = 196 patches + the class token, full: two
# 128-row query tiles cover 256 rows, so ~23 % of the tiles' rows are past
# the ragged edge).
PLAIN_FLASH_ROWS = {"nanogpt-124m": (dict(B=8, H=12, Hkv=12, T=1024, D=64), True),
                    "llama-1b": (dict(B=1, H=16, Hkv=4, T=2048, D=128), True),
                    "llama-1b-full": (dict(B=1, H=16, Hkv=4, T=2048, D=128), False),
                    "vit-b16": (dict(B=64, H=12, Hkv=12, T=197, D=64), False)}
# A ragged sweep at ViT's heads, full attention: T of 50, 197 and 257 against
# the 64- and 128-row tiles, each held against the plain versions.
VIT_RAGGED_T = (50, 197, 257)


def flash_inputs(dev, gen, dt, B, H, Hkv, T, D):
    from thunder_tpu_torch.models.litgpt import build_rope_cache

    q = torch.randn(B, H, T, D, device=dev, generator=gen).to(dt)
    k = torch.randn(B, Hkv, T, D, device=dev, generator=gen).to(dt)
    v = torch.randn(B, Hkv, T, D, device=dev, generator=gen).to(dt)
    do = torch.randn(B, H, T, D, device=dev, generator=gen).to(dt)
    cos, sin = build_rope_cache(T, D, 10000, torch.float32, dev)
    return q, k, v, cos, sin, do


def flash_err(got, want) -> tuple[float, float]:
    """(max abs error, max of |got - want| / max(1, |want|))."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), (d / want.float().abs().clamp(min=1.0)).max().item()


# The flash backward's dq, dk and dv are held on three measures, each within
# FLASH_GRAD_TOL: max |err| / max |ref| and ||err||_2 / ||ref||_2 (RING_TOL's
# two), and the worst row's ||err||_2 / ||ref||_2. A gradient is ~4 in the
# first causal rows and ~0.03 past a few hundred keys, so KERNEL_TOL's
# absolute 2e-2 below 1, or a bar scaled by the tensor alone, would pass a
# kernel that dropped some keys' share of late rows; the row measure does
# not (tests/test_torch_kernels.py plants such faults in the plain version).
# 2^-6 is 8 bf16 ulps: the kernels round p and ds to bf16 before their
# products, the plain versions do not (at most 6.9e-3 on the CPU at the card
# tests' shapes). A reference or row whose largest element or rms is below
# FLASH_GRAD_FLOOR is held at that scale: where one key carries almost all
# of a row's P, dS = P·(dP - delta) is f32 rounding noise (~1e-6), as in a
# causal row 0 (at a floor of 2^-10 an H100 read such an f32 row of dq at
# 2.3e-4 here). KERNEL_TOL's elementwise bar holds as well.
FLASH_GRAD_TOL = {"bfloat16": 2.0 ** -6, "float32": 1e-4}
FLASH_GRAD_FLOOR = 2.0 ** -6
# The flash forwards' o is held on grad_err's three measures at
# FLASH_GRAD_TOL and lse on max |err| at FLASH_LSE_TOL, beside KERNEL_TOL: a
# late causal row of o is ~0.02 and lse ~8, so KERNEL_TOL alone passes a
# kernel that drops a 64-key tile (lse moves ~0.03). lse sums f32 exp2s of
# the same scores as the plain version's logsumexp (the kernels rope q and
# k with the plain version's roundings): an H100 read at most 1.9e-6 in
# bf16, fp16 and f32 at the card tests' and these shapes, the CPU's planted
# test 9.5e-7; 2^-12 is ~128x that (tests/test_torch_kernels.py plants the
# faults).
FLASH_LSE_TOL = 2.0 ** -12


def grad_err(got, want) -> list[float]:
    """[max |err|, max |err| / max |ref|, ||err||_2 / ||ref||_2, the worst
    row's ||err||_2 / ||ref||_2], each reference measure at least
    FLASH_GRAD_FLOOR's (its rms for a norm)."""
    d, w = got.float() - want.float(), want.float()
    rows = d.norm(dim=-1) / w.norm(dim=-1).clamp(min=FLASH_GRAD_FLOOR * w.shape[-1] ** 0.5)
    return [d.abs().max().item(), d.abs().max().item() / max(w.abs().max().item(), FLASH_GRAD_FLOOR),
            d.norm().item() / max(w.norm().item(), FLASH_GRAD_FLOOR * w.numel() ** 0.5),
            rows.max().item()]


class FlashKernels:
    """One flash pair's calls over flash_inputs' tuple (q, k, v, cos, sin,
    do): with RoPE, flash_rope_attention(_backward); without, the sdpa
    claim's flash_attention(_backward), which take no cos/sin."""

    def __init__(self, cudaex, rope: bool, causal: bool):
        self.c, self.rope, self.causal = cudaex, rope, causal

    def fwd_args(self, a):
        return a[:5] if self.rope else a[:3]

    def bwd_args(self, a, o, lse):
        q, k, v, cos, sin, do = a
        return (q, k, v, o, lse, cos, sin, do) if self.rope else (q, k, v, o, lse, do)

    def fwd(self, *a):
        f = self.c.flash_rope_attention if self.rope else self.c.flash_attention
        return f(*a, self.causal)

    def fwd_plain(self, *a):
        f = self.c.flash_rope_attention_plain if self.rope else self.c.flash_attention_plain
        return f(*a, self.causal)

    def bwd(self, *a):
        f = self.c.flash_rope_attention_backward if self.rope else self.c.flash_attention_backward
        return f(*a, self.causal)

    def bwd_plain(self, *a):
        f = (self.c.flash_rope_attention_backward_plain if self.rope
             else self.c.flash_attention_backward_plain)
        return f(*a, self.causal)

    def library_inputs(self, a):
        """SDPA's inputs: q and k roped beforehand for the RoPE pair."""
        q, k, v, cos, sin, do = a
        if self.rope:
            q = self.c._rope_plain(q.float(), cos, sin).to(q.dtype)
            k = self.c._rope_plain(k.float(), cos, sin).to(k.dtype)
        return q.clone().requires_grad_(), k.clone().requires_grad_(), v.clone().requires_grad_(), do


def check_flash(cudaex, dev, gen, rope: bool = True) -> tuple[dict, dict]:
    """The flash pair (with RoPE: flash_rope_fwd/bwd at FLASH_SHAPES, causal;
    without: flash_fwd/bwd at PLAIN_FLASH_ROWS) against its plain versions
    in bf16 and f32 (o, lse, dq, dk and dv within KERNEL_TOL; o, dq, dk
    and dv within FLASH_GRAD_TOL on grad_err's three measures, lse within
    FLASH_LSE_TOL, each printed),
    then timed in bf16 beside SDPA and its autograd backward."""
    name = "flash_rope" if rope else "flash"
    rows = ({label: (shp, True) for label, shp in FLASH_SHAPES.items()} if rope else PLAIN_FLASH_ROWS)
    res = {"fwd": {"errs": [], "cases": [], "timing": {}},
           "bwd": {"errs": [], "cases": [], "timing": {}}}
    for label, (shp, causal) in rows.items():
        fk = FlashKernels(cudaex, rope, causal)
        for dt in (torch.bfloat16, torch.float32):
            a = flash_inputs(dev, gen, dt, **shp)
            o, lse = fk.fwd(*fk.fwd_args(a))
            grads = fk.bwd(*fk.bwd_args(a, o, lse))
            torch.cuda.synchronize()
            ro, rlse = fk.fwd_plain(*fk.fwd_args(a))
            fwd = [flash_err(o, ro), flash_err(lse, rlse)]
            o_err, lse_err = grad_err(o, ro), (lse - rlse).abs().max().item()
            del ro, rlse
            ref = fk.bwd_plain(*fk.bwd_args(a, o, lse))
            bwd = {n: grad_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
            bwd_max1 = max(flash_err(g, r)[1] for g, r in zip(grads, ref))
            del ref, grads
            torch.cuda.empty_cache()
            err = max(e[0] for e in fwd)
            scaled = max(e[1] for e in fwd)
            res["fwd"]["errs"].append(err)
            res["fwd"].setdefault("label_errs", {}).setdefault(label, []).append(err)
            res["fwd"]["cases"].append({"shape": label, "dtype": dname(dt), "max_abs_err": err,
                                        "max_err_over_max1": scaled, "o": o_err, "lse": lse_err,
                                        "tolerance": FLASH_GRAD_TOL[dname(dt)],
                                        "lse_tolerance": FLASH_LSE_TOL})
            if (not scaled <= KERNEL_TOL[dname(dt)] or not max(o_err[1:]) <= FLASH_GRAD_TOL[dname(dt)]
                    or not lse_err <= FLASH_LSE_TOL):
                raise AssertionError(f"{name}_fwd {label} {dt}: errors {scaled}, o {o_err}, lse {lse_err}")
            err = max(e[0] for e in bwd.values())
            res["bwd"]["errs"].append(err)
            res["bwd"].setdefault("label_errs", {}).setdefault(label, []).append(err)
            res["bwd"]["cases"].append({"shape": label, "dtype": dname(dt), "max_abs_err": err,
                                        "max_err_over_max1": bwd_max1,
                                        "tolerance": FLASH_GRAD_TOL[dname(dt)], **bwd})
            if (not max(max(e[1:]) for e in bwd.values()) <= FLASH_GRAD_TOL[dname(dt)]
                    or not bwd_max1 <= KERNEL_TOL[dname(dt)]):
                raise AssertionError(f"{name}_bwd {label} {dt}: errors {bwd}, {bwd_max1}")
    for label, (shp, causal) in rows.items():
        fk = FlashKernels(cudaex, rope, causal)
        B, H, Hkv, T, D = (shp[x] for x in ("B", "H", "Hkv", "T", "D"))
        qb, kvb = B * H * T * D * 2, B * Hkv * T * D * 2
        fwd_ops = 4 * B * H * T * T * D / (2 if causal else 1)
        cs_bytes = 2 * T * D * 4 if rope else 0
        fwd_bytes = 2 * qb + 2 * kvb + B * H * T * 4 + cs_bytes
        bwd_bytes = 4 * qb + 4 * kvb + B * H * T * 4 + cs_bytes
        sets = copies(lambda: flash_inputs(dev, gen, torch.bfloat16, **shp), 2 * qb + 2 * kvb)
        outs = [fk.fwd(*fk.fwd_args(a)) for a in sets]
        bsets = [fk.bwd_args(a, o, lse) for a, (o, lse) in zip(sets, outs)]
        pre = [fk.library_inputs(a) for a in sets]
        gqa = H != Hkv

        def lib_fwd(q, k, v, do):
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                    enable_gqa=gqa)

        def lib_fwd_bwd(q, k, v, do):
            return torch.autograd.grad(lib_fwd(q, k, v, do), (q, k, v), do)

        for kind, ops, nbytes, fn, plain, bs in (
                ("fwd", fwd_ops, fwd_bytes, fk.fwd, fk.fwd_plain, [fk.fwd_args(a) for a in sets]),
                ("bwd", 2.5 * fwd_ops, bwd_bytes, fk.bwd, fk.bwd_plain, bsets)):
            b, by = bound_ms(nbytes, ops, "bfloat16")
            ms, eager = cuda_ms(fn, bs, iters=50)
            plain_ms, plain_eager = cuda_ms(plain, bs[:1], iters=5)
            torch.cuda.empty_cache()
            res[kind]["timing"][label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                              eager_ms=eager, plain_eager_ms=plain_eager)
        # the library's backward: its forward + autograd backward, less its forward
        lf, lf_eager = cuda_ms(lib_fwd, pre, iters=50)
        lfb, lfb_eager = cuda_ms(lib_fwd_bwd, pre, iters=50)
        res["fwd"]["timing"][label].update(library_ms=lf, library_eager_ms=lf_eager)
        res["bwd"]["timing"][label].update(library_ms=lfb - lf, library_fwd_bwd_ms=lfb,
                                           library_eager_ms=lfb_eager - lf_eager)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = cudaex.flash_forward_plan(B, H, Hkv, T, D, torch.bfloat16, rope=rope, sms=sms)
        res["fwd"]["timing"][label].update(tiles=plan["tiles"], blocks=plan["blocks"],
                                           scratch_bytes=plan["scratch_bytes"])
        plan = cudaex.flash_backward_plan(B, H, Hkv, T, D, torch.bfloat16, rope=rope)
        res["bwd"]["timing"][label].update(blocks=plan["blocks"], scratch_bytes=plan["scratch_bytes"])
        del sets, outs, bsets, pre
        torch.cuda.empty_cache()
    main = "llama-350m" if rope else "nanogpt-124m"
    shape = ("B=4 H=16 T=2048 D=64 causal bf16 (llama-350m)" if rope
             else "B=8 H=12 T=1024 D=64 causal bf16 (nanogpt-124m)")
    out = {}
    for kind in ("fwd", "bwd"):
        emit("kernels", kernel=f"{name}_{kind}", cases=res[kind]["cases"],
             timing_bf16=res[kind]["timing"],
             errs_are="[max abs, max/max|ref|, l2/l2 ref, worst row l2/l2 ref]")
        out[kind] = dict(max_abs_err=max(res[kind]["errs"]), shape=shape, **res[kind]["timing"][main])
        # every row with its own error, for the kernels line
        out[kind]["rows"] = {label: dict(max_abs_err=max(res[kind]["label_errs"][label]), **timing)
                             for label, timing in res[kind]["timing"].items()}
    return out["fwd"], out["bwd"]


def check_flash_ragged(cudaex, dev, gen) -> dict:
    """The RoPE-free flash pair at ViT's heads (H=12, D=64), full attention,
    B=2, over VIT_RAGGED_T, in bf16 and f32: o, lse, dq, dk, dv against the
    plain versions at check_flash's bars (KERNEL_TOL; FLASH_GRAD_TOL on
    grad_err's measures; lse at FLASH_LSE_TOL)."""
    fk = FlashKernels(cudaex, False, False)
    cases = []
    for T in VIT_RAGGED_T:
        for dt in (torch.bfloat16, torch.float32):
            a = flash_inputs(dev, gen, dt, B=2, H=12, Hkv=12, T=T, D=64)
            o, lse = fk.fwd(*fk.fwd_args(a))
            grads = fk.bwd(*fk.bwd_args(a, o, lse))
            ro, rlse = fk.fwd_plain(*fk.fwd_args(a))
            ref = fk.bwd_plain(*fk.bwd_args(a, o, lse))
            o_err, lse_err = grad_err(o, ro), (lse - rlse).abs().max().item()
            bwd = {n: grad_err(g, r) for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
            scaled = max(flash_err(o, ro)[1], flash_err(lse, rlse)[1],
                         *(flash_err(g, r)[1] for g, r in zip(grads, ref)))
            tol = FLASH_GRAD_TOL[dname(dt)]
            case = dict(T=T, dtype=dname(dt), o=o_err, lse=lse_err, max_err_over_max1=scaled, tolerance=tol,
                        **bwd)
            cases.append(case)
            if (not scaled <= KERNEL_TOL[dname(dt)] or not max(o_err[1:]) <= tol or not lse_err <= FLASH_LSE_TOL
                    or not max(max(e[1:]) for e in bwd.values()) <= tol):
                raise AssertionError(f"flash ragged full attention T={T} {dt}: {case}")
    emit("kernels", kernel="flash_ragged_full", shape="B=2 H=12 D=64 full", cases=cases,
         errs_are="[max abs, max/max|ref|, l2/l2 ref, worst row l2/l2 ref]")
    return {"cases": cases}


# Fused cross-entropy: NanoGPT-124M's LM head at the nano_eval shape (B·T =
# 8192 rows of V = 50304) in bf16 (autocast's logits) and f32, and llama's
# (V = 32000) in bf16; every 97th row at ignore_index.
XENT_SHAPES = {"nanogpt-124m": (8192, 50304, (torch.bfloat16, torch.float32)),
               "llama": (8192, 32000, (torch.bfloat16,))}


def xent_inputs(dev, gen, dt, N, V):
    logits = (2 * torch.randn(N, V, device=dev, generator=gen)).to(dt)
    tgt = torch.randint(0, V, (N,), device=dev, generator=gen)
    tgt[::97] = -100
    return logits, tgt


def check_xent(cudaex, dev, gen) -> dict:
    """cross_entropy (loss and lse, f32) against its plain version, then
    timed beside F.cross_entropy(reduction="none") on the same logits."""
    cases, timing = [], {}
    F = torch.nn.functional
    for label, (N, V, dts) in XENT_SHAPES.items():
        for dt in dts:
            logits, tgt = xent_inputs(dev, gen, dt, N, V)
            loss, lse = cudaex.cross_entropy(logits, tgt)
            torch.cuda.synchronize()
            rloss, rlse = cudaex.cross_entropy_plain(logits, tgt)
            errs = [flash_err(loss, rloss), flash_err(lse, rlse)]
            del logits, rloss, rlse
            torch.cuda.empty_cache()
            err, scaled = max(e[0] for e in errs), max(e[1] for e in errs)
            key = f"{label} {dname(dt)}"
            cases.append({"shape": f"N={N} V={V}", "case": key, "max_abs_err": err,
                          "max_err_over_max1": scaled})
            if not scaled <= KERNEL_TOL["float32"]:
                raise AssertionError(f"cross_entropy {key}: error {scaled}")
            nbytes = N * V * dt.itemsize + N * 8 + 2 * N * 4
            b, by = bound_ms(nbytes, 5 * N * V, "float32")  # scale, max, subtract, exp2, add
            sets = copies(lambda: xent_inputs(dev, gen, dt, N, V), N * V * dt.itemsize)
            ms, eager = cuda_ms(cudaex.cross_entropy, sets, iters=50)
            plain_ms, plain_eager = cuda_ms(cudaex.cross_entropy_plain, sets[:1], iters=5)
            lib_ms, lib_eager = cuda_ms(lambda lg, t: F.cross_entropy(lg, t, reduction="none"), sets, iters=50)
            timing[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, eager_ms=eager,
                               plain_eager_ms=plain_eager, library_ms=lib_ms, library_eager_ms=lib_eager)
            del sets
            torch.cuda.empty_cache()
    emit("kernels", kernel="cross_entropy", cases=cases, timing=timing)
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                shape="N=8192 V=50304 bf16 (nanogpt-124m)", **timing["nanogpt-124m bfloat16"])


# Llama-3-1B's decode linears (N, K): the attention's qkv and proj, the MLP's
# fc_1 / fc_2 and proj, and lm_head.
QUANT_SHAPES = {"attn": (3072, 2048), "attn_proj": (2048, 2048), "fc_1": (8192, 2048),
                "fc_2": (8192, 2048), "mlp_proj": (2048, 8192), "lm_head": (128256, 2048)}
# The cases of the kernels phase (label, M, N, K): every decode shape at the
# serving paths' batch (int8: quant_serve's 8; NF4: nf4_inference's 4), and
# prefill buckets on the wgmma route (quant_serve's 256 and 512; NF4 at the
# largest bucket the checker claims).
QUANT_CASES = {
    "int8": [(label, 8, N, K) for label, (N, K) in QUANT_SHAPES.items()]
    + [("fc_1_prefill512", 512, *QUANT_SHAPES["fc_1"]), ("attn_prefill256", 256, *QUANT_SHAPES["attn"]),
       ("mlp_proj_prefill256", 256, *QUANT_SHAPES["mlp_proj"])],
    "nf4": [(label, 4, N, K) for label, (N, K) in QUANT_SHAPES.items()]
    + [("fc_1_prefill512", 512, *QUANT_SHAPES["fc_1"]), ("mlp_proj_train512", 512, *QUANT_SHAPES["mlp_proj"])],
}
# quant_train's frozen linears (M = 512): x reaches them in f32 (the f32
# norm's output, the f32 MLP product), so they run the split route; timed in
# f32 too, and at fc_1's decode (the f32 agreement phases' decode: int8 M=8
# on the split route, NF4 M=4 on the FMA kernel, route fma)
QUANT_F32_TIMED = {"int8": ("fc_1_prefill512", "fc_1"), "nf4": ("mlp_proj_train512", "fc_1")}
# The split route's bf16 products (f32 x): int8 x0, x1, x2 against the
# codes; NF4 the six x_i · w_j with i + j <= 2 (csrc/weight_only_linear.cuh)
QUANT_SPLIT_PASSES = {"int8": 3, "nf4": 6}
# the split route's two kernels: x's pieces, then the product
QUANT_SPLIT_STAGES = ("split_x_kernel", "wgmma_kernel")


def quant_plan(cudaex, kind: str, M: int, N: int, K: int) -> dict:
    """The bf16 route weight_only_plan takes at this shape, as printed."""
    p = cudaex.weight_only_plan(kind, M, N, K, torch.bfloat16)
    return {k: p[k] for k in ("route", "rows", "tile_m", "splits", "units_per_split", "grid", "blocks", "stages")}


def int8_inputs(dev, gen, dt, M, N, K):
    x = torch.randn(M, K, device=dev, generator=gen).to(dt)
    q = torch.randint(-127, 128, (N, K), device=dev, generator=gen, dtype=torch.int8)
    s = torch.rand(N, device=dev, generator=gen) * 5e-4 + 1e-4
    return x, q, s


def nf4_inputs(dev, gen, dt, M, N, K, quantized: bool):
    """x and kernel-layout NF4 weights: quantized from a normal weight (the
    checks), or random codes and absmax of the same bytes (the timing)."""
    from thunder_tpu_torch.transforms.quantization import pack_nf4_kernel_layout, quantize_nf4

    x = torch.randn(M, K, device=dev, generator=gen).to(dt)
    if quantized:
        w = torch.randn(N, K, device=dev, generator=gen) * 0.02
        return (x, *pack_nf4_kernel_layout(*quantize_nf4(w), (N, K)))
    pk = torch.randint(0, 256, (N, K // 2), device=dev, generator=gen, dtype=torch.uint8)
    ak = torch.rand(N, K // 64, device=dev, generator=gen) * 0.05 + 1e-3
    return x, pk, ak


def quant_work(kind: str, M: int, N: int, K: int, itemsize: int = 2) -> tuple[float, float]:
    """(bytes, operations) of one weight-only linear: the weights in their
    stored form (int8 + f32 scales; NF4 codes + f32 absmax) and x read once,
    y written once (x's dtype, bf16 unless named); 2·M·N·K operations."""
    w = N * K + 4 * N if kind == "int8" else N * K // 2 + 4 * N * K // 64
    return w + itemsize * (M * K + M * N), 2.0 * M * N * K


def quant_split_bound(kind: str, nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, by) of the split route's own work: QUANT_SPLIT_PASSES x 2MNK
    bf16 operations at 989 TFLOP/s ("bf16 split operations"), or the bytes
    where those take longer. A route that did 2MNK in f32 FMAs would be held
    to bound_ms(..., "float32") instead, which the split route beats."""
    b, by = bound_ms(nbytes, QUANT_SPLIT_PASSES[kind] * ops, "bfloat16")
    return b, "bf16 split operations" if by == "operations" else by


def count_routes(*fns) -> None:
    """Sets each weight-only wrapper's launches and launches by route to 0
    (the route dict in place: CUDA-graph replays add to it)."""
    for fn in fns:
        fn.launches = 0
        for route in fn.routes:
            fn.routes[route] = 0


def check_quant(cudaex, dev, gen, kind: str) -> dict:
    """int8_linear or nf4_linear against its plain version at QUANT_CASES'
    shapes in bf16 and f32, then timed in bf16 beside its bound, its plain
    version, the library call where the card's PyTorch has one (int8:
    torch._weight_int8pack_mm) and, as a side yardstick, a bf16 torch.matmul
    against weights dequantized beforehand. Each shape's bf16 route, K
    splits and blocks (cudaex.weight_only_plan) are printed with it."""
    from thunder_tpu_torch.transforms.quantization import dequantize_nf4_kl

    fn, plain = ((cudaex.int8_linear, cudaex.int8_linear_plain) if kind == "int8"
                 else (cudaex.nf4_linear, cudaex.nf4_linear_plain))
    M0 = 8 if kind == "int8" else 4
    shapes = QUANT_CASES[kind]

    def make(dt, M, N, K, real=True):
        if kind == "int8":
            return int8_inputs(dev, gen, dt, M, N, K)
        return nf4_inputs(dev, gen, dt, M, N, K, real)

    errs, cases = [], []
    for label, M, N, K in shapes:
        for dt in (torch.bfloat16, torch.float32):
            args = make(dt, M, N, K)
            out = fn(*args)
            torch.cuda.synchronize()
            err, scaled = flash_err(out, plain(*args))
            errs.append(err)
            plan = cudaex.weight_only_plan(kind, M, N, K, dt)
            cases.append({"shape": label, "M": M, "N": N, "K": K, "dtype": dname(dt), "max_abs_err": err,
                          "max_err_over_max1": scaled, "route": plan["route"], "tile_m": plan["tile_m"],
                          "splits": plan["splits"]})
            if not scaled <= KERNEL_TOL[dname(dt)]:
                raise AssertionError(f"{kind}_linear {label} {dt}: error {scaled}")
            del args, out
    torch.cuda.empty_cache()

    lib_ok = None
    timings = {}
    for label, M, N, K in shapes:
        nbytes, ops = quant_work(kind, M, N, K)
        b, by = bound_ms(nbytes, ops, "bfloat16")
        sets = copies(lambda: make(torch.bfloat16, M, N, K, False), nbytes)
        ms, eager = cuda_ms(fn, sets)
        plain_ms, plain_eager = cuda_ms(plain, sets[:1], iters=10)
        lib_ms = lib_eager = None
        if kind == "int8":
            if lib_ok is None:  # does this PyTorch run the library call on the card?
                try:
                    x, q, sc = sets[0]
                    torch._weight_int8pack_mm(x, q, sc.to(x.dtype))
                    torch.cuda.synchronize()
                    lib_ok = True
                except (RuntimeError, NotImplementedError) as e:
                    lib_ok = False
                    lib_error = str(e).splitlines()[0][:160]
            if lib_ok:
                lsets = [(x, q, sc.to(x.dtype)) for x, q, sc in sets]
                lib_ms, lib_eager = cuda_ms(torch._weight_int8pack_mm, lsets)
                del lsets
        # the side yardstick: bf16 weights, dequantized before the timing
        if kind == "int8":
            wsets = [(x, (q.to(torch.bfloat16) * sc.to(torch.bfloat16)[:, None]))
                     for x, q, sc in copies(lambda: make(torch.bfloat16, M, N, K), 2 * N * K)]
        else:
            wsets = [(x, dequantize_nf4_kl(pk, ak, (N, K)).to(torch.bfloat16))
                     for x, pk, ak in copies(lambda: make(torch.bfloat16, M, N, K, False), 2 * N * K)]
        mm_ms, mm_eager = cuda_ms(lambda x, w: torch.matmul(x, w.t()), wsets)
        timings[label] = dict(M=M, N=N, K=K, plan=quant_plan(cudaex, kind, M, N, K), ms=ms, plain_ms=plain_ms,
                              library_ms=lib_ms,
                              bound_ms=b, bound_by=by, eager_ms=eager, plain_eager_ms=plain_eager,
                              library_eager_ms=lib_eager, bf16_matmul_dequantized_ms=mm_ms,
                              bf16_matmul_dequantized_eager_ms=mm_eager, bytes=nbytes, operations=ops,
                              fraction_of_bound=b / ms)
        del sets, wsets
        torch.cuda.empty_cache()
    timings_f32 = {}
    for label, M, N, K in shapes:
        if label not in QUANT_F32_TIMED[kind]:
            continue
        nbytes, ops = quant_work(kind, M, N, K, itemsize=4)
        plan = cudaex.weight_only_plan(kind, M, N, K, torch.float32)
        b, by = (quant_split_bound(kind, nbytes, ops) if plan["route"] == "split"
                 else bound_ms(nbytes, ops, "float32"))
        sets = copies(lambda: make(torch.float32, M, N, K, False), nbytes)
        ms, eager = cuda_ms(fn, sets)
        plain_ms, _ = cuda_ms(plain, sets[:1], iters=10)
        timings_f32[label] = dict(M=M, N=N, K=K, route=plan["route"], tile_m=plan["tile_m"], splits=plan["splits"],
                                  blocks=plan["blocks"], ms=ms, eager_ms=eager, plain_ms=plain_ms, bound_ms=b,
                                  bound_by=by, fraction_of_bound=b / ms,
                                  f32_fma_bound_ms=bound_ms(nbytes, ops, "float32")[0],
                                  tflops=ops / ms / 1e9)
        if plan["route"] == "split":  # the pieces' pass and the product, each
            timings_f32[label]["device_ms_by_kernel"] = kernel_ms(fn, sets, QUANT_SPLIT_STAGES)
        del sets
        torch.cuda.empty_cache()
    extra = {"timing_f32": timings_f32}
    if kind == "int8":
        extra["library"] = ("torch._weight_int8pack_mm" if lib_ok
                            else f"none: torch._weight_int8pack_mm on the card raised: {lib_error}")
    else:
        extra["library"] = "none: no one PyTorch call computes an NF4 linear"
    emit("kernels", kernel=f"{kind}_linear", cases=cases, timing_bf16=timings, **extra)
    N, K = QUANT_SHAPES["fc_1"]
    return dict(max_abs_err=max(errs), shape=f"fc_1 M={M0} N={N} K={K} bf16 (Llama-3-1B decode)",
                lm_head=timings["lm_head"], timing_f32=timings_f32, **timings["fc_1"])


# llama-350m's linears (N, K) at the train path's M = B·T = 8192 rows: the
# attention's qkv and proj, the MLP's fc_1 (fc_2 has its shape) and proj, and
# lm_head. Under bf16 autocast x reaches them in f32 (after an f32 norm or the
# f32 MLP product), all but proj (the attention's bf16 output); the master
# weights in f32. FP8_SWEEP_K: the K sweep (N = 1024) the y tolerance rests on.
FP8_M = 8192
FP8_SHAPES = {"attn": (3072, 1024), "proj": (1024, 1024), "fc_1": (2816, 1024),
              "mlp_proj": (1024, 2816), "lm_head": (32000, 1024)}
FP8_PATH_X = {"attn": torch.float32, "proj": torch.bfloat16, "fc_1": torch.float32,
              "mlp_proj": torch.float32, "lm_head": torch.float32}
FP8_SWEEP_K = (1024, 2816, 4096)
# y of the fp8 kernel against its plain version, |err| / max(1, |plain|). Both
# sum the same exact e4m3 products in f32, in another order (the kernel adds
# each 32-deep tensor-core product into its f32 sums): f32 y differs by f32
# rounding, 7.7e-7 of |y| at K = 2816 and 1.1e-6 at K = 4096 on an H100 (the
# sweep prints each K); 1e-5 leaves room. bf16 y: one rounding to bf16, one ulp
# (2^-8 relative) where the f32 sums straddle a rounding boundary.
FP8_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# csrc/fp8_linear.cu's two kernels: the quantize pass and the product
FP8_STAGES = ("fp8_linear_quantize", "fp8_linear_core")


def fp8_inputs(dev, gen, dt, M, N, K):
    """x (M, K) in dt, an f32 master weight w (N, K) at llama's init scale,
    and delayed scales from the operands' amaxes (f32 scalars on the card)."""
    x = torch.randn(M, K, device=dev, generator=gen).to(dt)
    w = torch.randn(N, K, device=dev, generator=gen) * 0.02
    sx = torch.full((), 448.0, device=dev) / x.float().abs().amax()
    sw = torch.full((), 448.0, device=dev) / w.abs().amax()
    return x, w, sx, sw


def fp8_work(M: int, N: int, K: int, x_itemsize: int) -> tuple[float, float]:
    """(bytes, operations) of one fp8 linear on the training path: x and the
    f32 w read once, y (x's dtype) and the e4m3 codes xq, wq written once;
    2·M·N·K operations at the fp8 rate."""
    return (M * K * x_itemsize + N * K * 4 + M * N * x_itemsize + M * K + N * K), 2.0 * M * N * K


def check_fp8(cudaex, dev, gen) -> dict:
    """fp8_linear against its plain version at llama-350m's five linear
    shapes and the K sweep, x in bf16 and f32: the codes and amaxes must be
    equal, y within FP8_TOL. Then timed at every shape and dtype beside its
    bound, its plain version and two side yardsticks (no one PyTorch call
    quantizes, multiplies and reduces the amaxes): a bf16 torch.matmul of x
    and w, and torch._scaled_mm on operands quantized beforehand. The
    backward's two products (transforms/fp8_training.py:_fp8_mm, the route
    the path runs) are timed at each shape too."""
    from thunder_tpu_torch.transforms import fp8_training as fp8

    shapes = dict(FP8_SHAPES, sweep_k4096=(1024, 4096))
    cases, errs, sweep = [], [], {}
    for label, (N, K) in shapes.items():
        for dt in (torch.bfloat16, torch.float32):
            x, w, sx, sw = fp8_inputs(dev, gen, dt, FP8_M, N, K)
            y, xq, wq, ax, aw = cudaex.fp8_linear(x, w, sx, sw, save_quantized=True)
            torch.cuda.synchronize()
            ry, rxq, rwq, rax, raw = cudaex.fp8_linear_plain(x, w, sx, sw, save_quantized=True)
            codes = (torch.equal(xq.view(torch.uint8), rxq.view(torch.uint8))
                     and torch.equal(wq.view(torch.uint8), rwq.view(torch.uint8)))
            amax = ax.item() == rax.item() and aw.item() == raw.item()
            err, scaled = flash_err(y, ry)
            errs.append(err)
            cases.append({"shape": label, "M": FP8_M, "N": N, "K": K, "x": dname(dt), "codes_equal": codes,
                          "amax_equal": amax, "max_abs_err": err, "max_err_over_max1": scaled})
            if N == 1024:
                sweep.setdefault(K, {})[dname(dt)] = scaled
            if not (codes and amax and scaled <= FP8_TOL[dname(dt)]):
                raise AssertionError(f"fp8_linear {label} {dt}: codes {codes}, amax {amax}, error {scaled}")
            del x, w, y, xq, wq, ry, rxq, rwq
            torch.cuda.empty_cache()

    timing = {}
    for label, (N, K) in FP8_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            M = FP8_M
            nbytes, ops = fp8_work(M, N, K, dt.itemsize)
            b, by = bound_ms(nbytes, ops, "float8")
            sets = copies(lambda: fp8_inputs(dev, gen, dt, M, N, K), M * K * dt.itemsize + N * K * 4)
            ms, eager = cuda_ms(lambda *a: cudaex.fp8_linear(*a, save_quantized=True), sets, iters=50)
            plain_ms, _ = cuda_ms(lambda *a: cudaex.fp8_linear_plain(*a, save_quantized=True), sets[:1],
                                  iters=5)
            # side yardsticks on operands prepared beforehand
            q = [cudaex.fp8_linear(*a, save_quantized=True) for a in sets]
            pre = [(xq, wq, 1.0 / sx, 1.0 / sw) for (x, w, sx, sw), (_, xq, wq, _, _) in zip(sets, q)]
            smm_ms, _ = cuda_ms(lambda xq, wq, isx, isw: torch._scaled_mm(
                xq, wq.t(), scale_a=isx, scale_b=isw, out_dtype=dt, use_fast_accum=False), pre)
            mm_sets = [(x.to(torch.bfloat16), w.to(torch.bfloat16)) for x, w, _, _ in sets]
            mm_ms, _ = cuda_ms(lambda x, w: torch.matmul(x, w.t()), mm_sets)
            del mm_sets
            gq = [(torch.randn(M, N, device=dev, generator=gen) * 1e-3).to(torch.float8_e5m2) for _ in pre]
            dx_ms, _ = cuda_ms(fp8._fp8_mm, [(g, wq) for g, (_, wq, _, _) in zip(gq, pre)], iters=50)
            dw_ms, _ = cuda_ms(lambda g, xq: fp8._fp8_mm(g.t(), xq),
                               [(g, xq) for g, (xq, _, _, _) in zip(gq, pre)], iters=50)
            stages = kernel_ms(lambda *a: cudaex.fp8_linear(*a, save_quantized=True), sets, FP8_STAGES)
            timing.setdefault(label, {})[dname(dt)] = dict(
                M=M, N=N, K=K, ms=ms, eager_ms=eager, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=None, fraction_of_bound=b / ms, bytes=nbytes, operations=ops,
                device_ms_by_stage=stages, scaled_mm_prequantized_ms=smm_ms, bf16_matmul_ms=mm_ms,
                backward_dx_ms=dx_ms, backward_dw_ms=dw_ms)
            del sets, q, pre, gq
            torch.cuda.empty_cache()
    emit("kernels", kernel="fp8_linear", cases=cases, k_sweep=sweep, tolerance=FP8_TOL, timing=timing,
         library="none: no one PyTorch call quantizes, multiplies and reduces the amaxes",
         backward_route="torch._scaled_mm (e5m2 x e4m3, f32 out, unit scales, no fast accumulation)")
    N, K = FP8_SHAPES["attn"]
    return dict(max_abs_err=max(errs), shape=f"attn M={FP8_M} N={N} K={K} x f32, w f32 (llama-350m)",
                timing=timing, **timing["attn"]["float32"])


# The grouped expert MLP at the MoE paths' shapes: E = 8 experts of width
# H = 1024 over Llama-3-1B's D = 2048, top-2. (cap, dtype, group_sizes): the
# engine's decode step (8 slots, drop-free: cap = 8, 16 assignments, one
# expert empty), a 1024-token prefill bucket (cap = 1024, 2048 assignments),
# the train step (N = 2048 at capacity factor 1.0: cap = 512, f32 under
# autocast; experts over capacity are cut to 512, the rest end inside a
# 128-row block), and a cap of 200, which is not a multiple of the kernels'
# 128-row block. cudaex.grouped_mlp_plan routes them: decode to the decode
# route, prefill and cap 200 to the wgmma route, train to the ffma route.
GROUPED_E, GROUPED_D, GROUPED_H = 8, 2048, 1024
# The outputs are far below 1 (max ~0.2, RMS ~0.04 at these init scales), so
# the kernel is held to max |kernel - plain| <= GROUPED_TOL · max |plain|. f32:
# FFMAs against cuBLAS's f32 GEMM, another summation order. bf16: both round
# h and y to bf16 from f32 sums taken in another order, so an output moves by
# at most its own ulp, at most 2^-7 of the largest output; the limit is two
# such ulps (one was measured: 9.8e-4 at a max of ~0.19 on an H100).
GROUPED_TOL = {"bfloat16": 2.0 ** -6, "float32": 1e-4}
GROUPED_SHAPES = {
    "decode": (8, torch.bfloat16, [3, 0, 2, 4, 1, 2, 3, 1]),
    "prefill": (1024, torch.bfloat16, [310, 250, 190, 280, 262, 240, 270, 246]),
    "train": (512, torch.float32, [512, 512, 433, 512, 470, 512, 379, 512]),
    "ragged_cap": (200, torch.bfloat16, [200, 151, 64, 0, 199, 1, 100, 37]),
}


def grouped_inputs(dev, gen, dt, cap, gs):
    """Bins with rows past group_sizes zero (the dispatch scatter's fill) and
    panels at MoEMLP's init scale."""
    E, D, H = GROUPED_E, GROUPED_D, GROUPED_H
    bins = torch.randn(E, cap, D, device=dev, generator=gen)
    bins[torch.arange(cap, device=dev)[None, :] >= torch.tensor(gs, device=dev)[:, None]] = 0.0
    s = 1.0 / math.sqrt(D)
    wg = (torch.rand(E, D, H, device=dev, generator=gen) * 2 - 1) * s
    wu = (torch.rand(E, D, H, device=dev, generator=gen) * 2 - 1) * s
    wd = (torch.rand(E, H, D, device=dev, generator=gen) * 2 - 1) * (s / 2)
    return (bins.to(dt), wg.to(dt), wu.to(dt), wd.to(dt),
            torch.tensor(gs, dtype=torch.int64, device=dev))


def grouped_work(cap, gs, itemsize) -> tuple[float, float]:
    """(bytes, operations) of one grouped MLP call: the live rows of the
    bins and the live experts' three panels read once, y (all cap rows)
    written once; 6·D·H operations a live row (three products)."""
    D, H = GROUPED_D, GROUPED_H
    live = sum(min(n, cap) for n in gs)
    experts = sum(1 for n in gs if n > 0)
    return itemsize * (live * D + experts * 3 * D * H + GROUPED_E * cap * D), 6.0 * live * D * H


def grouped_stages(route: str) -> tuple:
    """csrc/grouped_mlp.cu's gate/up and down kernels of a route
    (cudaex.grouped_mlp_plan), as torch.profiler names them."""
    return (f"grouped_mlp_{route}<true>", f"grouped_mlp_{route}<false>")


def bmm_chain(bins, wg, wu, wd, gs):
    """The side yardstick: the decomposition's library GEMMs over the same
    bins, every row of every bin (it ignores group_sizes)."""
    return torch.bmm(torch.nn.functional.silu(torch.bmm(bins, wg)) * torch.bmm(bins, wu), wd)


def check_grouped(cudaex, dev, gen) -> dict:
    """grouped_mlp against its plain version at GROUPED_SHAPES (max abs
    error within GROUPED_TOL · max |plain|), then timed beside its bound,
    its plain version and the bmm chain."""
    cases, timing = [], {}
    for label, (cap, dt, gs) in GROUPED_SHAPES.items():
        args = grouped_inputs(dev, gen, dt, cap, gs)
        out = cudaex.grouped_mlp(*args)
        torch.cuda.synchronize()
        want = cudaex.grouped_mlp_plain(*args)
        err = (out.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        zero_tail = all(not out[e, n:].any() for e, n in enumerate(gs))
        cases.append({"shape": label, "cap": cap, "dtype": dname(dt), "group_sizes": gs,
                      "max_abs_err": err, "max_abs_plain": scale, "err_over_max_plain": err / scale,
                      "tolerance_over_max_plain": GROUPED_TOL[dname(dt)], "rows_past_group_sizes_zero": zero_tail})
        if not err <= GROUPED_TOL[dname(dt)] * scale or not zero_tail:
            raise AssertionError(f"grouped_mlp {label}: {cases[-1]}")
        del args, out, want
        nbytes, ops = grouped_work(cap, gs, dt.itemsize)
        b, by = bound_ms(nbytes, ops, dname(dt))
        sets = copies(lambda: grouped_inputs(dev, gen, dt, cap, gs), nbytes)
        ms, eager = cuda_ms(cudaex.grouped_mlp, sets)
        plain_ms, plain_eager = cuda_ms(cudaex.grouped_mlp_plain, sets, iters=20)
        bmm_ms, bmm_eager = cuda_ms(bmm_chain, sets, iters=50)
        plan = cudaex.grouped_mlp_plan(GROUPED_E, cap, GROUPED_D, GROUPED_H, dt)
        stages = kernel_ms(cudaex.grouped_mlp, sets, grouped_stages(plan["route"]))
        timing[label] = dict(cap=cap, dtype=dname(dt), ms=ms, plain_ms=plain_ms, library_ms=None,
                             bound_ms=b, bound_by=by, eager_ms=eager, plain_eager_ms=plain_eager,
                             bmm_chain_ms=bmm_ms, bmm_chain_eager_ms=bmm_eager, bytes=nbytes,
                             operations=ops, fraction_of_bound=b / ms, route=plan["route"],
                             gate_grid=plan["gate"]["grid"], down_grid=plan["down"]["grid"],
                             device_ms_by_stage=stages)
        del sets
        torch.cuda.empty_cache()
    emit("kernels", kernel="grouped_mlp", E=GROUPED_E, D=GROUPED_D, H=GROUPED_H, cases=cases, timing=timing,
         library="none: no one PyTorch call computes the grouped SwiGLU MLP; bmm_chain_ms is the "
                 "decomposition's torch.bmm chain over every bin row, a side yardstick",
         peak_ops="bf16 at 989 TFLOP/s (tensor cores); f32 at 67 TFLOP/s (FFMA)")
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases),
                shape=f"decode E=8 cap=8 D=2048 H=1024 bf16 group_sizes {GROUPED_SHAPES['decode'][2]}",
                timing=timing, **timing["decode"])


# ---------------------------------------------------------------------------
# phases 3-5: serve, profile, agreement
# ---------------------------------------------------------------------------


def make_prompts(rng, n, lo, hi, vocab):
    return [rng.randint(0, vocab, (int(rng.randint(lo, hi + 1)),)).astype(np.int32)
            for _ in range(n)]


def serve(tt, cudaex, cfg, prompts, seed) -> dict:
    from thunder_tpu_torch.models.litgpt import GPT
    from thunder_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    gpt = GPT(cfg, torch.bfloat16, seed=seed)
    engine = ServingEngine(gpt, max_batch=8, page_size=16, max_seq=2048, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    # compile and capture the decode program and every prefill bucket the
    # wave will use
    t0 = time.perf_counter()
    engine.warmup([len(p) for p in prompts])
    t_warm = time.perf_counter() - t0

    reset_peak_memory()
    cudaex.rms_norm.launches = 0
    cudaex.paged_attention.launches = 0
    steps0 = engine.decode_steps
    cfns = engine_cfns(engine)
    compiles0, graphs0 = sum(tt.cache_misses(c) for c in cfns), graph_stats(tt, cfns)
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new_tokens=64) for p in prompts]
    engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rms_norm": cudaex.rms_norm.launches,
                "paged_attention": cudaex.paged_attention.launches}
    compiles = sum(tt.cache_misses(c) for c in cfns) - compiles0
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, cfns).items()}
    require_replayed("serve", graphs)
    if compiles or graphs["graph_captures"]:
        raise AssertionError(f"serve: {compiles} compiles and {graphs['graph_captures']} captures during the wave")
    results = [f.result() for f in futs]
    for r, p in zip(results, prompts):
        if r.n_new_tokens != 64 or not ((r.new_tokens >= 0) & (r.new_tokens < cfg.padded_vocab_size)).all():
            raise AssertionError(f"request {r.request_id}: bad stream {r.new_tokens}")
    if engine.cache.allocator.n_used:
        raise AssertionError(f"{engine.cache.allocator.n_used} pages not returned")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    claimed = {b.sym.id for b in tt.last_traces(engine.runner.decode_cfn)[-1].bound_symbols
               if b.impl in (cudaex._rms_impl, cudaex._paged_attention_impl)}
    if claimed != {"torch.nn.functional.rms_norm", "thunder.paged_attention"}:
        raise AssertionError(f"the decode trace's cuda claims are {claimed}")
    n_tok = sum(r.n_new_tokens for r in results)
    # torch calls or kernel launches one program call issues (its executed
    # bound symbols, less frees and the return)
    ops = {name: sum(1 for b in tt.last_traces(cfn)[-1].bound_symbols
                     if b.sym.name not in ("python_del", "python_return"))
           for name, cfn in (("decode", engine.runner.decode_cfn),
                             ("prefill", engine.runner.prefill_cfn))}
    out = dict(model=cfg.name, n_layer=cfg.n_layer, n_embd=cfg.n_embd, dtype="bfloat16",
               requests=len(results), prompt_tokens=int(sum(len(p) for p in prompts)),
               new_tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
               mean_ttft_ms=1e3 * float(np.mean([r.ttft_s for r in results])),
               mean_tbot_ms=1e3 * float(np.mean([r.tbot_s for r in results])),
               decode_steps=engine.decode_steps - steps0,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               init_s=t_init, warmup_compile_s=t_warm, launches=launches,
               ops_per_program_call=ops, compiles_during_wave=compiles,
               captures_during_wave=graphs["graph_captures"], graph_replays=graphs["graph_replays"])
    emit("serve", **out)
    out["sampled"] = sampled_serve(tt, cudaex, engine, prompts, out)
    short = make_prompts(np.random.RandomState(1), 8, 128, 128, cfg.vocab_size)
    prof = profile_wave(engine, [(p, 32, "interactive") for p in short])
    emit("graphs_pdl", cell="serve decode step", **pdl_in_graphs(tt, cudaex, engine))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    serving_pair(tt, cudaex, "serve", lambda g: ServingEngine(gpt, max_batch=8, page_size=16, max_seq=2048,
                                                              dtype=torch.bfloat16, cuda_graphs=g),
                 [(p, 32, "interactive") for p in prompts[:8]])
    del gpt
    torch.cuda.empty_cache()
    return out, prof


def profile_wave(engine, specs, phase: str = "profile") -> dict:
    """Device busy share over a wave of (prompt, max_new_tokens, lane)
    requests, the kernels that took the device time, and the paged
    attention kernels' device ms, in all, by kernel (PAGED_KERNELS: the
    combine serves the decode and the chunk kernels both) and a decode
    step. The wave is profiled twice (profile_twice); the first is read."""
    steps = []

    def run():
        steps0 = engine.decode_steps
        for p, n, lane in specs:
            engine.submit(p, max_new_tokens=n, lane=lane)
        engine.drain()
        steps.append(engine.decode_steps - steps0)

    prof, check = profile_twice(phase, run)
    rows, wall_us = prof["rows"], prof["wall_us"]
    busy_us = sum(r[0] for r in rows)
    steps = steps[0]
    attn_us = sum(us for us, k, _ in rows if any(m in k for m in PAGED_KERNELS))
    by_kernel = {m: sum(us for us, k, _ in rows if m in k) / 1e3 for m in PAGED_KERNELS}
    out = dict(requests=len(specs), wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               idle_share=(1 - busy_us / wall_us) if busy_us else None, decode_steps=steps,
               attention_device_ms=attn_us / 1e3, attention_device_ms_by_kernel=by_kernel,
               attention_device_ms_per_decode_step=attn_us / 1e3 / steps if steps else None,
               device_ms_per_decode_step=busy_us / 1e3 / steps if steps else None,
               top=[{"name": k[:80], "device_ms": us / 1e3, "count": c} for us, k, c in rows[:10]],
               two_profiles=check)
    emit(phase, **out)
    return out


def agreement(cfg, prompts, seed) -> dict:
    from thunder_tpu_torch.inference import GPTInference
    from thunder_tpu_torch.models.litgpt import GPT
    from thunder_tpu_torch.serving import ServingEngine

    gpt = GPT(cfg, torch.float32, seed=seed)
    engine = ServingEngine(gpt, max_batch=8, page_size=16, max_seq=2048, dtype=torch.float32)
    futs = [engine.submit(p, max_new_tokens=64) for p in prompts]
    engine.drain()
    solo = GPTInference(gpt, max_seq=2048, dtype=torch.float32)
    report = []
    for p, f in zip(prompts, futs):
        out, m = solo.generate(torch.from_numpy(p[None, :]), 64)
        row = agree_row(f.result().new_tokens, out[0, len(p):].cpu().numpy(), m.top2_gap[0], len(p))
        report.append(row)
        if not row["equal"] and not row["solo_top2_gap"] < AGREE_GAP:
            emit("agreement", rows=report, tolerance=AGREE_GAP)
            raise AssertionError(f"streams differ: {row}")
    out = dict(rows=report, tolerance=AGREE_GAP, tf32=False)
    emit("agreement", **out)
    return out


def agree_row(got, want, gaps, prompt_len: int) -> dict:
    """One stream against its solo stream under the AGREE_GAP rule: equal,
    or different only after a step whose solo top-2 logit gap is < AGREE_GAP."""
    diff = np.nonzero(got != want)[0]
    row = {"prompt_len": prompt_len, "equal": not len(diff)}
    if len(diff):
        step = int(diff[0])
        row.update(first_diff_step=step, solo_top2_gap=float(gaps[step]))
    return row


# ---------------------------------------------------------------------------
# quant_serve, quant_agreement, nf4_inference
# ---------------------------------------------------------------------------


def weight_bytes(gpt) -> int:
    return sum(p.numel() * p.element_size() for p in gpt.parameters())


def reset_peak_memory() -> None:
    """Free what earlier phases left in reference cycles (engines and their
    programs), so the peak that follows is this phase's own."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


# ---------------------------------------------------------------------------
# CUDA graphs (executors/graphex.py): replay counts and the same-call pairs
# ---------------------------------------------------------------------------

# A same-call pair (ROADMAP ground rule 8) runs captured and op by op in
# turns, twice each: graphs, op by op, op by op, graphs.
PAIR_ROUNDS = (True, False, False, True)
PAIR_TRAIN_STEPS = 4


def graph_stats(tt, cfns) -> dict:
    """CUDA graphs captured and replayed by these programs (jit functions,
    TrainSteps, GPTInference decode programs)."""
    return {"graph_captures": sum(tt.graph_captures(c) for c in cfns),
            "graph_replays": sum(tt.graph_replays(c) for c in cfns)}


def require_replayed(phase: str, stats: dict) -> None:
    """The phase's path ran as CUDA graphs: at least one replay."""
    if not stats["graph_replays"]:
        raise AssertionError(f"{phase}: the path replayed no CUDA graph ({stats})")


def require_same_launches(phase: str, runs: list) -> None:
    """Each kernel launched as often captured as op by op."""
    if any(r["launches"] != runs[0]["launches"] for r in runs):
        raise AssertionError(f"{phase}: launch counts differ between the runs: "
                             f"{[(r['cuda_graphs'], r['launches']) for r in runs]}")


def train_pair(cell: str, step, idx, tgt, counters) -> dict:
    """The same-call pair of a TrainStep: PAIR_TRAIN_STEPS steps a run
    replayed as the step's CUDA graph and run op by op (``step.cuda_graphs``
    set each run: one compiled program), after one step of the same kind;
    wall ms a step (host clock, synchronized) and device busy ms a step
    (profiled over 2 more steps); each counter's launches over the timed
    steps, which must agree across the runs."""
    runs = []
    for graphs in PAIR_ROUNDS:
        step.cuda_graphs = graphs
        step(idx, tgt)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        for _ in range(PAIR_TRAIN_STEPS):
            step(idx, tgt)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / PAIR_TRAIN_STEPS
        launches = {c.__name__: c.launches for c in counters}
        prof = profiled(lambda: [step(idx, tgt) for _ in range(2)])
        runs.append(dict(cuda_graphs=graphs, wall_ms_per_step=wall * 1e3,
                         device_ms_per_step=sum(r[0] for r in prof["rows"]) / 2e3,
                         kernels_per_step=sum(r[2] for r in prof["rows"]) / 2, launches=launches,
                         clock_ratio=prof["clock_ratio"]))
    step.cuda_graphs = True
    require_same_launches(f"graphs {cell}", runs)
    out = dict(cell=cell, steps_a_run=PAIR_TRAIN_STEPS, runs=runs,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("graphs", **out)
    return out


def serving_pair(tt, cudaex, cell: str, make_engine, specs) -> dict:
    """The same-call pair of a serving wave: ``specs`` (prompt, new tokens,
    lane) through an engine whose programs replay CUDA graphs and one that
    runs them op by op (``make_engine(cuda_graphs)``), each warmed by
    ``warmup`` over the wave's prompt lengths; prefix caches cleared before
    every run. tokens/s, mean TTFT and TBOT; the paged kernels' launches
    and the greedy streams, equal across the runs; captures and compiles
    during each wave, 0."""
    engines = {g: make_engine(g) for g in (True, False)}
    for e in engines.values():
        e.warmup(sorted({len(p) for p, _, _ in specs}))
    counters = (cudaex.rms_norm, cudaex.paged_attention, cudaex.paged_chunk_attention)
    runs, streams = [], []
    for graphs in PAIR_ROUNDS:
        e = engines[graphs]
        if e.prefix is not None:
            e.prefix.clear()
        cfns = engine_cfns(e)
        before = graph_stats(tt, cfns)["graph_captures"], sum(tt.cache_misses(c) for c in cfns)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        futs = [e.submit(p, n, lane=lane) for p, n, lane in specs]
        e.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = [f.result() for f in futs]
        after = graph_stats(tt, cfns)["graph_captures"], sum(tt.cache_misses(c) for c in cfns)
        n_tok = sum(r.n_new_tokens for r in res)
        streams.append([r.new_tokens.tolist() for r in res])
        runs.append(dict(cuda_graphs=graphs, tokens_per_s=n_tok / wall,
                         mean_ttft_ms=1e3 * float(np.mean([r.ttft_s for r in res])),
                         mean_tbot_ms=1e3 * float(np.mean([r.tbot_s for r in res])),
                         launches={c.__name__: c.launches for c in counters},
                         captures_during_wave=after[0] - before[0], compiles_during_wave=after[1] - before[1],
                         graph_replays=graph_stats(tt, cfns)["graph_replays"]))
    require_same_launches(f"graphs {cell}", runs)
    if any(r["captures_during_wave"] or r["compiles_during_wave"] for r in runs):
        raise AssertionError(f"graphs {cell}: captures or compiles during a wave after warmup: {runs}")
    out = dict(cell=cell, requests=len(specs), new_tokens=sum(n for _, n, _ in specs), runs=runs,
               streams_equal=all(s == streams[0] for s in streams))
    emit("graphs", **out)
    if not out["streams_equal"]:
        raise AssertionError(f"graphs {cell}: the greedy streams differ between the runs")
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode_graph(cfn):
    """The raw CUDA-graph replay of a jit program's one captured graph."""
    prog = next(e.program for e in cfn._cache.values() if e.program is not None)
    return next(iter(prog._graphs.values())).replay_fn


def pdl_in_graphs(tt, cudaex, engine, reps: int = 100) -> dict:
    """rms_norm's programmatic dependent launch inside a captured decode
    step: the serve engine's decode graph (captured with RMS_PDL_CAPTURED,
    off) beside the same program captured with PDL on (a runner of its own
    on the same weights and pools), each replayed ``reps`` times between
    CUDA events, in turns on, off, off, on; device ms a decode step and the
    difference a launch (33 rms_norm launches a step at Llama-3-1B)."""
    from thunder_tpu_torch.serving.runner import PagedGPTRunner

    B, npm = engine.max_batch, engine.n_pages_max
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=engine.device)  # noqa: E731
    old = cudaex.RMS_PDL_CAPTURED
    cudaex.RMS_PDL_CAPTURED = cudaex.RMS_PDL
    try:
        on_runner = PagedGPTRunner(engine.gpt, page_size=engine.page_size, cuda_graphs=True)
        for _ in range(2):
            _, kps, vps = on_runner.decode_cfn(engine.params, zeros(B, 1), engine.cache.k_pages,
                                               engine.cache.v_pages, zeros(B, npm), zeros(B))
            engine.cache.rebind(kps, vps)
    finally:
        cudaex.RMS_PDL_CAPTURED = old
    n0 = cudaex.rms_norm.launches
    _, kps, vps = engine.runner.decode_cfn(engine.params, zeros(B, 1), engine.cache.k_pages,
                                           engine.cache.v_pages, zeros(B, npm), zeros(B))
    per_step = cudaex.rms_norm.launches - n0
    graphs = {True: decode_graph(on_runner.decode_cfn), False: decode_graph(engine.runner.decode_cfn)}
    times = {True: [], False: []}
    for pdl in PAIR_ROUNDS:
        replay = graphs[pdl]
        replay()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            replay()
        stop.record()
        torch.cuda.synchronize()
        times[pdl].append(start.elapsed_time(stop) / reps)
    on, off = float(np.mean(times[True])), float(np.mean(times[False]))
    return dict(decode_step_ms_pdl_on=times[True], decode_step_ms_pdl_off=times[False],
                rms_norm_launches_per_step=per_step, saved_us_per_launch=1e3 * (off - on) / per_step)


def quant_serve(tt, cudaex, cfg, prompts, seed, bf16_wave: dict) -> dict:
    """The serve phase's 16 requests through ServingEngine(quantize="int8")
    in bf16. int8_linear must launch 81 times a decode step (5 linears x 16
    layers + lm_head) plus, per prefill, 81 at a bucket of at most
    QUANT_MAX_M tokens and 1 (lm_head, at the true last token) above it."""
    from thunder_tpu_torch.models.litgpt import GPT
    from thunder_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    gpt = GPT(cfg, torch.bfloat16, seed=seed)
    bf16_bytes = weight_bytes(gpt)
    engine = ServingEngine(gpt, max_batch=8, page_size=16, max_seq=2048, dtype=torch.bfloat16,
                           quantize="int8")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    buckets = [engine.ladder.bucket_for(len(p)) for p in prompts]
    engine.warmup([len(p) for p in prompts])
    t_warm = time.perf_counter() - t0

    per_step = 5 * cfg.n_layer + 1
    reset_peak_memory()
    count_routes(cudaex.int8_linear)
    steps0 = engine.decode_steps
    cfns = engine_cfns(engine)
    compiles0, graphs0 = sum(tt.cache_misses(c) for c in cfns), graph_stats(tt, cfns)
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new_tokens=64) for p in prompts]
    engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cudaex.int8_linear.launches
    steps = engine.decode_steps - steps0
    compiles = sum(tt.cache_misses(c) for c in cfns) - compiles0
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, cfns).items()}
    require_replayed("quant_serve", graphs)
    if graphs["graph_captures"]:
        raise AssertionError(f"{graphs['graph_captures']} captures during the int8 wave")
    results = [f.result() for f in futs]
    for r in results:
        if r.n_new_tokens != 64 or not ((r.new_tokens >= 0) & (r.new_tokens < cfg.padded_vocab_size)).all():
            raise AssertionError(f"request {r.request_id}: bad stream {r.new_tokens}")
    prefill_launches = sum(per_step if L <= cudaex.QUANT_MAX_M else 1 for L in buckets)
    want = per_step * steps + prefill_launches
    decode_claims = sum(b.impl is cudaex._int8_linear_impl
                        for b in tt.last_traces(engine.runner.decode_cfn)[-1].bound_symbols)
    routes = dict(cudaex.int8_linear.routes)
    if decode_claims != per_step or launches != want or routes["split"] or sum(routes.values()) != launches:
        raise AssertionError(f"int8_linear: {decode_claims} claims in the decode trace, {launches} "
                             f"launches ({routes}); want {per_step} and {want}, none on the split route")
    if compiles:
        raise AssertionError(f"{compiles} compiles during the int8 wave")
    n_tok = sum(r.n_new_tokens for r in results)
    out = dict(model=cfg.name, n_layer=cfg.n_layer, dtype="bfloat16 activations, int8 weights",
               requests=len(results), new_tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
               mean_ttft_ms=1e3 * float(np.mean([r.ttft_s for r in results])),
               mean_tbot_ms=1e3 * float(np.mean([r.tbot_s for r in results])),
               decode_steps=steps, int8_linear_launches=launches, int8_linear_routes=routes,
               launches_expected=dict(per_decode_step=per_step, decode=per_step * steps,
                                      prefill=prefill_launches, buckets=sorted(buckets)),
               compiles_during_wave=compiles, captures_during_wave=graphs["graph_captures"],
               graph_replays=graphs["graph_replays"], weight_bytes=weight_bytes(gpt),
               bf16_weight_bytes=bf16_bytes, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               init_s=t_init, warmup_compile_s=t_warm,
               bf16_wave_same_call={k: bf16_wave[k] for k in ("tokens_per_s", "mean_ttft_ms", "mean_tbot_ms",
                                                              "decode_steps", "peak_memory_gb")})
    emit("quant_serve", **out)
    del engine, gpt
    torch.cuda.empty_cache()
    return out


def int8_exact_(gpt, seed: int, select=None, scale: float = 2.0 ** -9) -> None:
    """Every Linear weight (``select(name)`` ones, when given) as q · scale
    with integer q in [-126, 126] and q[:, 0] = 127
    (tests/test_mfu_levers.py:_make_int8_exact; scale a power of two): int8
    quantization recovers q and the scale exactly, and the int8 kernel's
    sum(x·q)·scale is the f32 product with the weights q · scale."""
    from thunder_tpu_torch import nn

    gen = torch.Generator(device=gpt.device).manual_seed(seed)
    with torch.no_grad():
        for name, mod in gpt.named_modules():
            if isinstance(mod, nn.Linear) and (select is None or select(name)):
                q = torch.randint(-126, 127, mod.weight.shape, device=gpt.device, generator=gen)
                q[:, 0] = 127
                mod.weight.copy_(q.to(mod.weight.dtype) * scale)


# quant_agreement's sampled requests: one a prompt, (temperature, seed)
QUANT_SAMPLED = ((0.7, 21), (1.0, 2 ** 32 + 22), (0.7, 23), (1.0, 24))


def quant_agreement(tt, cudaex, cfg, prompts, seed) -> dict:
    """f32, TF32 off, Llama-3-1B at full width and depth with int8-exact
    weights: the int8 engine's greedy streams must equal the unquantized
    engine's token for token; its sampled streams (QUANT_SAMPLED, submitted
    beside the greedy ones) are held to the unquantized engine's under the
    sampled-agreement rule (SAMPLE_SHIFT, SAMPLE_MARGIN), each engine's
    draws read by EngineDraws."""
    from thunder_tpu_torch.models.litgpt import GPT
    from thunder_tpu_torch.serving import ServingEngine

    def model():
        gpt = GPT(cfg, torch.float32, seed=seed)
        int8_exact_(gpt, seed)
        return gpt

    def wave(engine):
        futs = [engine.submit(p, max_new_tokens=64) for p in prompts]
        futs += [engine.submit(p, max_new_tokens=64, temperature=t, seed=sd)
                 for p, (t, sd) in zip(prompts, QUANT_SAMPLED)]
        engine.drain()
        return [f.result().new_tokens for f in futs]

    gpt = model()
    kw = dict(max_batch=8, page_size=16, max_seq=2048, dtype=torch.float32)
    plain = ServingEngine(gpt, **kw)
    plain_draws = EngineDraws(plain)
    want = wave(plain)
    plain_draws.remove()
    del plain
    n0, s0 = cudaex.int8_linear.launches, cudaex.int8_linear.routes["split"]
    engine = ServingEngine(gpt, quantize="int8", **kw)
    draws = EngineDraws(engine)
    got = wave(engine)
    draws.remove()
    launched = cudaex.int8_linear.launches - n0
    on_split = cudaex.int8_linear.routes["split"] - s0
    n = len(prompts)
    rows = [{"prompt_len": len(p), "equal": bool(np.array_equal(g, w))}
            for p, g, w in zip(prompts, got[:n], want[:n])]
    sampled = [sample_row(g, w, t, sd, len(p), draws.at, plain_draws.at)
               for p, (t, sd), g, w in zip(prompts, QUANT_SAMPLED, got[n:], want[n:])]
    del engine, gpt, draws, plain_draws
    torch.cuda.empty_cache()
    out = dict(model=f"{cfg.name} f32, int8-exact weights", tf32=False, rows=rows, sampled_rows=sampled,
               sampled=sampled_summary(sampled), int8_linear_launches=launched, on_split_route=on_split)
    emit("quant_agreement", **out)
    bad = rows_failing(sampled)
    if not all(r["equal"] for r in rows) or bad or not launched or on_split != launched:
        raise AssertionError(f"int8 streams differ from the unquantized engine's: {out}")
    torch.cuda.empty_cache()
    return out


NF4_B, NF4_PROMPT, NF4_NEW = 4, 512, 64


def nf4_inference(tt, cudaex, cfg, seed) -> dict:
    """GPTInference over Llama-3-1B in bf16 after QuantizeNF4Transform: B=4
    prompts of 512 tokens, 64 new each (benchmark_inference.py's --quantize
    nf4 path). Prefill runs 2,048 rows, above QUANT_MAX_M, so its block
    linears take the decomposition and only lm_head (at the last position,
    4 rows) the kernel; nf4_linear must launch 81 times a decode step."""
    from thunder_tpu_torch.inference import GPTInference
    from thunder_tpu_torch.models.litgpt import GPT
    from thunder_tpu_torch.transforms.quantization import QuantizeNF4Transform

    gpt = GPT(cfg, torch.bfloat16, seed=seed)
    bf16_bytes = weight_bytes(gpt)
    t0 = time.perf_counter()
    QuantizeNF4Transform().transform_module(gpt)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    eng = GPTInference(gpt, max_seq=NF4_PROMPT + NF4_NEW, dtype=torch.bfloat16)
    prompt = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (NF4_B, NF4_PROMPT)).astype(np.int32))
    t0 = time.perf_counter()
    eng.generate(prompt, NF4_NEW)  # compiles prefill and decode, captures the decode loop
    t_warm = time.perf_counter() - t0
    reset_peak_memory()
    count_routes(cudaex.nf4_linear)
    graphs0 = graph_stats(tt, [eng._decode_cfn])
    out_toks, m = eng.generate(prompt, NF4_NEW)
    torch.cuda.synchronize()
    launches = cudaex.nf4_linear.launches
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [eng._decode_cfn]).items()}
    require_replayed("nf4_inference", graphs)
    if graphs["graph_captures"]:
        raise AssertionError(f"nf4_inference: {graphs['graph_captures']} captures in the measured call")
    per_step = 5 * cfg.n_layer + 1
    steps = NF4_NEW - 1
    want = per_step * steps + 1
    routes = dict(cudaex.nf4_linear.routes)
    if launches != want or routes["split"]:
        raise AssertionError(f"nf4_linear launched {launches} times ({routes}), want {per_step} x {steps} + 1, "
                             "none on the split route")
    if not ((out_toks >= 0) & (out_toks < cfg.padded_vocab_size)).all():
        raise AssertionError("nf4_inference: tokens out of range")
    step = decode_step_split(eng, gpt, prompt)
    out = dict(model=cfg.name, n_layer=cfg.n_layer, dtype="bfloat16 activations, NF4 weights",
               B=NF4_B, prompt_len=NF4_PROMPT, new_tokens=NF4_NEW, tokens_per_s=m.tokens_per_sec,
               ttft_ms=1e3 * m.ttft_s, tbot_ms=1e3 * m.tbot_s, nf4_linear_launches=launches,
               nf4_linear_routes=routes, **graphs,
               launches_expected=dict(per_decode_step=per_step, decode_steps=steps, prefill_lm_head=1),
               weight_bytes=weight_bytes(gpt), bf16_weight_bytes=bf16_bytes,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, quantize_s=t_quant,
               warmup_compile_s=t_warm, **step)
    emit("nf4_inference", **out)
    nf4_pair(eng, prompt)
    del eng, gpt
    torch.cuda.empty_cache()
    return out


NF4_PAIR_NEW = 16


def nf4_pair(eng, prompt) -> dict:
    """The same-call pair of GPTInference over the NF4 model:
    generate(prompt, NF4_PAIR_NEW) with scan_decode (the decode loop one CUDA
    graph) and without (the Python loop over the decode program), one
    untimed call of each kind first; tokens/s, TTFT, TBOT and nf4_linear's
    launches a call and the streams, which must agree."""
    from thunder_tpu_torch.executors import cudaex

    runs, toks = [], []
    for scan in PAIR_ROUNDS:
        eng.generate(prompt, NF4_PAIR_NEW, scan_decode=scan)
        cudaex.nf4_linear.launches = 0
        out, m = eng.generate(prompt, NF4_PAIR_NEW, scan_decode=scan)
        torch.cuda.synchronize()
        toks.append(out.cpu())
        runs.append(dict(cuda_graphs=scan, tokens_per_s=m.tokens_per_sec, ttft_ms=1e3 * m.ttft_s,
                         tbot_ms=1e3 * m.tbot_s, launches={"nf4_linear": cudaex.nf4_linear.launches}))
    require_same_launches("graphs nf4_generate", runs)
    out = dict(cell="nf4_generate", B=prompt.shape[0], prompt_len=prompt.shape[1], new_tokens=NF4_PAIR_NEW,
               runs=runs, streams_equal=all(torch.equal(t, toks[0]) for t in toks))
    emit("graphs", **out)
    if not out["streams_equal"]:
        raise AssertionError("graphs nf4_generate: the greedy streams differ between the runs")
    return out


def decode_step_split(eng, gpt, prompt, n: int = 5) -> dict:
    """One decode program call split by the host clock: the time to
    enqueue it (the program's torch calls and launches) and the wait for the
    device after it (synchronize), medians over n calls at the prompt's end."""
    from thunder_tpu_torch.inference import KVCache

    cfg = gpt.cfg
    B, T = prompt.shape
    params = {k: p.detach() for k, p in gpt.named_parameters()}
    ks, vs = KVCache(cfg.n_layer, B, cfg.n_query_groups, eng.max_seq, cfg.head_size, eng.dtype,
                     gpt.device).as_tuple()
    logits, ks, vs = eng._prefill_cfn(params, prompt.to(gpt.device), ks, vs)
    tok = torch.argmax(logits, -1).to(prompt.dtype)[:, None]
    pos = torch.tensor(T, dtype=torch.int32, device=gpt.device)
    enq, wait = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._decode_cfn(params, tok, ks, vs, pos)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append(t1 - t0)
        wait.append(time.perf_counter() - t1)
    return dict(decode_enqueue_ms=1e3 * float(np.median(enq)), decode_device_wait_ms=1e3 * float(np.median(wait)),
                decode_enqueue_profile=enqueue_profile(lambda: eng._decode_cfn(params, tok, ks, vs, pos)))


def enqueue_profile(call, top: int = 12) -> dict:
    """Where one uncaptured program call spends its host time: torch.profiler
    with CPU activity only, the call's wall ms, the garbage collector's
    pauses inside it (generation, ms), the call again with the collector
    off, the aten and CUDA runtime rows by self host ms, and the Python
    functions (cProfile) by own ms."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    pauses = []

    def timed_gc(phase, info):  # the collector's own time inside the call
        if phase == "start":
            pauses.append([info["generation"], time.perf_counter()])
        else:
            pauses[-1][1] = time.perf_counter() - pauses[-1][1]

    torch.cuda.synchronize()
    gc.callbacks.append(timed_gc)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            call()
            wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(timed_gc)
    torch.cuda.synchronize()
    gc.disable()
    try:
        t0 = time.perf_counter()
        call()
        wall_no_gc = time.perf_counter() - t0
    finally:
        gc.enable()
    torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda r: -r.self_cpu_time_total)
    pr = cProfile.Profile()
    pr.enable()
    call()
    pr.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(pr).stats
    py = sorted(((v[2], v[0], f"{k[0].split('/')[-1]}:{k[1]}({k[2]})") for k, v in stats.items()), reverse=True)
    return dict(wall_ms=wall * 1e3, wall_ms_collector_off=wall_no_gc * 1e3,
                gc_pauses=[(g, ms * 1e3) for g, ms in pauses], gc_tracked_objects=len(gc.get_objects()),
                ops=sum(r.count for r in rows if r.key.startswith("aten::")),
                launches=sum(r.count for r in rows if r.key in ("cudaLaunchKernel", "cudaLaunchKernelExC")),
                host_ms_by_op=[(r.key, r.count, r.self_cpu_time_total / 1e3) for r in rows[:top]],
                python_ms_by_function=[(name, calls, own * 1e3) for own, calls, name in py[:top]])


def nf4_agreement(tt, cudaex, cfg, seed) -> dict:
    """f32, TF32 off: GPTInference over the NF4 model against GPTInference
    over an unquantized GPT holding dequantize_nf4_kl's f32 weights, B=4
    prompts of 128 tokens (prefill's 512 rows on the kernel too), 32 new
    tokens; streams equal or different only after a step whose top-2 gap
    is < AGREE_GAP."""
    from thunder_tpu_torch import nn
    from thunder_tpu_torch.inference import GPTInference
    from thunder_tpu_torch.models.litgpt import GPT
    from thunder_tpu_torch.transforms.quantization import QuantizeNF4Transform, dequantize_nf4_kl

    gpt = GPT(cfg, torch.float32, seed=seed)
    QuantizeNF4Transform().transform_module(gpt)
    ref = GPT(cfg, torch.float32, seed=seed)  # same norms and embedding; Linear weights replaced
    with torch.no_grad():
        for (name, mod), (_, rmod) in zip(gpt.named_modules(), ref.named_modules()):
            if isinstance(mod, nn.Linear):
                rmod.weight.copy_(dequantize_nf4_kl(mod.weight, mod.absmax,
                                                    (mod.out_features, mod.in_features)))
    B, T, new = NF4_B, 128, 32
    prompt = torch.from_numpy(np.random.RandomState(seed + 3).randint(
        0, cfg.vocab_size, (B, T)).astype(np.int32))
    n0, r0 = cudaex.nf4_linear.launches, dict(cudaex.nf4_linear.routes)
    got, _ = GPTInference(gpt, max_seq=T + new, dtype=torch.float32).generate(prompt, new)
    launched = cudaex.nf4_linear.launches - n0
    routes = {k: v - r0[k] for k, v in cudaex.nf4_linear.routes.items()}
    want, m = GPTInference(ref, max_seq=T + new, dtype=torch.float32).generate(prompt, new)
    rows = [agree_row(got[b, T:].cpu().numpy(), want[b, T:].cpu().numpy(), m.top2_gap[b], T)
            for b in range(B)]
    # the prefill, the new - 1 decode steps of the scan_decode graph, and the
    # decode call that compiles and warms the decode program before a
    # signature's first capture (GPTInference._scan_program); the prefill's
    # block linears (B·T = 512 rows) on the split route, the rest (B rows)
    # on the FMA kernel
    expected = (5 * cfg.n_layer + 1) * (new + 1)
    want_routes = dict.fromkeys(routes, 0) | {"split": 5 * cfg.n_layer, "fma": expected - 5 * cfg.n_layer}
    out = dict(model=f"{cfg.name} f32", tf32=False, rows=rows, tolerance=AGREE_GAP,
               nf4_linear_launches=launched, nf4_linear_launches_expected=expected, nf4_linear_routes=routes)
    emit("nf4_agreement", **out)
    bad = [r for r in rows if not r["equal"] and not r["solo_top2_gap"] < AGREE_GAP]
    if bad or launched != expected or routes != want_routes:
        raise AssertionError(f"nf4 agreement: {out}")
    del gpt, ref
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 6-7: fleet, fleet_agreement
# ---------------------------------------------------------------------------

FLEET_NEW = 32


def mixed_specs(rng, vocab, n, *, shared_len=1024, shared_frac=0.5, long_frac=0.125,
                chunk_tokens=256, max_seq=2048, new=FLEET_NEW, lo=128, hi=512) -> tuple:
    """([(prompt, max_new_tokens, lane) per request], counts by kind), drawn as
    thunder_tpu/benchmarks/benchmark_serving.py:_mixed_specs draws them:
    shared system prompt + 1-8-token tail (interactive), long prompts of
    max(chunk+1, long_max//2)..long_max tokens (batch lane), uniform lo..hi
    background (interactive)."""
    shared = rng.randint(0, vocab, (shared_len,)).astype(np.int32)
    long_max = max_seq - new - 1
    specs, kinds = [], {"shared": 0, "long_batch": 0, "uniform": 0}
    for _ in range(n):
        m = int(rng.randint(new, new + 1))
        u = rng.random_sample()
        if u < shared_frac:
            tail = rng.randint(0, vocab, (int(rng.randint(1, 9)),)).astype(np.int32)
            specs.append((np.concatenate([shared, tail]), m, "interactive"))
            kinds["shared"] += 1
        elif u < shared_frac + long_frac:
            L = int(rng.randint(max(chunk_tokens + 1, long_max // 2), long_max + 1))
            specs.append((rng.randint(0, vocab, (L,)).astype(np.int32), m, "batch"))
            kinds["long_batch"] += 1
        else:
            L = int(rng.randint(lo, hi + 1))
            specs.append((rng.randint(0, vocab, (L,)).astype(np.int32), m, "interactive"))
            kinds["uniform"] += 1
    return specs, kinds


def engine_cfns(engine) -> list:
    runners = [engine.runner] + ([engine.draft_runner] if engine.draft_runner is not None else [])
    return [getattr(r, n) for r in runners
            for n in ("prefill_cfn", "decode_cfn", "chunk_cfn", "verify_cfn")]


def run_wave(tt, engine, specs, zero=()) -> dict:
    """warmup over the wave's prompt lengths (compiles and captures the
    programs), replay the wave once with 2 new tokens each (warms the prefix
    cache: benchmark_serving.py's warm-up), then zero the counters (and call
    each of ``zero``) and submit the whole wave at once; it must compile and
    capture nothing."""
    from thunder_tpu_torch.executors import cudaex

    engine.warmup(sorted({len(p) for p, _, _ in specs}))
    for p, _, lane in specs:
        engine.submit(p, 2, lane=lane)
    engine.drain()
    torch.cuda.synchronize()
    before = {k: getattr(engine, k) for k in ("decode_steps", "chunk_calls", "verify_calls",
                                              "prefix_hits", "prefix_tokens_saved",
                                              "spec_proposed", "spec_accepted")}
    compiles0 = sum(tt.cache_misses(c) for c in engine_cfns(engine))
    graphs0 = graph_stats(tt, engine_cfns(engine))
    engine.peak_pages_in_use = engine.cache.allocator.n_used
    cudaex.rms_norm.launches = 0
    cudaex.paged_attention.launches = 0
    cudaex.paged_chunk_attention.launches = 0
    for z in zero:
        z()
    t0 = time.perf_counter()
    futs = [engine.submit(p, n, lane=lane) for p, n, lane in specs]
    engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rms_norm": cudaex.rms_norm.launches,
                "paged_attention": cudaex.paged_attention.launches,
                "paged_chunk_attention": cudaex.paged_chunk_attention.launches}
    results = [f.result() for f in futs]
    vocab = engine.cfg.padded_vocab_size
    for r, (_, n, _) in zip(results, specs):
        if r.n_new_tokens != n or not ((r.new_tokens >= 0) & (r.new_tokens < vocab)).all():
            raise AssertionError(f"request {r.request_id}: bad stream {r.new_tokens}")
    cached = len(engine.prefix) if engine.prefix is not None else 0
    if engine.cache.allocator.n_used != cached:
        raise AssertionError(f"{engine.cache.allocator.n_used} pages held, the prefix cache "
                             f"holds {cached}")
    n_tok = sum(r.n_new_tokens for r in results)
    counts = {k: getattr(engine, k) - v for k, v in before.items()}
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, engine_cfns(engine)).items()}
    require_replayed("wave", graphs)
    return dict(captures_during_wave=graphs["graph_captures"], graph_replays=graphs["graph_replays"],requests=len(results), prompt_tokens=int(sum(len(p) for p, _, _ in specs)),
                new_tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                mean_ttft_ms=1e3 * float(np.mean([r.ttft_s for r in results])),
                mean_tbot_ms=1e3 * float(np.mean([r.tbot_s for r in results])),
                engine_iterations=counts.pop("decode_steps"), **counts,
                peak_page_pool_utilization=engine.stats()["peak_page_pool_utilization"],
                compiles_during_wave=sum(tt.cache_misses(c) for c in engine_cfns(engine)) - compiles0,
                launches=launches)


def fleet(tt, cudaex, cfg, seed) -> dict:
    """The 32-request mixed wave (shared system prompt, long batch-lane
    prompts, uniform background; 32 new tokens each) through the fleet
    engine — prefix sharing, 256-token chunks, the model as its own draft
    with spec_k=2 (benchmark_serving.py's fleet setting) — and, in the same
    call for comparison, through the plain engine."""
    from thunder_tpu_torch.models.litgpt import GPT
    from thunder_tpu_torch.serving import ServingEngine

    gpt = GPT(cfg, torch.bfloat16, seed=seed)
    specs, kinds = mixed_specs(np.random.RandomState(seed), cfg.vocab_size, 32)
    base = dict(max_batch=8, page_size=16, max_seq=2048, dtype=torch.bfloat16)

    plain = ServingEngine(gpt, **base)
    plain_wave = run_wave(tt, plain, specs)
    del plain
    torch.cuda.empty_cache()

    engine = ServingEngine(gpt, prefix_sharing=True, chunk_tokens=256, draft_gpt=gpt, spec_k=2,
                           **base)
    wave = run_wave(tt, engine, specs)
    launches = wave["launches"]
    want_chunk = (cfg.n_layer * (wave["chunk_calls"] + wave["verify_calls"])
                  + engine.draft_gpt.cfg.n_layer * wave["chunk_calls"])
    if not launches["paged_chunk_attention"] == want_chunk > 0:
        raise AssertionError(f"paged_chunk_attention launched {launches['paged_chunk_attention']} "
                             f"times, the engine's programs account for {want_chunk}")
    if not (launches["rms_norm"] and launches["paged_attention"]):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if wave["compiles_during_wave"] or wave["captures_during_wave"] or plain_wave["captures_during_wave"]:
        raise AssertionError(f"{wave['compiles_during_wave']} compiles, {wave['captures_during_wave']} and "
                             f"{plain_wave['captures_during_wave']} captures during the timed waves")
    for cfn in (engine.runner.chunk_cfn, engine.runner.verify_cfn):
        if not any(b.impl is cudaex._paged_chunk_attention_impl
                   for b in tt.last_traces(cfn)[-1].bound_symbols):
            raise AssertionError(f"{cfn.__name__}'s trace does not claim thunder.paged_chunk_attention")
    out = dict(model=cfg.name, n_layer=cfg.n_layer, dtype="bfloat16", draft="self (the target)",
               spec_k=2, chunk_tokens=256, kinds=kinds, **wave,
               spec_accept_rate=wave["spec_accepted"] / max(1, wave["spec_proposed"]),
               spec_accept_note=("the draft is the target, so 1.0 but for bf16 rounding: the draft "
                                 "proposes through the decode program, the verify step scores "
                                 "through the chunk kernel, and near-ties may flip"),
               chunk_launches_expected=want_chunk, plain_engine_same_wave=plain_wave)
    emit("fleet", **out)
    out["profile"] = profile_wave(engine, specs[:8], "fleet_profile")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    serving_pair(tt, cudaex, "fleet", lambda g: ServingEngine(gpt, prefix_sharing=True, chunk_tokens=256,
                                                              draft_gpt=gpt, spec_k=2, cuda_graphs=g, **base),
                 specs[:8])
    del gpt
    torch.cuda.empty_cache()
    return out


def agreement_engine(gpt, draft, **kw):
    """fleet_agreement's engine: 4 slots, a 48-page pool, prefix sharing,
    256-token chunks, the draft with spec_k=2 (f32)."""
    from thunder_tpu_torch.serving import ServingEngine

    return ServingEngine(gpt, max_batch=4, page_size=16, max_seq=2048, dtype=torch.float32, n_pages=49,
                         prefix_sharing=True, chunk_tokens=256, draft_gpt=draft, spec_k=2, **kw)


# fleet_agreement's sampled requests, by index into agreement_wave's six
# (temperature, seed): seeds at and above 2^32 (taken mod 2^32)
AGREE_SAMPLED = {0: (1.0, 2 ** 32 + 3), 1: (0.7, 5), 3: (1.0, 2 ** 32 + 9), 4: (0.7, 2 ** 33 + 11)}
# The sampled-agreement rule. Two paths (an engine and solo GPTInference, or
# two engines) draw a request's token at position p from the same uniform
# u(seed, p), each by the inverse CDF of its own softmax(logits / T)
# (serving/sampling.sample_tokens). At every draw while the streams agree,
# both paths' logits are read (EngineDraws, solo_draws) and give the
# reference's margin (the distance of u from the nearer edge of its token's
# interval, over the total) and the shift D between the two paths: the
# largest distance between their normalized CDFs. A token can change only
# where the margin is below D, so a difference is excused only there, and
# only below SAMPLE_MARGIN. D must stay below SAMPLE_SHIFT at every draw:
# f32 paths through the same weights stay far below it, int8-exact weights
# (whose logits put most of the mass on a few tokens) move the CDFs by up
# to ~2e-4 between the split route and cuBLAS, and unrelated logits (std
# 0.57 over 128,256 tokens, the mass spread thin) lie ~2e-3 apart. Each path's
# token must be its own draw from its logits at u(seed, p) (but within
# SAMPLER_CPU_MARGIN of an edge, where the one-row recomputation may round
# otherwise). A stream drawn at another position, temperature or from
# other logits fails.
SAMPLE_MARGIN = 1e-4
SAMPLE_SHIFT = 1e-3
AGREE_NEW = 24


def agreement_wave(engine, cfg, seed, sampled=None) -> tuple:
    """A long batch-lane request (500 tokens: chunks of 256 + 244, 33 pages
    reserved of 48) decodes while five interactive ones arrive (two share a
    160-token prefix; the first needs 16 pages, 15 are free), so it is
    preempted and resumed. ``sampled``: {index: (temperature, seed)}.
    Returns (prompts, [(temperature, seed)], futures)."""
    sampled = sampled or {}
    rng = np.random.RandomState(seed + 2)
    tok = lambda n: rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)  # noqa: E731
    shared = tok(160)
    long_p = tok(500)
    prompts = [long_p, np.concatenate([shared, tok(5)]), np.concatenate([shared, tok(9)]), tok(20), tok(45),
               tok(60)]
    draws = [sampled.get(i, (0.0, None)) for i in range(len(prompts))]
    futs = [engine.submit(long_p, AGREE_NEW, lane="batch", temperature=draws[0][0], seed=draws[0][1])]
    while engine.stats()["active"] == 0 and not futs[0].done():  # chunks, then decoding
        engine._step_once()
    if futs[0].done():
        raise AssertionError(f"the batch-lane request ended before decoding: {futs[0].result()}")
    futs += [engine.submit(p, AGREE_NEW, temperature=t, seed=sd) for p, (t, sd) in zip(prompts[1:], draws[1:])]
    engine.drain()
    return prompts, draws, futs


class EngineDraws:
    """Stands in for a serving engine's sampler while installed and keeps
    the logits and temperature of every sampled row it draws, by the row's
    uniform (one (seed, position) pair's). The last draw at a uniform is the
    committed token's: a committed position is never drawn again, and a
    verify step draws after the draft proposed at that position."""

    def __init__(self, engine):
        self.engine, self.sampler, self.draws = engine, engine.sampler, {}
        engine.sampler = self

    def __call__(self, logits, u, temps):
        for r in np.nonzero(temps > 0)[0]:
            self.draws[float(u[r])] = (logits[r].detach().clone(), float(temps[r]))
        return self.sampler(logits, u, temps)

    def at(self, step: int, u: float):
        return self.draws.get(float(u))

    def remove(self) -> None:
        self.engine.sampler = self.sampler
        self.engine = None


def solo_draws(solo, prompt, n: int, temperature: float, seed):
    """solo.generate(prompt, n, temperature=, seed=)'s stream and, for
    each of its draws, the logits (V,) it drew from (its prefill's, then
    each decode step's), read by wrapping its two programs for the call."""
    logits = []

    def tap(fn):
        def tapped(*args):
            out = fn(*args)
            logits.append(out[0][0].detach().clone())
            return out

        tapped._cs = fn._cs
        return tapped

    programs = solo._prefill_cfn, solo._decode_cfn
    solo._prefill_cfn, solo._decode_cfn = (tap(f) for f in programs)
    try:
        out, _ = solo.generate(torch.from_numpy(prompt[None, :]), n, temperature=temperature, seed=seed)
    finally:
        solo._prefill_cfn, solo._decode_cfn = programs
    return out[0, len(prompt):].cpu().numpy(), logits


def draw_pair(la, lb, u: float, temperature: float) -> dict:
    """Both paths' draws at uniform ``u`` from logits ``la`` (under test)
    and ``lb`` (the reference), as sample_tokens forms them: each token and
    margin, and the shift D = max |C_a - C_b| of the two normalized CDFs."""
    from thunder_tpu_torch.serving.sampling import sample_tokens

    x = torch.stack([la, lb]).float()
    t = torch.full((2,), temperature, dtype=torch.float32, device=x.device)
    tok, margin = sample_tokens(x, torch.full((2,), u, dtype=torch.float64, device=x.device), t)
    c = torch.cumsum(torch.softmax(x / t[:, None], -1).double(), -1)
    c = c / c[:, -1:]
    tok, margin = tok.tolist(), margin.tolist()
    return dict(tok_a=tok[0], tok_b=tok[1], margin_a=margin[0], margin_b=margin[1],
                shift=float((c[0] - c[1]).abs().max()))


def sample_row(got, want, temperature: float, seed, prompt_len: int, got_at, want_at) -> dict:
    """A sampled stream (``got``, the path under test) against its
    reference (``want``) under the sampled-agreement rule, draw by draw
    while they agree. ``got_at(step, u)`` and ``want_at(step, u)`` give each
    path's (logits, temperature) of the draw at that step, or None. A
    broken rule is the row's ``fault``."""
    from thunder_tpu_torch.serving.sampling import canonical_seed, philox_uniform

    us = philox_uniform(canonical_seed(seed), prompt_len + np.arange(len(want)), 0)
    row = {"prompt_len": prompt_len, "temperature": temperature, "seed": seed,
           "equal": bool(np.array_equal(got, want))}
    margins, shifts = [], []
    for step, u in enumerate(us):
        a, b = got_at(step, u), want_at(step, u)
        if a is None or b is None:
            row["fault"] = f"draw {step}: no {'tested' if a is None else 'reference'} draw at its uniform"
            break
        if np.float32(a[1]) != np.float32(temperature) or np.float32(b[1]) != np.float32(temperature):
            row["fault"] = f"draw {step}: drawn at temperatures {a[1]} and {b[1]}"
            break
        d = draw_pair(a[0], b[0], float(u), temperature)
        margins.append(d["margin_b"])
        shifts.append(d["shift"])
        if ((d["tok_a"] != got[step] and d["margin_a"] >= SAMPLER_CPU_MARGIN)
                or (d["tok_b"] != want[step] and d["margin_b"] >= SAMPLER_CPU_MARGIN)):
            row["fault"] = f"draw {step}: a token is not its path's draw from its logits: {d}"
            break
        if d["shift"] >= SAMPLE_SHIFT:
            row["fault"] = f"draw {step}: the paths' distributions are {d['shift']} apart"
            break
        if got[step] != want[step]:
            row.update(first_diff_step=step, margin_at_diff=d["margin_b"], shift_at_diff=d["shift"])
            if not d["margin_b"] < min(d["shift"], SAMPLE_MARGIN):
                row["fault"] = (f"draw {step}: differs at a margin {d['margin_b']} not below the shift "
                                f"{d['shift']} and {SAMPLE_MARGIN}")
            break
    row.update(draws_compared=len(margins), min_margin=min(margins, default=None),
               median_margin=float(np.median(margins)) if margins else None,
               max_shift=max(shifts, default=None))
    return row


def sampled_summary(rows) -> dict:
    """The sampled rows' draws compared, smallest and median of their
    rows' median margins, and the largest shift between the paths."""
    rows = [r for r in rows if r.get("temperature", 0) > 0]
    compared = [r for r in rows if r["draws_compared"]]
    return dict(draws_compared=sum(r["draws_compared"] for r in rows),
                min_margin=min((r["min_margin"] for r in compared), default=None),
                median_of_row_median_margins=(float(np.median([r["median_margin"] for r in compared]))
                                              if compared else None),
                max_shift=max((r["max_shift"] for r in compared), default=None), shift_bound=SAMPLE_SHIFT,
                margins_at_diff=[r["margin_at_diff"] for r in rows if "margin_at_diff" in r],
                margin_bound=SAMPLE_MARGIN,
                diverged=sum(not r["equal"] for r in rows), faults=sum("fault" in r for r in rows))


def solo_rows(solo, prompts, draws, streams, tap=None) -> list:
    """Each stream against solo GPTInference.generate of its prompt:
    agree_row for a greedy one; for a sampled one (its temperature and
    seed), sample_row with ``tap`` (the engine's EngineDraws) as the tested
    path's draws and the solo draws as the reference."""
    rows = []
    for p, (temp, sd), got in zip(prompts, draws, streams):
        if temp > 0:
            want, logits = solo_draws(solo, p, len(got), temp, sd)
            rows.append(sample_row(got, want, temp, sd, len(p), tap.at,
                                   lambda step, u, lg=logits, t=temp: (lg[step], t) if step < len(lg) else None))
        else:
            out, m = solo.generate(torch.from_numpy(p[None, :]), len(got))
            rows.append(agree_row(got, out[0, len(p):].cpu().numpy(), m.top2_gap[0], len(p)))
    return rows


def rows_failing(rows) -> list:
    """Greedy rows that differ other than after a solo top-2 gap below
    AGREE_GAP; sampled rows that break the sampled-agreement rule."""
    return [r for r in rows if ("fault" in r if r.get("temperature", 0) > 0
                                else not r["equal"] and not r.get("solo_top2_gap", 1.0) < AGREE_GAP)]


def fleet_agreement(cfg, seed) -> dict:
    """f32, TF32 off, Llama-3-1B at full width and depth with a 2-layer
    draft of the same width from another seed (so proposals are rejected and
    rollback runs); prefix sharing and 256-token chunks; a pool of 48 pages,
    so the long batch-lane request is preempted by the interactive ones and
    resumed. Every greedy stream must equal the solo dense GPTInference
    stream, or differ only after a step whose solo top-2 gap is < AGREE_GAP.
    Then the same wave with AGREE_SAMPLED's requests sampled (T 0.7 and 1.0,
    seeds at and above 2^32; the prefix cache cleared): every sampled stream
    is held to solo GPTInference.generate(temperature=, seed=) under the
    sampled-agreement rule (SAMPLE_SHIFT, SAMPLE_MARGIN)."""
    from thunder_tpu_torch.inference import GPTInference
    from thunder_tpu_torch.models.litgpt import GPT, Config

    gpt = GPT(cfg, torch.float32, seed=seed)
    draft = GPT(Config.from_name(cfg.name, n_layer=2), torch.float32, seed=seed + 1)
    engine = agreement_engine(gpt, draft)
    solo = GPTInference(gpt, max_seq=2048, dtype=torch.float32)
    prompts, draws, futs = agreement_wave(engine, cfg, seed)
    rows = solo_rows(solo, prompts, draws, [f.result().new_tokens for f in futs])
    stages = dict(preempted=engine.preempted, resumed=engine.resumed, spec_accepted=engine.spec_accepted,
                  spec_proposed=engine.spec_proposed, prefix_hits=engine.prefix_hits,
                  chunk_calls=engine.chunk_calls, verify_calls=engine.verify_calls)
    engine.prefix.clear()
    p0 = engine.preempted
    tap = EngineDraws(engine)
    prompts, draws, futs = agreement_wave(engine, cfg, seed, AGREE_SAMPLED)
    tap.remove()
    sampled_rows = solo_rows(solo, prompts, draws, [f.result().new_tokens for f in futs], tap)
    out = dict(model=f"{cfg.name} f32", draft=f"{cfg.name} n_layer=2 seed {seed + 1}", tf32=False,
               rows=rows, tolerance=AGREE_GAP, **stages, sampled_rows=sampled_rows,
               sampled=sampled_summary(sampled_rows), sampled_wave_preempted=engine.preempted - p0)
    emit("fleet_agreement", **out)
    bad = rows_failing(rows + sampled_rows)
    if bad:
        raise AssertionError(f"fleet streams differ from solo: {bad}")
    if not (stages["preempted"] >= 1 and stages["resumed"] >= 1 and stages["prefix_hits"] >= 1
            and stages["spec_accepted"] < stages["spec_proposed"] and out["sampled_wave_preempted"] >= 1):
        raise AssertionError(f"fleet_agreement did not exercise every stage: {out}")
    del engine, gpt, draft, solo, tap
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# sampler, sampled_serve, quant_fleet, quant_fleet_agreement, moe_fleet,
# slo_serve (the serving path's sampling, int8 and MoE under every fleet
# stage, and SLO monitoring)
# ---------------------------------------------------------------------------

SAMPLER_ROWS = (1, 8, 24)         # a prefill's first token, a decode step, a verify step (8 x 3)
SAMPLER_CHI_P = 1e-3              # the sampled histogram against softmax(l / T)
SAMPLER_CPU_MARGIN = 1e-6         # card and CPU may draw differently only this close to an edge
QUANT_FLEET_AGREE_LAYERS = 4      # the f32 depth of quant_fleet_agreement, moe_fleet's agreement, slo_serve's burn


SAMPLER_TEMPS = np.array([0.0, 0.5, 0.7, 1.0, 1.0, 1.3, 0.0, 0.9], np.float32)
SAMPLER_CALLS = 5                 # a row count's captured-program calls: op by op, then 4 replays (the first captures)


def check_sampler(dev) -> dict:
    """serving/sampling.py on the card: 2^17 draws at V=64 and T 0.5 and 1.0
    against softmax(l / T) (chi-square, p > SAMPLER_CHI_P); (8, 128256)
    Llama-3 bf16 logits drawn on the card and on the CPU from the same
    uniforms (equal tokens but where the CPU margin is < SAMPLER_CPU_MARGIN;
    temperature-0 rows the argmax). Then the engine's captured program
    (Sampler) at 1, 8 and 24 rows: SAMPLER_CALLS calls a row count with new
    logits, uniforms and temperatures each (the first op by op, the others
    replays of its graph, captured at the second), each held to the CPU's
    sample_tokens as above; and its device µs a call (CUDA events over its
    graph's replays)."""
    from scipy import stats

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.serving.sampling import Sampler, philox_uniform, sample_tokens

    rng = np.random.RandomState(0)
    n, V = 1 << 17, 64
    logits = torch.from_numpy(rng.randn(V).astype(np.float32) * 2)
    chi = {}
    for temp in (0.5, 1.0):
        u = torch.from_numpy(philox_uniform(11, np.arange(n), 0)).to(dev)
        tok, _ = sample_tokens(logits.to(dev).expand(n, V), u, torch.full((n,), temp, device=dev))
        counts = np.bincount(tok.cpu().numpy(), minlength=V)
        p = torch.softmax(logits.double() / temp, -1).numpy()
        chi[str(temp)] = float(stats.chisquare(counts, p * n).pvalue)
    R, V = 8, 128256
    temps = SAMPLER_TEMPS
    differ, near, rows = [], 0, 0
    for trial in range(16):
        lg = torch.from_numpy(rng.randn(R, V).astype(np.float32) * 3).to(torch.bfloat16)
        u = philox_uniform(trial, np.arange(R) + 100, 0)
        dt, _ = sample_tokens(lg.to(dev), torch.from_numpy(u).to(dev), torch.from_numpy(temps).to(dev))
        ct, cm = sample_tokens(lg, torch.from_numpy(u), torch.from_numpy(temps))
        dt = dt.cpu()
        if not torch.equal(dt[temps == 0], torch.argmax(lg[temps == 0], -1)):
            raise AssertionError(f"sampler: a temperature-0 row is not the argmax (trial {trial})")
        for r in range(R):
            rows += 1
            near += int(cm[r] < SAMPLER_CPU_MARGIN)
            if dt[r] != ct[r]:
                differ.append(dict(trial=trial, row=r, cpu_margin=float(cm[r])))
    sampler = Sampler(dev)
    us, captured = {}, {}
    for R in SAMPLER_ROWS:
        replays0 = tt.graph_replays(sampler)
        for call in range(SAMPLER_CALLS):
            lg = torch.from_numpy(rng.randn(R, V).astype(np.float32) * 3).to(torch.bfloat16)
            u, t = philox_uniform(call + 40, np.arange(R) + 1000 * R, 0), np.resize(np.roll(temps, call), R)
            tok = sampler(lg.to(dev), u, t).cpu()
            ct, cm = sample_tokens(lg, torch.from_numpy(u), torch.from_numpy(t))
            if not torch.equal(tok[t == 0], torch.argmax(lg[t == 0], -1)):
                raise AssertionError(f"sampler: the program's temperature-0 row is not the argmax ({R} rows)")
            for r in np.nonzero((tok != ct).numpy())[0]:
                differ.append(dict(program_rows=R, call=call, row=int(r), cpu_margin=float(cm[r])))
        captured[str(R)] = dict(calls=SAMPLER_CALLS, replays=tt.graph_replays(sampler) - replays0)
        replay = next(iter(sampler.program(R, V, torch.bfloat16)._graphs.values())).replay_fn
        replay()
        us[str(R)] = 1e3 * _event_ms(lambda: [replay() for _ in range(200)]) / 200
    out = dict(chi_square_p=chi, cpu_rows=rows, cpu_rows_near_an_edge=near, cpu_differ=differ,
               margin_bound=SAMPLER_CPU_MARGIN, captured_program=captured, graph_captures=tt.graph_captures(sampler),
               device_us_per_call=us, vocab=V, logits_dtype="bfloat16")
    emit("sampler", **out)
    if min(chi.values()) <= SAMPLER_CHI_P:
        raise AssertionError(f"sampler: the draws do not follow softmax(l / T): {chi}")
    if any(d["cpu_margin"] >= SAMPLER_CPU_MARGIN for d in differ):
        raise AssertionError(f"sampler: card and CPU draw differently away from an edge: {differ}")
    if out["graph_captures"] != len(SAMPLER_ROWS) or any(c["replays"] != SAMPLER_CALLS - 1
                                                         for c in captured.values()):
        raise AssertionError(f"sampler: the program was not captured once and replayed a row count: {out}")
    return out


def graph_us(replay, reps: int = 100) -> float:
    """Device µs a replay of a captured graph (CUDA events over ``reps``)."""
    replay()
    return 1e3 * _event_ms(lambda: [replay() for _ in range(reps)]) / reps


def sampled_serve(tt, cudaex, engine, prompts, served: dict) -> dict:
    """The serve wave (16 requests, 64 new tokens) on the serve phase's warm
    engine, all greedy and with every other request sampled at T=0.8
    (distinct seeds), in turns greedy, sampled, sampled, greedy: tokens/s,
    TTFT, TBOT; 0 captures and 0 compiles, replays > 0 (the sampler's own
    in the sampled waves, none in the greedy ones); the greedy waves'
    launches and decode steps equal the serve wave's. The sampler's share
    of a decode step: its captured program at max_batch rows against the
    decode program's graph, device µs a replay."""
    cfns = engine_cfns(engine) + [engine.sampler]
    counters = (cudaex.rms_norm, cudaex.paged_attention)
    runs = []
    for sampled in (False, True, True, False):
        for c in counters:
            c.launches = 0
        steps0 = engine.decode_steps
        compiles0, graphs0 = sum(tt.cache_misses(c) for c in cfns), graph_stats(tt, cfns)
        sampler0 = tt.graph_replays(engine.sampler)
        t0 = time.perf_counter()
        futs = [engine.submit(p, max_new_tokens=64, temperature=0.8 if sampled and i % 2 else 0.0,
                              seed=7000 + i) for i, p in enumerate(prompts)]
        engine.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = [f.result() for f in futs]
        graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, cfns).items()}
        n_tok = sum(r.n_new_tokens for r in res)
        runs.append(dict(sampled=sampled, tokens_per_s=n_tok / wall, wall_s=wall,
                         mean_ttft_ms=1e3 * float(np.mean([r.ttft_s for r in res])),
                         mean_tbot_ms=1e3 * float(np.mean([r.tbot_s for r in res])),
                         decode_steps=engine.decode_steps - steps0,
                         launches={c.__name__: c.launches for c in counters},
                         compiles_during_wave=sum(tt.cache_misses(c) for c in cfns) - compiles0,
                         captures_during_wave=graphs["graph_captures"], graph_replays=graphs["graph_replays"],
                         sampler_replays=tt.graph_replays(engine.sampler) - sampler0))
        if any(r.n_new_tokens != 64 for r in res):
            raise AssertionError(f"sampled_serve: a request ended early: {[r.n_new_tokens for r in res]}")
    decode_us = graph_us(decode_graph(engine.runner.decode_cfn))
    V = engine.gpt.lm_head.weight.shape[0]
    prog = engine.sampler.program(engine.max_batch, V, engine.dtype)
    sampler_us = graph_us(next(iter(prog._graphs.values())).replay_fn)
    out = dict(model=served["model"], requests=len(prompts), sampled_requests=len(prompts) // 2, temperature=0.8,
               runs=runs, decode_step_device_us=decode_us, sampler_device_us=sampler_us,
               sampler_share_of_decode_step=sampler_us / decode_us,
               serve_wave=dict(launches=served["launches"], decode_steps=served["decode_steps"]))
    emit("sampled_serve", **out)
    for r in runs:
        if r["captures_during_wave"] or r["compiles_during_wave"] or not r["graph_replays"]:
            raise AssertionError(f"sampled_serve: captures, compiles or no replays after warmup: {r}")
        if bool(r["sampler_replays"]) != r["sampled"]:
            raise AssertionError(f"sampled_serve: the sampler ran {r['sampler_replays']} times in {r}")
        if not r["sampled"] and (r["launches"] != served["launches"]
                                 or r["decode_steps"] != served["decode_steps"]):
            raise AssertionError(f"sampled_serve: the greedy wave launched {r['launches']} in "
                                 f"{r['decode_steps']} steps, the serve wave {served['launches']} in "
                                 f"{served['decode_steps']}")
    return out


class ProgramCalls:
    """Counts each runner program's calls by (runner, program, rows) while
    installed: the engine reads its programs off the runners each call, so a
    counting wrapper (carrying the program's compile stats) stands in."""

    NAMES = ("prefill_cfn", "chunk_cfn", "decode_cfn", "verify_cfn")

    def __init__(self, engine):
        from collections import Counter

        self.calls = Counter()
        self.saved = []
        for label, runner in (("target", engine.runner), ("draft", engine.draft_runner)):
            if runner is None:
                continue
            for name in self.NAMES:
                fn = getattr(runner, name)
                self.saved.append((runner, name, fn))
                setattr(runner, name, self._counted(label, name, fn))

    def _counted(self, label, name, fn):
        def counted(params, toks, *rest):
            self.calls[(label, name, toks.shape[0] * toks.shape[1])] += 1
            return fn(params, toks, *rest)

        counted._cs = fn._cs
        counted.__name__ = name
        return counted

    def zero(self):
        self.calls.clear()

    def remove(self):
        for runner, name, fn in self.saved:
            setattr(runner, name, fn)


def int8_linears(gpt) -> tuple:
    """([(N, K)] of one block's int8 linears, (N, K) of lm_head)."""
    from thunder_tpu_torch import nn

    blk = [tuple(m.weight.shape) for m in gpt.h[0].modules()
           if isinstance(m, nn.Linear) and m.weight.dtype == torch.int8]
    return blk, tuple(gpt.lm_head.weight.shape)


def int8_routes_expected(cudaex, gpt, calls, label: str = "target") -> dict:
    """int8_linear's launches by route that ``label``'s program calls
    account for: a call with M rows runs each block linear at M (when M <=
    QUANT_MAX_M: the checker claims no larger x) and lm_head at M (decode,
    verify: logits at every row) or 1 (prefill, chunk: the last token)."""
    blk, head = int8_linears(gpt)
    n_layer = len(gpt.h)
    out = {r: 0 for r in cudaex.int8_linear.routes}
    for (lab, name, M), n in calls.items():
        if lab != label:
            continue
        if M <= cudaex.QUANT_MAX_M:
            for N, K in blk:
                out[cudaex.weight_only_plan("int8", M, N, K, torch.bfloat16)["route"]] += n * n_layer
        Mh = M if name in ("decode_cfn", "verify_cfn") else 1
        out[cudaex.weight_only_plan("int8", Mh, *head, torch.bfloat16)["route"]] += n
    return out


def rows_by_route(cudaex, gpt, calls) -> dict:
    """Program calls by rows, and the route each of a block's int8 linears
    takes at those rows."""
    blk, _ = int8_linears(gpt)
    out = {}
    for (lab, name, M), n in sorted(calls.items()):
        routes = sorted({cudaex.weight_only_plan("int8", M, N, K, torch.bfloat16)["route"] for N, K in blk}
                        ) if M <= cudaex.QUANT_MAX_M else ["not claimed"]
        out[f"{lab} {name} M={M}"] = dict(calls=n, block_routes=routes)
    return out


def cold_wave(tt, engine, specs, zero=()) -> dict:
    """The wave again on the warm engine with its prefix cache emptied, so
    every prompt is prefilled or chunked from its first token (256-row
    chunks): the counters zeroed (and each of ``zero`` called) just before;
    tokens/s, program calls, captures and compiles."""
    engine.prefix.clear()
    cfns = engine_cfns(engine)
    compiles0, graphs0 = sum(tt.cache_misses(c) for c in cfns), graph_stats(tt, cfns)
    before = {k: getattr(engine, k) for k in ("chunk_calls", "verify_calls", "prefix_hits")}
    for z in zero:
        z()
    t0 = time.perf_counter()
    futs = [engine.submit(p, n, lane=lane) for p, n, lane in specs]
    engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(f.result().n_new_tokens for f in futs)
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, cfns).items()}
    return dict(tokens_per_s=n_tok / wall, wall_s=wall, **{k: getattr(engine, k) - v for k, v in before.items()},
                compiles_during_wave=sum(tt.cache_misses(c) for c in cfns) - compiles0,
                captures_during_wave=graphs["graph_captures"], graph_replays=graphs["graph_replays"])


def quant_fleet(tt, cudaex, cfg, seed, bf16_fleet: dict) -> dict:
    """The fleet phase's 32-request mixed wave through
    ServingEngine(quantize="int8", prefix_sharing=True, chunk_tokens=256,
    draft_gpt=gpt, spec_k=2) in bf16 (the self-draft is quantized with the
    target): tokens/s beside the bf16 fleet wave of the same call; 0
    compiles and captures; int8_linear's launches by route equal to what
    the program calls account for (verify's 24 rows on `wgmma`, decode's 8
    and the warm cache's 16-row suffix chunks on `stream`, none on
    `split`); paged_chunk_attention as the fleet phase checks it; every
    chunk, verify and decode trace claims thunder.int8_linear on every
    quantized Linear. Then the wave again with the prefix cache emptied
    (cold_wave): its 256-row chunks on `wgmma`, routes as accounted."""
    from thunder_tpu_torch.models.litgpt import GPT
    from thunder_tpu_torch.serving import ServingEngine

    gpt = GPT(cfg, torch.bfloat16, seed=seed)
    specs, kinds = mixed_specs(np.random.RandomState(seed), cfg.vocab_size, 32)
    engine = ServingEngine(gpt, max_batch=8, page_size=16, max_seq=2048, dtype=torch.bfloat16,
                           prefix_sharing=True, chunk_tokens=256, draft_gpt=gpt, spec_k=2, quantize="int8")
    calls = ProgramCalls(engine)
    zero = (lambda: count_routes(cudaex.int8_linear), calls.zero)

    def expected():
        return {r: a + b for (r, a), b in zip(int8_routes_expected(cudaex, gpt, calls.calls, "target").items(),
                                              int8_routes_expected(cudaex, gpt, calls.calls, "draft").values())}

    try:
        wave = run_wave(tt, engine, specs, zero=zero)
        routes, want, warm_calls = dict(cudaex.int8_linear.routes), expected(), dict(calls.calls)
        cold = cold_wave(tt, engine, specs, zero=zero)
        cold.update(int8_linear_routes=dict(cudaex.int8_linear.routes), int8_routes_expected=expected(),
                    program_calls=rows_by_route(cudaex, gpt, calls.calls))
    finally:
        calls.remove()
    want_chunk = 2 * cfg.n_layer * wave["chunk_calls"] + cfg.n_layer * wave["verify_calls"]
    per_call = 5 * cfg.n_layer + 1
    claims = {f"{lab} {cfn.__name__}": sum(b.impl is cudaex._int8_linear_impl
                                           for b in tt.last_traces(cfn)[-1].bound_symbols)
              for lab, runner in (("target", engine.runner), ("draft", engine.draft_runner))
              for cfn in ((runner.chunk_cfn, runner.verify_cfn) if lab == "target"
                          else (runner.chunk_cfn, runner.decode_cfn))}
    out = dict(model=cfg.name, n_layer=cfg.n_layer, dtype="bfloat16 activations, int8 weights",
               draft="self (quantized with the target)", spec_k=2, chunk_tokens=256, kinds=kinds, **wave,
               spec_accept_rate=wave["spec_accepted"] / max(1, wave["spec_proposed"]),
               int8_linear_launches=cudaex.int8_linear.launches, int8_linear_routes=routes,
               int8_routes_expected=want, program_calls=rows_by_route(cudaex, gpt, warm_calls),
               int8_claims_per_program=claims, chunk_launches_expected=want_chunk, cold_prefix_cache=cold,
               bf16_fleet_same_call={k: bf16_fleet[k] for k in ("tokens_per_s", "mean_ttft_ms", "mean_tbot_ms",
                                                                "engine_iterations")},
               tokens_per_s_vs_bf16_fleet=wave["tokens_per_s"] / bf16_fleet["tokens_per_s"])
    emit("quant_fleet", **out)
    if wave["compiles_during_wave"] or wave["captures_during_wave"]:
        raise AssertionError(f"quant_fleet: {wave['compiles_during_wave']} compiles and "
                             f"{wave['captures_during_wave']} captures during the wave")
    if routes != want or routes["split"] or not routes["wgmma"] or not routes["stream"]:
        raise AssertionError(f"quant_fleet: int8_linear launched {routes} by route, the programs account "
                             f"for {want}")
    cold_chunks = [k for k in cold["program_calls"] if k.startswith("target chunk_cfn M=256")]
    if (cold["int8_linear_routes"] != cold["int8_routes_expected"] or cold["compiles_during_wave"]
            or cold["captures_during_wave"] or not cold_chunks
            or cold["program_calls"][cold_chunks[0]]["block_routes"] != ["wgmma"]):
        raise AssertionError(f"quant_fleet: the cold wave {cold}")
    if wave["launches"]["paged_chunk_attention"] != want_chunk:
        raise AssertionError(f"quant_fleet: paged_chunk_attention launched "
                             f"{wave['launches']['paged_chunk_attention']}, want {want_chunk}")
    if any(v != per_call for v in claims.values()):
        raise AssertionError(f"quant_fleet: int8_linear claims a program {claims}, want {per_call}")
    del engine, gpt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def quant_fleet_agreement(cfg, seed) -> dict:
    """f32, TF32 off, Llama-3-1B's width at QUANT_FLEET_AGREE_LAYERS layers
    with int8-exact weights: fleet_agreement's wave (a 2-layer draft from
    another seed, prefix sharing, 256-token chunks, preemption), greedy and
    then with AGREE_SAMPLED's requests sampled, through the unquantized
    fleet engine and the int8 one: every greedy stream must be equal token
    for token, every sampled one held to the unquantized engine's under the
    sampled-agreement rule (SAMPLE_SHIFT, SAMPLE_MARGIN), each engine's
    draws read by EngineDraws."""
    from thunder_tpu_torch.models.litgpt import GPT, Config

    acfg = Config.from_name(cfg.name, n_layer=QUANT_FLEET_AGREE_LAYERS)
    gpt = GPT(acfg, torch.float32, seed=seed)
    int8_exact_(gpt, seed)
    draft = GPT(Config.from_name(cfg.name, n_layer=2), torch.float32, seed=seed + 1)
    streams, stages, taps = {}, {}, {}
    for quantize in (None, "int8"):
        engine = agreement_engine(gpt, draft, quantize=quantize)
        taps[quantize] = EngineDraws(engine)
        got = []
        for sampled in (None, AGREE_SAMPLED):
            prompts, draws, futs = agreement_wave(engine, acfg, seed, sampled)
            got.append([f.result().new_tokens for f in futs])
            engine.prefix.clear()
        taps[quantize].remove()
        streams[quantize] = got
        stages[str(quantize)] = dict(preempted=engine.preempted, resumed=engine.resumed,
                                     prefix_hits=engine.prefix_hits, verify_calls=engine.verify_calls,
                                     chunk_calls=engine.chunk_calls)
        del engine
    rows = [dict(wave="greedy", request=i, equal=bool(np.array_equal(b, a)))
            for i, (a, b) in enumerate(zip(streams[None][0], streams["int8"][0]))]
    for i, (p, (t, sd), a, b) in enumerate(zip(prompts, draws, streams[None][1], streams["int8"][1])):
        rows.append(dict(wave="sampled", request=i, equal=bool(np.array_equal(b, a))) if t == 0
                    else dict(wave="sampled", request=i, **sample_row(b, a, t, sd, len(p), taps["int8"].at,
                                                                      taps[None].at)))
    out = dict(model=f"{cfg.name} f32 at {acfg.n_layer} layers (depth cut), int8-exact weights",
               draft=f"{cfg.name} n_layer=2 seed {seed + 1}, unquantized", tf32=False, rows=rows, stages=stages,
               sampled=sampled_summary(rows))
    emit("quant_fleet_agreement", **out)
    bad = [r for r in rows if ("fault" in r if r.get("temperature", 0) > 0 else not r["equal"])]
    if bad or stages["int8"]["preempted"] < 2 or not stages["int8"]["prefix_hits"]:
        raise AssertionError(f"quant_fleet_agreement: {bad or stages}")
    del gpt, draft, taps
    torch.cuda.empty_cache()
    return out


def moe_fleet(tt, cudaex, cfg, seed, bf16_fleet: dict) -> dict:
    """MoEGPT (Llama-3-1B, 8 experts of 1024, top-2, drop-free) under
    quantize="int8" (attention linears, the router gate at N=8, lm_head) and
    every fleet stage, a 2-layer dense bf16 draft of the same vocabulary
    (seed + 1), on the mixed wave: 0 compiles and captures; grouped_mlp
    launches n_layer times each target prefill, chunk and verify call the
    engine makes (so inside the chunk and verify graphs), int8_linear by
    route as the calls account for, in the warm wave and in a cold one
    (cold_wave: 256-row chunks); the chunk and verify traces claim both.
    Then f32 at QUANT_FLEET_AGREE_LAYERS layers: fleet_agreement's wave,
    greedy and sampled, through the int8 MoE fleet engine against solo
    GPTInference of the same quantized MoEGPT, under the AGREE_GAP and
    sampled-agreement (SAMPLE_SHIFT, SAMPLE_MARGIN) rules."""
    from thunder_tpu_torch.inference import GPTInference
    from thunder_tpu_torch.models.litgpt import GPT, Config
    from thunder_tpu_torch.models.moe import MoEGPT
    from thunder_tpu_torch.serving import ServingEngine

    gpt = MoEGPT(cfg, moe_config(cfg), torch.bfloat16, seed=seed)
    draft = GPT(Config.from_name(cfg.name, n_layer=2), torch.bfloat16, seed=seed + 1)
    specs, kinds = mixed_specs(np.random.RandomState(seed), cfg.vocab_size, 32)
    engine = ServingEngine(gpt, max_batch=8, page_size=16, max_seq=2048, dtype=torch.bfloat16,
                           prefix_sharing=True, chunk_tokens=256, draft_gpt=draft, spec_k=2, quantize="int8")
    calls = ProgramCalls(engine)

    def zero():
        count_routes(cudaex.int8_linear)
        cudaex.grouped_mlp.launches = 0
        calls.zero()

    def expected():
        return (cfg.n_layer * sum(n for k, n in calls.calls.items() if k[0] == "target"),
                int8_routes_expected(cudaex, gpt, calls.calls, "target"))

    try:
        wave = run_wave(tt, engine, specs, zero=(zero,))
        grouped, routes = cudaex.grouped_mlp.launches, dict(cudaex.int8_linear.routes)
        (want_grouped, want_routes), warm_calls = expected(), dict(calls.calls)
        cold = cold_wave(tt, engine, specs, zero=(zero,))
        want_cold = expected()
        cold.update(grouped_mlp_launches=cudaex.grouped_mlp.launches, grouped_mlp_expected=want_cold[0],
                    int8_linear_routes=dict(cudaex.int8_linear.routes), int8_routes_expected=want_cold[1],
                    program_calls=rows_by_route(cudaex, gpt, calls.calls))
    finally:
        calls.remove()
    claims = {cfn.__name__: {"grouped_mlp": sum(b.impl is cudaex._grouped_mlp_impl
                                                for b in tt.last_traces(cfn)[-1].bound_symbols),
                             "int8_linear": sum(b.impl is cudaex._int8_linear_impl
                                                for b in tt.last_traces(cfn)[-1].bound_symbols)}
              for cfn in (engine.runner.chunk_cfn, engine.runner.verify_cfn)}
    m = gpt.h[0].moe.cfg
    out = dict(model=f"{cfg.name} + MoE (E={m.n_expert}, H={m.intermediate_size}, top-{m.n_expert_per_token}, "
                     f"drop-free), int8", draft=f"{cfg.name} n_layer=2 bf16 seed {seed + 1}", kinds=kinds, **wave,
               grouped_mlp_launches=grouped, grouped_mlp_expected=want_grouped,
               int8_linear_routes=routes, int8_routes_expected=want_routes,
               program_calls=rows_by_route(cudaex, gpt, warm_calls), claims=claims, cold_prefix_cache=cold,
               bf16_fleet_same_call={k: bf16_fleet[k] for k in ("tokens_per_s", "mean_ttft_ms", "mean_tbot_ms")},
               tokens_per_s_vs_bf16_fleet=wave["tokens_per_s"] / bf16_fleet["tokens_per_s"])
    del engine, gpt, draft
    gc.collect()
    torch.cuda.empty_cache()
    cold_chunks = [k for k in cold["program_calls"] if k.startswith("target chunk_cfn M=256")]
    if (wave["compiles_during_wave"] or wave["captures_during_wave"] or cold["compiles_during_wave"]
            or cold["captures_during_wave"] or not cold_chunks):
        emit("moe_fleet", **out)
        raise AssertionError("moe_fleet: compiles or captures during a wave, or no 256-row chunk in the cold one")
    if (cold["grouped_mlp_launches"] != cold["grouped_mlp_expected"]
            or cold["int8_linear_routes"] != cold["int8_routes_expected"]):
        emit("moe_fleet", **out)
        raise AssertionError(f"moe_fleet: the cold wave {cold}")
    if grouped != want_grouped or routes != want_routes or not routes["wgmma"]:
        emit("moe_fleet", **out)
        raise AssertionError(f"moe_fleet: grouped_mlp {grouped} (want {want_grouped}), "
                             f"int8 {routes} (want {want_routes})")
    if any(c != {"grouped_mlp": cfg.n_layer, "int8_linear": 3 * cfg.n_layer + 1} for c in claims.values()):
        emit("moe_fleet", **out)
        raise AssertionError(f"moe_fleet: claims {claims}")
    # f32 agreement at cut depth against the same quantized model alone
    acfg = Config.from_name(cfg.name, n_layer=QUANT_FLEET_AGREE_LAYERS)
    gpt = MoEGPT(acfg, moe_config(acfg), torch.float32, seed=seed)
    draft = GPT(Config.from_name(cfg.name, n_layer=2), torch.float32, seed=seed + 1)
    engine = agreement_engine(gpt, draft, quantize="int8")
    solo = GPTInference(gpt, max_seq=2048, dtype=torch.float32)
    tap = EngineDraws(engine)
    rows = []
    for sampled in (None, AGREE_SAMPLED):
        prompts, draws, futs = agreement_wave(engine, acfg, seed, sampled)
        rows += solo_rows(solo, prompts, draws, [f.result().new_tokens for f in futs], tap)
        engine.prefix.clear()
    tap.remove()
    out["agreement"] = dict(model=f"{acfg.name} + MoE f32 at {acfg.n_layer} layers (depth cut), int8",
                            rows=rows, tolerance=AGREE_GAP, sampled=sampled_summary(rows),
                            preempted=engine.preempted, resumed=engine.resumed, prefix_hits=engine.prefix_hits,
                            verify_calls=engine.verify_calls)
    emit("moe_fleet", **out)
    bad = rows_failing(rows)
    if bad or engine.preempted < 2:
        raise AssertionError(f"moe_fleet: streams differ from solo: {bad} (preempted {engine.preempted})")
    del engine, gpt, draft, solo, tap
    torch.cuda.empty_cache()
    return out


SLO_NEW = 64
# slo_serve's timed bf16 waves, (engine, policy attached), after an untimed
# wave on each engine: engine 0's policy is attached and detached between
# its waves, so policy and none run on one instance; engine 1 never has one,
# so 0 against 1 without a policy sizes what a second instance alone
# changes (an A/A pair). The three kinds interleave wave by wave, each at
# the same mean position (a wave is ~0.6 s of host-bound decode, and the
# host drifts by several per cent within a call).
SLO_ROUNDS = (((0, True), (0, False), (1, False)) + ((1, False), (0, False), (0, True))) * 2


class HostTime:
    """The host seconds spent in the wrapped methods of some objects."""

    def __init__(self):
        self.s = 0.0

    def wrap(self, obj, name: str) -> None:
        fn = getattr(obj, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.s += time.perf_counter() - t0

        setattr(obj, name, timed)


def slo_serve(tt, cudaex, cfg, seed) -> dict:
    """ServingEngine(slo=) over Llama-3-1B: (1) bf16, 16 requests of 128
    tokens (one prefill bucket), SLO_NEW new each, in the turns of
    SLO_ROUNDS: tokens/s of each, the policy's cost on one engine, the host
    ms its monitor takes a wave (HostTime), and a second engine's tokens/s
    against the first's without one; the loose policy's goodput must be
    1.0. (2) f32 at
    QUANT_FLEET_AGREE_LAYERS layers, the bus on: an impossible p99 TTFT
    (breached by the first retirement) while 4 batch-lane requests hold
    every slot and 4 interactive ones wait: there must be a slo.breach,
    preempted >= 1, and greedy streams equal to the same wave's through an
    engine without a policy (or differing only after a solo top-2 gap <
    AGREE_GAP)."""
    from thunder_tpu_torch import observability
    from thunder_tpu_torch.inference import GPTInference
    from thunder_tpu_torch.models.litgpt import GPT, Config
    from thunder_tpu_torch.observability import SLOPolicy
    from thunder_tpu_torch.serving import ServingEngine

    gpt = GPT(cfg, torch.bfloat16, seed=seed)
    prompts = make_prompts(np.random.RandomState(seed + 5), 16, 128, 128, cfg.vocab_size)
    loose = SLOPolicy(p99_ttft_ms=60_000.0, p99_tbot_ms=10_000.0, min_goodput=0.5, window=64, min_samples=4)
    base = dict(max_batch=8, page_size=16, max_seq=2048, dtype=torch.bfloat16)
    engines = [ServingEngine(gpt, slo=loose, **base), ServingEngine(gpt, **base)]
    for e in engines:
        e.warmup([128])
        for p in prompts:  # an untimed wave: the first after warmup runs slow
            e.submit(p, SLO_NEW)
        e.drain()
    engines[0].reset_slo_accounting()
    monitor = engines[0].slo_monitor
    host = HostTime()
    for name in ("status", "observe_request"):
        host.wrap(monitor, name)
    runs = []
    for k, with_policy in SLO_ROUNDS:
        e = engines[k]
        if k == 0:
            e.slo_policy, e.slo_monitor = (loose, monitor) if with_policy else (None, None)
        host0 = host.s
        t0 = time.perf_counter()
        futs = [e.submit(p, SLO_NEW) for p in prompts]
        e.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = [f.result() for f in futs]
        runs.append(dict(engine=k, policy=with_policy, tokens_per_s=sum(r.n_new_tokens for r in res) / wall,
                         wall_ms=1e3 * wall, monitor_host_ms=1e3 * (host.s - host0),
                         mean_ttft_ms=1e3 * float(np.mean([r.ttft_s for r in res])),
                         slo_met=sum(bool(r.slo_met) for r in res) if with_policy else None))
    engines[0].slo_policy, engines[0].slo_monitor = loose, monitor
    loose_stats = {k: engines[0].stats()[k] for k in ("requests_retired", "requests_slo_met", "goodput")}
    del engines, gpt
    gc.collect()
    torch.cuda.empty_cache()

    acfg = Config.from_name(cfg.name, n_layer=QUANT_FLEET_AGREE_LAYERS)
    g32 = GPT(acfg, torch.float32, seed=seed)
    kw = dict(max_batch=4, page_size=16, max_seq=2048, dtype=torch.float32)
    impossible = SLOPolicy(p99_ttft_ms=1e-3, window=8, min_samples=1)
    rng = np.random.RandomState(seed + 6)
    short = rng.randint(0, cfg.vocab_size, (16,)).astype(np.int32)
    batch = make_prompts(rng, 4, 128, 300, cfg.vocab_size)
    inter = make_prompts(rng, 4, 16, 64, cfg.vocab_size)

    def burn_wave(engine):
        first = engine.submit(short, 2)
        engine.drain()
        futs = [engine.submit(p, 24, lane="batch") for p in batch]
        while engine.stats()["active"] < 4:
            engine._step_once()
        futs += [engine.submit(p, 8) for p in inter]
        engine.drain()
        return [first.result().new_tokens] + [f.result().new_tokens for f in futs]

    observability.reset()
    observability.enable()
    try:
        burn = ServingEngine(g32, slo=impossible, **kw)
        got = burn_wave(burn)
        breaches = [r["attrs"] for r in observability.records()
                    if r["kind"] == "event" and r["name"] == "slo.breach"]
        counters = {k: v for k, v in observability.counters().items() if k.startswith(("slo.", "serve.preempted"))}
    finally:
        observability.disable()
        observability.reset()
    plain = ServingEngine(g32, **kw)
    want = burn_wave(plain)
    solo = GPTInference(g32, max_seq=2048, dtype=torch.float32)
    rows = []
    for p, g, w in zip([short] + batch + inter, got, want):
        if np.array_equal(g, w):
            rows.append({"prompt_len": len(p), "equal": True})
        else:
            _, m = solo.generate(torch.from_numpy(p[None, :]), len(w))
            rows.append(agree_row(g, w, m.top2_gap[0], len(p)))

    def mean_rate(k: int, policy: bool) -> float:
        return float(np.mean([r["tokens_per_s"] for r in runs if r["engine"] == k and r["policy"] == policy]))

    out = dict(model=cfg.name, bf16_runs=runs, loose_policy=repr(loose), loose_stats=loose_stats,
               tokens_per_s_with_policy=[r["tokens_per_s"] for r in runs if r["policy"]],
               tokens_per_s_without=[r["tokens_per_s"] for r in runs if r["engine"] == 0 and not r["policy"]],
               tokens_per_s_second_engine=[r["tokens_per_s"] for r in runs if r["engine"] == 1],
               policy_over_none_same_engine=mean_rate(0, True) / mean_rate(0, False),
               second_engine_over_first=mean_rate(1, False) / mean_rate(0, False),
               monitor_host_share=float(np.mean([r["monitor_host_ms"] / r["wall_ms"] for r in runs if r["policy"]])),
               burn=dict(model=f"{cfg.name} f32 at {acfg.n_layer} layers (depth cut)", policy=repr(impossible),
                         breach_reasons=sorted({b["reason"] for b in breaches}), counters=counters,
                         preempted=burn.preempted, resumed=burn.resumed, plain_preempted=plain.preempted,
                         goodput=burn.goodput(), rows=rows))
    emit("slo_serve", **out)
    policy_waves = sum(with_policy for _, with_policy in SLO_ROUNDS)
    if loose_stats["goodput"] != 1.0 or loose_stats["requests_retired"] != policy_waves * len(prompts):
        raise AssertionError(f"slo_serve: the loose policy's goodput {loose_stats}")
    if "p99-ttft" not in out["burn"]["breach_reasons"] or burn.preempted < 1 or plain.preempted:
        raise AssertionError(f"slo_serve: no burn-rate preemption: {out['burn']}")
    bad = [r for r in rows if not r["equal"] and not r["solo_top2_gap"] < AGREE_GAP]
    if bad:
        raise AssertionError(f"slo_serve: streams under the policy differ from the plain engine's: {bad}")
    del burn, plain, solo, g32
    torch.cuda.empty_cache()
    return out


SLO_TRAIN_STEPS = 4


def train_slo_pair(tt, step, idx, tgt, tokens_per_step: int) -> dict:
    """TrainStep(slo=SLOPolicy(...)) on train's module and batch (its own
    AdamW state), captured, in turns with train's unmonitored step
    (unmonitored, monitored, monitored, unmonitored) after its compile and
    capture: SLO_TRAIN_STEPS synchronized steps a turn after one untimed; ms a step of each, the
    monitor's status after the last turn (a healthy policy: no breach)."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.observability import SLOPolicy
    from thunder_tpu_torch.training import TrainStep

    policy = SLOPolicy(p99_step_ms=10_000.0, min_tokens_per_s=1_000.0, tokens_per_step=tokens_per_step,
                       window=64, min_samples=4)
    mon = TrainStep(step.tmodule, optim.AdamW(lr=TRAIN_LR), slo=policy)
    steps = {False: step, True: mon}
    mon(idx, tgt)  # compiles
    mon(idx, tgt)  # captures
    runs = []
    for monitored in (False, True, True, False):
        st = steps[monitored]
        graphs0 = graph_stats(tt, [st])
        ms, losses = timed_steps(lambda: st(idx, tgt), 1, SLO_TRAIN_STEPS)
        graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [st]).items()}
        runs.append(dict(monitored=monitored, ms_per_step=ms * 1e3, **graphs))
    status = mon.slo_monitor.status()
    out = dict(policy=repr(policy), runs=runs, slo_status=status,
               monitored_ms=[r["ms_per_step"] for r in runs if r["monitored"]],
               unmonitored_ms=[r["ms_per_step"] for r in runs if not r["monitored"]])
    emit("train_slo", **out)
    if any(r["graph_captures"] or r["graph_replays"] != SLO_TRAIN_STEPS + 1 for r in runs) \
            or status["breached"] or status["source"] != "training":
        raise AssertionError(f"train_slo: {out}")
    del mon
    return out


# ---------------------------------------------------------------------------
# phases 8-10: train, train_profile, train_agreement
# ---------------------------------------------------------------------------


def train_batch(cfg, B, T, seed):
    rng = np.random.RandomState(seed)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)).cuda()
    return idx, tgt


def reference_loss(params: dict, cfg, idx, tgt, attention, linear=None):
    """The llama loss written out in plain torch ops over GPTForCausalLM's
    parameter dict — the module math of models/litgpt.py, independent of
    the port's trace compiler. ``attention(q, k, v)`` takes roped (B, H, T,
    hs) q and (B, Hkv, T, hs) k, v; ``linear(x, name)`` applies the weight
    of that name (default: F.linear)."""
    from thunder_tpu_torch.models.litgpt import build_rope_cache

    F = torch.nn.functional
    B, T = idx.shape
    nh, ng, hs = cfg.n_head, cfg.n_query_groups, cfg.head_size
    cos, sin = build_rope_cache(T, hs, cfg.rope_base, torch.float32, idx.device)

    def rms(x, w):
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + cfg.norm_eps)
        return y.to(x.dtype) * w

    def rope(x):
        xf = x.float()
        rot = torch.cat([-xf[..., hs // 2:], xf[..., :hs // 2]], -1)
        return (xf * cos + rot * sin).to(x.dtype)

    lin = linear or (lambda x, name: F.linear(x, params[name]))
    x = F.embedding(idx.long(), params["gpt.wte.weight"])
    for i in range(cfg.n_layer):
        w = lambda n: params[f"gpt.h.{i}.{n}"]  # noqa: E731
        wl = lambda y, n: lin(y, f"gpt.h.{i}.{n}.weight")  # noqa: E731
        qkv = wl(rms(x, w("norm_1.weight")), "attn.attn")
        qkv = qkv.view(B, T, ng, nh // ng + 2, hs)
        q = qkv[:, :, :, :nh // ng].reshape(B, T, nh, hs).transpose(1, 2)
        k = qkv[:, :, :, nh // ng].transpose(1, 2)
        v = qkv[:, :, :, nh // ng + 1].transpose(1, 2)
        y = attention(rope(q), rope(k), v).transpose(1, 2).reshape(B, T, nh * hs)
        x = x + wl(y, "attn.proj")
        h = rms(x, w("norm_2.weight"))
        x = x + wl(F.silu(wl(h, "mlp.fc_1")) * wl(h, "mlp.fc_2"), "mlp.proj")
    logits = lin(rms(x, params["gpt.ln_f.weight"]), "gpt.lm_head.weight")
    return F.cross_entropy(logits.reshape(B * T, -1).float(), tgt.reshape(-1).long())


def plain_attention(q, k, v):
    """Causal softmax attention written out in f32, GQA by repeating k/v."""
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    T = q.shape[2]
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=q.device).tril(), float("-inf"))
    return torch.matmul(torch.softmax(s, -1), v)


def sdpa_attention(q, k, v):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=q.shape[1] != k.shape[1])


class ReferenceAdamW:
    """AdamW written out as thunder_tpu/optim.py:83-106 (f32 moments, decay
    then step), over lists of tensors with torch's multi-tensor ops."""

    def __init__(self, params: list, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01):
        self.params, self.lr, (self.b1, self.b2), self.eps, self.wd = params, lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.v = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: list):
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        g32 = [g.float() for g in grads]
        self.m = torch._foreach_add(torch._foreach_mul(self.m, self.b1), torch._foreach_mul(g32, 1 - self.b1))
        self.v = torch._foreach_add(torch._foreach_mul(self.v, self.b2),
                                    torch._foreach_mul(torch._foreach_mul(g32, g32), 1 - self.b2))
        upd = torch._foreach_div(torch._foreach_div(self.m, bc1),
                                 torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(self.v, bc2)),
                                                    self.eps))
        p32 = [p.float() for p in self.params]
        p32 = torch._foreach_sub(p32, torch._foreach_mul(p32, self.lr * self.wd))
        p32 = torch._foreach_sub(p32, torch._foreach_mul(upd, self.lr))
        for p, q in zip(self.params, p32):
            p.copy_(q)


def reference_step(params: dict, opt: ReferenceAdamW, cfg, idx, tgt, attention, autocast: bool,
                   linear=None, loss_fn=reference_loss):
    with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
        loss = loss_fn(params, cfg, idx, tgt, attention, linear)
    grads = torch.autograd.grad(loss, opt.params)
    opt.step(grads)
    return loss.detach()


def timed_steps(step, warmup: int, n: int) -> tuple[float, list]:
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(n)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, [float(x) for x in losses]


def step_bound(model, cfg, B, T) -> dict:
    """The least time one train step could take on the card, from shapes:
    operations are 6 per weight of every matmul per token (forward and
    backward) plus causal attention's 4·B·H·T²·hs/2 forward and 2.5× that
    backward; bytes are the f32 parameters and AdamW moments read and
    written once and the batch read once."""
    n_mm = sum(p.numel() for name, p in model.named_parameters() if p.ndim == 2 and "wte" not in name)
    n_all = sum(p.numel() for p in model.parameters())
    ops = 6 * n_mm * B * T + 3.5 * cfg.n_layer * 4 * B * cfg.n_head * T * T * cfg.head_size / 2
    b, by = bound_ms(2 * 3 * 4 * n_all + 2 * B * T * 4, ops, "bfloat16")
    return dict(model_ops_per_step=ops, bound_ms=b, bound_by=by)


def train(tt, cudaex, seed) -> dict:
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    B, T, n_steps = 4, 2048, 10
    cfg = Config.from_name("llama-350m", block_size=T)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, torch.float32, seed=seed)
    step = TrainStep(tt.jit(model, transforms=[AutocastTransform()]), optim.AdamW(lr=TRAIN_LR))
    idx, tgt = train_batch(cfg, B, T, seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = float(step(idx, tgt))
    compile_s = time.perf_counter() - t0
    for _ in range(2):
        step(idx, tgt)
    torch.cuda.synchronize()
    cudaex.flash_rope_attention.launches = 0
    cudaex.flash_rope_attention_backward.launches = 0
    cudaex.rms_norm.launches = 0
    cudaex.adamw_update.launches = 0
    graphs0 = graph_stats(tt, [step])
    step_s, losses = timed_steps(lambda: step(idx, tgt), 0, n_steps)
    launches = {"flash_rope_fwd": cudaex.flash_rope_attention.launches,
                "flash_rope_bwd": cudaex.flash_rope_attention_backward.launches,
                "rms_norm": cudaex.rms_norm.launches, "adamw": cudaex.adamw_update.launches}
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [step]).items()}
    if graphs != {"graph_captures": 0, "graph_replays": n_steps}:
        raise AssertionError(f"train: the timed steps ran {graphs}, want {n_steps} replays and no capture")
    want = cfg.n_layer * n_steps
    if launches["flash_rope_fwd"] != want or launches["flash_rope_bwd"] != want:
        raise AssertionError(f"flash launches {launches} over {n_steps} steps, want {want} each")
    losses = [first] + losses
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}")
    fwd = tt.last_traces(step)[-1].bound_symbols
    bwd = tt.last_backward_traces(step)[-1].bound_symbols
    claims = {"forward": sorted({b.sym.id for b in fwd if b.sym.id == "cuda.rope_flash_fwd"
                                 and b.impl is cudaex._rope_flash_fwd_impl}),
              "backward": sorted({b.sym.id for b in bwd if b.sym.id == "cuda.rope_flash_bwd"
                                  and b.impl is cudaex._rope_flash_bwd_impl})}
    if claims != {"forward": ["cuda.rope_flash_fwd"], "backward": ["cuda.rope_flash_bwd"]}:
        raise AssertionError(f"the step's cuda claims are {claims}")
    ops = {name: sum(1 for b in t if b.sym.name not in ("python_del", "python_return"))
           for name, t in (("forward", fwd), ("backward", bwd))}
    bound = step_bound(model, cfg, B, T)
    out = dict(model=cfg.name, n_layer=cfg.n_layer, B=B, T=T, dtype="bf16 autocast, f32 master",
               steps=n_steps, ms_per_step=step_s * 1e3, tokens_per_s=B * T / step_s,
               mfu=bound["model_ops_per_step"] / step_s / PEAK_OPS["bfloat16"], **bound,
               compile_s=compile_s, init_s=t_init, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses, launches=launches, claims=claims, ops_per_step=ops, **graphs)
    emit("train", **out)
    prof = train_profile(step, idx, tgt)
    train_pair("train", step, idx, tgt, (cudaex.flash_rope_attention, cudaex.flash_rope_attention_backward,
                                         cudaex.adamw_update))
    out["slo"] = train_slo_pair(tt, step, idx, tgt, B * T)
    del step, model
    torch.cuda.empty_cache()
    out["baseline"] = baseline(cfg, B, T, n_steps, seed, bound["model_ops_per_step"])
    return out, prof


# Device kernels by what they do, by name: the first kind with a matching
# mark wins.
KERNEL_KINDS = (
    ("collective", ("nccl",)),
    ("attention", ("flash_fwd_", "flash_bwd_", "ring_bwd_")),
    ("conv", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "nchwToNhwc", "nhwcToNchw")),
    ("pooling", ("max_pool", "avg_pool")),
    ("fp8_linear", ("fp8_linear_",)),
    ("grouped_mlp", ("grouped_mlp_",)),
    ("scan", ("scan_outer_dim", "scan_innermost_dim")),
    ("matmul", ("nvjet", "gemm", "cutlass", "cublas")),
    ("optimizer", ("adamw_kernel", "multi_tensor_apply")),
    # a one-rank NCCL collective is one device-to-device copy ("memcpy128",
    # "memcpy32_post" inside a graph)
    ("memcpy", ("Memcpy", "memcpy")),
    ("reduction", ("reduce_kernel",)),
    ("copy_cast", ("direct_copy", "copy_kernel")),
    ("elementwise", ("elementwise_kernel", "index_elementwise")),
)


def train_profile(step, idx, tgt, phase: str = "train_profile") -> dict:
    """Device busy share over 2 steps, the kernels that took the time (by
    name and by kind, per step), and the kernel launches a step. The 2
    steps are profiled twice (profile_twice); the first is read."""
    def run():
        for _ in range(2):
            step(idx, tgt)

    prof, check = profile_twice(phase, run)
    rows, wall_us = prof["rows"], prof["wall_us"]
    nccl_host = [(e.key, e.count, e.cpu_time_total) for e in prof["prof"].key_averages()
                 if e.key.startswith("nccl:") and not str(e.device_type).endswith("CUDA")]
    busy_us = sum(r[0] for r in rows)
    by_kind: dict = {}
    count_by_kind: dict = {}
    other = []
    for us, k, c in rows:
        kind = next((kind for kind, marks in KERNEL_KINDS if any(m in k for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / 2
        count_by_kind[kind] = count_by_kind.get(kind, 0) + c / 2
        if kind == "other":
            other.append({"name": k[:80], "device_ms": us / 1e3 / 2, "count": c / 2})
    out = dict(steps=2, wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               idle_share=(1 - busy_us / wall_us) if busy_us else None,
               kernel_launches_per_step=sum(r[2] for r in rows) / 2,
               device_ms_per_step_by_kind=by_kind, kernels_per_step_by_kind=count_by_kind,
               top=[{"name": k[:80], "device_ms": us / 1e3, "count": c} for us, k, c in rows[:12]],
               other_per_step=other[:6], two_profiles=check)
    if nccl_host or "collective" in by_kind:
        out["nccl"] = dict(
            device_ms_per_step=by_kind.get("collective", 0.0),
            device_kernels_per_step=sum(c for _, k, c in rows if "nccl" in k) / 2,
            host_calls_per_step={k: c / 2 for k, c, _ in nccl_host},
            host_ms_per_step=sum(us for _, _, us in nccl_host) / 1e3 / 2)
    emit(phase, **out)
    return out


def baseline(cfg, B, T, n_steps, seed, model_ops) -> dict:
    """The hand-written plain-PyTorch step at the train phase's shape: bf16
    autocast, F.scaled_dot_product_attention, the reference AdamW. Its
    weights are random (seeded); only its speed is read."""
    from thunder_tpu_torch.models.litgpt import GPTForCausalLM

    model = GPTForCausalLM(cfg, torch.float32, seed=seed)
    params = {k: p.detach().requires_grad_() for k, p in model.named_parameters()}
    opt = ReferenceAdamW(list(params.values()), TRAIN_LR)
    idx, tgt = train_batch(cfg, B, T, seed)
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = timed_steps(
        lambda: reference_step(params, opt, cfg, idx, tgt, sdpa_attention, True), 2, n_steps)
    out = dict(ms_per_step=step_s * 1e3, baseline_tokens_per_s=B * T / step_s,
               mfu=model_ops / step_s / PEAK_OPS["bfloat16"], losses=losses,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("train_baseline", **out)
    del model, params, opt
    torch.cuda.empty_cache()
    return out


def train_agreement(tt, cudaex, seed) -> dict:
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.training import TrainStep

    B, T, n_steps = 1, 2048, 3
    cfg = Config.from_name("llama-350m", n_layer=2, block_size=T)
    model = GPTForCausalLM(cfg, torch.float32, seed=seed)
    ref = {k: p.detach().clone().requires_grad_() for k, p in model.named_parameters()}
    idx, tgt = train_batch(cfg, B, T, seed)
    step = TrainStep(tt.jit(model), optim.AdamW(lr=TRAIN_LR))
    opt = ReferenceAdamW(list(ref.values()), TRAIN_LR)
    n0 = cudaex.flash_rope_attention.launches
    got = [float(step(idx, tgt)) for _ in range(n_steps)]
    want = [float(reference_step(ref, opt, cfg, idx, tgt, plain_attention, False))
            for _ in range(n_steps)]
    if cudaex.flash_rope_attention.launches - n0 != cfg.n_layer * n_steps:
        raise AssertionError("the f32 step did not run the flash kernels")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    diffs = torch.cat([(p.detach() - ref[k].detach()).abs().flatten()
                       for k, p in model.named_parameters()])
    out = dict(model=f"{cfg.name} n_layer=2", B=B, T=T, steps=n_steps, tf32=False,
               losses=got, reference_losses=want, loss_max_rel=loss_rel, loss_rtol=LOSS_RTOL,
               param_max_abs=diffs.max().item(), param_p999_abs=torch.quantile(
                   diffs[torch.randperm(diffs.numel(), device=diffs.device)[:1 << 24]], 0.999).item(),
               param_atol=PARAM_ATOL)
    emit("train_agreement", **out)
    if not loss_rel <= LOSS_RTOL or not out["param_max_abs"] <= PARAM_ATOL:
        raise AssertionError(f"train agreement: losses {loss_rel}, params {out['param_max_abs']}")
    del step, model, ref, opt
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 11-13: fp8 training, its agreement, LoRA
# ---------------------------------------------------------------------------

# The f32 fp8 step against the hand-written fp8 reference. Both quantize
# with the same scales, but an activation or gradient that the port computes
# in another summation order can land on the other side of an e4m3 or e5m2
# rounding boundary (e5m2 keeps 2 mantissa bits: one code is 25 % of an
# element), and the port's backward products run through cuBLAS's fp8 GEMM.
# So many gradient elements near 0 flip sign, and each flip moves a weight
# apart by the most two AdamW steps can: the bias-corrected m̂/√v̂ averages g
# and g² with slightly different weights, so |m̂/√v̂| reaches 1, 1.0013 and
# 1.0036 at steps 1-3 (Cauchy-Schwarz): FP8_PARAM_ATOL = 2 lr (1 + 1.0013 +
# 1.0036), where 2 lr·3 (PARAM_ATOL) is not quite enough (5.96e-4 measured
# on an H100). The losses: within FP8_LOSS_RTOL (4.7e-5 on the CPU at width
# 256, 1.7e-5 on an H100).
# The histories: the weights' amaxes of the first step are the same maxima of
# the same weights and must be equal; every entry is held to FP8_HIST_RTOL,
# the relative move of a weight amax by PARAM_ATOL at llama-350m's smallest
# init bound (1/sqrt(2816) = 0.019: 3.2e-2); the activations' amaxes move
# with the weights.
FP8_LOSS_RTOL = 5e-4
FP8_HIST_RTOL = 5e-2
ADAMW_FLIP_ATOL = 2 * TRAIN_LR * (1 + 1.0013 + 1.0036)
FP8_PARAM_ATOL = ADAMW_FLIP_ATOL


def fp8_q(x, scale, fmt_max: float, dtype):
    return torch.clamp(x.float() * scale, -fmt_max, fmt_max).to(dtype)


def fp8_scale(hist, fmt_max: float = 448.0):
    """Delayed scale from an amax history: fmt_max / max(history), 1 while
    the history is empty (one rounded division, as jnp divides)."""
    amax = hist.max().float()
    return torch.where(amax > 0, torch.full_like(amax, fmt_max) / amax.clamp_min(1e-12), 1.0)


class ReferenceFP8Linear(torch.autograd.Function):
    """thunder_tpu/transforms/fp8_training.py's delayed-scaling linear written
    out in plain torch, independent of the port: e4m3 codes of x and w from
    the history scales, the f32 product of the codes over sx·sw; backward:
    the gradient quantized to e5m2 with current scaling, f32 products of the
    codes."""

    @staticmethod
    def forward(ctx, x, w, sx, sw):
        xq, wq = fp8_q(x, sx, 448.0, torch.float8_e4m3fn), fp8_q(w, sw, 448.0, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq, sx, sw)
        return (torch.matmul(xq.float(), wq.float().t()) / (sx * sw)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, wq, sx, sw = ctx.saved_tensors
        amax = g.abs().max().float().clamp_min(1e-12)
        sg = torch.full_like(amax, 57344.0) / amax
        gq = fp8_q(g, sg, 57344.0, torch.float8_e5m2).float()
        dx = torch.matmul(gq, wq.float()) / (sg * sw)
        dw = torch.matmul(gq.t(), xq.float()) / (sg * sx)
        return dx.to(g.dtype), dw.to(g.dtype), None, None


class ReferenceFP8Linears:
    """The amax histories of every linear (by weight name, newest amax at
    slot 0) and the linear that reads them for its scales and rolls them."""

    def __init__(self, names, device, length: int = 16):
        self.hist = {n: (torch.zeros(length, device=device), torch.zeros(length, device=device))
                     for n in names}
        self.params = None

    def __call__(self, x, name):
        hx, hw = self.hist[name]
        w = self.params[name]
        x2 = x.reshape(-1, x.shape[-1])
        y = ReferenceFP8Linear.apply(x2, w, fp8_scale(hx), fp8_scale(hw))
        with torch.no_grad():
            self.hist[name] = (torch.cat([x2.abs().max().float().reshape(1), hx[:-1]]),
                               torch.cat([w.abs().max().float().reshape(1), hw[:-1]]))
        return y.reshape(*x.shape[:-1], y.shape[-1])


def fp8_histories(model) -> dict:
    return {k: b for k, b in model.named_buffers() if "fp8_amax" in k}


def fp8_train(tt, cudaex, seed, bf16: dict) -> dict:
    """The train phase's step with FP8TrainingTransform after autocast:
    every linear through fp8_linear (5 a layer + lm_head), the backward's
    products through torch._scaled_mm."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms import fp8_training as fp8
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    B, T, n_steps = 4, 2048, 10
    cfg = Config.from_name("llama-350m", block_size=T)
    model = GPTForCausalLM(cfg, torch.float32, seed=seed)
    step = TrainStep(tt.jit(model, transforms=[AutocastTransform(), fp8.FP8TrainingTransform()]),
                     optim.AdamW(lr=TRAIN_LR))
    idx, tgt = train_batch(cfg, B, T, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = float(step(idx, tgt))
    compile_s = time.perf_counter() - t0
    for _ in range(2):
        step(idx, tgt)
    torch.cuda.synchronize()
    cudaex.fp8_linear.launches = 0
    cudaex.flash_rope_attention.launches = 0
    cudaex.flash_rope_attention_backward.launches = 0
    for k in fp8.BACKWARD_ROUTES:
        fp8.BACKWARD_ROUTES[k] = 0
    graphs0 = graph_stats(tt, [step])
    step_s, losses = timed_steps(lambda: step(idx, tgt), 0, n_steps)
    launches = {"fp8_linear": cudaex.fp8_linear.launches,
                "flash_rope_fwd": cudaex.flash_rope_attention.launches,
                "flash_rope_bwd": cudaex.flash_rope_attention_backward.launches}
    routes = dict(fp8.BACKWARD_ROUTES)
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [step]).items()}
    require_replayed("fp8_train", graphs)
    fwd = [b for b in tt.last_traces(step)[-1].bound_symbols if b.sym.id == "fp8_train_ex.train_linear_aug"]
    n_fp8 = len(fwd)
    arriving: dict = {}
    for b in fwd:
        x, w = b.args[0], b.args[1]
        key = f"M={x.shape[0]} N={w.shape[0]} K={w.shape[1]} x {x.dtype.name} w {w.dtype.name}"
        arriving[key] = arriving.get(key, 0) + 1
    if n_fp8 != 5 * cfg.n_layer + 1:
        raise AssertionError(f"the forward trace holds {n_fp8} fp8 linears, want {5 * cfg.n_layer + 1}")
    want = {"fp8_linear": n_fp8 * n_steps, "flash_rope_fwd": cfg.n_layer * n_steps,
            "flash_rope_bwd": cfg.n_layer * n_steps}
    if launches != want or routes != {"scaled_mm": 2 * n_fp8 * n_steps, "f32": 0}:
        raise AssertionError(f"launches {launches}, backward routes {routes}; want {want}")
    losses = [first] + losses
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"fp8 train losses {losses}")
    hists = fp8_histories(model)
    n_filled = min(3 + n_steps, 16)
    empty = [k for k, h in hists.items() if not bool((h[:n_filled] > 0).all())]
    if len(hists) != 2 * n_fp8 or empty:
        raise AssertionError(f"{len(hists)} amax histories, not filled: {empty[:4]}")
    out = dict(model=cfg.name, n_layer=cfg.n_layer, B=B, T=T,
               dtype="bf16 autocast, fp8 linears (e4m3 fwd, e5m2 grads), f32 master", steps=n_steps,
               ms_per_step=step_s * 1e3, tokens_per_s=B * T / step_s, compile_s=compile_s,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               bf16_ms_per_step=bf16["ms_per_step"], bf16_peak_memory_gb=bf16["peak_memory_gb"],
               losses=losses, launches=launches, fp8_linears_per_step=n_fp8, backward_routes=routes,
               arriving=arriving, histories=len(hists),
               lm_head_x_hist=hists["gpt.lm_head.fp8_amax_x_hist"][:4].tolist(), **graphs)
    emit("fp8_train", **out)
    out["profile"] = train_profile(step, idx, tgt, "fp8_train_profile")
    del step, model, hists
    torch.cuda.empty_cache()
    return out


def fp8_train_agreement(tt, cudaex, seed) -> dict:
    """f32, TF32 off: the port's fp8 TrainStep against the hand-written
    reference step with ReferenceFP8Linear on every linear, from the same
    weights and batch, 3 steps."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.fp8_training import FP8TrainingTransform

    B, T, n_steps = 1, 2048, 3
    cfg = Config.from_name("llama-350m", n_layer=2, block_size=T)
    model = GPTForCausalLM(cfg, torch.float32, seed=seed)
    ref = {k: p.detach().clone().requires_grad_() for k, p in model.named_parameters()}
    names = [k for k, p in ref.items() if p.ndim == 2 and "wte" not in k]
    lin = ReferenceFP8Linears(names, ref[names[0]].device)
    lin.params = ref
    idx, tgt = train_batch(cfg, B, T, seed)
    step = TrainStep(tt.jit(model, transforms=[FP8TrainingTransform()]), optim.AdamW(lr=TRAIN_LR))
    opt = ReferenceAdamW(list(ref.values()), TRAIN_LR)
    n0 = cudaex.fp8_linear.launches
    got = [float(step(idx, tgt)) for _ in range(n_steps)]
    want = [float(reference_step(ref, opt, cfg, idx, tgt, plain_attention, False, lin))
            for _ in range(n_steps)]
    if cudaex.fp8_linear.launches - n0 != len(names) * n_steps:
        raise AssertionError("the f32 fp8 step did not run the fp8 kernel on every linear")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    hists = fp8_histories(model)
    hist_rel, n_equal, n_all, first_w_equal = 0.0, 0, 0, True
    for name in names:
        for r, h_ref in zip("xw", lin.hist[name]):
            h = hists[name.replace("weight", f"fp8_amax_{r}_hist")]
            hist_rel = max(hist_rel, ((h - h_ref).abs() / h_ref.abs().clamp_min(1e-30)).max().item())
            n_equal += int((h == h_ref).sum())
            n_all += h.numel()
            if r == "w":  # slot n_steps - 1 holds the first step's amax
                first_w_equal &= bool(h[n_steps - 1] == h_ref[n_steps - 1])
    diffs = torch.cat([(p.detach() - ref[k].detach()).abs().flatten() for k, p in model.named_parameters()])
    out = dict(model=f"{cfg.name} n_layer=2", B=B, T=T, steps=n_steps, tf32=False, losses=got,
               reference_losses=want, loss_max_rel=loss_rel, loss_rtol=FP8_LOSS_RTOL,
               hist_max_rel=hist_rel, hist_rtol=FP8_HIST_RTOL, hist_entries_equal=n_equal,
               hist_entries=n_all, first_step_weight_amax_equal=first_w_equal,
               param_max_abs=diffs.max().item(), param_atol=FP8_PARAM_ATOL)
    emit("fp8_train_agreement", **out)
    if not (loss_rel <= FP8_LOSS_RTOL and hist_rel <= FP8_HIST_RTOL and first_w_equal
            and out["param_max_abs"] <= FP8_PARAM_ATOL):
        raise AssertionError(f"fp8 train agreement: losses {loss_rel}, histories {hist_rel}, "
                             f"params {out['param_max_abs']}")
    del step, model, ref, opt, lin
    torch.cuda.empty_cache()
    return out


def lora_train(tt, cudaex, seed) -> dict:
    """llama-350m with LORATransform(r=8, lora_alpha=16) after bf16
    autocast, every base parameter frozen (the transform freezes the Linears
    it adapts; the embedding and norms are frozen here, as a LoRA user
    does): only the adapters may change. A compile step and a capture step,
    then n_steps - 1 timed ones."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.autocast import AutocastTransform
    from thunder_tpu_torch.transforms.lora import LORATransform

    B, T, n_steps = 4, 2048, 10
    cfg = Config.from_name("llama-350m", block_size=T)
    model = GPTForCausalLM(cfg, torch.float32, seed=seed)
    tmod = tt.jit(model, transforms=[AutocastTransform(), LORATransform(r=8, lora_alpha=16)])
    for k, p in model.named_parameters():
        if "lora_" not in k:
            p.requires_grad_(False)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = TrainStep(tmod, optim.AdamW(lr=TRAIN_LR))
    idx, tgt = train_batch(cfg, B, T, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = float(step(idx, tgt))
    compile_s = time.perf_counter() - t0
    step(idx, tgt)  # captures the step's graph (untimed)
    n0 = cudaex.flash_rope_attention.launches
    graphs0 = graph_stats(tt, [step])
    step_s, losses = timed_steps(lambda: step(idx, tgt), 0, n_steps - 1)
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [step]).items()}
    require_replayed("lora_train", graphs)
    losses = [first] + losses
    adapters = [k for k in before if "lora_" in k]
    changed = [k for k, p in model.named_parameters() if not torch.equal(p.detach(), before[k])]
    out = dict(model=cfg.name, n_layer=cfg.n_layer, B=B, T=T, r=8, lora_alpha=16,
               dtype="bf16 autocast, f32 master", steps=n_steps, ms_per_step=step_s * 1e3,
               tokens_per_s=B * T / step_s, compile_s=compile_s,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses,
               adapters=len(adapters), adapter_params=sum(before[k].numel() for k in adapters),
               params=sum(p.numel() for p in before.values()), changed=len(changed),
               flash_rope_fwd_launches=cudaex.flash_rope_attention.launches - n0, **graphs)
    emit("lora_train", **out)
    if len(adapters) != 2 * (5 * cfg.n_layer + 1) or sorted(changed) != sorted(adapters):
        raise AssertionError(f"lora: {len(adapters)} adapters; changed {len(changed)}, "
                             f"base changed {sorted(set(changed) - set(adapters))[:4]}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"lora losses {losses}")
    if out["flash_rope_fwd_launches"] != cfg.n_layer * (n_steps - 1):
        raise AssertionError("the LoRA step did not run the flash kernels")
    del step, tmod, model, before
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 14-17: NanoGPT training, its forward loss and agreement; remat
# ---------------------------------------------------------------------------


def nano_reference_loss(params: dict, cfg, idx, tgt, attention, linear=None):
    """NanoGPT's loss written out in plain torch ops over NanoGPT's parameter
    dict (models/nanogpt.py's module math): learned positions, LayerNorm
    with bias, tanh GELU, ``attention(q, k, v)`` on (B, H, T, hs) heads.
    ``linear(x, name)`` applies the weight of that name (default:
    F.linear); the biases are added after it."""
    F = torch.nn.functional
    B, T = idx.shape
    C, nh = cfg.n_embd, cfg.n_head
    lin = linear or (lambda x, name: F.linear(x, params[name]))

    def dense(x, name):
        return lin(x, f"{name}.weight") + params[f"{name}.bias"]

    def ln(x, name):
        return F.layer_norm(x, (C,), params[f"{name}.weight"], params[f"{name}.bias"], 1e-5)

    x = F.embedding(idx.long(), params["wte.weight"]) + params["wpe.weight"][:T]
    for i in range(cfg.n_layer):
        q, k, v = dense(ln(x, f"h.{i}.ln_1"), f"h.{i}.attn.c_attn").split(C, -1)
        q, k, v = (t.reshape(B, T, nh, C // nh).transpose(1, 2) for t in (q, k, v))
        y = attention(q, k, v).transpose(1, 2).reshape(B, T, C)
        x = x + dense(y, f"h.{i}.attn.c_proj")
        h = F.gelu(dense(ln(x, f"h.{i}.ln_2"), f"h.{i}.mlp.c_fc"), approximate="tanh")
        x = x + dense(h, f"h.{i}.mlp.c_proj")
    logits = lin(ln(x, "ln_f"), "lm_head.weight")
    return F.cross_entropy(logits.reshape(B * T, -1).float(), tgt.reshape(-1).long())


def nano_bound(model, cfg, B, T) -> dict:
    """step_bound for NanoGPT: 6 operations per matmul weight per token, plus
    causal attention's 3.5 x 4·B·H·T²·hs/2 (forward and backward); bytes:
    f32 parameters and AdamW moments read and written once."""
    n_mm = sum(p.numel() for name, p in model.named_parameters() if p.ndim == 2 and "wte" not in name
               and "wpe" not in name)
    n_all = sum(p.numel() for p in model.parameters())
    hs = cfg.n_embd // cfg.n_head
    ops = 6 * n_mm * B * T + 3.5 * cfg.n_layer * 4 * B * cfg.n_head * T * T * hs / 2
    b, by = bound_ms(2 * 3 * 4 * n_all + 2 * B * T * 4, ops, "bfloat16")
    return dict(model_ops_per_step=ops, bound_ms=b, bound_by=by)


def nano_train(tt, cudaex, seed) -> dict:
    """TrainStep(jit(NanoGPT(gpt2), [AutocastTransform()]), AdamW) at
    bench.py's nanogpt-124m shape (B=8, T=1024), full width and depth: the
    first call timed as compile, 2 warm-up and 10 timed steps; the flash
    counters zeroed just before the timed steps must read 12 x 10 each. Then
    its profile and the hand-written baseline in the same call."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.nanogpt import NanoGPT, configs
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    B, T, n_steps = 8, 1024, 10
    cfg = configs["gpt2"]
    reset_peak_memory()
    model = NanoGPT(cfg, torch.float32, seed=seed)
    step = TrainStep(tt.jit(model, transforms=[AutocastTransform()]), optim.AdamW(lr=TRAIN_LR))
    idx, tgt = train_batch(cfg, B, T, seed)
    t0 = time.perf_counter()
    first = float(step(idx, tgt))
    compile_s = time.perf_counter() - t0
    for _ in range(2):
        step(idx, tgt)
    torch.cuda.synchronize()
    cudaex.flash_attention.launches = 0
    cudaex.flash_attention_backward.launches = 0
    graphs0 = graph_stats(tt, [step])
    step_s, losses = timed_steps(lambda: step(idx, tgt), 0, n_steps)
    launches = {"flash_fwd": cudaex.flash_attention.launches,
                "flash_bwd": cudaex.flash_attention_backward.launches}
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [step]).items()}
    require_replayed("nano_train", graphs)
    want = cfg.n_layer * n_steps
    if launches["flash_fwd"] != want or launches["flash_bwd"] != want:
        raise AssertionError(f"nano flash launches {launches} over {n_steps} steps, want {want} each")
    losses = [first] + losses
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"nano train losses {losses}")
    fwd = tt.last_traces(step)[-1].bound_symbols
    bwd = tt.last_backward_traces(step)[-1].bound_symbols
    claims = {"forward": sum(b.impl is cudaex._flash_fwd_impl for b in fwd),
              "backward": sum(b.impl is cudaex._flash_bwd_impl for b in bwd)}
    if claims != {"forward": cfg.n_layer, "backward": cfg.n_layer}:
        raise AssertionError(f"the nano step's flash claims are {claims}")
    bound = nano_bound(model, cfg, B, T)
    out = dict(model="gpt2 (NanoGPT-124M)", n_layer=cfg.n_layer, B=B, T=T,
               dtype="bf16 autocast, f32 master", steps=n_steps, ms_per_step=step_s * 1e3,
               tokens_per_s=B * T / step_s, mfu=bound["model_ops_per_step"] / step_s / PEAK_OPS["bfloat16"],
               **bound, compile_s=compile_s, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses, launches=launches, claims=claims,
               ops_per_step={name: sum(1 for b in t if b.sym.name not in ("python_del", "python_return"))
                             for name, t in (("forward", fwd), ("backward", bwd))}, **graphs)
    emit("nano_train", **out)
    out["profile"] = train_profile(step, idx, tgt, "nano_train_profile")
    train_pair("nano_train", step, idx, tgt, (cudaex.flash_attention, cudaex.flash_attention_backward,
                                              cudaex.adamw_update))
    del step
    torch.cuda.empty_cache()
    out["baseline"] = nano_baseline(cfg, B, T, n_steps, seed, bound["model_ops_per_step"])
    return out, model


def nano_baseline(cfg, B, T, n_steps, seed, model_ops) -> dict:
    """The hand-written plain-PyTorch NanoGPT step at nano_train's shape:
    bf16 autocast, F.scaled_dot_product_attention, F.layer_norm,
    F.gelu(approximate="tanh"), the reference AdamW."""
    from thunder_tpu_torch.models.nanogpt import NanoGPT

    model = NanoGPT(cfg, torch.float32, seed=seed)
    params = {k: p.detach().requires_grad_() for k, p in model.named_parameters()}
    opt = ReferenceAdamW(list(params.values()), TRAIN_LR)
    idx, tgt = train_batch(cfg, B, T, seed)
    reset_peak_memory()
    step_s, losses = timed_steps(lambda: reference_step(params, opt, cfg, idx, tgt, sdpa_attention, True,
                                                        loss_fn=nano_reference_loss), 2, n_steps)
    out = dict(ms_per_step=step_s * 1e3, baseline_tokens_per_s=B * T / step_s,
               mfu=model_ops / step_s / PEAK_OPS["bfloat16"], losses=losses,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("nano_train_baseline", **out)
    del model, params, opt
    torch.cuda.empty_cache()
    return out


NANO_EVAL_RTOL = 1e-3


def nano_eval(tt, cudaex, model, seed) -> dict:
    """The forward loss with no gradient, ``jit(model)(idx, targets)`` under
    autocast at nano_train's shape: cross_entropy is claimed whole and
    launches its kernel on the (8192, 50304) bf16 logits. Its loss must be
    within NANO_EVAL_RTOL of F.cross_entropy on the same logits (the same
    program without targets)."""
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    B, T = 8, 1024
    cfg = model.cfg
    idx, tgt = train_batch(cfg, B, T, seed + 1)
    fn = tt.jit(model, transforms=[AutocastTransform()])
    logits = tt.jit(model, transforms=[AutocastTransform()])(idx)
    want = torch.nn.functional.cross_entropy(logits.reshape(B * T, -1).float(), tgt.reshape(-1).long()).item()
    del logits
    fn(idx, tgt)  # compile
    torch.cuda.synchronize()
    cudaex.cross_entropy.launches = 0
    cudaex.flash_attention.launches = 0
    t0 = time.perf_counter()
    loss = fn(idx, tgt).item()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"cross_entropy": cudaex.cross_entropy.launches, "flash_fwd": cudaex.flash_attention.launches}
    claimed = [b for b in tt.last_traces(fn)[-1].bound_symbols if b.impl is cudaex._cross_entropy_impl]
    out = dict(model="gpt2 (NanoGPT-124M)", B=B, T=T, dtype="bf16 autocast", ms=ms, loss=loss,
               f_cross_entropy=want, rel_err=abs(loss - want) / abs(want), rtol=NANO_EVAL_RTOL,
               launches=launches, logits_dtype=str(claimed[0].args[0].dtype) if claimed else None)
    emit("nano_eval", **out)
    if launches != {"cross_entropy": 1, "flash_fwd": cfg.n_layer} or not claimed:
        raise AssertionError(f"nano eval launches {launches}, claimed {len(claimed)}")
    if not out["rel_err"] <= NANO_EVAL_RTOL:
        raise AssertionError(f"nano eval loss {loss} vs F.cross_entropy {want}")
    return out


def nano_train_agreement(tt, cudaex, seed) -> dict:
    """f32, TF32 off, gpt2 width at 2 layers, B=1, T=256: 3 steps of the
    port's TrainStep against the hand-written step (nano_reference_loss with
    written-out attention, torch autograd, the reference AdamW) from the
    same weights and batch. Losses within LOSS_RTOL; parameters within
    PARAM_ATOL, but for the keys' third of each c_attn.bias: adding a
    constant to every key shifts each score row by a constant, which the
    softmax ignores, so that gradient is 0 up to rounding and AdamW steps
    each element by ±lr on the rounding's sign in each run: those elements
    are held to ADAMW_FLIP_ATOL, the most 3 steps can move them apart."""
    from dataclasses import replace

    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.nanogpt import NanoGPT, configs
    from thunder_tpu_torch.training import TrainStep

    B, T, n_steps = 1, 256, 3
    cfg = replace(configs["gpt2"], n_layer=2)
    model = NanoGPT(cfg, torch.float32, seed=seed)
    ref = {k: p.detach().clone().requires_grad_() for k, p in model.named_parameters()}
    idx, tgt = train_batch(cfg, B, T, seed)
    step = TrainStep(tt.jit(model), optim.AdamW(lr=TRAIN_LR))
    opt = ReferenceAdamW(list(ref.values()), TRAIN_LR)
    n0 = cudaex.flash_attention.launches
    got = [float(step(idx, tgt)) for _ in range(n_steps)]
    want = [float(reference_step(ref, opt, cfg, idx, tgt, plain_attention, False,
                                 loss_fn=nano_reference_loss)) for _ in range(n_steps)]
    if cudaex.flash_attention.launches - n0 != cfg.n_layer * n_steps:
        raise AssertionError("the f32 nano step did not run the flash kernels")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    C = cfg.n_embd
    diffs, key_bias = [], []
    for k, p in model.named_parameters():
        d = (p.detach() - ref[k].detach()).abs()
        if k.endswith("attn.c_attn.bias"):
            key_bias.append(d[C:2 * C])
            d = torch.cat([d[:C], d[2 * C:]])
        diffs.append(d.flatten())
    diffs, key_bias = torch.cat(diffs), torch.cat(key_bias)
    out = dict(model="gpt2 n_layer=2", B=B, T=T, steps=n_steps, tf32=False, losses=got,
               reference_losses=want, loss_max_rel=loss_rel, loss_rtol=LOSS_RTOL,
               param_max_abs=diffs.max().item(), param_atol=PARAM_ATOL,
               key_bias_max_abs=key_bias.max().item(), key_bias_atol=ADAMW_FLIP_ATOL)
    emit("nano_train_agreement", **out)
    if (not loss_rel <= LOSS_RTOL or not out["param_max_abs"] <= PARAM_ATOL
            or not out["key_bias_max_abs"] <= ADAMW_FLIP_ATOL):
        raise AssertionError(f"nano train agreement: losses {loss_rel}, params {out['param_max_abs']}, "
                             f"key bias {out['key_bias_max_abs']}")
    del step, model, ref, opt
    torch.cuda.empty_cache()
    return out


def saved_bytes(step, tt) -> tuple[int, int]:
    """(count, bytes) of the tensors the step's forward saves for backward."""
    saved = tt.last_traces(step)[1].bound_symbols[-1].args[0][1]
    tensors = [p for p in saved if hasattr(p, "shape")]
    return len(tensors), sum(math.prod(p.shape) * p.dtype.bytes for p in tensors)


REMAT_RTOL = 1e-5  # thunder_tpu's tests/test_remat.py: remat changes no loss


def remat_run(tt, cudaex, seed, ckpt: bool, B=1, T=2048, n_steps=5) -> dict:
    """llama-1b at full width and depth, bf16 autocast, AdamW, with
    ``activation_checkpoint`` set or not: first call timed as compile, 2
    warm-up and n_steps timed steps, then 2 profiled steps for the device
    time a step (train_profile). Peak memory from a clean start, over
    whole steps and over the forward and backward programs alone (read as
    the optimizer update starts: AdamW's param-sized temporaries come after
    the programs have freed their tensors). The step is a CUDA graph from
    its second call, so those two peaks are read in its first (op by op)
    and second (captured: the graph's pool) calls, where the update runs
    Python; the whole-step peak covers every step."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    cfg = Config.from_name("llama-1b", block_size=T, activation_checkpoint=ckpt)
    reset_peak_memory()
    model = GPTForCausalLM(cfg, torch.float32, seed=seed)
    opt = optim.AdamW(lr=TRAIN_LR)
    step = TrainStep(tt.jit(model, transforms=[AutocastTransform()]), opt)
    idx, tgt = train_batch(cfg, B, T, seed)
    peaks = {"programs": 0, "update": 0}
    update = opt.update

    def measured_update(*a, **k):
        peaks["programs"] = max(peaks["programs"], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        out = update(*a, **k)
        peaks["update"] = max(peaks["update"], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return out

    opt.update = measured_update
    t0 = time.perf_counter()
    first = float(step(idx, tgt))
    compile_s = time.perf_counter() - t0
    for _ in range(2):
        step(idx, tgt)
    torch.cuda.synchronize()
    cudaex.flash_rope_attention.launches = 0
    cudaex.flash_rope_attention_backward.launches = 0
    graphs0 = graph_stats(tt, [step])
    step_s, losses = timed_steps(lambda: step(idx, tgt), 0, n_steps)
    launches = (cudaex.flash_rope_attention.launches, cudaex.flash_rope_attention_backward.launches)
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [step]).items()}
    require_replayed("remat_train", graphs)
    fwd = tt.last_traces(step)[-1].bound_symbols
    bwd = tt.last_backward_traces(step)[-1].bound_symbols
    planned = sum(b.sym.id == "cuda.rope_flash_fwd" for b in fwd) + sum(
        b.sym.id == "cuda.rope_flash_fwd" for b in bwd)
    n_saved, nbytes = saved_bytes(step, tt)
    prof = train_profile(step, idx, tgt, f"remat_train_{'ckpt' if ckpt else 'plain'}_profile")
    out = dict(activation_checkpoint=ckpt, ms_per_step=step_s * 1e3, tokens_per_s=B * T / step_s,
               device_ms_per_step=prof["device_busy_ms"] / prof["steps"],
               attention_device_ms_per_step=prof["device_ms_per_step_by_kind"].get("attention"),
               compile_s=compile_s, peak_memory_gb=max(peaks.values()) / 1e9,
               programs_peak_memory_gb=peaks["programs"] / 1e9, update_peak_memory_gb=peaks["update"] / 1e9,
               saved_for_backward=n_saved, saved_for_backward_gb=nbytes / 1e9, losses=[first] + losses,
               flash_rope_fwd_per_step=launches[0] / n_steps,
               flash_rope_bwd_per_step=launches[1] / n_steps,
               flash_rope_fwd_planned_per_step=planned, **graphs)
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def remat_train(tt, cudaex, seed) -> dict:
    """bench.py's llama-1b:1:2048 rows, without and with ckpt, in this order
    in one call; then the f32 losses of 3 steps with and without remat at 2
    layers, which must agree to REMAT_RTOL."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.training import TrainStep

    runs = {name: remat_run(tt, cudaex, seed, ckpt) for name, ckpt in (("plain", False), ("ckpt", True))}
    n_layer = Config.from_name("llama-1b").n_layer
    out = dict(model="llama-1b", n_layer=n_layer, B=1, T=2048, dtype="bf16 autocast, f32 master", **runs)
    losses = {}
    for name, ckpt in (("plain", False), ("ckpt", True)):
        cfg = Config.from_name("llama-1b", n_layer=2, block_size=2048, activation_checkpoint=ckpt)
        model = GPTForCausalLM(cfg, torch.float32, seed=seed)
        step = TrainStep(tt.jit(model), optim.AdamW(lr=TRAIN_LR))
        idx, tgt = train_batch(cfg, 1, 2048, seed)
        losses[name] = [float(step(idx, tgt)) for _ in range(3)]
        del step, model
    out["f32_losses"] = losses
    out["f32_loss_max_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses["ckpt"], losses["plain"]))
    emit("remat_train", **out)
    if runs["plain"]["flash_rope_fwd_per_step"] != n_layer:
        raise AssertionError(f"remat_train: {runs['plain']['flash_rope_fwd_per_step']} flash forwards a "
                             f"step without remat, want {n_layer}")
    for name, run in runs.items():
        if run["flash_rope_fwd_per_step"] != run["flash_rope_fwd_planned_per_step"] or \
                run["flash_rope_bwd_per_step"] != n_layer:
            raise AssertionError(f"remat_train {name}: launches a step differ from the plan: {run}")
        if not all(math.isfinite(x) for x in run["losses"]):
            raise AssertionError(f"remat_train {name} losses {run['losses']}")
    if not runs["ckpt"]["saved_for_backward_gb"] < runs["plain"]["saved_for_backward_gb"]:
        raise AssertionError("remat_train: activation_checkpoint saved no memory for the backward")
    if not out["f32_loss_max_rel"] <= REMAT_RTOL:
        raise AssertionError(f"remat_train: f32 losses {losses}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 18-21: MoE serving and training
# ---------------------------------------------------------------------------


def moe_config(cfg, capacity_factor=None, dispatch="grouped"):
    """benchmark_inference.py --moe's experts over a GPT config: 8 SwiGLU
    experts of width max(128, intermediate_size // 8) (1024 at Llama-3-1B),
    top-2; drop-free unless a capacity factor is given."""
    from thunder_tpu_torch.models.moe import MoEConfig

    return MoEConfig(n_embd=cfg.n_embd, intermediate_size=max(128, cfg.intermediate_size // 8), n_expert=8,
                     n_expert_per_token=2, capacity_factor=capacity_factor, dispatch=dispatch)


def prefill_calls(engine) -> int:
    return sum(engine.ladder.hits().values())


def moe_serve(tt, cudaex, cfg, prompts, seed, dense_wave: dict) -> dict:
    """ServingEngine over MoEGPT(Llama-3-1B, 8 experts of 1024, top-2,
    drop-free) in bf16: the serve phase's 16 requests after one warm-up
    replay of the wave (2 new tokens each). grouped_mlp must launch n_layer
    times a program call (the engine's prefill and decode calls), with 0
    compiles; the dense serve wave's numbers from the same call beside."""
    from thunder_tpu_torch.models.moe import MoEGPT
    from thunder_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    gpt = MoEGPT(cfg, moe_config(cfg), torch.bfloat16, seed=seed)
    engine = ServingEngine(gpt, max_batch=8, page_size=16, max_seq=2048, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup([len(p) for p in prompts])
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0

    reset_peak_memory()
    cfns = (engine.runner.prefill_cfn, engine.runner.decode_cfn)
    steps0, prefills0 = engine.decode_steps, prefill_calls(engine)
    compiles0, graphs0 = sum(tt.cache_misses(c) for c in cfns), graph_stats(tt, cfns)
    cudaex.grouped_mlp.launches = 0
    cudaex.rms_norm.launches = 0
    cudaex.paged_attention.launches = 0
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new_tokens=64) for p in prompts]
    engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"grouped_mlp": cudaex.grouped_mlp.launches, "rms_norm": cudaex.rms_norm.launches,
                "paged_attention": cudaex.paged_attention.launches}
    calls = {"prefill": prefill_calls(engine) - prefills0, "decode": engine.decode_steps - steps0}
    compiles = sum(tt.cache_misses(c) for c in cfns) - compiles0
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, cfns).items()}
    require_replayed("moe_serve", graphs)
    if graphs["graph_captures"]:
        raise AssertionError(f"{graphs['graph_captures']} captures during the MoE wave")
    results = [f.result() for f in futs]
    for r in results:
        if r.n_new_tokens != 64 or not ((r.new_tokens >= 0) & (r.new_tokens < cfg.padded_vocab_size)).all():
            raise AssertionError(f"request {r.request_id}: bad stream {r.new_tokens}")
    want = cfg.n_layer * (calls["prefill"] + calls["decode"])
    if launches["grouped_mlp"] != want or not (launches["rms_norm"] and launches["paged_attention"]):
        raise AssertionError(f"moe_serve launches {launches}, want grouped_mlp {cfg.n_layer} x {calls} = {want}")
    if compiles:
        raise AssertionError(f"{compiles} compiles during the MoE wave")
    for cfn in cfns:
        n = sum(b.impl is cudaex._grouped_mlp_impl for b in tt.last_traces(cfn)[-1].bound_symbols)
        if n != cfg.n_layer:
            raise AssertionError(f"{cfn.__name__}'s trace claims thunder.grouped_mlp {n} times")
    ops = {name: sum(1 for b in tt.last_traces(cfn)[-1].bound_symbols
                     if b.sym.name not in ("python_del", "python_return"))
           for name, cfn in (("prefill", cfns[0]), ("decode", cfns[1]))}
    n_tok = sum(r.n_new_tokens for r in results)
    m = gpt.h[0].moe.cfg
    out = dict(model=f"{cfg.name} + MoE (E={m.n_expert}, H={m.intermediate_size}, "
                     f"top-{m.n_expert_per_token}, drop-free)", n_layer=cfg.n_layer,
               dtype="bfloat16", params=sum(p.numel() for p in gpt.parameters()), requests=len(results),
               new_tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
               mean_ttft_ms=1e3 * float(np.mean([r.ttft_s for r in results])),
               mean_tbot_ms=1e3 * float(np.mean([r.tbot_s for r in results])),
               program_calls=calls, launches=launches, grouped_mlp_launches_expected=want,
               compiles_during_wave=compiles, captures_during_wave=graphs["graph_captures"],
               graph_replays=graphs["graph_replays"], ops_per_program_call=ops,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, init_s=t_init, warmup_s=t_warm,
               dense_wave_same_call={k: dense_wave[k] for k in ("tokens_per_s", "mean_ttft_ms", "mean_tbot_ms",
                                                                "decode_steps", "ops_per_program_call")})
    emit("moe_serve", **out)
    short = make_prompts(np.random.RandomState(1), 8, 128, 128, cfg.vocab_size)
    out["profile"] = profile_wave(engine, [(p, 32, "interactive") for p in short], "moe_serve_profile")
    del engine, gpt
    torch.cuda.empty_cache()
    return out


def moe_agreement(cfg, prompts, seed) -> dict:
    """f32, TF32 off: the MoE engine's greedy streams against solo
    GPTInference over the same MoEGPT, under the AGREE_GAP rule."""
    from thunder_tpu_torch.inference import GPTInference
    from thunder_tpu_torch.models.moe import MoEGPT
    from thunder_tpu_torch.serving import ServingEngine

    gpt = MoEGPT(cfg, moe_config(cfg), torch.float32, seed=seed)
    engine = ServingEngine(gpt, max_batch=8, page_size=16, max_seq=2048, dtype=torch.float32)
    futs = [engine.submit(p, max_new_tokens=64) for p in prompts]
    engine.drain()
    solo = GPTInference(gpt, max_seq=2048, dtype=torch.float32)
    rows = []
    for p, f in zip(prompts, futs):
        out, m = solo.generate(torch.from_numpy(p[None, :]), 64)
        rows.append(agree_row(f.result().new_tokens, out[0, len(p):].cpu().numpy(), m.top2_gap[0], len(p)))
    out = dict(model=f"{cfg.name} + MoE f32", rows=rows, tolerance=AGREE_GAP, tf32=False)
    emit("moe_agreement", **out)
    bad = [r for r in rows if not r["equal"] and not r["solo_top2_gap"] < AGREE_GAP]
    if bad:
        raise AssertionError(f"MoE streams differ from solo: {bad}")
    del engine, gpt, solo
    torch.cuda.empty_cache()
    return out


def moe_step_bound(model, cfg, moe_cfg, B, T) -> dict:
    """step_bound for MoEGPT: 6 operations per weight of every 2-d matmul
    per token, plus the experts' 3·D·H weights 6 times for each of the B·T·K
    routed rows (an upper bound: rows over capacity are dropped), plus
    causal attention; bytes as step_bound."""
    n_mm = sum(p.numel() for name, p in model.named_parameters() if p.ndim == 2 and "wte" not in name)
    n_all = sum(p.numel() for p in model.parameters())
    expert = 6 * B * T * moe_cfg.n_expert_per_token * 3 * cfg.n_embd * moe_cfg.intermediate_size * cfg.n_layer
    ops = 6 * n_mm * B * T + expert + 3.5 * cfg.n_layer * 4 * B * cfg.n_head * T * T * cfg.head_size / 2
    b, by = bound_ms(2 * 3 * 4 * n_all + 2 * B * T * 4, ops, "bfloat16")
    return dict(model_ops_per_step=ops, bound_ms=b, bound_by=by)


def moe_train(tt, cudaex, seed) -> dict:
    """TrainStep(jit(MoEGPT(Llama-3-1B, 8 experts of 1024, top-2, capacity
    factor 1.0), [AutocastTransform()]), AdamW(lr=1e-4)), f32 master
    weights, B=1, T=2048: the first call timed as compile, 2 warm-up and 10
    timed steps between zeroed counters (grouped_mlp and the flash-RoPE pair
    n_layer x 10 each); losses finite and falling; then 2 steps profiled."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config
    from thunder_tpu_torch.models.moe import MoEGPT
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    B, T, n_steps = 1, 2048, 10
    cfg = Config.from_name("Llama-3-1B", block_size=T)
    mcfg = moe_config(cfg, capacity_factor=1.0)
    reset_peak_memory()
    t0 = time.perf_counter()
    model = MoEGPT(cfg, mcfg, torch.float32, seed=seed)
    step = TrainStep(tt.jit(model, transforms=[AutocastTransform()]), optim.AdamW(lr=TRAIN_LR))
    idx, tgt = train_batch(cfg, B, T, seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    first = float(step(idx, tgt))
    compile_s = time.perf_counter() - t0
    for _ in range(2):
        step(idx, tgt)
    torch.cuda.synchronize()
    cudaex.grouped_mlp.launches = 0
    cudaex.flash_rope_attention.launches = 0
    cudaex.flash_rope_attention_backward.launches = 0
    cudaex.adamw_update.launches = 0
    graphs0 = graph_stats(tt, [step])
    step_s, losses = timed_steps(lambda: step(idx, tgt), 0, n_steps)
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [step]).items()}
    require_replayed("moe_train", graphs)
    launches = {"grouped_mlp": cudaex.grouped_mlp.launches,
                "flash_rope_fwd": cudaex.flash_rope_attention.launches,
                "flash_rope_bwd": cudaex.flash_rope_attention_backward.launches,
                "adamw": cudaex.adamw_update.launches}
    if launches["adamw"] != n_steps:
        raise AssertionError(f"adamw launches {launches['adamw']} over {n_steps} steps, want one a step")
    want = cfg.n_layer * n_steps
    if any(v != want for k, v in launches.items() if k != "adamw"):
        raise AssertionError(f"moe_train launches {launches} over {n_steps} steps, want {want} each")
    losses = [first] + losses
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"moe_train losses {losses}")
    fwd = tt.last_traces(step)[-1].bound_symbols
    claimed = [b for b in fwd if b.sym.id == "cuda.grouped_mlp_fwd"]
    kernel_dtypes = sorted({str(a.dtype.name) for b in claimed for a in b.args[:4]})
    bound = moe_step_bound(model, cfg, mcfg, B, T)
    out = dict(model=f"{cfg.name} + MoE (E={mcfg.n_expert}, H={mcfg.intermediate_size}, "
                     f"top-{mcfg.n_expert_per_token}, capacity factor {mcfg.capacity_factor})", n_layer=cfg.n_layer,
               B=B, T=T, dtype="bf16 autocast, f32 master", params=sum(p.numel() for p in model.parameters()),
               capacity=model.h[0].moe.capacity(B * T), steps=n_steps, ms_per_step=step_s * 1e3,
               tokens_per_s=B * T / step_s, mfu=bound["model_ops_per_step"] / step_s / PEAK_OPS["bfloat16"],
               **bound, compile_s=compile_s, init_s=t_init,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses, launches=launches,
               grouped_mlp_operand_dtypes=kernel_dtypes, **graphs)
    emit("moe_train", **out)
    out["profile"] = train_profile(step, idx, tgt, "moe_train_profile")
    train_pair("moe_train", step, idx, tgt, (cudaex.grouped_mlp, cudaex.flash_rope_attention,
                                             cudaex.flash_rope_attention_backward, cudaex.adamw_update))
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The MoE roads differ only in summation order, so in f32 their gradients
# agree to rounding: each tensor's step-1 gradients within MOE_GRAD_RTOL of
# its largest (4.3e-7 measured on an H100). A parameter moves apart only
# where AdamW's ±lr step follows a gradient whose sign the order can flip:
# elements whose dense-road gradient, at some step, is both within
# MOE_NEAR_ZERO of its tensor's largest and smaller than MOE_FLIP_MARGIN
# times the roads' gap are held to ADAMW_FLIP_ATOL, the rest to
# MOE_PARAM_ATOL (1.2e-6 measured over every element; a missing or swapped
# expert gradient moves a weight by ~lr a step).
MOE_GRAD_RTOL = 1e-4
MOE_NEAR_ZERO = 1e-4
MOE_FLIP_MARGIN = 10.0
MOE_PARAM_ATOL = 1e-5


class GradRecorder:
    """Wraps an optimizer and keeps every step's gradients. Given the
    recorder of another run (``against``), it keeps only the first step's
    and marks, over every step, the flip-prone elements: |g| within
    MOE_NEAR_ZERO of the tensor's largest and below MOE_FLIP_MARGIN times
    the gap to that run's gradient of the same step."""

    def __init__(self, inner, against=None):
        self.inner, self.against, self.steps, self.flip_prone, self.n = inner, against, [], {}, 0

    def init(self, params):
        return self.inner.init(params)

    def update(self, params, grads, state):
        grads = {k: g.detach() for k, g in grads.items() if g is not None}
        if self.against is None or not self.steps:
            self.steps.append({k: g.clone() for k, g in grads.items()})
        if self.against is not None:
            other = self.against.steps[self.n]
            for k, g in grads.items():
                prone = ((g.abs() <= MOE_NEAR_ZERO * g.abs().max())
                         & (g.abs() < MOE_FLIP_MARGIN * (other[k] - g).abs()))
                self.flip_prone[k] = prone | self.flip_prone[k] if k in self.flip_prone else prone
        self.n += 1
        return self.inner.update(params, grads, state)


def captured_against_op_by_op(tt, phase: str, make, batches, counters) -> dict:
    """The road under test's TrainStep (``make(cuda_graphs)`` -> (step,
    model), from the same weights each time) run op by op and captured (its
    first step op by op, then one capture and replays) over ``batches``, a
    new batch each step. f32, TF32 off, the same kernels in the same order:
    losses, parameters and buffers (the running stats, MoE counts and the
    like that a step writes; constant ones compare equal) must be bit-equal
    and each counter's launches equal. A value read on the host and baked
    into the capture (a group size, a routing count) would show from the
    second batch on."""
    runs = {}
    for graphs in (False, True):
        step, model = make(graphs)
        n0 = [c.launches for c in counters]
        losses = [float(step(*b)) for b in batches]
        state = [*model.named_parameters(), *model.named_buffers()]
        runs[graphs] = dict(losses=losses, launches=[c.launches - n for c, n in zip(counters, n0)],
                            params={k: p.detach().clone() for k, p in state},
                            **graph_stats(tt, [step]))
        del step, model
    got, want = runs[True], runs[False]
    require_replayed(phase, got)
    differ = sorted(k for k in want["params"] if not torch.equal(got["params"][k], want["params"][k]))
    out = dict(steps=len(batches), losses=got["losses"], op_by_op_losses=want["losses"],
               params_not_bit_equal=differ, launches={c.__name__: n for c, n in zip(counters, got["launches"])},
               op_by_op_launches={c.__name__: n for c, n in zip(counters, want["launches"])},
               graph_captures=got["graph_captures"], graph_replays=got["graph_replays"])
    if got["losses"] != want["losses"] or differ or got["launches"] != want["launches"]:
        raise AssertionError(f"{phase}: the captured step is not the op-by-op step bit for bit: {out}")
    del runs
    torch.cuda.empty_cache()
    return out


def moe_train_agreement(tt, cudaex, seed) -> dict:
    """f32, TF32 off, the MoE model at 2 layers, B=1, T=256 (capacity factor
    1.0: cap 64, so tokens are dropped): 3 TrainSteps on the grouped road
    (the kernel and its claimed grad rule) against the dense road (every
    expert over every token, no kernel) from the same weights. Losses within
    LOSS_RTOL, step-1 gradients within MOE_GRAD_RTOL, parameters within
    MOE_PARAM_ATOL but flip-prone elements within ADAMW_FLIP_ATOL:
    the two roads sum in other orders (the same split as thunder_tpu's
    grouped-vs-dense tests). Both roads run op by op (GradRecorder reads
    every step's gradients in Python, which a replay does not run); then
    the grouped road captured, the main path's TrainStep, is held bit for
    bit against it op by op over 3 new batches (``captured``)."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config
    from thunder_tpu_torch.models.moe import MoEGPT
    from thunder_tpu_torch.training import TrainStep

    B, T, n_steps = 1, 256, 3
    cfg = Config.from_name("Llama-3-1B", n_layer=2, block_size=T)
    runs = {}
    for road in ("grouped", "dense"):
        model = MoEGPT(cfg, moe_config(cfg, 1.0, road), torch.float32, seed=seed)
        rec = GradRecorder(optim.AdamW(lr=TRAIN_LR), runs["grouped"]["rec"] if runs else None)
        # op by op: GradRecorder reads every step's gradients in Python,
        # which a CUDA-graph replay does not run
        step = TrainStep(tt.jit(model), rec, cuda_graphs=False)
        idx, tgt = train_batch(cfg, B, T, seed)
        n0 = cudaex.grouped_mlp.launches
        losses = [float(step(idx, tgt)) for _ in range(n_steps)]
        runs[road] = dict(losses=losses, launches=cudaex.grouped_mlp.launches - n0, rec=rec,
                          params={k: p.detach() for k, p in model.named_parameters()})
        del step
    g, d = runs["grouped"], runs["dense"]
    if g["launches"] != cfg.n_layer * n_steps or d["launches"]:
        raise AssertionError(f"grouped_mlp launches: grouped road {g['launches']}, dense road {d['launches']}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], d["losses"]))
    g1, d1 = g["rec"].steps[0], d["rec"].steps[0]
    if g1.keys() != d1.keys() or g1.keys() != g["params"].keys():
        raise AssertionError(f"gradients for {sorted(g1)} and {sorted(d1)}, parameters {sorted(g['params'])}")
    grad_rel = {k: ((g1[k] - d1[k]).abs().max() / d1[k].abs().max().clamp(min=1e-30)).item() for k in d1}
    prone = d["rec"].flip_prone
    tight, flip = [], []
    for k in g["params"]:
        diff = (g["params"][k] - d["params"][k]).abs()
        tight.append(diff[~prone[k]])
        flip.append(diff[prone[k]])
    tight, flip = torch.cat(tight), torch.cat(flip)
    out = dict(model=f"{cfg.name} + MoE n_layer=2", B=B, T=T, steps=n_steps, tf32=False,
               grouped_losses=g["losses"], dense_losses=d["losses"], loss_max_rel=loss_rel, loss_rtol=LOSS_RTOL,
               grad_max_rel=max(grad_rel.values()), grad_rtol=MOE_GRAD_RTOL,
               param_max_abs=tight.max().item(), param_atol=MOE_PARAM_ATOL,
               flip_prone_elements=flip.numel(), elements=tight.numel() + flip.numel(),
               flip_prone_max_abs=flip.max().item() if flip.numel() else 0.0, flip_prone_atol=ADAMW_FLIP_ATOL,
               grouped_mlp_launches=g["launches"])

    def grouped_step(graphs):
        model = MoEGPT(cfg, moe_config(cfg, 1.0, "grouped"), torch.float32, seed=seed)
        return TrainStep(tt.jit(model), optim.AdamW(lr=TRAIN_LR), cuda_graphs=graphs), model

    out["captured"] = captured_against_op_by_op(
        tt, "moe_train_agreement (captured)", grouped_step,
        [train_batch(cfg, B, T, seed + 1 + i) for i in range(n_steps)], (cudaex.grouped_mlp,))
    emit("moe_train_agreement", **out)
    if (not loss_rel <= LOSS_RTOL or not out["grad_max_rel"] <= MOE_GRAD_RTOL
            or not out["param_max_abs"] <= MOE_PARAM_ATOL or not out["flip_prone_max_abs"] <= ADAMW_FLIP_ATOL):
        raise AssertionError(f"moe train agreement: losses {loss_rel}, gradients "
                             f"{ {k: v for k, v in grad_rel.items() if not v <= MOE_GRAD_RTOL} }, "
                             f"params {out['param_max_abs']}, flip-prone params {out['flip_prone_max_abs']}")
    del runs, g, d, tight, flip
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 22-24: context parallelism — the ring kernels, cp_train and its
# agreement
# ---------------------------------------------------------------------------

# The four-shard ring that check_ring steps in one process: an 8,192-token
# context over sp=4, so each rank holds T_blk = 2048 positions: llama-350m's
# heads, a GQA case (16 q heads over 4 kv heads, D=128) and one full
# (non-causal) case. Each compared tensor — a step's o/l, m, l and dq, dk,
# dv against the plain version; the whole ring's out, lse, dq, dk, dv
# against the flash kernels B1/B2 on the whole sequence — is held on two
# measures, max |err| / max |ref| and ||err||_2 / ||ref||_2, each within
# RING_TOL. The second measure is
# there because |o/l| and dq are ~4 in the first causal rows but ~0.03 in
# the rows that see hundreds of keys: a bar scaled by the largest value
# alone is as large as a typical one. A future step's backward writes
# zeros, so its reference is 0 and any nonzero output fails. In bf16 the
# kernels round p and ds to bf16 before their products (the plain versions
# do not) and the flash kernels do so at other running maxima: an H100 read
# at most 3.7e-3 for a step and 6.0e-3 for the whole ring, so RING_TOL is
# 2^-6 (8 bf16 ulps, GROUPED_TOL's bar); f32 read at most 1.0e-5.
RING_CTX, RING_N = 8192, 4
RING_SHAPES = {"llama-350m": (dict(B=1, H=16, Hkv=16, D=64), True),
               "gqa-d128": (dict(B=1, H=16, Hkv=4, D=128), True),
               "llama-350m-full": (dict(B=1, H=16, Hkv=16, D=64), False)}
RING_TOL = {"bfloat16": 2.0 ** -6, "float32": 1e-4}


def ring_work(kind: str, B, H, Hkv, T, D, causal=True, fwd=True) -> tuple[float, float]:
    """(bytes, operations) one ring step must move and do at bf16: q, the
    shard (k, v) read once; forward: the f32 o, m, l read and written;
    backward: do read, lse and delta read, f32 dq, dk, dv written; the
    causal operations of the step's kind (a future shard: none; the
    forward leaves its accumulators unread, the backward writes zeros)."""
    qb, kvb, rows = B * H * T * D, B * Hkv * T * D, B * H * T
    full_ops = 4 * B * H * T * T * D
    ops = {"diagonal": full_ops / 2 if causal else full_ops, "past": full_ops, "future": 0.0}[kind]
    if fwd:
        nbytes = 0.0 if kind == "future" else 2 * qb + 2 * 2 * kvb + 2 * 4 * (qb + 2 * rows)
        return nbytes, ops
    out_bytes = 4 * qb + 2 * 4 * kvb
    nbytes = out_bytes if kind == "future" else 2 * 2 * qb + 2 * 2 * kvb + 2 * 4 * rows + out_bytes
    return nbytes, 2.5 * ops


def ring_inputs(dev, gen, dt, B, H, Hkv, D, T=RING_CTX):
    q = torch.randn(B, H, T, D, device=dev, generator=gen).to(dt)
    k = torch.randn(B, Hkv, T, D, device=dev, generator=gen).to(dt)
    v = torch.randn(B, Hkv, T, D, device=dev, generator=gen).to(dt)
    do = torch.randn(B, H, T, D, device=dev, generator=gen).to(dt)
    return q, k, v, do


def ring_state(q):
    B, H, T, D = q.shape
    return (torch.zeros(B, H, T, D, device=q.device),
            torch.full((B, H, T, 1), -1e30, device=q.device),
            torch.zeros(B, H, T, 1, device=q.device))


def rel_err(got, want) -> list[float]:
    """[max |err|, max |err| / max |want|, ||err||_2 / ||want||_2] in f32; a
    zero reference makes any error infinite."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    tiny = torch.finfo(torch.float32).tiny
    return [d.max().item(), (d.max() / w.abs().max().clamp(min=tiny)).item(),
            (d.norm() / w.norm().clamp(min=tiny)).item()]


def ring_failures(errs: dict, tol: float) -> dict:
    """The tensors of {name: rel_err} whose relative measures exceed tol."""
    return {name: e for name, e in errs.items() if not max(e[1], e[2]) <= tol}


def step_ring(cudaex, q, k, v, do, causal, n=RING_N) -> tuple[dict, tuple]:
    """Every rank's ring, diagonal first, in one process: per step the
    kernel (in place) against the plain version on the same carried state
    (o/l, m and l); then the backward ring from the kernels' lse. -> ({"fwd":
    {tensor: rel_err}, "bwd": ...}, the worst over steps of each measure;
    (out, lse, dq, dk, dv) on the whole sequence)."""
    T = q.shape[2] // n
    blk = lambda t, r: t[:, :, r * T:(r + 1) * T].contiguous()  # noqa: E731
    errs = {"fwd": {}, "bwd": {}}

    def note(kind, names, got, want):
        for name, g, w in zip(names, got, want):
            e = rel_err(g, w)
            errs[kind][name] = [max(a, b) for a, b in zip(errs[kind].get(name, e), e)]

    outs, lses = [], []
    for r in range(n):
        qr = blk(q, r)
        o, m, l = ring_state(qr)
        for i in range(n):
            src = (r - i) % n
            kb, vb = blk(k, src), blk(v, src)
            want = cudaex.ring_flash_step_plain(qr, kb, vb, o.clone(), m.clone(), l.clone(),
                                                r * T, src * T, causal)
            o, m, l = cudaex.ring_flash_step(qr, kb, vb, o, m, l, r * T, src * T, causal)
            # o is held normalized: its absolute error grows with l (the kernel
            # rounds p to bf16 for p·v), the output's does not
            note("fwd", ("o/l", "m", "l"), (o / l, m, l), (want[0] / want[2], want[1], want[2]))
            del want
        l1 = l[..., 0]
        outs.append((o / l1[..., None]).to(q.dtype))
        lses.append((m[..., 0] + torch.log2(l1)) * cudaex.LN2)
    out, lse = torch.cat(outs, 2), torch.cat(lses, 2)
    dq, dk, dv = torch.zeros(q.shape, device=q.device), torch.zeros(k.shape, device=q.device), \
        torch.zeros(k.shape, device=q.device)
    for r in range(n):
        qr, dor = blk(q, r), blk(do, r)
        lse1 = blk(lse, r)[..., None].contiguous()
        delta = (dor.float() * blk(out, r).float()).sum(-1, keepdim=True)
        for i in range(n):
            src = (r - i) % n
            kb, vb = blk(k, src), blk(v, src)
            got = cudaex.ring_flash_bwd_step(qr, kb, vb, dor, lse1, delta, r * T, src * T, causal)
            note("bwd", ("dq", "dk", "dv"), got,
                 cudaex.ring_flash_bwd_step_plain(qr, kb, vb, dor, lse1, delta, r * T, src * T, causal))
            dq[:, :, r * T:(r + 1) * T] += got[0]
            dk[:, :, src * T:(src + 1) * T] += got[1]
            dv[:, :, src * T:(src + 1) * T] += got[2]
    return errs, (out, lse, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def time_ring_steps(cudaex, dev, gen, shp, causal, T, kinds) -> dict:
    """Device and eager ms of the forward and backward step kernels for each
    step kind at block T (bf16), beside bound_ms, the plain versions and, as
    side yardsticks (library_ms is none: no one PyTorch call folds a shard
    into carried accumulators), on the same (q, shard) pair: SDPA and the B1
    flash forward kernel; the flash backward kernel (tt_flash_bwd, causal at
    the diagonal step) and SDPA's autograd backward (its forward and
    backward less its forward)."""
    B, H, Hkv, D = (shp[x] for x in ("B", "H", "Hkv", "D"))
    gqa = H != Hkv
    out = {}
    for kind in kinds:
        q_off, k_off = {"diagonal": (T, T), "past": (T, 0), "future": (0, T)}[kind]

        def make():
            q, k, v, do = ring_inputs(dev, gen, torch.bfloat16, B, H, Hkv, D, T)
            o, m, l = cudaex.ring_flash_step_plain(q, k, v, *ring_state(q), T, T, causal)
            lse = ((m + torch.log2(l)) * cudaex.LN2).contiguous()
            delta = (do.float() * (o / l)).sum(-1, keepdim=True)
            return q, k, v, do, o.contiguous(), m.contiguous(), l.contiguous(), lse, delta

        fbytes, fops = ring_work(kind, B, H, Hkv, T, D, causal, fwd=True)
        sets = copies(make, int(fbytes + 8 * B * H * T * D + 1))
        fwd_args = [(q, k, v, o, m, l, q_off, k_off, causal) for q, k, v, do, o, m, l, _, _ in sets]
        bwd_args = [(q, k, v, do, lse, delta, q_off, k_off, causal)
                    for q, k, v, do, _, _, _, lse, delta in sets]
        row = {}
        for name, fn, plain, args, fwd in (
                ("fwd", cudaex.ring_flash_step, cudaex.ring_flash_step_plain, fwd_args, True),
                ("bwd", cudaex.ring_flash_bwd_step, cudaex.ring_flash_bwd_step_plain, bwd_args, False)):
            nbytes, ops = ring_work(kind, B, H, Hkv, T, D, causal, fwd)
            b, by = bound_ms(nbytes, ops, "bfloat16")
            ms, eager = cuda_ms(fn, args, iters=50)
            if kind == "future" and causal and fwd:
                # the plain version returns at once: no device work to time
                plain_ms = plain_eager = None
            else:
                plain_ms, plain_eager = cuda_ms(plain, args[:1], iters=3)
            row[name] = dict(ms=ms, eager_ms=eager, bound_ms=b, bound_by=by, plain_ms=plain_ms,
                             plain_eager_ms=plain_eager, library_ms=None)
        plan = cudaex.ring_forward_plan(B, H, Hkv, T, D, torch.bfloat16, q_off, k_off, causal)
        row["fwd"]["plan"] = {k: plan[k] for k in ("future", "items", "blocks")}
        if kind != "future":
            pairs = [(q, k, v) for q, k, v, *_ in sets]
            sdpa = lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal and kind == "diagonal", enable_gqa=gqa)
            b1 = lambda q, k, v: cudaex.flash_attention(q, k, v, causal and kind == "diagonal")  # noqa: E731
            row["fwd"]["sdpa_ms"] = cuda_ms(sdpa, pairs, iters=50)[0]
            row["fwd"]["flash_fwd_ms"] = cuda_ms(b1, pairs, iters=50)[0]
            diag = causal and kind == "diagonal"
            fb_args = [(q, k, v, *cudaex.flash_attention(q, k, v, diag), do, diag)
                       for q, k, v, do, *_ in sets]
            row["bwd"]["flash_bwd_ms"] = cuda_ms(cudaex.flash_attention_backward, fb_args, iters=50)[0]
            del fb_args
            lib = [(q.clone().requires_grad_(), k.clone().requires_grad_(), v.clone().requires_grad_(), do)
                   for q, k, v, do, *_ in sets]
            sdpa_fb = lambda q, k, v, do: torch.autograd.grad(sdpa(q, k, v), (q, k, v), do)  # noqa: E731
            row["bwd"]["sdpa_bwd_ms"] = (cuda_ms(sdpa_fb, lib, iters=50)[0]
                                         - cuda_ms(lambda q, k, v, do: sdpa(q, k, v), lib, iters=50)[0])
            del lib
        out[kind] = row
        del sets, fwd_args, bwd_args
        torch.cuda.empty_cache()
    return out


def check_ring(cudaex, dev, gen) -> tuple[dict, dict]:
    """The ring step kernels: every rank's four-step ring over an 8,192-token
    context (T_blk=2048), diagonal first, at RING_SHAPES in bf16 and f32,
    each step against the plain version and the whole ring against the
    flash kernels on the whole sequence (RING_TOL); at
    cp_train's shape (B=1, H=16, T=8192, D=64, bf16, the one diagonal step
    of a one-rank ring) the kernels against the plain versions (RING_TOL);
    then timed there and at T_blk=2048 for a diagonal, a past and a future
    step. Every reading is printed before a failure raises."""
    cases, whole, failed = {"fwd": [], "bwd": []}, [], []
    n0 = (cudaex.flash_attention.launches, cudaex.flash_attention_backward.launches)
    for label, (shp, causal) in RING_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, do = ring_inputs(dev, gen, dt, **shp)
            errs, (out, lse, dq, dk, dv) = step_ring(cudaex, q, k, v, do, causal)
            for kind in ("fwd", "bwd"):
                cases[kind].append({"shape": label, "dtype": dname(dt), "errs": errs[kind]})
                bad = ring_failures(errs[kind], RING_TOL[dname(dt)])
                if bad:
                    failed.append(f"ring_flash_{kind} {label} {dname(dt)} steps: {bad}")
            ro, rlse = cudaex.flash_attention(q, k, v, causal)
            ref = cudaex.flash_attention_backward(q, k, v, ro, rlse, do, causal)
            w = {name: rel_err(g, r) for name, g, r in
                 zip(("out", "lse", "dq", "dk", "dv"), (out, lse, dq, dk, dv), (ro, rlse, *ref))}
            whole.append({"shape": label, "dtype": dname(dt), "vs_flash": w})
            bad = ring_failures(w, RING_TOL[dname(dt)])
            if bad:
                failed.append(f"ring {label} {dname(dt)} against flash on the whole sequence: {bad}")
            del q, k, v, do, out, lse, dq, dk, dv, ro, rlse, ref
            torch.cuda.empty_cache()
    cudaex.flash_attention.launches, cudaex.flash_attention_backward.launches = n0
    # at cp_train's shape: the kernels against their plain versions, then timed
    shp = RING_SHAPES["llama-350m"][0]
    q, k, v, do = ring_inputs(dev, gen, torch.bfloat16, **shp)
    main_errs, _ = step_ring(cudaex, q, k, v, do, True, n=1)
    del q, k, v, do
    torch.cuda.empty_cache()
    for kind in ("fwd", "bwd"):
        bad = ring_failures(main_errs[kind], RING_TOL["bfloat16"])
        if bad:
            failed.append(f"ring_flash_{kind} at cp_train's shape: {bad}")
    timing = {"cp_train T=8192": time_ring_steps(cudaex, dev, gen, shp, True, RING_CTX, ["diagonal"]),
              f"T_blk={RING_CTX // RING_N}": time_ring_steps(cudaex, dev, gen, shp, True,
                                                             RING_CTX // RING_N,
                                                             ["diagonal", "past", "future"]),
              f"gqa-d128 T_blk={RING_CTX // RING_N}": time_ring_steps(cudaex, dev, gen, RING_SHAPES["gqa-d128"][0],
                                                     True, RING_CTX // RING_N, ["diagonal"])}
    res = {}
    for kind in ("fwd", "bwd"):
        emit("kernels", kernel=f"ring_flash_{kind}", errs_are="[max abs, max/max|ref|, l2/l2 ref]",
             tol=RING_TOL, cases=cases[kind], cp_train_shape_errs=main_errs[kind],
             whole_ring=whole if kind == "bwd" else None,
             timing_bf16={lbl: {k2: r[kind] for k2, r in t.items()} for lbl, t in timing.items()})
        main = timing["cp_train T=8192"]["diagonal"][kind]
        res[kind] = dict(max_abs_err=max(e[0] for e in main_errs[kind].values()),
                         shape="B=1 H=16 T=8192 D=64 causal bf16, the diagonal step (cp_train)",
                         **{x: main[x] for x in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")})
    if failed:
        raise AssertionError("; ".join(failed))
    return res["fwd"], res["bwd"]


def cp_step(tt, model, autocast: bool, sp: bool, opt=None, cuda_graphs: bool = True):
    """TrainStep over jit(model) with opt (default AdamW(lr=TRAIN_LR)),
    autocast or not; with sp, context_parallel over a one-rank mesh of the
    process group; captured as a CUDA graph unless told otherwise."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.parallel import context_parallel, make_mesh
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    tm = tt.jit(model, transforms=[AutocastTransform()] if autocast else None)
    if sp:
        context_parallel(tm, make_mesh({"sp": 1}))
    return TrainStep(tm, opt if opt is not None else optim.AdamW(lr=TRAIN_LR), cuda_graphs=cuda_graphs)


def cp_train(tt, cudaex, seed) -> dict:
    """TrainStep over context_parallel(jit(GPTForCausalLM(llama-350m,
    block_size=8192), [AutocastTransform()]), make_mesh({"sp": 1})) on a
    one-rank NCCL group, AdamW(lr=1e-4), B=1, T=8192: 3 untimed steps (the
    first timed as compile) and 10 timed ones between zeroed counters —
    ring_flash_fwd and ring_flash_bwd 24 x 10 each, the flash-RoPE pair 0;
    losses finite and falling; 2 steps profiled, with the NCCL all-reduces
    of the loss and of every gradient. Beside it, the plain TrainStep
    (flash-RoPE kernels) on the same batch in the same call."""
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM

    B, T, n_steps = 1, RING_CTX, 10
    cfg = Config.from_name("llama-350m", block_size=T)
    idx, tgt = train_batch(cfg, B, T, seed)
    runs = {}
    for name, sp in (("cp", True), ("plain", False)):
        reset_peak_memory()
        model = GPTForCausalLM(cfg, torch.float32, seed=seed)
        step = cp_step(tt, model, True, sp)
        t0 = time.perf_counter()
        first = float(step(idx, tgt))
        compile_s = time.perf_counter() - t0
        for _ in range(2):
            step(idx, tgt)
        torch.cuda.synchronize()
        counters = (cudaex.ring_flash_step, cudaex.ring_flash_bwd_step,
                    cudaex.flash_rope_attention, cudaex.flash_rope_attention_backward)
        for c in counters:
            c.launches = 0
        graphs0 = graph_stats(tt, [step])
        step_s, losses = timed_steps(lambda: step(idx, tgt), 0, n_steps)
        launches = dict(zip(("ring_flash_fwd", "ring_flash_bwd", "flash_rope_fwd", "flash_rope_bwd"),
                            (c.launches for c in counters)))
        graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [step]).items()}
        require_replayed(f"cp_train ({name})", graphs)
        want = cfg.n_layer * n_steps
        expect = ({"ring_flash_fwd": want, "ring_flash_bwd": want, "flash_rope_fwd": 0,
                   "flash_rope_bwd": 0} if sp else
                  {"ring_flash_fwd": 0, "ring_flash_bwd": 0, "flash_rope_fwd": want,
                   "flash_rope_bwd": want})
        if launches != expect:
            raise AssertionError(f"cp_train ({name}) launches {launches} over {n_steps} steps, "
                                 f"want {expect}")
        losses = [first] + losses
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"cp_train ({name}) losses {losses}")
        fwd = tt.last_traces(step)[-1].bound_symbols
        bwd = tt.last_backward_traces(step)[-1].bound_symbols
        bound = step_bound(model, cfg, B, T)
        out = dict(model=cfg.name, n_layer=cfg.n_layer, B=B, T=T, dtype="bf16 autocast, f32 master",
                   plan="context_parallel sp=1 (one-rank NCCL group)" if sp else "none",
                   steps=n_steps, ms_per_step=step_s * 1e3, tokens_per_s=B * T / step_s,
                   mfu=bound["model_ops_per_step"] / step_s / PEAK_OPS["bfloat16"], **bound,
                   compile_s=compile_s, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   losses=losses, launches=launches, **graphs,
                   ops_per_step={"forward": len(fwd), "backward": len(bwd)})
        if sp:
            claims = {"forward": sorted({b.sym.id for b in fwd if b.impl is cudaex._ring_flash_fwd_impl}),
                      "backward": sorted({b.sym.id for b in bwd if b.impl is cudaex._ring_flash_bwd_impl})}
            if claims != {"forward": ["dist.ring_attention_fwd"], "backward": ["dist.ring_attention_bwd"]}:
                raise AssertionError(f"cp_train's cuda claims are {claims}")
            out["claims"] = claims
            out["collectives_per_step"] = {
                "forward": sum(b.sym.id == "dist.all_reduce" for b in fwd),
                "backward": sum(b.sym.id == "dist.all_reduce" for b in bwd)}
        emit("cp_train" if sp else "cp_train_plain", **out)
        out["profile"] = train_profile(step, idx, tgt, "cp_train_profile" if sp else "cp_train_plain_profile")
        runs[name] = out
        del step, model
        gc.collect()
        torch.cuda.empty_cache()
    return runs["cp"], runs["plain"]


def cp_train_agreement(tt, cudaex, seed) -> dict:
    """f32, TF32 off: llama-350m at 2 layers, B=1, T=1024, from the same
    weights: 3 AdamW steps of the sp=1 context-parallel step (the ring
    kernels, the synchronize and all_reduce prims over the NCCL group)
    against the plain TrainStep (the flash-RoPE kernels). The two differ in
    summation order only, so they are held as moe_train_agreement holds its
    roads: losses within LOSS_RTOL (the bar of thunder_tpu's
    test_context_parallel_gpt_exact), step-1 gradients within MOE_GRAD_RTOL
    of each tensor's largest, parameters within MOE_PARAM_ATOL but
    flip-prone elements within ADAMW_FLIP_ATOL. Then the CP step captured
    (its all-reduces inside the graph), cp_train's path, is held bit for
    bit against it op by op over 3 new batches (``captured``)."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM

    B, T, n_steps = 1, 1024, 3
    cfg = Config.from_name("llama-350m", n_layer=2, block_size=T)
    idx, tgt = train_batch(cfg, B, T, seed)
    runs = {}
    for road in ("plain", "cp"):
        model = GPTForCausalLM(cfg, torch.float32, seed=seed)
        rec = GradRecorder(optim.AdamW(lr=TRAIN_LR), runs["plain"]["rec"] if runs else None)
        # op by op: GradRecorder reads every step's gradients in Python
        step = cp_step(tt, model, False, road == "cp", rec, cuda_graphs=False)
        n0 = cudaex.ring_flash_step.launches, cudaex.ring_flash_bwd_step.launches
        losses = [float(step(idx, tgt)) for _ in range(n_steps)]
        runs[road] = dict(losses=losses, rec=rec, params={k: p.detach() for k, p in model.named_parameters()},
                          ring=(cudaex.ring_flash_step.launches - n0[0],
                                cudaex.ring_flash_bwd_step.launches - n0[1]))
        del step
    cp, ref = runs["cp"], runs["plain"]
    if cp["ring"] != (cfg.n_layer * n_steps,) * 2 or ref["ring"] != (0, 0):
        raise AssertionError(f"ring kernel launches: CP step {cp['ring']}, plain step {ref['ring']}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(cp["losses"], ref["losses"]))
    g1, r1 = cp["rec"].steps[0], ref["rec"].steps[0]
    if g1.keys() != r1.keys() or g1.keys() != cp["params"].keys():
        raise AssertionError(f"gradients for {sorted(g1)} and {sorted(r1)}, parameters {sorted(cp['params'])}")
    grad_rel = {k: ((g1[k] - r1[k]).abs().max() / r1[k].abs().max().clamp(min=1e-30)).item() for k in r1}
    prone = cp["rec"].flip_prone
    tight, flip = [], []
    for k in cp["params"]:
        diff = (cp["params"][k] - ref["params"][k]).abs()
        tight.append(diff[~prone[k]])
        flip.append(diff[prone[k]])
    tight, flip = torch.cat(tight), torch.cat(flip)
    out = dict(model=f"{cfg.name} n_layer=2", B=B, T=T, steps=n_steps, tf32=False,
               losses=cp["losses"], plain_losses=ref["losses"], loss_max_rel=loss_rel, loss_rtol=LOSS_RTOL,
               grad_max_rel=max(grad_rel.values()), grad_rtol=MOE_GRAD_RTOL,
               param_max_abs=tight.max().item(), param_atol=MOE_PARAM_ATOL,
               flip_prone_elements=flip.numel(), elements=tight.numel() + flip.numel(),
               flip_prone_max_abs=flip.max().item() if flip.numel() else 0.0, flip_prone_atol=ADAMW_FLIP_ATOL)

    def cp_road(graphs):
        model = GPTForCausalLM(cfg, torch.float32, seed=seed)
        return cp_step(tt, model, False, True, cuda_graphs=graphs), model

    out["captured"] = captured_against_op_by_op(
        tt, "cp_train_agreement (captured)", cp_road,
        [train_batch(cfg, B, T, seed + 1 + i) for i in range(n_steps)],
        (cudaex.ring_flash_step, cudaex.ring_flash_bwd_step))
    emit("cp_train_agreement", **out)
    if (not loss_rel <= LOSS_RTOL or not out["grad_max_rel"] <= MOE_GRAD_RTOL
            or not out["param_max_abs"] <= MOE_PARAM_ATOL or not out["flip_prone_max_abs"] <= ADAMW_FLIP_ATOL):
        raise AssertionError(f"cp train agreement: losses {loss_rel}, gradients "
                             f"{ {k: v for k, v in grad_rel.items() if not v <= MOE_GRAD_RTOL} }, "
                             f"params {out['param_max_abs']}, flip-prone params {out['flip_prone_max_abs']}")
    del runs, cp, ref, tight, flip
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# after phase 24, on the same one-rank NCCL group: sharded training —
# fsdp_train, sharded_agreement, ep_moe
# ---------------------------------------------------------------------------

# The plans sharded_agreement holds bit for bit against no plan, each on
# one-rank meshes of the process group (sharded_step says what each is)
SHARDED_PLANS = ("fsdp:2", "fsdp:3", "dp_x_fsdp+bucketing", "ddp+bucketing", "tp")
# The bucketing plans' bucket size. dryrun_multichip's 1 MiB makes no bucket
# at llama-350m's widths: every gradient but the RMSNorm weights' exceeds
# it, so each would sit alone (PERF.md, PR 24); 64 MiB packs several.
SHARDED_BUCKET_MB = 64
# fsdp_train against the plain train step in turns, FSDP_TURN_STEPS a turn
FSDP_TURNS = ("fsdp:3", "plain", "plain", "fsdp:3")
FSDP_TURN_STEPS = 5
# moe_ep_forward's shape (MoEGPT's experts at Llama-3-1B, moe_config) and
# the calls a profile of it covers
EP_E, EP_D, EP_H, EP_K, EP_N = 8, 2048, 1024, 2, 4096
EP_CALLS = 5


def sharded_step(tt, model, cfg, plan: str, autocast: bool, opt=None, cuda_graphs: bool = True):
    """TrainStep over jit(model) (autocast or not; AdamW(lr=TRAIN_LR) unless
    ``opt``) under ``plan``, each mesh of size 1 over the process group:
    "plain" (no plan); "fsdp:2" / "fsdp:3" (fsdp at that ZeRO stage);
    "dp_x_fsdp+bucketing" (ddp then fsdp on a 1 x 1 dp x fsdp mesh, with
    GradBucketingTransform, as __graft_entry__.dryrun_multichip's phase 1);
    "ddp+bucketing" (ddp(bucket_mb=)), both at SHARDED_BUCKET_MB; "tp"
    (column_parallel of every mlp.fc_1 and mlp.fc_2, row_parallel of every
    mlp.proj)."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.parallel import (GradBucketingTransform, column_parallel, ddp, fsdp, make_mesh,
                                            row_parallel)
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    transforms = [AutocastTransform()] if autocast else []
    if plan == "dp_x_fsdp+bucketing":
        transforms.append(GradBucketingTransform(SHARDED_BUCKET_MB))
    tm = tt.jit(model, transforms=transforms or None)
    if plan.startswith("fsdp:"):
        fsdp(tm, make_mesh({"fsdp": 1}), zero=int(plan[-1]))
    elif plan == "dp_x_fsdp+bucketing":
        mesh = make_mesh({"dp": 1, "fsdp": 1})
        ddp(tm, mesh)
        fsdp(tm, mesh)
    elif plan == "ddp+bucketing":
        ddp(tm, make_mesh({"dp": 1}), bucket_mb=SHARDED_BUCKET_MB)
    elif plan == "tp":
        mesh = make_mesh({"tp": 1})
        mlps = [f"gpt.h.{i}.mlp" for i in range(cfg.n_layer)]
        column_parallel(tm, mesh, [f"{q}.{n}" for q in mlps for n in ("fc_1", "fc_2")])
        row_parallel(tm, mesh, [f"{q}.proj" for q in mlps])
    elif plan != "plain":
        raise ValueError(f"unknown plan {plan!r}")
    return TrainStep(tm, opt if opt is not None else optim.AdamW(lr=TRAIN_LR), cuda_graphs=cuda_graphs)


COLLECTIVE_IDS = ("dist.all_gather", "dist.reduce_scatter", "dist.all_reduce", "dist.all_to_all",
                  "dist.synchronize_tensor_parallel_input", "dist.synchronize_tensor_parallel_output",
                  "dist.pack", "dist.unpack")


def collectives(tt, step) -> dict:
    """The collective prims (and bucketing's pack/unpack) in the step's last
    forward and backward traces, by id."""
    out = {}
    for name, trace in (("forward", tt.last_traces(step)[-1]), ("backward", tt.last_backward_traces(step)[-1])):
        ids = [b.sym.id for b in trace.bound_symbols]
        out[name] = {k[len("dist."):]: ids.count(k) for k in COLLECTIVE_IDS if ids.count(k)}
    return out


def saved_for_backward(tt, step) -> dict:
    """The tensors the step's forward saves for its backward that are not
    the forward's inputs (the parameters, buffers and batch, held anyway):
    name -> bytes."""
    fwd = tt.last_traces(step)[1]
    inputs = {p.name for p in fwd.args if hasattr(p, "name")}
    return {p.name: math.prod(p.shape) * p.dtype.bytes for p in fwd.bound_symbols[-1].args[0][1]
            if hasattr(p, "shape") and p.name not in inputs}


def gathered_bytes(model) -> dict:
    """From the parameter shapes: the f32 bytes of every parameter FSDP
    shards (all of llama's: each has at least min_shard_numel = 128
    elements), and the bytes of the gathered forms a ZeRO-2 forward keeps
    for the backward under autocast: the bf16 copy of every matmul weight
    (the linears and lm_head; the embedding's gradient reads no weight)."""
    params = dict(model.named_parameters())
    return dict(sharded_f32=sum(p.numel() * 4 for p in params.values() if p.numel() >= 128),
                matmul_bf16=sum(p.numel() * 2 for k, p in params.items() if p.ndim == 2 and "wte" not in k))


def fsdp_train(tt, cudaex, seed) -> dict:
    """train's configuration (llama-350m, B=4, T=2048, bf16 autocast,
    AdamW(lr=1e-4), captured) under fsdp(zero=3) over a one-rank mesh of
    the NCCL group: 3 untimed steps, then 10 timed between zeroed counters
    (the flash-RoPE pair 24 x 10 each, AdamW 10 — on the rank's shards —,
    0 captures, 10 replays), losses finite and falling; its profile with
    the NCCL kernels and host calls; the plain train step beside it in
    turns (FSDP_TURNS); and the saved-for-backward bytes at zero=3 and (one
    op-by-op step) zero=2, whose difference must be the gathered matmul
    weights' bf16 copies exactly: ZeRO-3's backward re-gathers them."""
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM

    B, T, n_steps = 4, 2048, 10
    cfg = Config.from_name("llama-350m", block_size=T)
    idx, tgt = train_batch(cfg, B, T, seed)
    counters = (cudaex.flash_rope_attention, cudaex.flash_rope_attention_backward, cudaex.adamw_update)
    reset_peak_memory()
    model = GPTForCausalLM(cfg, torch.float32, seed=seed)
    sizes = gathered_bytes(model)
    step = sharded_step(tt, model, cfg, "fsdp:3", True)
    t0 = time.perf_counter()
    first = float(step(idx, tgt))
    compile_s = time.perf_counter() - t0
    for _ in range(2):
        step(idx, tgt)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    graphs0 = graph_stats(tt, [step])
    step_s, losses = timed_steps(lambda: step(idx, tgt), 0, n_steps)
    launches = dict(zip(("flash_rope_fwd", "flash_rope_bwd", "adamw"), (c.launches for c in counters)))
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [step]).items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_rope_fwd": cfg.n_layer * n_steps, "flash_rope_bwd": cfg.n_layer * n_steps, "adamw": n_steps}
    if graphs != {"graph_captures": 0, "graph_replays": n_steps}:
        raise AssertionError(f"fsdp_train: the timed steps ran {graphs}, want {n_steps} replays and no capture")
    if launches != want:
        raise AssertionError(f"fsdp_train: launches {launches} over {n_steps} steps, want {want}")
    losses = [first] + losses
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"fsdp_train losses {losses}")
    coll = collectives(tt, step)
    saved3 = saved_for_backward(tt, step)
    bound = step_bound(model, cfg, B, T)
    out = dict(model=cfg.name, n_layer=cfg.n_layer, B=B, T=T, dtype="bf16 autocast, f32 master",
               plan="fsdp(zero=3) fsdp=1 (one-rank NCCL group)", steps=n_steps, ms_per_step=step_s * 1e3,
               tokens_per_s=B * T / step_s, mfu=bound["model_ops_per_step"] / step_s / PEAK_OPS["bfloat16"],
               **bound, compile_s=compile_s, peak_memory_gb=peak, losses=losses, launches=launches, **graphs,
               collectives_per_step=coll)
    emit("fsdp_train", **out)
    out["profile"] = train_profile(step, idx, tgt, "fsdp_train_profile")
    # each one-rank collective of the replayed graph is one device copy, no
    # NCCL kernel and no host call
    out["collective_copies_per_step"] = {
        "kernels": out["profile"]["kernels_per_step_by_kind"].get("memcpy", 0),
        "device_ms": out["profile"]["device_ms_per_step_by_kind"].get("memcpy", 0.0),
        "nccl": out["profile"].get("nccl")}
    # the plain step's own peak: above what the FSDP step holds
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plain_model = GPTForCausalLM(cfg, torch.float32, seed=seed)
    plain = sharded_step(tt, plain_model, cfg, "plain", True)
    for _ in range(3):
        plain(idx, tgt)
    torch.cuda.synchronize()
    out["plain_peak_memory_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    out["plain_profile"] = train_profile(plain, idx, tgt, "fsdp_train_plain_profile")
    turns = []
    for name in FSDP_TURNS:
        s, _ = timed_steps(lambda: (step if name == "fsdp:3" else plain)(idx, tgt), 1, FSDP_TURN_STEPS)
        turns.append({"plan": name, "ms_per_step": s * 1e3})
    ms = {n: [t["ms_per_step"] for t in turns if t["plan"] == n] for n in ("fsdp:3", "plain")}
    out["turns"] = turns
    out["fsdp_over_plain"] = sum(ms["fsdp:3"]) / sum(ms["plain"])
    del step, plain, model, plain_model
    gc.collect()
    torch.cuda.empty_cache()
    # ZeRO-2: one op-by-op step for its traces
    model = GPTForCausalLM(cfg, torch.float32, seed=seed)
    step = sharded_step(tt, model, cfg, "fsdp:2", True, cuda_graphs=False)
    step(idx, tgt)
    saved2 = saved_for_backward(tt, step)
    coll2 = collectives(tt, step)
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    extra = sum(saved2.values()) - sum(saved3.values())
    out.update(saved_for_backward_gb={"zero3": sum(saved3.values()) / 1e9, "zero2": sum(saved2.values()) / 1e9},
               zero2_minus_zero3_bytes=extra, gathered_matmul_bf16_bytes=sizes["matmul_bf16"],
               sharded_params_f32_bytes=sizes["sharded_f32"],
               only_zero3_saves=sorted(set(saved3) - set(saved2)), zero2_collectives_per_step=coll2)
    emit("fsdp_train", **{k: out[k] for k in ("saved_for_backward_gb", "zero2_minus_zero3_bytes",
                                               "gathered_matmul_bf16_bytes", "sharded_params_f32_bytes",
                                               "only_zero3_saves", "zero2_collectives_per_step", "turns",
                                               "fsdp_over_plain", "plain_peak_memory_gb",
                                               "collective_copies_per_step")})
    if extra != sizes["matmul_bf16"] or out["only_zero3_saves"]:
        raise AssertionError(f"fsdp_train: ZeRO-2 saves {extra} bytes more than ZeRO-3, want the gathered "
                             f"matmul weights' {sizes['matmul_bf16']}; ZeRO-3 alone saves {out['only_zero3_saves']}")
    if coll["backward"].get("all_gather", 0) == 0 or coll2["backward"].get("all_gather", 0):
        raise AssertionError(f"fsdp_train: backward all_gathers (the re-gather) zero=3 {coll['backward']}, "
                             f"zero=2 {coll2['backward']}")
    return out


class WindowedStep:
    """A TrainStep called in no_sync windows: ``micro`` calls inside
    ``tmodule.no_sync()`` (the first as ``micro_step``), then a step that
    folds them; graph_stats reads the TrainStep's counts."""

    def __init__(self, step, micro: int = 2):
        self.step, self.micro, self.i = step, micro, 0

    @property
    def _cs(self):
        return self.step._cs

    def __call__(self, *batch):
        at = self.i % (self.micro + 1)
        self.i += 1
        if at == 0:
            return self.step.micro_step(*batch)
        if at < self.micro:
            with self.step.tmodule.no_sync():
                return self.step(*batch)
        return self.step(*batch)


def param_state(step) -> dict:
    """The module's whole (unpadded) parameters and buffers, cloned."""
    return {k: v.detach().clone() for k, v in step.tmodule.state_dict().items()}


def sharded_agreement(tt, cudaex, seed) -> dict:
    """f32, TF32 off, llama-350m at 2 layers, B=1, T=1024, one-rank meshes
    of the NCCL group: 3 captured steps (a new batch each) under each of
    SHARDED_PLANS against the plain captured TrainStep from the same
    weights: losses and parameters bit-equal (one-rank collectives and
    pack/unpack only move data). Then a no_sync window (a micro_step, a
    micro-step through no_sync, the step that folds them) under
    fsdp(zero=3) against the same window with no plan, op by op: losses
    within LOSS_RTOL, parameters within MOE_PARAM_ATOL (flip-prone ones
    within ADAMW_FLIP_ATOL), moe_train_agreement's bounds; and 3 such
    windows captured against op by op, bit for bit."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM

    B, T, n_steps = 1, 1024, 3
    cfg = Config.from_name("llama-350m", n_layer=2, block_size=T)
    batches = [train_batch(cfg, B, T, seed + i) for i in range(n_steps)]
    counters = (cudaex.flash_rope_attention, cudaex.flash_rope_attention_backward, cudaex.adamw_update)
    runs = {}
    for plan in ("plain",) + SHARDED_PLANS:
        model = GPTForCausalLM(cfg, torch.float32, seed=seed)
        step = sharded_step(tt, model, cfg, plan, False)
        n0 = [c.launches for c in counters]
        losses = [float(step(*b)) for b in batches]
        runs[plan] = dict(losses=losses, params=param_state(step), collectives=collectives(tt, step),
                          launches={c.__name__: c.launches - n for c, n in zip(counters, n0)},
                          **graph_stats(tt, [step]))
        require_replayed(f"sharded_agreement ({plan})", runs[plan])
        del step, model
    ref = runs["plain"]
    plans = {}
    for plan in SHARDED_PLANS:
        got = runs[plan]
        differ = sorted(k for k in ref["params"] if not torch.equal(got["params"][k], ref["params"][k]))
        plans[plan] = dict(losses=got["losses"], losses_bit_equal=got["losses"] == ref["losses"],
                           params_not_bit_equal=differ, collectives_per_step=got["collectives"],
                           launches=got["launches"], graph_replays=got["graph_replays"])
    # the no_sync window under fsdp(zero=3) against no plan, op by op
    wins = {}
    for plan in ("plain", "fsdp:3"):
        model = GPTForCausalLM(cfg, torch.float32, seed=seed)
        rec = GradRecorder(optim.AdamW(lr=TRAIN_LR), wins["plain"]["rec"] if wins else None)
        step = WindowedStep(sharded_step(tt, model, cfg, plan, False, rec, cuda_graphs=False))
        wins[plan] = dict(losses=[float(step(*b)) for b in batches], rec=rec, params=param_state(step.step),
                          step_count=step.step.step_count)
        del step, model
    win, wref = wins["fsdp:3"], wins["plain"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(win["losses"], wref["losses"]))
    prone = win["rec"].flip_prone
    tight = torch.cat([(win["params"][k] - wref["params"][k]).abs()[~prone[k]] for k in prone])
    flip = torch.cat([(win["params"][k] - wref["params"][k]).abs()[prone[k]] for k in prone])
    window = dict(losses=win["losses"], plain_losses=wref["losses"], loss_max_rel=loss_rel, loss_rtol=LOSS_RTOL,
                  updates=win["step_count"], param_max_abs=tight.max().item(), param_atol=MOE_PARAM_ATOL,
                  flip_prone_elements=flip.numel(), flip_prone_max_abs=flip.max().item() if flip.numel() else 0.0,
                  flip_prone_atol=ADAMW_FLIP_ATOL)

    def windowed(graphs):
        model = GPTForCausalLM(cfg, torch.float32, seed=seed)
        return WindowedStep(sharded_step(tt, model, cfg, "fsdp:3", False, cuda_graphs=graphs)), model

    window["captured"] = captured_against_op_by_op(
        tt, "sharded_agreement (the captured window)", windowed,
        [train_batch(cfg, B, T, seed + 10 + i) for i in range(3 * n_steps)], counters)
    out = dict(model=f"{cfg.name} n_layer=2", B=B, T=T, steps=n_steps, tf32=False, plain_losses=ref["losses"],
               plain_collectives_per_step=ref["collectives"], plans=plans, window=window)
    emit("sharded_agreement", **out)
    bad = {p: r for p, r in plans.items() if not r["losses_bit_equal"] or r["params_not_bit_equal"]
           or ("bucketing" in p and not r["collectives_per_step"]["backward"].get("pack"))}
    if bad:
        raise AssertionError(f"sharded_agreement: not bit-equal to the plain step, or bucketing packed "
                             f"nothing: {bad}")
    if (win["step_count"] != 1 or not loss_rel <= LOSS_RTOL or not window["param_max_abs"] <= MOE_PARAM_ATOL
            or not window["flip_prone_max_abs"] <= ADAMW_FLIP_ATOL):
        raise AssertionError(f"sharded_agreement: the fsdp window against the plain window: {window}")
    del runs, wins, tight, flip
    torch.cuda.empty_cache()
    return out


def ep_params(dev, dtype, gen) -> dict:
    """moe_ep_forward's weights at MoEMLP's init scale: the router (D, E)
    and the expert panels (E, D, H), (E, D, H), (E, H, D)."""
    s = 1.0 / math.sqrt(EP_D)

    def u(shape, bound):
        return ((torch.rand(shape, device=dev, generator=gen) * 2 - 1) * bound).to(dtype)

    return {"gate_w": u((EP_D, EP_E), s), "w_gate": u((EP_E, EP_D, EP_H), s), "w_up": u((EP_E, EP_D, EP_H), s),
            "w_down": u((EP_E, EP_H, EP_D), s / 2)}


def ep_reference(p: dict, x, K: int, grouped):
    """moe_ep_forward at ep=1, drop-free, written out in plain torch: the
    softmax router, top-K renormalized, each (token, k) into the next slot
    of its expert's bin of N·K slots, ``grouped(bins, panels, live rows)``,
    the weighted combine."""
    N, D = x.shape
    E = p["gate_w"].shape[1]
    cap = N * K
    probs = torch.softmax(x @ p["gate_w"], -1)
    top_p, top_i = torch.topk(probs, K, -1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    flat_e = top_i.reshape(-1)
    oh = torch.nn.functional.one_hot(flat_e, E)
    slot = flat_e * cap + oh.cumsum(0).gather(1, flat_e[:, None])[:, 0] - 1
    bins = x.new_zeros(E * cap, D).index_add(0, slot, x.repeat_interleave(K, 0))
    y = grouped(bins.view(E, cap, D), p["w_gate"], p["w_up"], p["w_down"], oh.sum(0)).reshape(E * cap, D)
    return (y[slot] * top_p.reshape(-1, 1)).view(N, K, D).sum(1)


def ep_moe(tt, cudaex, seed, dev="cuda") -> dict:
    """moe_ep_forward over a one-rank ep mesh of the NCCL group (its two
    all_to_alls NCCL calls) at MoEGPT's expert widths (E=8, D=2048, H=1024,
    top-2) on N=4,096 bf16 tokens, drop-free (bins of N·K rows): the
    grouped_mlp launches a call (the bins' live counts as group_sizes) and
    the device µs a call, profiled twice, against MoEMLP's grouped road
    (bins of N rows) on the same tokens and weights. Then f32: the output
    and the gradients of sum(out · dy) for x, the router and the three
    panels, through the port's value_and_grad, each within MOE_GRAD_RTOL
    of its largest of the same function written out (ep_reference) on
    cudaex.grouped_mlp_plain with torch autograd."""
    from thunder_tpu_torch.models.moe import MoEConfig, MoEMLP
    from thunder_tpu_torch.parallel import make_mesh
    from thunder_tpu_torch.parallel.expert_parallel import moe_ep_forward
    from thunder_tpu_torch.transforms.autodiff import ThunderValueAndGrad

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mesh = make_mesh({"ep": 1})

    def ep_fwd(p, x):
        return moe_ep_forward(p, x, mesh=mesh, axis="ep", n_expert_per_token=EP_K)

    p = ep_params(dev, torch.bfloat16, gen)
    x = torch.randn(EP_N, EP_D, device=dev, generator=gen).to(torch.bfloat16)
    ep = tt.jit(ep_fwd)
    moe = MoEMLP(MoEConfig(n_embd=EP_D, intermediate_size=EP_H, n_expert=EP_E, n_expert_per_token=EP_K),
                 torch.bfloat16, dev)
    with torch.no_grad():
        moe.gate.weight.copy_(p["gate_w"].t())
        for k in ("w_gate", "w_up", "w_down"):
            getattr(moe, k).copy_(p[k])
    road = tt.jit(moe)
    xb = x.view(1, EP_N, EP_D)
    calls = {"ep": lambda: ep(p, x), "moe_mlp": lambda: road(xb)}
    launches, device_us, checks = {}, {}, {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        n0 = cudaex.grouped_mlp.launches
        call()
        torch.cuda.synchronize()
        launches[name] = cudaex.grouped_mlp.launches - n0
        prof, checks[name] = profile_twice(f"ep_moe ({name})", lambda: [call() for _ in range(EP_CALLS)])
        device_us[name] = sum(r[0] for r in prof["rows"]) / EP_CALLS
    bf16_diff = (ep(p, x).float() - road(xb).view(EP_N, EP_D).float()).abs().max().item()
    if launches != {"ep": 1, "moe_mlp": 1}:
        raise AssertionError(f"ep_moe: grouped_mlp launches a call {launches}, want 1 each")
    del p, x, moe, road, ep, calls, prof
    # f32: the port's value_and_grad against the written-out function on the plain grouped MLP
    p = ep_params(dev, torch.float32, gen)
    x = torch.randn(EP_N, EP_D, device=dev, generator=gen)
    dy = torch.randn(EP_N, EP_D, device=dev, generator=gen)
    n0 = cudaex.grouped_mlp.launches
    out = tt.jit(ep_fwd)(p, x)
    (_, grads) = ThunderValueAndGrad(lambda p, x: (ep_fwd(p, x) * dy).sum(), argnums=(0, 1))(p, x)
    f32_launches = cudaex.grouped_mlp.launches - n0
    gp, gx = grads[0]
    ref_p = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    ref_x = x.detach().clone().requires_grad_()
    ref_out = ep_reference(ref_p, ref_x, EP_K, cudaex.grouped_mlp_plain)
    ref_g = torch.autograd.grad((ref_out * dy).sum(), [ref_x, *ref_p.values()])
    got = {"out": out, "x": gx, **{k: gp[k] for k in ref_p}}
    want = {"out": ref_out.detach(), "x": ref_g[0], **dict(zip(ref_p, ref_g[1:]))}
    rel = {k: ((got[k] - want[k]).abs().max() / want[k].abs().max().clamp(min=1e-30)).item() for k in want}
    res = dict(E=EP_E, D=EP_D, H=EP_H, K=EP_K, N=EP_N, dtype="bf16; f32 agreement", capacity=EP_N * EP_K,
               grouped_mlp_launches_per_call=launches["ep"], moe_mlp_grouped_mlp_launches_per_call=launches["moe_mlp"],
               device_us_per_call=device_us["ep"], moe_mlp_device_us_per_call=device_us["moe_mlp"],
               ep_over_moe_mlp=device_us["ep"] / device_us["moe_mlp"], two_profiles=checks,
               bf16_max_abs_diff_against_moe_mlp=bf16_diff, f32_grouped_mlp_launches=f32_launches,
               f32_max_err_over_max_ref=rel, rtol=MOE_GRAD_RTOL)
    emit("ep_moe", **res)
    if f32_launches < 2 or not all(v <= MOE_GRAD_RTOL for v in rel.values()):
        raise AssertionError(f"ep_moe: f32 launches {f32_launches}, errors over each tensor's largest {rel}")
    del p, x, dy, out, grads, ref_p, ref_x, ref_out, ref_g, got, want
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 25-29: vision — ViT-B/16 and ResNet-50 through the captured
# TrainStep, ViT's eval loss, and their f32 agreements
# ---------------------------------------------------------------------------

VIT_B = 64
RESNET_B = 64
# torchvision's ResNet recipe (named, not fetched): SGD, lr 0.1, momentum 0.9,
# weight decay 1e-4
RESNET_SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
# resnet_train_agreement's SGD road: the recipe's momentum and weight decay
# at a rate where the loss does not run away over 3 steps at its B=8 (at
# 0.1 it rises over the 3 steps, and the two f32 roads part with it).
RESNET_AGREE_SGD = dict(RESNET_SGD, lr=1e-3)
# PARAM_ATOL counts AdamW's moves, ±lr whatever the gradient. An SGD move is
# lr times the momentum buffer, a sum of gradients with no bound of its own,
# and a ReLU, pool or BatchNorm decision taken otherwise moves a gradient
# element by its whole upstream value. So the SGD road is held against the
# exact answer, the hand-written step in f64: each tensor's distance from it
# over that tensor's move there, worst and median over the tensors, at most
# SGD_F64_RATIO times the hand-written f32 step's. A wrong rate, sign or
# momentum misses by a large share of the move (no momentum: 2.61 of a
# steady gradient's 5.61 lr over 3 steps), where two f32 roads share most
# of their rounding.
SGD_F64_RATIO = 2.0


def image_batch(B, size, classes, seed, dev="cuda"):
    """Random images (B, 3, size, size) f32 and labels (B,) int64 from a
    numpy seed."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal((B, 3, size, size)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, classes, (B,)).astype(np.int64)).to(dev)
    return x, y


def trace_matmul_ops(trace) -> float:
    """Forward operations of a claimed trace's convolutions, linears and
    matmuls from their shapes: 2 per multiply-add (the attention that the
    flash kernels run is counted apart)."""
    from thunder_tpu_torch.core.prims import PrimIDs

    ops = 0.0
    for b in trace.bound_symbols:
        if b.sym.id == PrimIDs.CONVOLUTION:
            a, w = b.args[0], b.args[1]
            ops += 2 * math.prod(b.output.shape) * math.prod(w.shape[1:])
        elif b.sym.id == PrimIDs.LINEAR:
            ops += 2 * math.prod(b.output.shape) * b.args[0].shape[-1]
        elif b.sym.id == PrimIDs.MATMUL:
            ops += 2 * math.prod(b.output.shape) * b.args[0].shape[-1]
    return ops


def vision_bound(fwd_trace, model, attn_fwd_ops: float, state_bytes_per_param: int, batch_bytes: int) -> dict:
    """The least time of one vision train step, from shapes: 3x the forward
    trace's conv/linear/matmul operations (forward, input and weight
    gradients) plus 3.5x the full attention's forward 4·B·H·T²·hs
    (step_bound's count); bytes: the f32 parameters and the optimizer's
    state read and written once, the batch read once."""
    ops = 3 * trace_matmul_ops(fwd_trace) + 3.5 * attn_fwd_ops
    n_all = sum(p.numel() for p in model.parameters())
    b, by = bound_ms(2 * state_bytes_per_param * n_all + batch_bytes, ops, "bfloat16")
    return dict(model_ops_per_step=ops, bound_ms=b, bound_by=by)


def vision_train(tt, cell: str, step, model, x, y, counters, want: dict, n_steps: int = 10) -> dict:
    """A vision TrainStep's timed run, as train and nano_train time theirs:
    the first call timed as compile, 2 warm-up steps (capture, replay),
    then the counters zeroed and n_steps timed steps, which must replay with
    no capture and launch each counter ``want[name]`` times; losses finite
    and falling."""
    reset_peak_memory()
    t0 = time.perf_counter()
    first = float(step(x, y))
    compile_s = time.perf_counter() - t0
    for _ in range(2):
        step(x, y)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    graphs0 = graph_stats(tt, [step])
    step_s, losses = timed_steps(lambda: step(x, y), 0, n_steps)
    launches = {c.__name__: c.launches for c in counters}
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [step]).items()}
    if graphs != {"graph_captures": 0, "graph_replays": n_steps}:
        raise AssertionError(f"{cell}: the timed steps ran {graphs}, want {n_steps} replays and no capture")
    if launches != {k: v * n_steps for k, v in want.items()}:
        raise AssertionError(f"{cell}: launches {launches} over {n_steps} steps, want {want} a step")
    losses = [first] + losses
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cell} losses {losses}")
    fwd = tt.last_traces(step)[-1].bound_symbols
    bwd = tt.last_backward_traces(step)[-1].bound_symbols
    return dict(steps=n_steps, ms_per_step=step_s * 1e3, images_per_s=x.shape[0] / step_s,
                compile_s=compile_s, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses,
                launches=launches, launches_per_step={k: v / n_steps for k, v in launches.items()},
                ops_per_step={name: sum(1 for b in t if b.sym.name not in ("python_del", "python_return"))
                              for name, t in (("forward", fwd), ("backward", bwd))}, **graphs)


def vit_reference_loss(params: dict, cfg, x, y, attention, linear=None):
    """ViT's loss written out in plain torch ops over ViTForClassification's
    parameter dict (models/vit.py's module math): F.conv2d patchify,
    F.layer_norm, erf GELU, ``attention(q, k, v)`` on (B, H, T, hs) heads."""
    F = torch.nn.functional
    p = lambda n: params[f"vit.{n}"]  # noqa: E731
    B, C, nh = x.shape[0], cfg.dim, cfg.heads
    h = F.conv2d(x, p("patch_embed.proj.weight"), p("patch_embed.proj.bias"), stride=cfg.patch_size)
    h = torch.cat([p("cls_token").expand(B, 1, C), h.flatten(2).transpose(1, 2)], 1) + p("pos_embed")
    for i in range(cfg.depth):
        w = lambda n: params[f"vit.blocks.{i}.{n}"]  # noqa: E731
        a = F.layer_norm(h, (C,), w("norm1.weight"), w("norm1.bias"), 1e-5)
        q, k, v = F.linear(a, w("attn.qkv.weight"), w("attn.qkv.bias")).split(C, -1)
        q, k, v = (t.reshape(B, -1, nh, C // nh).transpose(1, 2) for t in (q, k, v))
        o = attention(q, k, v).transpose(1, 2).reshape(B, -1, C)
        h = h + F.linear(o, w("attn.proj.weight"), w("attn.proj.bias"))
        m = F.layer_norm(h, (C,), w("norm2.weight"), w("norm2.bias"), 1e-5)
        h = h + F.linear(F.gelu(F.linear(m, w("fc1.weight"), w("fc1.bias"))), w("fc2.weight"), w("fc2.bias"))
    h = F.layer_norm(h, (C,), p("norm.weight"), p("norm.bias"), 1e-5)
    return F.cross_entropy(F.linear(h[:, 0], p("head.weight"), p("head.bias")).float(), y.long())


def plain_full_attention(q, k, v):
    """Full (non-causal) softmax attention written out."""
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(torch.softmax(s, -1), v)


def sdpa_full_attention(q, k, v):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v)


def vit_attention_ops(cfg, B) -> float:
    T = (cfg.image_size // cfg.patch_size) ** 2 + 1
    return cfg.depth * 4 * B * cfg.heads * T * T * (cfg.dim // cfg.heads)


def vit_train(tt, cudaex, seed) -> tuple:
    """TrainStep(jit(ViTForClassification(vit-b16), [AutocastTransform()]),
    AdamW(lr=1e-4)) at B=64 (224x224, patch 16: T=197, 12 heads of 64),
    full width and depth: compile, 2 warm-up and 10 timed steps on one
    batch; tt_flash_fwd and tt_flash_bwd 12 a step each (full attention),
    the AdamW kernel once. Then its profile, the same-call pair and the
    captured step in turns with the hand-written baseline (F.conv2d,
    F.layer_norm, F.scaled_dot_product_attention)."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.vit import ViTForClassification, configs
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    cfg = configs["vit-b16"]
    B = VIT_B
    model = ViTForClassification(cfg, torch.float32, seed=seed)
    step = TrainStep(tt.jit(model, transforms=[AutocastTransform()]), optim.AdamW(lr=TRAIN_LR))
    x, y = image_batch(B, cfg.image_size, cfg.num_classes, seed)
    counters = (cudaex.flash_attention, cudaex.flash_attention_backward, cudaex.adamw_update)
    run = vision_train(tt, "vit_train", step, model, x, y, counters,
                       {"flash_attention": cfg.depth, "flash_attention_backward": cfg.depth, "adamw_update": 1})
    fwd = tt.last_traces(step)[-1].bound_symbols
    bwd = tt.last_backward_traces(step)[-1].bound_symbols
    claims = {"forward": sum(b.impl is cudaex._flash_fwd_impl for b in fwd),
              "backward": sum(b.impl is cudaex._flash_bwd_impl for b in bwd)}
    if claims != {"forward": cfg.depth, "backward": cfg.depth}:
        raise AssertionError(f"the ViT step's flash claims are {claims}")
    bound = vision_bound(tt.last_traces(step)[-1], model, vit_attention_ops(cfg, B), 3 * 4, x.numel() * 4)
    T = (cfg.image_size // cfg.patch_size) ** 2 + 1
    out = dict(model="vit-b16", depth=cfg.depth, B=B, T=T, image_size=cfg.image_size,
               dtype="bf16 autocast, f32 master", optimizer="AdamW(lr=1e-4)", **run,
               mfu=bound["model_ops_per_step"] / (run["ms_per_step"] / 1e3) / PEAK_OPS["bfloat16"], **bound,
               claims=claims)
    emit("vit_train", **out)
    out["profile"] = train_profile(step, x, y, "vit_train_profile")
    train_pair("vit_train", step, x, y, counters)

    def make_baseline():
        params = {k: p.detach().clone().requires_grad_() for k, p in model.named_parameters()}
        opt = ReferenceAdamW(list(params.values()), TRAIN_LR)

        def base_step():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                loss = vit_reference_loss(params, cfg, x, y, sdpa_full_attention)
            opt.step(torch.autograd.grad(loss, opt.params))
            return loss.detach()
        return base_step

    out["baseline"] = against_baseline(tt, "vit_train_baseline", step, x, y, make_baseline, B,
                                       bound["model_ops_per_step"])
    del step
    torch.cuda.empty_cache()
    return out, model


def against_baseline(tt, phase, step, x, y, make_baseline, B, model_ops, n_steps: int = 10) -> dict:
    """The captured TrainStep and a hand-written plain-PyTorch step
    (``make_baseline()`` -> its step, over detached copies of the weights:
    bf16 autocast, torch autograd, the reference optimizer) timed in turns,
    twice each: baseline, port, port, baseline; n_steps a run after 2
    untimed steps, wall ms a step (host clock, synchronized). Only the
    baseline's speed is read. Its host time moves between runs, so each run
    is reported; the port's runs must replay with no capture. The
    baseline's peak memory is read above what the port's step holds."""
    resident = torch.cuda.memory_allocated()
    reset_peak_memory()
    base_step = make_baseline()
    graphs0 = graph_stats(tt, [step])
    runs = []
    for road in ("baseline", "port", "port", "baseline"):
        step_s, losses = timed_steps(base_step if road == "baseline" else lambda: step(x, y), 2, n_steps)
        runs.append(dict(road=road, ms_per_step=step_s * 1e3, images_per_s=B / step_s,
                         mfu=model_ops / step_s / PEAK_OPS["bfloat16"], losses=losses))
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [step]).items()}
    if graphs != {"graph_captures": 0, "graph_replays": 2 * (2 + n_steps)}:
        raise AssertionError(f"{phase}: the port's runs ran {graphs}")
    out = dict(rounds=runs, baseline_ms_per_step=[r["ms_per_step"] for r in runs if r["road"] == "baseline"],
               port_ms_per_step=[r["ms_per_step"] for r in runs if r["road"] == "port"],
               baseline_peak_memory_gb=(torch.cuda.max_memory_allocated() - resident) / 1e9, **graphs)
    emit(phase, **out)
    del base_step
    torch.cuda.empty_cache()
    return out


VIT_EVAL_RTOL = NANO_EVAL_RTOL


def vit_eval(tt, cudaex, model, seed) -> dict:
    """The no-grad forward loss of vit_train's model in eval mode,
    ``jit(model)(x, labels)`` under autocast at B=64: within VIT_EVAL_RTOL
    (PERF.md §2's eval-loss bar) of F.cross_entropy on the same program's
    logits; whether the cross-entropy kernel claims the (64, 1000) bf16
    logits, and its launches."""
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    cfg = model.vit.cfg
    B = VIT_B
    model.eval()
    x, y = image_batch(B, cfg.image_size, cfg.num_classes, seed + 1)
    logits = tt.jit(model.vit, transforms=[AutocastTransform()])(x)
    want = torch.nn.functional.cross_entropy(logits.float(), y).item()
    fn = tt.jit(model, transforms=[AutocastTransform()])
    fn(x, y)  # compile
    torch.cuda.synchronize()
    cudaex.cross_entropy.launches = 0
    cudaex.flash_attention.launches = 0
    t0 = time.perf_counter()
    loss = fn(x, y).item()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"cross_entropy": cudaex.cross_entropy.launches, "flash_fwd": cudaex.flash_attention.launches}
    claimed = [b for b in tt.last_traces(fn)[-1].bound_symbols if b.impl is cudaex._cross_entropy_impl]
    out = dict(model="vit-b16", B=B, dtype="bf16 autocast", mode="eval", ms=ms, loss=loss,
               f_cross_entropy=want, rel_err=abs(loss - want) / abs(want), rtol=VIT_EVAL_RTOL,
               launches=launches, cross_entropy_claimed=bool(claimed),
               logits=f"{tuple(claimed[0].args[0].shape)} {claimed[0].args[0].dtype}" if claimed else None)
    emit("vit_eval", **out)
    if launches != {"cross_entropy": 1, "flash_fwd": cfg.depth} or not claimed:
        raise AssertionError(f"vit eval launches {launches}, claimed {len(claimed)}")
    if not out["rel_err"] <= VIT_EVAL_RTOL:
        raise AssertionError(f"vit eval loss {loss} vs F.cross_entropy {want}")
    return out


def held_to(ref: dict, got: dict) -> float:
    """The largest |got - ref| over every tensor of ``ref``."""
    return max((got[k].detach().float() - r.detach().float()).abs().max().item() for k, r in ref.items())


def vit_train_agreement(tt, cudaex, seed) -> dict:
    """f32, TF32 off, vit-b16's width (dim 768, 12 heads, MLP 3072, 224x224,
    patch 16) at depth 2, B=8: 3 steps of the port's TrainStep against the
    hand-written step (vit_reference_loss with written-out attention,
    torch autograd, the reference AdamW) from the same weights and batch.
    Losses within LOSS_RTOL, parameters within PARAM_ATOL. Then the
    captured road against op by op
    over 3 new batches, bit-equal; cuDNN pinned to its deterministic
    algorithms there (the patchify conv's weight gradient may sum with
    atomics otherwise)."""
    from dataclasses import replace

    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.vit import ViTForClassification, configs
    from thunder_tpu_torch.training import TrainStep

    B, n_steps = 8, 3
    cfg = replace(configs["vit-b16"], depth=2)
    model = ViTForClassification(cfg, torch.float32, seed=seed)
    ref = {k: p.detach().clone().requires_grad_() for k, p in model.named_parameters()}
    x, y = image_batch(B, cfg.image_size, cfg.num_classes, seed)
    step = TrainStep(tt.jit(model), optim.AdamW(lr=TRAIN_LR))
    opt = ReferenceAdamW(list(ref.values()), TRAIN_LR)
    n0 = cudaex.flash_attention.launches
    got = [float(step(x, y)) for _ in range(n_steps)]
    want = [float(reference_step(ref, opt, cfg, x, y, plain_full_attention, False, loss_fn=vit_reference_loss))
            for _ in range(n_steps)]
    if cudaex.flash_attention.launches - n0 != cfg.depth * n_steps:
        raise AssertionError("the f32 ViT step did not run the flash kernels")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    param_max = held_to(ref, dict(model.named_parameters()))
    out = dict(model="vit-b16 depth=2", B=B, steps=n_steps, tf32=False, losses=got, reference_losses=want,
               loss_max_rel=loss_rel, loss_rtol=LOSS_RTOL, param_max_abs=param_max, param_atol=PARAM_ATOL)
    del step, ref, opt

    def road(graphs):
        m = ViTForClassification(cfg, torch.float32, seed=seed)
        return TrainStep(tt.jit(m), optim.AdamW(lr=TRAIN_LR), cuda_graphs=graphs), m

    with cudnn_deterministic():
        out["captured"] = captured_against_op_by_op(
            tt, "vit_train_agreement (captured)", road,
            [image_batch(B, cfg.image_size, cfg.num_classes, seed + 1 + i) for i in range(n_steps)],
            (cudaex.flash_attention, cudaex.flash_attention_backward, cudaex.adamw_update))
    emit("vit_train_agreement", **out)
    if not loss_rel <= LOSS_RTOL or not param_max <= PARAM_ATOL:
        raise AssertionError(f"vit train agreement: losses {loss_rel}, params {param_max}")
    del model
    torch.cuda.empty_cache()
    return out


class cudnn_deterministic:
    """cuDNN's deterministic algorithms inside the block, the setting
    restored after it: a bit-for-bit comparison of two runs needs them,
    since cuDNN's weight-gradient algorithms may sum with atomics."""

    def __enter__(self):
        self.was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.was


class ResNetLoss(torch.nn.Module):
    """A ResNet's mean cross-entropy over labels: the model a ResNet
    TrainStep takes (thunder_tpu's tests wrap theirs alike)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, y):
        from thunder_tpu_torch.ops import ltorch

        return ltorch.cross_entropy(self.net(x), y)


def resnet_reference_logits(params: dict, buffers: dict, cfg, x, training: bool):
    """ResNet v1.5's logits written out in plain torch ops over ResNetLoss's
    parameter and buffer dicts (models/resnet.py's module math): F.conv2d,
    F.batch_norm (in training mode it writes the running stats in place,
    momentum 0.1, the variance unbiased), F.relu, F.max_pool2d,
    F.adaptive_avg_pool2d, F.linear."""
    F = torch.nn.functional

    def convbn(h, name, stride, pad):
        h = F.conv2d(h, params[f"net.{name}.conv.weight"], None, stride, pad)
        return F.batch_norm(h, buffers[f"net.{name}.bn.running_mean"], buffers[f"net.{name}.bn.running_var"],
                            params[f"net.{name}.bn.weight"], params[f"net.{name}.bn.bias"], training=training,
                            momentum=0.1, eps=1e-5)

    h = F.max_pool2d(F.relu(convbn(x, "stem", 2, 3)), 3, 2, 1)
    for i, n_blocks in enumerate(cfg.layers):
        for j in range(n_blocks):
            pre, stride = f"stages.{i}.{j}", ((1 if i == 0 else 2) if j == 0 else 1)
            idn = convbn(h, f"{pre}.down", stride, 0) if f"net.{pre}.down.conv.weight" in params else h
            if cfg.block == "bottleneck":
                o = F.relu(convbn(h, f"{pre}.cbr1", 1, 0))
                o = convbn(F.relu(convbn(o, f"{pre}.cbr2", stride, 1)), f"{pre}.cbr3", 1, 0)
            else:
                o = convbn(F.relu(convbn(h, f"{pre}.cbr1", stride, 1)), f"{pre}.cbr2", 1, 1)
            h = F.relu(o + idn)
    return F.linear(F.adaptive_avg_pool2d(h, 1).flatten(1), params["net.fc.weight"], params["net.fc.bias"])


class ReferenceSGD:
    """SGD written out as thunder_tpu/optim.py's: g + wd·p, then the
    momentum buffer m·buf + g (g at the first step), then p - lr·buf."""

    def __init__(self, params: list, lr, momentum, weight_decay):
        self.params, self.lr, self.m, self.wd = params, lr, momentum, weight_decay
        self.bufs = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: list):
        for p, g, b in zip(self.params, grads, self.bufs):
            b.mul_(self.m).add_(g + self.wd * p)
            p.sub_(self.lr * b)


def resnet_train(tt, cudaex, seed) -> dict:
    """TrainStep(jit(ResNetLoss(ResNet(resnet50)), [AutocastTransform()]),
    SGD(lr=0.1, momentum=0.9, weight_decay=1e-4)) at B=64, 224x224, full
    width and depth (bottleneck v1.5): compile, 2 warm-up and 10 timed
    steps; every BatchNorm's running stats written each step (f32). No
    hand-written kernel is on this path (conv, pooling and BatchNorm run
    as torch ops: cuDNN's convolutions). Then its profile, the same-call
    pair and the captured step in turns with the hand-written baseline
    (F.conv2d, F.batch_norm)."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.resnet import build, configs
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    cfg = configs["resnet50"]
    B = RESNET_B
    model = ResNetLoss(build("resnet50", torch.float32, seed=seed))
    step = TrainStep(tt.jit(model, transforms=[AutocastTransform()]), optim.SGD(**RESNET_SGD))
    x, y = image_batch(B, 224, cfg.num_classes, seed)
    stats0 = model.net.stem.bn.running_var.clone()
    run = vision_train(tt, "resnet_train", step, model, x, y, (), {})
    buffers = dict(model.named_buffers())
    if (torch.equal(stats0, model.net.stem.bn.running_var)
            or any(b.dtype != torch.float32 for b in buffers.values())):
        raise AssertionError("resnet_train: the running stats were not written, or are not f32")
    bound = vision_bound(tt.last_traces(step)[-1], model, 0.0, 2 * 4, x.numel() * 4)
    out = dict(model="resnet50", B=B, image_size=224, dtype="bf16 autocast, f32 master and running stats",
               optimizer="SGD(lr=0.1, momentum=0.9, weight_decay=1e-4)", **run,
               mfu=bound["model_ops_per_step"] / (run["ms_per_step"] / 1e3) / PEAK_OPS["bfloat16"], **bound,
               batch_norms=sum(1 for k in buffers if k.endswith("running_mean")))
    emit("resnet_train", **out)
    out["profile"] = train_profile(step, x, y, "resnet_train_profile")
    train_pair("resnet_train", step, x, y, ())

    def make_baseline():
        buffers = {k: b.clone() for k, b in model.named_buffers()}
        params = {k: p.detach().clone().requires_grad_() for k, p in model.named_parameters()}
        opt = ReferenceSGD(list(params.values()), **RESNET_SGD)

        def base_step():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                loss = torch.nn.functional.cross_entropy(
                    resnet_reference_logits(params, buffers, cfg, x, True).float(), y)
            opt.step(torch.autograd.grad(loss, opt.params))
            return loss.detach()
        return base_step

    out["baseline"] = against_baseline(tt, "resnet_train_baseline", step, x, y, make_baseline, B,
                                       bound["model_ops_per_step"])
    del step, model
    torch.cuda.empty_cache()
    return out


def distance_from_f64(start: dict, exact: dict, roads: dict) -> dict:
    """For each road (name -> parameter dict), each tensor's largest
    distance from the f64 road's parameters (``exact``) over that tensor's
    largest move in the f64 road from ``start``; worst and median over the
    tensors."""
    out = {}
    for name, got in roads.items():
        rel = sorted(((got[k].detach().double() - e).abs().max()
                      / (e - start[k]).abs().max().clamp(min=1e-30)).item() for k, e in exact.items())
        out[name] = {"worst": rel[-1], "median": rel[len(rel) // 2]}
    return out


def resnet_train_agreement(tt, cudaex, seed) -> dict:
    """f32, TF32 off, cuDNN's deterministic algorithms (their sums have one
    order; the bit-for-bit check below needs it), resnet50's widths with
    one bottleneck a stage (layers (1, 1, 1, 1)), B=8, 224x224.

    Two roads, each from the same weights and batches as the hand-written
    step (F.conv2d, F.batch_norm, torch autograd): a train-mode forward of
    ``jit(model.net)`` (its running-stat writes), then 3 TrainSteps with a
    new batch each. ``adamw`` (AdamW(lr=1e-4), as every train agreement):
    losses within LOSS_RTOL, parameters and running stats within
    PARAM_ATOL. ``sgd`` (the recipe's momentum and weight decay at
    RESNET_AGREE_SGD's rate): losses within LOSS_RTOL, running stats within
    PARAM_ATOL, and the parameters no farther from the hand-written step
    in f64 than SGD_F64_RATIO times the hand-written f32 step is (worst and
    median tensor). Each road then ``model.eval()``: the same jit function
    retraces once, and its logits match the hand-written eval forward on
    the port's own weights and running stats within 1e-4 of the largest.
    Then the recipe's SGD road captured against op by op over 3 new
    batches, bit for bit, running stats included."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.resnet import ResNet, ResNetConfig
    from thunder_tpu_torch.training import TrainStep

    F = torch.nn.functional
    B, n_steps = 8, 3
    cfg = ResNetConfig(block="bottleneck", layers=(1, 1, 1, 1))
    batches = [image_batch(B, 224, cfg.num_classes, seed + i) for i in range(n_steps + 2)]
    f32, f64 = torch.float32, torch.float64

    def hand_written(model, dtype, make_ref):
        params = {k: p.detach().to(dtype).clone().requires_grad_() for k, p in model.named_parameters()}
        return params, {k: b.to(dtype).clone() for k, b in model.named_buffers()}, make_ref(list(params.values()))

    def hand_step(road, x, y):
        params, buffers, opt = road
        loss = F.cross_entropy(resnet_reference_logits(params, buffers, cfg, x.to(opt.params[0].dtype), True), y)
        opt.step(torch.autograd.grad(loss, opt.params))
        return loss.item()

    with cudnn_deterministic():
        out = dict(model="resnet50 layers=(1,1,1,1)", B=B, steps=n_steps, tf32=False, cudnn_deterministic=True)
        for road, make_opt, make_ref, dtypes in (
                ("adamw", lambda: optim.AdamW(lr=TRAIN_LR), lambda ps: ReferenceAdamW(ps, TRAIN_LR), (f32,)),
                ("sgd", lambda: optim.SGD(**RESNET_AGREE_SGD),
                 lambda ps: ReferenceSGD(ps, **RESNET_AGREE_SGD), (f32, f64))):
            model = ResNetLoss(ResNet(cfg, torch.float32, seed=seed))
            start = {k: p.detach().double() for k, p in model.named_parameters()}
            refs = {dt: hand_written(model, dt, make_ref) for dt in dtypes}
            fwd = tt.jit(model.net)
            fwd(batches[0][0])
            with torch.no_grad():
                for dt, (params, buffers, _) in refs.items():
                    resnet_reference_logits(params, buffers, cfg, batches[0][0].to(dt), True)
            step = TrainStep(tt.jit(model), make_opt())
            got = [float(step(x, y)) for x, y in batches[1:n_steps + 1]]
            want = {dt: [hand_step(r, x, y) for x, y in batches[1:n_steps + 1]] for dt, r in refs.items()}
            params = dict(model.named_parameters())
            res = dict(losses=got, reference_losses=want[f32],
                       loss_max_rel=max(abs(a - b) / abs(b) for a, b in zip(got, want[f32])),
                       running_stats_max_abs=held_to(refs[f32][1], dict(model.named_buffers())))
            if f64 in refs:
                res.update(f64_losses=want[f64], distance_from_f64=distance_from_f64(
                    start, {k: p.detach() for k, p in refs[f64][0].items()},
                    {"port": params, "reference_f32": refs[f32][0]}))
            else:
                res.update(param_max_abs=held_to(refs[f32][0], params))
            misses = tt.cache_misses(fwd)
            model.eval()
            logits = fwd(batches[-1][0])
            with torch.no_grad():  # on the port's own weights and running stats
                ref_logits = resnet_reference_logits(params, dict(model.named_buffers()), cfg, batches[-1][0], False)
            res.update(eval_logits_max_rel=((logits - ref_logits).abs().max() / ref_logits.abs().max()).item(),
                       eval_retraces=tt.cache_misses(fwd) - misses)
            out[road] = res
            del step, refs, params, model, fwd
        out.update(loss_rtol=LOSS_RTOL, param_atol=PARAM_ATOL, sgd_optimizer=RESNET_AGREE_SGD,
                   sgd_f64_ratio=SGD_F64_RATIO, eval_rtol=1e-4)

        def road(graphs):
            m = ResNetLoss(ResNet(cfg, torch.float32, seed=seed))
            return TrainStep(tt.jit(m), optim.SGD(**RESNET_SGD), cuda_graphs=graphs), m

        out["captured"] = captured_against_op_by_op(
            tt, "resnet_train_agreement (captured)", road,
            [image_batch(B, 224, cfg.num_classes, seed + 10 + i) for i in range(n_steps)], ())
    emit("resnet_train_agreement", **out)
    adamw, sgd = out["adamw"], out["sgd"]
    port, plain = sgd["distance_from_f64"]["port"], sgd["distance_from_f64"]["reference_f32"]
    if (any(not r["loss_max_rel"] <= LOSS_RTOL or not r["running_stats_max_abs"] <= PARAM_ATOL
            or not r["eval_logits_max_rel"] <= 1e-4 or r["eval_retraces"] != 1 for r in (adamw, sgd))
            or not adamw["param_max_abs"] <= PARAM_ATOL
            or not port["worst"] <= SGD_F64_RATIO * plain["worst"]
            or not port["median"] <= SGD_F64_RATIO * plain["median"]):
        raise AssertionError(f"resnet train agreement: adamw {adamw}, sgd {sgd}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 30-32: the torch frontend — a Llama written in plain PyTorch,
# traced through __torch_function__ (interop/torch_frontend.py)
# ---------------------------------------------------------------------------


class TorchRMSNorm(torch.nn.Module):
    """An RMSNorm weight applied by F.rms_norm."""

    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x):
        return torch.nn.functional.rms_norm(x, (x.shape[-1],), self.weight, self.eps)


class TorchAttention(torch.nn.Module):
    """Grouped-query attention with half-split RoPE written out in tensor
    ops, then F.scaled_dot_product_attention(is_causal=True,
    enable_gqa=True). The fused qkv projection keeps litgpt's grouped row
    layout, so the port model's weights load as they are."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.cfg = cfg
        width = (cfg.n_head + 2 * cfg.n_query_groups) * cfg.head_size
        self.attn = torch.nn.Linear(cfg.n_embd, width, bias=cfg.bias, dtype=dtype, device=device)
        self.proj = torch.nn.Linear(cfg.n_head * cfg.head_size, cfg.n_embd, bias=cfg.bias, dtype=dtype,
                                    device=device)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        B, T, _ = x.shape
        nh, ng, hs = cfg.n_head, cfg.n_query_groups, cfg.head_size
        per = nh // ng
        qkv = self.attn(x).view(B, T, ng, per + 2, hs)
        q = qkv[:, :, :, :per].reshape(B, T, nh, hs).transpose(1, 2)
        k = qkv[:, :, :, per].transpose(1, 2)
        v = qkv[:, :, :, per + 1].transpose(1, 2)

        def rope(t):
            h = hs // 2
            t1, t2 = t[..., :h], t[..., h:]
            c, s = cos[:, :h], sin[:, :h]
            return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], dim=-1)

        y = torch.nn.functional.scaled_dot_product_attention(rope(q), rope(k), v, is_causal=True,
                                                             enable_gqa=True)
        return self.proj(y.transpose(1, 2).reshape(B, T, nh * hs))


class TorchMLP(torch.nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        kw = dict(bias=cfg.bias, dtype=dtype, device=device)
        self.fc_1 = torch.nn.Linear(cfg.n_embd, cfg.intermediate_size, **kw)
        self.fc_2 = torch.nn.Linear(cfg.n_embd, cfg.intermediate_size, **kw)
        self.proj = torch.nn.Linear(cfg.intermediate_size, cfg.n_embd, **kw)

    def forward(self, x):
        return self.proj(torch.nn.functional.silu(self.fc_1(x)) * self.fc_2(x))


class TorchBlock(torch.nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.norm_1 = TorchRMSNorm(cfg.n_embd, cfg.norm_eps, dtype, device)
        self.attn = TorchAttention(cfg, dtype, device)
        self.norm_2 = TorchRMSNorm(cfg.n_embd, cfg.norm_eps, dtype, device)
        self.mlp = TorchMLP(cfg, dtype, device)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.norm_1(x), cos, sin)
        return x + self.mlp(self.norm_2(x))


class TorchGPT(torch.nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.wte = torch.nn.Embedding(cfg.padded_vocab_size, cfg.n_embd, dtype=dtype, device=device)
        self.h = torch.nn.ModuleList([TorchBlock(cfg, dtype, device) for _ in range(cfg.n_layer)])
        self.ln_f = TorchRMSNorm(cfg.n_embd, cfg.norm_eps, dtype, device)
        self.lm_head = torch.nn.Linear(cfg.n_embd, cfg.padded_vocab_size, bias=cfg.lm_head_bias, dtype=dtype,
                                       device=device)
        # build_rope_cache's tables, as plain tensors (buffers: the program's
        # inputs, read on every call)
        self.register_buffer("cos", torch.empty(cfg.block_size, cfg.rope_n_elem, dtype=dtype, device=device))
        self.register_buffer("sin", torch.empty(cfg.block_size, cfg.rope_n_elem, dtype=dtype, device=device))

    def forward(self, idx):
        T = idx.shape[1]
        cos, sin = self.cos[:T], self.sin[:T]
        x = self.wte(idx)
        for block in self.h:
            x = block(x, cos, sin)
        return self.lm_head(self.ln_f(x))


class TorchLlama(torch.nn.Module):
    """A Llama written in plain PyTorch (nn.Embedding, nn.Linear, F.rms_norm,
    F.scaled_dot_product_attention, F.silu, F.cross_entropy): user code, as a
    user would write it, that ``tt.jit`` takes to the torch frontend. Its
    parameter and buffer names are GPTForCausalLM's (models/litgpt.py), so
    ``torch_llama_from(port_model)`` computes the port model's function on
    the same weights. Llama configs only (RMSNorm, LLaMAMLP, RoPE over the
    whole head)."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.gpt = TorchGPT(cfg, dtype, device)

    def forward(self, idx, targets):
        logits = self.gpt(idx)
        B, T, V = logits.shape
        return torch.nn.functional.cross_entropy(logits.reshape(B * T, V),
                                                 targets.reshape(B * T).to(torch.long))


def torch_llama_from(port_model) -> TorchLlama:
    """A TorchLlama holding a copy of ``port_model``'s weights and rope tables
    (a GPTForCausalLM), on its device and in its dtype."""
    w = port_model.gpt.lm_head.weight
    user = TorchLlama(port_model.cfg, w.dtype, torch.device("meta")).to_empty(device=w.device)
    user.load_state_dict(port_model.state_dict())
    return user


FRONTEND_EVAL_RTOL = 1e-3
FRONTEND_CALLS = 5


def frontend_claims(cudaex, trace) -> dict:
    """The cuda claims of a frontend program, and any op that fell back to
    the opaque torch_eager ops."""
    impls = {"sdpa": cudaex._sdpa_impl, "rms_norm": cudaex._rms_impl, "cross_entropy": cudaex._cross_entropy_impl}
    return dict(claims={k: sum(1 for b in trace.bound_symbols if b.impl is f) for k, f in impls.items()},
                torch_eager=sorted({str(b.sym.id) for b in trace.bound_symbols
                                    if str(b.sym.id).startswith("torch_eager.")}))


def frontend_eval(tt, cudaex, seed) -> dict:
    """Llama-3-1B (16 layers, 32 heads in 8 KV groups of D=64, vocab
    128,256) in bf16 as TorchLlama, ``tt.jit(model, cuda_graphs=True)``:
    the route is the frontend; the loss at B=2, T=2048 within
    FRONTEND_EVAL_RTOL of the same module run eagerly in torch (its logits,
    the loss of them taken in f32); per call
    16 tt_flash_fwd, 33 tt_rms_norm and 1 tt_cross_entropy launches; no
    torch_eager op in the trace; after warm-up 0 captures and 0 compiles.
    Then the same-call pair with the port-native GPTForCausalLM forward on
    the same weights (captured too): frontend, native, native, frontend, ms
    a call each; device ms a call from two agreeing profiles of each."""
    from thunder_tpu_torch.interop.torch_frontend import CompiledTorchModule
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM

    B, T = 2, 2048
    cfg = Config.from_name("Llama-3-1B")
    reset_peak_memory()
    port = GPTForCausalLM(cfg, torch.bfloat16, seed=seed)
    user = torch_llama_from(port)
    fn = tt.jit(user, cuda_graphs=True)
    if not (tt.uses_torch_frontend(user) and isinstance(fn, CompiledTorchModule)):
        raise AssertionError(f"frontend_eval: jit took {type(fn).__name__}, not the torch frontend")
    idx, tgt = train_batch(cfg, B, T, seed + 3)
    with torch.no_grad():
        # the module run eagerly, its loss taken in f32 from its bf16 logits
        # (a bf16 loss is rounded to 2^-8 of itself, more than the bar)
        want = torch.nn.functional.cross_entropy(user.gpt(idx).reshape(B * T, -1).float(),
                                                 tgt.reshape(-1).long()).item()
    t0 = time.perf_counter()
    fn(idx, tgt)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    for _ in range(2):  # capture, replay
        fn(idx, tgt)
    torch.cuda.synchronize()
    counters = (cudaex.flash_attention, cudaex.rms_norm, cudaex.cross_entropy)
    for c in counters:
        c.launches = 0
    graphs0, misses0 = graph_stats(tt, [fn]), tt.cache_misses(fn)
    t0 = time.perf_counter()
    losses = [fn(idx, tgt) for _ in range(FRONTEND_CALLS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / FRONTEND_CALLS * 1e3
    losses = [x.item() for x in losses]
    launches = {c.__name__: c.launches / FRONTEND_CALLS for c in counters}
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [fn]).items()}
    compiles = tt.cache_misses(fn) - misses0
    trace = frontend_claims(cudaex, tt.last_traces(fn)[-1])
    out = dict(model=cfg.name, n_layer=cfg.n_layer, B=B, T=T, dtype="bf16", route=type(fn).__name__,
               compile_s=compile_s, ms_per_call=ms, loss=losses[0], eager_loss=want,
               rel_err=abs(losses[0] - want) / abs(want), rtol=FRONTEND_EVAL_RTOL,
               launches_per_call=launches, compiles=compiles, **graphs, **trace)
    want_launches = {"flash_attention": cfg.n_layer, "rms_norm": 2 * cfg.n_layer + 1, "cross_entropy": 1}
    if launches != want_launches or trace["torch_eager"] or compiles or graphs != {
            "graph_captures": 0, "graph_replays": FRONTEND_CALLS}:
        emit("frontend_eval", **out)
        raise AssertionError(f"frontend_eval: launches {launches} (want {want_launches}), torch_eager "
                             f"{trace['torch_eager']}, compiles {compiles}, graphs {graphs}")
    if not out["rel_err"] <= FRONTEND_EVAL_RTOL or len(set(losses)) != 1:
        emit("frontend_eval", **out)
        raise AssertionError(f"frontend_eval: losses {losses} vs eager {want}")
    native = tt.jit(port, cuda_graphs=True)
    for _ in range(3):
        native(idx, tgt)
    rounds = []
    for road, f in (("frontend", fn), ("native", native), ("native", native), ("frontend", fn)):
        f(idx, tgt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FRONTEND_CALLS):
            f(idx, tgt)
        torch.cuda.synchronize()
        rounds.append(dict(road=road, ms_per_call=(time.perf_counter() - t0) / FRONTEND_CALLS * 1e3))
    profiles = {}
    for road, f in (("frontend", fn), ("native", native)):
        prof, check = profile_twice(f"frontend_eval_{road}_profile", lambda: [f(idx, tgt) for _ in range(2)])
        rows = prof["rows"]
        profiles[road] = dict(device_ms_per_call=sum(r[0] for r in rows) / 2e3,
                              kernels_per_call=sum(r[2] for r in rows) / 2,
                              top=[{"name": k[:80], "device_ms": us / 2e3, "count": c / 2} for us, k, c in rows[:8]],
                              two_profiles=check)
    out.update(native_loss=native(idx, tgt).item(), pair=rounds, profiles=profiles,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("frontend_eval", **out)
    del fn, native, user, port
    torch.cuda.empty_cache()
    return out


def frontend_train(tt, cudaex, seed, trained: dict) -> dict:
    """llama-350m as TorchLlama, f32 master weights, B=4, T=2048, through
    ``tt.jit(model, transforms=[AutocastTransform()])`` and a user loop of
    ``tt.value_and_grad`` and ``optim.AdamW.update`` (op by op, as every
    value_and_grad runs): 3 untimed and 10 timed steps, ms a step and
    tokens/s; tt_flash_fwd and tt_flash_bwd 24 a step (rms_norm and the
    cross-entropy kernel counted as their checkers decide: autocast leaves
    the f32 RMSNorm weights beside bf16 activations); losses finite and
    falling. Then in turns with the port-native value_and_grad loop on the
    same weights (frontend, native, native, frontend), and device ms a step
    of each from two agreeing profiles. The captured TrainStep's ms a step
    (the train phase's) is printed beside it, for context only."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    B, T, n_steps = 4, 2048, 10
    cfg = Config.from_name("llama-350m", block_size=T)
    reset_peak_memory()
    port = GPTForCausalLM(cfg, torch.float32, seed=seed)
    user = torch_llama_from(port)
    idx, tgt = train_batch(cfg, B, T, seed)
    opt = optim.AdamW(lr=TRAIN_LR)

    def loop(model, jitted):
        vag = tt.value_and_grad(jitted)
        params = dict(model.named_parameters())
        state = opt.init(params)

        def step():
            loss, grads = vag(idx, tgt)
            opt.update(params, grads, state)
            return loss

        return step, vag

    step, vag = loop(user, tt.jit(user, transforms=[AutocastTransform()]))
    if type(vag).__name__ != "TorchModuleValueAndGrad":
        raise AssertionError(f"frontend_train: value_and_grad took {type(vag).__name__}")
    t0 = time.perf_counter()
    first = float(step())
    compile_s = time.perf_counter() - t0
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    counters = (cudaex.flash_attention, cudaex.flash_attention_backward, cudaex.rms_norm, cudaex.cross_entropy,
                cudaex.adamw_update)
    for c in counters:
        c.launches = 0
    step_s, losses = timed_steps(step, 0, n_steps)
    launches = {c.__name__: c.launches / n_steps for c in counters}
    losses = [first] + losses
    fwd = frontend_claims(cudaex, vag._cs.last_traces[-1])
    out = dict(model=cfg.name, n_layer=cfg.n_layer, B=B, T=T, dtype="bf16 autocast, f32 master",
               route="frontend, value_and_grad op by op", steps=n_steps, ms_per_step=step_s * 1e3,
               tokens_per_s=B * T / step_s, compile_s=compile_s, losses=losses, launches_per_step=launches,
               forward=fwd, train_step_captured_ms_per_step=trained["ms_per_step"])
    if launches["flash_attention"] != cfg.n_layer or launches["flash_attention_backward"] != cfg.n_layer:
        emit("frontend_train", **out)
        raise AssertionError(f"frontend_train: flash launches a step {launches}, want {cfg.n_layer} each")
    if fwd["torch_eager"] or not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        emit("frontend_train", **out)
        raise AssertionError(f"frontend_train: torch_eager {fwd['torch_eager']}, losses {losses}")
    native_step, _ = loop(port, tt.jit(port, transforms=[AutocastTransform()]))
    for _ in range(2):
        native_step()
    rounds = []
    for road, f in (("frontend", step), ("native", native_step), ("native", native_step), ("frontend", step)):
        s, _ = timed_steps(f, 1, PAIR_TRAIN_STEPS)
        rounds.append(dict(road=road, ms_per_step=s * 1e3))
    profiles = {}
    for road, f in (("frontend", step), ("native", native_step)):
        prof, check = profile_twice(f"frontend_train_{road}_profile", lambda: [f() for _ in range(2)])
        rows, wall_us = prof["rows"], prof["wall_us"]
        busy_us = sum(r[0] for r in rows)
        profiles[road] = dict(device_ms_per_step=busy_us / 2e3, wall_ms_per_step=wall_us / 2e3,
                              idle_share=1 - busy_us / wall_us, kernels_per_step=sum(r[2] for r in rows) / 2,
                              two_profiles=check)
    out.update(pair=rounds, profiles=profiles, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("frontend_train", **out)
    del step, native_step, user, port
    torch.cuda.empty_cache()
    return out


def frontend_train_agreement(tt, cudaex, seed) -> dict:
    """f32, TF32 off, train_agreement's config (llama-350m width at 2
    layers, B=1, T=2048): 3 AdamW steps of the frontend road (TorchLlama,
    ``tt.value_and_grad`` and ``optim.AdamW.update``) against
    reference_step's hand-written step from the same weights and batch:
    losses within LOSS_RTOL, parameters within PARAM_ATOL; the f32 flash
    kernels launch n_layer times a step."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM

    B, T, n_steps = 1, 2048, 3
    cfg = Config.from_name("llama-350m", n_layer=2, block_size=T)
    port = GPTForCausalLM(cfg, torch.float32, seed=seed)
    user = torch_llama_from(port)
    ref = {k: p.detach().clone().requires_grad_() for k, p in port.named_parameters()}
    del port
    idx, tgt = train_batch(cfg, B, T, seed)
    vag = tt.value_and_grad(tt.jit(user))
    opt = optim.AdamW(lr=TRAIN_LR)
    params = dict(user.named_parameters())
    state = opt.init(params)
    ref_opt = ReferenceAdamW(list(ref.values()), TRAIN_LR)
    n0 = cudaex.flash_attention.launches
    got = []
    for _ in range(n_steps):
        loss, grads = vag(idx, tgt)
        opt.update(params, grads, state)
        got.append(float(loss))
    launches = cudaex.flash_attention.launches - n0
    want = [float(reference_step(ref, ref_opt, cfg, idx, tgt, plain_attention, False)) for _ in range(n_steps)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    diffs = torch.cat([(params[k].detach() - ref[k].detach()).abs().flatten() for k in ref])
    out = dict(model=f"{cfg.name} n_layer=2", B=B, T=T, steps=n_steps, tf32=False, losses=got,
               reference_losses=want, loss_max_rel=loss_rel, loss_rtol=LOSS_RTOL,
               param_max_abs=diffs.max().item(), param_atol=PARAM_ATOL, flash_launches=launches)
    emit("frontend_train_agreement", **out)
    if launches != cfg.n_layer * n_steps:
        raise AssertionError(f"frontend_train_agreement: {launches} flash launches, want {cfg.n_layer * n_steps}")
    if not loss_rel <= LOSS_RTOL or not out["param_max_abs"] <= PARAM_ATOL:
        raise AssertionError(f"frontend train agreement: losses {loss_rel}, params {out['param_max_abs']}")
    del vag, user, ref, ref_opt, params, state
    torch.cuda.empty_cache()
    return out



# ---------------------------------------------------------------------------
# phases 33-36: frozen int8/NF4 linears in training, fp8 inference from a
# meta-built model, the compiler extensions
# ---------------------------------------------------------------------------

# B·T = cudaex.QUANT_MAX_M: the checkers claim every frozen linear of the step
QUANT_TRAIN_B, QUANT_TRAIN_T = 1, 512


def quant_train_transforms() -> list:
    """QuantizeInt8Transform on every mlp.fc_1 and mlp.fc_2,
    QuantizeNF4Transform on every mlp.proj (kernel layout at Llama-3-1B's
    K = 8192): those weights frozen, the rest trainable."""
    from thunder_tpu_torch.transforms.quantization import QuantizeInt8Transform, QuantizeNF4Transform

    return [QuantizeInt8Transform(target_predicate=lambda n, m: n.endswith(("mlp.fc_1", "mlp.fc_2"))),
            QuantizeNF4Transform(target_predicate=lambda n, m: n.endswith("mlp.proj"))]


def split_state(model) -> tuple[dict, dict]:
    """(trainable, frozen) parameters by name, cloned."""
    named = list(model.named_parameters())
    return ({k: p.detach().clone() for k, p in named if p.requires_grad},
            {k: p.detach().clone() for k, p in named if not p.requires_grad})


def require_frozen_and_trained(phase: str, model, trainable0: dict, frozen0: dict) -> dict:
    """Every frozen tensor (codes, scales, absmax) bit-equal to its start,
    every trainable one moved."""
    now = dict(model.named_parameters())
    changed = sorted(k for k, v in frozen0.items() if not torch.equal(now[k].detach(), v))
    stuck = sorted(k for k, v in trainable0.items() if torch.equal(now[k].detach(), v))
    if changed or stuck:
        raise AssertionError(f"{phase}: frozen tensors changed {changed[:8]}; trainable ones did not "
                             f"move {stuck[:8]}")
    return dict(frozen_tensors=len(frozen0), frozen_bit_equal=True, trainable_tensors=len(trainable0),
                trainable_all_moved=True)


def require_quant_claims(phase: str, cudaex, trace) -> dict:
    """Every frozen linear of the forward trace claimed by its kernel: a
    shape the checker declines would decompose here, and fails the phase."""
    impls = {"quant.linear_int8": cudaex._int8_linear_impl, "quant.linear_nf4_kl": cudaex._nf4_kl_impl}
    seen = {k: 0 for k in impls}
    for b in trace.bound_symbols:
        sid = b.sym.id
        if isinstance(sid, str) and sid.startswith("quant."):
            if impls.get(sid) is not b.impl:
                raise AssertionError(f"{phase}: {sid} is not claimed by its kernel (impl {b.impl})")
            seen[sid] += 1
    return seen


def quant_train(tt, cudaex, seed) -> dict:
    """Llama-3-1B at full width and depth with every mlp.fc_1/fc_2 int8 and
    every mlp.proj NF4 (frozen), the rest trained: bf16 autocast, f32
    master weights, AdamW, B=1, T=512, captured."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    B, T, n_steps = QUANT_TRAIN_B, QUANT_TRAIN_T, 10
    cfg = Config.from_name("Llama-3-1B", block_size=T)
    reset_peak_memory()
    model = GPTForCausalLM(cfg, torch.float32, seed=seed)
    step = TrainStep(tt.jit(model, transforms=[*quant_train_transforms(), AutocastTransform()]),
                     optim.AdamW(lr=TRAIN_LR))
    trainable0, frozen0 = split_state(model)
    idx, tgt = train_batch(cfg, B, T, seed)
    t0 = time.perf_counter()
    first = float(step(idx, tgt))
    compile_s = time.perf_counter() - t0
    for _ in range(2):
        step(idx, tgt)
    torch.cuda.synchronize()
    counters = {"int8_linear": cudaex.int8_linear, "nf4_linear": cudaex.nf4_linear,
                "flash_rope_fwd": cudaex.flash_rope_attention,
                "flash_rope_bwd": cudaex.flash_rope_attention_backward, "adamw": cudaex.adamw_update}
    for c in counters.values():
        c.launches = 0
    count_routes(cudaex.int8_linear, cudaex.nf4_linear)
    graphs0 = graph_stats(tt, [step])
    step_s, losses = timed_steps(lambda: step(idx, tgt), 0, n_steps)
    per_step = {k: c.launches / n_steps for k, c in counters.items()}
    routes = {k: dict(counters[k].routes) for k in ("int8_linear", "nf4_linear")}
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, [step]).items()}
    if graphs != {"graph_captures": 0, "graph_replays": n_steps}:
        raise AssertionError(f"quant_train: the timed steps ran {graphs}, want {n_steps} replays and no capture")
    want = {"int8_linear": 2 * cfg.n_layer, "nf4_linear": cfg.n_layer, "flash_rope_fwd": cfg.n_layer,
            "flash_rope_bwd": cfg.n_layer, "adamw": 1}
    if per_step != want:
        raise AssertionError(f"quant_train: launches a step {per_step}, want {want}")
    if any(r["split"] != counters[k].launches or sum(r.values()) != r["split"] for k, r in routes.items()):
        raise AssertionError(f"quant_train: launches by route {routes}; want all on the split route")
    claims = require_quant_claims("quant_train", cudaex, tt.last_traces(step)[-1])
    losses = [first] + losses
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"quant_train losses {losses}")
    state = require_frozen_and_trained("quant_train", model, trainable0, frozen0)
    frozen_bytes = sum(v.numel() * v.element_size() for v in frozen0.values())
    x_dtypes = sorted({str(b.args[0].dtype) for b in tt.last_traces(step)[-1].bound_symbols
                       if isinstance(b.sym.id, str) and b.sym.id.startswith("quant.")})
    out = dict(model=cfg.name, n_layer=cfg.n_layer, B=B, T=T, dtype="bf16 autocast, f32 master",
               frozen="int8 mlp.fc_1/fc_2, NF4 mlp.proj", frozen_linears_x_dtype=x_dtypes,
               steps=n_steps, ms_per_step=step_s * 1e3, tokens_per_s=B * T / step_s, compile_s=compile_s,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses,
               launches_per_step=per_step, launches_by_route=routes, claims_per_forward=claims,
               trainable_parameters=sum(v.numel() for v in trainable0.values()),
               frozen_weight_bytes=frozen_bytes, **state, **graphs)
    del trainable0, frozen0
    prof = train_profile(step, idx, tgt, "quant_train_profile")
    out.update(device_ms_per_step=prof["device_busy_ms"] / prof["steps"], idle_share=prof["idle_share"],
               device_ms_per_step_by_kind=prof["device_ms_per_step_by_kind"])
    emit("quant_train", **out)
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


class FrozenLinearReference(torch.autograd.Function):
    """A frozen int8 or NF4 linear written out in plain torch. Forward: the
    kernels' function in f32 (int8: the sum of x·q, then the per-row
    scale; NF4: the kernel-layout codes looked up in the NF4 table times
    their block's absmax). Backward: thunder_tpu's rules (_qlin_bwd,
    _nf4_kl_bwd): the incoming gradient and the dequantized weight rounded
    to bf16, dx their product cast back to the gradient's dtype."""

    @staticmethod
    def forward(ctx, x, kind, codes, aux):
        if kind == "int8":
            y = torch.matmul(x.float(), codes.float().t()) * aux.float()
            ctx.w_bf16 = codes.to(torch.bfloat16) * aux.to(torch.bfloat16)[:, None]
        else:
            w = nf4_dequant_written(codes, aux, x.shape[-1])
            y = torch.matmul(x.float(), w.t())
            ctx.w_bf16 = w.to(torch.bfloat16)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return torch.matmul(g.to(torch.bfloat16), ctx.w_bf16).to(g.dtype), None, None, None


def nf4_dequant_written(packed, absmax, K: int):
    """Kernel-layout NF4 (transforms/quantization.py:pack_nf4_kernel_layout)
    to f32: within each block_k slice of a row, byte j holds column j in
    its high nibble and column j + block_k/2 in its low one; 64-value blocks
    share an absmax."""
    from thunder_tpu_torch.transforms.quantization import NF4_CODE, nf4_kernel_block_k

    N, bk = packed.shape[0], nf4_kernel_block_k(K)
    b = packed.reshape(N, K // bk, bk // 2).long()
    codes = torch.cat([b >> 4, b & 15], dim=-1).reshape(N, K)
    return NF4_CODE.to(packed.device)[codes] * absmax.reshape(N, K // 64).repeat_interleave(64, dim=1)


# The frozen linears' step-1 gradients against FrozenLinearReference's. Both
# sides compute in f32 but for one rounding, the same on both: the frozen
# backward rounds the incoming gradient and the dequantized weight to bf16.
# Where the two f32 gradients straddle a bf16 rounding boundary, their
# rounded values land one bf16 ulp (at most 2^-7 of the value) apart, and
# that gap flows on into every gradient upstream; if every rounded element
# landed apart, a tensor's gradient would move by at most about 2^-7 of its
# norm. So each trainable tensor's step-1 gradient is held to
# QUANT_GRAD_RTOL = 2^-7 of its norm: a missing scale, a wrong NF4 table
# entry or a transposed weight moves it by O(1).
QUANT_GRAD_RTOL = 2.0 ** -7
# The phase's two data: the held one (int8-exact fc_1/fc_2 at the init's
# scale, codes · 2^-13: std ~0.009, the init's ~0.013), and every linear
# int8-exact at 2^-9 (std 0.14, loss ~29.7), on which the 3-step losses
# part past LOSS_RTOL (1.9e-4 on an H100 80GB HBM3), as AdamW's ±lr steps of
# near-zero gradients follow signs that the summation order can flip: on it
# the phase holds the first step (its loss and gradients, which no AdamW
# step has touched) and reports the 3 steps.
QUANT_AGREE_DATA = {"fc_1/fc_2 at 2^-13": (lambda name: name.endswith(("mlp.fc_1", "mlp.fc_2")), 2.0 ** -13),
                    "every linear at 2^-9": (None, 2.0 ** -9)}


class FirstGradsAdamW(ReferenceAdamW):
    """ReferenceAdamW that keeps its first step's gradients."""

    def step(self, grads: list):
        if self.t == 0:
            self.first = [g.detach().clone() for g in grads]
        super().step(grads)


def quant_train_agreement(tt, cudaex, seed) -> dict:
    """f32, TF32 off, Llama-3-1B's widths at 2 layers, B=1, T=512 (every
    frozen linear under QUANT_MAX_M, on its kernel's split route), on each of
    QUANT_AGREE_DATA: 3 AdamW steps of the port's TrainStep (op by op, its
    gradients read by GradRecorder) against the hand-written step whose
    frozen linears are FrozenLinearReference. Held on both data: the
    step-1 loss within LOSS_RTOL, every trainable tensor's step-1 gradient
    within QUANT_GRAD_RTOL of its norm, the frozen tensors bit-equal. Held
    on the first data (the held one): the 3 steps' losses within LOSS_RTOL
    and parameters within PARAM_ATOL; on the second they are reported.
    Then the captured step against op by op, bit for bit (``captured``)."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.training import TrainStep

    B, T, n_steps = QUANT_TRAIN_B, QUANT_TRAIN_T, 3
    cfg = Config.from_name("Llama-3-1B", n_layer=2, block_size=T)
    idx, tgt = train_batch(cfg, B, T, seed)
    held_data = next(iter(QUANT_AGREE_DATA))
    out = dict(model=f"{cfg.name} n_layer=2", B=B, T=T, steps=n_steps, tf32=False, loss_rtol=LOSS_RTOL,
               grad_rtol=QUANT_GRAD_RTOL, param_atol=PARAM_ATOL, data={})
    failed = []
    for data, (select, scale) in QUANT_AGREE_DATA.items():
        model = GPTForCausalLM(cfg, torch.float32, seed=seed)
        int8_exact_(model.gpt, seed, select=select, scale=scale)
        rec = GradRecorder(optim.AdamW(lr=TRAIN_LR))
        step = TrainStep(tt.jit(model, transforms=quant_train_transforms()), rec, cuda_graphs=False)
        trainable0, frozen0 = split_state(model)
        ref = {k: v.clone().requires_grad_() for k, v in trainable0.items()}
        consts = {k: v.clone() for k, v in frozen0.items()}

        def linear(x, name):
            mod = name[:-len(".weight")]
            if f"{mod}.scale" in consts:
                return FrozenLinearReference.apply(x, "int8", consts[name], consts[f"{mod}.scale"])
            if f"{mod}.absmax" in consts:
                return FrozenLinearReference.apply(x, "nf4", consts[name], consts[f"{mod}.absmax"])
            return torch.nn.functional.linear(x, ref[name])

        opt = FirstGradsAdamW(list(ref.values()), TRAIN_LR)
        n0 = (cudaex.int8_linear.routes["split"], cudaex.nf4_linear.routes["split"])
        got = [float(step(idx, tgt)) for _ in range(n_steps)]
        launched = (cudaex.int8_linear.routes["split"] - n0[0], cudaex.nf4_linear.routes["split"] - n0[1])
        want = [float(reference_step(ref, opt, cfg, idx, tgt, plain_attention, False, linear=linear))
                for _ in range(n_steps)]
        if launched != (2 * cfg.n_layer * n_steps, cfg.n_layer * n_steps):
            raise AssertionError(f"quant_train_agreement: int8/NF4 split-route launches {launched} over "
                                 f"{n_steps} steps")
        state = require_frozen_and_trained("quant_train_agreement", model, trainable0, frozen0)
        g1, r1 = rec.steps[0], dict(zip(ref, opt.first))
        if g1.keys() != r1.keys():
            raise AssertionError(f"quant_train_agreement: gradients for {sorted(g1)}, want {sorted(r1)}")
        grad_rel = {k: ((g1[k] - r1[k]).norm() / r1[k].norm().clamp(min=1e-30)).item() for k in r1}
        worst = max(grad_rel, key=grad_rel.get)
        now = dict(model.named_parameters())
        rels = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        row = dict(int8_exact_scale=scale, losses=got, reference_losses=want, step1_loss_rel=rels[0],
                   loss_max_rel=max(rels), grad_max_rel=grad_rel[worst], grad_worst_tensor=worst,
                   grad_median_rel=float(np.median(list(grad_rel.values()))),
                   param_max_abs=max((now[k].detach() - v.detach()).abs().max().item() for k, v in ref.items()),
                   launches=dict(zip(("int8_linear", "nf4_linear"), launched)), **state)
        out["data"][data] = row
        if not rels[0] <= LOSS_RTOL or not row["grad_max_rel"] <= QUANT_GRAD_RTOL:
            failed.append(f"{data}: step-1 loss {rels[0]}, gradient of {worst} {row['grad_max_rel']}")
        if data == held_data and (not row["loss_max_rel"] <= LOSS_RTOL or not row["param_max_abs"] <= PARAM_ATOL):
            failed.append(f"{data}: losses {row['loss_max_rel']}, params {row['param_max_abs']}")
        del step, model, ref, opt, rec, g1, r1, trainable0, frozen0, consts, now
        gc.collect()
        torch.cuda.empty_cache()

    def held_step(graphs):
        model = GPTForCausalLM(cfg, torch.float32, seed=seed)
        int8_exact_(model.gpt, seed, select=QUANT_AGREE_DATA[held_data][0], scale=QUANT_AGREE_DATA[held_data][1])
        return TrainStep(tt.jit(model, transforms=quant_train_transforms()), optim.AdamW(lr=TRAIN_LR),
                         cuda_graphs=graphs), model

    out["captured"] = captured_against_op_by_op(
        tt, "quant_train_agreement (captured)", held_step,
        [train_batch(cfg, B, T, seed + 1 + i) for i in range(n_steps)],
        (cudaex.int8_linear, cudaex.nf4_linear, cudaex.adamw_update))
    emit("quant_train_agreement", **out)
    if failed:
        raise AssertionError(f"quant train agreement: {failed}")
    torch.cuda.empty_cache()
    return out


# fp8 inference: the port's fp8 linear (torch._scaled_mm on the card) against
# thunder_tpu's _fp8_linear_impl written out (fp8_reference_linear) on the
# same x, so on the same e4m3 codes of x and of the weights. Both sum the same
# exact products of e4m3 codes in f32-or-better, in other orders: each sum is
# within K·u·Σ|products| of the exact one (u = 2^-24, the f32 unit
# roundoff), so the two within 2·K·u·Σ|products|; the f32 epilogue (two
# products and the bias) adds 4u of |y| + |bias|; the final cast to x's
# dtype rounds each, so where the f32 values straddle a rounding boundary
# they part by one more ulp of the output dtype. FP8_INF_B, FP8_INF_T:
# frontend_eval's shape.
FP8_INF_B, FP8_INF_T = 2, 2048
F32_UNIT_ROUNDOFF = 2.0 ** -24
MANTISSA_BITS = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}
# On the card, torch._scaled_mm sums the e4m3 products on the tensor cores,
# whose partial sums keep fewer bits than f32 before each promotion into the
# f32 accumulator, so its sums stray further than an f32 accumulation: the
# f32-only bound held at the path's shapes (0.84 of it at K = 2048 on an
# H100 80GB HBM3) and failed at K = 256. FP8_MMA_EPS bounds that stray
# relative to Σ|products|; fp8_mma_sweep measures it at K from 32 to 8192 in
# every run, and the phase fails if a K exceeds it.
FP8_MMA_EPS = 2.0 ** -11
FP8_SWEEP_KS = (32, 64, 256, 1024, 2048, 4096, 8192)


def fp8_reference_linear(x, qweight, scale, bias=None) -> tuple:
    """thunder_tpu/transforms/fp8_inference.py:_fp8_linear_impl written out,
    over x's rows flattened: (y, the f32 value before the cast,
    Σ|products|·scales + |bias|), each (rows, N)."""
    x_amax = torch.clamp_min(x.abs().amax(), 1e-12)
    x_scale = (x_amax / 448.0).to(torch.float32)
    xq = (x.float() / x_scale).to(torch.float8_e4m3fn).float().reshape(-1, x.shape[-1])
    w = qweight.float()
    s = x_scale * scale[None, :]
    out = torch.matmul(xq, w.t()) * s
    mag = torch.matmul(xq.abs(), w.abs().t()) * s
    if bias is not None:
        out = out + bias
        mag = mag + bias.abs()
    return out.to(x.dtype), out, mag


def fp8_inference_err(x, qweight, scale, bias, y) -> float:
    """max over y of |y - plain| / bound (module comment above); at most 1
    where the port computes thunder_tpu's function."""
    ref, f32, mag = fp8_reference_linear(x, qweight, scale, bias)
    y = y.float().reshape(f32.shape)
    acc = ((2 * x.shape[-1] + 4) * F32_UNIT_ROUNDOFF + (FP8_MMA_EPS if y.is_cuda else 0.0)) * mag
    top = torch.maximum(f32.abs(), y.abs()) + acc
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - MANTISSA_BITS[x.dtype])
    return ((y - ref.float()).abs() / (acc + ulp)).max().item()


def fp8_mma_sweep(dev, M: int = 256, N: int = 1024) -> dict:
    """max |_scaled_mm's f32 sum − the exact sum| / Σ|products| of e4m3
    codes (x from a normal, weights from quantize_fp8_weight), by K: the
    route's accumulation error, which FP8_MMA_EPS bounds."""
    from thunder_tpu_torch.transforms import fp8_inference as f8

    gen = torch.Generator(device=dev).manual_seed(21)
    one = torch.ones((), dtype=torch.float32, device=dev)
    out = {}
    for K in FP8_SWEEP_KS:
        x = torch.randn(M, K, device=dev, generator=gen).to(torch.float8_e4m3fn)
        q, _ = f8.quantize_fp8_weight(torch.randn(N, K, device=dev, generator=gen) * 0.02)
        y = torch._scaled_mm(x, q.t(), scale_a=one, scale_b=one, out_dtype=torch.float32, use_fast_accum=False)
        exact = torch.matmul(x.double(), q.double().t())
        mag = torch.matmul(x.double().abs(), q.double().abs().t())
        out[K] = ((y.double() - exact).abs() / mag).max().item()
    return out


def fp8_inference(tt, cudaex, seed) -> dict:
    """Llama-3-1B built under meta_device() and materialized straight onto
    the card by MaterializationTransform(seed) (twice: one copy per road),
    then tt.jit(model, transforms=[FP8LinearInference()], cuda_graphs=True)
    as a captured forward at B=2, T=2048, bf16, in turns with the bf16
    forward of the same weights (fp8, bf16, bf16, fp8), each profiled twice
    a round; torch._scaled_mm calls a forward; and every fp8 linear of one
    uncaptured forward held against the plain version on its own x
    (fp8_inference_err <= 1), the logits being lm_head's."""
    from thunder_tpu_torch.core.devices import resolve_device
    from thunder_tpu_torch.executors import torchex
    from thunder_tpu_torch.models.litgpt import GPT, Config
    from thunder_tpu_torch.transforms import fp8_inference as f8
    from thunder_tpu_torch.transforms.materialization import MaterializationTransform, meta_device

    B, T = FP8_INF_B, FP8_INF_T
    cfg = Config.from_name("Llama-3-1B", block_size=T)
    reset_peak_memory()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with meta_device():
        models = {"fp8": GPT(cfg, torch.bfloat16, seed=seed), "bf16": GPT(cfg, torch.bfloat16, seed=seed)}
    meta_bytes = torch.cuda.memory_allocated() - mem0
    if meta_bytes or not all(t.is_meta for m in models.values() for t in [*m.parameters(), *m.buffers()]):
        raise AssertionError(f"fp8_inference: the meta build allocated {meta_bytes} bytes on the card")
    for m in models.values():
        MaterializationTransform(seed=seed).transform_module(m)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dev = resolve_device(None)
    if not all(t.device == dev for m in models.values() for t in [*m.parameters(), *m.buffers()]):
        raise AssertionError("fp8_inference: a materialized tensor is not on the card")
    bf16_bytes = weight_bytes(models["bf16"])
    progs = {"fp8": tt.jit(models["fp8"], transforms=[f8.FP8LinearInference()], cuda_graphs=True),
             "bf16": tt.jit(models["bf16"], cuda_graphs=True)}
    idx = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, T)).astype(np.int32)).cuda()
    with torch.no_grad():
        for prog in progs.values():
            for _ in range(3):  # op by op, capture, replay
                prog(idx)
    torch.cuda.synchronize()
    n_fp8 = sum(b.sym.id == "fp8.linear" for b in tt.last_traces(progs["fp8"])[-1].bound_symbols)
    graphs0 = graph_stats(tt, list(progs.values()))
    c0 = f8.SCALED_MM_CALLS["scaled_mm"]
    with torch.no_grad():
        logits = progs["fp8"](idx)
        bf16_logits = progs["bf16"](idx)
    torch.cuda.synchronize()
    scaled_mm_calls = f8.SCALED_MM_CALLS["scaled_mm"] - c0
    if scaled_mm_calls != n_fp8 or n_fp8 != 5 * cfg.n_layer + 1:
        raise AssertionError(f"fp8_inference: {scaled_mm_calls} torch._scaled_mm calls a forward, "
                             f"{n_fp8} fp8 linears in the trace, want {5 * cfg.n_layer + 1}")
    if not torch.isfinite(logits).all() or tuple(logits.shape) != (B, T, cfg.padded_vocab_size):
        raise AssertionError(f"fp8_inference: logits {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    rel_bf16 = ((logits.float() - bf16_logits.float()).abs().max() / bf16_logits.float().abs().max()).item()
    del logits, bf16_logits
    runs = []
    for road in ("fp8", "bf16", "bf16", "fp8"):
        prog = progs[road]
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FRONTEND_CALLS):
                prog(idx)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / FRONTEND_CALLS
            prof, check = profile_twice(f"fp8_inference_{road}_profile", lambda: [prog(idx) for _ in range(2)])
        runs.append(dict(road=road, wall_ms_per_call=wall * 1e3,
                         device_ms_per_call=sum(r[0] for r in prof["rows"]) / 2e3,
                         clock_ratio=prof["clock_ratio"], two_profiles=check))
    graphs = {k: v - graphs0[k] for k, v in graph_stats(tt, list(progs.values())).items()}
    require_replayed("fp8_inference", graphs)
    if graphs["graph_captures"]:
        raise AssertionError(f"fp8_inference: {graphs['graph_captures']} captures after warm-up")
    # every fp8 linear of one uncaptured forward against the plain version on its own x
    checks = []

    def checked(x, qweight, scale, bias=None):
        y = f8.fp8_linear_impl(x, qweight, scale, bias)
        ref = fp8_reference_linear(x, qweight, scale, bias)[0]
        checks.append(dict(N=qweight.shape[0], K=qweight.shape[1],
                           max_abs_err=(y.float().reshape(ref.shape) - ref.float()).abs().max().item(),
                           err_over_bound=fp8_inference_err(x, qweight, scale, bias, y)))
        return y

    impl = torchex.ex.implmap["fp8.linear"]
    torchex.ex.implmap["fp8.linear"] = (checked, None)
    try:
        with torch.no_grad():
            tt.jit(models["fp8"])(idx)
    finally:
        torchex.ex.implmap["fp8.linear"] = impl
    torch.cuda.synchronize()
    worst = max(checks, key=lambda c: c["err_over_bound"])
    sweep = fp8_mma_sweep(dev)
    fp8_bytes = weight_bytes(models["fp8"])
    out = dict(model=cfg.name, n_layer=cfg.n_layer, B=B, T=T, dtype="bf16 activations, e4m3 weights",
               built="meta_device, MaterializationTransform onto the card", build_s=build_s,
               meta_build_bytes=meta_bytes, weight_bytes=fp8_bytes, bf16_weight_bytes=bf16_bytes,
               fp8_linears=n_fp8, scaled_mm_calls_per_forward=scaled_mm_calls, runs=runs,
               device_ms={road: [r["device_ms_per_call"] for r in runs if r["road"] == road] for road in progs},
               logits_max_abs_err=checks[-1]["max_abs_err"], logits_err_over_bound=checks[-1]["err_over_bound"],
               worst_linear=worst, linears_checked=len(checks), fp8_vs_bf16_logits_max_rel=rel_bf16,
               mma_err_over_sum_by_K=sweep, fp8_mma_eps=FP8_MMA_EPS,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **graphs)
    emit("fp8_inference", **out)
    if len(checks) != n_fp8 or worst["err_over_bound"] > 1.0:
        raise AssertionError(f"fp8_inference: the fp8 linear parts from the plain version: {worst}")
    if max(sweep.values()) > FP8_MMA_EPS:
        raise AssertionError(f"fp8_inference: _scaled_mm's sums stray past FP8_MMA_EPS: {sweep}")
    del progs, models
    gc.collect()
    torch.cuda.empty_cache()
    return out


EXT_B, EXT_D = 64, 256


def extensions_op():
    """tt.custom_op's swish4 with its vjp (thunder_tpu's TestCustomOp op),
    registered once."""
    import thunder_tpu_torch as tt

    if not hasattr(extensions_op, "op"):
        @tt.custom_op("chip_smoke.swish4", like=lambda x: x)
        def swish4(x):
            return x * torch.sigmoid(4.0 * x)

        @swish4.register_vjp
        def swish4_vjp(x, g):
            s = torch.sigmoid(4.0 * x)
            return g * (s + 4.0 * x * s * (1.0 - s))

        extensions_op.op = swish4
    return extensions_op.op


class ExtensionsNet(torch.nn.Module):
    """A net whose forward uses this slice's breadth: an autocast_ctx region
    (fc1 in bf16), a custom op with a registered vjp, ltorch.einsum on a
    diagonal spec (the EINSUM prim) and a scatter (both differentiated by
    the vjp fallback), a constant subgraph (full, iota, exp) that
    ConstantFolding folds; an MSE loss."""

    def __init__(self, device, seed: int):
        from thunder_tpu_torch import nn

        super().__init__()
        gen = torch.Generator(device=device).manual_seed(seed)
        self.fc1 = nn.Linear(EXT_D, EXT_D, device=device, generator=gen)
        self.fc2 = nn.Linear(EXT_D, EXT_D, device=device, generator=gen)
        n = int(math.isqrt(EXT_D))
        # n distinct columns a row: a scatter whose index repeats within a
        # row writes one of the repeated sources, which one left undefined
        # (torch's CUDA scatter and jax's both say so), so the card and the
        # CPU may keep different ones
        self.register_buffer("cols", torch.rand(EXT_B, EXT_D, device=device, generator=gen).argsort(dim=1)[:, :n])

    def forward(self, x, y):
        from thunder_tpu_torch.core import dtypes, prims
        from thunder_tpu_torch.ops import ltorch
        from thunder_tpu_torch.transforms.autocast import autocast_ctx

        n = int(math.isqrt(EXT_D))
        with autocast_ctx(dtypes.bfloat16):
            h = self.fc1(x)
        h = extensions_op()(ltorch.to(h, dtypes.float32))
        d = ltorch.einsum("bii->bi", ltorch.reshape(h, (x.shape[0], n, n)))
        h = ltorch.scatter(h, 1, self.cols, d)
        c = prims.mul(prims.exp(prims.full((EXT_D,), -0.5, dtype=dtypes.float32)),
                      prims.add(prims.iota(EXT_D, dtype=dtypes.float32), 1.0))
        return ltorch.mse_loss(self.fc2(h * ltorch.true_divide(c, float(EXT_D))), y)


def extensions_plain(params: dict, cols, x, y):
    """ExtensionsNet's loss written out in plain torch over its parameter
    dict: fc1's inputs cast to bf16 as autocast_ctx casts them (the bias
    added after the product, as ltorch.linear adds it), torch.einsum and
    Tensor.scatter (torch autograd differentiates them), the custom op's
    function, the constant computed."""
    F = torch.nn.functional
    n = int(math.isqrt(EXT_D))
    bf = torch.bfloat16
    h = (F.linear(x.to(bf), params["fc1.weight"].to(bf)) + params["fc1.bias"].to(bf)).float()
    h = h * torch.sigmoid(4.0 * h)
    d = torch.einsum("bii->bi", h.reshape(x.shape[0], n, n))
    h = h.scatter(1, cols, d)
    c = (torch.exp(torch.full((EXT_D,), -0.5, device=x.device))
         * (torch.arange(EXT_D, dtype=torch.float32, device=x.device) + 1.0))
    return F.mse_loss(F.linear(h * (c / float(EXT_D)), params["fc2.weight"], params["fc2.bias"]), y)


def extensions_step1_grads(tt, net, batch) -> tuple[dict, dict]:
    """(the port's, the plain version's) step-1 gradients by name on net's
    device: the port's from a TrainStep run op by op (GradRecorder reads
    them), the plain version's from torch autograd on the same weights."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.constant_folding import ConstantFolding
    from thunder_tpu_torch.transforms.prune_prologue_checks import PrunePrologueChecks

    params = {k: p.detach().clone().requires_grad_() for k, p in net.named_parameters()}
    plain = dict(zip(params, torch.autograd.grad(extensions_plain(params, net.cols, *batch),
                                                 list(params.values()))))
    rec = GradRecorder(optim.AdamW(lr=TRAIN_LR))
    step = TrainStep(tt.jit(net, transforms=[ConstantFolding(), PrunePrologueChecks()]), rec, cuda_graphs=False)
    step(*batch)
    return rec.steps[0], plain


def grads_rel(got: dict, want: dict) -> dict:
    """|got - want| / |want| by tensor (2-norms)."""
    if got.keys() != want.keys():
        raise AssertionError(f"gradients for {sorted(got)}, want {sorted(want)}")
    return {k: ((got[k] - want[k]).norm() / want[k].norm().clamp(min=1e-30)).item() for k in want}


def extensions(tt, cudaex, seed) -> dict:
    """ExtensionsNet through tt.jit(..., transforms=[ConstantFolding(),
    PrunePrologueChecks()]): its forward as a captured jit program (the
    constant folded, no prologue check, the autocast casts, the custom op
    claimed by its executor), bit-equal to the op-by-op program; then
    differentiated by a captured TrainStep (the backward holds
    torch.vjp_fallback for the einsum and the scatter, and the custom op's
    vjp), 3 AdamW steps bit-equal to op by op (captured_against_op_by_op)
    and their losses within EXT_LOSS_RTOL of the same steps on the CPU;
    its step-1 gradients within EXT_GRAD_RTOL of the CPU's and of
    extensions_plain's by torch autograd on the card."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.core.devices import resolve_device
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.constant_folding import ConstantFolding
    from thunder_tpu_torch.transforms.prune_prologue_checks import PrunePrologueChecks

    dev = resolve_device(None)
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed)
    batches = [tuple(torch.from_numpy(rng.randn(EXT_B, EXT_D).astype(np.float32)) for _ in range(2))
               for _ in range(3)]
    start = {k: v.cpu() for k, v in ExtensionsNet(dev, seed).state_dict().items()}

    def net(device):
        m = ExtensionsNet(device, seed)
        m.load_state_dict({k: v.to(device) for k, v in start.items()})
        return m

    def transforms():
        return [ConstantFolding(), PrunePrologueChecks()]

    # the forward as a captured jit program against op by op
    outs = {}
    for graphs in (False, True):
        fwd = tt.jit(net(dev), transforms=transforms(), cuda_graphs=graphs)
        x, y = (t.to(dev) for t in batches[0])
        with torch.no_grad():
            outs[graphs] = [fwd(x, y).clone() for _ in range(3)]
        stats = graph_stats(tt, [fwd])
    if stats["graph_replays"] < 1 or not all(torch.equal(a, b) for a, b in zip(outs[True], outs[False])):
        raise AssertionError(f"extensions: the captured forward is not the op-by-op one: {outs}, {stats}")
    acquired, folded = tt.last_traces(fwd)[0], tt.last_traces(fwd)[1]
    exec_ids = [b.sym.id for b in tt.last_traces(fwd)[-1].bound_symbols]
    pro = tt.last_prologue_traces(fwd)[-1]
    claims = dict(
        folded=sum(b.sym.id == PrimIDs.EXP for b in acquired.bound_symbols) == 1
        and not any(b.sym.id == PrimIDs.EXP for b in folded.bound_symbols)
        and PrimIDs.TENSOR_CONSTANT in exec_ids,
        prologue_checks=sum(b.sym.id == PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA for b in pro.bound_symbols),
        bf16_casts=sum(b.sym.id == PrimIDs.CONVERT_ELEMENT_TYPE and str(b.args[1]) == "dtypes.bfloat16"
                       for b in tt.last_traces(fwd)[-1].bound_symbols),
        custom_op=[b.impl is extensions_op().fn for b in tt.last_traces(fwd)[-1].bound_symbols
                   if b.sym.id == "chip_smoke.swish4"] == [True],
        einsum_prim=PrimIDs.EINSUM in exec_ids)
    if not (claims["folded"] and claims["prologue_checks"] == 0 and claims["bf16_casts"] >= 2
            and claims["custom_op"] and claims["einsum_prim"]):
        raise AssertionError(f"extensions: the forward program lacks a part: {claims}")

    # differentiated: a captured TrainStep against op by op, and against the CPU
    def make(graphs, device=dev):
        model = net(device)
        return TrainStep(tt.jit(model, transforms=transforms()), optim.AdamW(lr=TRAIN_LR),
                         cuda_graphs=graphs), model

    card_batches = [tuple(t.to(dev) for t in b) for b in batches]
    captured = captured_against_op_by_op(tt, "extensions", make, card_batches, (cudaex.adamw_update,))
    step, model = make(False)
    card_losses = [float(step(*b)) for b in card_batches]
    bwd = tt.last_backward_traces(step)[-1].bound_symbols
    fallback = sorted(str(b.args[0]) for b in bwd if b.sym.id == "torch.vjp_fallback")
    custom_vjp = sum(str(b.sym.id).startswith("chip_smoke.swish4_vjp") for b in bwd)
    cpu_step, cpu_model = make(False, torch.device("cpu"))
    cpu_losses = [float(cpu_step(*b)) for b in batches]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    del step, model, cpu_step, cpu_model
    card_grads, plain_grads = extensions_step1_grads(tt, net(dev), card_batches[0])
    cpu_grads, _ = extensions_step1_grads(tt, net(torch.device("cpu")), batches[0])
    against_cpu = grads_rel({k: g.cpu() for k, g in card_grads.items()}, cpu_grads)
    against_plain = grads_rel(card_grads, plain_grads)
    out = dict(B=EXT_B, D=EXT_D, forward=claims, forward_graph_replays=stats["graph_replays"],
               backward_vjp_fallback=fallback, backward_custom_vjp=custom_vjp, captured=captured,
               losses=card_losses, cpu_losses=cpu_losses, cpu_loss_max_rel=loss_rel,
               cpu_loss_rtol=EXT_LOSS_RTOL, step1_grad_rel_cpu=against_cpu,
               step1_grad_rel_plain=against_plain, grad_rtol=EXT_GRAD_RTOL,
               seconds=time.perf_counter() - t0)
    emit("extensions", **out)
    if fallback != ["PrimIDs.EINSUM", "PrimIDs.SCATTER"] or custom_vjp != 1:
        raise AssertionError(f"extensions: the backward lacks a rule: fallback {fallback}, custom vjp {custom_vjp}")
    if (not loss_rel <= EXT_LOSS_RTOL or not max(against_cpu.values()) <= EXT_GRAD_RTOL
            or not max(against_plain.values()) <= EXT_GRAD_RTOL):
        raise AssertionError(f"extensions: the card parts from the CPU or the plain version: losses {loss_rel}, "
                             f"gradients {against_cpu}, {against_plain}")
    return out


# The card against the CPU and the plain version on ExtensionsNet: f32 but
# for fc1's bf16 region (its product, and its backward's products, rounded
# to bf16), where cuBLAS and the CPU sum in other orders and a value on a
# rounding boundary lands one bf16 ulp (at most 2^-7 of it) apart. Such
# flips move the MSE loss by far less than EXT_LOSS_RTOL of itself; if every
# rounded value of the region landed apart, a gradient would move by about
# 2^-7 of its norm, so each tensor's step-1 gradient is held to
# EXT_GRAD_RTOL = 2^-7 of its norm. The fallback's and the custom vjp's
# gradients are f32; the einsum's cotangent scaled by 1.1 in the fallback
# moves fc1's gradients past it.
EXT_LOSS_RTOL = 1e-3
EXT_GRAD_RTOL = 2.0 ** -7


# ---------------------------------------------------------------------------
# phases 37-38: resilient training
# ---------------------------------------------------------------------------

RESILIENT_PLAN = "nan_loss@5,transient@9*2,preempt@14"
RESILIENT_TOKENS = 16 * 2 ** 20  # uint16 tokens in the phase's token file
RESILIENT_STEPS = 6  # steps after the preemption: the resumed run and each uninterrupted continuation
RESILIENT_CONTINUATIONS = 3  # uninterrupted continuations from the saved state, for their spread
RESILIENT_PAIR_STEPS = 8
LOADER_RATE_BATCHES = 64
KILL_RESUME_STEPS = 12
# what each resilient_kill_resume process runs, from the checkout's root
KILL_RESUME_CHILD = ("import sys, chip_smoke; "
                     "chip_smoke.kill_resume_child(sys.argv[1], sys.argv[2], int(sys.argv[3]))")


class ScaledLoss(torch.nn.Module):
    """The LM loss times a float input, ``scale`` (ones): the batch's float
    leaf, which the ``nan_loss`` fault poisons (a token batch has none)."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, idx, tgt, scale):
        from thunder_tpu_torch.ops import ltorch

        return ltorch.mul(self.lm(idx, tgt), scale)


def scratch_dir():
    """A temporary directory under the checkout's build/ (gitignored), removed
    by the caller."""
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_tmp"
    root.mkdir(parents=True, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=root)


def device_state(step) -> list:
    """Device copies of every tensor a step writes: parameters, buffers and
    the optimizer's state (flatten order)."""
    from thunder_tpu_torch.parallel.checkpoint import flatten

    return [t.detach().clone() for t in (*step.tmodule.get_parameters().values(),
                                         *step.tmodule.get_buffers().values(), *flatten(step.opt_state))]


def live_tensors(step) -> list:
    from thunder_tpu_torch.parallel.checkpoint import flatten

    return [t.detach() for t in (*step.tmodule.get_parameters().values(),
                                 *step.tmodule.get_buffers().values(), *flatten(step.opt_state))]


@torch.no_grad()
def write_state_(step, saved: list) -> None:
    """``device_state``'s copies written back in place (the graph's tensors)."""
    for t, s in zip(live_tensors(step), saved):
        t.copy_(s)


def same_bits(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def loader_rate(loader_cls, path, B, T, seed) -> dict:
    """The native loader's batches/s on the host alone (next_batch, after one
    warm batch)."""
    loader = loader_cls(path, B, T, seed=seed)
    loader.next_batch()
    t0 = time.perf_counter()
    for _ in range(LOADER_RATE_BATCHES):
        loader.next_batch()
    s = time.perf_counter() - t0
    loader.close()
    return dict(batches_per_s=LOADER_RATE_BATCHES / s, tokens_per_s=LOADER_RATE_BATCHES * B * T / s)


def resilient_train(tt, cudaex, seed) -> dict:
    """Phase 33 (see the module docstring)."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.data import TokenLoader, write_token_file
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.robustness import CheckpointManager, GuardPolicy, Preempted, StepGuard, faults
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    from thunder_tpu_torch.core.devices import resolve_device

    B, T = 4, 2048
    cfg = Config.from_name("llama-350m", block_size=T)
    dev = resolve_device(None)
    one = torch.ones((), device=dev)
    counters = (cudaex.flash_rope_attention, cudaex.flash_rope_attention_backward, cudaex.adamw_update)

    def make_step(model_seed, guarded=True, model=None):
        model = model if model is not None else GPTForCausalLM(cfg, torch.float32, seed=model_seed)
        guard = (StepGuard(GuardPolicy(on_nonfinite="skip", check_grad_norm=True, retry_transient=2))
                 if guarded else None)
        return TrainStep(tt.jit(ScaledLoss(model), transforms=[AutocastTransform()]), optim.AdamW(lr=TRAIN_LR),
                         guard=guard), model

    tmp = scratch_dir()
    try:
        import shutil

        tokens = f"{tmp.name}/tokens.bin"
        write_token_file(tokens, np.random.RandomState(seed).randint(0, cfg.vocab_size, RESILIENT_TOKENS))
        ckdir = f"{tmp.name}/ckpts"
        disk_free_gb = shutil.disk_usage(tmp.name).free / 1e9
        rate = loader_rate(TokenLoader, tokens, B, T, seed)
        loader = TokenLoader(tokens, B, T, seed=seed)
        if loader._lib is None or not loader.is_native:
            raise AssertionError("resilient_train: the native TokenLoader did not build")
        batches = loader.prefetched(size=2)
        step, model = make_step(seed)
        mgr = CheckpointManager(ckdir, every_n_steps=8, keep=2, async_save=True, loader=batches).attach(step)
        guard = step.guard

        # -- the main path: 15 guarded steps under the fault plan, preempted
        faults.configure(RESILIENT_PLAN)
        for c in counters:
            c.launches = 0
        walls, losses, skip_ok, retries_at_9 = [], [], None, None
        captures_after_first = None
        try:
            for i in range(40):
                x, y = next(batches)
                pre = device_state(step) if i == 5 else None
                t0 = time.perf_counter()
                try:
                    loss = step(x, y, one)
                finally:
                    walls.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
                if i == 1:
                    captures_after_first = tt.graph_captures(step)
                if pre is not None:
                    skip_ok = same_bits(pre, live_tensors(step))
                    del pre
                if i == 9:
                    retries_at_9 = guard.retries
            raise AssertionError("resilient_train: the preempt fault never fired")
        except Preempted as e:
            preempted = dict(step=e.step, checkpoint=e.checkpoint_path is not None)
        finally:
            faults.clear()
        n_steps = len(walls)
        launches = {c.__name__: c.launches for c in counters}
        graphs = graph_stats(tt, [step])
        mgr.close()
        step._ckpt_manager = None
        saves = [dict(r) for r in mgr.save_log]
        kept = device_state(step)
        cursor = batches.state_dict()
        if not (preempted["step"] == 15 and preempted["checkpoint"] and n_steps == 15):
            raise AssertionError(f"resilient_train: preempted {preempted} after {n_steps} steps")
        if not skip_ok or not math.isnan(losses[5]) or guard.skipped != 1:
            raise AssertionError(f"resilient_train: step 5 not skipped bit-equal (skip_ok {skip_ok}, "
                                 f"loss {losses[5]}, skipped {guard.skipped})")
        if retries_at_9 != 2:
            raise AssertionError(f"resilient_train: {retries_at_9} retries at step 9, want 2")
        if [s["step"] for s in saves] != [8, 15] or not all("write_s" in s for s in saves):
            raise AssertionError(f"resilient_train: saves {saves}")
        if graphs["graph_captures"] != captures_after_first or not graphs["graph_replays"]:
            raise AssertionError(f"resilient_train: graphs {graphs}, captures after step 1 {captures_after_first}")
        # each step (the skipped one too: its AdamW launch reads the flag and writes nothing)
        want = {"flash_rope_attention": cfg.n_layer * n_steps,
                "flash_rope_attention_backward": cfg.n_layer * n_steps, "adamw_update": n_steps}
        if launches != want:
            raise AssertionError(f"resilient_train: launches {launches}, want {want}")
        per_step = {"tt_flash_rope_fwd": launches["flash_rope_attention"] / n_steps,
                    "tt_flash_rope_bwd": launches["flash_rope_attention_backward"] / n_steps,
                    "adamw": launches["adamw_update"] / n_steps}
        finite = [x for i, x in enumerate(losses) if i != 5]
        if not all(math.isfinite(x) for x in finite):
            raise AssertionError(f"resilient_train: losses {losses}")

        # -- uninterrupted continuations from the saved state
        recorded = [tuple(t.clone() for t in next(batches)) for _ in range(RESILIENT_STEPS)]
        batches.close()
        loader.close()
        continuations = []
        for _ in range(RESILIENT_CONTINUATIONS):
            write_state_(step, kept)
            step._step_count = 15
            continuations.append([float(step(x, y, one)) for x, y in recorded])
        del step, model
        gc.collect()
        torch.cuda.empty_cache()

        # -- a fresh step and manager restore the last save
        fresh, fresh_model = make_step(seed + 1)
        loader2 = TokenLoader(tokens, B, T, seed=seed + 7)
        mgr2 = CheckpointManager(ckdir, loader=loader2, preemption=False)
        torch.cuda.synchronize()
        meta = mgr2.restore(fresh)
        torch.cuda.synchronize()
        restore = dict(mgr2.last_restore)
        restore.pop("path")
        restored_bit_equal = same_bits(kept, live_tensors(fresh))
        del kept
        if not restored_bit_equal or meta["step"] != 15 or fresh.step_count != 15 or meta["loader"] != cursor:
            raise AssertionError(f"resilient_train: restore bit-equal {restored_bit_equal}, meta step "
                                 f"{meta['step']}, loader {meta['loader']} vs {cursor}")
        batches2 = loader2.prefetched(size=2)
        resumed, same_batches = [], True
        for x0, y0 in recorded:
            x, y = next(batches2)
            same_batches = same_batches and torch.equal(x, x0) and torch.equal(y, y0)
            resumed.append(float(fresh(x, y, one)))
        if not same_batches:
            raise AssertionError("resilient_train: the restored loader served other batches")
        spread = max(abs(a - b) for i, c in enumerate(continuations) for d in continuations[i + 1:]
                     for a, b in zip(c, d))
        gap = min(max(abs(a - b) for a, b in zip(resumed, c)) for c in continuations)
        floor = 4 * math.ulp(max(abs(x) for x in resumed))
        if not gap <= max(spread, floor):
            raise AssertionError(f"resilient_train: resumed losses {resumed} are {gap} from the nearest "
                                 f"uninterrupted continuation {continuations}, spread {spread}")

        # -- the device's idle share between guarded steps (from the prefetcher)
        prof = profiled(lambda: [fresh(*next(batches2), one) for _ in range(3)])
        busy_ms = sum(r[0] for r in prof["rows"]) / 1e3
        idle_share = 1 - busy_ms / (prof["wall_us"] / 1e3)

        # -- guarded and unguarded ms a step, in turns (a same-call pair, twice)
        x, y = next(batches2)
        batches2.close()
        loader2.close()
        plain, _ = make_step(None, guarded=False, model=fresh_model)
        rounds = []
        for guarded in (False, True, True, False):
            s = fresh if guarded else plain
            for _ in range(2):
                s(x, y, one)
            torch.cuda.synchronize()
            calls = []
            t0 = time.perf_counter()
            for _ in range(RESILIENT_PAIR_STEPS):
                c0 = time.perf_counter()
                s(x, y, one)
                calls.append(time.perf_counter() - c0)
            torch.cuda.synchronize()
            # host_ms_per_call: the call's own wall time, without a sync: the
            # host's work a step unguarded, the whole step guarded (its flag read)
            rounds.append(dict(guarded=guarded, ms_per_step=(time.perf_counter() - t0) / RESILIENT_PAIR_STEPS * 1e3,
                               host_ms_per_call=sum(calls) / len(calls) * 1e3))
        pair_graphs = graph_stats(tt, [fresh, plain])
        guarded_ms = [r["ms_per_step"] for r in rounds if r["guarded"]]
        plain_ms = [r["ms_per_step"] for r in rounds if not r["guarded"]]
        del plain, fresh, fresh_model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        tmp.cleanup()
    # call 7 saves (the step counter reaches 8), 5 is skipped, 9 retried, 14
    # preempted; 0 and 1 compile and capture
    normal = [w for i, w in enumerate(walls) if i not in (0, 1, 5, 7, 9, 14)]
    median = sorted(normal)[len(normal) // 2]
    out = dict(model=cfg.name, B=B, T=T, dtype="bf16 autocast, f32 master", plan=RESILIENT_PLAN,
               steps=n_steps, losses=losses, preempted=preempted, skipped_step_bit_equal=skip_ok,
               retries_at_step_9=retries_at_9, launches=launches, launches_per_step=per_step, **graphs,
               captures_after_first_step=captures_after_first, step_wall_ms=walls, median_step_ms=median,
               save_step_ms=walls[7], save_stall_ms=walls[7] - median,
               writer_overlap_ms=walls[8:14], 
               saves=[{k: v for k, v in s.items() if k != "path"} for s in saves],
               write_gb=saves[0]["bytes"] / 1e9, write_s=saves[0]["write_s"],
               preempt_save_write_s=saves[1]["write_s"], restore_s=restore["seconds"], restore=restore,
               restored_bit_equal=restored_bit_equal, resumed_losses=resumed, continuations=continuations,
               continuation_spread=spread, resumed_gap=gap, loader=rate, loader_native=True,
               device_busy_ms=busy_ms, device_idle_share=idle_share, clock_ratio=prof["clock_ratio"],
               guarded_ms_per_step=guarded_ms, unguarded_ms_per_step=plain_ms, pair_rounds=rounds,
               pair_graphs=pair_graphs, disk_free_gb=disk_free_gb,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("resilient_train", **out)
    return out


def kill_resume_child(workdir: str, mode: str, seed: int) -> None:
    """One process of resilient_kill_resume: llama-350m cut to 2 layers, f32,
    B=1, T=512, AdamW, captured, a native TokenLoader. ``full`` runs
    KILL_RESUME_STEPS steps; ``die`` saves every 4 steps (TT_FAULT=die@7 in
    its environment kills it in step 7); ``resume`` restores the newest save
    (loader cursor included) and runs to KILL_RESUME_STEPS. Prints a JSON
    line a step: {"step": i, "loss": x}."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.core.devices import resolve_device
    from thunder_tpu_torch.data import TokenLoader
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM
    from thunder_tpu_torch.robustness import CheckpointManager
    from thunder_tpu_torch.training import TrainStep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.from_name("llama-350m", block_size=512, n_layer=2)
    step = TrainStep(tt.jit(GPTForCausalLM(cfg, torch.float32, seed=seed)), optim.AdamW(lr=TRAIN_LR))
    loader = TokenLoader(f"{workdir}/tokens.bin", 1, 512, seed=seed)
    if not loader.is_native:
        raise AssertionError("kill_resume_child: the native TokenLoader did not build")
    if mode != "full":
        mgr = CheckpointManager(f"{workdir}/ckpts", every_n_steps=4, keep=3, async_save=False, loader=loader,
                                preemption=False).attach(step)
        if mode == "resume":
            mgr.restore(step)
    while step.step_count < KILL_RESUME_STEPS:
        x, y = loader.next_batch()
        i = step.step_count
        dev = resolve_device(None)
        loss = float(step(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)))
        print(json.dumps({"step": i, "loss": loss}), flush=True)
    loader.close()


def resilient_kill_resume(seed) -> dict:
    """Phase 34 (see the module docstring)."""
    import os
    from pathlib import Path

    from thunder_tpu_torch.data import write_token_file
    from thunder_tpu_torch.models.litgpt import Config
    from thunder_tpu_torch.robustness import faults, list_steps

    here = str(Path(__file__).resolve().parent)
    vocab = Config.from_name("llama-350m").vocab_size
    tmp = scratch_dir()
    try:
        write_token_file(f"{tmp.name}/tokens.bin", np.random.RandomState(seed).randint(0, vocab, 2 ** 20))

        def child(mode, env_extra=None):
            env = {k: v for k, v in os.environ.items() if k != "TT_FAULT"}
            env.update(env_extra or {})
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-c", KILL_RESUME_CHILD, tmp.name, mode, str(seed)],
                                 cwd=here, env=env, capture_output=True, text=True, timeout=300)
            losses = {}
            for ln in run.stdout.splitlines():
                if ln.startswith("{"):
                    rec = json.loads(ln)
                    losses[rec["step"]] = rec["loss"]
            return run.returncode, losses, time.perf_counter() - t0, run.stderr[-2000:]

        rc_full, full, s_full, err = child("full")
        if rc_full != 0 or sorted(full) != list(range(KILL_RESUME_STEPS)):
            raise AssertionError(f"resilient_kill_resume: the uninterrupted run: rc {rc_full}, {full}, {err}")
        rc_die, died, s_die, err = child("die", {"TT_FAULT": "die@7"})
        saved = [s for s, _ in list_steps(f"{tmp.name}/ckpts")]
        if rc_die != faults.DIE_EXIT_CODE or sorted(died) != list(range(7)) or saved != [4]:
            raise AssertionError(f"resilient_kill_resume: the killed run: rc {rc_die}, steps {sorted(died)}, "
                                 f"saves {saved}, {err}")
        rc_res, resumed, s_res, err = child("resume")
        if rc_res != 0 or sorted(resumed) != list(range(4, KILL_RESUME_STEPS)):
            raise AssertionError(f"resilient_kill_resume: the resumed run: rc {rc_res}, {resumed}, {err}")
    finally:
        tmp.cleanup()
    bit_equal = all(resumed[i] == full[i] for i in resumed) and all(died[i] == full[i] for i in died)
    out = dict(model="llama-350m at 2 layers", dtype="float32", B=1, T=512, steps=KILL_RESUME_STEPS,
               fault="die@7", die_exit_code=rc_die, saves=saved, full_losses=[full[i] for i in sorted(full)],
               resumed_losses=[resumed[i] for i in sorted(resumed)], bit_equal=bit_equal,
               seconds={"full": s_full, "die": s_die, "resume": s_res})
    emit("resilient_kill_resume", **out)
    if not bit_equal:
        raise AssertionError(f"resilient_kill_resume: resumed losses {resumed} are not the uninterrupted {full}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import cudaex
    from thunder_tpu_torch.models.litgpt import Config
    from thunder_tpu_torch.parallel import multiprocess

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    lib = cudaex.build()
    cudaex._library()
    log = (lib.parent / "build.log").read_text()
    emit("build", seconds=time.perf_counter() - t0, library=lib.name,
         ptxas=[ln.strip() for ln in log.splitlines() if "Used" in ln or "Compiling" in ln])

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rms = check_rms(cudaex, dev, gen)
    paged = check_paged(cudaex, dev, gen)
    chunk = check_chunk(cudaex, dev, gen)
    flash_fwd, flash_bwd = check_flash(cudaex, dev, gen)
    plain_fwd, plain_bwd = check_flash(cudaex, dev, gen, rope=False)
    check_flash_ragged(cudaex, dev, gen)
    xent = check_xent(cudaex, dev, gen)
    int8 = check_quant(cudaex, dev, gen, "int8")
    nf4 = check_quant(cudaex, dev, gen, "nf4")
    fp8 = check_fp8(cudaex, dev, gen)
    grouped = check_grouped(cudaex, dev, gen)
    adamw = check_adamw(cudaex, dev, gen)
    check_sampler(dev)

    cfg = Config.from_name("Llama-3-1B")
    rng = np.random.RandomState(args.seed)
    prompts = make_prompts(rng, 16, 128, 1024, cfg.vocab_size)
    # NF4 first: after the serving phases below, the same phase measured a
    # ~3x slower decode step (PERF.md, open questions), for a reason not
    # yet understood
    nf4_run = nf4_inference(tt, cudaex, cfg, args.seed)
    nf4_agreement(tt, cudaex, cfg, args.seed)
    served, _ = serve(tt, cudaex, cfg, prompts, args.seed)
    agreement(cfg, prompts[:4], args.seed)
    torch.cuda.empty_cache()
    quant_served = quant_serve(tt, cudaex, cfg, prompts, args.seed, served)
    quant_agreement(tt, cudaex, cfg, prompts[:4], args.seed)
    fleet_wave = fleet(tt, cudaex, cfg, args.seed)
    fleet_agreement(cfg, args.seed)
    quant_fleet_wave = quant_fleet(tt, cudaex, cfg, args.seed, fleet_wave)
    quant_fleet_agreement(cfg, args.seed)
    moe_fleet_wave = moe_fleet(tt, cudaex, cfg, args.seed, fleet_wave)
    slo_serve(tt, cudaex, cfg, args.seed)
    trained, _ = train(tt, cudaex, args.seed)
    train_agreement(tt, cudaex, args.seed)
    fp8_trained = fp8_train(tt, cudaex, args.seed, trained)
    fp8_train_agreement(tt, cudaex, args.seed)
    lora_train(tt, cudaex, args.seed)
    nano, nano_model = nano_train(tt, cudaex, args.seed)
    nano_evaluated = nano_eval(tt, cudaex, nano_model, args.seed)
    del nano_model
    nano_train_agreement(tt, cudaex, args.seed)
    remat_train(tt, cudaex, args.seed)
    moe_served = moe_serve(tt, cudaex, cfg, prompts, args.seed, served)
    moe_agreement(cfg, prompts[:4], args.seed)
    moe_trained = moe_train(tt, cudaex, args.seed)
    moe_train_agreement(tt, cudaex, args.seed)
    ring_fwd, ring_bwd = check_ring(cudaex, dev, gen)
    # one process group for the CP and the sharded phases, destroyed after them
    multiprocess.initialize(f"tcp://localhost:{multiprocess.free_port()}", 1, 0)
    try:
        cp_trained, _ = cp_train(tt, cudaex, args.seed)
        cp_train_agreement(tt, cudaex, args.seed)
        fsdp_trained = fsdp_train(tt, cudaex, args.seed)
        sharded_agreement(tt, cudaex, args.seed)
        ep = ep_moe(tt, cudaex, args.seed)
    finally:
        multiprocess.destroy()
    vit, vit_model = vit_train(tt, cudaex, args.seed)
    vit_eval(tt, cudaex, vit_model, args.seed)
    del vit_model
    vit_train_agreement(tt, cudaex, args.seed)
    resnet_train(tt, cudaex, args.seed)
    resnet_train_agreement(tt, cudaex, args.seed)
    front_eval = frontend_eval(tt, cudaex, args.seed)
    front_train = frontend_train(tt, cudaex, args.seed, trained)
    frontend_train_agreement(tt, cudaex, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    quant_trained = quant_train(tt, cudaex, args.seed)
    quant_train_agreement(tt, cudaex, args.seed)
    fp8_inference(tt, cudaex, args.seed)
    extensions(tt, cudaex, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    resilient = resilient_train(tt, cudaex, args.seed)
    torch.cuda.empty_cache()
    resilient_kill_resume(args.seed)
    on_resilient = {"flash_rope_fwd": resilient["launches_per_step"]["tt_flash_rope_fwd"],
                    "flash_rope_bwd": resilient["launches_per_step"]["tt_flash_rope_bwd"],
                    "adamw": resilient["launches_per_step"]["adamw"]}
    front = {"rms_norm": front_eval["launches_per_call"]["rms_norm"],
             "flash_fwd": front_eval["launches_per_call"]["flash_attention"],
             "flash_bwd": front_train["launches_per_step"]["flash_attention_backward"],
             "cross_entropy": front_eval["launches_per_call"]["cross_entropy"]}

    kernels = []
    for name, res, src, rep, launches in (
            ("rms_norm", rms, "thunder_tpu_torch/csrc/rms_norm.cu",
             "thunder_tpu/executors/pallasex.py:1245", served["launches"]["rms_norm"]),
            ("paged_attention", paged, "thunder_tpu_torch/csrc/paged_attention.cu",
             "thunder_tpu/executors/pallasex.py:1738", served["launches"]["paged_attention"]),
            ("paged_chunk_attention", chunk, "thunder_tpu_torch/csrc/paged_chunk_attention.cu",
             "thunder_tpu/executors/pallasex.py:1882",
             fleet_wave["launches"]["paged_chunk_attention"]),
            ("flash_rope_fwd", flash_fwd, "thunder_tpu_torch/csrc/flash_fwd_sm90.cu",
             "thunder_tpu/executors/pallasex.py:611", trained["launches"]["flash_rope_fwd"]),
            ("flash_rope_bwd", flash_bwd, "thunder_tpu_torch/csrc/flash_bwd_sm90.cu",
             "thunder_tpu/executors/pallasex.py:850", trained["launches"]["flash_rope_bwd"]),
            ("int8_linear", int8, "thunder_tpu_torch/csrc/int8_linear.cu",
             "thunder_tpu/executors/pallasex.py:1318", quant_served["int8_linear_launches"]),
            ("nf4_linear", nf4, "thunder_tpu_torch/csrc/nf4_linear.cu",
             "thunder_tpu/executors/pallasex.py:1605", nf4_run["nf4_linear_launches"]),
            ("fp8_linear", fp8, "thunder_tpu_torch/csrc/fp8_linear.cu",
             "thunder_tpu/executors/pallasex.py:1447", fp8_trained["launches"]["fp8_linear"]),
            ("flash_fwd", plain_fwd, "thunder_tpu_torch/csrc/flash_fwd_sm90.cu",
             "thunder_tpu/executors/pallasex.py:134", nano["launches"]["flash_fwd"]),
            ("flash_bwd", plain_bwd, "thunder_tpu_torch/csrc/flash_bwd_sm90.cu",
             "thunder_tpu/executors/pallasex.py:423", nano["launches"]["flash_bwd"]),
            ("cross_entropy", xent, "thunder_tpu_torch/csrc/cross_entropy.cu",
             "thunder_tpu/executors/pallasex.py:1179", nano_evaluated["launches"]["cross_entropy"]),
            ("grouped_mlp", grouped, "thunder_tpu_torch/csrc/grouped_mlp.cu",
             "thunder_tpu/executors/pallasex.py:2004", moe_served["launches"]["grouped_mlp"]),
            ("ring_flash_fwd", ring_fwd, "thunder_tpu_torch/csrc/flash_fwd_sm90.cu",
             "thunder_tpu/executors/pallasex.py:2205", cp_trained["launches"]["ring_flash_fwd"]),
            ("ring_flash_bwd", ring_bwd, "thunder_tpu_torch/csrc/flash_bwd_sm90.cu",
             "thunder_tpu/executors/pallasex.py:2326", cp_trained["launches"]["ring_flash_bwd"]),
            ("adamw", adamw, "thunder_tpu_torch/csrc/adamw.cu",
             "thunder_tpu/optim.py:83 (inside the step's jax.jit; no Pallas kernel)",
             moe_trained["launches"]["adamw"]),
            ("flash_fwd@vit-b16", dict(plain_fwd["rows"]["vit-b16"], shape="B=64 H=12 T=197 D=64 full bf16"),
             "thunder_tpu_torch/csrc/flash_fwd_sm90.cu", "thunder_tpu/executors/pallasex.py:134",
             vit["launches"]["flash_attention"]),
            ("flash_bwd@vit-b16", dict(plain_bwd["rows"]["vit-b16"], shape="B=64 H=12 T=197 D=64 full bf16"),
             "thunder_tpu_torch/csrc/flash_bwd_sm90.cu", "thunder_tpu/executors/pallasex.py:423",
             vit["launches"]["flash_attention_backward"])):
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches, "max_abs_err": res["max_abs_err"],
                        "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                        "bound_by": res["bound_by"], "library_ms": res["library_ms"],
                        "shape": res["shape"]})
        if name in front:
            # launches a call (frontend_eval) or a step (frontend_train) on the torch frontend's path
            kernels[-1]["frontend_launches"] = front[name]
        if name in on_resilient:
            # launches a step on resilient_train's guarded path
            kernels[-1]["resilient_launches_per_step"] = on_resilient[name]
        if name in quant_trained["launches_per_step"]:
            # launches a step on quant_train's path (frozen int8/NF4 linears)
            kernels[-1]["quant_train_launches_per_step"] = quant_trained["launches_per_step"][name]
        if name in quant_trained["launches_by_route"]:
            # quant_train's f32 x: the split route's launches and its time at that shape
            kernels[-1]["quant_train_split_launches_per_step"] = (quant_trained["launches_by_route"][name]["split"]
                                                                  / quant_trained["steps"])
            f32 = res["timing_f32"][QUANT_F32_TIMED[name[:-len("_linear")]][0]]
            kernels[-1]["f32_split"] = {k: f32[k] for k in ("M", "N", "K", "ms", "plain_ms", "bound_ms", "bound_by",
                                                              "f32_fma_bound_ms")}
        if name in ("flash_rope_fwd", "flash_rope_bwd", "adamw"):
            # launches in 10 fsdp_train steps (AdamW over the rank's shards)
            kernels[-1]["fsdp_train_launches"] = fsdp_trained["launches"][name]
        if name == "adamw":
            kernels[-1]["skip_flag"] = res["skip_flag"]
        if name == "int8_linear":
            # launches by route in the int8 fleet waves: chunks (M <= 256) and verify (M = 24) on wgmma
            kernels[-1]["quant_fleet_launches_by_route"] = quant_fleet_wave["int8_linear_routes"]
            kernels[-1]["quant_fleet_cold_launches_by_route"] = \
                quant_fleet_wave["cold_prefix_cache"]["int8_linear_routes"]
            kernels[-1]["moe_fleet_launches_by_route"] = moe_fleet_wave["int8_linear_routes"]
        if name == "grouped_mlp":
            # launches in the int8 MoE fleet wave: n_layer a target prefill, chunk and verify call
            kernels[-1]["moe_fleet_launches"] = moe_fleet_wave["grouped_mlp_launches"]
            kernels[-1]["moe_fleet_cold_launches"] = moe_fleet_wave["cold_prefix_cache"]["grouped_mlp_launches"]
            # launches a moe_ep_forward call (ep=1, N=4,096 tokens, bins of N·K rows)
            kernels[-1]["ep_moe_launches_per_call"] = ep["grouped_mlp_launches_per_call"]
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
