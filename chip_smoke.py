#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env     torch, CUDA and nvcc versions; the card's name and power limit.
2. build   nvcc builds the two kernel libraries for sm_90a, one nvcc
           each, started together: tf_operator_tpu_torch/csrc/
           flash_attention.cu (the wgmma kernels: bf16 and fp16, all three
           at head_dim 128, 256, 384 and 512) and
           csrc/flash_attention_f32tc.cu (the f32 forward, dQ and dK/dV on
           tensor cores, 3xTF32, head_dim 128-512); seconds,
           library paths, and per kernel variant ("flash_fwd[bf16,256]")
           the registers, stack and spill bytes that ptxas reports.
3. kernels each flash-attention kernel (forward, dQ, dK/dV) against its
           plain PyTorch version on the card (KERNEL_CASES; B=1, H=32,
           Hkv=8, GQA 4:1): in bf16 at head_dim 128 the training step's
           shapes (S=2048, causal), a non-causal case, a q_seq != k_seq
           case with q_offset > 0, an odd number of 64-row tiles (S=1088)
           and q_seq = k_seq / 2 with q_offset 0 (half the k tiles seen by
           no row: their dK/dV must be exact zeros); ragged lengths
           (S=2000 causal, Sq=72 / Sk=200 at q_offset 128, S=8); fp16 at
           S=2048 and 200; f32 (the 3xTF32 forward, dQ and dK/dV) at
           128-512 and bf16/fp16 at 384 and 512 (the wgmma forward, dQ and
           dK/dV by column halves) at S=2048 causal, and f32 128 and 512,
           fp16 384 and bf16 512 at S=200 not; the wgmma kernels' edges
           at 384-512 (bf16 512 and 384 at S=2000, bf16 512 at
           Sq=1024 / Sk=2048 with q_offset 1024, bf16 512 and 384 with
           half the k tiles unseen, fp16 512 Sq=72 / Sk=200 at q_offset
           128) and bf16 512 S=2048 causal at d512_train's heads (H=8,
           Hkv=2), timed; and head_dim 256 (the wgmma
           kernels) in bf16 and fp16 at S=2048 causal, bf16 at S=2000,
           Sq=1024 / Sk=2048 at q_offset 1024 and at 0 (half the k tiles
           unseen), S=200 not causal, and fp16 Sq=72 / Sk=200 at q_offset
           128; and bf16 at head_dim 256, S=2048 causal, at d256_train's
           heads (H=16, Hkv=4), the shapes that phase launches them at.
           Each output within a limit scaled to its own largest value (REL
           below; f32 F32_REL); the check must also reject perturbed plain
           outputs (zeros, δ dropped, the first or last k or q tile
           skipped, one GQA member left out of dK/dV) and, wherever they
           apply, the domain's edge cases (the partial last k tile
           dropped, rows past the last full q tile left as zeros, scores
           from the first 128 of head_dim, head_dim columns 128-255 left
           as zeros or copied from columns 0-127, at head_dim 384-512 the
           out's, dQ's and dK/dV's last 128 columns left as zeros or copied
           from columns 0-127, each of the four on its own, and out's
           second column half summed without each q tile's last visible k
           tile (a column-half warpgroup that leaves its loop early),
           through out on its own, f32 products in
           TF32, and in f32 P rounded to TF32 before O, P^T and dS^T before
           dV and dK and dS before dQ, as a 3xTF32 kernel that split only
           the loaded operands would give). In f32 the kernels' out, lse,
           dQ, dK and dV are also held to a float64 version at the same
           limits (f64_ratio), and that check must reject both TF32
           perturbations through each output on its own: the plain version
           sums its long products in f32 too, so against it alone a right
           kernel's margin is partly the plain version's own rounding (its
           f64_ratio is reported).
           Kernel,
           plain and library (scaled_dot_product_attention, a yardstick
           the port never calls) device times from CUDA events around
           calls queued behind a sleep kernel (``cuda_ms``), and beside
           them the same calls launched by the host as it goes, at B=1,
           S=2048, H=32, Hkv=8, causal for every timed case above (the
           3xTF32 kernels 10 calls, the wgmma ones 20);
           the bound takes 989 TFLOP/s for bf16/fp16 and three TF32
           products at 494.7 for the 3xTF32 kernels (their f32 FMA bound,
           67 TFLOP/s, beside), against 3.35 TB/s, and counts no redundant
           work (the D=384-512 kernels' two column halves each reduce S,
           and the dQ's and dK/dV's dP too, over all of head_dim: the
           forward 1.5x, the dQ 1.67x, the dK/dV 1.5x).
3a. fp16_model  the model phase's logits check in fp16 at S=2048
           (phase 4's rule; forward only): launches flash_fwd 4.
3b. ragged_train  the main path at S=2000 (no multiple of the 64-row
           tile), bf16: the logits through the kernels against the
           reference attention (phase 4's rule), then 3 Trainer steps
           launching fwd 8 / dQ 4 / dK/dV 4 each and calling the reference
           attention never (counted); tokens/s and peak memory beside the
           same 3 steps with attention_impl="xla", what the port ran there
           before its kernels took ragged lengths; losses finite and
           falling.
3c. f32_train  the main path with LlamaConfig.dtype = f32 at S=2048: the
           logits within relative L2 F32_LOGITS_REL of the reference
           attention's on the same f32 weights, then 2 steps launching
           flash_fwd_f32tc 8, flash_dq_f32tc 4 and flash_dkv_f32tc 4 each,
           no reference attention; the step time.
3d. d256_train  the main path with the attention at head_dim 256: the
           same model with n_heads 16, n_kv_heads 4, head_dim 256 (the
           projections keep llama_3_8b's shapes), bf16, S=2048: the logits
           through the kernels against the reference attention (phase 4's
           rule), then 3 Trainer steps launching flash_fwd_d256 8,
           flash_dq_d256 4 and flash_dkv_d256 4 each and the reference
           attention never, losses finite and falling; ms a step, tokens/s
           and peak memory beside the same 3 steps with
           attention_impl="xla".
3e. d512_train  the same at head_dim 512: n_heads 8, n_kv_heads 2,
           head_dim 512, bf16, S=2048, 3 steps launching flash_fwd_d512 8,
           flash_dq_d512 4 and flash_dkv_d512 4 each (the dK/dV's GQA items
           split over 2 CTAs at these heads), against attention_impl="xla".
3f. d384_train  the same at head_dim 384 (n_heads 8, n_kv_heads 2):
           flash_fwd_d384 8, flash_dq_d384 4 and flash_dkv_d384 4 a step.
           Each of 3b, 3d, 3e and 3f reports its seconds.
4. model   the 4-layer llama_3_8b-width model's logits through the kernels
           against the same weights through the reference attention.
5. train   the main path: Trainer + Llama (llama_3_8b widths, 4 layers,
           bf16 compute, f32 params, full remat), adamw(3e-4), B=1,
           S=2048, 5 steps on one fixed batch. Launch counters are zeroed
           just before and read just after; each kernel must have run its
           per-step count (fwd 8 = 4 layers x forward + remat recompute,
           dQ 4, dK/dV 4).
6. profile one more step under torch.profiler: device time by kernel class
           and the device's idle share.
7. ckpt    restartable training on that state (23.1 GB of f32 params and
           AdamW moments): a preemption notice {"barrier": "b1"} makes
           CheckpointHook.after_step force a save to disk, wait, and
           publish a record with that barrier; seconds until save()
           returned, seconds of wait(), GB on disk, GB/s, free disk before.
           A host copy of the saved state is kept (every parameter and
           its AdamW tensors), then one more step is taken and its loss
           and parameters kept; then everything is freed, a Llama built
           on the meta device and a new Trainer's abstract_state() (no
           draws; a step from it must raise before the restore) restore
           the checkpoint: parameters, moments and steps bit-equal to the
           saved copy; then the same step: loss and every parameter must
           equal the kept ones bit for bit. The check must reject two
           wrong restores (AdamW moments left fresh, AdamW's per-parameter
           step dropped), each the saved state put back from the host
           copy (not read from disk again) and spoiled. Then today's way,
           a Llama from another seed, init() and restore, also bit-equal
           to the saved copy: the
           seconds and peak memory (above what was allocated before) of
           both ways.
8. dist    the sharded training path at world size 1: make_mesh builds
           MeshConfig(dp=-1) over a world of one NCCL process, and the
           Trainer shards the train phase's model (same seed, batch and
           optimizer) by LLAMA_RULES (parallel/sharding.py: every Dense and
           the embedding a DTensor on the tp axis, FSDP2 over (dp, fsdp)).
           The model is built twice: today's way (eager on the card, then
           sharded by init()) and on the meta device, placed with nothing
           allocated and materialised by init() from the same draws; every
           parameter of the second, gathered (full_tensor), must be
           torch.equal to the first's; the seconds and peak memory above
           what was allocated before of each. The eager one is freed and
           the meta-built one takes 5 steps: each loss and grad norm within DIST_REL of
           the train phase's (and whether bit-equal), launches per step as
           the train phase's (8/4/4 under full: the kernels, not the
           reference, on the rank's local heads); tokens/s, peak memory and
           one profiled step's device busy time beside the train phase's.
           The sharded state is saved (DCP, shard by shard), one more step
           is taken and kept, and the unsharded Trainer of another seed
           restores the save and takes that step: restored parameters, the
           next loss and every parameter after it bit-equal.
8a. ring   ring attention (ops/ring_attention.py) over the flash kernels:
           4 ring positions stepped in lock step on the card (a hop that
           rotates the list of lanes), S=8192 in blocks of 2048, B=1,
           H=32, Hkv=8, D=128, bf16, causal and not; then causal rings of
           ragged 2000-token bf16 blocks and of 512-token f32 blocks (the
           3xTF32 kernels, at f32's limits), each ring the one
           resolve_impl("auto") picks for its block. out, dQ, dK and dV are
           held against one kernel call over the whole 8192 and against the
           plain version (by KV head), with check's scaled limits; the
           check must reject three broken rings (an off-diagonal block
           merged with its visibility inverted, dK/dV left one hop from
           home, δ taken from the diagonal block's output). Launches per
           ring: forward, dQ and dK/dV 4 each per position (RING_LANES^2);
           the ring's device time (forward and backward) beside the one
           call's. Reckoned: 14 visible or masked 2048² block pairs
           (12 whole, 4 causal diagonals) against the 8 of one causal 8192
           call, about 1.75x before the merges.
8b. ring_train the train phase's model (seed, batch, optimizer, 5 steps)
           with attention_impl="ring_flash" on MeshConfig(dp=-1, sp=1) at
           world size 1 (the ring of one block): losses and grad norms
           within DIST_REL of the train phase's (and whether bit-equal),
           launches 8/4/4 a step.
8c. pp     LlamaPipelineTrainer (parallel/llama_pp.py) at world size 1
           (pp=1): llama_3_8b widths, 4 layers, a batch of 4x2048 in 4
           microbatches, adamw(3e-4); "auto" probes GPipe's peak against the
           card's memory (the choice, peak and budget printed); gpipe and
           1f1b take 3 steps each from the seed-0 state, each loss and
           grad norm within PP_LOSS_RTOL and PP_NORM_RTOL of the unsharded
           Trainer's 3 steps on that batch,
           launches a step by pp_launches (GPipe L·m each; 1F1B the same at
           the last stage, fwd 2·L/pp·m elsewhere), tokens/s, peak memory;
           the payload (python -m tf_operator_tpu_torch.train.train_llama_pp
           --pp 1 --dp 1 --steps 3) runs in phase 16a.
8d. tp_kv  each rank's attention where tp divides the query heads but
           not the KV heads: tp=16 over llama_3_8b's 32 query and 8 KV
           heads (2 query heads a rank, S=2048, bf16), the rank's own KV
           head taken from all 8 (models/llama.py _own_kv) and its
           attention through best_attention, forward and backward, on all
           16 ranks in turn: out, dQ, dK and dV (of all 8 KV heads) within
           check's scaled limits of the plain version on JAX's layout (K/V
           repeated to full heads and sliced to the rank's); a rank that
           reads the next KV head over must be rejected; launches forward,
           dQ and dK/dV 1 each a rank.
9. remat   full, save_attn, save_qkv and mlp_only, one model at a time, the
           train phase's seed and batch, 3 steps each: launches a step must
           be fwd 4, dQ 4, dK/dV 4 (full: 8/4/4), and losses and parameters
           must equal the train phase's after its first 3 steps; ms/step,
           peak memory, one profiled step's device busy time, and the
           memory one forward keeps for its backward, per policy. Under
           save_attn, steps through run_train_steps on fresh host batches
           with and without prefetch_device, in turns; prefetch_to_device
           must hand over a batch while the card is busy without waiting
           for it (PREFETCH_MAX_HANDOVER_S).

The training state is then freed, and the serving path runs (it launches
no flash kernel, as the JAX decode path runs none):

10. decode the KV-cache path at llama_3_8b width with 2 layers on a 2-slot
           cache: slots first hold another sequence, then prompts of 256
           and 192 tokens are prefilled on a reused 1-row staging cache and
           inserted (insert_cache), and 64 decode_steps follow. In f32 (TF32
           off) every logit is held against the no-cache forward of the same
           weights with a limit scaled to the logits (DECODE_REL); the check
           must reject three wrong caches (mask off by one, K/V written one
           row late, a slot left stale after insert_cache). In bf16 the
           cached logits may be no further from the f32 forward than the
           bf16 no-cache forward is (x1.25).
11. serve  LlamaRunner at full llama_3_8b (32 layers, f32 params, bf16
           compute, max_seq_len 8192, 4 slots) behind RequestQueue (tenants
           a:b = 2:1), ContinuousBatcher and ServingEngine.run_until_idle:
           8 requests, prompts of 7 to 2000 tokens, 32 new tokens each.
           TTFT, prefill ms per bucket, decode ms per step, tokens/s, peak
           memory; one decode step under torch.profiler (device time by
           class, idle share) beside its reckoned bytes. Every request must
           finish to budget with in-vocabulary tokens and finite logits, and
           the flash launch counters must read 0. The operator's registry
           (runtime.metrics) must count each request once in its TTFT
           histogram and its completed requests; the line carries the
           registry's TTFT p99, the figure the serving autoscaler reads.
12. worker serve.worker.main --runner llama on the card over a spool of 3
           requests and the .close sentinel: exit 0, 3 responses, each
           counted once in the registry's TTFT and completed series.
13. resume the MNIST payload (train.dist_mnist) on the card as
           subprocesses: --steps 6 --crash-at-step 3 exits 137, the same
           command again exits 0 resuming at step 3, and an uninterrupted
           --steps 6 in another directory (run beside those two) reaches
           the same step-6
           parameters within RESUME_ATOL (cuDNN's convolution backward need
           not be deterministic), while its step-5 parameters do not.
14. resnet ResNet-50 training (no flash kernel: cuDNN convolutions and
           the hand-written TPUBatchNorm in eager PyTorch).
           resnet_check, in f32 with TF32 off: the s2d stem against the
           conv7 stem on the same 7x7 weights, and ResNet-50 (s2d, B=2,
           224x224, randomised norm scales and statistics) in training mode,
           logits and updated BatchNorm buffers on the card against the
           port's CPU path on the same weights and batch, each within
           RESNET_REL of its largest value; the check must reject a stem
           kernel padded at the wrong end, symmetric 3x3/stride-2 and
           max-pool padding, an unbiased running variance and momentum 0.1
           in place of 0.9.
           resnet, bench.py's configuration (bench.py:280-292): ResNet-50,
           s2d stem, B=256, 224x224, bf16 images, sgd(0.1, 0.9),
           classification_loss, no grad norm, one resident batch; images/s
           as the median of 3 timed blocks of RESNET_BLOCK_STEPS steps (one
           steps_per_call dispatch each, bench.py's collect_reps), with the
           spread; MFU at 3 x 4.09 GFLOP an image over 989 TFLOP/s; peak
           memory; losses finite and falling, buffers changed.
           resnet_profile: one step under torch.profiler, device time by
           class (convolution, reductions, elementwise, casts, optimizer)
           and the idle share, of the profiled step and against the
           host-timed step.
           resnet_pipeline: fresh batches from images_pipeline(256, 224)
           (the native C++ loader) through prefetch_to_device, a step each,
           as bench.py's data-pipeline mode, then through DeviceFeeder (the
           host copies on a thread); images/s of each.
           resnet_frozen: classification_loss_frozen_stats steps: buffers
           bit-equal, parameters moved; ms a step. The payload runs in
           phase 16a.

15. mixtral Mixtral (models/mixtral.py), after every earlier phase.
           mixtral_check: mixtral_tiny in f32 (TF32 off), card against CPU
           on the same weights: MoELayer outputs within MIXTRAL_CHECK_REL
           of their largest value, aux within MIXTRAL_AUX_ATOL and equal
           drop counts for both dispatch paths at capacity factors 1.25
           and 0.25 (which must drop), the whole model's logits; the check
           must reject a layer whose expert 0 outputs zeros.
           mixtral_train: Trainer + Mixtral at mixtral_8x7b width, 2
           layers (3.16 B parameters), B=1, S=2048, bf16 compute, f32
           params, full remat, adamw(1e-4), make_moe_lm_loss; 5 steps with
           the einsum path, then 5 with the gather path from the same seed
           and batch: losses finite and falling and within
           MIXTRAL_LOSS_RTOL of each other, first-step drop counts equal
           (per layer and step printed), flash launches 4/2/2 a step
           (counters zeroed before each run's steps), ms/step, tokens/s,
           MFU on active work (attention, router, k of E experts,
           lm_head) with the capacity-padding and dispatch-einsum FLOPs
           beside it, peak memory, and one profiled step (device busy by
           class, idle share, matmul time split by the launching op's
           shapes).
           mixtral_decode: 2 layers of that width in f32 (TF32 off),
           cached prefill and decode logits (the decode phase's slots and
           steps) within DECODE_REL of the drop-free no-cache forward
           (capacity_factor = n_experts) and the same greedy tokens.
           mixtral_serve: MixtralRunner at 8 layers (f32 params, bf16
           compute, max_seq_len 8192, 4 slots) serves the serve phase's 8
           requests (TTFT, prefill ms per bucket, decode ms a step,
           tokens/s, peak memory); mixtral_serve_profile: one decode step
           under torch.profiler with the MoE layers annotated. The
           payload runs in phase 16a.

16. bert  BERT (models/bert.py; no flash kernel: the reference attention
           at head_dim 64, as in JAX), after Mixtral.
           bert_check: bert_tiny in f32 (TF32 off), card against CPU on
           the same weights and a padded MLM batch (B=4, S=40): logits
           within BERT_CHECK_REL of their largest value and every
           parameter's gradient within BERT_GRAD_REL of its own (the key
           biases', zero in exact arithmetic, of the key weights'); the check
           must reject the card's logits without the padding mask; then
           bert_base at B=2, S=128 in f32, logits within BERT_BASE_REL.
           bert: benchmarks/bench_bert.py's configuration, Trainer + Bert
           (bert_base, bf16 compute, f32 params, remat), adamw(1e-4),
           mlm_loss, B=16, S=512, one fixed batch with 15% masked, 5
           steps: losses finite, the first within 0.5 of ln V + 1/2 (the
           cross entropy of unit-variance random logits), falling; ms a
           step, tokens/s, peak memory, MFU over 989 TFLOP/s (6 FLOPs a
           matmul parameter a token plus 12·D a pair and head, remat not
           counted); one profiled step by class (matmul, attention einsums
           and softmax, LayerNorm, gelu, casts, AdamW) and the idle share.
           Flash launches 0/0/0 over both phases (launches_by_path.bert).
16a. payloads  the payloads of phases 8c, 14, 15 and 16 as subprocesses
           on the card, all started at once (none needs another's
           output): pp_payload (python -m tf_operator_tpu_torch.train.
           train_llama_pp --pp 1 --dp 1 --steps 3), resnet_payload
           (train_resnet --size 50 --steps 4 --batch-size 64 --image-size
           224), mixtral_payload (train_mixtral --size tiny --steps 4) and
           bert_payload (train_bert --size base --steps 2): each exits 0
           and prints its "... training OK" line; one line each, as its
           phase printed it before, its seconds from the common start.
17. ps     two port shards (python -m tf_operator_tpu_torch.train.ps) as
           subprocesses on loopback from a TPUJOB_CLUSTER_SPEC, each on
           the card, and the port's MNIST worker (train.dist_mnist_ps) on
           the card for 30 steps against them, its window-mean loss
           falling; on two fresh shards, one pull and one push of a
           bert_base-sized flat dict (110 M f32 parameters) timed, median
           of 3, and the pushed SGD steps read back; every shard stopped
           by SIGTERM exits 0.
18. operator  the port's own control plane (Operator.local, the GPU
           controller and the local pod backend) runs three TPUJobs on the
           card, each with spec.slice.accelerator h100-1, one after the
           other, each waited for by TPUJobClient until all its workers
           succeeded, the backend handing each pod its own of the
           machine's cards (CUDA_VISIBLE_DEVICES's, else 0..count-1):
           gpu-smoke (2 workers of train.gpu_smoke taking the one card in
           turn: each pod stamped nvidia.com/gpu "1" and its toleration,
           both logs with WORLD_SIZE=2, LOCAL_WORLD_SIZE=1,
           CUDA_VISIBLE_DEVICES the card, MASTER_ADDR=127.0.0.1 and one
           MASTER_PORT, ranks 0 and 1, no JAX_/TPU_/MEGASCALE_ key, the
           card's name; a line of each pod's env), gpu-resnet
           (the resnet_payload command as 1 worker: "resnet training OK")
           and gpu-mnist-resume (train.dist_mnist crashing at step 3 under
           the ExitCode restart policy: one restart, the new pod resumes
           at step 3). One line a job: seconds from creation to
           AllReplicasReady and to completion, restarts, the pod logs'
           last lines, the card's name and power limit.
19. operator_planes  a second Operator.local with gang scheduling
           (total_chips=1: the one card), slice health, checkpoint
           coordination and serving. gang_queue: gpu-gang-a and gpu-gang-b
           (one h100-1 worker of train.gpu_smoke each) created back to
           back; both succeed, b is admitted after a (the gang's decision
           journal) and gets ready no earlier than a completes, each pod
           holds nvidia.com/gpu "1" and its toleration, each log the
           card's matmul; b's seconds of queue wait. serving_drain: one
           serving replica at h100-1 running serve.worker --runner llama
           (ServingPolicy 2 slots, queue 8, 8 tokens; HealthPolicy and
           CheckpointPolicy on, barrier timeout 60 s) over 24 spooled
           requests; after 4 or more responses and before all 24, its pod
           is bound to node n-maint, which then reports MaintenancePending:
           the slice-health drain opens the save-before-evict barrier, the
           worker re-spools its in-flight requests and acks, the gang is
           evicted and rebinds, the new pod logs "resumed after drain"
           and serves the rest. Checks: exactly the 24 ids answered, 8
           tokens or fewer each, nothing left pending or claimed, the job
           Succeeded, CheckpointBarrier False with CheckpointBarrierSaved,
           the ack after the first response and before the last; seconds
           from the notice to the ack and to the rebound pod's first
           response, the drain_rebind_seconds observation, responses
           before and after the ack, the card's name and power limit.
20. served the served plane as three processes: the port's operator
           (python -m tf_operator_tpu_torch --backend none --api-port ...,
           bearer tokens, and TLS from a self-signed bootstrap where the
           cryptography package imports; one line says which), a node
           agent (python -m tf_operator_tpu_torch.runtime.agent --chips 1)
           and this script as the SDK user (TPUJobClient.connect with the
           admin token). served-smoke: 2 workers of train.gpu_smoke at
           h100-1, run in turn on the agent's one card; both pods on the
           agent's node with nvidia.com/gpu "1",
           each printed env with MASTER_ADDR the agent's address and
           MASTER_PORT rank 0's published coordinator port, both logs read
           through the API server's log proxy naming the card.
           served-gloo: 2 workers of train.dist_mnist --device cpu --steps
           2 (NCCL cannot put two ranks on one card), a gloo rendezvous at
           the resolved address: "distributed: 2 processes" and "done:".
           Then no token gets 401 and a create with the read-only token
           403. Lines: seconds from creation to AllReplicasReady and to
           completion of each job, from the operator's start to /healthz
           and from the agent's start to its Node, the card's name and
           power limit.
21. kube   the Kubernetes plane: the port's fake API server
           (runtime/kube_fake.py, the port's ClusterRole enforced) with one
           node of allocatable nvidia.com/gpu 1 and an NVLink-domain
           label; the port's node agent (python -m
           tf_operator_tpu_torch.runtime.nodeagent) and operator (python
           -m tf_operator_tpu_torch --backend kube, gang scheduling with
           its slice-gang binder, checkpoint coordination, the agent's
           relay directory) as processes, both from a kubeconfig; this
           script creates kube-smoke (2 workers of train.gpu_smoke at
           h100-1 under a checkpoint policy) as a CR through
           TPUJobClient.connect_kube and plays the node's kubelet
           (FakeKubelet): each pod the binder binds runs as a subprocess
           of its container's command and rendered env with
           CUDA_VISIBLE_DEVICES the node's card, one pod at a time, its
           phase and log fed back through set_pod_phase / set_pod_log. A
           preemption notice stamped on the first running pod must reach
           its TPUJOB_PREEMPT_FILE through the agent. Checks: the job
           Succeeded, both pods on the node with nvidia.com/gpu "1",
           ranks 0 and 1 with LOCAL_WORLD_SIZE 1 and the node's card,
           both logs naming the card, the notice relayed, the node's
           heartbeat younger than 5 periods. One line: seconds from the
           CR's creation to AllReplicasReady and to Succeeded, from the
           agent's start to its first heartbeat, from the stamp to the
           notice file, the card's name and power limit.
22. failover   the deployed configuration of
           manifests/gpu/operator-deployment.yaml: the kube phase's fake
           API server with one one-GPU node, its node agent, and two
           operator processes (python -m tf_operator_tpu_torch --backend
           kube --leader-elect, distinct --leader-elect-identity, the kube
           phase's other flags) contending for the one Lease. A CR runs
           one h100-1 worker of train_resnet --size 50 --batch-size 64
           --image-size 224 (FAILOVER_STEPS steps, its output unbuffered);
           this script is the node's kubelet. Once the worker is Running
           and has logged its first step, the Lease's holder is killed
           with SIGKILL (no release). Checks: the standby holds the Lease
           within LEASE_DURATION + 2 RETRY_PERIOD + 5 s (cli.py: 26 s) of
           the kill, with the worker Running at the takeover and still
           Running 10 s after it; the CR Succeeded; the worker is the one
           from before the kill (the same uid, the same process, on the
           same card, restart count 0) and its log runs steps 0 to
           FAILOVER_STEPS - 1 once each after one start; the fake's record
           of creates holds one pod create for the replica index; at no
           sampled instant did pods bound to the node ask for more GPUs
           than it has, or did two pods' processes run. One line: seconds
           from the kill to the takeover and to Succeeded, the steps and
           seconds a step, the identities, the card's name and power
           limit.
23. installed  the port from its wheel: a copy of the image's build
           context (pyproject.toml, README.md, tf_operator_tpu_torch) is
           built offline into a wheel (pip wheel --no-deps
           --no-build-isolation --no-index) and installed with --target
           into a temporary directory made read-only (and shown unchanged
           after the phase: the superuser writes through the mode). Then
           processes whose working directory lies outside the checkout,
           with the install as the only PYTHONPATH and a fresh HOME and
           XDG_CACHE_HOME: a copy of this script (--installed-check)
           imports the port from the install, builds both kernel
           libraries with nvcc from the installed csrc/ into the fresh
           cache, runs fwd, dQ and dK/dV once each at the main path's
           shape (bf16, B=1, S=2048, H=32, Hkv=8, D=128, causal) against
           their plain versions (check_case: the kernels phase's limits
           and perturbations; launches 1/1/1), and builds the native
           generator and loader with g++ from the installed native/ into
           the cache, whose first batches must equal the checkout's
           build's; python -m tf_operator_tpu_torch.train.train_resnet
           (resnet_payload's command) prints "resnet training OK"; the
           installed console script tpu-operator-torch on --backend local
           with an HTTP API and a token serves this script as the SDK
           user, and gpu-smoke (2 workers, as the operator phase submits
           it) succeeds, each pod importing the port from the install;
           and the catalogue's smoke file as the install carries it
           (tf_operator_tpu_torch/examples/smoke/tpujob_smoke.yaml),
           with phase 24's two edits, through python -m
           tf_operator_tpu_torch.run_local from the install: Succeeded,
           its pod on the card and importing the install. The payload
           and the catalogue's smoke run beside the console script's
           job, after the nvcc build. One line: the wheel's file count,
           the seconds of wheel, install, nvcc, kernels, native, payload,
           job and catalogue_smoke, library paths, the card's name and
           power limit.
24. examples  the port's job catalogue (tf_operator_tpu_torch/examples/)
           as a user on a GPU node runs it: python -m
           tf_operator_tpu_torch.run_local on EXAMPLES_ON_CARD (smoke,
           llama_spmd, mixtral_moe, dist_mnist, resnet_dp,
           dist_mnist_ps), all at once, started before phase 23 and run
           beside it (its seconds are counted from their start),
           each on a copy with the two edits its comments ask for on a
           node of one card (--device cpu dropped; spec.slice.accelerator
           h100-1) and, where several workers take the card in turn, the
           job made to wait for all of them (successPolicy AllWorkers, or
           cleanPodPolicy None under a chief), the copy printed; each
           run_local sees the card as CUDA_VISIBLE_DEVICES, so its
           GPU-holding pods take it in turn, and its chief and ps pods,
           which hold no GPU, run on the host (the operator renders
           TPUJOB_DEVICE=cpu into them). Checks,
           pod by pod, every replica of the copy: each job Succeeded;
           each pod's log ends in its payload's line (a ps pod, reaped
           at the job's end, serves to the last: its log is read while it
           runs); the smoke pod's env names the card and its matmul the
           card's name; every worker's "device:" line reads cuda with
           the card's name and CUDA_VISIBLE_DEVICES, every chief's and
           ps pod's "device: cpu (TPUJOB_DEVICE=cpu)", so a chief on the
           card or a worker on the host fails; the llama losses fall
           (the last below the first). The catalogue must be exactly
           those files and EXAMPLES_OFF_CARD, the files one card does not
           run, each with the reason, printed in the phase's line
           (bert_gang's on the phases line). None launches a flash
           kernel: --size tiny has head_dim 16.

Then the whole script's seconds, a {"phases": [...]} line (each step of
main: ok, seconds and up to two headline numbers; a step that fails
prints it too, before the script exits non-zero), a {"kernels": [...]}
summary line (one
entry a launch key: the wgmma D=128 kernels' numbers from the training
step's case and launches from the train phase, the wgmma D=256 kernels'
from the bf16 D=256 case and the d256_train phase, the 3xTF32 kernels'
from the f32 D=128 case and the f32_train phase, the wgmma D=384
kernels' from the bf16 D=384 case and the d384_train phase, the D=512
ones' from the bf16 D=512 case and the d512_train phase; every path's
launches and every timed variant beside them),
the nvidia-smi name/power line, and last {"ok":
true, "device": {...}}. Any
failure exits non-zero before the last line; so does a machine without a
CUDA card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import gc
import glob
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import zipfile
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from tf_operator_tpu_torch import _paths, native
from tf_operator_tpu_torch.models import bert as tbert
from tf_operator_tpu_torch.models import llama as tllama
from tf_operator_tpu_torch.models.llama import Llama, llama_3_8b
from tf_operator_tpu_torch.models import mixtral as tmix
from tf_operator_tpu_torch.models import resnet
from tf_operator_tpu_torch.models.mnist import MnistCNN
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops import ring_attention as ra
from tf_operator_tpu_torch.parallel.llama_pp import LlamaPipelineTrainer
from tf_operator_tpu_torch.runtime import metrics as registry
from tf_operator_tpu_torch.serve import worker
from tf_operator_tpu_torch.serve.batcher import ContinuousBatcher
from tf_operator_tpu_torch.serve.engine import ServingEngine
from tf_operator_tpu_torch.serve.queue import Request, RequestQueue
from tf_operator_tpu_torch.serve.runner import LlamaRunner, MixtralRunner
from tf_operator_tpu_torch.train.checkpoint import (
    CheckpointConfig,
    CheckpointHook,
    Checkpointer,
)
from tf_operator_tpu_torch.ops.layers import TPUBatchNorm, repeat_kv
from tf_operator_tpu_torch.parallel.distributed import process_group_scope
from tf_operator_tpu_torch.parallel.mesh import (
    MeshConfig,
    make_mesh,
    mesh_shape,
)
from tf_operator_tpu_torch.parallel.sharding import LLAMA_RULES
from tf_operator_tpu_torch.train.data import (
    DeviceFeeder,
    SyntheticImages,
    images_pipeline,
    prefetch_to_device,
)
from tf_operator_tpu_torch.train.trainer import (
    Trainer,
    adam,
    adamw,
    classification_loss,
    classification_loss_frozen_stats,
    cross_entropy_loss,
    run_train_steps,
    sgd,
)

# Kernel vs plain version. Attention outputs and gradients are small
# (at these inputs most are ~1e-2), so the repo's fixed bf16 atol of 2e-2
# would pass a kernel writing zeros: each output's atol is scaled to its
# own largest value and capped at 2e-2, rtol stays 2e-2 (one bf16 ulp is
# at most 2**-7 of a value), and the relative L2 error is bounded too. lse
# is a log, so an absolute error on it is a relative one on the softmax
# sum.
# fp16 keeps 3 more mantissa bits than bf16, so it is held to bf16's
# limits (its rounding noise sits well inside them).
REL = 1e-2
ATOL = 2e-2
LSE_ATOL = 1e-3
# f32 kernels (the 3xTF32 forward, dQ and dK/dV) against the plain
# versions with TF32 off: relative L2 within 1e-5, every element
# within 1e-5 of the output's largest value plus 1e-5 of itself, lse
# within 1e-5. Both sum in
# f32, in orders that differ by about 1e-7 of a value, and 3xTF32 leaves
# about 2^-21 of a product; a TF32 product (10-bit mantissa) is off by
# about 1e-4, and the tf32 perturbations show these limits reject it.
F32_REL = F32_TOL = F32_LSE_ATOL = 1e-5
OUTPUTS = {"flash_fwd": ("out", "lse"), "flash_dq": ("dq",),
           "flash_dkv": ("dk", "dv")}
BLOCK = fa.BLOCK
PEAK_BF16 = 989e12      # H100 SXM dense bf16/fp16 tensor-core FLOP/s
PEAK_F32 = 67e12        # H100 SXM f32 FLOP/s without tensor cores
PEAK_TF32 = 494.7e12    # H100 SXM dense TF32 tensor-core FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
SOURCE = {"": "tf_operator_tpu_torch/csrc/flash_attention.cu",
          "_d256": "tf_operator_tpu_torch/csrc/flash_attention.cu",
          "_d384": "tf_operator_tpu_torch/csrc/flash_attention.cu",
          "_d512": "tf_operator_tpu_torch/csrc/flash_attention.cu",
          "_f32tc": "tf_operator_tpu_torch/csrc/flash_attention_f32tc.cu"}
REPLACES = {
    "flash_fwd": "tf_operator_tpu/ops/flash_attention.py:95",
    "flash_dq": "tf_operator_tpu/ops/flash_attention.py:183",
    "flash_dkv": "tf_operator_tpu/ops/flash_attention.py:207",
}
DTYPE_NAME = {torch.bfloat16: "bf16", torch.float16: "fp16",
              torch.float32: "f32"}
B, S, H, HKV, D = 1, 2048, 32, 8, 128
STEPS = 5
# Paths beyond the tile and dtype of the main one: a ragged sequence (no
# multiple of 64) and f32 through the 3xTF32 kernels. The f32
# logits against the reference attention's on the same f32 weights: both
# sum in f32 (TF32 off), in other orders, through 4 layers and a
# 128,256-way lm_head.
RAGGED_S = 2000
RAGGED_STEPS = 3
F32_STEPS = 2
F32_LOGITS_REL = 1e-4
# The main path at head_dim 256: 16 query and 4 KV heads of 256 keep
# llama_3_8b's projection shapes and the main path's attention FLOPs; at
# head_dim 512, 8 query and 2 KV heads of 512 do; at 384 the same heads
# (projections 3072 wide).
D256_HEADS, D256_KV_HEADS, D256_STEPS = 16, 4, 3
D512_HEADS, D512_KV_HEADS, D512_STEPS = 8, 2, 3
D384_HEADS, D384_KV_HEADS, D384_STEPS = 8, 2, 3
PER_STEP = {"flash_fwd": 8, "flash_dq": 4, "flash_dkv": 4}
# Under save_attn, save_qkv and mlp_only the backward reuses the forward
# kernel's outputs: one forward launch a layer.
REMAT_PER_STEP = {"flash_fwd": 4, "flash_dq": 4, "flash_dkv": 4}
REMAT_STEPS = 3
# Policies change what is saved, not the arithmetic: the same kernels and
# GEMMs on the same inputs. Parameters after 3 steps within 1e-6 (an AdamW
# step moves them by up to 3e-4), losses within 1e-6 relative.
REMAT_ATOL = 1e-6
# The sharded path at world size 1 against the unsharded step: the same
# GEMMs and kernels on the same numbers (FSDP2's gather and reduce over one
# rank are copies); the grad norm sums its squares in another order.
DIST_REL = 1e-5
# Ring phase: RING_LANES ring positions of RING_S // RING_LANES tokens,
# causal and not; then a causal ring of ragged 2000-token blocks, and one
# of f32 blocks (the 3xTF32 kernels), each block's ring chosen by
# resolve_impl("auto"). (causal, block rows, dtype)
RING_LANES = 4
RING_S = 8192
RING_CASES = ((True, RING_S // RING_LANES, torch.bfloat16),
              (False, RING_S // RING_LANES, torch.bfloat16),
              (True, 2000, torch.bfloat16),
              (True, 512, torch.float32))
# tp_kv phase: a tp that divides llama_3_8b's 32 query heads but not its 8
# KV heads (2 query heads a rank, both reading one KV head).
TP_KV = 16
# Pipeline phase: the global batch, its microbatches and the steps a
# schedule takes. Its losses and grad norms against the unsharded Trainer's
# on the same batch: the stage runs the same layers on [1, 2048]
# microbatches where the Trainer runs [4, 2048], so bf16 GEMMs round
# differently. Measured on an H100 80GB HBM3 at 700 W (PERF.md, PR 9): at
# most 2.70e-5 of the loss and 1.50e-4 of the grad norm over 3 steps, both
# schedules. The limits are about 4x those; a gradient off by a constant
# (a lost 1/m: 4x here) leaves AdamW's losses nearly where they were but
# moves the grad norm by its factor.
PP_BATCH = 4
PP_MICROBATCHES = 4
PP_STEPS = 3
PP_LOSS_RTOL = 1e-4
PP_NORM_RTOL = 6e-4
PREFETCH_STEPS = 8
# The card sleeps about 0.15 s while prefetch_to_device hands over a batch
# and stages the next; a hand-over that waited for the card would take
# that long, one that only queues copies takes well under a millisecond.
PREFETCH_SLEEP_CYCLES = 1 << 28
PREFETCH_MAX_HANDOVER_S = 0.02
# MNIST resume: step-6 parameters of the resumed and the uninterrupted run.
# cuDNN's convolution backward may sum in another order run to run (about
# 1e-7 of a gradient); one adam(1e-3) step moves a parameter by up to 1e-3,
# so a resume that replays a wrong batch or loses the moments is far off.
RESUME_ATOL = 1e-4
# Decode check: cached against no-cache logits of the same f32 weights (TF32
# off). The two paths sum in other orders (other GEMM shapes; softmax over
# the whole 8192-row cache against the causal prefix), about 1e-6 of the
# logits' scale; the limit is 1e-4 of it, and a wrong cache moves logits by
# their own scale.
DECODE_REL = 1e-4
DECODE_LENS = (256, 192)    # slot prompts, prefilled one by one
DECODE_STEPS = 64
SERVE_PROMPTS = (7, 40, 130, 300, 700, 1000, 1500, 2000)
SERVE_NEW_TOKENS = 32
SERVE_SLOTS = 4
# ResNet-50 (bench.py:280-292 and :29).
RESNET_BATCH, RESNET_IMAGE = 256, 224
RESNET_TRAIN_FLOPS_PER_IMAGE = 3 * 4.09e9   # the step is ~3x the forward
RESNET_WARMUP = 3
RESNET_BLOCK_STEPS = 8      # steps a timed block: one steps_per_call call
RESNET_FROZEN_STEPS = 2
RESNET_PIPELINE_STEPS = 8
RESNET_CHECK_BATCH = 2
# Card (cuDNN, f32, TF32 off) against CPU on the same f32 weights: each
# output within RESNET_REL of its own largest value. A wrong padding moves
# logits by their own scale; an unbiased running variance moves the last
# stage's (7x7, B=2: 98 values a channel) by 0.1/97 of the batch variance.
RESNET_REL = 1e-4
SPREAD_THRESHOLD = 0.1      # bench.py's outlier-rep guard
MAX_EXTRA_REPS = 2
REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"     # the restartable-training and Mixtral phases' device


# Every record this process emitted, and one entry a step of main: pass
# or fail, its seconds and up to two headline numbers, the first of
# HEADLINE_KEYS found at the top of the records it emitted.
EMITTED = []
PHASES = []
HEADLINE_KEYS = (
    "tokens_per_s", "images_per_s", "ms_per_step", "step_ms", "ttft_s",
    "flash_over_xla_tokens_per_s", "idle_share", "rel_l2_kernel_vs_plain",
    "ring_fwd_bwd_ms", "save_s", "restore_s", "pull_s", "push_s",
    "flash_fwd_ms", "cases_checked", "wheel_files", "nvcc_s",
    "b_queue_wait_seconds", "seconds_notice_to_ack", "seconds_to_healthz",
    "agent_seconds_to_heartbeat", "seconds_to_completion")


def emit(record) -> None:
    EMITTED.append(record)
    print(json.dumps(record), flush=True)


# Phases whose line on the phases line carries these numbers instead.
PHASE_HEADLINES = {
    "serve": ("tokens_per_s", "registry_ttft_p99_s"),
    "failover": ("lease_takeover_seconds", "kill_to_succeeded_seconds",
                 "steps"),
    "examples": ("files_run", "slowest_file_seconds", "bert_gang")}


def headline(records, keys=HEADLINE_KEYS, most: int = 2,
             numbers: bool = True) -> dict:
    """Up to ``most`` of ``keys`` from ``records``: numbers only, unless
    ``numbers`` is false (a phase's own PHASE_HEADLINES)."""
    found = {}
    for key in keys:
        value = next((r[key] for r in records
                      if not numbers and r.get(key) is not None
                      or isinstance(r.get(key), (int, float))
                      and not isinstance(r.get(key), bool)), None)
        if value is not None:
            found[key] = value
        if len(found) == most:
            break
    return found


def run_phase(name: str, fn, *args):
    """``fn(*args)`` as the step ``name`` of the phases line; a step that
    raises is entered as failed, the phases line printed, and the error
    raised on."""
    first, t0 = len(EMITTED), time.perf_counter()
    try:
        result = fn(*args)
    except BaseException as err:
        PHASES.append({"phase": name, "ok": False,
                       "seconds": time.perf_counter() - t0,
                       "error": f"{type(err).__name__}: {err}"[:300]})
        emit({"phases": PHASES})
        raise
    keys = PHASE_HEADLINES.get(name)
    PHASES.append({"phase": name, "ok": True,
                   "seconds": time.perf_counter() - t0,
                   **(headline(EMITTED[first:], keys, len(keys), False)
                      if keys else headline(EMITTED[first:]))})
    return result


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, queued: bool = True) -> float:
    """Mean time of one ``fn()`` over ``reps`` calls between two CUDA events.

    queued (the default): the calls are enqueued behind a sleep kernel and
    the start event must still be pending once the host has queued the
    last of them, so the card runs them back to back and the host's launch
    rate does not enter (if the sleep ran out first, it is lengthened and
    the run repeated). ``queued=False`` times calls that the host launches
    as it goes, which a slow host stretches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        behind = not start.query()
        torch.cuda.synchronize()
        if behind or not queued:
            return start.elapsed_time(end) / reps
        if cycles >= 1 << 36:
            raise RuntimeError("the host could not queue the timed calls "
                               "within the longest sleep")
        cycles *= 4


def counts(per_kernel: dict, times: int = 1) -> dict:
    """Launches of every kernel in fa.LAUNCHES: ``per_kernel``'s counts
    times ``times``, and 0 for each kernel it does not name."""
    return {n: per_kernel.get(n, 0) * times for n in fa.LAUNCHES}


def visible_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(q, k) pairs the causal mask leaves, per head."""
    if not causal:
        return sq * sk
    return sum(min(sk, q + q_offset + 1) for q in range(sq))


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_env():
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc, "nvidia_smi": nvidia_smi(),
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})


def kernel_variant(mangled: str) -> str:
    """"flash_fwd[bf16,256]", "flash_dq_f32tc[f32,512]": the kernel and
    template arguments of a compiled kernel's mangled name (the
    anonymous namespace's own name, which holds the file's name, left
    out)."""
    end = mangled.find("_kernelI")
    start = mangled.rfind("flash_", 0, end)
    found = re.match(r"(f|13__nv_bfloat16|6__half)?(?:Li(\d+)E)?E",
                     mangled[end + len("_kernelI"):])
    if end < 0 or start < 0 or not found:
        return mangled
    # A kernel templated on head_dim alone (the 3xTF32 one) takes f32.
    dtype = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "fp16",
             None: "f32"}
    args = dtype[found[1]] + (f",{found[2]}" if found[2] else "")
    return f"{mangled[start:end]}[{args}]"


def ptxas_report(log: str) -> dict:
    """Per kernel variant, what ``ptxas -v`` says: registers at entry (the
    warp-specialised kernels then move them with setmaxnreg), stack frame
    and spill bytes; plus any ptxas warning (e.g. setmaxnreg ignored)."""
    report, name = {"warnings": []}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_variant(entry[1])
            report[name] = {}
        elif "warning" in line.lower():
            report["warnings"].append(line.strip())
        elif name is not None:
            for key, pattern in (("stack_bytes", r"(\d+) bytes stack frame"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"),
                                 ("registers", r"Used (\d+) registers")):
                found = re.search(pattern, line)
                if found:
                    report[name][key] = int(found[1])
    return report


def phase_build():
    """Every kernel library, one nvcc each, started together."""
    t0 = time.perf_counter()
    _build.load_all(fa._LIBRARY.values())
    for family in fa._LIBRARY:
        fa._lib(family)
    libraries = {}
    for name in fa._LIBRARY.values():
        seconds, path, log = _build.build_info[name]
        libraries[name] = {"nvcc_seconds": round(seconds, 3),
                           "library": path, "ptxas": ptxas_report(log)}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": libraries})


def launch_keys(dtype, d: int) -> dict:
    """The launch key of the kernel that runs each of fwd, dQ and dK/dV
    at (dtype, head_dim), by the kind's key in OUTPUTS."""
    return {kn: kn + fa.kernel_suffix(kn[len("flash_"):], dtype, d)
            for kn in OUTPUTS}


def make_inputs(gen, sq, sk, dtype=torch.bfloat16, d=D, h=H, hkv=HKV):
    def mk(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * 0.5).to(dtype)
    return mk(B, sq, h, d), mk(B, sk, hkv, d), mk(B, sk, hkv, d), \
        mk(B, sq, h, d)


def limits(dtype) -> dict:
    """check's limits for outputs of ``dtype`` (see REL and F32_REL)."""
    if dtype == torch.float32:
        return {"rel": F32_REL, "tol": F32_TOL, "lse_atol": F32_LSE_ATOL}
    return {"rel": REL, "tol": ATOL, "lse_atol": LSE_ATOL}


def check(name: str, got, want, rel: float = REL, tol: float = ATOL,
          lse_atol: float = LSE_ATOL) -> dict:
    """Hold one output against its plain version with limits scaled to
    that output (see REL): every element within atol + tol * |want|, where
    atol = min(tol, rel * max|want|), and relative L2 within rel; lse
    within lse_atol. ``ratio`` is the error over its limit (the larger of
    the two for a scaled output): the check passes at ratio <= 1."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = diff.max().item()
    if name == "lse":
        return {"max_abs_err": err, "limit": lse_atol,
                "ratio": err / lse_atol, "ok": err <= lse_atol}
    atol = min(tol, rel * want.abs().max().item())
    elementwise = (diff / (atol + tol * want.abs())).max().item()
    rel_l2 = (diff.norm() / want.norm()).item()
    ratio = max(elementwise, rel_l2 / rel)
    return {"max_abs_err": err, "atol": atol, "rel_l2": rel_l2,
            "ratio": ratio, "ok": ratio <= 1.0}


def _last_tile_cuts(q, k, causal, q_offset):
    """Per q tile (the last may be partial): its rows, their position
    offset, and how many leading keys stay when its last visible k tile
    is left out."""
    nk = -(-k.shape[1] // BLOCK)
    for i in range(-(-q.shape[1] // BLOCK)):
        off = q_offset + i * BLOCK
        seen = min(nk, (off + BLOCK - 1) // BLOCK + 1) if causal else nk
        yield (slice(i * BLOCK, min((i + 1) * BLOCK, q.shape[1])), off,
               (seen - 1) * BLOCK)


def _fwd_without_last_tile(q, k, v, causal, q_offset):
    """The plain forward with each q tile's last visible k tile left out
    (a pipeline that drops its final stage): rows left with no key get
    out 0 and lse -1e30, as the kernel's l == 0 guard would give."""
    outs, lses = [], []
    for rows, off, keep in _last_tile_cuts(q, k, causal, q_offset):
        if keep == 0:
            outs.append(torch.zeros_like(q[:, rows]))
            lses.append(torch.full((q.shape[0], q.shape[2],
                                    rows.stop - rows.start),
                                   fa.NEG_INF, device=q.device))
            continue
        out, lse = fa._fwd_reference(q[:, rows], k[:, :keep], v[:, :keep],
                                     causal, off)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def _dq_without_last_tile(q, k, v, lse, do, delta, causal, q_offset):
    """The plain dQ with each q tile's last visible k tile left out: rows
    left with no key get dq 0."""
    parts = []
    for rows, off, keep in _last_tile_cuts(q, k, causal, q_offset):
        parts.append(torch.zeros_like(q[:, rows]) if keep == 0 else
                     fa._dq_reference(q[:, rows], k[:, :keep], v[:, :keep],
                                      lse[..., rows], do[:, rows],
                                      delta[..., rows], causal, off))
    return torch.cat(parts, dim=1)


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest even), as f32."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & -8192).view(torch.float32)


def _scores_float64(q, k, causal, q_offset):
    """fa._scores in float64: scaled, masked scores [B, Hkv, G, Sq, Sk] and
    the grouped q."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.double()) * d ** -0.5
    if causal:
        q_pos = torch.arange(sq, device=q.device) + q_offset
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], fa.NEG_INF)
    return s, qg


def _probs_grads_float64(q, k, v, lse, do, delta, causal, q_offset):
    """fa._probs_grads in float64: P, dS [B, Hkv, G, Sq, Sk] and the
    grouped q and dO."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    s, qg = _scores_float64(q, k, causal, q_offset)
    dog = do.double().reshape(b, sq, hkv, h // hkv, d)
    p = torch.exp(s - lse.double().reshape(b, hkv, h // hkv, sq, 1))
    dp = torch.einsum("bqkgd,btkd->bkgqt", dog, v.double())
    ds = p * (dp - delta.double().reshape(b, hkv, h // hkv, sq, 1)) \
        * d ** -0.5
    return p, ds, qg, dog


def dkv_float64(q, k, v, lse, do, delta, causal, q_offset):
    """dK and dV of the plain version's formulas (fa._probs_grads and
    fa._dkv_reference) computed in float64."""
    p, ds, qg, dog = _probs_grads_float64(q, k, v, lse, do, delta, causal,
                                          q_offset)
    return (torch.einsum("bkgqt,bqkgd->btkd", ds, qg),
            torch.einsum("bkgqt,bqkgd->btkd", p, dog))


def dq_float64(q, k, v, lse, do, delta, causal, q_offset):
    """dQ of the plain version's formulas (fa._dq_reference) computed in
    float64."""
    _, ds, _, _ = _probs_grads_float64(q, k, v, lse, do, delta, causal,
                                       q_offset)
    return torch.einsum("bkgqt,btkd->bqkgd", ds, k.double()).reshape(
        q.shape)


def fwd_float64(q, k, v, causal, q_offset):
    """out [B, Sq, H, D] and lse [B, H, Sq] of the plain forward's formulas
    (fa._fwd_reference: the -1e30 mask, a sum of 0 guarded as 1) computed
    in float64."""
    b, sq, h, d = q.shape
    s, _ = _scores_float64(q, k, causal, q_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bkgqt,btkd->bkgqd", p, v.double()) / l
    return (o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d),
            (m + torch.log(l)).reshape(b, h, sq))


# The domain perturbations of a column half at head_dim 384-512, which the
# check must reject through each output they change on its own.
COLUMN_HALF_PERTURBATIONS = ("d_cols_last_128_zero",
                             "d_cols_last_128_from_cols_0_127",
                             "out_second_half_without_last_k_tile")


def domain_perturbed(q, k, v, do, ref, delta, causal, q_offset):
    """Plain-version outputs of kernels that handle the domain's edges
    wrong, which the check must reject; only those that apply to these
    inputs: ragged edges, head_dim > 128, f32."""
    lse, sq, sk, d = ref["lse"], q.shape[1], k.shape[1], q.shape[3]
    wrong = {}
    keep_k = sk // BLOCK * BLOCK
    if sk % BLOCK and keep_k:
        # The partial last k tile never loaded: its keys are out of every
        # softmax and dQ sum, and their dK/dV rows are never written.
        kc, vc = k[:, :keep_k], v[:, :keep_k]
        out, lse_cut = fa._fwd_reference(q, kc, vc, causal, q_offset)
        tail = {n: ref[n].clone() for n in ("dk", "dv")}
        for t in tail.values():
            t[:, keep_k:] = 0
        wrong["keys_past_last_full_tile_dropped"] = {
            "out": out, "lse": lse_cut,
            "dq": fa._dq_reference(q, kc, vc, lse, do, delta, causal,
                                   q_offset), **tail}
    if sq % BLOCK:
        # Rows past the last full q tile never stored (left as zeros).
        keep_q = sq // BLOCK * BLOCK
        rows = {n: ref[n].clone() for n in ("out", "dq")}
        for t in rows.values():
            t[:, keep_q:] = 0
        wrong["rows_past_last_full_tile_zero"] = rows
    if d > 128:
        # Scores from the first 128 of head_dim only (one chunk).
        q_cut = q.clone()
        q_cut[..., 128:] = 0
        out, lse_cut = fa._fwd_reference(q_cut, k, v, causal, q_offset)
        dq, dk, dv = fa._bwd_reference(q_cut, k, v, out, lse_cut, do,
                                       causal, q_offset)
        wrong["scores_from_first_128_of_d"] = {
            "out": out, "lse": lse_cut, "dq": dq, "dk": dk, "dv": dv}
        # Outputs whose head_dim columns 128-255 are never written (left as
        # zeros) or written from the wrong accumulator (columns 0-127
        # again), as a kernel with one 128-column accumulator too few
        # would give.
        zero, again = {}, {}
        for n in ("out", "dq", "dk", "dv"):
            zero[n], again[n] = ref[n].clone(), ref[n].clone()
            zero[n][..., 128:256] = 0
            again[n][..., 128:256] = ref[n][..., :128]
        wrong["d_cols_128_255_zero"] = zero
        wrong["d_cols_128_255_from_cols_0_127"] = again
    if d > 256:
        # out, dQ and dK/dV whose last 128 head_dim columns are never
        # written (left as zeros) or written from columns 0-127, as a
        # column-half warpgroup or CTA that never stores, or stores the
        # wrong slice, would give; and out's second column half summed
        # without each q tile's last visible k tile, as a column-half
        # warpgroup that leaves its loop early would give (lse is
        # warpgroup 0's).
        zero, again = {}, {}
        for n in ("out", "dq", "dk", "dv"):
            zero[n], again[n] = ref[n].clone(), ref[n].clone()
            zero[n][..., d - 128:] = 0
            again[n][..., d - 128:] = ref[n][..., :128]
        early = ref["out"].clone()
        early[..., d // 2:] = _fwd_without_last_tile(
            q, k, v, causal, q_offset)[0][..., d // 2:]
        wrong.update(zip(COLUMN_HALF_PERTURBATIONS,
                         (zero, again, {"out": early})))
    if q.dtype == torch.float32:
        # A TF32 kernel: every product on TF32-rounded operands.
        qt, kt, vt, dot = (tf32(x) for x in (q, k, v, do))
        out, lse_t = fa._fwd_reference(qt, kt, vt, causal, q_offset)
        dq, dk, dv = fa._bwd_reference(qt, kt, vt, out, lse_t, dot, causal,
                                       q_offset)
        wrong["tf32"] = {"out": out, "lse": lse_t, "dq": dq, "dk": dk,
                         "dv": dv}
        # 3xTF32 kernels that split the loaded operands but not the
        # computed ones: P rounded to TF32 before O += P V, P^T and dS^T
        # before dV += P^T dO and dK += dS^T Q, dS before dQ += dS K.
        s, _ = fa._scores(q, k, causal, q_offset)
        pf = torch.exp(s - s.amax(dim=-1, keepdim=True))
        out = torch.einsum("bkgqt,btkd->bkgqd", tf32(pf), v.float()) \
            / pf.sum(dim=-1, keepdim=True)
        del s, pf
        p, ds, qg, dog = fa._probs_grads(q, k, v, lse, do, delta, causal,
                                         q_offset)
        wrong["tf32_register_operands"] = {
            "out": out.permute(0, 3, 1, 2, 4).reshape(q.shape),
            "dq": torch.einsum("bkgqt,btkd->bqkgd", tf32(ds),
                               k.float()).reshape(q.shape),
            "dk": torch.einsum("bkgqt,bqkgd->btkd", tf32(ds), qg),
            "dv": torch.einsum("bkgqt,bqkgd->btkd", tf32(p), dog)}
    return wrong


def perturbed(q, k, v, do, ref, delta, causal, q_offset):
    """Plain-version outputs of kernels gone wrong in typical ways, which
    the check must reject: each a dict of the outputs it changes. Beyond
    zeros, these need more than one k tile (k_seq > BLOCK)."""
    if k.shape[1] <= BLOCK:
        return {"zeros": {n: torch.zeros_like(t) for n, t in ref.items()}}
    lse = ref["lse"]
    k_rest, v_rest, k_off = k[:, BLOCK:], v[:, BLOCK:], q_offset - BLOCK
    out_skip, lse_skip = fa._fwd_reference(q, k_rest, v_rest, causal, k_off)
    dk_skip, dv_skip = fa._dkv_reference(
        q[:, BLOCK:], k, v, lse[..., BLOCK:], do[:, BLOCK:],
        delta[..., BLOCK:], causal, q_offset + BLOCK)
    out_tail, lse_tail = _fwd_without_last_tile(q, k, v, causal, q_offset)
    if q.shape[1] > BLOCK:
        dk_tail, dv_tail = fa._dkv_reference(
            q[:, :-BLOCK], k, v, lse[..., :-BLOCK], do[:, :-BLOCK],
            delta[..., :-BLOCK], causal, q_offset)
    else:
        dk_tail, dv_tail = torch.zeros_like(k), torch.zeros_like(v)
    # The last q tile's rows of dQ never written (the edge warpgroup idle).
    dq_tail = ref["dq"].clone()
    dq_tail[:, -BLOCK:] = 0
    # One GQA member (heads h = 0 mod group) left out of the dK/dV sum: its
    # dO, and so its δ = rowsum(dO O), zeroed.
    member = torch.arange(q.shape[2], device=q.device) % (
        q.shape[2] // k.shape[2]) == 0
    do_member = do.masked_fill(member[None, None, :, None], 0)
    delta_member = delta.masked_fill(member[None, :, None], 0)
    dk_member, dv_member = fa._dkv_reference(
        q, k, v, lse, do_member, delta_member, causal, q_offset)
    no_delta = torch.zeros_like(delta)
    return {
        "zeros": {n: torch.zeros_like(t) for n, t in ref.items()},
        # δ = rowsum(dO O) left out of dS = P (dP - δ) scale.
        "delta_dropped": {
            "dq": fa._dq_reference(q, k, v, lse, do, no_delta, causal,
                                   q_offset),
            "dk": fa._dkv_reference(q, k, v, lse, do, no_delta, causal,
                                    q_offset)[0]},
        # The first k tile left out of the forward's and dQ's loops (the
        # one tile every query row sees).
        "first_k_tile_skipped": {
            "out": out_skip, "lse": lse_skip,
            "dq": fa._dq_reference(q, k_rest, v_rest, lse, do, delta,
                                   causal, k_off)},
        # The first q tile left out of dK/dV's loop.
        "first_q_tile_skipped": {"dk": dk_skip, "dv": dv_skip},
        # The pipeline's tail dropped: each q tile's last visible k tile
        # (the diagonal) in the forward's and dQ's loops, the last q tile
        # in dK/dV's loop and in dQ's output.
        "last_k_tile_skipped": {
            "out": out_tail, "lse": lse_tail,
            "dq": _dq_without_last_tile(q, k, v, lse, do, delta, causal,
                                        q_offset)},
        "last_q_tile_skipped": {"dk": dk_tail, "dv": dv_tail,
                                "dq": dq_tail},
        "gqa_member_dropped": {"dk": dk_member, "dv": dv_member},
    }


def check_case(gen, sq, sk, causal, q_offset, timed: bool,
               dtype=torch.bfloat16, d=D, h=H, hkv=HKV):
    """One case: each kernel against its plain version, and the check
    itself against perturbed plain outputs that it must reject. The
    kernels run before the plain versions they are held to, so an output
    a kernel failed to write cannot hold a plain result left in memory
    the allocator hands out again."""
    q, k, v, do = make_inputs(gen, sq, sk, dtype, d, h, hkv)
    lim = limits(dtype)
    out, lse = fa._fwd_cuda(q, k, v, causal, q_offset)
    ref_out, ref_lse = fa._fwd_reference(q, k, v, causal, q_offset)
    delta = fa._delta(ref_out, do)
    dq = fa._dq_cuda(q, k, v, ref_lse, do, delta, causal, q_offset)
    dk, dv = fa._dkv_cuda(q, k, v, ref_lse, do, delta, causal, q_offset)
    ref_dq = fa._dq_reference(q, k, v, ref_lse, do, delta, causal, q_offset)
    ref_dk, ref_dv = fa._dkv_reference(q, k, v, ref_lse, do, delta, causal,
                                       q_offset)
    torch.cuda.synchronize()
    ref = {"out": ref_out, "lse": ref_lse, "dq": ref_dq, "dk": ref_dk,
           "dv": ref_dv}
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    checks = {n: check(n, got[n], ref[n], **lim) for n in ref}
    errs = {kn: max(checks[n]["max_abs_err"] for n in names)
            for kn, names in OUTPUTS.items()}
    ok = {kn: all(checks[n]["ok"] for n in names)
          for kn, names in OUTPUTS.items()}
    # ratio > 1 means the check rejects that wrong output.
    caught = {p: {n: check(n, t, ref[n], **lim)["ratio"]
                  for n, t in outs.items()}
              for p, outs in perturbed(q, k, v, do, ref, delta, causal,
                                       q_offset).items()}
    wrong = domain_perturbed(q, k, v, do, ref, delta, causal, q_offset)
    domain_caught = {p: {n: check(n, t, ref[n], **lim)["ratio"]
                         for n, t in outs.items()}
                     for p, outs in wrong.items()}
    keys = launch_keys(dtype, d)
    case = {"dtype": DTYPE_NAME[dtype], "d": d, "h": h, "hkv": hkv,
            "sq": sq, "sk": sk, "causal": causal, "q_offset": q_offset,
            "kernels": keys,
            "max_abs_err": errs, "ok": ok, "checks": checks,
            "perturbed_ratio": caught,
            "domain_perturbed_ratio": domain_caught}
    if dtype == torch.float32:
        # The f32 plain version sums its long products in f32 as well, so
        # the kernels' out, lse, dQ, dK and dV are also held to a float64
        # version at the same limits (gated), which must reject the TF32
        # perturbations; the plain version's own ratio is reported beside.
        exact = dict(zip(("out", "lse"), fwd_float64(q, k, v, causal,
                                                     q_offset)))
        exact.update(zip(("dk", "dv"), dkv_float64(
            q, k, v, ref_lse, do, delta, causal, q_offset)))
        exact["dq"] = dq_float64(q, k, v, ref_lse, do, delta, causal,
                                 q_offset)
        case["f64_ratio"] = {
            n: {"kernel": check(n, got[n], e, **lim)["ratio"],
                "plain": check(n, ref[n], e, **lim)["ratio"]}
            for n, e in exact.items()}
        case["f64_perturbed_ratio"] = {
            p: {n: check(n, t, exact[n], **lim)["ratio"]
                for n, t in wrong[p].items()}
            for p in ("tf32", "tf32_register_operands")}
        del exact
    del wrong
    # Keys no query row sees (causal, k >= sq + q_offset) must get exact
    # zeros: the kernel's outputs come from torch.empty.
    unseen = sq + q_offset if causal else sk
    if unseen < sk:
        case["unseen_keys_zero"] = bool(
            (dk[:, unseen:] == 0).all() and (dv[:, unseen:] == 0).all())
    if not timed:
        return case, None

    size = q.element_size()
    pairs = visible_pairs(sq, sk, causal, q_offset) * h * B
    act_q, act_kv, rows = B * sq * h * d * size, B * sk * hkv * d * size, \
        B * h * sq * 4
    work = {  # (matmul FLOPs, bytes read once + written once)
        "flash_fwd": (pairs * 4 * d, act_q + 2 * act_kv + act_q + rows),
        "flash_dq": (pairs * 6 * d, 2 * act_q + 2 * act_kv + 2 * rows
                     + act_q),
        "flash_dkv": (pairs * 8 * d, 2 * act_q + 2 * act_kv + 2 * rows
                      + 2 * act_kv),
    }
    peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16
    # The 3xTF32 kernels take milliseconds a call: fewer repetitions.
    reps = {kn: 10 if key.endswith("_f32tc") else 20
            for kn, key in keys.items()}
    kernel_calls = {
        "flash_fwd": lambda: fa._fwd_cuda(q, k, v, causal, q_offset),
        "flash_dq": lambda: fa._dq_cuda(q, k, v, ref_lse, do, delta, causal,
                                        q_offset),
        "flash_dkv": lambda: fa._dkv_cuda(q, k, v, ref_lse, do, delta,
                                          causal, q_offset),
    }
    plain = {
        "flash_fwd": cuda_ms(lambda: fa._fwd_reference(
            q, k, v, causal, q_offset), 3, 1),
        "flash_dq": cuda_ms(lambda: fa._dq_reference(
            q, k, v, ref_lse, do, delta, causal, q_offset), 3, 1),
        "flash_dkv": cuda_ms(lambda: fa._dkv_reference(
            q, k, v, ref_lse, do, delta, causal, q_offset), 3, 1),
    }
    # Yardstick only: PyTorch's fused attention on the same inputs, in its
    # [B, H, S, D] layout (views). Its backward computes dQ, dK and dV in
    # one call, so it stands beside both backward kernels.
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    lib_calls = {
        "fwd": lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True),
        "bwd": lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
    }
    # (device time of calls queued behind a sleep, time of the same calls
    # launched by the host as it goes)
    lib_reps = min(reps.values())
    times = {n: (cuda_ms(f, reps.get(n, lib_reps)),
                 cuda_ms(f, reps.get(n, lib_reps), queued=False))
             for n, f in {**kernel_calls, **lib_calls}.items()}
    library = {"flash_fwd": times["fwd"], "flash_dq": times["bwd"],
               "flash_dkv": times["bwd"]}
    stats = {}
    for name, (flops, nbytes) in work.items():
        bound_ms, bound_by = bound(flops, nbytes, peak)
        ms, host_ms = times[name]
        row = {"dtype": DTYPE_NAME[dtype], "d": d, "h": h, "hkv": hkv,
               "sq": sq, "sk": sk, "ms": ms, "host_launched_ms": host_ms,
               "tflop_per_s": flops / ms / 1e9, "plain_ms": plain[name],
               "library_ms": library[name][0],
               "library_host_launched_ms": library[name][1],
               "bound_ms": bound_ms, "bound_by": bound_by,
               "peak_flop_per_s": peak, "flops": flops, "bytes": nbytes}
        if keys[name].endswith("_f32tc"):
            # 3xTF32: every product as three TF32 products on the tensor
            # cores, its bound; the f32 FMA bound beside it.
            row["fma_bound_ms"] = bound_ms
            row["bound_ms"], row["bound_by"] = bound(3 * flops, nbytes,
                                                     PEAK_TF32)
            row["peak_flop_per_s"] = PEAK_TF32 / 3
        stats[keys[name]] = row
    case["timing"] = stats
    return case, stats


# The kernels phase's cases: (dtype, head_dim, q_seq, k_seq, causal,
# q_offset, timed) and, where given, (H, Hkv); else B, H and Hkv are the
# module's (GQA 4:1). The first is the training step's; each kernel's
# first timed case gives the summary's numbers (the f32 kernels' f32 at
# 128, the wgmma D=256, D=384 and D=512 kernels' bf16).
KERNEL_CASES = (
    (torch.bfloat16, D, S, S, True, 0, True),
    (torch.bfloat16, D, S, S, False, 0, False),
    (torch.bfloat16, D, S // 2, S, True, S // 2, False),
    (torch.bfloat16, D, S // 2 + BLOCK, S // 2 + BLOCK, True, 0, False),
    (torch.bfloat16, D, S // 2, S, True, 0, False),  # half the k tiles unseen
    # Ragged sequences (partial last tiles), wgmma kernels.
    (torch.bfloat16, D, 2000, 2000, True, 0, True),
    (torch.bfloat16, D, 72, 200, True, 128, False),
    (torch.bfloat16, D, 8, 8, True, 0, False),
    (torch.float16, D, S, S, True, 0, True),
    (torch.float16, D, 200, 200, True, 0, False),
    # f32 at every head_dim (the 3xTF32 forward, dQ and dK/dV), and
    # bf16/fp16 at 384-512 (the wgmma kernels by column halves).
    (torch.float32, 128, S, S, True, 0, True),
    (torch.float32, 128, 200, 200, False, 0, False),
    (torch.float32, 256, S, S, True, 0, True),
    (torch.float32, 384, S, S, True, 0, True),
    (torch.float32, 512, S, S, True, 0, True),
    (torch.float32, 512, 200, 200, False, 0, False),
    (torch.bfloat16, 384, S, S, True, 0, True),
    (torch.float16, 384, S, S, True, 0, True),
    (torch.float16, 384, 200, 200, False, 0, False),
    (torch.bfloat16, 512, S, S, True, 0, True),
    (torch.bfloat16, 512, 200, 200, False, 0, False),
    (torch.float16, 512, S, S, True, 0, True),
    # The wgmma kernels' edges at 384-512, as at 256 below: no
    # multiple of the tile, q_offset, half the k tiles unseen (exact
    # zeros), a ragged q_offset case; and d512_train's heads (H=8, Hkv=2:
    # the dK/dV's splits).
    (torch.bfloat16, 512, 2000, 2000, True, 0, False),
    (torch.bfloat16, 512, S // 2, S, True, S // 2, False),
    (torch.bfloat16, 512, S // 2, S, True, 0, False),  # half unseen
    (torch.bfloat16, 384, S // 2, S, True, 0, False),  # half unseen
    (torch.float16, 512, 72, 200, True, 128, False),
    (torch.bfloat16, 384, 2000, 2000, True, 0, False),
    (torch.bfloat16, 512, S, S, True, 0, True, D512_HEADS, D512_KV_HEADS),
    # head_dim 256, bf16/fp16: the wgmma kernels ("_d256"); the training
    # step's shapes first, then the edges the D=128
    # cases cover: q_offset, no multiple of the tile, a ragged q_offset
    # case and half the k tiles unseen (exact zeros).
    (torch.bfloat16, 256, S, S, True, 0, True),
    (torch.float16, 256, S, S, True, 0, True),
    (torch.bfloat16, 256, 2000, 2000, True, 0, True),
    (torch.bfloat16, 256, S // 2, S, True, S // 2, False),
    (torch.bfloat16, 256, 200, 200, False, 0, False),
    (torch.float16, 256, 72, 200, True, 128, False),
    (torch.bfloat16, 256, S // 2, S, True, 0, False),  # half unseen
    # head_dim 256 at d256_train's heads: the shapes it launches them at.
    (torch.bfloat16, 256, S, S, True, 0, True, D256_HEADS, D256_KV_HEADS),
)


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, stats, variants = [], {}, []
    for dtype, d, sq, sk, causal, q_offset, timed, *heads in KERNEL_CASES:
        case, st = check_case(gen, sq, sk, causal, q_offset, timed, dtype, d,
                              *heads)
        cases.append(case)
        for name, row in (st or {}).items():
            # Each kernel's summary numbers: its first timed case.
            stats.setdefault(name, row)
            variants.append({"kernel": name, **row})
        free_cuda()
    emit({"phase": "kernels", "cases_checked": len(cases),
          "flash_fwd_ms": stats["flash_fwd"]["ms"],
          "tolerance": {"atol": f"min({ATOL}, {REL} * max|ref|)",
                        "rtol": ATOL, "rel_l2": REL, "lse_atol": LSE_ATOL,
                        "f32": {"atol": f"min({F32_TOL}, {F32_REL} * "
                                        f"max|ref|)",
                                "rtol": F32_TOL, "rel_l2": F32_REL,
                                "lse_atol": F32_LSE_ATOL}},
          "cases": cases})
    tag = lambda c: (c["dtype"], c["d"], c["h"], c["sq"], c["sk"],
                     c["causal"])
    bad = [(*tag(c), n) for c in cases
           for n, good in c["ok"].items() if not good]
    bad += [(*tag(c), "unseen keys not zero") for c in cases
            if c.get("unseen_keys_zero") is False]
    bad += [(*tag(c), n, "vs float64") for c in cases
            for n, r in c.get("f64_ratio", {}).items() if r["kernel"] > 1.0]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"beyond the scaled limits: {bad}")
    # The check must reject wrong outputs: zeros in every case, every
    # perturbed output at the training step's shape, and every domain
    # perturbation wherever it applies (through at least one of the
    # outputs it changes: a ragged edge moves some outputs by a few rows'
    # worth, which only lse or the rows themselves show).
    missed = [(*tag(c), p, n) for i, c in enumerate(cases)
              for p, ratios in c["perturbed_ratio"].items()
              for n, r in ratios.items()
              if r <= 1.0 and (i == 0 or p == "zeros")]
    missed += [(*tag(c), p) for c in cases
               for p, ratios in c["domain_perturbed_ratio"].items()
               if max(ratios.values()) <= 1.0]
    # A column half left unwritten, written from the wrong columns or
    # summed over too few k tiles: each of out, dQ, dK and dV it changes on
    # its own (their kernels split the columns apart).
    missed += [(*tag(c), p, n) for c in cases
               for p, ratios in c["domain_perturbed_ratio"].items()
               if p in COLUMN_HALF_PERTURBATIONS
               for n, r in ratios.items() if r <= 1.0]
    # Against float64 each output of a TF32 perturbation on its own: a
    # kernel that left any one of out, dQ, dK and dV in TF32 must be
    # caught.
    missed += [(*tag(c), p, n, "vs float64") for c in cases
               for p, ratios in c.get("f64_perturbed_ratio", {}).items()
               for n, r in ratios.items() if r <= 1.0]
    if missed:
        raise AssertionError(f"the kernel check accepts wrong outputs: "
                             f"{missed}")
    errs = {}
    for c in cases:
        for kn, err in c["max_abs_err"].items():
            name = c["kernels"][kn]
            errs[name] = max(errs.get(name, 0.0), err)
    return stats, variants, errs


def slice_config():
    return dataclasses.replace(llama_3_8b(), n_layers=4, remat=True,
                               remat_policy="full")


def logits_of(model, tokens, **fields):
    """Logits of ``model``'s weights in a model with ``fields`` changed."""
    other = Llama(dataclasses.replace(model.cfg, **fields), device=DEVICE)
    other.load_state_dict(model.state_dict())
    with torch.no_grad():
        out = other(tokens).float()
    del other
    torch.cuda.empty_cache()
    return out


def rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def phase_model(model, tokens, phase: str = "model") -> dict:
    """The logits through the kernels and through the reference attention
    in the model's dtype (bf16 or fp16), each against the same weights in
    f32 with the reference attention (relative L2). The kernel path passes
    when it is no further from f32 than the reference path is (x1.25);
    its forward must launch the kernels, one a layer, and call the
    reference attention never. Returns the launches."""
    fa.reset_launches()
    with torch.no_grad(), reference_attention_calls() as calls:
        got = model(tokens).float()
    torch.cuda.synchronize()
    launches, ref_calls = dict(fa.LAUNCHES), calls[0]
    plain = logits_of(model, tokens, attention_impl="xla")
    truth = logits_of(model, tokens, attention_impl="xla",
                      dtype=torch.float32)
    kernel_err, plain_err = rel_l2(got, truth), rel_l2(plain, truth)
    name = DTYPE_NAME[model.cfg.dtype]
    emit({"phase": phase, "dtype": name, "tokens": list(tokens.shape),
          "logits_shape": list(got.shape),
          "finite": bool(torch.isfinite(got).all()),
          "rel_l2_kernel_vs_f32": kernel_err,
          "rel_l2_plain_vs_f32": plain_err,
          "rel_l2_kernel_vs_plain": rel_l2(got, plain),
          "launches": launches, "reference_attention_calls": ref_calls})
    if not torch.isfinite(got).all() or kernel_err > 1.25 * plain_err:
        raise AssertionError(
            f"{name} logits through the kernels are further from the f32 "
            f"model ({kernel_err}) than 1.25x the {name} reference path's "
            f"({plain_err})")
    fwd = launch_keys(model.cfg.dtype, model.cfg.head_dim)["flash_fwd"]
    want = counts({fwd: model.cfg.n_layers})
    if launches != want or ref_calls:
        raise AssertionError(f"{phase}: launches {launches} != {want} or "
                             f"{ref_calls} reference attention calls")
    return launches


@contextlib.contextmanager
def reference_attention_calls():
    """Count the calls of the reference attention (ops.layers.attention),
    from the model and from best_attention's fallback."""
    calls, real = [0], fa.attention

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    with mock.patch.object(fa, "attention", counted), \
            mock.patch.object(tllama, "attention", counted):
        yield calls


def train_run(model, batch, steps: int) -> dict:
    """``steps`` Trainer steps (adamw(3e-4)) on one batch, with the kernel
    launches and the reference-attention calls counted over them."""
    trainer = Trainer(model=model, optimizer=adamw(3e-4), device=DEVICE)
    state = trainer.init()
    step = trainer.make_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, norms, step_s = [], [], []
    with reference_attention_calls() as calls:
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tokens = batch["inputs"].shape[0] * (batch["inputs"].shape[1] - 1)
    return {"losses": losses, "grad_norms": norms,
            "step_ms": [t * 1e3 for t in step_s],
            "ms_per_step": steady * 1e3, "tokens_per_s": tokens / steady,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": dict(fa.LAUNCHES),
            "reference_attention_calls": calls[0]}


def full_remat_launches(layers: int, dtype=torch.bfloat16, d: int = D
                        ) -> dict:
    """Launches of one training step under full remat: the forward kernel
    twice a layer (forward and recompute), dQ and dK/dV once, each the
    kernel that runs it at (dtype, head_dim)."""
    keys = launch_keys(dtype, d)
    return {keys["flash_fwd"]: 2 * layers, keys["flash_dq"]: layers,
            keys["flash_dkv"]: layers}


def seeded(cfg):
    return Llama(cfg, device=DEVICE,
                 generator=torch.Generator(device=DEVICE).manual_seed(0))


def free_cuda():
    gc.collect()
    torch.cuda.empty_cache()


def phase_fp16_model() -> dict:
    """The model phase's logits check in fp16 at S=2048 (module
    docstring, phase 3a); returns the launches."""
    model = seeded(dataclasses.replace(slice_config(), dtype=torch.float16))
    tokens = np.random.default_rng(3).integers(0, model.cfg.vocab_size,
                                               (B, S))
    launches = phase_model(model, torch.as_tensor(tokens, device=DEVICE),
                           "fp16_model")
    del model
    free_cuda()
    return launches


def train_against_xla(phase: str, cfg, tokens, steps: int, **record):
    """A path beside the main one (phases 3b, 3d-3f): ``cfg``'s logits
    through the kernels against the reference attention (phase 4's rule,
    on ``tokens`` less the last), then ``steps`` Trainer steps through the
    kernels, which must launch full remat's kernels at (dtype, head_dim)
    and call the reference attention never, with losses finite and
    falling, beside the same steps with attention_impl="xla". Emits both
    runs and the phase's seconds; returns the kernel run."""
    started = time.perf_counter()
    model = seeded(cfg)
    phase_model(model, torch.as_tensor(tokens[:, :-1], device=DEVICE),
                phase.replace("_train", "_model"))
    runs = {"flash": train_run(model, {"inputs": tokens}, steps)}
    del model
    free_cuda()
    model = seeded(dataclasses.replace(cfg, attention_impl="xla"))
    runs["xla"] = train_run(model, {"inputs": tokens}, steps)
    del model
    free_cuda()
    emit({"phase": phase, "nvidia_smi": nvidia_smi(),
          "seconds": time.perf_counter() - started,
          "layers": cfg.n_layers, "batch": B, "seq": tokens.shape[1] - 1,
          "steps": steps, **record, "runs": runs,
          "flash_over_xla_tokens_per_s":
              runs["flash"]["tokens_per_s"] / runs["xla"]["tokens_per_s"]})
    flash = runs["flash"]
    losses = flash["losses"]
    if not all(math.isfinite(x) for x in losses + flash["grad_norms"]):
        raise AssertionError(f"{phase}: non-finite loss or grad norm: "
                             f"{flash}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: loss did not fall: {losses}")
    want = counts(full_remat_launches(cfg.n_layers, cfg.dtype, cfg.head_dim),
                  steps)
    if flash["launches"] != want or flash["reference_attention_calls"]:
        raise AssertionError(
            f"{phase}: launches {flash['launches']} != {want} or "
            f"{flash['reference_attention_calls']} reference attention "
            f"calls")
    return flash


def phase_ragged_train() -> dict:
    """The main path at a sequence that is no multiple of the kernels'
    tile (module docstring, phase 3b); returns the kernel run's
    launches."""
    cfg = slice_config()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (B, RAGGED_S + 1))
    return train_against_xla("ragged_train", cfg, tokens,
                             RAGGED_STEPS)["launches"]


def phase_f32_train() -> dict:
    """The main path in f32 through the 3xTF32 kernels (module docstring,
    phase 3c); returns the launches of its steps."""
    cfg = dataclasses.replace(slice_config(), dtype=torch.float32)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               (B, S + 1))
    model = seeded(cfg)
    inputs = torch.as_tensor(tokens[:, :S], device=DEVICE)
    fa.reset_launches()
    with torch.no_grad(), reference_attention_calls() as calls:
        got = model(inputs).float()
    forward_launches, forward_ref_calls = dict(fa.LAUNCHES), calls[0]
    want_logits = logits_of(model, inputs, attention_impl="xla")
    logits_err = rel_l2(got, want_logits)
    del got, want_logits
    run = train_run(model, {"inputs": tokens}, F32_STEPS)
    del model
    free_cuda()
    emit({"phase": "f32_train", "nvidia_smi": nvidia_smi(),
          "layers": cfg.n_layers, "batch": B, "seq": S,
          "rel_l2_logits_vs_reference_attention": logits_err,
          "limit": F32_LOGITS_REL, "forward_launches": forward_launches,
          "forward_reference_attention_calls": forward_ref_calls, **run})
    if not logits_err <= F32_LOGITS_REL:
        raise AssertionError(f"f32 logits through the kernels are "
                             f"{logits_err} from the reference attention's "
                             f"(limit {F32_LOGITS_REL})")
    want = counts(full_remat_launches(cfg.n_layers, torch.float32),
                  F32_STEPS)
    if (run["launches"] != want or run["reference_attention_calls"]
            or forward_ref_calls
            or forward_launches != counts(
                {launch_keys(torch.float32, cfg.head_dim)["flash_fwd"]:
                 cfg.n_layers})):
        raise AssertionError(
            f"f32_train: launches {run['launches']} != {want}, forward "
            f"{forward_launches}, or reference attention calls "
            f"{run['reference_attention_calls']} / {forward_ref_calls}")
    if not all(math.isfinite(x) for x in run["losses"] + run["grad_norms"]):
        raise AssertionError(f"f32_train: non-finite loss or grad norm: "
                             f"{run}")
    return run["launches"]


def phase_d256_train() -> dict:
    """The main path with the attention at head_dim 256 (module
    docstring, phase 3d); returns the kernel run's launches."""
    cfg = dataclasses.replace(slice_config(), n_heads=D256_HEADS,
                              n_kv_heads=D256_KV_HEADS, head_dim=256)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                               (B, S + 1))
    return train_against_xla("d256_train", cfg, tokens, D256_STEPS,
                             heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                             head_dim=cfg.head_dim)["launches"]


def phase_wide_train(phase: str, head_dim: int, heads: int, kv_heads: int,
                     steps: int, seed: int) -> dict:
    """The main path with the attention at a wide head_dim (module
    docstring, phases 3e and 3f); returns the kernel run's launches."""
    cfg = dataclasses.replace(slice_config(), n_heads=heads,
                              n_kv_heads=kv_heads, head_dim=head_dim)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (B, S + 1))
    return train_against_xla(phase, cfg, tokens, steps, heads=cfg.n_heads,
                             kv_heads=cfg.n_kv_heads,
                             head_dim=cfg.head_dim)["launches"]


def phase_train(model, batch):
    trainer = Trainer(model=model, optimizer=adamw(3e-4), device="cuda")
    state = trainer.init()
    step = trainer.make_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, norms, step_s = [], [], []
    for i in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i + 1 == REMAT_STEPS:     # the remat phase's reference
            full_params = cpu_params(model)
    launches = dict(fa.LAUNCHES)
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    cfg = model.cfg
    # Model FLOPs of one step (remat recompute not counted): 6 per matmul
    # parameter per token (the embedding lookup is no matmul), plus causal
    # attention's 4 D FLOPs per (q, k) pair and head forward, x3 with the
    # backward.
    matmul_params = sum(p.numel() for n, p in model.named_parameters()
                        if n.endswith(".weight") and "embed" not in n)
    flops = (6 * matmul_params * B * S + 3 * 4 * cfg.head_dim * cfg.n_heads
             * visible_pairs(S, S, True, 0) * cfg.n_layers * B)
    record = {"phase": "train", "layers": cfg.n_layers,
              "params": sum(p.numel() for p in model.parameters()),
              "batch": B, "seq": S, "steps": STEPS, "losses": losses,
              "grad_norms": norms, "step_ms": [t * 1e3 for t in step_s],
              "ms_per_step": steady * 1e3, "tokens_per_s": B * S / steady,
              "model_flops_per_step": flops,
              "mfu_vs_989_tflops": flops / steady / PEAK_BF16,
              "max_memory_allocated_gb":
                  torch.cuda.max_memory_allocated() / 2 ** 30,
              "launches": launches}
    emit(record)
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    want = counts(PER_STEP, STEPS)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} "
                             f"({PER_STEP} per step)")
    full = {"losses": losses[:REMAT_STEPS], "params": full_params,
            "record": record}
    return launches, step, state, full


def cpu_params(model):
    """A host copy of every parameter (a copy on any device); a sharded
    model's gathered whole."""
    return {n: (p.full_tensor() if isinstance(p, DTensor) else p)
            .detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}


def kernel_class(name: str) -> str:
    if "flash_" in name:
        return "flash attention kernels"
    if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "multi_tensor_apply" in name:
        return "optimizer (foreach)"
    return "other"


def phase_profile(step, state, batch):
    """One more step under torch.profiler: device time by kernel class,
    the busiest kernels, and the device's idle share of the step."""
    record = profile_step(step, state, batch)
    emit({"phase": "profile", **record})
    return record


def profile_step(step, state, batch, classify=kernel_class,
                 op_class=None) -> dict:
    """One step under torch.profiler (see phase_profile), kernels grouped
    by ``classify(name)``. With ``op_class(op)`` (a class or None for an
    aten op, read with its input shapes), also the device time of each
    op class's kernels (``by_op_class_ms``; a kernel the profiler links to
    no aten op, e.g. one launched while the host waited on a full command
    buffer, is in none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=op_class is not None) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, by_op = {}, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            cls = (op_class(ev) if op_class is not None
                   and ev.name.startswith("aten::") else None)
            if cls is not None:
                by_op[cls] = (by_op.get(cls, 0.0)
                              + sum(k.duration for k in ev.kernels) / 1e3)
            continue
        # Device-side ranges of user annotations (e.g. Optimizer.step)
        # span kernels that are counted on their own.
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.is_user_annotation):
            continue
        by_name[ev.name] = (by_name.get(ev.name, 0.0)
                            + ev.time_range.elapsed_us() / 1e3)
    by_class, top = {}, {}
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        cls = classify(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        if len(top.setdefault(cls, [])) < 4:
            top[cls].append([name[:100], ms])
    busy = sum(by_class.values())
    record = {"wall_ms": wall_ms, "device_busy_ms": busy,
              "idle_share": 1.0 - busy / wall_ms if busy else None,
              "by_class_ms": by_class, "top_kernels_ms": top}
    if op_class is not None:
        record["by_op_class_ms"] = by_op
    return record


# ---------------------------------------------------------------------------
# Restartable training: checkpoint and restore, remat policies
# ---------------------------------------------------------------------------

class TimedCheckpointer:
    """The Checkpointer surface, timing save() (until the state is off
    the card) and wait() (until the step is committed on disk)."""

    def __init__(self, ckpt: Checkpointer):
        self.ckpt = ckpt
        self.seconds = {}

    def _timed(self, name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.seconds[name] = time.perf_counter() - t0

    def save(self, step, state, force=False):
        return self._timed("save_s", self.ckpt.save, step, state, force)

    def wait(self):
        return self._timed("wait_s", self.ckpt.wait)

    def latest_step(self):
        return self.ckpt.latest_step()


def state_bytes(state) -> int:
    """Bytes of the parameters and the optimizer's tensors."""
    tensors = list(state.model.parameters()) + [
        t for per_param in state.opt_state.state.values()
        for t in per_param.values() if torch.is_tensor(t)]
    return sum(t.numel() * t.element_size() for t in tensors)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def phase_ckpt(step, state, batch, root):
    """The coordinated checkpoint on the training state (module docstring,
    phase 7), then one more step whose loss and parameters are kept."""
    card = nvidia_smi()
    directory = os.path.join(root, "ckpt")
    need = state_bytes(state)
    free = shutil.disk_usage(root).free
    if free < 1.1 * need:
        raise AssertionError(f"{free / 1e9:.1f} GB free under {root}, the "
                             f"checkpoint needs {need / 1e9:.1f} GB")
    preempt = os.path.join(root, "preempt.json")
    with open(preempt, "w") as f:
        json.dump({"barrier": "b1"}, f)
    config = CheckpointConfig(directory=directory, interval_steps=1000,
                              preempt_file=preempt,
                              record_file=os.path.join(root, "record.json"))
    timed = TimedCheckpointer(Checkpointer(directory))
    torch.cuda.synchronize()
    saved_step = state.step
    saved = CheckpointHook(timed, config).after_step(saved_step, state)
    with open(config.record_file) as f:
        record = json.load(f)
    on_disk = dir_bytes(os.path.join(directory, str(saved_step)))
    seconds = timed.seconds
    saved_state = state_copy(state)
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    kept = {"step": saved_step, "loss": float(metrics["loss"]),
            "params": cpu_params(state.model), "saved": saved_state}
    emit({"phase": "ckpt", "nvidia_smi": card, "step": saved_step,
          "saved": saved, "record": record,
          "latest_step": timed.latest_step(), "state_gb": need / 1e9,
          "disk_gb": on_disk / 1e9, "free_disk_gb_before": free / 1e9,
          "save_s": seconds.get("save_s"), "wait_s": seconds.get("wait_s"),
          "gb_per_s": on_disk / 1e9 / (seconds["save_s"]
                                       + seconds["wait_s"]),
          "next_loss": kept["loss"]})
    if not (saved and record["step"] == saved_step
            and record["barrier"] == "b1"
            and timed.latest_step() == saved_step):
        raise AssertionError(f"the barrier save did not commit and ack "
                             f"step {saved_step}: saved={saved} "
                             f"record={record}")
    timed.ckpt.close()
    return kept


def state_tensors(state) -> dict:
    """Every parameter (a sharded one gathered whole) and each one's AdamW
    tensors, keyed by (parameter name, "param" or the optimizer's key)."""
    out = {}
    for name, p in state.model.named_parameters():
        out[name, "param"] = p.full_tensor() if isinstance(p, DTensor) else p
        for key, t in state.opt_state.state.get(p, {}).items():
            out[name, key] = t.full_tensor() if isinstance(t, DTensor) else t
    return out


def state_copy(state) -> dict:
    """A host copy of ``state_tensors``, taken one tensor at a time."""
    return {k: t.detach().to("cpu", copy=True)
            for k, t in state_tensors(state).items()}


def load_state_copy(state, saved: dict, step: int) -> None:
    """Put a ``state_copy`` back into ``state`` (an unsharded one), in
    place, one tensor at a time, at ``step``."""
    now = state_tensors(state)
    if set(now) != set(saved):
        raise AssertionError(f"state keys differ: "
                             f"{sorted(set(now) ^ set(saved), key=str)[:3]}")
    with torch.no_grad():
        for k, t in saved.items():
            now[k].copy_(t)
    state.step = step


def differing(state, saved: dict) -> list:
    """The keys whose tensor in ``state`` is not bit for bit the host copy
    ``saved`` (each copied back to the card on its own)."""
    now = state_tensors(state)
    return sorted(set(now) ^ set(saved)) + [
        k for k, t in saved.items()
        if k in now and not torch.equal(now[k], t.to(now[k].device))]


def timed_init(build):
    """``build()``'s result, with its seconds and the card's peak
    allocation above what was allocated before it (GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = build()
    torch.cuda.synchronize()
    return out, {"s": time.perf_counter() - t0,
                 "peak_gb": (torch.cuda.max_memory_allocated() - base)
                 / 2 ** 30, "before_gb": base / 2 ** 30}


def _fresh_moments(opt):
    for per_param in opt.state.values():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            per_param[name].zero_()


def _adam_step_dropped(opt):
    for per_param in opt.state.values():
        per_param["step"].zero_()


def phase_restore(kept, batch, root):
    """The checkpoint restored into ``Trainer.abstract_state()`` of a
    model built on the meta device (no draws), held bit for bit to the
    saved state, and the kept step taken again; then today's way, a
    build from another seed, ``init`` and restore, for its seconds and
    peak (module docstring, phase 7)."""
    card = nvidia_smi()
    ckpt = Checkpointer(os.path.join(root, "ckpt"))

    def abstract():
        trainer = Trainer(model=Llama(slice_config(), device="meta"),
                          optimizer=adamw(3e-4), device=DEVICE)
        return trainer, trainer.abstract_state()

    (trainer, state), built = timed_init(abstract)
    model, step = state.model, trainer.make_train_step()
    try:
        step(state, batch)
        unrestored_raised = False
    except RuntimeError:
        unrestored_raised = True

    def restored_step(spoil=None, against_saved=False, from_disk=True):
        t = time.perf_counter()
        if from_disk:
            ckpt.restore(state)
        else:
            load_state_copy(state, kept["saved"], kept["step"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        restored_at = state.step
        out = {"restore_s": seconds, "restored_step": restored_at,
               "source": "disk" if from_disk else "host copy"}
        if against_saved:
            out["peak_gb"] = (torch.cuda.max_memory_allocated()
                              / 2 ** 30)
            out["saved_differing"] = differing(state, kept["saved"])
            out["saved_tensors"] = len(kept["saved"])
        if spoil is not None:
            spoil(state.opt_state)
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        differ = [n for n, p in model.named_parameters()
                  if not torch.equal(p.detach().cpu(), kept["params"][n])]
        return {**out, "loss": float(metrics["loss"]),
                "loss_bit_equal": float(metrics["loss"]) == kept["loss"],
                "params_differing": len(differ),
                "params": len(kept["params"])}

    good = restored_step(against_saved=True)
    good["peak_gb"] -= built["before_gb"]
    # The wrong restores start from the host copy of the saved state (the
    # disk restore above was held bit for bit to it), not from disk again.
    wrong = {"moments_fresh": restored_step(_fresh_moments, from_disk=False),
             "adam_step_dropped": restored_step(_adam_step_dropped,
                                                from_disk=False)}
    del model, trainer, state, step
    free_cuda()

    def today():
        model = Llama(slice_config(), device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(1))
        state = Trainer(model=model, optimizer=adamw(3e-4),
                        device=DEVICE).init()
        torch.cuda.synchronize()
        built = time.perf_counter()
        ckpt.restore(state)
        torch.cuda.synchronize()
        return state, time.perf_counter() - built

    (state, today_restore_s), today_built = timed_init(today)
    today_differing = differing(state, kept["saved"])
    del state
    free_cuda()
    ckpt.close()
    record = {
        "phase": "restore", "nvidia_smi": card,
        "abstract": {"build_s": built["s"], **good,
                     "build_and_restore_s": built["s"] + good["restore_s"],
                     "saved_differing": len(good["saved_differing"])},
        "unrestored_step_raised": unrestored_raised,
        "init_then_restore": {
            "s": today_built["s"], "restore_s": today_restore_s,
            "init_s": today_built["s"] - today_restore_s,
            "peak_gb": today_built["peak_gb"],
            "saved_differing": len(today_differing)},
        "order": "abstract first, then init_then_restore",
        "wrong_restores": wrong}
    emit(record)
    if not unrestored_raised:
        raise AssertionError("a step from an unrestored abstract state ran")
    if good["saved_differing"] or today_differing:
        raise AssertionError(
            f"the restored state differs from the saved one: abstract "
            f"{good['saved_differing'][:3]}, init-then-restore "
            f"{today_differing[:3]}")
    if not (good["restored_step"] == kept["step"] and good["loss_bit_equal"]
            and good["params_differing"] == 0):
        raise AssertionError(f"the restored run differs from the one that "
                             f"never stopped: {good}")
    missed = [name for name, r in wrong.items() if r["params_differing"] == 0]
    if missed:
        raise AssertionError(f"the restore check accepts wrong restores: "
                             f"{missed}")


def phase_dist(batch, train, train_profile, root):
    """The sharded training path at world size 1 (module docstring, phase
    8): the steps against the train phase's, the kernels' launches, what
    the wrapping costs, and the sharded state saved and restored into the
    unsharded Trainer."""
    card = nvidia_smi()
    with process_group_scope():
        mesh = make_mesh(MeshConfig(dp=-1), device=DEVICE)

        def sharded(device):
            model = Llama(slice_config(), device=device)
            trainer = Trainer(model=model, optimizer=adamw(3e-4),
                              device=DEVICE, mesh=mesh, rules=LLAMA_RULES,
                              param_axes_fn=tllama.param_logical_axes)
            return trainer, trainer.init()

        # Today's init (the eager build, then sharded) beside the meta
        # build materialised by init(): the same seed, every parameter
        # gathered bit for bit.
        (_, eager), eager_init = timed_init(lambda: sharded(DEVICE))
        (trainer, state), meta_init = timed_init(lambda: sharded("meta"))
        model = state.model
        eager_params = dict(eager.model.named_parameters())
        meta_params = dict(model.named_parameters())
        init_differ = sorted(set(eager_params) ^ set(meta_params)) + [
            n for n, p in meta_params.items() if n in eager_params
            and not torch.equal(p.full_tensor(),
                                eager_params[n].full_tensor())]
        init_params = len(meta_params)
        del eager, eager_params, meta_params
        free_cuda()
        if init_differ:
            raise AssertionError(f"the meta-built init differs from the "
                                 f"eager build: {init_differ[:3]}")
        step = trainer.make_train_step()
        sharded = sum(isinstance(p, DTensor) for p in model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        losses, norms, step_s = [], [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
        ckpt = Checkpointer(os.path.join(root, "dist-ckpt"))
        t0 = time.perf_counter()
        ckpt.save(state.step, state)
        ckpt.wait()
        save_s = time.perf_counter() - t0
        ckpt.close()
        saved_step, saved = state.step, cpu_params(model)
        # One more step, profiled: the step the restored Trainer repeats.
        out = {}

        def kept_step(st, b):
            out["result"] = step(st, b)
            return out["result"]

        profile = profile_step(kept_step, state, batch)
        kept_loss = float(out["result"][1]["loss"])
        kept = cpu_params(model)
        mesh_sizes = mesh_shape(mesh)
        backend = dist.get_backend()
        del model, trainer, state, step, out, mesh
        gc.collect()
        torch.cuda.empty_cache()
    # The unsharded Trainer, from another seed, restores the sharded save.
    model = Llama(slice_config(), device=DEVICE,
                  generator=torch.Generator(device=DEVICE).manual_seed(1))
    trainer = Trainer(model=model, optimizer=adamw(3e-4), device=DEVICE)
    state = trainer.init()
    ckpt = Checkpointer(os.path.join(root, "dist-ckpt"))
    t0 = time.perf_counter()
    ckpt.restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ckpt.close()
    restored = cpu_params(model)
    restored_differ = [n for n, p in saved.items()
                       if not torch.equal(restored[n], p)]
    del restored, saved
    _, metrics = trainer.make_train_step()(state, batch)
    next_loss = float(metrics["loss"])
    next_differ = [n for n, p in cpu_params(model).items()
                   if not torch.equal(p, kept[n])]
    del model, trainer, state, kept
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(root, "dist-ckpt"), ignore_errors=True)

    rel = lambda a, b: abs(a - b) / abs(b)
    record = {
        "phase": "dist", "nvidia_smi": card, "backend": backend,
        "mesh": mesh_sizes, "rules": "LLAMA_RULES",
        "dtensor_params": sharded, "losses": losses, "grad_norms": norms,
        "max_rel_loss_vs_unsharded": max(
            rel(a, b) for a, b in zip(losses, train["losses"])),
        "max_rel_grad_norm_vs_unsharded": max(
            rel(a, b) for a, b in zip(norms, train["grad_norms"])),
        "losses_bit_equal": losses == train["losses"],
        "grad_norms_bit_equal": norms == train["grad_norms"],
        "limit": DIST_REL, "launches": launches,
        "step_ms": [t * 1e3 for t in step_s], "ms_per_step": steady * 1e3,
        "tokens_per_s": B * S / steady,
        "unsharded_tokens_per_s": train["tokens_per_s"],
        "device_busy_ms": profile["device_busy_ms"],
        "unsharded_device_busy_ms": train_profile["device_busy_ms"],
        "profile": profile,
        "max_memory_allocated_gb": peak,
        "unsharded_max_memory_allocated_gb":
            train["max_memory_allocated_gb"],
        "save_s": save_s, "saved_step": saved_step, "restore_s": restore_s,
        "restored_params_differing": len(restored_differ),
        "next_loss": next_loss, "next_loss_sharded": kept_loss,
        "next_loss_bit_equal": next_loss == kept_loss,
        "next_params_differing": len(next_differ),
        "init": {"eager": eager_init, "meta": meta_init,
                 "params": init_params,
                 "params_differing": len(init_differ)}}
    emit(record)
    if not (record["max_rel_loss_vs_unsharded"] <= DIST_REL
            and record["max_rel_grad_norm_vs_unsharded"] <= DIST_REL):
        raise AssertionError(f"the sharded steps differ from the unsharded "
                             f"ones beyond {DIST_REL}: {losses} {norms} vs "
                             f"{train['losses']} {train['grad_norms']}")
    want = counts(PER_STEP, STEPS)
    if launches != want:
        raise AssertionError(f"sharded kernel launches {launches} != {want}: "
                             f"the sharded path left the kernels")
    if not (saved_step == STEPS and not restored_differ
            and record["next_loss_bit_equal"] and not next_differ):
        raise AssertionError(
            f"the sharded save restored into the unsharded Trainer differs: "
            f"restored {restored_differ[:3]}, next step {next_differ[:3]}, "
            f"loss {next_loss} vs {kept_loss}")
    return launches


# ---------------------------------------------------------------------------
# Sequence and pipeline parallelism: ring, ring_train, pp
# ---------------------------------------------------------------------------

def rotate(lanes, reverse=False):
    """The lock-step hop of the ring phase: lane i receives lane i-1's
    payload (i+1's when reversed)."""
    return lanes[1:] + lanes[:1] if reverse else lanes[-1:] + lanes[:-1]


def plain_by_kv_head(q, k, v, do, causal):
    """The plain forward and backward over the whole sequence, one KV head
    and its query heads at a time (the f32 scores of all 32 heads at 8192
    would take 8.6 GB each): out, lse, dq, dk, dv."""
    group = q.shape[2] // k.shape[2]
    parts = []
    for h in range(k.shape[2]):
        qh = q[:, :, h * group:(h + 1) * group]
        kh, vh = k[:, :, h:h + 1], v[:, :, h:h + 1]
        doh = do[:, :, h * group:(h + 1) * group]
        out, lse = fa._fwd_reference(qh, kh, vh, causal, 0)
        dq, dk, dv = fa._bwd_reference(qh, kh, vh, out, lse, doh, causal, 0)
        parts.append((out, lse, dq, dk, dv))
    dims = (2, 1, 2, 2, 2)
    return [torch.cat([p[i] for p in parts], dim=d)
            for i, d in enumerate(dims)]


def lanes_of(x):
    return [c.contiguous() for c in x.chunk(RING_LANES, dim=1)]


def ring_outputs(q, k, v, do, causal):
    """The ring through its autograd function, the launches it made, and
    its per-lane forward results: {out, dq, dk, dv} over the sequence."""
    ring = ra.Ring(rotate, tuple(range(RING_LANES)), RING_LANES)
    qs, ks, vs = ([c.detach().clone().requires_grad_() for c in lanes_of(x)]
                  for x in (q, k, v))
    torch.cuda.synchronize()
    fa.reset_launches()
    outs = ra._ring_flash_lanes(qs, ks, vs, ring, causal)
    torch.autograd.backward(outs, lanes_of(do))
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    cat = lambda xs: torch.cat([x.detach() for x in xs], dim=1)
    got = {"out": cat(outs), "dq": cat([x.grad for x in qs]),
           "dk": cat([x.grad for x in ks]), "dv": cat([x.grad for x in vs])}
    return got, launches, ring


def ring_perturbed(q, k, v, do, causal, got, ring):
    """Rings gone wrong in the three ways the check must catch."""
    qs, ks, vs, dos = (lanes_of(x) for x in (q, k, v, do))
    n = RING_LANES
    # An off-diagonal block merged with its visibility inverted.
    accs, kb, vb = [], ks, vs
    for i in range(n):
        o, lse = fa._fwd(qs[i], ks[i], vs[i], causal, 0)
        accs.append((o.float(), lse))
    for step in range(1, n):
        kb, vb = kb[-1:] + kb[:-1], vb[-1:] + vb[:-1]
        for i, src in enumerate(ring.sources(step)):
            o, lse = fa._fwd(qs[i], kb[i], vb[i], False, 0)
            accs[i] = ra._merge_block(*accs[i], o, lse,
                                      not ra._visible(causal, src, i))
    inverted = torch.cat([o.to(q.dtype) for o, _ in accs], dim=1)
    # dK/dV without the last hop home: lane r keeps block r+1's.
    away = {name: torch.cat([got[name].chunk(n, dim=1)[(r + 1) % n]
                             for r in range(n)], dim=1)
            for name in ("dk", "dv")}
    # δ from the diagonal block's output instead of the final one.
    outs, lses = ra._ring_flash_fwd(qs, ks, vs, ring, causal)
    deltas = [fa._delta(fa._fwd(qs[i], ks[i], vs[i], causal, 0)[0], dos[i])
              for i in range(n)]
    dqs, dks, _ = ra._ring_flash_bwd(qs, ks, vs, outs, lses, dos, deltas,
                                     ring, causal)
    # δ enters dS = P (dP - δ) only: dV = P^T dO does not see it.
    cat = lambda xs: torch.cat(xs, dim=1)
    return {"visibility_inverted": {"out": inverted},
            "dkv_one_hop_from_home": away,
            "delta_from_block_output": {"dq": cat(dqs), "dk": cat(dks)}}


def phase_ring():
    """Ring attention over the kernels, 4 lock-step lanes on the card
    (module docstring, phase 8a)."""
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    cases, launches_total = [], dict.fromkeys(fa.LAUNCHES, 0)
    for causal, s_blk, dtype in RING_CASES:
        # The block's ring as JAX's impl="auto" picks it: the flash ring
        # for every block in the kernels' domain, f32 included.
        impl = ra.resolve_impl("auto", s_blk, D, H, HKV, dtype)
        if impl != "flash":
            raise AssertionError(f"resolve_impl('auto') chose {impl} for a "
                                 f"{dtype} block of {s_blk}")
        want_launches = counts({n: RING_LANES * RING_LANES
                                for n in launch_keys(dtype, D).values()})
        lim = limits(dtype)
        q, k, v, do = ((torch.randn(B, RING_LANES * s_blk, h, D,
                                    generator=gen, device=DEVICE) * 0.5)
                       .to(dtype) for h in (H, HKV, HKV, H))
        got, launches, ring = ring_outputs(q, k, v, do, causal)
        for name, count in launches.items():
            launches_total[name] += count
        out, lse = fa._fwd(q, k, v, causal, 0)
        dq, dk, dv = fa._bwd(q, k, v, out, lse, do, causal, 0)
        single = {"out": out, "dq": dq, "dk": dk, "dv": dv}
        plain = dict(zip(("out", "lse", "dq", "dk", "dv"),
                         plain_by_kv_head(q, k, v, do, causal)))
        plain.pop("lse")
        checks = {n: check(n, got[n], plain[n], **lim) for n in got}
        vs_single = {n: check(n, got[n], single[n], **lim) for n in got}
        single_vs_plain = {n: check(n, single[n], plain[n], **lim)["ratio"]
                           for n in got}
        caught = {p: {n: check(n, t, plain[n], **lim)["ratio"]
                      for n, t in outs.items()}
                  for p, outs in ring_perturbed(q, k, v, do, causal, got,
                                                ring).items()}
        qs, ks, vs, dos = (lanes_of(x) for x in (q, k, v, do))

        def ring_call():
            outs, lses = ra._ring_flash_fwd(qs, ks, vs, ring, causal)
            deltas = [fa._delta(o, do) for o, do in zip(outs, dos)]
            ra._ring_flash_bwd(qs, ks, vs, outs, lses, dos, deltas, ring,
                               causal)

        def single_call():
            o, l = fa._fwd(q, k, v, causal, 0)
            fa._bwd(q, k, v, o, l, do, causal, 0)

        # One ring call queues some 320 launches (kernels, merges, f32
        # accumulations); the card's queue of pending launches holds about
        # a thousand, so each timed run is one call, the median of three.
        ring_ms = sorted(cuda_ms(ring_call, 1) for _ in range(3))[1]
        single_ms = sorted(cuda_ms(single_call, 1) for _ in range(3))[1]
        cases.append({
            "causal": causal, "block": s_blk, "dtype": DTYPE_NAME[dtype],
            "impl_auto": impl, "launches": launches,
            "want_launches": want_launches,
            "checks_vs_plain": checks, "checks_vs_one_call": vs_single,
            "one_call_vs_plain_ratio": single_vs_plain,
            "perturbed_ratio": caught,
            "ring_fwd_bwd_ms": ring_ms, "one_call_fwd_bwd_ms": single_ms,
            "ring_over_one_call": ring_ms / single_ms,
            "reckoned_block_pairs": ({"ring": 14, "one_call": 8} if causal
                                     else {"ring": 16, "one_call": 16})})
        del q, k, v, do, got, single, plain, qs, ks, vs, dos
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "ring", "nvidia_smi": nvidia_smi(), "lanes": RING_LANES,
          "shape": {"B": B, "H": H, "Hkv": HKV, "D": D},
          "tolerance": {"bf16": limits(torch.bfloat16),
                        "f32": limits(torch.float32)},
          "cases": cases})
    bad = [(c["causal"], c["block"], c["dtype"], which, n) for c in cases
           for which in ("checks_vs_plain", "checks_vs_one_call")
           for n, r in c[which].items() if not r["ok"]]
    if bad:
        raise AssertionError(f"the ring disagrees beyond the scaled "
                             f"limits: {bad}")
    missed = [(c["causal"], c["block"], c["dtype"], p, n) for c in cases
              for p, ratios in c["perturbed_ratio"].items()
              for n, r in ratios.items() if r <= 1.0]
    if missed:
        raise AssertionError(f"the ring check accepts broken rings: "
                             f"{missed}")
    wrong = [(c["launches"], c["want_launches"]) for c in cases
             if c["launches"] != c["want_launches"]]
    if wrong:
        raise AssertionError(f"ring launches (got, want) {wrong} (forward, "
                             f"dQ, dK/dV {RING_LANES} a position)")
    return launches_total


def phase_ring_train(batch, train):
    """The train phase's step with attention_impl="ring_flash" on a mesh
    with sp (module docstring, phase 8b)."""
    with process_group_scope():
        mesh = make_mesh(MeshConfig(dp=-1, sp=1), device=DEVICE)
        cfg = dataclasses.replace(slice_config(), attention_impl="ring_flash")
        model = Llama(cfg, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(0))
        trainer = Trainer(model=model, optimizer=adamw(3e-4), device=DEVICE,
                          mesh=mesh, rules=LLAMA_RULES,
                          param_axes_fn=tllama.param_logical_axes)
        state = trainer.init()
        step = trainer.make_train_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        losses, norms, step_s = [], [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mesh_sizes = mesh_shape(mesh)
        del model, trainer, state, step, mesh
        gc.collect()
        torch.cuda.empty_cache()
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    rel = lambda a, b: abs(a - b) / abs(b)
    record = {
        "phase": "ring_train", "nvidia_smi": nvidia_smi(), "mesh": mesh_sizes,
        "attention_impl": "ring_flash", "losses": losses, "grad_norms": norms,
        "max_rel_loss_vs_train": max(
            rel(a, b) for a, b in zip(losses, train["losses"])),
        "max_rel_grad_norm_vs_train": max(
            rel(a, b) for a, b in zip(norms, train["grad_norms"])),
        "losses_bit_equal": losses == train["losses"],
        "grad_norms_bit_equal": norms == train["grad_norms"],
        "limit": DIST_REL, "launches": launches,
        "step_ms": [t * 1e3 for t in step_s], "ms_per_step": steady * 1e3,
        "tokens_per_s": B * S / steady, "max_memory_allocated_gb": peak}
    emit(record)
    if not (record["max_rel_loss_vs_train"] <= DIST_REL
            and record["max_rel_grad_norm_vs_train"] <= DIST_REL):
        raise AssertionError(f"the ring steps differ from the train phase's "
                             f"beyond {DIST_REL}: {losses} {norms}")
    want = counts(PER_STEP, STEPS)
    if launches != want:
        raise AssertionError(f"ring_train kernel launches {launches} != "
                             f"{want}: the ring left the kernels")
    return launches


def phase_tp_kv():
    """Each rank's attention where tp divides the query heads but not the
    KV heads (module docstring, phase 8d)."""
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    mk = lambda *shape: (torch.randn(*shape, generator=gen, device=DEVICE)
                         * 0.5).to(torch.bfloat16)
    heads, group = H // TP_KV, H // HKV

    def port(first):
        def attend(q, k, v):
            return fa.best_attention(
                q, *tllama._own_kv(k, v, first, heads, group), causal=True)
        return attend

    def run(attend, q, k, v, do):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = attend(*leaves)
        out.backward(do)
        return {"out": out.detach(), "dq": leaves[0].grad,
                "dk": leaves[1].grad, "dv": leaves[2].grad}

    launches = dict.fromkeys(fa.LAUNCHES, 0)
    worst, caught = {}, []
    for rank in range(TP_KV):
        first = rank * heads
        q, do = mk(B, S, heads, D), mk(B, S, heads, D)
        k, v = mk(B, S, HKV, D), mk(B, S, HKV, D)
        fa.reset_launches()
        got = run(port(first), q, k, v, do)
        torch.cuda.synchronize()
        for name, count in fa.LAUNCHES.items():
            launches[name] += count
        # The plain version on JAX's layout: K/V repeated to full heads and
        # sliced to this rank's, the repeated heads' dK/dV summed back.
        mine = lambda x: repeat_kv(x, group)[:, :, first:first + heads]
        out, _, dq, dk, dv = plain_by_kv_head(q, mine(k), mine(v), do, True)
        home = torch.arange(first, first + heads, device=DEVICE) // group
        full = lambda g: torch.zeros(k.shape, dtype=torch.float32,
                                     device=DEVICE).index_add_(
                                         2, home, g.float())
        plain = {"out": out, "dq": dq, "dk": full(dk), "dv": full(dv)}
        for n, r in ((n, check(n, got[n], plain[n])) for n in plain):
            if r["ratio"] > worst.get(n, {"ratio": -1.0})["ratio"]:
                worst[n] = r
        # A rank that reads the next KV head over must be rejected.
        wrong = run(port((first + group) % H), q, k, v, do)
        caught.append(max(check(n, wrong[n], plain[n])["ratio"]
                          for n in plain))
        del q, k, v, do, got, wrong, plain
    gc.collect()
    torch.cuda.empty_cache()
    want = counts(dict.fromkeys(PER_STEP, TP_KV))
    emit({"phase": "tp_kv", "nvidia_smi": nvidia_smi(), "tp": TP_KV,
          "heads_per_rank": heads, "kv_heads": HKV, "seq": S,
          "worst_vs_plain": worst, "launches": launches,
          "want_launches": want, "wrong_kv_head_min_ratio": min(caught)})
    if not all(r["ok"] for r in worst.values()):
        raise AssertionError(f"tp_kv disagrees with the plain version: "
                             f"{worst}")
    if min(caught) <= 1.0:
        raise AssertionError("the tp_kv check accepts the wrong KV head")
    if launches != want:
        raise AssertionError(f"tp_kv launches {launches} != {want}: the "
                             f"ranks' attention left the kernels")


def pp_launches(schedule: str, stage: int, stages: int, layers: int,
                microbatches: int) -> dict:
    """Kernel launches of one pipeline step at ``stage``: each of its
    layers runs forward, dQ and dK/dV once a microbatch; 1F1B runs the
    forward again in the backward (recompute), except at the last stage,
    whose forward slot is its backward slot's microbatch."""
    per = layers // stages * microbatches
    again = schedule == "1f1b" and stage < stages - 1
    return {"flash_fwd": per * (2 if again else 1), "flash_dq": per,
            "flash_dkv": per}


def phase_pp():
    """LlamaPipelineTrainer at world size 1 (module docstring, phase 8c)."""
    cfg = slice_config()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (PP_BATCH, S + 1))
    # The unsharded Trainer on the same batch.
    model = Llama(cfg, device=DEVICE,
                  generator=torch.Generator(device=DEVICE).manual_seed(0))
    trainer = Trainer(model=model, optimizer=adamw(3e-4), device=DEVICE)
    state, step = trainer.init(), trainer.make_train_step()
    reference, reference_norms = [], []
    for _ in range(PP_STEPS):
        state, metrics = step(state, {"inputs": tokens})
        reference.append(float(metrics["loss"]))
        reference_norms.append(float(metrics["grad_norm"]))
    del model, trainer, state, step
    gc.collect()
    torch.cuda.empty_cache()
    runs = {}
    with process_group_scope():
        mesh = make_mesh(MeshConfig(dp=-1, pp=1), device=DEVICE)

        def pipeline(schedule):
            return LlamaPipelineTrainer(cfg, mesh, adamw(3e-4),
                                        PP_MICROBATCHES, schedule=schedule,
                                        device=DEVICE)

        auto = pipeline("auto")
        for schedule in ("gpipe", "1f1b"):
            state = auto.init(generator=torch.Generator(
                device=DEVICE).manual_seed(0))
            if schedule == "gpipe":
                auto.make_train_step(state, sample_tokens=tokens)
            step = pipeline(schedule).make_train_step(state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            losses, norms, step_s = [], [], []
            for _ in range(PP_STEPS):
                t0 = time.perf_counter()
                state, metrics = step(state, tokens)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
            launches = dict(fa.LAUNCHES)
            steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
            rel = lambda xs, ys: max(abs(a - b) / abs(b)
                                     for a, b in zip(xs, ys))
            runs[schedule] = {
                "losses": losses, "grad_norms": norms, "launches": launches,
                "want_launches": counts(pp_launches(
                    schedule, 0, 1, cfg.n_layers, PP_MICROBATCHES), PP_STEPS),
                "max_rel_loss_vs_trainer": rel(losses, reference),
                "max_rel_grad_norm_vs_trainer": rel(norms, reference_norms),
                "step_ms": [t * 1e3 for t in step_s],
                "ms_per_step": steady * 1e3,
                "tokens_per_s": PP_BATCH * S / steady,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 2 ** 30}
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
        peak, budget = auto.probe
        choice = {"resolved": auto.resolved_schedule,
                  "probe_peak_gb": None if peak is None else peak / 2 ** 30,
                  "budget_gb": None if budget is None else budget / 2 ** 30}
        del auto, mesh
    emit({"phase": "pp", "nvidia_smi": nvidia_smi(), "layers": cfg.n_layers,
          "batch": PP_BATCH, "seq": S, "microbatches": PP_MICROBATCHES,
          "trainer_losses": reference, "trainer_grad_norms": reference_norms,
          "limit_rel": {"loss": PP_LOSS_RTOL, "grad_norm": PP_NORM_RTOL},
          "auto": choice, "schedules": runs})
    for schedule, r in runs.items():
        if r["launches"] != r["want_launches"]:
            raise AssertionError(f"pp {schedule}: kernel launches "
                                 f"{r['launches']} != {r['want_launches']}")
        if not (r["max_rel_loss_vs_trainer"] <= PP_LOSS_RTOL
                and r["max_rel_grad_norm_vs_trainer"] <= PP_NORM_RTOL):
            raise AssertionError(
                f"pp {schedule}: losses {r['losses']} and grad norms "
                f"{r['grad_norms']} vs the Trainer's {reference} and "
                f"{reference_norms}")
    if choice["resolved"] not in ("gpipe", "1f1b") or peak is None:
        raise AssertionError(f"auto made no probed choice: {choice}")
    return {n: sum(r["launches"][n] for r in runs.values())
            for n in fa.LAUNCHES}


def prefetch_stage_s(vocab: int) -> list:
    """Seconds prefetch_to_device takes to hand over a batch (and stage
    the next) while the card is busy: the copies are queued on a side
    stream, so the host must not wait for the card."""
    rng = np.random.default_rng(3)
    it = prefetch_to_device(({"inputs": rng.integers(0, vocab, (B, S + 1))}
                             for _ in range(4)), DEVICE)
    next(it)
    seconds = []
    for _ in range(3):
        torch.cuda._sleep(PREFETCH_SLEEP_CYCLES)
        t0 = time.perf_counter()
        next(it)
        seconds.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return seconds


def prefetch_ms(step, state, vocab: int) -> dict:
    """ms a step of run_train_steps on fresh host batches, without and
    with prefetch_device, in turns (host, prefetch, prefetch, host, host,
    prefetch)."""
    rng = np.random.default_rng(2)
    batches = [{"inputs": rng.integers(0, vocab, (B, S + 1))}
               for _ in range(PREFETCH_STEPS)]
    want = [int(b["inputs"].sum()) for b in batches]
    times = {"host": [], "prefetch": []}

    def checked(state, batch):
        # Each step must see its own batch (summed where the batch lies,
        # read after the timed run).
        sums.append(torch.as_tensor(batch["inputs"]).sum())
        return step(state, batch)

    for label in ("host", "prefetch", "prefetch", "host", "host",
                  "prefetch"):
        sums = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_train_steps(checked, state, iter(batches), PREFETCH_STEPS,
                        prefetch_device=DEVICE if label == "prefetch"
                        else None)
        torch.cuda.synchronize()
        times[label].append((time.perf_counter() - t0) * 1e3
                            / PREFETCH_STEPS)
        if [int(x) for x in sums] != want:
            raise AssertionError(f"{label}: the steps saw other batches")
    return times


def activation_gb(trainer, state, batch) -> dict:
    """Device memory one forward leaves for its backward (the tensors the
    remat policy keeps), and the peak of that forward and backward, both
    above the memory held before it (params, optimizer state)."""
    torch.cuda.synchronize()
    state.opt_state.zero_grad(set_to_none=True)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = trainer.loss_fn(state.model, trainer._to_device(batch))
    kept = torch.cuda.memory_allocated() - base
    loss.backward()
    peak = torch.cuda.max_memory_allocated() - base
    state.opt_state.zero_grad(set_to_none=True)
    return {"saved_for_backward_gb": kept / 2 ** 30,
            "fwd_bwd_peak_above_state_gb": peak / 2 ** 30}


def phase_remat(batch, full):
    """Each remat policy against full's first 3 train-phase steps (module
    docstring, phase 9); full again, as the run-to-run check."""
    card = nvidia_smi()
    policies = {}
    for policy in tllama.REMAT_POLICIES:
        cfg = dataclasses.replace(slice_config(), remat_policy=policy)
        model = Llama(cfg, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(0))
        trainer = Trainer(model=model, optimizer=adamw(3e-4), device=DEVICE)
        state = trainer.init()
        step = trainer.make_train_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        losses, step_s = [], []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        params = cpu_params(model)
        diff = max((params[n] - p).abs().max().item()
                   for n, p in full["params"].items())
        result = {
            "losses": losses, "step_ms": [t * 1e3 for t in step_s],
            "ms_per_step": sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3,
            "max_memory_allocated_gb": peak,
            "launches_per_step": {n: c / REMAT_STEPS
                                  for n, c in launches.items()},
            "max_abs_param_diff_vs_full": diff,
            "max_rel_loss_diff_vs_full": max(
                abs(a - b) / abs(b) for a, b in zip(losses, full["losses"])),
            "bit_equal_to_full": losses == full["losses"] and all(
                torch.equal(params[n], p) for n, p in full["params"].items())}
        profiled = profile_step(step, state, batch)
        result.update(device_busy_ms=profiled["device_busy_ms"],
                      idle_share=profiled["idle_share"],
                      device_ms_by_class=profiled["by_class_ms"],
                      **activation_gb(trainer, state, batch))
        if policy == "save_attn":
            result["prefetch_ms_per_step"] = prefetch_ms(
                step, state, cfg.vocab_size)
            result["prefetch_handover_s_card_busy"] = prefetch_stage_s(
                cfg.vocab_size)
        policies[policy] = result
        del model, trainer, state, step, params
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "remat", "nvidia_smi": card, "steps": REMAT_STEPS,
          "limits": {"param_atol": REMAT_ATOL, "loss_rtol": REMAT_ATOL},
          "policies": policies})
    handover = policies["save_attn"]["prefetch_handover_s_card_busy"]
    if max(handover) > PREFETCH_MAX_HANDOVER_S:
        raise AssertionError(f"prefetch_to_device waited for the busy card: "
                             f"{handover} s")
    for policy, r in policies.items():
        per_step = PER_STEP if policy == "full" else REMAT_PER_STEP
        want = counts(per_step, REMAT_STEPS)
        got = {n: c * REMAT_STEPS for n, c in r["launches_per_step"].items()}
        if got != want:
            raise AssertionError(f"{policy}: kernel launches {got} != {want}")
        if (r["max_abs_param_diff_vs_full"] > REMAT_ATOL
                or r["max_rel_loss_diff_vs_full"] > REMAT_ATOL):
            raise AssertionError(f"{policy} differs from full: {r}")


# ---------------------------------------------------------------------------
# The serving path: decode check, serve, worker
# ---------------------------------------------------------------------------

def decode_config(dtype, decode: bool):
    return dataclasses.replace(llama_3_8b(), n_layers=2, remat=False,
                               attention_impl="xla", dtype=dtype,
                               decode=decode)


def seeded_llama(cfg):
    """The same weights for every config of one shape (seed 0)."""
    return Llama(cfg, device="cuda",
                 generator=torch.Generator(device="cuda").manual_seed(0))


def no_cache_logits(dtype, tokens):
    model = seeded_llama(decode_config(dtype, decode=False))
    with torch.no_grad():
        out = model(tokens).float()
    del model
    torch.cuda.empty_cache()
    return out


def cached_logits(model, tokens, other, skip_insert=None, lib=tllama):
    """Per slot, its logits at positions 0 .. n + DECODE_STEPS - 1: the
    prefill's for its prompt of n = DECODE_LENS[slot] tokens, then one
    decode_step's per position. Both slots first hold ``other`` (an
    earlier occupant), so rows a slot fails to overwrite are wrong, not
    zero; the 1-row staging cache is reused without zeroing, as the runner
    does. ``skip_insert``: a slot whose insert_cache is left out. ``lib``:
    the model family's decode helpers (models/llama.py or mixtral.py)."""
    cache, stage = lib.init_cache(model, 2), lib.init_cache(model, 1)
    arange = lambda n: torch.arange(n, device=DEVICE)[None]
    _, stage = lib.prefill(model, stage, other, arange(other.shape[1]))
    for slot in range(2):
        lib.insert_cache(cache, stage, slot)
    outs = []
    for slot, n in enumerate(DECODE_LENS):
        logits, stage = lib.prefill(model, stage,
                                    tokens[slot:slot + 1, :n], arange(n))
        outs.append([logits[0].float()])
        if slot != skip_insert:
            lib.insert_cache(cache, stage, slot)
    lens = torch.tensor(DECODE_LENS, device=DEVICE)
    rows = torch.arange(2, device=DEVICE)
    for t in range(DECODE_STEPS):
        pos = lens + t
        logits, cache = lib.decode_step(
            model, cache, tokens[rows, pos][:, None], pos[:, None])
        for slot in range(2):
            outs[slot].append(logits[slot].float())
    return torch.cat([torch.cat(o) for o in outs])


def phase_decode():
    """The KV-cache path against the no-cache forward of the same weights
    (module docstring, phase 10)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start_gb = torch.cuda.memory_allocated() / 2 ** 30
    vocab = llama_3_8b().vocab_size
    rng = np.random.default_rng(1)
    seq = max(DECODE_LENS) + DECODE_STEPS
    tokens = torch.as_tensor(rng.integers(0, vocab, (2, seq)), device="cuda")
    other = torch.as_tensor(rng.integers(0, vocab, (1, seq)), device="cuda")
    truth = no_cache_logits(torch.float32, tokens)
    want = torch.cat([truth[slot, :n + DECODE_STEPS]
                      for slot, n in enumerate(DECODE_LENS)])

    model = seeded_llama(decode_config(torch.float32, decode=True))
    params = sum(p.numel() for p in model.parameters())
    f32 = check("logits", cached_logits(model, tokens, other), want,
                rel=DECODE_REL, tol=DECODE_REL)
    write_rows = tllama._write_rows
    wrong = {}
    with mock.patch.object(tllama, "_visible", lambda k_pos, positions:
                           k_pos[None, None, :] < positions[:, :, None]):
        wrong["mask_off_by_one"] = cached_logits(model, tokens, other)
    with mock.patch.object(tllama, "_write_rows", lambda cache, new, pos:
                           write_rows(cache, new, pos + 1)):
        wrong["kv_written_one_row_late"] = cached_logits(model, tokens, other)
    wrong["slot_stale_after_insert"] = cached_logits(model, tokens, other,
                                                     skip_insert=1)
    caught = {name: check("logits", got, want, rel=DECODE_REL,
                          tol=DECODE_REL)["ratio"]
              for name, got in wrong.items()}
    del model, wrong
    torch.cuda.empty_cache()

    model = seeded_llama(decode_config(torch.bfloat16, decode=True))
    cached_bf16 = cached_logits(model, tokens, other)
    del model
    torch.cuda.empty_cache()
    plain = no_cache_logits(torch.bfloat16, tokens)
    plain_bf16 = torch.cat([plain[slot, :n + DECODE_STEPS]
                            for slot, n in enumerate(DECODE_LENS)])
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    cached_err, plain_err = rel(cached_bf16, want), rel(plain_bf16, want)
    emit({"phase": "decode", "layers": 2, "params": params,
          "memory_allocated_gb_at_start": start_gb,
          "slot_prompts": list(DECODE_LENS), "decode_steps": DECODE_STEPS,
          "max_seq_len": llama_3_8b().max_seq_len,
          "f32": {"max_abs_err": f32["max_abs_err"],
                  "limit": {"atol": f32["atol"], "rtol": DECODE_REL,
                            "rel_l2": DECODE_REL},
                  "rel_l2": f32["rel_l2"], "ratio": f32["ratio"]},
          "perturbed_ratio": caught,
          "bf16": {"rel_l2_cached_vs_f32": cached_err,
                   "rel_l2_no_cache_vs_f32": plain_err,
                   "finite": bool(torch.isfinite(cached_bf16).all())}})
    if not f32["ok"]:
        raise AssertionError(f"cached f32 logits off the no-cache forward: "
                             f"ratio {f32['ratio']}")
    missed = [name for name, ratio in caught.items() if ratio <= 1.0]
    if missed:
        raise AssertionError(f"the decode check accepts wrong caches: "
                             f"{missed}")
    if (not torch.isfinite(cached_bf16).all()
            or cached_err > 1.25 * plain_err):
        raise AssertionError(
            f"bf16 cached logits further from the f32 forward ({cached_err})"
            f" than 1.25x the bf16 no-cache forward's ({plain_err})")


def matmul_params(model) -> int:
    """Parameters that enter a matmul: every weight of two or more dims
    (Dense weights, Mixtral's expert tensors) but the embedding table,
    which is a lookup."""
    return sum(p.numel() for n, p in model.named_parameters()
               if p.dim() >= 2 and "embed" not in n)


def decode_step_bytes(runner):
    """Reckoned bytes of one decode step over all slots: (floor, as the
    port moves them). The floor reads every matmul weight once in f32 and
    the whole K/V cache once in bf16. The port also writes and reads a
    bf16 copy of each weight (Dense casts on every call) and, per layer,
    an f32 copy of the K cache (f32 scores, as ops.layers.attention)."""
    weights = matmul_params(runner.model)
    kv = runner.cache["k"].numel()
    return 4 * weights + 2 * 2 * kv, 8 * weights + (2 + 4 + 4 + 2) * kv


def prefill_bound_ms(runner, size: int) -> float:
    """Reckoned least time of one prefill of ``size`` tokens: the matmuls
    at the bf16 tensor-core peak, plus the f32 scores and weighted sums
    over the whole cache (4 D FLOPs per query, key and head) at the f32
    peak of 67 TFLOP/s (TF32 off)."""
    cfg = runner.config
    weights = matmul_params(runner.model)
    attn = 4 * cfg.head_dim * size * cfg.max_seq_len * cfg.n_heads
    return (2 * weights * size / PEAK_BF16
            + attn * cfg.n_layers / 67e12) * 1e3


def profile_decode(runner, lengths):
    """One decode step under torch.profiler: device busy time, idle share,
    and device time by class. Kernels inside the device-side range of the
    cached attention (annotated here with record_function) are its class;
    inside a Mixtral MoE layer's range, MoE matmul or MoE casts/routing
    (chiefly the f32 -> bf16 expert-weight casts); of the rest, cuBLAS
    GEMMs are matmul and all else casts/elementwise (chiefly the f32 ->
    bf16 weight casts)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    orig = tllama.LlamaAttention._cached_attention
    moe_orig = tmix.MoELayer.forward

    def annotated(self, *args):
        with record_function("cached_attention"):
            return orig(self, *args)

    def moe_annotated(self, *args):
        with record_function("moe_layer"):
            return moe_orig(self, *args)

    last = [1] * len(lengths)
    runner.decode(last, lengths)
    torch.cuda.synchronize()
    with mock.patch.object(tllama.LlamaAttention, "_cached_attention",
                           annotated), \
            mock.patch.object(tmix.MoELayer, "forward", moe_annotated), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.decode(last, lengths)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    ranges = {name: [(ev.time_range.start, ev.time_range.end)
                     for ev in device
                     if ev.is_user_annotation and ev.name == name]
              for name in ("cached_attention", "moe_layer")}
    inside = lambda ev, name: any(a <= ev.time_range.start < b
                                  for a, b in ranges[name])
    by_class, top, kernels = {}, {}, 0
    for ev in device:
        if ev.is_user_annotation:
            continue
        kernels += 1
        matmul = kernel_class(ev.name) == "matmul (cuBLAS)"
        if inside(ev, "cached_attention"):
            cls = "attention (cached, GQA einsums, softmax, cache writes)"
        elif inside(ev, "moe_layer"):
            cls = ("moe matmul (router, dispatch, experts)" if matmul
                   else "moe casts/routing/elementwise")
        elif matmul:
            cls = "matmul (cuBLAS)"
        else:
            cls = "casts/elementwise"
        ms = ev.time_range.elapsed_us() / 1e3
        by_class[cls] = by_class.get(cls, 0.0) + ms
        top.setdefault(cls, {})
        top[cls][ev.name[:80]] = top[cls].get(ev.name[:80], 0.0) + ms
    busy = sum(by_class.values())
    top = {cls: sorted(names.items(), key=lambda kv: -kv[1])[:3]
           for cls, names in top.items()}
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if busy else None,
            "kernels": kernels,
            "attention_ranges": len(ranges["cached_attention"]),
            "moe_ranges": len(ranges["moe_layer"]),
            "by_class_ms": by_class,
            "top_kernels_ms": top}


def registry_counts() -> dict:
    """The serving series of the operator's registry that a run must
    raise: TTFT observations and completed requests."""
    return {"ttft_count": registry.serving_ttft_seconds.count_value(),
            "completed": registry.serving_requests_total.value(
                outcome="completed")}


def registry_rise(before: dict) -> dict:
    """The rise of ``registry_counts`` since ``before`` and the registry's
    TTFT p99 (over every observation of this process: the figure the
    autoscaler reads)."""
    after = registry_counts()
    return {"registry_rise": {k: after[k] - before[k] for k in after},
            "registry_ttft_p99_s":
                registry.serving_ttft_seconds.quantile(0.99)}


def check_rise(counts: dict, requests: int) -> None:
    """Each series must have risen by exactly ``requests``."""
    want = {"ttft_count": requests, "completed": requests}
    if counts["registry_rise"] != want:
        raise AssertionError(f"the registry rose by "
                             f"{counts['registry_rise']}, want {want}")


def serve_requests(runner) -> dict:
    """SERVE_PROMPTS through RequestQueue (tenants a:b = 2:1),
    ContinuousBatcher and ServingEngine.run_until_idle on ``runner``:
    TTFT, prefill ms per bucket, decode ms per step, tokens/s and the
    flash launches (which must read 0: decode runs no flash kernel). Every
    request must finish to budget with in-vocabulary tokens and finite
    logits, and count once into the registry's TTFT and completed
    series."""
    cfg = runner.config
    prefill_ms, decode_ms = {}, []
    prefill, decode = runner.prefill, runner.decode

    def timed_prefill(prompt, slot):
        t = time.perf_counter()
        token = prefill(prompt, slot)       # int(): waits for the card
        prefill_ms.setdefault(runner._bucket(len(prompt)), []).append(
            (time.perf_counter() - t) * 1e3)
        return token

    def timed_decode(last_tokens, lengths):
        t = time.perf_counter()
        tokens = decode(last_tokens, lengths)   # .tolist(): waits
        decode_ms.append((time.perf_counter() - t) * 1e3)
        return tokens

    runner.prefill, runner.decode = timed_prefill, timed_decode
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)

    def all_finite(module, args, out):
        finite.logical_and_(torch.isfinite(out).all())   # no host sync

    hook = runner.model.lm_head.register_forward_hook(all_finite)
    queue = RequestQueue(tenant_weights={"a": 2, "b": 1})
    engine = ServingEngine(queue, ContinuousBatcher(runner))
    rng = np.random.default_rng(0)
    requests = [Request(id=f"req{i}", tenant="ab"[i % 2],
                        prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                        max_new_tokens=SERVE_NEW_TOKENS)
                for i, n in enumerate(SERVE_PROMPTS)]
    for request in requests:
        queue.submit(request)
    fa.reset_launches()
    counted = registry_counts()
    t0 = time.perf_counter()
    done = engine.run_until_idle()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    counts = registry_rise(counted)
    hook.remove()
    runner.prefill, runner.decode = prefill, decode
    generated = sum(len(r.output) for r in done)
    record = {
        "layers": cfg.n_layers,
        "params": sum(p.numel() for p in runner.model.parameters()),
        "max_seq_len": cfg.max_seq_len, "slots": SERVE_SLOTS,
        "requests": [{"id": r.id, "tenant": r.tenant,
                      "prompt": len(r.prompt), "tokens": len(r.output),
                      "ttft_s": r.ttft_seconds,
                      "outcome": r.outcome} for r in requests],
        "prefill_ms_by_bucket": prefill_ms,
        "decode_steps": len(decode_ms),
        "decode_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
        "decode_ms_min": min(decode_ms), "decode_ms_max": max(decode_ms),
        "generated_tokens": generated, "wall_s": wall_s,
        "tokens_per_s": generated / wall_s, **counts,
        "max_memory_allocated_gb":
            torch.cuda.max_memory_allocated() / 2 ** 30,
        "flash_launches": launches}
    bad = [r.id for r in requests
           if r.outcome != "completed" or len(r.output) != SERVE_NEW_TOKENS
           or not all(0 <= t < cfg.vocab_size for t in r.output)]
    if bad or len(done) != len(requests):
        raise AssertionError(f"requests not served to budget with "
                             f"in-vocabulary tokens: {bad}")
    if not bool(finite):
        raise AssertionError("non-finite logits on the serve path")
    if any(launches.values()):
        raise AssertionError(f"the serve path launched flash kernels: "
                             f"{launches}")
    check_rise(counts, len(requests))
    return record


def phase_serve():
    """LlamaRunner at full llama_3_8b through the engine (module
    docstring, phase 11)."""
    card = nvidia_smi()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = LlamaRunner(config=llama_3_8b(), max_slots=SERVE_SLOTS,
                         device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    record = serve_requests(runner)
    emit({"phase": "serve", "nvidia_smi": card, "build_s": build_s,
          **record,
          "prefill_bound_ms_by_bucket": {
              b: prefill_bound_ms(runner, b)
              for b in record["prefill_ms_by_bucket"]}})
    lengths = [n + SERVE_NEW_TOKENS + 1 for n in SERVE_PROMPTS[-SERVE_SLOTS:]]
    floor, port = decode_step_bytes(runner)
    emit({"phase": "serve_profile", "nvidia_smi": card,
          "slots": SERVE_SLOTS, "lengths": lengths,
          **profile_decode(runner, lengths),
          "reckoned_bytes": {"floor": floor, "port": port,
                             "floor_ms": floor / PEAK_BYTES * 1e3,
                             "port_ms": port / PEAK_BYTES * 1e3}})
    del runner
    torch.cuda.empty_cache()


def phase_worker():
    """The serving worker with the llama runner on the card over a spool of
    3 requests and the .close sentinel (module docstring, phase 12)."""
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="serve-spool-", dir=build) as root:
        os.makedirs(os.path.join(root, "pending"))
        for i in range(3):
            with open(os.path.join(root, "pending", f"w{i}.json"), "w") as f:
                json.dump({"id": f"w{i}", "tenant": "t",
                           "prompt": [1 + i, 2, 3 + i], "maxNewTokens": 8}, f)
        open(os.path.join(root, worker.CLOSE_SENTINEL), "w").close()
        counted = registry_counts()
        t0 = time.perf_counter()
        rc = worker.main(["--runner", "llama", "--spool", root,
                          "--poll-interval", "0.001"])
        seconds = time.perf_counter() - t0
        counts = registry_rise(counted)
        responses = {}
        for name in sorted(os.listdir(os.path.join(root, "done"))):
            with open(os.path.join(root, "done", name)) as f:
                responses[name] = json.load(f)["tokens"]
    emit({"phase": "worker", "rc": rc, "seconds": seconds,
          "responses": responses, **counts})
    if rc != 0 or len(responses) != 3:
        raise AssertionError(f"serving worker returned {rc} with "
                             f"{len(responses)} responses, want 0 and 3")
    check_rise(counts, 3)


def mnist_params(directory: str, step: int) -> dict:
    """Parameters of the MNIST payload's checkpoint at ``step``."""
    model = MnistCNN(device=DEVICE)
    state = Trainer(model=model, optimizer=adam(1e-3), device=DEVICE).init()
    ckpt = Checkpointer(directory)
    ckpt.restore(state, step=step)
    ckpt.close()
    return cpu_params(model)


def phase_resume(root):
    """The MNIST payload crashes, resumes and is held against an
    uninterrupted run (module docstring, phase 13)."""
    command = [sys.executable, "-m", "tf_operator_tpu_torch.train.dist_mnist",
               "--steps", "6"]
    resumed_dir = os.path.join(root, "resumed")
    straight_dir = os.path.join(root, "straight")
    crash = ["--checkpoint-dir", resumed_dir, "--crash-at-step", "3"]

    def start(args):
        return args, time.perf_counter(), subprocess.Popen(
            command + args + ["--device", DEVICE], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(started):
        args, t0, proc = started
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode not in (0, 137):
            raise AssertionError(f"dist_mnist {args} exited "
                                 f"{proc.returncode}: {err[-2000:]}")
        return {"args": args, "rc": proc.returncode,
                "seconds": time.perf_counter() - t0,
                "stdout": out.splitlines()}

    # The uninterrupted run needs nothing of the other two: it runs
    # beside the crash and the resume.
    uninterrupted = start(["--checkpoint-dir", straight_dir])
    runs = []
    try:
        runs += [finish(start(crash)), finish(start(crash))]
    finally:
        runs.append(finish(uninterrupted))
    resumed = mnist_params(resumed_dir, 6)
    straight = mnist_params(straight_dir, 6)
    one_short = mnist_params(straight_dir, 5)
    diff = max((resumed[n] - p).abs().max().item()
               for n, p in straight.items())
    wrong = max((resumed[n] - p).abs().max().item()
                for n, p in one_short.items())
    emit({"phase": "resume", "runs": runs,
          "rcs": [r["rc"] for r in runs], "limit": RESUME_ATOL,
          "max_abs_param_diff_vs_uninterrupted": diff,
          "max_abs_param_diff_vs_step_5": wrong})
    crashed, again, _ = (r["stdout"] for r in runs)
    if [r["rc"] for r in runs] != [137, 0, 0]:
        raise AssertionError(f"dist_mnist exit codes "
                             f"{[r['rc'] for r in runs]} != [137, 0, 0]")
    if ("injected crash at step 3" not in crashed
            or "resumed from checkpoint at step 3" not in again
            or not any(line.startswith("done:") for line in again)):
        raise AssertionError(f"dist_mnist did not crash at step 3 and "
                             f"resume there: {crashed} {again}")
    if not diff <= RESUME_ATOL < wrong:
        raise AssertionError(
            f"resumed step-6 parameters {diff} from the uninterrupted run "
            f"(limit {RESUME_ATOL}); its step 5 is {wrong} away")

# ---------------------------------------------------------------------------
# ResNet-50 training
# ---------------------------------------------------------------------------

def _spread_frac(values) -> float:
    s = sorted(values)
    median = s[len(s) // 2]
    return (s[-1] - s[0]) / median if median else 0.0


def _stablest_subset(times, k):
    return min(itertools.combinations(range(len(times)), k),
               key=lambda idx: _spread_frac([times[i] for i in idx]))


def collect_reps(run_block, base_reps: int = 3):
    """bench.py's outlier-rep guard (bench.py:57-82): ``base_reps`` timed
    blocks, up to MAX_EXTRA_REPS more while no ``base_reps`` of them agree
    within SPREAD_THRESHOLD; (the stablest ``base_reps``, the rest)."""
    times = [run_block() for _ in range(base_reps)]
    for _ in range(MAX_EXTRA_REPS):
        kept = _stablest_subset(times, base_reps)
        if _spread_frac([times[i] for i in kept]) <= SPREAD_THRESHOLD:
            break
        times.append(run_block())
    kept = set(_stablest_subset(times, base_reps))
    return ([times[i] for i in sorted(kept)],
            [times[i] for i in range(len(times)) if i not in kept])


def resnet_kernel_class(name: str) -> str:
    n = name.lower()
    if "multi_tensor_apply" in n:
        return "optimizer (foreach SGD)"
    if "pool" in n:
        return "max pool"
    # cuDNN runs some 1x1 convolutions as GEMMs (cutlass, nvjet); the
    # classifier's GEMMs are a few microseconds of this class.
    if any(t in n for t in ("conv", "xmma", "implicit_gemm", "fprop",
                            "dgrad", "wgrad", "cudnn", "winograd", "fft",
                            "gemm", "nvjet", "cutlass")):
        return "convolution (cuDNN, with its GEMMs)"
    if "memcpy" in n or "memset" in n:
        return "memcpy and memset"
    if "reduce" in n:
        return "reductions (BN statistics, head mean; their backward)"
    if "copy" in n:
        return "casts and copies"
    if "elementwise" in n:
        return "elementwise (BN affine, ReLU, residual; their backward)"
    return "other"


def resnet_check_config():
    return dataclasses.replace(resnet.resnet50(stem="s2d"),
                               dtype=torch.float32)


def randomize_norms(model, gen):
    """Norm scales, biases and running statistics drawn away from their
    initial values, so that every branch (bn3 starts at scale 0) and the
    running update's old values enter the check."""
    with torch.no_grad():
        for name, value in model.state_dict().items():
            leaf = name.rsplit(".", 1)[1]
            if value.ndim != 1 or name.startswith("classifier"):
                continue
            noise = torch.randn(value.shape, generator=gen,
                                device=value.device)
            if leaf == "scale":
                value.copy_(1 + 0.3 * noise)
            elif leaf in ("bias", "mean"):
                value.copy_(0.1 * noise)
            elif leaf == "var":
                value.copy_(1 + 0.5 * noise.abs())


def scaled_err(got, want) -> float:
    """max |got - want| over max |want|, both on the host."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def resnet_outputs(model, x):
    """(logits, {buffer: value}, {BN layer: values a channel}) of one
    training-mode forward."""
    counts, hooks = {}, []
    for name, module in model.named_modules():
        if isinstance(module, TPUBatchNorm):
            hooks.append(module.register_forward_hook(
                lambda m, args, out, name=name: counts.__setitem__(
                    name, args[0].numel() // args[0].shape[1])))
    model.train()
    with torch.no_grad():
        logits = model(x)
    for h in hooks:
        h.remove()
    return logits, {n: b.clone() for n, b in model.named_buffers()}, counts


def phase_resnet_check():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    # The two stems on the same 7x7 weights.
    x = torch.randn(RESNET_CHECK_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3,
                    generator=gen, device=DEVICE)
    w7 = torch.randn(resnet_check_config().width, 3, 7, 7, generator=gen,
                     device=DEVICE) * 0.1
    stems = {}
    for stem in resnet.STEMS:
        model = resnet.ResNet(dataclasses.replace(resnet_check_config(),
                                                  stem=stem), device=DEVICE)
        stems[stem] = model.stem_conv_s2d if stem == "s2d" else \
            model.stem_conv
    # A wrong weight map: the 7x7 taps shifted by one, as when the 8x8
    # kernel is zero-padded after the taps instead of before.
    shifted = torch.nn.functional.pad(w7, (0, 1, 0, 1))[..., 1:, 1:]
    with torch.no_grad():
        stems["conv7"].weight.copy_(w7)
        want = stems["conv7"](x.permute(0, 3, 1, 2))
        s2d_in = resnet.space_to_depth(x).permute(0, 3, 1, 2)
        stem_errs = {}
        for label, w in (("s2d", w7), ("perturbed_taps_shifted", shifted)):
            stems["s2d"].weight.copy_(resnet.s2d_stem_kernel_oihw(w))
            stem_errs[label] = scaled_err(stems["s2d"](s2d_in), want)
    del stems, model

    # ResNet-50 on the card against the CPU on the same weights and batch.
    cfg = resnet_check_config()
    card = resnet.ResNet(cfg, device=DEVICE, generator=gen)
    randomize_norms(card, gen)
    cpu = resnet.ResNet(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    old = {k: v.to("cpu", copy=True) for k, v in card.named_buffers()}
    batch = resnet.synthetic_batch(gen, RESNET_CHECK_BATCH, RESNET_IMAGE,
                                   cfg.num_classes)
    got_logits, got_buffers, _ = resnet_outputs(card, batch["inputs"])
    want_logits, want_buffers, counts = resnet_outputs(
        cpu, batch["inputs"].cpu())

    def errors(logits, buffers):
        errs = {"logits": scaled_err(got_logits, logits)}
        errs["buffers"] = max(scaled_err(got_buffers[k], v)
                              for k, v in buffers.items())
        return errs

    # Perturbed plain versions, which the check must reject: the CPU model
    # from the same buffers again with symmetric padding, and the running
    # statistics of an unbiased variance or of momentum 0.1 worked out
    # from the batch statistics of its update.
    cpu.load_state_dict(old, strict=False)
    symmetric = lambda size, kernel, stride: ((kernel - 1) // 2,) * 2
    with mock.patch.object(resnet, "same_padding", symmetric):
        sym_logits, sym_buffers, _ = resnet_outputs(cpu,
                                                    batch["inputs"].cpu())
    unbiased, momentum_01 = {}, {}
    for name, new in want_buffers.items():
        layer, leaf = name.rsplit(".", 1)
        batch_stat = (new - 0.9 * old[name]) / 0.1
        n = counts[layer]
        unbiased[name] = (0.9 * old[name] + 0.1 * batch_stat * n / (n - 1)
                          if leaf == "var" else new)
        momentum_01[name] = 0.1 * old[name] + 0.9 * batch_stat
    checks = {"card_vs_cpu": errors(want_logits, want_buffers),
              "perturbed_symmetric_padding": errors(sym_logits, sym_buffers),
              "perturbed_unbiased_running_var": errors(want_logits, unbiased),
              "perturbed_momentum_0.1": errors(want_logits, momentum_01)}
    emit({"phase": "resnet_check", "dtype": "float32", "tf32": False,
          "batch": RESNET_CHECK_BATCH, "image": RESNET_IMAGE,
          "limit": RESNET_REL, "stem_errs": stem_errs,
          "smallest_bn_count": min(counts.values()),
          "finite": bool(torch.isfinite(got_logits).all()),
          "errs": checks})
    del card, cpu
    torch.cuda.empty_cache()
    if not stem_errs["s2d"] <= RESNET_REL < stem_errs[
            "perturbed_taps_shifted"]:
        raise AssertionError(f"s2d stem against conv7: {stem_errs} "
                             f"(limit {RESNET_REL})")
    if not all(e <= RESNET_REL for e in checks["card_vs_cpu"].values()):
        raise AssertionError(f"ResNet-50 on the card against the CPU: "
                             f"{checks['card_vs_cpu']} (limit {RESNET_REL})")
    missed = [p for p, errs in checks.items() if p.startswith("perturbed")
              and all(e <= RESNET_REL for e in errs.values())]
    if missed:
        raise AssertionError(f"the ResNet check accepts {missed}")


def resnet_step_setup():
    """bench.py's benchmarked program: ResNet-50 (s2d, bf16), sgd(0.1,
    0.9), classification_loss, no grad norm, one resident bf16 batch."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = resnet.ResNet(resnet.resnet50(stem="s2d"), device=DEVICE,
                          generator=gen)
    trainer = Trainer(model=model, optimizer=sgd(0.1, momentum=0.9),
                      loss_fn=classification_loss, device=DEVICE,
                      grad_norm_metric=False)
    batch = resnet.synthetic_batch(gen, RESNET_BATCH, RESNET_IMAGE,
                                   model.cfg.num_classes)
    batch["inputs"] = batch["inputs"].to(torch.bfloat16)
    return model, trainer, batch


def phase_resnet():
    """The main measurement and its correctness (module docstring,
    phase 14); returns what the later ResNet phases reuse."""
    model, trainer, batch = resnet_step_setup()
    state = trainer.init()
    step = trainer.make_train_step()
    block = trainer.make_train_step(steps_per_call=RESNET_BLOCK_STEPS)
    before = {k: v.clone() for k, v in model.named_buffers()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    losses, warm_s = [], []
    for _ in range(RESNET_WARMUP):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        warm_s.append(time.perf_counter() - t0)
    block_losses = []

    def run_block() -> float:
        nonlocal state
        t0 = time.perf_counter()
        state, m = block(state, batch)
        block_losses.append(float(m["loss"]))
        return time.perf_counter() - t0

    times, discarded = collect_reps(run_block)
    rates = sorted(RESNET_BATCH * RESNET_BLOCK_STEPS / t for t in times)
    median = rates[len(rates) // 2]
    changed = sum(not torch.equal(v, before[k])
                  for k, v in model.named_buffers())
    record = {
        "phase": "resnet", "nvidia_smi": nvidia_smi(),
        "config": {"model": "resnet50", "stem": "s2d", "batch": RESNET_BATCH,
                   "image": RESNET_IMAGE, "dtype": "bfloat16",
                   "optimizer": "sgd(0.1, momentum=0.9)",
                   "steps_per_block": RESNET_BLOCK_STEPS},
        "params": sum(p.numel() for p in model.parameters()),
        "images_per_s": median, "images_per_s_reps": rates,
        "spread_frac": _spread_frac(rates),
        "discarded_block_s": discarded, "block_s": times,
        "ms_per_step": RESNET_BATCH / median * 1e3,
        "mfu_vs_989_tflops": median * RESNET_TRAIN_FLOPS_PER_IMAGE
        / PEAK_BF16,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "allocated_at_start_gb": at_start / 2 ** 30,
        "warmup_step_s": warm_s, "losses": losses + block_losses,
        "buffers_changed": changed, "buffers": len(before)}
    emit(record)
    all_losses = record["losses"]
    if not all(math.isfinite(x) for x in all_losses):
        raise AssertionError(f"non-finite ResNet loss: {all_losses}")
    if not all_losses[-1] < all_losses[0]:
        raise AssertionError(f"ResNet loss did not fall: {all_losses}")
    if changed != len(before):
        raise AssertionError(f"{len(before) - changed} of {len(before)} "
                             "BatchNorm buffers did not change")
    prof = profile_step(step, state, batch, resnet_kernel_class)
    # The profiler slows the host's launches, which stretches the profiled
    # step's wall; against the host-timed step the idle share is smaller.
    prof["idle_share_vs_host_timed_step"] = (
        1.0 - prof["device_busy_ms"] / record["ms_per_step"])
    emit({"phase": "resnet_profile", **prof})
    return model, trainer, state, batch, median


def phase_resnet_frozen(model, trainer, state, batch):
    """classification_loss_frozen_stats: buffers bit-equal, parameters
    moved."""
    frozen = dataclasses.replace(
        trainer, loss_fn=classification_loss_frozen_stats).make_train_step()
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    weight = model.stem_conv_s2d.weight.detach().clone()
    step_s, losses = [], []
    for _ in range(RESNET_FROZEN_STEPS):
        t0 = time.perf_counter()
        state, metrics = frozen(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
    kept = all(torch.equal(v, buffers[k]) for k, v in model.named_buffers())
    moved = not torch.equal(model.stem_conv_s2d.weight, weight)
    emit({"phase": "resnet_frozen", "steps": RESNET_FROZEN_STEPS,
          "losses": losses, "step_ms": [t * 1e3 for t in step_s],
          "buffers_bit_equal": kept, "params_moved": moved})
    if not (kept and moved and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"frozen-statistics step: buffers kept {kept}, "
                             f"parameters moved {moved}, losses {losses}")
    return state


def phase_resnet_pipeline(trainer, state):
    """Fresh batches from the native loader, one step each: through
    prefetch_to_device as bench.py's TPU_BENCH_DATA_PIPELINE mode (the
    loader's copy-out and the pinned copy on the training thread), then
    through DeviceFeeder (the same copies on a thread of their own)."""
    step = trainer.make_train_step()
    num_classes = trainer.model.cfg.num_classes
    arms = {}
    for arm in ("prefetch_to_device", "device_feeder"):
        with images_pipeline(RESNET_BATCH, RESNET_IMAGE,
                             num_classes) as loader:
            if arm == "prefetch_to_device":
                fed = prefetch_to_device(loader, DEVICE, depth=2)
            else:
                fed = DeviceFeeder(loader, DEVICE, prefetch=2)
            try:
                for _ in range(2):
                    state, metrics = step(state, next(fed))
                float(metrics["loss"])
                t0 = time.perf_counter()
                losses = []
                for _ in range(RESNET_PIPELINE_STEPS):
                    state, metrics = step(state, next(fed))
                    losses.append(metrics["loss"])
                losses = [float(x) for x in losses]
                seconds = time.perf_counter() - t0
            finally:
                if arm == "device_feeder":
                    fed.stop()
        arms[arm] = {"images_per_s": RESNET_BATCH * RESNET_PIPELINE_STEPS
                     / seconds,
                     "ms_per_step": seconds / RESNET_PIPELINE_STEPS * 1e3,
                     "losses": losses}
    emit({"phase": "resnet_pipeline", "steps": RESNET_PIPELINE_STEPS,
          **arms})
    bad = [a for a, r in arms.items()
           if not all(math.isfinite(x) for x in r["losses"])]
    if bad:
        raise AssertionError(f"non-finite loss on fed batches: {bad}")
    return state


def phase_resnet_all():
    # What earlier phases left unreachable (34.9 GiB in one run) would
    # otherwise sit under the ResNet's peak.
    gc.collect()
    torch.cuda.empty_cache()
    phase_resnet_check()
    model, trainer, state, batch, _ = phase_resnet()
    state = phase_resnet_pipeline(trainer, state)
    # Last: steps on stale running statistics at lr 0.1 drive the loss up.
    state = phase_resnet_frozen(model, trainer, state, batch)
    del model, trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Mixtral (models/mixtral.py): check, training, serving, payload
# ---------------------------------------------------------------------------

MIXTRAL_TRAIN_LAYERS = 2
MIXTRAL_STEPS = 5
MIXTRAL_LR = 1e-4
# Flash launches a step at 2 layers under full remat: the forward kernel
# twice a layer (forward, recompute), the two backward kernels once.
MIXTRAL_PER_STEP = {"flash_fwd": 4, "flash_dq": 2, "flash_dkv": 2}
# The two dispatch paths' losses (tests/test_moe_dispatch.py's rtol).
MIXTRAL_LOSS_RTOL = 5e-3
MIXTRAL_SERVE_LAYERS = 8
# Card (f32, TF32 off) against CPU on mixtral_tiny: each MoE output within
# 1e-5 of its largest value (sums of at most 128 f32 products in another
# order), aux within 1e-6; a zeroed expert moves outputs by their scale.
MIXTRAL_CHECK_REL = 1e-5
MIXTRAL_AUX_ATOL = 1e-6


def scaled_ratio(got, want, rel: float) -> float:
    """max |got - want| over rel * max |want|: the check passes at <= 1."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return ((got - want).abs().max() / (rel * want.abs().max())).item()


def phase_mixtral_check():
    """mixtral_tiny in f32 (TF32 off), card against CPU on the same weights
    and inputs: MoELayer outputs, aux and drop counts for both dispatch
    paths at capacity factors 1.25 and 0.25 (which must drop), and the
    whole model's logits and aux; the check must reject a layer whose
    expert 0 outputs zeros."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(tmix.mixtral_tiny(), dtype=torch.float32)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, 32, cfg.hidden)), dtype=torch.float32)
    devices = {"cpu": "cpu", "card": DEVICE}
    seeded = lambda make, dev: make(dev, torch.Generator(dev).manual_seed(0))
    cases, bad = [], []
    for dispatch, factor in itertools.product(tmix.DISPATCHES, (1.25, 0.25)):
        layer_cfg = dataclasses.replace(cfg, dispatch=dispatch,
                                        capacity_factor=factor)
        layers = {where: seeded(functools.partial(tmix.MoELayer, layer_cfg),
                                dev) for where, dev in devices.items()}
        layers["card"].load_state_dict(layers["cpu"].state_dict())
        with torch.no_grad():
            want, want_aux = layers["cpu"](x)
            got, aux = layers["card"](x.to(DEVICE))
            real = layers["card"]._expert_ffn

            def zero_expert(expert_in):
                out = real(expert_in).clone()
                out[0] = 0
                return out

            layers["card"]._expert_ffn = zero_expert
            wrong, _ = layers["card"](x.to(DEVICE))
        case = {"dispatch": dispatch, "capacity_factor": factor,
                "ratio": scaled_ratio(got, want, MIXTRAL_CHECK_REL),
                "aux_err": abs(aux.item() - want_aux.item()),
                "dropped": int(layers["card"].dropped_assignments),
                "dropped_cpu": int(layers["cpu"].dropped_assignments),
                "expert0_zeroed_ratio": scaled_ratio(wrong, want,
                                                     MIXTRAL_CHECK_REL)}
        cases.append(case)
        if (case["ratio"] > 1 or case["aux_err"] > MIXTRAL_AUX_ATOL
                or case["dropped"] != case["dropped_cpu"]
                or (factor < 1 and case["dropped"] == 0)
                or case["expert0_zeroed_ratio"] <= 1):
            bad.append(case)
    models = {where: seeded(functools.partial(tmix.Mixtral, cfg), dev)
              for where, dev in devices.items()}
    models["card"].load_state_dict(models["cpu"].state_dict())
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 32)))
    with torch.no_grad():
        want, want_aux = models["cpu"](tokens)
        got, aux = models["card"](tokens.to(DEVICE))
    model_case = {"ratio": scaled_ratio(got, want, MIXTRAL_CHECK_REL),
                  "aux_err": abs(aux.item() - want_aux.item()),
                  "dropped": [int(layer.moe.dropped_assignments)
                              for layer in models["card"].layers],
                  "dropped_cpu": [int(layer.moe.dropped_assignments)
                                  for layer in models["cpu"].layers]}
    emit({"phase": "mixtral_check", "dtype": "float32", "tf32": False,
          "limit": {"rel_to_max": MIXTRAL_CHECK_REL,
                    "aux_atol": MIXTRAL_AUX_ATOL},
          "moe_layer": cases, "model": model_case})
    if (model_case["ratio"] > 1 or model_case["aux_err"] > MIXTRAL_AUX_ATOL
            or model_case["dropped"] != model_case["dropped_cpu"]):
        bad.append(model_case)
    if bad:
        raise AssertionError(f"Mixtral on the card disagrees with the CPU, "
                             f"or the check accepts a zeroed expert: {bad}")


def mixtral_op_class(op, rows: int, experts: int):
    """The class of a Mixtral training step's aten op by its name and input
    shapes, or None: expert matmuls are bmm over E; the dispatch and
    combine einsums contract or produce ``rows`` = E x capacity; the gather
    path's index ops; the expert-weight and other casts."""
    name = op.name
    shapes = [s for s in op.input_shapes or () if s]
    if name in ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"):
        if name == "aten::bmm" and shapes and shapes[0][0] == experts:
            return "expert matmuls"
        if any(rows in shape for shape in shapes):
            return "dispatch/combine einsums"
        return "matmul (attention, router, lm_head)"
    if name in ("aten::index", "aten::index_put_", "aten::_index_put_impl_",
                "aten::index_add_", "aten::sort", "aten::argsort",
                "aten::bincount", "aten::gather", "aten::scatter_add_"):
        return "dispatch/combine index ops"
    if name in ("aten::copy_", "aten::_to_copy"):
        return "casts/copies"
    return None


def mixtral_kernel_class(name: str) -> str:
    """``kernel_class``, with copy kernels (the casts) a class of their
    own."""
    cls = kernel_class(name)
    return "casts/copies" if cls == "other" and "copy" in name else cls


def mixtral_flops(cfg, tokens: int, capacity: int, kept: int) -> dict:
    """Reckoned FLOPs of one training step (remat recompute not counted),
    6 a parameter a token and attention's 12 D a visible pair and head:
    the active work (attention projections, router, k of E experts and
    lm_head), the expert matmuls on capacity padding (E x capacity rows a
    layer, ``kept`` of them real over the layers), and the dispatch and
    combine einsums (2 T E C H each forward, x3 with the backward)."""
    h, m, e, k = cfg.hidden, cfg.mlp_dim, cfg.n_experts, cfg.experts_per_token
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    layers = cfg.n_layers
    attn_params = h * q + 2 * h * kv + q * h
    active = (6 * tokens * (layers * (attn_params + h * e + k * 3 * h * m)
                            + h * cfg.vocab_size)
              + 12 * cfg.head_dim * cfg.n_heads * layers
              * visible_pairs(tokens, tokens, True, 0))
    padding = 6 * 3 * h * m * (layers * e * capacity - kept)
    dispatch = 3 * 2 * 2 * tokens * e * capacity * h * layers
    return {"active": active, "capacity_padding": padding,
            "dispatch_einsums": dispatch}


def phase_mixtral_train():
    """The main path of this family: Trainer + Mixtral at mixtral_8x7b
    width, 2 layers, B=1, S=2048, bf16 compute, f32 params, full remat,
    adamw(1e-4), make_moe_lm_loss (aux weight 0.02); MIXTRAL_STEPS steps
    with each dispatch path from the same seed and batch. Returns the
    flash launches of both runs' steps."""
    card = nvidia_smi()
    cfg = dataclasses.replace(tmix.mixtral_8x7b(),
                              n_layers=MIXTRAL_TRAIN_LAYERS, remat=True)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (B, S + 1))
    batch = {"inputs": tokens}
    capacity = max(cfg.experts_per_token,
                   int(B * S * cfg.experts_per_token * cfg.capacity_factor
                       / cfg.n_experts))
    runs, total = {}, dict.fromkeys(fa.LAUNCHES, 0)
    start_gb = torch.cuda.memory_allocated() / 2 ** 30
    for dispatch in tmix.DISPATCHES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = tmix.Mixtral(dataclasses.replace(cfg, dispatch=dispatch),
                             device=DEVICE, generator=torch.Generator(
                                 device=DEVICE).manual_seed(0))
        params = sum(p.numel() for p in model.parameters())
        trainer = Trainer(model=model, optimizer=adamw(MIXTRAL_LR),
                          loss_fn=tmix.make_moe_lm_loss(cfg.aux_loss_weight),
                          device=DEVICE)
        state = trainer.init()
        step = trainer.make_train_step()
        torch.cuda.synchronize()
        losses, norms, drops, step_s = [], [], [], []
        fa.reset_launches()
        for _ in range(MIXTRAL_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            drops.append([int(layer.moe.dropped_assignments)
                          for layer in model.layers])
        launches = dict(fa.LAUNCHES)
        for name in total:
            total[name] += launches.get(name, 0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_step(step, state, batch, mixtral_kernel_class,
                            functools.partial(
                                mixtral_op_class,
                                rows=cfg.n_experts * capacity,
                                experts=cfg.n_experts))
        steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
        kept = B * S * cfg.experts_per_token * cfg.n_layers - sum(drops[-1])
        flops = mixtral_flops(cfg, B * S, capacity, kept)
        runs[dispatch] = {
            "losses": losses, "grad_norms": norms,
            "dropped_per_layer": drops, "step_ms": [t * 1e3 for t in step_s],
            "ms_per_step": steady * 1e3, "tokens_per_s": B * S / steady,
            "flops_per_step": flops,
            "mfu_active_vs_989_tflops": flops["active"] / steady / PEAK_BF16,
            "max_memory_allocated_gb": peak,
            "free_gb_at_peak": (torch.cuda.get_device_properties(0)
                                .total_memory / 2 ** 30 - peak),
            "launches": launches,
            "launches_per_step": {n: c / MIXTRAL_STEPS
                                  for n, c in launches.items()},
            "profile": prof}
        del model, trainer, state, step, metrics
        gc.collect()
        torch.cuda.empty_cache()
    einsum, gather = runs["einsum"], runs["gather"]
    emit({"phase": "mixtral_train", "nvidia_smi": card,
          "memory_allocated_gb_at_start": start_gb,
          "layers": cfg.n_layers, "batch": B, "seq": S,
          "params": params, "capacity": capacity, "steps": MIXTRAL_STEPS,
          "lr": MIXTRAL_LR, "aux_loss_weight": cfg.aux_loss_weight,
          "loss_rtol": MIXTRAL_LOSS_RTOL, "runs": runs})
    for dispatch, run in runs.items():
        if not all(math.isfinite(v) for v in run["losses"] + run["grad_norms"]):
            raise AssertionError(f"{dispatch}: non-finite loss or grad norm")
        if not run["losses"][-1] < run["losses"][0]:
            raise AssertionError(f"{dispatch}: loss did not fall: "
                                 f"{run['losses']}")
        want = counts(MIXTRAL_PER_STEP, MIXTRAL_STEPS)
        if run["launches"] != want:
            raise AssertionError(f"{dispatch}: flash launches "
                                 f"{run['launches']} != {want}")
    np.testing.assert_allclose(gather["losses"], einsum["losses"],
                               rtol=MIXTRAL_LOSS_RTOL)
    # The first step routes the same weights and batch: the same drops.
    # Later steps start from weights that differ in the last bf16 bits
    # (the paths' backward sums round differently), so they are printed.
    if einsum["dropped_per_layer"][0] != gather["dropped_per_layer"][0]:
        raise AssertionError(f"first-step drop counts differ between the "
                             f"dispatch paths: {einsum['dropped_per_layer']}"
                             f" {gather['dropped_per_layer']}")
    return total


def phase_mixtral_serve():
    """Decode at 2 layers of mixtral_8x7b width in f32 (TF32 off): cached
    prefill and decode logits (2 slots, prompts of DECODE_LENS tokens,
    DECODE_STEPS steps) against the drop-free no-cache forward
    (capacity_factor = n_experts) of the same weights, and the greedy
    tokens of both equal; then MixtralRunner at 8 layers (f32 params,
    bf16 compute, max_seq_len 8192, SERVE_SLOTS slots) serves
    SERVE_PROMPTS, and one decode step is profiled."""
    card = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(tmix.mixtral_8x7b(), n_layers=2,
                               remat=False, dtype=torch.float32)
    free = dataclasses.replace(base, capacity_factor=float(base.n_experts))
    rng = np.random.default_rng(1)
    seq = max(DECODE_LENS) + DECODE_STEPS
    tokens = torch.as_tensor(rng.integers(0, base.vocab_size, (2, seq)),
                             device=DEVICE)
    other = torch.as_tensor(rng.integers(0, base.vocab_size, (1, seq)),
                            device=DEVICE)
    seeded = lambda c: tmix.Mixtral(c, device=DEVICE,
                                    generator=torch.Generator(
                                        device=DEVICE).manual_seed(0))
    model = seeded(free)
    with torch.no_grad():
        truth = model(tokens)[0].float()
    del model
    torch.cuda.empty_cache()
    want = torch.cat([truth[slot, :n + DECODE_STEPS]
                      for slot, n in enumerate(DECODE_LENS)])
    model = seeded(dataclasses.replace(base, decode=True))
    got = cached_logits(model, tokens, other, lib=tmix)
    del model
    torch.cuda.empty_cache()
    f32 = check("logits", got, want, rel=DECODE_REL, tol=DECODE_REL)
    greedy_equal = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    emit({"phase": "mixtral_decode", "nvidia_smi": card, "layers": 2,
          "slot_prompts": list(DECODE_LENS), "decode_steps": DECODE_STEPS,
          "f32": {"max_abs_err": f32["max_abs_err"],
                  "limit": {"atol": f32["atol"], "rtol": DECODE_REL,
                            "rel_l2": DECODE_REL},
                  "rel_l2": f32["rel_l2"], "ratio": f32["ratio"]},
          "greedy_tokens_equal": greedy_equal})
    if not f32["ok"] or not greedy_equal:
        raise AssertionError(f"cached Mixtral logits off the drop-free "
                             f"forward: ratio {f32['ratio']}, greedy "
                             f"tokens equal {greedy_equal}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = MixtralRunner(config=dataclasses.replace(
        tmix.mixtral_8x7b(), n_layers=MIXTRAL_SERVE_LAYERS),
        max_slots=SERVE_SLOTS, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    record = serve_requests(runner)
    emit({"phase": "mixtral_serve", "nvidia_smi": card, "build_s": build_s,
          "dispatch": runner.config.dispatch, **record})
    lengths = [n + SERVE_NEW_TOKENS + 1 for n in SERVE_PROMPTS[-SERVE_SLOTS:]]
    floor, port = decode_step_bytes(runner)
    emit({"phase": "mixtral_serve_profile", "nvidia_smi": card,
          "slots": SERVE_SLOTS, "lengths": lengths,
          **profile_decode(runner, lengths),
          "reckoned_bytes": {"floor": floor, "port": port,
                             "floor_ms": floor / PEAK_BYTES * 1e3,
                             "port_ms": port / PEAK_BYTES * 1e3}})
    del runner
    gc.collect()
    torch.cuda.empty_cache()


def phase_mixtral_all() -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    phase_mixtral_check()
    launches = phase_mixtral_train()
    phase_mixtral_serve()
    return launches


# ---------------------------------------------------------------------------
# BERT (models/bert.py) and the parameter server (train/ps.py)
# ---------------------------------------------------------------------------

# Card (f32, TF32 off) against CPU: bert_tiny's logits within 1e-5 of
# their largest value (sums of at most 128 f32 products in another
# order, as mixtral_check), its gradients within 1e-4 (sums over the
# batch's 160 rows on top); bert_base's logits within 1e-4 (12 layers of
# sums over 768-3072 products).
BERT_CHECK_REL = 1e-5
BERT_GRAD_REL = 1e-4
BERT_BASE_REL = 1e-4
BERT_CHECK_SHAPE = (4, 40)          # B, S < max_seq_len, one row padded
BERT_BASE_CHECK_SHAPE = (2, 128)
# benchmarks/bench_bert.py's configuration: B=16, S=512, bf16 compute,
# f32 params, remat, adamw(1e-4).
BERT_B, BERT_S = 16, 512
BERT_STEPS = 5
BERT_LR = 1e-4
# The first loss: the cross entropy of random logits of unit variance
# (the MLM head's input leaves mlm_ln at unit variance, its weights draw
# at 1/hidden) over V words is about ln V + 1/2.
BERT_FIRST_LOSS_ATOL = 0.5
PS_STEPS = 30
PS_TRANSFER_REPS = 3


def bert_batch(vocab: int, b: int, s: int, seed: int,
               padded: bool = False) -> dict:
    """The payload's MLM batch: tokens from ``default_rng(seed)``, 15% of
    positions masked with the sentinel 3; ``padded`` adds an attn_mask
    with row 1 padded at its tail and the last row all padding."""
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, vocab, (b, s))
    mask = rng.random((b, s)) < 0.15
    batch = {"inputs": np.where(mask, 3, targets), "targets": targets,
             "mask": mask.astype(np.float32)}
    if padded:
        attn = np.ones((b, s), np.int32)
        attn[1, s // 2:] = 0
        attn[-1] = 0
        batch["attn_mask"] = attn
    return batch


def phase_bert_check() -> dict:
    """bert_tiny in f32 (TF32 off), card against CPU on the same weights
    and a padded batch: logits and every parameter's gradient of the MLM
    loss, each within its limit scaled to its own largest value (check);
    the check must reject the card's logits without the padding mask.
    Then bert_base at B=2, S=128 in f32: logits, card against CPU.
    Returns the flash launches of the phase (BERT reaches no kernel)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.reset_launches()
    tiny = dataclasses.replace(tbert.bert_tiny(), dtype=torch.float32)
    seeded = lambda cfg, dev: tbert.Bert(
        cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    models = {"cpu": seeded(tiny, "cpu")}
    models["card"] = seeded(tiny, DEVICE)
    models["card"].load_state_dict(models["cpu"].state_dict())
    batch = bert_batch(tiny.vocab_size, *BERT_CHECK_SHAPE, seed=5,
                       padded=True)
    outs = {}
    for where, model in models.items():
        dev = next(model.parameters()).device
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        logits = model(b["inputs"], b["attn_mask"])
        loss = cross_entropy_loss(logits, b["targets"], b["mask"])
        loss.backward()
        outs[where] = {"logits": logits.detach().cpu(), "loss": loss.item(),
                       "grads": {n: p.grad.cpu() for n, p in
                                 model.named_parameters()}}
        if where == "card":
            with torch.no_grad():
                outs["unmasked"] = model(b["inputs"]).cpu()
    logits = check("logits", outs["card"]["logits"], outs["cpu"]["logits"],
                   rel=BERT_CHECK_REL, tol=BERT_CHECK_REL)
    unmasked = check("logits", outs["unmasked"], outs["cpu"]["logits"],
                     rel=BERT_CHECK_REL, tol=BERT_CHECK_REL)
    grads = {}
    for n, g in outs["card"]["grads"].items():
        want = outs["cpu"]["grads"][n]
        if n.endswith("attn.wk.bias"):
            # Zero in exact arithmetic: the key bias moves every logit of
            # a query row alike, which the softmax cancels. Both sides'
            # round-off is held against the key weight's gradient.
            scale = outs["cpu"]["grads"][n[:-len("bias")] + "weight"]
            limit = BERT_GRAD_REL * scale.abs().max().item()
            err = max(g.abs().max().item(), want.abs().max().item())
            grads[n] = {"max_abs_err": err, "limit": limit,
                        "ratio": err / limit, "ok": err <= limit}
        else:
            grads[n] = check(n, g, want, rel=BERT_GRAD_REL,
                             tol=BERT_GRAD_REL)
    worst = max(grads, key=lambda n: grads[n]["ratio"])
    del models, outs
    base = dataclasses.replace(tbert.bert_base(), dtype=torch.float32,
                               remat=False)
    cpu_base = seeded(base, "cpu")
    card_base = seeded(base, DEVICE)
    card_base.load_state_dict(cpu_base.state_dict())
    tokens = bert_batch(base.vocab_size, *BERT_BASE_CHECK_SHAPE,
                        seed=6)["inputs"]
    with torch.no_grad():
        want = cpu_base(torch.as_tensor(tokens))
        got = card_base(torch.as_tensor(tokens, device=DEVICE)).cpu()
    base_logits = check("logits", got, want, rel=BERT_BASE_REL,
                        tol=BERT_BASE_REL)
    del cpu_base, card_base, want, got
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(fa.LAUNCHES)
    emit({"phase": "bert_check", "dtype": "float32", "tf32": False,
          "tiny": {"batch": list(BERT_CHECK_SHAPE),
                   "limit": {"logits_rel": BERT_CHECK_REL,
                             "grads_rel": BERT_GRAD_REL},
                   "logits": logits, "worst_grad": [worst, grads[worst]],
                   "grads_ok": all(g["ok"] for g in grads.values()),
                   "unmasked_ratio": unmasked["ratio"]},
          "base": {"batch": list(BERT_BASE_CHECK_SHAPE),
                   "limit_rel": BERT_BASE_REL, "logits": base_logits},
          "launches": launches})
    bad = [n for n, g in grads.items() if not g["ok"]]
    if not logits["ok"] or bad or not base_logits["ok"]:
        raise AssertionError(f"BERT on the card disagrees with the CPU: "
                             f"logits {logits['ratio']}, grads {bad}, "
                             f"bert_base {base_logits['ratio']}")
    if unmasked["ok"]:
        raise AssertionError("the check accepts logits without the padding "
                             "mask")
    if any(launches.values()):
        raise AssertionError(f"BERT launched flash kernels: {launches}")
    return launches


def bert_op_class(op, seq: int, vocab: int):
    """The class of a BERT training step's aten op by its name and input
    shapes, or None: [.., S, S] operands are the attention's einsums and
    softmax, the other matmuls the projections and the MLM head; keepdim
    [B, S, 1] statistics and the mean/square/rsqrt ops are LayerNorm's (no
    other layer of the model takes them); the foreach ops AdamW's."""
    name = op.name
    shapes = [s for s in op.input_shapes or () if s]
    if name.startswith("aten::_foreach"):
        return "AdamW (foreach)"
    if name in ("aten::bmm", "aten::baddbmm", "aten::_softmax",
                "aten::_softmax_backward_data") or any(
            len(x) >= 2 and x[-1] == x[-2] == seq for x in shapes):
        return "attention einsums and softmax"
    if name in ("aten::mm", "aten::addmm"):
        return "matmul (projections, MLM head)"
    if name in ("aten::gelu", "aten::gelu_backward"):
        return "gelu"
    if name in ("aten::mean", "aten::square", "aten::pow", "aten::rsqrt",
                "aten::clamp_min") or any(len(x) == 3 and x[-1] == 1
                                          for x in shapes):
        return "LayerNorm"
    if name in ("aten::copy_", "aten::_to_copy"):
        return "casts/copies"
    if any(x and x[-1] == vocab for x in shapes):
        return "MLM loss and logits"
    return None


def bert_flops(model, tokens: int, seq: int) -> dict:
    """Reckoned FLOPs of one training step (the remat recompute not
    counted): 6 a matmul parameter a token, and the attention's 12·D a
    (query, key) pair and head."""
    cfg = model.cfg
    matmul_params = sum(m.weight.numel() for m in model.modules()
                        if isinstance(m, tllama.Dense))
    attention = (12 * cfg.head_dim * cfg.n_heads * cfg.n_layers * tokens
                 * seq)
    return {"matmul_params": matmul_params,
            "matmul": 6 * matmul_params * tokens, "attention": attention,
            "total": 6 * matmul_params * tokens + attention}


def phase_bert() -> dict:
    """BERT-base MLM training at benchmarks/bench_bert.py's configuration:
    Trainer + Bert (bf16 compute, f32 params, remat), adamw(1e-4),
    mlm_loss, B=16, S=512, one fixed batch with 15% masked, BERT_STEPS
    steps; then one profiled step. Returns the flash launches of the
    steps."""
    card = nvidia_smi()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = tbert.bert_base()
    model = tbert.Bert(cfg, device=DEVICE,
                       generator=torch.Generator(device=DEVICE).manual_seed(0))
    trainer = Trainer(model=model, optimizer=adamw(BERT_LR),
                      loss_fn=tbert.mlm_loss, device=DEVICE)
    state = trainer.init()
    step = trainer.make_train_step()
    batch = bert_batch(cfg.vocab_size, BERT_B, BERT_S, seed=0)
    torch.cuda.synchronize()
    losses, norms, step_s = [], [], []
    fa.reset_launches()
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_step(step, state, batch, kernel_class, functools.partial(
        bert_op_class, seq=BERT_S, vocab=cfg.vocab_size))
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    tokens = BERT_B * BERT_S
    flops = bert_flops(model, tokens, BERT_S)
    first_loss = math.log(cfg.vocab_size) + 0.5
    emit({"phase": "bert", "nvidia_smi": card, "batch": BERT_B,
          "seq": BERT_S, "dtype": str(cfg.dtype), "remat": cfg.remat,
          "lr": BERT_LR, "params": sum(p.numel() for p in
                                       model.parameters()),
          "losses": losses, "grad_norms": norms,
          "expected_first_loss": first_loss,
          "step_ms": [t * 1e3 for t in step_s], "ms_per_step": steady * 1e3,
          "tokens_per_s": tokens / steady, "flops_per_step": flops,
          "mfu_vs_989_tflops": flops["total"] / steady / PEAK_BF16,
          "max_memory_allocated_gb": peak, "launches": launches,
          "profile": prof})
    del model, trainer, state, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"non-finite BERT loss or grad norm: {losses}")
    if abs(losses[0] - first_loss) > BERT_FIRST_LOSS_ATOL:
        raise AssertionError(f"first BERT loss {losses[0]} is not within "
                             f"{BERT_FIRST_LOSS_ATOL} of {first_loss}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"BERT loss did not fall: {losses}")
    if any(launches.values()):
        raise AssertionError(f"BERT launched flash kernels: {launches}")
    return launches


# The payloads' own commands as subprocesses on the card, started together
# (none waits on another): (record name, arguments after python -m, a
# line each must print, as a regular expression).
PAYLOAD_RUNS = (
    ("pp_payload", ["tf_operator_tpu_torch.train.train_llama_pp", "--pp",
                    "1", "--dp", "1", "--steps", "3"],
     r".*pipeline training OK"),
    ("resnet_payload", ["tf_operator_tpu_torch.train.train_resnet",
                        "--size", "50", "--steps", "4", "--batch-size", "64",
                        "--image-size", "224"], "resnet training OK"),
    ("mixtral_payload", ["tf_operator_tpu_torch.train.train_mixtral",
                         "--size", "tiny", "--steps", "4"],
     "mixtral training OK"),
    ("bert_payload", ["tf_operator_tpu_torch.train.train_bert", "--size",
                      "base", "--steps", "2"], "bert training OK"),
)


def phase_payloads():
    """Each of PAYLOAD_RUNS exits 0 and prints its line (module
    docstring, phase 16a); one line each, as its own phase printed it,
    with its seconds from the common start."""
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-payloads-") as out:
        t0 = time.perf_counter()
        procs = {}
        for name, args, line in PAYLOAD_RUNS:
            with open(os.path.join(out, name + ".out"), "w") as o, \
                    open(os.path.join(out, name + ".err"), "w") as e:
                procs[name] = subprocess.Popen([sys.executable, "-m", *args],
                                               cwd=REPO, stdout=o, stderr=e)
        ended = {}
        try:
            while len(ended) < len(procs):
                for name, proc in procs.items():
                    if name not in ended and proc.poll() is not None:
                        ended[name] = time.perf_counter() - t0
                if time.perf_counter() - t0 > 300:
                    left = sorted(set(procs) - set(ended))
                    raise AssertionError(f"payloads still running after "
                                         f"300 s: {left}")
                time.sleep(0.1)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = []
        for name, args, line in PAYLOAD_RUNS:
            with open(os.path.join(out, name + ".out")) as f:
                lines = f.read().splitlines()
            rc = procs[name].returncode
            emit({"phase": name, "args": args[1:], "rc": rc,
                  "seconds": ended[name], "stdout": lines})
            if rc != 0 or not any(re.fullmatch(line, printed)
                                  for printed in lines):
                with open(os.path.join(out, name + ".err")) as f:
                    failed.append(f"{args[0]} exited {rc}: {f.read()[-2000:]}")
    if failed:
        raise AssertionError("; ".join(failed))


def phase_bert_all() -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    launches = phase_bert_check()
    train = phase_bert()
    return {n: launches[n] + train[n] for n in launches}


def _free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def _cluster_spec(addrs, task_type: str, index: int) -> str:
    return json.dumps({"cluster": {"ps": addrs, "worker": ["127.0.0.1:0"]},
                       "task": {"type": task_type, "index": index}})


def phase_ps(root: str):
    """The parameter-server job on the card: two port shards (python -m
    tf_operator_tpu_torch.train.ps) as subprocesses on loopback, each
    given its TPUJOB_CLUSTER_SPEC, and the port's MNIST worker on the card
    for PS_STEPS steps against them (window-mean loss falling); then, on
    two fresh shards, the seconds of one pull and one push of a
    bert_base-sized flat dict (110 M f32 parameters over 2 shards: what a
    worker of the BASELINE's "PS + 8 Workers" config moves a step), the
    median of PS_TRANSFER_REPS, and the pushed SGD steps read back. Every
    shard is stopped with SIGTERM and must exit 0."""
    import signal

    from tf_operator_tpu_torch.train.ps import PSClient

    card = nvidia_smi()
    ports = _free_ports(4)
    jobs = {"mnist": [f"127.0.0.1:{p}" for p in ports[:2]],
            "bert": [f"127.0.0.1:{p}" for p in ports[2:]]}
    lr = {"mnist": 0.2, "bert": 0.01}
    shards, logs = [], []
    try:
        for job, addrs in jobs.items():
            for i in range(len(addrs)):
                log = open(os.path.join(root, f"ps-{job}-{i}.log"), "w+")
                logs.append(log)
                shards.append(subprocess.Popen(
                    [sys.executable, "-m", "tf_operator_tpu_torch.train.ps",
                     "--lr", str(lr[job])], cwd=REPO, stdout=log,
                    stderr=subprocess.STDOUT,
                    env=dict(os.environ, TPUJOB_CLUSTER_SPEC=_cluster_spec(
                        addrs, "ps", i))))
        t0 = time.perf_counter()
        worker = subprocess.run(
            [sys.executable, "-m", "tf_operator_tpu_torch.train.dist_mnist_ps",
             "--steps", str(PS_STEPS)], cwd=REPO, capture_output=True,
            text=True, timeout=300,
            env=dict(os.environ, TPU_WORKER_ID="0",
                     TPUJOB_CLUSTER_SPEC=_cluster_spec(jobs["mnist"],
                                                       "worker", 0)))
        worker_s = time.perf_counter() - t0
        done = [ln for ln in worker.stdout.splitlines()
                if ln.startswith("done:")]
        if worker.returncode != 0 or not done:
            raise AssertionError(f"PS worker exited {worker.returncode}: "
                                 f"{worker.stderr[-2000:]}")
        first = float(done[0].split("first=")[1].split()[0])
        last = float(done[0].split("last=")[1])

        model = tbert.Bert(tbert.bert_base(), device=DEVICE)
        flat = {n.replace(".", "/"): p.detach().cpu().numpy()
                for n, p in model.named_parameters()}
        del model
        nbytes = sum(v.nbytes for v in flat.values())
        client = PSClient(jobs["bert"])
        client.wait_ready(timeout=120)
        t0 = time.perf_counter()
        client.init(flat)
        init_s = time.perf_counter() - t0
        pull_s, push_s = [], []
        for _ in range(PS_TRANSFER_REPS):
            t0 = time.perf_counter()
            client.push(flat)
            push_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            pulled = client.pull()
            pull_s.append(time.perf_counter() - t0)
        client.close()
        # PS_TRANSFER_REPS SGD steps, each with the initial parameters as
        # the gradient.
        scale = 1 - lr["bert"] * PS_TRANSFER_REPS
        key = "layers/0/attn/wq/weight"
        got = pulled["layers"]["0"]["attn"]["wq"]["weight"]
        applied = bool(np.allclose(got, flat[key] * scale, rtol=1e-5,
                                   atol=1e-7))
        rcs = []
        for proc in shards:
            proc.send_signal(signal.SIGTERM)
        for proc in shards:
            rcs.append(proc.wait(timeout=60))
        shard_logs = []
        for log in logs:
            log.seek(0)
            shard_logs.append(log.read())
    finally:
        for proc in shards:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    on_card = all("serving on" in text and " on cuda" in text
                  for text in shard_logs)
    median = lambda xs: sorted(xs)[len(xs) // 2]
    emit({"phase": "ps", "nvidia_smi": card, "shards": 2,
          "worker": {"steps": PS_STEPS, "seconds": worker_s,
                     "first_window_loss": first, "last_window_loss": last},
          "transfer": {"params": sum(v.size for v in flat.values()),
                       "bytes": nbytes, "init_s": init_s,
                       "pull_s": pull_s, "push_s": push_s,
                       "pull_s_median": median(pull_s),
                       "push_s_median": median(push_s),
                       "pull_gb_per_s": nbytes / median(pull_s) / 1e9,
                       "push_gb_per_s": nbytes / median(push_s) / 1e9,
                       "sgd_steps_read_back": applied},
          "shard_rcs": rcs, "shards_on_card": on_card})
    if not last < first:
        raise AssertionError(f"PS worker loss did not fall: {first} -> "
                             f"{last}")
    if not applied or any(rcs) or not on_card:
        raise AssertionError(f"PS transfer: pushes applied {applied}, "
                             f"shard exit codes {rcs}, on the card "
                             f"{on_card}: {shard_logs}")


# ---------------------------------------------------------------------------
# The port's control plane
# ---------------------------------------------------------------------------

OPERATOR_TIMEOUT_S = 300
OPERATOR_LOG_LINES = 5
TPU_ENV_PREFIXES = ("JAX_", "TPU_", "MEGASCALE_")


def operator_job(name: str, command, replicas: int = 1,
                 restart_policy: str = "", rtype: str = "worker",
                 accelerator: str = "h100-1"):
    """A TPUJob of ``replicas`` ``rtype`` replicas running ``command`` on
    ``accelerator`` (one H100), its pods kept after the end
    (clean_pod_policy None) with their logs, succeeded once all of its
    workers have."""
    from tf_operator_tpu_torch.api import constants
    from tf_operator_tpu_torch.api.types import (
        Container,
        ObjectMeta,
        PodSpec,
        PodTemplateSpec,
        ReplicaSpec,
        TPUJob,
        TPUJobSpec,
    )

    spec = ReplicaSpec(
        replicas=replicas, restart_policy=restart_policy,
        template=PodTemplateSpec(spec=PodSpec(containers=[Container(
            name=constants.DEFAULT_CONTAINER_NAME, command=command)])))
    job = TPUJob(metadata=ObjectMeta(name=name),
                 spec=TPUJobSpec(replica_specs={rtype: spec}))
    job.spec.slice.accelerator = accelerator
    job.spec.run_policy.clean_pod_policy = "None"
    # Done when every worker is: pods holding the one card in turn run
    # one after the other.
    job.spec.success_policy = "AllWorkers"
    return job


def bootstrap_env(log: str) -> dict:
    """The env gpu_smoke printed: the JSON object after "bootstrap env:"."""
    text = log.split("bootstrap env:", 1)[1]
    return json.JSONDecoder().raw_decode(text.lstrip())[0]


def run_operator_job(op, client, job, card: str):
    """Submit ``job`` to the operator ``op``, wait for it and emit its
    line; return its pod logs and its restarts (pods created beyond one a
    replica). Raises unless it Succeeded."""
    from tf_operator_tpu_torch.controller import conditions as cond

    name = job.metadata.name
    client.create(job)
    done = client.wait_for_job(name, timeout=OPERATOR_TIMEOUT_S)
    logs = client.get_job_logs(name)
    status = done.status
    created = done.metadata.creation_timestamp
    since = lambda t: None if t is None else (t - created).total_seconds()
    replicas = sum(s.replicas for s in done.spec.replica_specs.values())
    restarts = sum(e.count for e in op.recorder.events_for(
        name, reason="SuccessfulCreatePod")) - replicas
    emit({"phase": "operator", "job": name, "nvidia_smi": card,
          "conditions": [c.type for c in status.conditions
                         if c.status == "True"],
          "seconds_to_all_replicas_ready": since(
              status.all_replicas_ready_time),
          "seconds_to_completion": since(status.completion_time),
          "restarts": restarts,
          "log_tails": {pod: log.splitlines()[-OPERATOR_LOG_LINES:]
                        for pod, log in sorted(logs.items())}})
    if not cond.is_succeeded(status):
        raise AssertionError(
            f"TPUJob {name} did not succeed: "
            f"{[(c.type, c.status, c.message) for c in status.conditions]}"
            f" {logs}")
    return logs, restarts


def check_smoke_pods(client, logs, device_name: str, cards=None) -> None:
    """gpu-smoke's pods: stamped with one GPU and its toleration, the
    torch env of a 2-process world at one loopback rendezvous, one
    process a pod (``LOCAL_WORLD_SIZE`` 1), no key of the TPU contract,
    and a matmul on the card named ``device_name``; where ``cards`` names
    the backend's cards, each pod saw one of them alone as
    ``CUDA_VISIBLE_DEVICES``."""
    from tf_operator_tpu_torch.api import constants

    envs = {pod: bootstrap_env(log) for pod, log in logs.items()}
    pods = client.get_pods("gpu-smoke")
    stamped = [
        p.spec.containers[0].resources.get(constants.RESOURCE_GPU) == "1"
        and any(t.key == constants.RESOURCE_GPU and t.operator == "Exists"
                for t in p.spec.tolerations) for p in pods]
    leaked = sorted(k for p in pods for k in p.spec.containers[0].env
                    if k.startswith(TPU_ENV_PREFIXES))
    leaked += sorted(k for env in envs.values() for k in env
                     if k.startswith(TPU_ENV_PREFIXES))
    if (len(pods) != 2 or not all(stamped) or leaked
            or sorted(e.get("RANK") for e in envs.values()) != ["0", "1"]
            or {e.get("WORLD_SIZE") for e in envs.values()} != {"2"}
            or {e.get("LOCAL_WORLD_SIZE") for e in envs.values()} != {"1"}
            or (cards is not None and not all(
                e.get("CUDA_VISIBLE_DEVICES") in cards
                for e in envs.values()))
            or {e.get("MASTER_ADDR") for e in envs.values()} != {"127.0.0.1"}
            or len({e.get("MASTER_PORT") for e in envs.values()}) != 1
            or not all(f"({device_name}): matmul sum" in log
                       and "smoke OK on 1 device(s)" in log
                       for log in logs.values())):
        raise AssertionError(f"gpu-smoke: stamped {stamped}, leaked "
                             f"{leaked}, env {envs}, logs {logs}")


def phase_operator(root: str):
    """The port's own operator runs three jobs on the card (module
    docstring, phase 18)."""
    from tf_operator_tpu_torch.operator import Operator
    from tf_operator_tpu_torch.sdk import TPUJobClient

    card = nvidia_smi()
    # The backend hands each pod its own of this machine's cards
    # (runtime/local.py CardInventory): CUDA_VISIBLE_DEVICES's, else
    # 0..count-1.
    op = Operator.local(workdir=REPO, chips=torch.cuda.device_count())
    op.start(threadiness=2)
    try:
        client = TPUJobClient(op.store)
        logs, _ = run_operator_job(op, client, operator_job(
            "gpu-smoke", [sys.executable, "-m",
                          "tf_operator_tpu_torch.train.gpu_smoke"],
            replicas=2), card)
        cards = op.backend.cards.cards
        emit({"phase": "operator", "job": "gpu-smoke", "cards": cards,
              "pod_env": {pod: {k: v for k, v in bootstrap_env(log).items()
                                if k in ("CUDA_VISIBLE_DEVICES", "RANK",
                                         "LOCAL_WORLD_SIZE", "WORLD_SIZE")}
                          for pod, log in sorted(logs.items())}})
        check_smoke_pods(client, logs, torch.cuda.get_device_name(0),
                         cards=cards)

        logs, _ = run_operator_job(op, client, operator_job(
            "gpu-resnet", [sys.executable, "-m",
                           "tf_operator_tpu_torch.train.train_resnet",
                           "--size", "50", "--steps", "4", "--batch-size",
                           "64", "--image-size", "224"]), card)
        if "resnet training OK" not in logs["gpu-resnet-worker-0"]:
            raise AssertionError(f"gpu-resnet: {logs}")

        logs, restarts = run_operator_job(op, client, operator_job(
            "gpu-mnist-resume", [sys.executable, "-m",
                                 "tf_operator_tpu_torch.train.dist_mnist",
                                 "--steps", "6", "--checkpoint-dir",
                                 os.path.join(root, "operator-mnist"),
                                 "--crash-at-step", "3"],
            restart_policy="ExitCode"), card)
        log = logs["gpu-mnist-resume-worker-0"]
        if (restarts != 1
                or "injected crash at step 3" in log
                or "resumed from checkpoint at step 3" not in log):
            raise AssertionError(f"gpu-mnist-resume: {restarts} restarts, "
                                 f"{logs}")
    finally:
        op.stop()


PLANES_REQUESTS = 24
PLANES_DRAIN_AFTER = 4      # responses landed before the maintenance notice
PLANES_WAIT_S = 90          # deadline of each wait of the serving arc


def planes_operator(**kwargs):
    """Operator.local with every plane a GPU gang goes through: gang
    admission, slice health, checkpoint coordination and serving."""
    from tf_operator_tpu_torch.operator import Operator

    op = Operator.local(workdir=REPO, enable_gang_scheduling=True,
                        enable_slice_health=True,
                        enable_ckpt_coordination=True, enable_serving=True,
                        **kwargs)
    op.start(threadiness=2)
    return op


def wait_until(predicate, what: str, timeout: float = PLANES_WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def admission(name: str):
    """(wall time, order) of the gang's admission of ``name``, from the
    port's decision journal."""
    from tf_operator_tpu_torch.runtime import trace

    admits = [r for r in trace.JOURNAL.decisions("default", name) or []
              if r["kind"] == "admission.admit"]
    if not admits:
        raise AssertionError(f"{name} was never admitted")
    return admits[0]["time"], admits[0]["seq"]


def run_gang_queue(op, client, command, accelerator: str, gpus: str,
                   device_name: str, card: str) -> dict:
    """Two one-worker jobs created back to back on an operator whose GPU
    budget holds one of them: both succeed, the second is admitted after
    the first and gets ready no earlier than the first completes."""
    from tf_operator_tpu_torch.api import constants
    from tf_operator_tpu_torch.controller import conditions as cond

    names = ("gpu-gang-a", "gpu-gang-b")
    for name in names:
        client.create(operator_job(name, command, accelerator=accelerator))
    done = [client.wait_for_job(n, timeout=OPERATOR_TIMEOUT_S)
            for n in names]
    logs = [client.get_job_logs(n) for n in names]
    admits = [admission(n) for n in names]
    pods = [p for n in names for p in client.get_pods(n)]
    stamped = [p.spec.containers[0].resources.get(constants.RESOURCE_GPU)
               == gpus and any(t.key == constants.RESOURCE_GPU
                               and t.operator == "Exists"
                               for t in p.spec.tolerations) for p in pods]
    a, b = (j.status for j in done)
    result = {
        "phase": "operator_planes", "arc": "gang_queue", "nvidia_smi": card,
        "succeeded": [cond.is_succeeded(s) for s in (a, b)],
        "admission_order": [n for _, n in sorted(
            (seq, n) for (_, seq), n in zip(admits, names))],
        "b_queue_wait_seconds": (admits[1][0] - done[1].metadata
                                 .creation_timestamp.timestamp()),
        "b_ready_after_a_done_seconds": (
            None if b.all_replicas_ready_time is None
            or a.completion_time is None else
            (b.all_replicas_ready_time - a.completion_time).total_seconds()),
        "pods_stamped": stamped,
        "log_tails": {pod: log.splitlines()[-OPERATOR_LOG_LINES:]
                      for job_logs in logs
                      for pod, log in sorted(job_logs.items())}}
    emit(result)
    if (not all(result["succeeded"]) or result["admission_order"]
            != list(names) or result["b_ready_after_a_done_seconds"] is None
            or result["b_ready_after_a_done_seconds"] < 0
            or len(pods) != 2 or not all(stamped)
            or not all(f"({device_name}): matmul sum" in log
                       for job_logs in logs for log in job_logs.values())):
        raise AssertionError(f"gang queue: {result} {logs}")
    return result


def serving_planes_job(spool: str, command, accelerator: str):
    """One serving replica under the serving, health and checkpoint
    policies of the serving-drain arc."""
    from tf_operator_tpu_torch.api.types import (
        CheckpointPolicy,
        HealthPolicy,
        ServingPolicy,
    )

    job = operator_job("gpu-serve", command, rtype="serving",
                       accelerator=accelerator)
    policy = job.spec.run_policy
    policy.serving_policy = ServingPolicy(
        enabled=True, spool_directory=spool, max_batch_slots=2,
        max_queue_depth=8, max_tokens_per_request=8)
    policy.health_policy = HealthPolicy(enabled=True)
    # The drain barrier rides checkpoint coordination: the serving
    # worker's save is its re-spool, acked through the record channel.
    policy.checkpoint_policy = CheckpointPolicy(
        enabled=True, directory=spool, interval_steps=100000,
        barrier_timeout_seconds=60.0)
    return job


def spool_responses(spool: str) -> dict:
    """id -> (wall time written, tokens) of every response in ``spool``."""
    done = os.path.join(spool, "done")
    out = {}
    for name in os.listdir(done) if os.path.isdir(done) else ():
        if name.endswith(".json"):
            path = os.path.join(done, name)
            with open(path) as f:
                tokens = json.load(f)["tokens"]
            out[name[:-len(".json")]] = (os.stat(path).st_mtime, tokens)
    return out


class StoreBindClient:
    """The pods/binding endpoint over the operator's own store: the first
    bind of a pod wins, a second is a conflict (what a Kubernetes API
    server answers the port's binder)."""

    def __init__(self, store):
        self.store = store

    def bind_pod(self, namespace: str, name: str, node: str) -> None:
        from tf_operator_tpu_torch.runtime import store as store_mod

        pod = self.store.get(store_mod.PODS, namespace, name)
        if pod.spec.node_name:
            raise store_mod.ConflictError(
                f"pod {namespace}/{name} is already on {pod.spec.node_name}")
        pod.spec.node_name = node
        self.store.update(store_mod.PODS, pod)


def ready_node(name: str, **conditions):
    from tf_operator_tpu_torch.api.types import (
        Node,
        NodeSpec,
        NodeStatus,
        ObjectMeta,
    )

    return Node(metadata=ObjectMeta(name=name, namespace=""),
                spec=NodeSpec(chips=8),
                status=NodeStatus(phase="Ready",
                                  conditions=dict(Ready="True",
                                                  **conditions)))


def inject_maintenance(store, job_name: str) -> None:
    """Bind the job's live pods to node n-maint, then create n-maint with
    a maintenance notice: a placed gang under an announced maintenance."""
    from tf_operator_tpu_torch.api import constants
    from tf_operator_tpu_torch.runtime import store as store_mod

    for pod in store.list(store_mod.PODS,
                          selector={constants.LABEL_JOB_NAME: job_name}):
        fresh = pod.deepcopy()
        fresh.spec.node_name = "n-maint"
        store.update(store_mod.PODS, fresh)
    store.create(store_mod.NODES,
                 ready_node("n-maint", MaintenancePending="True"))


def run_serving_drain(op, client, spool: str, command, accelerator: str,
                      card: str) -> dict:
    """A serving gang drained off a maintenance node mid-traffic answers
    every request exactly once (module docstring, phase 19). The port's
    binder places the gang's pods on node n-spare through the store, so
    slice health sees the rebound gang bound again and times the
    rebind."""
    from tf_operator_tpu_torch.controller.binder import SliceGangBinder
    from tf_operator_tpu_torch.runtime import store as store_mod

    op.store.create(store_mod.NODES, ready_node("n-spare"))
    binder = SliceGangBinder(op.store, StoreBindClient(op.store),
                             op.controller.engine.gang,
                             recorder=op.recorder).start()
    try:
        return serving_drain_arc(op, client, spool, command, accelerator,
                                 card)
    finally:
        binder.stop()


def serving_drain_arc(op, client, spool: str, command, accelerator: str,
                      card: str) -> dict:
    from tf_operator_tpu_torch.api.types import JobConditionType
    from tf_operator_tpu_torch.controller import conditions as cond
    from tf_operator_tpu_torch.runtime import metrics

    os.makedirs(os.path.join(spool, "pending"))
    rebind_sum = metrics.drain_rebind_seconds.sum_value(
        job_namespace="default")
    rebind_count = metrics.drain_rebind_seconds.count_value(
        job_namespace="default")
    client.create(serving_planes_job(spool, command, accelerator))
    client.wait_for_condition("gpu-serve", JobConditionType.RUNNING,
                              timeout=PLANES_WAIT_S)
    ids = [f"req{i:03d}" for i in range(PLANES_REQUESTS)]
    for i, rid in enumerate(ids):
        path = os.path.join(spool, "pending", f"{rid}.json")
        with open(path + ".tmp", "w") as f:
            json.dump({"id": rid, "tenant": "team-a" if i % 2 else "team-b",
                       "prompt": [i + 1, i + 2, i + 3], "maxNewTokens": 8},
                      f)
        os.replace(path + ".tmp", path)
    wait_until(lambda: len(spool_responses(spool)) >= PLANES_DRAIN_AFTER,
               "the first responses")
    before_notice = len(spool_responses(spool))
    notice_at = time.time()
    inject_maintenance(op.store, "gpu-serve")
    wait_until(lambda: len(spool_responses(spool)) >= PLANES_REQUESTS,
               "every response after the drain")
    open(os.path.join(spool, worker.CLOSE_SENTINEL), "w").close()
    job = client.wait_for_job("gpu-serve", timeout=PLANES_WAIT_S)
    responses = spool_responses(spool)
    logs = client.get_job_logs("gpu-serve")
    acks = op.recorder.events_for("gpu-serve",
                                  reason="CheckpointBarrierSaved")
    ack_at = acks[0].timestamp.timestamp() if acks else None
    barrier = [c for c in job.status.conditions
               if c.type == JobConditionType.CHECKPOINT_BARRIER]
    times = sorted(t for t, _ in responses.values())
    after = [t for t in times if ack_at is not None and t > ack_at]
    left = [n for sub in ("pending", "claimed")
            for _, _, files in os.walk(os.path.join(spool, sub))
            for n in files if n.endswith(".json")]
    result = {
        "phase": "operator_planes", "arc": "serving_drain",
        "nvidia_smi": card, "succeeded": cond.is_succeeded(job.status),
        "responses": len(responses),
        "max_tokens": max(len(t) for _, t in responses.values()),
        "responses_at_notice": before_notice,
        "responses_before_ack": len(times) - len(after),
        "responses_after_ack": len(after),
        "left_in_spool": left,
        "barrier": [(c.status, c.reason) for c in barrier],
        "resumed_after_drain": any("resumed after drain" in log
                                   for log in logs.values()),
        "seconds_notice_to_ack": (None if ack_at is None
                                  else ack_at - notice_at),
        "seconds_notice_to_rebound_first_response": (
            after[0] - notice_at if after else None),
        "seconds_ack_to_rebound_first_response": (
            after[0] - ack_at if after else None),
        "drain_rebind_seconds": metrics.drain_rebind_seconds.sum_value(
            job_namespace="default") - rebind_sum,
        "drain_rebind_observations": metrics.drain_rebind_seconds
        .count_value(job_namespace="default") - rebind_count,
        "log_tails": {pod: log.splitlines()[-OPERATOR_LOG_LINES:]
                      for pod, log in sorted(logs.items())}}
    emit(result)
    if (not result["succeeded"] or sorted(responses) != ids
            or result["max_tokens"] > 8 or left
            or result["barrier"] != [("False", "CheckpointBarrierSaved")]
            or not result["resumed_after_drain"]
            or ack_at is None or not times[0] < ack_at < times[-1]
            or result["drain_rebind_observations"] != 1):
        raise AssertionError(f"serving drain: {result} {logs}")
    return result


def phase_operator_planes(root: str):
    """The port's gang, health, checkpoint and serving planes on the card
    (module docstring, phase 19)."""
    from tf_operator_tpu_torch.sdk import TPUJobClient

    card = nvidia_smi()
    op = planes_operator(total_chips=1)
    try:
        client = TPUJobClient(op.store)
        run_gang_queue(op, client, [sys.executable, "-m",
                                    "tf_operator_tpu_torch.train.gpu_smoke"],
                       "h100-1", "1", torch.cuda.get_device_name(0), card)
        run_serving_drain(op, client, os.path.join(root, "planes-spool"),
                          [sys.executable, "-m",
                           "tf_operator_tpu_torch.serve.worker", "--runner",
                           "llama"], "h100-1", card)
    finally:
        op.stop()


SERVED_AGENT = "served-agent"
SERVED_ADMIN_TOKEN = "served-admin"
SERVED_READ_TOKEN = "served-read"
SERVED_START_S = 60         # deadline of the operator's and agent's start


def served_job_line(client, name: str, card: str, tls: bool) -> dict:
    """Wait for ``name`` over the served API and emit its line; return
    its pod logs, read through the API server's log proxy."""
    from tf_operator_tpu_torch.controller import conditions as cond

    done = client.wait_for_job(name, timeout=OPERATOR_TIMEOUT_S)
    logs = client.get_job_logs(name)
    status, created = done.status, done.metadata.creation_timestamp
    since = lambda t: None if t is None else (t - created).total_seconds()
    emit({"phase": "served", "job": name, "tls": tls, "nvidia_smi": card,
          "seconds_to_all_replicas_ready": since(
              status.all_replicas_ready_time),
          "seconds_to_completion": since(status.completion_time),
          "log_tails": {pod: log.splitlines()[-OPERATOR_LOG_LINES:]
                        for pod, log in sorted(logs.items())}})
    if not cond.is_succeeded(status):
        raise AssertionError(
            f"served job {name} did not succeed: "
            f"{[(c.type, c.status, c.message) for c in status.conditions]}"
            f" {logs}")
    return logs


def check_served_smoke(client, logs, device_name: str) -> None:
    """served-smoke's pods: on the agent's node with one GPU each, the
    rendezvous resolved to rank 0's published placement, the card's
    matmul in both logs."""
    from tf_operator_tpu_torch.api import constants

    pods = {p.metadata.name: p for p in client.get_pods("served-smoke")}
    rank0 = pods.get("served-smoke-worker-0")
    port = rank0.status.ports.get("coordinator") if rank0 else None
    envs = {pod: bootstrap_env(log) for pod, log in logs.items()}
    if (len(pods) != 2 or port is None or sorted(envs) != sorted(pods)
            or any(p.spec.node_name != SERVED_AGENT
                   or p.spec.containers[0].resources.get(
                       constants.RESOURCE_GPU) != "1"
                   for p in pods.values())
            or any((e.get("MASTER_ADDR"), e.get("MASTER_PORT"))
                   != ("127.0.0.1", str(port)) for e in envs.values())
            or sorted(e.get("RANK") for e in envs.values()) != ["0", "1"]
            or not all(f"({device_name}): matmul sum" in log
                       and "smoke OK on 1 device(s)" in log
                       for log in logs.values())):
        raise AssertionError(
            f"served-smoke: pods {[p.to_dict() for p in pods.values()]}, "
            f"env {envs}, logs {logs}")


def check_served_auth(url: str, ca_file) -> dict:
    """No token: 401 on a list; the read-only token: a list, then 403
    on a create."""
    from tf_operator_tpu_torch import testutil
    from tf_operator_tpu_torch.runtime import store as store_mod
    from tf_operator_tpu_torch.runtime.remote import RemoteStore

    codes = {}
    for who, token, call in (
            ("anonymous list", None,
             lambda r: r.list(store_mod.TPUJOBS)),
            ("read-only create", SERVED_READ_TOKEN,
             lambda r: r.create(store_mod.TPUJOBS, testutil.new_tpujob(
                 worker=1, name="served-ro")))):
        remote = RemoteStore(url, token=token, ca_file=ca_file)
        try:
            call(remote)
            codes[who] = 200
        except RuntimeError as err:
            codes[who] = int(str(err).split()[2].rstrip(":"))
    RemoteStore(url, token=SERVED_READ_TOKEN, ca_file=ca_file).list(
        store_mod.TPUJOBS)
    if codes != {"anonymous list": 401, "read-only create": 403}:
        raise AssertionError(f"served auth: {codes}")
    return codes


def phase_served(root: str):
    """The port's operator, a node agent and this script as the SDK
    user, three processes (module docstring, phase 20)."""
    from tf_operator_tpu_torch.runtime import store as store_mod
    from tf_operator_tpu_torch.runtime.apiserver import wait_for_server
    from tf_operator_tpu_torch.sdk import TPUJobClient

    card = nvidia_smi()
    work = os.path.join(root, "served")
    os.makedirs(work)
    tokens = os.path.join(work, "tokens")
    with open(tokens, "w") as f:
        f.write(f"{SERVED_ADMIN_TOKEN} admin\n{SERVED_READ_TOKEN} "
                "read-only\n")
    try:
        import cryptography  # noqa: F401
        tls = True
    except ImportError:
        tls = False
    emit({"phase": "served", "tls": tls,
          "transport": "https (self-signed bootstrap)" if tls else
          "http: the cryptography package does not import here"})
    port = _free_ports(1)[0]
    url = f"{'https' if tls else 'http'}://127.0.0.1:{port}"
    ca_file = os.path.join(work, "tls", "cert.pem") if tls else None
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs = []

    def start(name, argv):
        log = open(os.path.join(work, f"{name}.log"), "wb")
        procs.append((name, subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))

    def log_tail(name) -> str:
        with open(os.path.join(work, f"{name}.log"), "rb") as f:
            return f.read()[-4000:].decode(errors="replace")

    try:
        started = time.perf_counter()
        start("operator", [
            "tf_operator_tpu_torch", "--backend", "none", "--api-port",
            str(port), "--api-tokens-file", tokens, "--no-leader-elect",
            "--monitoring-port", "0", "--resync-period", "2"]
            + (["--api-self-signed-tls-dir", os.path.join(work, "tls")]
               if tls else []))
        try:
            wait_for_server(url, timeout=SERVED_START_S, ca_file=ca_file)
        except TimeoutError as err:
            raise AssertionError(f"served operator: {err}\n"
                                 f"{log_tail('operator')}")
        healthz_s = time.perf_counter() - started
        started = time.perf_counter()
        start("agent", [
            "tf_operator_tpu_torch.runtime.agent", "--server", url,
            "--name", SERVED_AGENT, "--chips", "1", "--address",
            "127.0.0.1", "--workdir", REPO, "--token-file", tokens]
            + (["--ca-cert", ca_file] if tls else []))
        client = TPUJobClient.connect(url, token=SERVED_ADMIN_TOKEN,
                                      ca_file=ca_file)
        try:
            wait_until(lambda: client.store.try_get(
                store_mod.NODES, "default", SERVED_AGENT) is not None,
                "the agent's Node", SERVED_START_S)
        except AssertionError as err:
            raise AssertionError(f"{err}\n{log_tail('agent')}")
        node_s = time.perf_counter() - started
        node = client.store.get(store_mod.NODES, "default", SERVED_AGENT)
        emit({"phase": "served", "tls": tls,
              "seconds_to_healthz": healthz_s,
              "seconds_to_node": node_s, "node_chips": node.spec.chips,
              "nvidia_smi": card})
        if node.spec.chips != 1:
            raise AssertionError(f"served node: {node.to_dict()}")

        client.create(operator_job(
            "served-smoke", [sys.executable, "-m",
                             "tf_operator_tpu_torch.train.gpu_smoke"],
            replicas=2))
        logs = served_job_line(client, "served-smoke", card, tls)
        check_served_smoke(client, logs, torch.cuda.get_device_name(0))

        gloo = operator_job(
            "served-gloo", [sys.executable, "-m",
                            "tf_operator_tpu_torch.train.dist_mnist",
                            "--device", "cpu", "--steps", "2"],
            replicas=2, accelerator="")
        spec = gloo.spec.replica_specs["worker"].template.spec
        spec.containers[0].env["TPUJOB_JAX_DISTRIBUTED"] = "1"
        client.create(gloo)
        logs = served_job_line(client, "served-gloo", card, tls)
        if ("distributed: 2 processes" not in logs["served-gloo-worker-0"]
                or not all("done:" in log for log in logs.values())
                or len(logs) != 2):
            raise AssertionError(f"served-gloo: {logs}")
        emit({"phase": "served", "tls": tls,
              "auth": check_served_auth(url, ca_file)})
    finally:
        for name, proc, log in reversed(procs):
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
            if proc.returncode not in (0, -signal.SIGTERM):
                print(f"served {name} exited {proc.returncode}:\n"
                      f"{log_tail(name)}", file=sys.stderr)


KUBE_NODE = "kube-gpu-node"
KUBE_START_S = 60           # deadline of the operator's and agent's start
KUBE_HEARTBEAT_S = 1.0      # the node agent's heartbeat period
KUBE_NOTICE = json.dumps({"barrier": "chip-smoke-kube",
                          "reason": "ScheduledMaintenance"}, sort_keys=True)
KUBECONFIG = """\
apiVersion: v1
kind: Config
current-context: chip-smoke
contexts:
  - name: chip-smoke
    context: {{cluster: fake, user: operator}}
clusters:
  - name: fake
    cluster: {{server: "{server}"}}
users:
  - name: operator
    user: {{}}
"""


class FakeKubelet:
    """This script as the kubelet of one node of the port's fake API
    server with one card: each pod the binder bound to the node runs as
    a subprocess of its container's command and rendered env, with
    ``CUDA_VISIBLE_DEVICES`` the node's card, once no other pod holds the
    card; its phase and log go back through the fake's ``set_pod_phase``
    and ``set_pod_log``."""

    def __init__(self, fake, node: str, card: str, work: str):
        self.fake, self.node, self.card, self.work = fake, node, card, work
        self.procs = {}      # pod name -> (Popen, log path)
        self.done = {}       # pod name -> exit code
        self.envs = {}       # pod name -> the env it ran with
        self.started = {}    # pod name -> time.time() at start
        self.uids = {}       # pod name -> the uid of the pod it ran

    def tick(self) -> None:
        for name, (proc, log_path) in list(self.procs.items()):
            if proc.poll() is None:
                continue
            del self.procs[name]
            self.done[name] = proc.returncode
            with open(log_path, errors="replace") as f:
                self.fake.state.set_pod_log("default", name, f.read())
            self.fake.state.set_pod_phase(
                "default", name,
                "Succeeded" if proc.returncode == 0 else "Failed",
                exit_code=proc.returncode)
        for raw in self.fake.state.list("pods", "default", "")["items"]:
            name = raw["metadata"]["name"]
            if (raw["spec"].get("nodeName") != self.node
                    or name in self.procs or name in self.done
                    or (raw.get("status") or {}).get("phase") not in (
                        None, "", "Pending")
                    or self.procs):     # the one card is held
                continue
            container = raw["spec"]["containers"][0]
            env = {e["name"]: e.get("value", "")
                   for e in container.get("env") or []}
            env.update(PATH=os.environ.get("PATH", "/usr/bin:/bin"),
                       PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=self.card)
            for var in ("HOME", "LANG"):
                if var in os.environ:
                    env[var] = os.environ[var]
            log_path = os.path.join(self.work, f"{name}.log")
            with open(log_path, "wb") as log:
                proc = subprocess.Popen(
                    list(container.get("command") or [])
                    + list(container.get("args") or []),
                    cwd=container.get("workingDir") or REPO, env=env,
                    stdout=log, stderr=subprocess.STDOUT)
            self.procs[name], self.envs[name] = (proc, log_path), env
            self.started[name] = time.time()
            self.uids[name] = raw["metadata"]["uid"]
            self.fake.state.set_pod_phase("default", name, "Running")

    def stop(self) -> None:
        for proc, _ in self.procs.values():
            proc.kill()
            proc.wait()


def kube_job(name: str, work: str):
    """gpu-smoke as 2 workers at h100-1 under a checkpoint policy (which
    wires its pods to the node agent's relay directory)."""
    from tf_operator_tpu_torch.api.types import CheckpointPolicy

    job = operator_job(name, [sys.executable, "-m",
                              "tf_operator_tpu_torch.train.gpu_smoke"],
                       replicas=2)
    job.metadata.namespace = "default"
    job.spec.run_policy.checkpoint_policy = CheckpointPolicy(
        enabled=True, directory=os.path.join(work, "ckpt"),
        interval_steps=100000)
    return job


def phase_kube(root: str):
    """The Kubernetes plane (module docstring, phase 21): the port's
    operator on --backend kube and its node agent as processes against
    the port's fake API server, a TPUJob CR from connect_kube, this
    script as the node's kubelet."""
    from tf_operator_tpu_torch.api import constants
    from tf_operator_tpu_torch.controller import conditions as cond
    from tf_operator_tpu_torch.runtime.kube_fake import FakeKubeApiServer
    from tf_operator_tpu_torch.sdk import TPUJobClient

    card = nvidia_smi()
    device_name = torch.cuda.get_device_name(0)
    visible = [c for c in os.environ.get("CUDA_VISIBLE_DEVICES",
                                         "").split(",") if c.strip()]
    node_card = visible[0] if visible else "0"
    work = os.path.join(root, "kube")
    relay = os.path.join(work, "relay")
    os.makedirs(relay)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs = []

    def start(name, argv):
        log = open(os.path.join(work, f"{name}.log"), "wb")
        procs.append((name, subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))

    def log_tail(name) -> str:
        with open(os.path.join(work, f"{name}.log"), "rb") as f:
            return f.read()[-4000:].decode(errors="replace")

    def heartbeat():
        node = fake.state.get("nodes", "", KUBE_NODE)
        return (node["metadata"].get("annotations") or {}).get(
            constants.ANNOTATION_AGENT_HEARTBEAT)

    fake = FakeKubeApiServer().start()
    kubelet = FakeKubelet(fake, KUBE_NODE, node_card, work)
    try:
        fake.state.add_node(KUBE_NODE, chips=1, nvlink_domain="chip-smoke")
        kubeconfig = os.path.join(work, "kubeconfig")
        with open(kubeconfig, "w") as f:
            f.write(KUBECONFIG.format(server=fake.url))
        started = time.perf_counter()
        start("agent", [
            "tf_operator_tpu_torch.runtime.nodeagent", "--node", KUBE_NODE,
            "--relay-dir", relay, "--kubeconfig", kubeconfig,
            "--heartbeat-seconds", str(KUBE_HEARTBEAT_S),
            "--ckpt-poll-seconds", "0.2"])
        try:
            wait_until(lambda: heartbeat() is not None,
                       "the agent's first heartbeat", KUBE_START_S)
        except AssertionError as err:
            raise AssertionError(f"{err}\n{log_tail('agent')}")
        heartbeat_s = time.perf_counter() - started
        start("operator", [
            "tf_operator_tpu_torch", "--backend", "kube", "--kubeconfig",
            kubeconfig, "--enable-gang-scheduling",
            "--enable-ckpt-coordination", "--agent-relay-dir", relay,
            "--no-leader-elect", "--monitoring-port", "0",
            "--resync-period", "2"])
        client = TPUJobClient.connect_kube(kubeconfig)
        name = "kube-smoke"
        client.create(kube_job(name, work))
        notice_s = notice_stamped = None
        deadline = time.monotonic() + OPERATOR_TIMEOUT_S
        while True:
            kubelet.tick()
            job = client.get(name)
            if cond.is_succeeded(job.status) or cond.is_failed(job.status):
                break
            running = sorted(kubelet.procs)
            if notice_stamped is None and running:
                # The checkpoint coordinator's stamp, made by hand: the
                # agent must relay it to the pod's notice file.
                fake.state.patch("pods", "default", running[0], {
                    "metadata": {"annotations": {
                        constants.ANNOTATION_PREEMPT_NOTICE: KUBE_NOTICE}}})
                notice_stamped = (running[0], time.perf_counter())
            if notice_stamped is not None and notice_s is None:
                path = kubelet.envs[notice_stamped[0]].get(
                    constants.ENV_PREEMPT_FILE, "")
                if path and os.path.exists(path):
                    with open(path) as f:
                        if f.read() == KUBE_NOTICE:
                            notice_s = time.perf_counter() - notice_stamped[1]
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"kube: {name} not done after {OPERATOR_TIMEOUT_S} s: "
                    f"{job.status.to_dict()}\n{log_tail('operator')}")
            time.sleep(0.05)
        while notice_s is None and time.monotonic() < deadline:
            path = kubelet.envs[notice_stamped[0]].get(
                constants.ENV_PREEMPT_FILE, "")
            if path and os.path.exists(path):
                notice_s = time.perf_counter() - notice_stamped[1]
            time.sleep(0.05)
        beat = heartbeat()
        beat_age = (datetime.datetime.now(datetime.timezone.utc)
                    - datetime.datetime.fromisoformat(beat)).total_seconds()
        logs = client.get_job_logs(name)
        pods = {p.metadata.name: p for p in client.get_pods(name)}
        envs = {pod: bootstrap_env(log) for pod, log in logs.items()}
        status, created = job.status, job.metadata.creation_timestamp
        since = lambda t: None if t is None else (t - created).total_seconds()
        emit({"phase": "kube", "job": name, "nvidia_smi": card,
              "node_card": node_card,
              "conditions": [c.type for c in status.conditions
                             if c.status == "True"],
              "seconds_to_all_replicas_ready": since(
                  status.all_replicas_ready_time),
              "seconds_to_completion": since(status.completion_time),
              "agent_seconds_to_heartbeat": heartbeat_s,
              "heartbeat_age_s": beat_age,
              "notice_relay_s": notice_s,
              "pods": {pod: {"node": p.spec.node_name,
                             "gpus": p.spec.containers[0].resources.get(
                                 constants.RESOURCE_GPU),
                             "env": {k: envs.get(pod, {}).get(k) for k in (
                                 "CUDA_VISIBLE_DEVICES", "RANK",
                                 "LOCAL_WORLD_SIZE", "WORLD_SIZE")}}
                       for pod, p in sorted(pods.items())},
              "log_tails": {pod: log.splitlines()[-OPERATOR_LOG_LINES:]
                            for pod, log in sorted(logs.items())}})
        if (not cond.is_succeeded(status) or len(pods) != 2
                or sorted(envs) != sorted(pods)
                or any(p.spec.node_name != KUBE_NODE
                       or p.spec.containers[0].resources.get(
                           constants.RESOURCE_GPU) != "1"
                       for p in pods.values())
                or sorted(e.get("RANK") for e in envs.values()) != ["0", "1"]
                or any((e.get("CUDA_VISIBLE_DEVICES"),
                        e.get("LOCAL_WORLD_SIZE")) != (node_card, "1")
                       for e in envs.values())
                or not all(f"({device_name}): matmul sum" in log
                           and "smoke OK on 1 device(s)" in log
                           for log in logs.values())
                or notice_s is None
                or not 0 <= beat_age < 5 * KUBE_HEARTBEAT_S):
            raise AssertionError(
                f"kube: status {status.to_dict()}, pods "
                f"{[p.to_dict() for p in pods.values()]}, env {envs}, "
                f"notice {notice_s}, heartbeat age {beat_age}, logs {logs}"
                f"\n{log_tail('operator')}\n{log_tail('agent')}")
    finally:
        kubelet.stop()
        for pname, proc, log in reversed(procs):
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
            if proc.returncode not in (0, -signal.SIGTERM):
                print(f"kube {pname} exited {proc.returncode}:\n"
                      f"{log_tail(pname)}", file=sys.stderr)
        fake.stop()


FAILOVER_NODE = "failover-gpu-node"
FAILOVER_IDENTITIES = ("operator-a", "operator-b")
FAILOVER_JOB = "failover-resnet"
# ResNet-50 at B=64 takes 0.0736-0.1059 s a step on an H100 80GB HBM3 at
# 700 W (this phase): 500 steps train at least 36.7 s after the kill,
# past the takeover's limit (26 s after it) plus
# FAILOVER_AFTER_TAKEOVER_S.
FAILOVER_STEPS = 500
FAILOVER_AFTER_TAKEOVER_S = 10.0
FAILOVER_SLACK_S = 5.0      # beyond LEASE_DURATION + 2 RETRY_PERIOD
STEP_LINE = re.compile(r"^step (\d+): loss=", re.M)


def failover_command(steps: int) -> list:
    """The worker's command: the operator phase's ResNet-50 payload,
    unbuffered so each step reaches the log as it is taken."""
    return [sys.executable, "-u", "-m",
            "tf_operator_tpu_torch.train.train_resnet", "--size", "50",
            "--steps", str(steps), "--batch-size", "64", "--image-size",
            "224"]


def lease_holder(fake, name: str):
    """(holder identity, transitions) of the Lease ``name``; ("", 0)
    while it does not exist."""
    raw = fake.state.objects["leases"].get(("default", name))
    spec = (raw or {}).get("spec") or {}
    return spec.get("holderIdentity") or "", spec.get("leaseTransitions") or 0


def phase_failover(root: str):
    """The two-replica deployment of manifests/gpu losing its leader
    mid-job (module docstring, phase 22)."""
    from tf_operator_tpu_torch import cli
    from tf_operator_tpu_torch.api import constants
    from tf_operator_tpu_torch.controller import conditions as cond
    from tf_operator_tpu_torch.runtime.kube_fake import FakeKubeApiServer
    from tf_operator_tpu_torch.runtime.leaderelection import (
        DEFAULT_LOCK_NAME,
    )
    from tf_operator_tpu_torch.sdk import TPUJobClient

    card = nvidia_smi()
    visible = [c for c in os.environ.get("CUDA_VISIBLE_DEVICES",
                                         "").split(",") if c.strip()]
    node_card = visible[0] if visible else "0"
    work = os.path.join(root, "failover")
    relay = os.path.join(work, "relay")
    os.makedirs(relay)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    procs = {}       # name -> (Popen, log file)
    takeover_limit = (cli.LEASE_DURATION + 2 * cli.RETRY_PERIOD
                      + FAILOVER_SLACK_S)

    def start(name, argv):
        log = open(os.path.join(work, f"{name}.log"), "wb")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), log)

    def log_tail(name) -> str:
        with open(os.path.join(work, f"{name}.log"), "rb") as f:
            return f.read()[-4000:].decode(errors="replace")

    fake = FakeKubeApiServer().start()
    # The fake's record of creates: (pod, uid, replica index).
    creates = []
    state_create = fake.state.create

    def record_create(resource, ns, obj):
        out = state_create(resource, ns, obj)
        if resource == "pods":
            meta = out["metadata"]
            creates.append((meta["name"], meta["uid"], (meta.get(
                "labels") or {}).get(constants.LABEL_REPLICA_INDEX)))
        return out

    fake.state.create = record_create
    kubelet = FakeKubelet(fake, FAILOVER_NODE, node_card, work)
    pod = f"{FAILOVER_JOB}-worker-0"
    pod_log = os.path.join(work, f"{pod}.log")
    peak = {"gpus_bound": 0, "processes": 0}
    step_seen = {}   # step -> time.perf_counter() it was first seen

    def pod_phase():
        raw = fake.state.objects["pods"].get(("default", pod))
        return ((raw or {}).get("status") or {}).get("phase")

    def tick():
        kubelet.tick()
        bound = 0
        for raw in list(fake.state.objects["pods"].values()):
            if (raw["spec"].get("nodeName") == FAILOVER_NODE
                    and (raw.get("status") or {}).get("phase")
                    not in ("Succeeded", "Failed")):
                limits = ((raw["spec"]["containers"][0].get("resources")
                           or {}).get("limits") or {})
                bound += int(limits.get(constants.RESOURCE_GPU, 0))
        peak["gpus_bound"] = max(peak["gpus_bound"], bound)
        peak["processes"] = max(peak["processes"], len(kubelet.procs))
        if os.path.exists(pod_log):
            with open(pod_log, errors="replace") as f:
                for m in STEP_LINE.finditer(f.read()):
                    step_seen.setdefault(int(m.group(1)),
                                         time.perf_counter())

    try:
        t_start = time.perf_counter()
        fake.state.add_node(FAILOVER_NODE, chips=1,
                            nvlink_domain="chip-smoke")
        kubeconfig = os.path.join(work, "kubeconfig")
        with open(kubeconfig, "w") as f:
            f.write(KUBECONFIG.format(server=fake.url))
        start("agent", [
            "tf_operator_tpu_torch.runtime.nodeagent", "--node",
            FAILOVER_NODE, "--relay-dir", relay, "--kubeconfig", kubeconfig,
            "--heartbeat-seconds", str(KUBE_HEARTBEAT_S)])
        for identity in FAILOVER_IDENTITIES:
            start(identity, [
                "tf_operator_tpu_torch", "--backend", "kube",
                "--kubeconfig", kubeconfig, "--enable-gang-scheduling",
                "--enable-ckpt-coordination", "--agent-relay-dir", relay,
                "--leader-elect", "--leader-elect-identity", identity,
                "--monitoring-port", "0", "--resync-period", "2"])
        try:
            wait_until(lambda: lease_holder(fake, DEFAULT_LOCK_NAME)[0]
                       in FAILOVER_IDENTITIES, "a leader", KUBE_START_S)
        except AssertionError as err:
            raise AssertionError(f"{err}\n{log_tail(FAILOVER_IDENTITIES[0])}")
        leader_s = time.perf_counter() - t_start
        client = TPUJobClient.connect_kube(kubeconfig)
        job = operator_job(FAILOVER_JOB, failover_command(FAILOVER_STEPS))
        job.metadata.namespace = "default"
        client.create(job)

        # Running and training: the first step is in the worker's log.
        deadline = time.monotonic() + OPERATOR_TIMEOUT_S
        while not (pod in kubelet.procs and step_seen):
            tick()
            if pod in kubelet.done or time.monotonic() > deadline:
                raise AssertionError(
                    f"failover: {pod} never trained: "
                    f"{client.get(FAILOVER_JOB).status.to_dict()}\n"
                    f"{log_tail(FAILOVER_IDENTITIES[0])}")
            time.sleep(0.05)
        leader, _ = lease_holder(fake, DEFAULT_LOCK_NAME)
        standby = next(i for i in FAILOVER_IDENTITIES if i != leader)
        raw = fake.state.objects["pods"][("default", pod)]
        before = {"uid": raw["metadata"]["uid"],
                  "pid": kubelet.procs[pod][0].pid,
                  "card": kubelet.envs[pod].get("CUDA_VISIBLE_DEVICES"),
                  "node": raw["spec"].get("nodeName")}
        steps_at_kill = len(step_seen)
        killed = procs[leader][0]
        killed.send_signal(signal.SIGKILL)   # releases nothing
        t_kill = time.perf_counter()
        first_step_s = min(step_seen.values()) - t_start
        killed.wait(timeout=30)

        takeover_s = running_at_takeover = running_after = None
        steps_at_takeover = None
        while True:
            tick()
            now = time.perf_counter()
            if takeover_s is None:
                if lease_holder(fake, DEFAULT_LOCK_NAME)[0] == standby:
                    takeover_s = now - t_kill
                    steps_at_takeover = len(step_seen)
                    running_at_takeover = (pod in kubelet.procs
                                           and pod_phase() == "Running")
                elif now - t_kill > takeover_limit:
                    raise AssertionError(
                        f"failover: {standby} did not take the lease within "
                        f"{takeover_limit} s of the kill\n{log_tail(standby)}")
            elif (running_after is None
                    and now - t_kill >= takeover_s + FAILOVER_AFTER_TAKEOVER_S):
                running_after = (pod in kubelet.procs
                                 and pod_phase() == "Running")
            status = client.get(FAILOVER_JOB).status
            if cond.is_succeeded(status) or cond.is_failed(status):
                break
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"failover: {FAILOVER_JOB} not done after "
                    f"{OPERATOR_TIMEOUT_S} s: {status.to_dict()}\n"
                    f"{log_tail(standby)}")
            time.sleep(0.05)
        succeeded_s = time.perf_counter() - t_kill
        tick()
        raw = fake.state.objects["pods"].get(("default", pod)) or {}
        restarts = [c.get("restartCount") for c in
                    (raw.get("status") or {}).get("containerStatuses") or []]
        with open(pod_log, errors="replace") as f:
            log = f.read()
        steps = [int(m.group(1)) for m in STEP_LINE.finditer(log)]
        seen = sorted(step_seen.items())
        step_s = ((seen[-1][1] - seen[0][1]) / (len(seen) - 1)
                  if len(seen) > 1 else None)
        holder, transitions = lease_holder(fake, DEFAULT_LOCK_NAME)
        emit({"phase": "failover", "job": FAILOVER_JOB, "nvidia_smi": card,
              "node_card": node_card, "leader": leader, "standby": standby,
              "leader_exit": killed.returncode,
              "seconds_to_leader": leader_s,
              "seconds_to_first_step": first_step_s,
              "lease_takeover_seconds": takeover_s,
              "takeover_limit_s": takeover_limit,
              "kill_to_succeeded_seconds": succeeded_s,
              "steps": FAILOVER_STEPS, "step_s": step_s,
              "steps_before_kill": steps_at_kill,
              "steps_at_takeover": steps_at_takeover,
              "training_after_takeover_s": (
                  None if takeover_s is None
                  else seen[-1][1] - t_kill - takeover_s),
              "running_at_takeover": running_at_takeover,
              "running_10s_after_takeover": running_after,
              "lease": {"holder": holder, "transitions": transitions},
              "pod": {"uid_unchanged": raw.get("metadata", {}).get("uid")
                      == before["uid"] == kubelet.uids.get(pod),
                      "pid": before["pid"], "card": before["card"],
                      "node": before["node"], "restart_counts": restarts,
                      "exit": kubelet.done.get(pod)},
              "pod_creates": creates,
              "peak_gpus_bound": peak["gpus_bound"],
              "peak_processes": peak["processes"],
              "log_tail": log.splitlines()[-OPERATOR_LOG_LINES:]})
        problems = []
        if not cond.is_succeeded(status):
            problems.append(f"the CR ended {status.to_dict()}")
        if killed.returncode != -signal.SIGKILL:
            problems.append(f"the leader exited {killed.returncode}")
        if takeover_s is None or takeover_s > takeover_limit:
            problems.append(f"lease taken over after {takeover_s} s")
        if holder != standby or transitions < 1:
            problems.append(f"lease held by {holder!r}, {transitions} "
                            "transitions")
        if not running_at_takeover or not running_after:
            problems.append(
                f"the worker was not Running at the takeover "
                f"({running_at_takeover}) and {FAILOVER_AFTER_TAKEOVER_S} s "
                f"after it ({running_after}): size FAILOVER_STEPS up")
        if (raw.get("metadata", {}).get("uid") != before["uid"]
                or kubelet.uids.get(pod) != before["uid"]
                or sorted(kubelet.started) != [pod]
                or kubelet.done.get(pod) != 0 or restarts != [0]
                or before["card"] != node_card
                or before["node"] != FAILOVER_NODE):
            problems.append(
                f"the worker was not adopted: before {before}, after "
                f"{raw.get('metadata', {}).get('uid')} restarts {restarts} "
                f"runs {sorted(kubelet.started)} exit {kubelet.done}")
        if (steps != list(range(FAILOVER_STEPS))
                or log.count("device:") != 1
                or "resnet training OK" not in log):
            problems.append(f"the step log did not run on from 0 once: "
                            f"{len(steps)} step lines, "
                            f"{log.count('device:')} starts")
        if [(i) for _, _, i in creates] != ["0"]:
            problems.append(f"pod creates {creates}")
        if peak["gpus_bound"] > 1 or peak["processes"] > 1:
            problems.append(f"the card was given to two pods: {peak}")
        if problems:
            raise AssertionError(
                "failover: " + "; ".join(problems) + f"\n{log_tail(standby)}")
    finally:
        kubelet.stop()
        # Every process is told to stop first, so their shutdowns overlap.
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.terminate()
        for pname, (proc, log) in reversed(list(procs.items())):
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.close()
            if proc.returncode not in (0, -signal.SIGTERM, -signal.SIGKILL):
                print(f"failover {pname} exited {proc.returncode}:\n"
                      f"{log_tail(pname)}", file=sys.stderr)
        fake.stop()


# ---------------------------------------------------------------------------
# The installed port: its wheel, installed read-only, run from outside the
# checkout
# ---------------------------------------------------------------------------

# The image's build context (build/images/tpu_operator_torch/Dockerfile):
# what the port's wheel is built from.
WHEEL_CONTEXT = ("pyproject.toml", "README.md", "tf_operator_tpu_torch")
# pip offline: no index, no build isolation (setuptools comes with torch),
# no version check.
PIP = (sys.executable, "-m", "pip", "--disable-pip-version-check")
INSTALLED_STEP_S = 600      # deadline of each step of the installed phase
INSTALLED_TOKEN = "chip-smoke-installed"
INSTALLED_BATCH = 64        # the ResNet payload's batch


def under(path: str, root: str) -> bool:
    path, root = os.path.realpath(path), os.path.realpath(root)
    return os.path.commonpath([path, root]) == root


def build_wheel(work: str) -> dict:
    """The port's wheel, built in a copy of the image's build context (so
    setuptools' build/ and *.egg-info stay out of the checkout) and
    installed with --target into ``<work>/site``, made read-only."""
    src, wheels = os.path.join(work, "src"), os.path.join(work, "wheel")
    site = os.path.join(work, "site")
    os.makedirs(src)
    for name in WHEEL_CONTEXT:
        path = os.path.join(REPO, name)
        if os.path.isdir(path):
            shutil.copytree(path, os.path.join(src, name),
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy2(path, src)
    seconds = {}

    def pip(step, *args):
        t0 = time.perf_counter()
        proc = subprocess.run([*PIP, *args], cwd=work, capture_output=True,
                              text=True, timeout=INSTALLED_STEP_S)
        seconds[step] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"pip {step} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")

    pip("wheel", "wheel", "--no-deps", "--no-build-isolation", "--no-index",
        "--wheel-dir", wheels, src)
    found = [os.path.join(wheels, n) for n in os.listdir(wheels)
             if n.endswith(".whl")]
    if len(found) != 1:
        raise AssertionError(f"pip wheel made {found}")
    with zipfile.ZipFile(found[0]) as whl:
        files = whl.namelist()
    pip("install", "install", "--no-deps", "--no-index", "--target", site,
        found[0])
    subprocess.run(["chmod", "-R", "a-w", site], check=True, timeout=60)
    return {"wheel": os.path.basename(found[0]), "wheel_files": len(files),
            "site": site, "seconds": seconds}


def installed_env(work: str, site: str) -> dict:
    """This process's env with the install as the only PYTHONPATH and a
    fresh HOME and XDG_CACHE_HOME."""
    home = os.path.join(work, "home")
    os.makedirs(home, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONHOME", "PYTHONUSERBASE")}
    env.update(PYTHONPATH=site, HOME=home,
               XDG_CACHE_HOME=os.path.join(home, ".cache"))
    return env


def tree_state(root: str) -> list:
    """Every path under ``root`` with its mode and a file's mtime,
    bytecode caches left out (Python writes them where it may and skips
    them where it may not). The superuser writes through a read-only
    mode, so an install is shown untouched by comparing this before and
    after."""
    state = []
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in dirs + files:
            path = os.path.join(dirpath, name)
            st = os.lstat(path)
            # A directory's mtime moves when a cache appears in it.
            state.append((os.path.relpath(path, root), st.st_mode,
                          None if name in dirs else st.st_mtime_ns))
    return sorted(state, key=str)


def native_digest() -> str:
    """sha256 of the first batch of images_pipeline (the native loader,
    loader.cc) and of SyntheticImages (batchgen.cc) at the ResNet
    payload's batch and size, seed 0."""
    digest = hashlib.sha256()
    with images_pipeline(INSTALLED_BATCH, RESNET_IMAGE) as loader:
        batches = [next(loader)]
    batches.append(next(iter(SyntheticImages(INSTALLED_BATCH,
                                             RESNET_IMAGE))))
    for batch in batches:
        for key in sorted(batch):
            digest.update(np.ascontiguousarray(batch[key]).tobytes())
    return digest.hexdigest()


def installed_check() -> int:
    """Run by phase_installed as ``chip_smoke.py --installed-check`` in a
    copy of this script outside the checkout, the port on PYTHONPATH from
    the read-only install alone: every kernel library built by nvcc from
    the installed csrc/ into the fresh cache, then fwd, dQ and dK/dV
    once each at the main path's shape, held to their plain versions by
    check_case (which must also reject its perturbed outputs); then the
    native data path built by g++ from the installed native/ into the
    cache (native_digest). One JSON line."""
    import tf_operator_tpu_torch

    site, cache = os.environ["PYTHONPATH"], str(_paths.cache_root())
    modules = {m.__name__: m.__file__
               for m in (tf_operator_tpu_torch, _paths, _build, fa, native)}
    t0 = time.perf_counter()
    phase_build()
    nvcc_s = time.perf_counter() - t0
    libraries = {name: {"nvcc_seconds": seconds, "library": path}
                 for name, (seconds, path, _) in _build.build_info.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launches()
    t0 = time.perf_counter()
    case, _ = check_case(torch.Generator(device="cuda").manual_seed(0),
                         S, S, True, 0, False)
    kernels_s = time.perf_counter() - t0
    launches = {n: c for n, c in fa.LAUNCHES.items() if c}
    missed = [(p, n) for p, ratios in case["perturbed_ratio"].items()
              for n, r in ratios.items() if r <= 1.0]
    missed += [p for p, ratios in case["domain_perturbed_ratio"].items()
               if max(ratios.values()) <= 1.0]
    t0 = time.perf_counter()
    digest = native_digest()
    native_s = time.perf_counter() - t0
    native_libraries = sorted(
        str(native.library_path(n)) for n in ("batchgen", "loader"))
    record = {"site": site, "cache": cache, "modules": modules,
              "libraries": libraries, "nvcc_s": nvcc_s,
              "kernels_s": kernels_s, "launches": launches,
              "ok": case["ok"], "max_abs_err": case["max_abs_err"],
              "checks": {n: c["ratio"] for n, c in case["checks"].items()},
              "perturbations_rejected": len(case["perturbed_ratio"])
              + len(case["domain_perturbed_ratio"]) - len(missed),
              "missed": missed, "native_s": native_s,
              "native_libraries": native_libraries, "native_digest": digest}
    emit(record)
    if (not all(under(f, site) for f in modules.values())
            or sorted(libraries) != sorted(fa._LIBRARY.values())
            or not all(under(lib["library"], cache) and lib["nvcc_seconds"]
                       > 0 for lib in libraries.values())
            or not all(under(p, cache) and os.path.exists(p)
                       for p in native_libraries)
            or not all(case["ok"].values()) or missed
            or launches != {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}):
        raise AssertionError(f"installed check: {record}")
    return 0


def phase_installed():
    """The port from its wheel (module docstring, phase 23)."""
    from tf_operator_tpu_torch.runtime.apiserver import wait_for_server
    from tf_operator_tpu_torch.sdk import TPUJobClient

    card = nvidia_smi()
    device_name = torch.cuda.get_device_name(0)
    work = tempfile.mkdtemp(prefix="chip-smoke-installed-")
    if under(work, REPO):
        raise AssertionError(f"{work} lies in the checkout")
    proc = None
    started = []    # the subprocesses still to stop on the way out
    try:
        wheel = build_wheel(work)
        site, seconds = wheel["site"], wheel["seconds"]
        before = tree_state(site)
        writable = [p for p, mode, _ in before if mode & 0o222]
        if writable:
            raise AssertionError(f"installed: writable {writable[:5]}")
        env = installed_env(work, site)
        run = os.path.join(work, "run")
        os.makedirs(run)
        shutil.copy2(os.path.abspath(__file__), run)
        visible = [c for c in os.environ.get("CUDA_VISIBLE_DEVICES",
                                             "").split(",") if c.strip()]
        cards = visible or ["0"]

        def start(step, argv, **extra):
            out = open(os.path.join(work, step + ".out"), "w+")
            started.append(subprocess.Popen(
                argv, cwd=run, env=dict(env, **extra), stdout=out,
                stderr=subprocess.STDOUT))
            return step, time.perf_counter(), out, started[-1]

        def finish(child):
            step, t0, out, proc = child
            try:
                proc.wait(timeout=INSTALLED_STEP_S)
            finally:
                seconds[step] = time.perf_counter() - t0
                out.seek(0)
                text = out.read()
                out.close()
            if proc.returncode != 0:
                raise AssertionError(f"installed {step} exited "
                                     f"{proc.returncode}:\n{text[-6000:]}")
            return text.splitlines()

        checked = json.loads(finish(start("check_process", [
            sys.executable, os.path.join(run, "chip_smoke.py"),
            "--installed-check"]))[-1])
        for step in ("nvcc", "kernels", "native"):
            seconds[step] = checked[f"{step}_s"]
        # The same batches from the checkout's build of the same sources.
        if checked["native_digest"] != native_digest():
            raise AssertionError(f"installed native batches differ from "
                                 f"the checkout's: {checked}")
        # The ResNet payload and the catalogue's smoke file run beside the
        # console script's job below.
        payload = start("payload", [
            sys.executable, "-m", "tf_operator_tpu_torch.train.train_resnet",
            "--size", "50", "--steps", "4", "--batch-size", "64",
            "--image-size", "224"])
        smoke_file = os.path.join(site, "tf_operator_tpu_torch", "examples",
                                  "smoke", "tpujob_smoke.yaml")
        smoke_copy, smoke_edits = card_copy(smoke_file, work)
        catalogue = start("catalogue_smoke", [
            sys.executable, "-m", "tf_operator_tpu_torch.run_local",
            smoke_copy, "--timeout", str(EXAMPLES_TIMEOUT_S)],
            CUDA_VISIBLE_DEVICES=cards[0])

        # The installed console script as the operator on the local
        # backend, its API served to this script as the SDK user.
        tokens = os.path.join(work, "tokens")
        with open(tokens, "w") as f:
            f.write(f"{INSTALLED_TOKEN} admin\n")
        port = _free_ports(1)[0]
        url = f"http://127.0.0.1:{port}"
        log_path = os.path.join(work, "operator.log")
        t0 = time.perf_counter()
        with open(log_path, "wb") as log:
            proc = subprocess.Popen(
                [os.path.join(site, "bin", "tpu-operator-torch"),
                 "--backend", "local", "--api-port", str(port),
                 "--api-tokens-file", tokens, "--no-leader-elect",
                 "--monitoring-port", "0", "--resync-period", "2"],
                cwd=run, env=dict(env, CUDA_VISIBLE_DEVICES=",".join(cards)),
                stdout=log, stderr=subprocess.STDOUT)
        try:
            wait_for_server(url, timeout=SERVED_START_S)
            client = TPUJobClient.connect(url, token=INSTALLED_TOKEN)
            client.create(operator_job(
                "gpu-smoke", [sys.executable, "-m",
                              "tf_operator_tpu_torch.train.gpu_smoke"],
                replicas=2))
            done = client.wait_for_job("gpu-smoke",
                                       timeout=OPERATOR_TIMEOUT_S)
            logs = client.get_job_logs("gpu-smoke")
            check_smoke_pods(client, logs, device_name, cards=cards)
        except BaseException:
            with open(log_path, "rb") as f:
                print(f.read()[-4000:].decode(errors="replace"),
                      file=sys.stderr)
            raise
        seconds["job"] = time.perf_counter() - t0
        payload = finish(payload)
        if "resnet training OK" not in payload:
            raise AssertionError(f"installed train_resnet: {payload}")
        catalogue = "\n".join(finish(catalogue))
        smoke_run = check_card_run("smoke/tpujob_smoke.yaml", 0, catalogue,
                                   cards[0], device_name)
        imported = "port imported from " + os.path.join(
            site, "tf_operator_tpu_torch")
        smoke_logs = run_local_logs(catalogue)
        if not all(imported in lines for lines in smoke_logs.values()):
            raise AssertionError(f"installed catalogue smoke: {catalogue}")
        changed = sorted(set(tree_state(site)) ^ set(before), key=str)
        status, created = done.status, done.metadata.creation_timestamp
        emit({"phase": "installed", "nvidia_smi": card,
              "wheel": wheel["wheel"], "wheel_files": wheel["wheel_files"],
              "nvcc_s": seconds["nvcc"], "seconds": seconds, "site": site,
              "site_changed": changed,
              "modules": checked["modules"],
              "libraries": checked["libraries"],
              "launches": checked["launches"],
              "kernel_checks": checked["checks"],
              "perturbations_rejected": checked["perturbations_rejected"],
              "native_libraries": checked["native_libraries"],
              "payload": payload[-2:],
              "catalogue_smoke": {"file": smoke_file, "edits": smoke_edits,
                                  "pods": smoke_run["pods"]},
              "job_seconds_to_completion": (
                  status.completion_time - created).total_seconds(),
              "pods_import_the_install": all(imported in log
                                             for log in logs.values())})
        if changed or not all(imported in log for log in logs.values()):
            raise AssertionError(f"installed: the install changed "
                                 f"{changed[:10]}, logs {logs}")
    finally:
        for child in started:
            if child.poll() is None:
                child.kill()
                child.wait()
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        subprocess.run(["chmod", "-R", "u+w", work], timeout=60)
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# The job catalogue (tf_operator_tpu_torch/examples/) through run_local
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(REPO, "tf_operator_tpu_torch", "examples")
# The catalogue files the examples phase runs on the card, with the line
# each pod's log must end in (a regular expression).
EXAMPLES_ON_CARD = {
    "smoke/tpujob_smoke.yaml": r"smoke OK on 1 device\(s\)",
    "llama_spmd/tpujob_llama.yaml": "llama training OK",
    "mixtral_moe/tpujob_mixtral.yaml": "mixtral training OK",
    "dist_mnist/tpujob_dist_mnist.yaml": r"done: loss \S+ -> \S+",
    "resnet_dp/tpujob_resnet.yaml": "resnet training OK",
    "dist_mnist/tpujob_dist_mnist_ps.yaml": r"done: first=\S+ last=\S+",
}
# The roles that hold no GPU, in JAX as in the port: their pods run on
# the host, by the device the operator names for them.
NO_GPU_ROLES = ("chief", "ps")
ON_HOST = "device: cpu (TPUJOB_DEVICE=cpu)"
# The rest of the catalogue, and why one card does not run it.
_FLAGGED = ("needs an operator started with its header's flags, which "
            "run_local does not take; its pods are the worker stub, which "
            "touches no device (tests/test_torch_examples.py runs it under "
            "those flags against the JAX file on the CPU)")
EXAMPLES_OFF_CARD = {
    "bert_gang/tpujob_bert.yaml": "a gang of 8 pods "
        "(schedulingPolicy.minAvailable 8) needs 8 cards at once as "
        "h100-1, and 64 as the file stands (h100-32: each pod one world "
        "of 8 processes, one a GPU, since a pod of several GPUs trains as "
        "one local world)",
    "checkpoint/tpujob_checkpoint.yaml": _FLAGGED,
    "elastic/tpujob_elastic.yaml": _FLAGGED,
    "quota/tpujob_quota.yaml": _FLAGGED,
    "rl/tpujob_rl.yaml": _FLAGGED,
    "serving/tpujob_serving.yaml": "needs --enable-serving and its 2 "
        "serving replicas up at once (they serve until the spool closes): "
        "2 cards",
    "dist_mnist/ps_networkpolicy.yaml": "a NetworkPolicy, no job",
    "quota/queues.yaml": "a queue config, no job",
}
EXAMPLES_TIMEOUT_S = 300
LLAMA_STEP = re.compile(r"^step (\d+): loss=(\S+)$")


def card_copy(path: str, out_dir: str):
    """The catalogue file ``path`` as a node of one card runs it, in a
    JSON copy under ``out_dir``: the two edits its comments ask for there
    (``--device cpu`` dropped from each command; spec.slice.accelerator
    h100-1, so each GPU-holding pod is given the card), and, where its
    workers take that card in turn, that the job waits for every one of
    them: spec.successPolicy AllWorkers where worker 0 would decide, and
    runPolicy.cleanPodPolicy None where a chief decides (its workers are
    then not reaped when it finishes first). Returns (the copy's path,
    the edits)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    edits = []
    specs = raw["spec"]["replicaSpecs"]
    for rtype, spec in specs.items():
        for c in spec["template"]["spec"]["containers"]:
            if c["command"][-2:] == ["--device", "cpu"]:
                c["command"] = c["command"][:-2]
                edits.append(f"{rtype}: --device cpu dropped")
    sl = raw["spec"].setdefault("slice", {})
    edits.append(f"spec.slice.accelerator: {sl.get('accelerator') or '-'}"
                 f" -> h100-1")
    sl["accelerator"] = "h100-1"
    workers = specs.get("worker", {}).get("replicas", 1) \
        if "worker" in specs else 0
    policy = raw["spec"].setdefault("runPolicy", {})
    if "chief" in specs and workers:
        if policy.get("cleanPodPolicy") != "None":
            edits.append(f"runPolicy.cleanPodPolicy: "
                         f"{policy.get('cleanPodPolicy') or '-'} -> None")
            policy["cleanPodPolicy"] = "None"
    elif workers > 1 and raw["spec"].get("successPolicy") != "AllWorkers":
        edits.append(f"spec.successPolicy: "
                     f"{raw['spec'].get('successPolicy') or '-'} -> "
                     f"AllWorkers")
        raw["spec"]["successPolicy"] = "AllWorkers"
    copy = os.path.join(out_dir, os.path.basename(path)[:-len(".yaml")]
                        + ".json")
    with open(copy, "w") as f:
        json.dump(raw, f, indent=1)
    return copy, edits


def run_local_logs(stdout: str) -> dict:
    """Pod name -> the non-empty lines of its log, from run_local's
    output."""
    logs, name = {}, None
    for line in stdout.splitlines():
        m = re.fullmatch(r"--- logs (\S+) ---", line)
        if m:
            name = m[1]
            logs[name] = []
        elif name is not None and line.strip():
            logs[name].append(line)
    return logs


def replica_pods(copy: str) -> dict:
    """Pod name -> role of every replica the job file ``copy`` makes."""
    with open(copy) as f:
        raw = json.load(f)
    job = raw["metadata"]["name"]
    return {f"{job}-{rtype}-{i}": rtype
            for rtype, spec in raw["spec"]["replicaSpecs"].items()
            for i in range(spec.get("replicas", 1))}


def snapshot_pod_logs(tmp: str, into: dict) -> None:
    """Read the pod logs a run_local whose TMPDIR is ``tmp`` is writing
    into ``into`` (pod name -> its non-empty lines): a pod its job's
    cleanPodPolicy reaps at the end (a ps server) takes its log with it
    before run_local prints the logs."""
    for path in glob.glob(os.path.join(tmp, "tpujob-logs-*", "*.log")):
        pod = os.path.basename(path).split(".")[1]
        try:
            with open(path, errors="replace") as f:
                lines = [line.rstrip("\n") for line in f if line.strip()]
        except OSError:
            continue
        if lines:
            into[pod] = lines


def check_card_run(rel: str, rc: int, stdout: str, card: str,
                   device_name: str, pods: dict = None,
                   read_live: dict = None) -> dict:
    """A catalogue file's run_local on the card: Succeeded, and pod by
    pod (``pods``: name -> role) each log ending in its payload's line,
    each payload where its pod's role puts it: a worker on the card it
    was given (gpu_smoke's env and matmul; the training payloads' device
    line), a chief or ps pod on the host by the operator's device key;
    the llama losses falling. A ps pod reaped at the job's end is read
    from ``read_live`` (its log as it ran), and serves to the last, so
    only its device is checked. ``pods`` defaults to the pods whose logs
    run_local printed. Returns what it read."""
    name = re.search(r"^TPUJob (\S+): (\S+)$", stdout, re.M)
    logs = run_local_logs(stdout)
    if pods is None:
        pods = {pod: pod.split("-")[-2] for pod in logs}
    read_live = read_live or {}
    found = {"rc": rc, "state": name and name[2],
             "pods": {p: lines[-3:] for p, lines in logs.items()}}
    bad = []
    if rc != 0 or not name or name[2] != "Succeeded" or not logs:
        bad.append("the job did not succeed")
    on_card = re.compile(rf"device: cuda(:\d+)? \({re.escape(device_name)}, "
                         rf"CUDA_VISIBLE_DEVICES={re.escape(card)}\)")
    for pod, role in pods.items():
        lines = logs.get(pod)
        if lines is None and role == "ps" and pod in read_live:
            lines = read_live[pod]
            found["pods"][pod] = ["(read while it ran)", *lines[:2]]
        elif not lines or not re.fullmatch(EXAMPLES_ON_CARD[rel],
                                           lines[-1]):
            bad.append(f"{pod} ends {(lines or [])[-1:]}")
            lines = lines or []
        devices = [line for line in lines if line.startswith("device:")]
        if role in NO_GPU_ROLES:
            if not devices or any(d != ON_HOST for d in devices):
                bad.append(f"{pod} ({role}, no GPU): {devices}")
            continue
        if not all(on_card.fullmatch(line) for line in devices):
            bad.append(f"{pod}: {devices}")
        if rel.startswith("smoke/"):
            env = bootstrap_env("\n".join(lines))
            if (env.get("CUDA_VISIBLE_DEVICES") != card or not any(
                    f"({device_name}): matmul sum" in line
                    for line in lines)):
                bad.append(f"{pod}: env {env}")
        elif not devices:
            bad.append(f"{pod}: no device line")
    if rel.startswith("llama_spmd/"):
        losses = [float(m[2]) for line in logs.get("llama-spmd-worker-0", [])
                  if (m := LLAMA_STEP.match(line))]
        found["losses"] = losses
        if len(losses) < 2 or not losses[-1] < losses[0]:
            bad.append(f"llama losses {losses}")
    if bad:
        raise AssertionError(f"{rel} on the card: {bad}\n{stdout[-3000:]}")
    return found


class CatalogueRuns:
    """The catalogue's run_locals on the card (phase examples), started
    at once before ``installed`` and run beside it: a thread reads the
    pods' logs as they run (``snapshot_pod_logs``) and notes when each
    run_local exits. ``finish`` waits for them and checks each run;
    ``stop`` kills what still runs."""

    def __init__(self):
        visible = [c for c in os.environ.get("CUDA_VISIBLE_DEVICES",
                                             "").split(",") if c.strip()]
        self.gpu = (visible or ["0"])[0]
        self.work = tempfile.mkdtemp(prefix="chip-smoke-examples-")
        self.procs, self.pods, self.read_live, self.seconds = {}, {}, {}, {}
        self._done = threading.Event()
        self._watcher = threading.Thread(target=self._watch, daemon=True)

    def start(self) -> "CatalogueRuns":
        listed = sorted([*EXAMPLES_ON_CARD, *EXAMPLES_OFF_CARD])
        catalogue = sorted(os.path.relpath(p, EXAMPLES) for p in glob.glob(
            os.path.join(EXAMPLES, "*", "*.yaml")))
        if listed != catalogue:
            raise AssertionError(f"the catalogue {catalogue} is not the "
                                 f"files run and listed {listed}")
        self.t0 = time.perf_counter()
        for rel in EXAMPLES_ON_CARD:
            out = os.path.join(self.work, rel[:-len(".yaml")])
            os.makedirs(out)
            copy, edits = card_copy(os.path.join(EXAMPLES, rel), out)
            with open(copy) as f:
                print(f"{rel} as run on the card ({'; '.join(edits)}): "
                      f"{json.dumps(json.load(f))}", flush=True)
            log = open(os.path.join(out, "run_local.out"), "w")
            # The backend's pod logs land under run_local's TMPDIR.
            tmp = os.path.join(out, "tmp")
            os.makedirs(tmp)
            self.pods[rel], self.read_live[rel] = replica_pods(copy), {}
            self.procs[rel] = (edits, log, tmp, subprocess.Popen(
                [sys.executable, "-m", "tf_operator_tpu_torch.run_local",
                 copy, "--timeout", str(EXAMPLES_TIMEOUT_S),
                 "--workdir", os.path.join(out, "pods")],
                cwd=REPO, env=dict(os.environ,
                                   CUDA_VISIBLE_DEVICES=self.gpu,
                                   TMPDIR=tmp),
                stdout=log, stderr=subprocess.STDOUT))
        self._watcher.start()
        return self

    def _watch(self) -> None:
        while not self._done.is_set() and len(self.seconds) < len(
                self.procs):
            for rel, (_, _, tmp, proc) in self.procs.items():
                if rel in self.seconds:
                    continue
                snapshot_pod_logs(tmp, self.read_live[rel])
                if proc.poll() is not None:
                    self.seconds[rel] = time.perf_counter() - self.t0
            self._done.wait(0.1)

    def finish(self) -> None:
        """Wait for every run_local, check each run and emit the phase's
        lines: the step ``examples`` (module docstring, phase 24)."""
        try:
            self._watcher.join(max(0.0, EXAMPLES_TIMEOUT_S + 60
                                   - (time.perf_counter() - self.t0)))
            if len(self.seconds) < len(self.procs):
                raise AssertionError(
                    f"run_local still running: "
                    f"{sorted(set(self.procs) - set(self.seconds))}")
            card = nvidia_smi()
            device_name = torch.cuda.get_device_name(0)
            runs, failed = {}, []
            for rel, (edits, log, _, proc) in self.procs.items():
                log.close()
                with open(log.name) as f:
                    stdout = f.read()
                try:
                    runs[rel] = check_card_run(
                        rel, proc.returncode, stdout, self.gpu, device_name,
                        self.pods[rel], self.read_live[rel])
                except AssertionError as err:
                    failed.append(str(err))
                    runs[rel] = {"rc": proc.returncode, "failed": True}
                emit({"phase": "examples", "file": rel, "edits": edits,
                      "seconds": self.seconds[rel], **runs[rel]})
            emit({"phase": "examples", "nvidia_smi": card, "card": self.gpu,
                  "files_run": len(self.procs),
                  "slowest_file_seconds": max(self.seconds.values()),
                  "seconds": self.seconds, "not_on_card": EXAMPLES_OFF_CARD,
                  "bert_gang": EXAMPLES_OFF_CARD[
                      "bert_gang/tpujob_bert.yaml"]})
            if failed:
                raise AssertionError("; ".join(failed))
        finally:
            self.stop()

    def stop(self) -> None:
        self._done.set()
        for _, log, _, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(self.work, ignore_errors=True)


def main() -> int:
    if sys.argv[1:] == ["--installed-check"]:
        return installed_check()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    started = time.perf_counter()
    run_phase("env", phase_env)
    run_phase("build", phase_build)
    stats, variants, errs = run_phase("kernels", phase_kernels)
    fp16_launches = run_phase("fp16_model", phase_fp16_model)
    ragged_launches = run_phase("ragged_train", phase_ragged_train)
    f32_launches = run_phase("f32_train", phase_f32_train)
    d256_launches = run_phase("d256_train", phase_d256_train)
    d512_launches = run_phase("d512_train", phase_wide_train, "d512_train",
                              512, D512_HEADS, D512_KV_HEADS, D512_STEPS, 5)
    d384_launches = run_phase("d384_train", phase_wide_train, "d384_train",
                              384, D384_HEADS, D384_KV_HEADS, D384_STEPS, 6)

    cfg = slice_config()
    model = Llama(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (B, S + 1))
    run_phase("model", phase_model, model,
              torch.as_tensor(tokens[:, :512], device="cuda"))
    batch = {"inputs": tokens}
    launches, step, state, full = run_phase("train", phase_train, model,
                                            batch)
    train_profile = run_phase("profile", phase_profile, step, state, batch)
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt-", dir=build)
    try:
        kept = run_phase("ckpt", phase_ckpt, step, state, batch, root)
        # Free the training model, optimizer and state (35.9 GiB at peak)
        # before another model is built.
        del model, step, state
        gc.collect()
        torch.cuda.empty_cache()
        run_phase("restore", phase_restore, kept, batch, root)
        del kept
        shutil.rmtree(os.path.join(root, "ckpt"), ignore_errors=True)
        dist_launches = run_phase("dist", phase_dist, batch, full["record"],
                                  train_profile, root)
        ring_launches = run_phase("ring", phase_ring)
        ring_train_launches = run_phase("ring_train", phase_ring_train,
                                        batch, full["record"])
        pp_launches_run = run_phase("pp", phase_pp)
        run_phase("tp_kv", phase_tp_kv)
        run_phase("remat", phase_remat, batch, full)
        del full
        run_phase("decode", phase_decode)
        run_phase("serve", phase_serve)
        run_phase("worker", phase_worker)
        run_phase("resume", phase_resume, root)
        run_phase("resnet", phase_resnet_all)
        mixtral_launches = run_phase("mixtral", phase_mixtral_all)
        bert_launches = run_phase("bert", phase_bert_all)
        run_phase("payloads", phase_payloads)
        run_phase("ps", phase_ps, root)
        run_phase("operator", phase_operator, root)
        run_phase("operator_planes", phase_operator_planes, root)
        run_phase("served", phase_served, root)
        run_phase("kube", phase_kube, root)
        run_phase("failover", phase_failover, root)
        # The catalogue's runs go beside the install's: both are
        # subprocesses, the catalogue's tiny on the card.
        catalogue = CatalogueRuns()
        try:
            catalogue.start()
            run_phase("installed", phase_installed)
        except BaseException:
            catalogue.stop()
            raise
        run_phase("examples", catalogue.finish)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # One entry a kernel (launch key): the wgmma D=128 kernels' numbers
    # from the training step's case and their launches from the train
    # phase; the wgmma D=256 kernels' from the bf16 D=256 case and the
    # d256_train phase; the 3xTF32 kernels' from the f32 D=128 case and
    # the f32_train phase; the D=384 ones' from the bf16 D=384 case and the
    # d384_train phase, the D=512 ones' from the bf16 D=512 case and the
    # d512_train phase; every timed variant under "variants".
    summary = []
    by_path = {"train": launches, "fp16_model": fp16_launches,
               "ragged_train": ragged_launches, "f32_train": f32_launches,
               "d256_train": d256_launches, "d512_train": d512_launches,
               "d384_train": d384_launches,
               "dist": dist_launches, "ring": ring_launches,
               "ring_train": ring_train_launches, "pp": pp_launches_run,
               "mixtral": mixtral_launches, "bert": bert_launches}
    main_paths = {"": "train", "_d256": "d256_train",
                  "_d384": "d384_train", "_d512": "d512_train",
                  "_f32tc": "f32_train"}
    for suffix in fa._FAMILY:
        for kind in fa.KINDS:
            kernel, name = f"flash_{kind}", f"flash_{kind}{suffix}"
            main_path = main_paths[suffix]
            st = stats[name]
            summary.append({
                "name": name, "route": "cuda", "source": SOURCE[suffix],
                "replaces": REPLACES[kernel],
                "launches": by_path[main_path][name], "main_path": main_path,
                "launches_by_path": {p: c[name] for p, c in by_path.items()},
                "max_abs_err": errs[name], "ms": st["ms"],
                "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                "bound_by": st["bound_by"], "library_ms": st["library_ms"],
                "timed_at": {k: st[k] for k in ("dtype", "d", "h", "hkv",
                                                 "sq", "sk")},
                "variants": [{k: row[k] for k in (
                    "dtype", "d", "h", "sq", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}
                    for row in variants if row["kernel"] == name]})
    emit({"phase": "total", "seconds": time.perf_counter() - started})
    emit({"phases": PHASES})
    emit({"kernels": summary})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
