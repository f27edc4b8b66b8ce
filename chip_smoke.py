#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; a failing phase raises and the script exits non-zero:

1. device  - the card's name and power limit (nvidia-smi) and torch's view.
2. build   - nvcc builds every kernel under ray_tpu_torch/ops/csrc/; then
             cuobjdump -sass counts the tensor-core instructions (HMMA,
             HGMMA) of every kernel: the bf16 flash forward and dQ kernels
             must have HGMMA (wgmma) and dK/dV HMMA (mma.sync) at every
             head dim, the f32 ones none, and no bf16 instantiation of a
             scalar flash body may exist; ptxas's registers and spill bytes
             per kernel are kept, and the bf16 dQ kernel must not spill.
3. kernels - each hand kernel against its plain PyTorch version on the
             card, on numpy-seeded inputs, with stated tolerances (the
             flash forward, its dQ and dK/dV backward kernels, paged
             decode's split and combine passes, with splits that hold no
             token); the bf16 forward on the same bf16 inputs, with a
             mean limit that a control (scores rounded to bf16 before the
             softmax) must miss at long T (also at Mixtral's D=128, G=4,
             T 16/128/2048, and at the `pipeline` path's B=1, T=1024,
             G=4 in f32 and bf16, forward and backward; paged decode also
             at D=128, G=4, page 64);
             the backward ones also against
             a control without the bf16 roundings that their limit must
             reject; a grad-tracking call launches forward, dQ and dK/dV
             once each. The flash kernels are checked again at the
             training shape, and dQ, dK and dV twice on the same inputs
             must be bit-equal.
             Then each is timed on the device (CUDA events
             around a CUDA-graph replay of back-to-back calls, host cost
             excluded; the eager per-call time is logged beside it) with
             its plain version, the least time the card could take (bound)
             and, where one exists, a single PyTorch call computing the
             same function. Paged decode is timed at the serving batch and
             at a long shape (B=8, lengths 2048), and at both under the
             split plans that aim at 2, 3, 4 and 8 CTAs an SM.
4. model   - the llama_1b decoder in f32: logits through the kernels (paged
             prefill and decode) against logits through the plain dense
             cache path, on one prompt.
5. slice   - the paged LLMServer at llama_1b width and depth, seeded random
             weights, serving requests through generate and generate_stream
             under asyncio; the kernel launch counters are reset just
             before and read just after, and must match layers x calls
             (no backward launch; a combine pass after every split pass
             whose plan has several splits); stats()["slo"] must hold TTFT
             and TPOT summaries, slo_snapshot() must count the waves'
             requests, a prefix digest must exist after the radix hit, and
             the trace ring (cleared before) must hold one
             `serve.decode_chunk` span a host sync. Then two more pairs of
             waves on fresh prompts of the same shapes, tracing on and
             RAY_TPU_TRACE=0, must take equal host syncs for equal tokens.
             One more wave runs under torch.profiler.
6. moe     - the MoE serving path at Mixtral-8x7B width (d_model 4096,
             32/8 heads, head_dim 128, ffn 14336, 8 experts top-2, vocab
             32000), depth cut to 8 of its 32 layers: (a) 2 layers in f32,
             logits and every token's top-2 expert ids through the kernels
             (B1 at D=128, G=4 on the first prefill chunk, B4 on a decode
             step) against the plain dense-cache path; (b) the paged
             LLMServer (bf16 weights from seed 0, dropless experts) serving
             the slice's two waves, with the same launch-count checks as
             the slice (path `serve_moe`), the SLO metrics (stats()["slo"],
             slo_snapshot()), a prefix digest, peak memory, and one wave
             under torch.profiler with the MoE einsums' share of device
             time; (c) B1 (B=1, T=128, H=32, Kh=8, D=128) and B4 (B=8, D=128,
             the wave's lengths) timed with their plain versions and SDPA.
7. replica - speculate=4 against speculate=0 (dense, f32: equal greedy
             ids), first on the tiny preset with CPU-seeded weights and a
             prompt whose drafts are accepted (accepted > 0), then at
             llama_1b width on a repeating prompt (accept rate logged);
             embed of 300 tokens through B1 against the plain path, and a
             merged LoRA adapter served for one request.
8. pd      - prefill/decode disaggregation at llama_1b width (path
             `serve_pd`): a colocated LLMServer, a PrefillServer and a
             PDServer on one set of weights; the slice's prompts one at a
             time with PD ids equal to colocated, the shared prefix not
             shipped again, shipped bytes per page, peak memory under one
             pool's growth, a pull over the KV data server and the whole-KV
             hand-off; then a concurrent wave with the launch-count checks
             (B1 per fresh first chunk on the prefill side, B4 per decode
             step of the PD server), its TTFT breakdown from the trace
             windows (one trace a request: one `serve.pd.queue` and one
             `serve.pd.first_decode` window, the `prefill` waits, the
             `kv_ship` segments and the prefill side's `prefill_chunk` and
             `kv_seal` spans, each family's p50 a request and its share of
             TTFT p50; the kv_seal pages equal to the pages shipped; beside
             them a stopwatch on the awaited prefill_begin, which no window
             covers) and the seal / install times a page. These paths,
             `runtime`, `serve_app` and `jobs` share one session of the
             port's runtime, opened here and shut down after `jobs` (every
             worker gone). Path `serve_pd_proc`: the same checks with the
             PrefillServer a serve deployment of the port's runtime
             (`EngineReplica` "prefill", num_gpus=1: its own process, two
             CUDA contexts sharing the card; its weights' digest equal to
             the colocated server's) reached through its
             DeploymentHandle: sequential ids equal the colocated
             server's, the shared prefix not shipped again, every segment
             attached here, a pull over the replica's KV data server and
             the whole-KV hand-off; the wave with B1 counted in the
             replica and B4 here, its TTFT p50/p99, tokens/s and breakdown
             with the replica's spans merged by trace id (each read
             through the handle); the seal ms a page in the replica, the
             install ms a page here; no `rtpt-*` segment left after the
             replica closes its shipping and its app is deleted. Path
             `runtime`
             (`run_runtime`): the port's own task/actor runtime. init()
             counts the card as {"GPU": 1}; a plain task's worker has
             none of torch, jax or ray_tpu loaded and a num_gpus=0 task
             sees no card; a 128 MiB bf16 tensor drawn by a num_gpus=1
             task lands on a card here, bit-equal; a num_gpus=1
             `EngineReplica` "llm" builds the slice's llama_1b server and answers
             the sequential prompts through .remote()/get with the
             colocated server's ids, its own B1 and B4 counters reset
             just before and read just after (as the slice's launch
             checks), its CUDA_VISIBLE_DEVICES equal to get_gpu_ids()
             and one card seen; a 128 MiB bf16 tensor from here lands on
             the actor's card, bit-equal; a second num_gpus=1 actor stays
             pending until the first is killed, then gets the card; a
             1 GiB CPU tensor through put -> get, timed, a write to one
             get leaving the next unchanged. Path `serve_app`
             (`run_serve_app`): Serve's deployment layer. The OpenAI app
             serve.deployment(OpenAIIngress).bind({"llama_1b": llm}), `llm`
             the slice's llama_1b server as a num_gpus=1 deployment
             (`EngineReplica` "llm"), the ingress a CPU replica, behind
             serve.start's HTTP proxy: the sequential prompts through
             the deployment's handle with the colocated server's ids, then
             as POST /v1/completions over http.client one at a time, as a
             concurrent wave, one `stream: true` request and a concurrent
             wave of streams: every answer 200 with the OpenAI shape, its
             text ByteTokenizer's decode of the ids the engine produced for
             it and usage their counts; B1 and B4 counted in the replica's
             process (this process's counts 0), the replica bound to the
             card; the replica's start, the first SSE event against the
             engine's TTFT, the proxy + ingress + handle ms a request and
             decode tokens/s logged. Path `jobs` (`run_jobs`), last in
             that session: the dashboard on port 0 reports "GPU" total 1,
             `python -m ray_tpu_torch topology` names the card and
             `status` (attached through RTPT_ADDRESS) lists the GPU; job
             A, submitted over HTTP with JobSubmissionClient, is a driver
             (`job_main`) that attaches, starts one unnamed num_gpus=1
             EngineReplica "llm" and serves the sequential prompts
             through an ActorPool of it: SUCCEEDED, its ids (read through
             /api/jobs/<id>/logs) the colocated server's, its actor's
             launches the `runtime` path's actor's, none in this process
             or the job's driver, which sees no card; job B, serving in a
             loop, is stopped once its first answer shows: STOPPED, the
             card free again, a new num_gpus=1 actor started on it, the
             job's actor listed dead. Path `cluster` (`run_cluster`), in a
             session of its own after that one closes: the port's runtime
             across nodes. This process is a head owning no card; a
             SubprocessNodeProvider bound to the card launches one node
             agent for sdk.request_resources(bundles=[{"GPU": 1}]):
             cluster_resources()["GPU"] 0 before it registers, 1 after; a
             num_gpus=1 actor lands on it (its parent the agent) on the
             card of this process's card-0 UUID; llama_1b's seeded bf16
             weights, put at the head, reach that actor's card as a
             method's argument (bytes, seconds and GB/s logged), then a
             num_gpus=1
             EngineReplica "llm" built from them on the node (its weights'
             digest equal) answers the sequential prompts with the
             colocated server's ids, B1 and B4 counted in its process as
             `runtime`'s are and 0 here; the agent's process group is
             SIGKILLed: nodes() drops to 1 within the heartbeat limit, the
             next call raises ActorDiedError, the reconciler launches a
             replacement node bound to the same card, and a replica there
             answers with the same ids (kill to its first answer logged).
   radix_visits - the slice's prompts twice through an in-process server
             (radix cache on, off, and on in f32): where a bf16 second
             visit differs from the first, the top-2 logit gap of the
             full forward in bf16 and in f32 against the bf16 row's
             distance from f32; the first visits equal the colocated
             ids, the second ones equal them with the cache off and in
             f32, and every bf16 difference sits inside bf16's rounding.
9. tiered  - radix KV demotion at llama_1b width (path `serve_tiered`): 8
             families of 1024-token prefixes round-robin on a 32-page pool
             with a 64 MiB stash, restored pages torch.equal to their
             bytes before eviction, ids equal a pool that never evicts,
             demoted/restored pages and disk objects counted, TTFT p50
             against RAY_TPU_SPILL_KV=0.
10. train   - the training step (ray_tpu_torch.train): (a) llama_1b width
             with 2 layers in f32, every parameter's gradient through the
             kernels against the plain attention path (and a TF32 control
             that the limit must reject), and the bf16 loss head at B=4,
             T=2048 against the same head widened to f32; (b) train_llama at
             llama_1b width and depth, B=4, T=2048, bf16, 2 warm-up and
             10 timed steps, counters reset before and read after (forward,
             dQ and dK/dV each 16 per step), finite losses and params; (c)
             one step with remat (forward 32 per step) whose loss matches
             (b)'s first; (d) one step under torch.profiler, in which the
             flash forward's, dQ's and dK/dV's device time must be the
             tensor-core kernels', 16 calls each.
11. trainer - the trainer's world (path `train_resume`): (a) util/gpu.py's
             topology, visible ids and peak rate and api._detect_gpus
             against the card and nvidia-smi; (b) a one-rank NCCL
             collective group (init_collective_group(1, 0, "nccl")) running
             every op on a bf16 tensor of one llama_1b layer's parameter
             count, each result equal to its input, each op timed, both
             barriers, and _world_info; (c) llama_1b, bf16, B=4, T=2048: 6
             steps fed by iter_device_batches(prefetch=2), checkpointed with
             Checkpoint.from_state (torch.save, about 5 GB, in a temporary
             directory removed at the end) after step 3, the same 6 steps
             fed by the plain copy (losses equal), then a fresh model and
             AdamW restored with to_state(target=...) taking steps 4-6 on a
             fresh iterator: params after the restore, losses and final
             params torch.equal to the uninterrupted run, forward, dQ and
             dK/dV 16 launches each per resumed step; the checkpoint's
             bytes, save and restore seconds and ms per step of each feed
             logged; (d) one step fed by the iterator under torch.profiler:
             the batch's host-to-device copy is a pinned copy on a stream
             other than the flash forward kernel's; (e) path `train_fit`:
             TorchTrainer(...).fit() over (c)'s loop and batches (given as
             datasets={"train": ...}, read through get_dataset_shard),
             CheckpointConfig(num_to_keep=1), FailureConfig(max_failures=1):
             6 steps each reporting {"loss", "step"}, checkpoints at steps 2
             and 4, step 3's first attempt raising before its report and the
             retry restoring from get_checkpoint(): no error, the history's
             losses, every loss tensor and the final params equal (c)'s
             uninterrupted run, only checkpoint_000001 (step 4) left and
             named by the result, forward, dQ and dK/dV 16 launches each per
             step taken (112 over 7); the fit's seconds, its ms a step
             against the bare loop's, each report() call, the saves, the
             report's checkpoint copies and the bytes left logged; path
             `train_fit_actor`: the same loop through
             TorchTrainer(use_worker_actor=True,
             ScalingConfig(use_gpu=True)) in a session of the port's
             runtime, a TrainWorker actor on the card whose process exits
             (os._exit(1)) at step 3 of its first attempt and is respawned
             on the card, resuming from step 2: the history equal (c)'s
             run A as floats, the final params' digest equal, B1-B3 16
             launches a step in each of the actor's processes and none in
             this one, the card back after the actor's death (a
             num_gpus=1 actor starts); ms a step in the actor and the
             restart's seconds logged; (f) path `ckpt_whole`: 4 gloo ranks on CPU tensors write llama_1b's
             seeded bf16 weights and AdamW state (one optimizer step at lr
             0 on seeded gradients) sharded on {"fsdp": 4} and restore it
             onto {"fsdp": 2, "tp": 2}, every
             block torch.equal the whole's there; this process reads it
             whole (weights torch.equal the seed's, its peak host RSS
             sampled) and serves it: greedy ids equal a server built from
             the seed's weights, B1 and B4 counted.
12. mesh    - the device mesh (ray_tpu_torch.parallel): (a) world 1 on NCCL:
             make_mesh and auto_mesh, shard_tree of llama_1b's seeded bf16
             state_dict from the host (every block torch.equal to the
             whole), each xla_ops op on one layer's 45,092,864 bf16
             elements (exact results, each timed), and
             iter_device_batches(sharding=data_sharding(mesh)); (b) path
             `serve_tp` at world 1: the shard-local llama_1b on a {"tp": 1}
             mesh (its collectives through NCCL) prefilling a dense cache
             and taking 8 greedy steps, as the server's steps do, with
             logits torch.equal to the plain model's and no kernel
             launched (the dense cache attends with the plain
             decode_attention, as JAX's tp path does). tp=2 on one card
             would need two ranks on one device: NCCL refuses that, and
             gloo's all-gather of CUDA tensors crashes the process, so
             tp > 1 runs with --cards 4 only.
    train_mesh - path `train_mesh`: build_llama_trainer at llama_1b width and
             depth (bf16, B=4, T=2048) on a world-1 {"dp": 1, "fsdp": 1,
             "tp": 1} mesh over NCCL, its batch through
             iter_device_batches(sharding=data_sharding(mesh)), 3 steps:
             losses and every param torch.equal to the plain step's on the
             same weights and batches, B1, B2 and B3 launched as often (16
             a step each); then B1, B2 and B3 held to their plain versions
             and timed at the 8B's shapes a card (B=1, T=2048, D=128, bf16:
             H=32, Kh=8 at fsdp and H=16, Kh=4 at tp=2).
13. seqpipe - sequence and pipeline parallelism at llama_1b width on world
             1 (NCCL): (a) path `ring`: the shard-local llama_1b (bf16,
             seed 0) with attn_impl="ring" on an {"sp": 1} mesh, B=1,
             T=2048, global positions, its batch placed with
             iter_device_batches(sharding=data_sharding(mesh, True)): the
             summed CE loss, the logits and the parameter gradients against
             a witness, the same weights in f32 with attn_impl="flash",
             and against that model in bf16 (RING_TOL; its own distance
             from the witness logged); two
             planted faults (RING_CONTROLS: scores rounded to bf16, the
             causal diagonal one key right) read against the witness, the
             second of which the limits must reject; then a 2-layer f32
             case held to 1e-4; no hand kernel may launch; (b)
             pipeline_apply on a {"pp": 1} mesh equal to the sequential
             blocks; (c) path `pipeline`: llama_1b in f32 split into 4
             PipelineStages of 4 blocks (the embedding in stage 0, the final
             norm, head and mean CE loss in stage 3) driven in process in
             1F1B order (run_1f1b, MPMDPipeline.train_step's schedule) over
             8 microbatches of B=1, T=1024 with one sgd(0.1) step: the mean
             loss and every parameter after the step within 1e-5 of the
             whole model's step; B1 launched twice a layer a microbatch
             (forward and recompute), B2 and B3 once; (d) the 1F1B step in
             bf16 timed beside the whole model's step, each stage's
             device-busy share of the step (CUDA events) beside the GPipe
             bound 3/11 and the bubble of its `pipeline.fwd` /
             `pipeline.bwd` trace windows (2M a stage, busy within 5% of
             the CUDA events'); one step with RAY_TPU_TRACE=0 records no
             window and creates no CUDA event.
14. rl      - RLlib's core (ray_tpu_torch.rllib), f32: (a) each learner's
             update on the card against the same update on the CPU from
             the same weights and batch (PPOLearner.update, 2 epochs;
             IMPALALearner.update on [50, 64]; the Nature CNN module's
             update_once on [8, 4, 84, 84, 4] uint8), metrics within
             RL_METRIC_TOL and params within the Adam bound with at most
             RL_FAR_SHARE of them lr / 100 apart, and TorchCartPole.step
             within CARTPOLE_TOL with equal flags; (b) path `rl_device`:
             DeviceRollout(TorchCartPole, 64 envs, 50 steps) on the card
             feeding the IMPALA learner at (256, 256) (lr 3e-3, entropy
             0.01) until the best episode_return_mean passes 60 (JAX's
             bar; at most 50 iterations), the return curve, env-steps/s
             and ms an update logged; then 3 PPO iterations at PPO's
             defaults on 8 x 500 device rollouts through compute_gae and
             PPOLearner.update, then 200 minibatch steps under
             torch.profiler (busy share); (c) path `rl_cnn`: 10 timed CNN
             update_once calls on [50, 32, 84, 84, 4] uint8 frames from
             the seed (45 MB), ms an update, peak memory, finite losses;
             (a, continued) DQN (double-Q, PER weights), SAC, TQC, CQL (a
             bc_iters step and a SAC step), IQL, BC and MARWIL updates on
             the card against the CPU's from the same weights, minibatch
             and injected draws; (d) path `rl_offline`: BCConfig(...)
             .build().train() on JAX's expert data to action_accuracy
             over 0.95, one MARWIL iteration, CQL and IQL at their
             defaults on 3000 Pendulum-v1 transitions (its dynamics in
             numpy), CQL's penalty below its cql_alpha=0 ablation's; (e)
             path `rl_offpolicy`: DQN's learner from ReplayBuffer and
             PrioritizedReplayBuffer (CartPole shapes) and on the Nature
             CNN (a 4000-transition buffer of 84x84x4 frames), SAC's and
             TQC's learners (Pendulum shapes), each at its defaults; (f)
             path `rl_multi_agent`: a MultiAgentEnvRunner on the host
             feeding per-policy PPOLearners on the card, 3 iterations
             shared and 3 independent. Each of (d)-(f) logs ms an update,
             its busy share and launches an update over 10 profiled
             updates; (g) path `rl_dreamer`; (h) path `rl_sebulba`: the
             sebulba pipeline's lockstep schedule in process, the port's
             RolloutActor on jax_env="cartpole" feeding IMPALA's
             _sebulba_update for 3 iterations, params torch.equal to the
             learner fed DeviceRollout directly, jit_cache_size() == 1,
             `pipeline.act` windows at versions 0, 1, 2; (i) path
             `rl_sebulba_actors`: the port's SebulbaPipeline through
             IMPALA's `.sebulba(enabled=True, ...)` on the port's runtime,
             a num_gpus=1 RolloutActor of DeviceRollout(TorchCartPole) and
             a ReplayActor, the learner here: lockstep params after 3
             iterations torch.equal to the learner fed DeviceRollout
             directly, then 1 actor with 2 rollouts in flight for 20
             updates (env-steps/s, gap counts, stale drops). No kernel may
             launch on any RL path. The entry
             points that make a gymnasium env (path `rl_ppo`, DQN's,
             SAC's and TQC's `train()`, `PPOConfig().multi_agent(...)`)
             are not driven: the chip machine has no gymnasium. Nor are
             the remote env runners and evaluation actors
             (`num_env_runners`, `evaluation_num_env_runners`), whose
             actors make gymnasium envs: tests/test_torch_rl_remote.py
             holds them to JAX's on the CPU.

    python3 chip_smoke.py --cards 4

runs the multi-card phases instead (it needs four visible cards):
`runtime` in this process (four num_gpus=1 actors of the port's runtime
bound to four distinct cards, their uuids this process's four, then a
num_gpus=2 actor that sees two; no model, no NCCL), `serve` in this
process (run_serve_cards: the `serve_app` app with its llama_1b
deployment at num_replicas=2, a card each, where a wave of four
256-token-prefix families is spread by p2c and each family's repeats
over HTTP go to the replica that advertised its prefix, ids equal to an
in-process server's; and PD as two deployments, PrefillServer on a third
card and PDServer bound with its handle on a fourth, ids equal, TTFT
read), `actors` in this process (run_actors_cards: (a) the trainer's
worker group, four TrainWorker actors with num_gpus=1 in a placement
group at {"fsdp": 4} (llama_1b, B=1 a card, T=2048, 4 steps, a sharded
checkpoint at step 2), rank 2 exiting at step 3 of the first attempt and
the whole group retried, its history equal an unkilled group's, every
rank on its own card, B1-B3 counted on every rank; (b) build_pipeline of
four PipelineStage actors a card each, llama_1b f32 cut by LlamaStage,
one 1F1B step over 8 microbatches of B=1, T=1024 against whole_step and
against run_1f1b in this process on the same cards, then ms a step and an
activation's hop through the store; (c) create_collective_group over four
GPU actors, a "host" group through the rendezvous actor and an "nccl"
group whose address rank 0 publishes there, every operation equal to the
host rule, and the bus GB/s of a 256 MiB all-reduce), `cluster` in this
process (run_cluster_cards: a head owning no card and four node agents
launched by GcpGpuNodeProvider("a3-highgpu-1g") on FakeGpuApi, node k
bound to card k; (a) four num_gpus=1 actors with SPREAD on four agents,
their UUIDs this process's four; (b) the trainer's worker group of
`actors` (a) across the agents, one TrainWorker an agent through a
node-only resource, rank 2 SIGKILLing its agent at step 3 of the first
attempt, the reconciler replacing that node on the same card and the
group restarting from step 2's checkpoint: the history and every rank's
blocks' digest equal `actors` (a)'s unkilled single-node run (run first
when `actors` is not in the run), B1-B3 counted on every rank; ms a step
against the single node's and the seconds from the kill to the resumed
step), `rl_dp` in a world
of its own, then `seqpipe`, `fsdp` and `tp` in
the same ranks (one spawned rank per card over NCCL), then MPMD in this
process. `--phases runtime`, `--phases serve`, `--phases actors`, `--phases cluster`,
`--phases seqpipe`,
`--phases tp`, `--phases rl_dp` or `--phases fsdp` runs one group alone: a
rehearsal aid for a change that touches one of them; the check of a
change is the default run. `fsdp`: (a) path
`train_fsdp`, llama_8b at full width (d 4096, 32 layers, 32/8 heads,
head_dim 128, ffn 14336, vocab 32000; seeded weights), f32 master
weights, bf16 activations, flash attention, remat, AdamW (lr 1e-4, weight
decay 1e-4), 4 x 2048 tokens a step (a row a card), on {"fsdp": 4} and
{"fsdp": 2, "tp": 2} from the same weights, 2 untimed and 5 timed steps
each: every loss finite, step 1's losses within FSDP_LOSS_TOL of each
other, a limit two planted faults must miss at step 2 (rank 1's fsdp
gather out of order; the gradient mean skipped), the replicated params
equal on every rank, B1, B2 and B3 launched 64, 32 and 32 times a rank a
step; ms a step, tokens/s, model TFLOP/s a card and its share of 989,
peak memory a card, and the NCCL kernels' share of one profiled step;
(b) f32 llama_1b (B=4, T=512) on {"fsdp": 4}, {"dp": 2, "fsdp": 2} and
{"fsdp": 2, "tp": 2}, and a 2-layer Mixtral-width MoE on {"ep": 4} and
{"ep": 2, "tp": 2}, two steps each against the whole model's on card 0
from the same weights: losses within 1e-5 relative, the gathered params
with at most 1e-3 of their coordinates lr / 100 apart; (c) llama_1b (bf16
params) on {"fsdp": 4}, checkpointed sharded after step 3 of 6 (each rank
its own blocks and AdamW moments), restored into a fresh model and AdamW:
losses and every rank's blocks torch.equal to the uninterrupted run, with
the bytes a rank and the seconds to save and to restore; then the same
checkpoint read whole on every rank: rank 0's weights torch.equal
gather_state_dict of the live blocks at the save and, served on card 0,
give the greedy ids of a server built from those; every rank restores it
onto {"fsdp": 2, "tp": 2}, its blocks and moments torch.equal the whole's
there; (d) path
`fsdp_fit`: every rank calls TorchTrainer(loop,
scaling_config=ScalingConfig(num_workers=4, use_gpu=True),
run_config=RunConfig(<a fresh shared directory>)).fit() over (c)'s loop,
4 steps each reporting {"loss", "step"}, a sharded checkpoint reported at
step 2 by every rank, then a second fit in a fresh directory with
resume_from_checkpoint=Checkpoint(<the first run's checkpoint_000000>)
taking steps 3-4: the losses of steps 3-4 and every rank's blocks
torch.equal to the first fit's, progress.jsonl written by rank 0 alone (4
lines, then 2), the copy holding every rank's shard and the layout, B1, B2
and B3 16 launches each a rank a step (96 over 6), _world_info (4, rank);
rank 0's copy seconds of the sharded checkpoint logged. `seqpipe`: ring attention at sp=4
(llama_1b, bf16, B=1, T=16384, 4096 tokens a card, the batch placed by
data_sharding(mesh, True)) against the f32 witness on one card at the
whole T (loss, gathered logits, the sp-psum'd gradients), the bf16 flash
model beside it, and the controls of the one-card run and a block
dropped by the ring's last rank, both rejected; with the ms of a forward
and a forward and backward, the peak memory a card and the ms of one K/V
shift, and an f32 2-layer case held to 1e-4; pipeline_apply at pp=4 (llama_1b blocks, 4
a stage, 8 microbatches of [1, 2048, 2048]) against the sequential blocks,
f32 outputs and gradients within 1e-5, bf16 timed; then, in this process,
MPMD 1F1B with stage i on card i (check_1f1b in f32, and in bf16 the
tokens/s and each stage's device-busy share against the GPipe bound).
`tp`: the xla_ops at world 4 on one layer's bytes
(ms and NCCL-tests bus bandwidth, beside `nvidia-smi nvlink -s`);
llama_1b f32 at tp 1, 2 and 4 with greedy ids equal (near-ties logged),
and speculate=4 at tp=4 equal to the plain tp=4 server; llama_1b bf16 at
tp 1, 2 and 4 (TTFT p50, decode tokens/s, host syncs a token, peak memory
a card, the first prefill's logits against tp=1); a 2-layer f32
Mixtral-width model at tp=4 against tp=1 (logits and expert ids), the
same model's forward with its banks over {"ep": 4} and {"ep": 2, "tp": 2}
(path `moe_ep`: error, ms, B1 launches on the local heads); and
Mixtral-8x7B at all 32 layers, bf16, tp=4 on the dense cache, serving the
slice's wave; last, a follower that fails at tp=4 (its decode step
raises), which must make rank 0 raise with the follower's error. No kernel
may launch on a tp server's ranks. Results go to
chip_smoke_out/chip_smoke_cards4.json.

It prints a `kernels` JSON line, the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}. Details go to chip_smoke_out/chip_smoke.json.
It needs one CUDA card and exits non-zero without one.
"""

import asyncio
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from ray_tpu_torch.util.gpu import H100_SXM, peak_flops_per_chip

HBM_BYTES_PER_S = 3.35e12               # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": peak_flops_per_chip(H100_SXM),  # dense tensor-core rate
              "float32": 67e12}         # f32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max-abs vs the plain version
# bf16 forward vs its plain version on the same bf16 inputs: mean |err| over
# mean |out|. The kernel rounds P to bf16 before P V; a control that rounds
# the scores to bf16 before the softmax must miss this limit where rows are
# long (T >= FWD_CONTROL_MIN_T): at short T the scores stay near 1 in size
# and their rounding is no larger than P's.
FWD_MEAN_TOL = 2e-3
FWD_CONTROL_MIN_T = 1024
PIPE_SEQ = 1024          # the `pipeline` path's microbatch length (B=1)
PIPE_BUSY_TOL = 0.05     # a stage's busy time, its trace windows against CUDA events
# backward kernels vs their plain version, per gradient: max |err| over max
# |grad|, and mean |err| over mean |grad|. The mean limit is the one that
# a backward without the dS and P roundings (the control) must exceed.
BWD_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
BWD_MEAN_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
OUT_DIR = Path(__file__).resolve().parent / "chip_smoke_out"


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, iters=100, warmup=3):
    """Device time of one fn() call: `iters` calls captured in one CUDA graph
    and replayed between two CUDA events, so the host's per-call cost (the
    Python wrapper and its checks) is not counted."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_eager_ms(fn, iters=100, warmup=10):
    """Time per call of back-to-back eager calls, host cost included: what
    the serving loop pays per launch."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def bound(bytes_moved, flops, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ build
def kernel_label(symbol):
    """(kernel, dtype, head dim) from a mangled kernel symbol, e.g.
    ...19flash_fwd_tc_kernelILi64EE... -> ("flash_fwd_tc_kernel", "bfloat16", 64).
    The tensor-core kernels take bf16 only; the scalar ones name their
    element type first (f = float)."""
    m = re.search(r"(?<=\d)((?:flash|paged)_[a-z_]*?_kernel)I(.*)", symbol)
    if m is None:
        return symbol, None, None
    name, args = m.groups()
    d = re.search(r"Li(\d+)E", args)
    dtype = ("float32" if args.startswith("f") else
             "bfloat16" if args.startswith("13__nv_bfloat16") or "_tc_" in name else None)
    return name, dtype, int(d.group(1)) if d else None


def tensor_core_counts(lib_path):
    """Tensor-core instructions per kernel of the built library, from
    cuobjdump -sass: {(kernel, dtype, head dim): {"HMMA": n, "HGMMA": n}}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = kernel_label(line.split("Function :", 1)[1].strip())
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None and (m := re.search(r"\b(HG?MMA)\b", line)):
            counts[fn][m.group(1)] += 1
    return counts


# the bf16 flash kernels and the tensor-core instruction each must use
TC_KERNELS = {"flash_fwd_tc_kernel": "HGMMA", "flash_bwd_dq_tc_kernel": "HGMMA",
              "flash_bwd_dkv_tc_kernel": "HMMA"}
SCALAR_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def check_tensor_cores(lib_path):
    """The bf16 flash kernels run on the tensor cores (forward and dQ
    wgmma, dK/dV mma.sync) at every head dim; the f32 routes do not; no
    bf16 instantiation of a scalar flash body exists. Returns the counts;
    raises on a miss."""
    counts = tensor_core_counts(lib_path)
    flash = {k: n for k, n in counts.items() if k[0].startswith("flash_")}
    for (name, dtype, d), n in sorted(flash.items(), key=lambda kv: str(kv[0])):
        log(f"[build]   {n['HMMA']:5d} HMMA {n['HGMMA']:5d} HGMMA in {name}<{dtype}, D={d}>")
    problems = [k for k, n in flash.items() if k[0] in TC_KERNELS
                and (n[TC_KERNELS[k[0]]] == 0 or k[1] != "bfloat16")]
    problems += [k for k, n in flash.items() if k[0] not in TC_KERNELS and sum(n.values())]
    problems += [k for k in flash if k[0] in SCALAR_KERNELS and k[1] != "float32"]
    for want in TC_KERNELS:
        have = sorted(k[2] for k in flash if k[0] == want)
        if have != [16, 32, 64, 128]:
            problems.append((want, "head dims", tuple(have)))
    if problems:
        raise AssertionError(f"tensor-core evidence failed for {problems}")
    return {f"{k[0]}<{k[1]},{k[2]}>": n for k, n in counts.items()}


def ptxas_report(build_log):
    """Registers and spill bytes per kernel from the build's ptxas -v
    report: {"kernel<dtype,D[,G]>": {"registers": n, "spill_stores": n,
    "spill_loads": n}} (G: the paged kernel's group bucket)."""
    report, fn = {}, None
    for line in build_log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name, dtype, _ = kernel_label(m.group(1))
            ints = re.findall(r"Li(\d+)E", m.group(1))
            fn = report.setdefault(f"{name}<{','.join([str(dtype)] + ints)}>", {})
        elif fn is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            fn.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif fn is not None and (m := re.search(r"Used (\d+) registers", line)):
            fn["registers"] = int(m.group(1))
            fn = None
    return report


def check_spills(report):
    """The bf16 dQ kernel keeps its tiles and sums in registers: 0 spill
    bytes at every head dim. Logs the tensor-core and paged kernels'
    registers; raises on a spill."""
    rows = {k: v for k, v in report.items()
            if any(k.startswith(n + "<") for n in TC_KERNELS) or k.startswith("paged_")}
    for k, v in sorted(rows.items()):
        log(f"[build]   {v.get('registers')} registers, {v.get('spill_stores')} / "
            f"{v.get('spill_loads')} spill bytes (stores / loads) in {k}")
    dq = {k: v for k, v in rows.items() if k.startswith("flash_bwd_dq_tc_kernel<")}
    if len(dq) != 4 or any(v.get("spill_stores") or v.get("spill_loads") for v in dq.values()):
        raise AssertionError(f"flash_bwd_dq_tc_kernel registers/spills: {dq}")
    return rows


# ---------------------------------------------------------------- kernels
def flash_inputs(rng, b, t, h, kh, d, dtype, device="cuda"):
    import torch
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        device, dtype)
    return mk(b, t, h, d), mk(b, t, kh, d), mk(b, t, kh, d)


def fwd_control(q, k, v, causal):
    """The plain forward with the scores rounded to bf16 before the softmax
    (f32 softmax and P V after it, out rounded to q's dtype once)."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    b, t, h, d = q.shape
    s = fa._grouped_scores(q, k, causal, 1.0 / d ** 0.5).to(torch.bfloat16).float()
    out = torch.einsum("bkgts,bskd->btkgd", torch.softmax(s, dim=-1), v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def check_fwd(tag, q, k, v, causal, out, lse):
    """The forward kernel's out and lse against the plain version on the
    same inputs: out within TOL max-abs (both round out once), lse within
    1e-3; in bf16 also the mean error over the mean |out| within
    FWD_MEAN_TOL, with the control's reading beside it, which must miss that
    limit where T >= FWD_CONTROL_MIN_T. Returns the readings; raises on a
    miss."""
    from ray_tpu_torch.ops import flash_attention as fa
    name = str(q.dtype).split(".")[1]
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal, return_lse=True)
    r = dict(max_abs_err=(out.float() - ref.float()).abs().max().item(),
             lse_max_abs_err=(lse - ref_lse).abs().max().item())
    ok = r["max_abs_err"] <= TOL[name] and r["lse_max_abs_err"] <= TOL["float32"] * 10
    if name == "bfloat16":
        r["mean_rel_err"] = mean_rel_err(out, ref)
        ctl = fwd_control(q, k, v, causal)
        r["control_max_abs_err"] = (ctl.float() - ref.float()).abs().max().item()
        r["control_mean_rel_err"] = mean_rel_err(ctl, ref)
        ok = ok and r["mean_rel_err"] <= FWD_MEAN_TOL
        if q.shape[1] >= FWD_CONTROL_MIN_T:
            ok = ok and r["control_mean_rel_err"] > FWD_MEAN_TOL
        del ctl
    if not ok:
        raise AssertionError(f"flash_fwd {tag}: readings {r} (limits max-abs {TOL[name]}, "
                             f"lse {TOL['float32'] * 10}, bf16 mean {FWD_MEAN_TOL})")
    return r


def check_flash(rng, record, device="cuda"):
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    worst = 0.0
    cases = [(dt, causal, g, kh, t, 64, 1, 32) for dt in (torch.float32, torch.bfloat16)
             for causal in (True, False) for g, kh in ((1, 32), (4, 8))
             for t in (16, 100, 128, 2048)]
    # the other head dims the kernel is built for
    cases += [(torch.bfloat16, True, 4, 2, 100, d, 2, 8) for d in (16, 32, 128)]
    # the MoE serving shapes (Mixtral: D = 128, 32 query heads over 8 kv
    # heads), on inputs of their own so that the cases above and every
    # later check keep the inputs they had before these were added
    cases += [(torch.bfloat16, True, 4, 8, t, 128, 1, 32) for t in (16, 128, 2048)]
    moe_rng = np.random.default_rng(128)
    # the pipeline path's shape (B=1, T=PIPE_SEQ, G=4), both routes, on
    # inputs of their own too
    cases += [(dt, True, 4, 8, PIPE_SEQ, 64, 1, 32) for dt in (torch.float32, torch.bfloat16)]
    pipe_rng = np.random.default_rng(PIPE_SEQ)
    for dtype, causal, g, kh, t, d, b, h in cases:
        name = str(dtype).split(".")[1]
        src = moe_rng if (d, h) == (128, 32) else pipe_rng if t == PIPE_SEQ else rng
        q, k, v = flash_inputs(src, b, t, h, kh, d, dtype, device)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        r = check_fwd(f"{name} causal={causal} G={g} T={t} D={d}", q, k, v, causal, out,
                      lse)
        record.append(dict(kernel="flash_fwd", dtype=name, causal=causal, group=g, T=t,
                           head_dim=d, ok=True, **r))
        worst = max(worst, r["max_abs_err"])
    bf = [r for r in record if r["kernel"] == "flash_fwd" and r["dtype"] == "bfloat16"]
    long_rows = [r for r in bf if r["T"] >= FWD_CONTROL_MIN_T]
    if device == "cuda":  # a grad-tracking call: forward, dQ, dK/dV once each
        q, k, v = (x.requires_grad_() for x in
                   flash_inputs(rng, 1, 100, 32, 8, 64, torch.bfloat16, device))
        before = flash_counts()
        fa.flash_attention(q, k, v).float().square().sum().backward()
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(flash_counts(), before)]
        if launched != [1, 1, 1]:
            raise AssertionError(f"grad-tracking call launched fwd/dq/dkv {launched}")
    log(f"[kernels] flash_fwd: {len(cases)} cases within tolerance (max-abs f32 "
        f"{TOL['float32']}, bf16 {TOL['bfloat16']}; bf16 mean {FWD_MEAN_TOL}), worst "
        f"max-abs {worst:.3e}; bf16 mean worst {max(r['mean_rel_err'] for r in bf):.3e}; "
        f"control (scores rounded to bf16) mean least {min(r['control_mean_rel_err'] for r in bf):.3e} "
        f"over all bf16 cases, {min(r['control_mean_rel_err'] for r in long_rows):.3e} "
        f"where T >= {FWD_CONTROL_MIN_T}")
    return worst


def flash_counts():
    from ray_tpu_torch.ops import flash_attention as fa
    return [fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES]


def reset_flash_counts():
    from ray_tpu_torch.ops import flash_attention as fa
    fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0


def rel_err(got, want):
    """max |got - want| over the largest |want| (f32)."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def mean_rel_err(got, want):
    """mean |got - want| over the mean |want| (f32)."""
    return ((got.float() - want.float()).abs().mean() / want.float().abs().mean()).item()


def check_bwd(tag, name, got, want, control=None):
    """dq, dk, dv of the kernels (`got`) against the plain backward
    (`want`): each gradient's max error over its largest |grad| within
    BWD_TOL and its mean error over its mean |grad| within BWD_MEAN_TOL.
    `control`, for bf16: the plain backward without the dS and P roundings
    (f32 operands, outputs rounded once), which must miss the mean limit on
    at least one gradient, so that the limit would catch a kernel that
    drops them. Returns the readings; raises on a miss."""
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    means = [mean_rel_err(a, b) for a, b in zip(got, want)]
    out = dict(rel_err=errs, mean_rel_err=means,
               max_abs_err=[(a.float() - b.float()).abs().max().item()
                            for a, b in zip(got, want)])
    ok = max(errs) <= BWD_TOL[name] and max(means) <= BWD_MEAN_TOL[name]
    if control is not None:
        out["control_rel_err"] = [rel_err(a, b) for a, b in zip(control, want)]
        out["control_mean_rel_err"] = [mean_rel_err(a, b) for a, b in zip(control, want)]
        ok = ok and max(out["control_mean_rel_err"]) > BWD_MEAN_TOL[name]
    if not ok:
        raise AssertionError(f"flash_bwd {tag}: dq/dk/dv readings {out} (limits max "
                             f"{BWD_TOL[name]}, mean {BWD_MEAN_TOL[name]})")
    return out


def bwd_control(q, k, v, out, lse, do, causal):
    """The plain backward without the dS and P roundings: every operand in
    f32, each gradient rounded to the input dtype once at the end."""
    from ray_tpu_torch.ops import flash_attention as fa
    f = lambda x: x.float()
    return [g.to(q.dtype) for g in fa.flash_attention_bwd_reference(
        f(q), f(k), f(v), f(out), lse, f(do), causal)]


def check_flash_bwd(rng, record, device="cuda"):
    """B2 (dQ) and B3 (dK/dV) against flash_attention_bwd_reference on the
    same q, k, v, out, lse and dO, within the limits of `check_bwd`; f32
    differs in summation order only, bf16 also by the bf16 outputs."""
    import torch
    from ray_tpu_torch.ops import flash_attention as fa
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}   # max, mean
    control = [1.0, 1.0]     # the control's smallest readings over the bf16 cases
    max_abs = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = [(dt, causal, g, t, 64) for dt in (torch.float32, torch.bfloat16)
             for causal in (True, False) for g in (1, 4) for t in (16, 100, 128, 2048)]
    cases += [(torch.bfloat16, True, 4, 100, d) for d in (16, 32, 128)]
    # the pipeline path's shape (B=1, T=PIPE_SEQ, G=4), both routes, on
    # inputs of their own so that the cases above keep theirs
    cases += [(dt, True, 4, PIPE_SEQ, 64) for dt in (torch.float32, torch.bfloat16)]
    pipe_rng = np.random.default_rng(PIPE_SEQ)
    for dtype, causal, g, t, d in cases:
        name = str(dtype).split(".")[1]
        h = 32 if d == 64 else 8
        src = pipe_rng if t == PIPE_SEQ else rng
        q, k, v = flash_inputs(src, 1 if t in (PIPE_SEQ, 2048) else 2, t, h, h // g, d, dtype,
                               device)
        do = flash_inputs(src, q.shape[0], t, h, 1, d, dtype, device)[0]
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
        ctl = bwd_control(q, k, v, out, lse, do, causal) if name == "bfloat16" else None
        r = check_bwd(f"{name} causal={causal} G={g} T={t} D={d}", name, got, want, ctl)
        record.append(dict(kernel="flash_bwd", dtype=name, causal=causal, group=g, T=t,
                           head_dim=d, ok=True, **r))
        worst[name] = [max(worst[name][0], *r["rel_err"]),
                       max(worst[name][1], *r["mean_rel_err"])]
        if ctl is not None:
            control = [min(control[0], max(r["control_rel_err"])),
                       min(control[1], max(r["control_mean_rel_err"]))]
        max_abs["flash_bwd_dq"] = max(max_abs["flash_bwd_dq"], r["max_abs_err"][0])
        max_abs["flash_bwd_dkv"] = max(max_abs["flash_bwd_dkv"], *r["max_abs_err"][1:])
    log(f"[kernels] flash_bwd dq + dkv: {len(cases)} cases within tolerance (max / mean "
        f"error over max / mean |grad|: f32 {BWD_TOL['float32']} / "
        f"{BWD_MEAN_TOL['float32']}, bf16 {BWD_TOL['bfloat16']} / "
        f"{BWD_MEAN_TOL['bfloat16']}); worst f32 {worst['float32']}, bf16 "
        f"{worst['bfloat16']}; control without dS/P roundings, least over the bf16 "
        f"cases: {control}; max-abs {max_abs}")
    return max_abs, dict(worst=worst, control_least=control)


def time_flash_train(rng, record):
    """B1, B2, B3 at the training shape (`time_flash_shape`): B=4, T=2048,
    H=32, Kh=8, D=64, bf16, causal, with the f32 routes."""
    return time_flash_shape(rng, record, 4, 2048, 32, 8, 64, f32_route=True)


def time_flash_shape(rng, record, b, t, h, kh, d, f32_route=False):
    """B1, B2, B3 at one bf16 causal shape. First each is held against its
    plain version on these inputs (B1 as in `check_fwd`, B2 and B3 as in
    `check_bwd`), and dQ, dK and dV computed twice must be bit-equal.
    Bounds count each
    input read once and each output written once, and the matrix products'
    flops inside the causal area (exp and elementwise work not counted).
    The plain backward computes dQ, dK and dV together; so does the
    library yardstick, the aten flash-attention backward on kv heads
    expanded to H (its dK/dV are per query head: the sum over the group
    is not in its time). With `f32_route`, the f32 routes (scalar FMAs, off
    both main paths) are timed on the same inputs widened to f32."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa
    scale = 1.0 / d ** 0.5
    shape = f"B={b} T={t} H={h} Kh={kh} D={d} bf16 causal"
    q, k, v = flash_inputs(rng, b, t, h, kh, d, torch.bfloat16)
    do = flash_inputs(rng, b, t, h, 1, d, torch.bfloat16)[0]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    fwd_r = check_fwd(shape, q, k, v, True, out, lse)
    record.append(dict(kernel="flash_fwd", dtype="bfloat16", causal=True, group=h // kh, B=b,
                       T=t, heads=h, head_dim=d, ok=True, **fwd_r))
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
    bit_equal = [torch.equal(a, b_) for a, b_ in zip(got, again)]
    if not all(bit_equal):
        raise AssertionError(f"flash_bwd dq/dk/dv: two runs on the same inputs differ "
                             f"(bit-equal {bit_equal})")
    bit_equal = all(bit_equal)
    del again
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
    bwd = check_bwd(shape, "bfloat16", got, want,
                    bwd_control(q, k, v, out, lse, do, True))
    record.append(dict(kernel="flash_bwd", dtype="bfloat16", causal=True, group=h // kh, B=b,
                       T=t, heads=h, head_dim=d, ok=True, bit_equal_rerun=bit_equal, **bwd))
    fmt = lambda xs: [f"{x:.3e}" for x in xs]
    log(f"[kernels] {shape} vs plain: flash_fwd max-abs {fwd_r['max_abs_err']:.3e}, "
        f"mean {fwd_r['mean_rel_err']:.3e} (control mean {fwd_r['control_mean_rel_err']:.3e}, "
        f"lse {fwd_r['lse_max_abs_err']:.3e}); dq/dk/dv max {fmt(bwd['rel_err'])}, mean "
        f"{fmt(bwd['mean_rel_err'])} (control max {fmt(bwd['control_rel_err'])}, mean "
        f"{fmt(bwd['control_mean_rel_err'])}); dQ/dK/dV rerun bit-equal {bit_equal}")
    del got, want
    err = fwd_r["max_abs_err"]
    delta = fa.bwd_delta(out, do)
    fwd = lambda: fa.flash_attention_fwd(q, k, v, causal=True)
    dq = lambda: fa.launch_bwd_dq(q, k, v, do, lse, delta, True, scale)
    dkv = lambda: fa.launch_bwd_dkv(q, k, v, do, lse, delta, True, scale)
    plain_fwd = time_ms(lambda: fa.flash_attention_reference(q, k, v, True), iters=3)
    plain_bwd = time_eager_ms(
        lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, True), iters=3,
        warmup=1)
    qt, dot = q.transpose(1, 2), do.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                       iters=20)
    o, l, cq, ck, mq, mk, seed, offset, _ = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, True, False, scale=scale)
    sdpa_bwd = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, o, l, cq, ck, mq, mk, 0.0, True, seed, offset, scale=scale),
        iters=20)
    n_q, n_kv = b * t * h * d, b * t * kh * d       # elements of q (= out, do) and k (= v)
    pairs = b * h * t * (t + 1) // 2                # (query, key) pairs in the causal area
    stats = 4 * b * h * t                           # bytes of lse (and of delta)
    rows = {}
    for name, fn, nbytes, flops, plain, lib, max_abs in (
            ("flash_fwd", fwd, 2 * (2 * n_q + 2 * n_kv) + stats, 4 * d * pairs,
             plain_fwd, sdpa_fwd, err),
            ("flash_bwd_dq", dq, 2 * (3 * n_q + 2 * n_kv) + 2 * stats, 6 * d * pairs,
             plain_bwd, sdpa_bwd, bwd["max_abs_err"][0]),
            ("flash_bwd_dkv", dkv, 2 * (2 * n_q + 4 * n_kv) + 2 * stats, 8 * d * pairs,
             plain_bwd, sdpa_bwd, max(bwd["max_abs_err"][1:]))):
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        rows[name] = dict(shape=shape,
                          ms=time_ms(fn, iters=20), eager_ms=time_eager_ms(fn, iters=20),
                          plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=max_abs)
        r = rows[name]
        log(f"[kernels] {name} {shape}: {r['ms']:.4f} ms (eager call "
            f"{r['eager_ms']:.4f}), plain {plain:.4f} ms, library {lib:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
    if not f32_route:
        return rows
    # the f32 routes, off both main paths
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    out32, lse32 = fa.flash_attention_fwd(q32, k32, v32, causal=True)
    delta32 = fa.bwd_delta(out32, do32)
    rows["f32_route"] = dict(
        shape=shape.replace("bf16", "f32"),
        flash_fwd_ms=time_ms(lambda: fa.flash_attention_fwd(q32, k32, v32, causal=True),
                             iters=5),
        flash_bwd_dq_ms=time_ms(lambda: fa.launch_bwd_dq(q32, k32, v32, do32, lse32,
                                                         delta32, True, scale), iters=5),
        flash_bwd_dkv_ms=time_ms(lambda: fa.launch_bwd_dkv(q32, k32, v32, do32, lse32,
                                                           delta32, True, scale), iters=5))
    log(f"[kernels] f32 routes (scalar FMAs) at the train shape: flash_fwd "
        f"{rows['f32_route']['flash_fwd_ms']:.4f} ms, flash_bwd_dq "
        f"{rows['f32_route']['flash_bwd_dq_ms']:.4f} ms, flash_bwd_dkv "
        f"{rows['f32_route']['flash_bwd_dkv_ms']:.4f} ms")
    return rows


def paged_inputs(rng, b, kh, g, d, page, max_pages, lengths, dtype, device="cuda"):
    """Pool + fragmented tables: each row's pages are a scrambled draw."""
    import torch
    pool = b * max_pages + 1
    k_pages = rng.standard_normal((kh, pool, page, d), dtype=np.float32)
    v_pages = rng.standard_normal((kh, pool, page, d), dtype=np.float32)
    perm = rng.permutation(np.arange(1, pool))
    tables = np.zeros((b, max_pages), np.int32)
    used = 0
    for i in range(b):
        need = -(-int(lengths[i]) // page)
        tables[i, :need] = perm[used:used + need]
        used += need
    q = rng.standard_normal((b, kh * g, d), dtype=np.float32)
    cu = lambda x, dt=dtype: torch.from_numpy(x).to(device, dt)
    return (cu(q), cu(k_pages), cu(v_pages), cu(tables, torch.int32),
            cu(np.asarray(lengths, np.int32), torch.int32))


def paged_cases(rng):
    """(dtype, B, Kh, G, D, page, max_pages, lengths) of the B4 checks."""
    import torch
    from ray_tpu_torch.ops import paged_attention as pa
    f32, bf16 = torch.float32, torch.bfloat16
    serve = [1, 64, 100, 2048, 777, 129, 63, 1500]  # 2048 fills the table
    cases = [(dt, 8, 8, g, 64, 64, 32, serve) for dt in (bf16, f32) for g in (1, 4)]
    # other head dims, the largest group, other page sizes, groups that are
    # not a power of two (the kernel rounds G up for its registers)
    cases += [(f32, 4, 2, g, d, page, 3, [1, 5, 17, 3 * page])
              for d, g, page in ((16, 2, 16), (32, 1, 32), (128, 8, 16), (64, 3, 64))]
    cases.append((bf16, 3, 2, 6, 64, 32, 8, [1, 100, 256]))
    # the MoE serving shape: Mixtral's D = 128 and G = 4, page 64 (drawn
    # from its own inputs in check_paged)
    cases.append((bf16, 8, 8, 4, 128, 64, 32, serve))
    # one split per page (B x Kh small): length 1 leaves every split but the
    # first without a token, 640 fills a 40-page table; G = 8, D = 128,
    # page 16; the largest page; a batch that fills the card with one split
    for dt in (bf16, f32):
        cases += [(dt, 2, 2, 8, 128, 16, 40, [1, 640]),
                  (dt, 4, 2, 4, 64, 64, 32, [1, 65, 2048, 1000]),
                  (dt, 2, 1, 8, 128, pa.MAX_PAGE_SIZE, 4, [300, 4 * pa.MAX_PAGE_SIZE]),
                  (dt, 72, 8, 4, 64, 64, 4, rng.integers(1, 257, 72).tolist())]
    return cases


def check_paged(rng, record, device="cuda"):
    """B4 against paged_attention_reference within TOL on every case of
    `paged_cases`; each call launches one split pass and, where its plan has
    several splits, one combine pass. The plain version of the split
    arithmetic (paged_attention_split_reference, on the plan's
    pages_per_split) is read beside it."""
    import torch
    from ray_tpu_torch.ops import paged_attention as pa
    worst, n_multi = 0.0, 0
    cases = paged_cases(rng)
    moe_rng = np.random.default_rng(129)
    for dtype, b, kh, g, d, page, max_pages, lens in cases:
        name = str(dtype).split(".")[1]
        src = moe_rng if (d, g) == (128, 4) else rng
        q, kp, vp, tb, ln = paged_inputs(src, b, kh, g, d, page, max_pages, lens, dtype,
                                         device)
        sms = pa._sm_count(q.device) if device == "cuda" else 132  # CPU: no launch
        n_split, per = pa.split_plan(b, kh, max_pages, sms)
        before = (pa.LAUNCHES, pa.COMBINE_LAUNCHES)
        out = pa.paged_attention(q, kp, vp, tb, ln)
        launched = (pa.LAUNCHES - before[0], pa.COMBINE_LAUNCHES - before[1])
        want = (1, int(n_split > 1)) if device == "cuda" else (0, 0)
        f = lambda x: x.float()
        ref = pa.paged_attention_reference(f(q), f(kp), f(vp), tb, ln)
        split_ref = pa.paged_attention_split_reference(f(q), f(kp), f(vp), tb, ln,
                                                       pages_per_split=per)
        err = (out.float() - ref).abs().max().item()
        ok = err <= TOL[name] and launched == want
        record.append(dict(kernel="paged_decode", dtype=name, B=b, kv_heads=kh, group=g,
                           head_dim=d, page=page, max_pages=max_pages, lengths=list(lens),
                           n_split=n_split, pages_per_split=per, launched=launched,
                           max_abs_err=err,
                           split_ref_max_abs_err=(out.float() - split_ref).abs().max().item(),
                           ok=ok))
        if not ok:
            raise AssertionError(f"paged_decode {record[-1]}")
        worst = max(worst, err)
        n_multi += n_split > 1
    log(f"[kernels] paged_decode: {len(cases)} cases within tolerance ({n_multi} with "
        f"several splits, some holding no token), worst max-abs {worst:.3e}")
    return worst


def time_flash(rng, t, d=64):
    """B1 at a prefill chunk of a serving path: B=1, H=32, Kh=8, bf16, head
    dim `d` (64: llama_1b; 128: Mixtral)."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as fa
    b, h, kh = 1, 32, 8
    q, k, v = flash_inputs(rng, b, t, h, kh, d, torch.bfloat16)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    eager_ms = time_eager_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, True),
                       iters=5 if t > 1024 else 20)
    # yardstick only: one library call on the same inputs ([B, H, T, D],
    # kv heads expanded outside the timed region)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bytes_moved = 2 * (2 * b * t * h * d + 2 * b * t * kh * d) + 4 * b * h * t
    flops = 4 * d * h * b * t * (t + 1) // 2
    bound_ms, bound_by = bound(bytes_moved, flops, "bfloat16")
    return dict(T=t, head_dim=d, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


def time_paged(rng, lengths, copies=1, d=64):
    """B4 at a serving decode batch: B=8, H=32, Kh=8, page 64, max_pages 32,
    bf16, head dim `d` (64: llama_1b; 128: Mixtral). With copies > 1 the timed calls take turns over that
    many input sets (own pools and tables), so that K and V come from device
    memory and not from the 50 MB L2 cache. Only wrapper calls are timed, so
    the same function times the kernel of another commit's package."""
    import itertools
    import torch
    from ray_tpu_torch.ops import paged_attention as pa
    b, kh, g, page, max_pages = 8, 8, 4, 64, 32
    sets = [paged_inputs(rng, b, kh, g, d, page, max_pages, lengths, torch.bfloat16)
            for _ in range(copies)]
    turns = itertools.cycle(sets)
    ms = time_ms(lambda: pa.paged_attention(*next(turns)))
    eager_ms = time_eager_ms(lambda: pa.paged_attention(*next(turns)))
    plain_ms = time_ms(lambda: pa.paged_attention_reference(*next(turns)), iters=20)
    tokens = int(sum(lengths))
    bytes_moved = (2 * 2 * b * kh * g * d          # q in, out
                   + 2 * 2 * tokens * kh * d       # K and V of the valid tokens
                   + 4 * b * max_pages + 4 * b)    # tables, lengths
    flops = 4 * tokens * kh * g * d
    bound_ms, bound_by = bound(bytes_moved, flops, "bfloat16")
    plan = getattr(pa, "split_plan", None)
    return dict(lengths=list(lengths), copies=copies, head_dim=d, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                plan=plan(b, kh, max_pages, pa._sm_count(sets[0][0].device)) if plan else None)


def sweep_paged_plan(rng, serve_lengths):
    """B4 at the serving and the long lengths (as `time_paged`) under the
    split plans that aim at 2, 3, 4 and 8 CTAs an SM (CTAS_PER_SM, whose
    value the wrapper uses is the plan's aim)."""
    from ray_tpu_torch.ops import paged_attention as pa
    keep, rows = pa.CTAS_PER_SM, []
    try:
        for k in (2, 3, 4, 8):
            pa.CTAS_PER_SM = k
            serve, long = time_paged(rng, serve_lengths), time_paged(rng, [2048] * 8, copies=4)
            rows.append(dict(ctas_per_sm=k, plan=serve["plan"], serve_ms=serve["ms"],
                             long_ms=long["ms"]))
    finally:
        pa.CTAS_PER_SM = keep
    log(f"[kernels] paged_decode plans (CTAs an SM, (n_split, pages_per_split), serve ms, "
        f"long ms; the wrapper aims at {keep}): "
        + "; ".join(f"{r['ctas_per_sm']} {r['plan']} {r['serve_ms']:.4f} {r['long_ms']:.4f}"
                    for r in rows))
    return rows


# ------------------------------------------------------------------ model
def check_model(server, device="cuda"):
    """llama_1b in f32: the kernel path (paged chunk-local prefill through
    B1, one decode step through B4) against the plain dense-cache path
    (decode_attention) on the same weights and a 100-token prompt."""
    import torch
    from ray_tpu_torch.models.llama import KVCache, Llama
    from ray_tpu_torch.ops.paged_attention import PagedKVCache

    cfg = dataclasses.replace(server.model_cfg, dtype=torch.float32,
                              param_dtype=torch.float32)
    model = Llama(cfg, device=device)
    model.load_state_dict(server.model.state_dict())
    model.requires_grad_(False)
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 100))).to(device)
    with torch.no_grad():
        dense = KVCache.init(cfg, 1, 256, device=device)
        logits_d, dense = model(prompt, cache=dense)
        nxt = logits_d[:, -1].argmax(-1, keepdim=True)
        step_d, _ = model(nxt, cache=dense)
        paged = PagedKVCache.init(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 5, 64,
                                  1, 4, dtype=torch.float32, device=device)
        paged.block_tables[0] = torch.tensor([3, 1, 4, 2], dtype=torch.int32)
        logits_p, paged = model(prompt, cache=paged, paged_chunk_local=True)
        step_p, _ = model(nxt, cache=paged)
    err_prefill = (logits_p - logits_d).abs().max().item()
    err_step = (step_p - step_d).abs().max().item()
    finite = bool(torch.isfinite(logits_p).all() and torch.isfinite(step_p).all())
    tol = 1e-3
    log(f"[model] llama_1b f32 kernel path vs plain path: prefill logits max-abs "
        f"{err_prefill:.3e}, decode-step logits max-abs {err_step:.3e} (tol {tol})")
    if not (finite and err_prefill <= tol and err_step <= tol):
        raise AssertionError(f"model check failed: finite={finite}, "
                             f"prefill {err_prefill}, step {err_step}")
    del model, dense, paged
    return dict(prefill_max_abs_err=err_prefill, step_max_abs_err=err_step, tol=tol)


# ------------------------------------------------------------------ slice
def slice_prompts(vocab, seed=1234):
    """Wave 1: 8 fresh prompts (17..300 tokens; 129+ are multi-chunk),
    one of them opening with a 256-token prefix. Wave 2, after wave 1
    finished: that prefix again with another tail (a radix hit that
    prefills through the continuation path), and one fresh prompt."""
    rng = np.random.default_rng(seed)
    ids = lambda n: rng.integers(1, vocab, n).tolist()
    shared = ids(256)
    wave1 = [ids(n) for n in (17, 40, 64, 100, 128, 129, 200)] + [shared + ids(44)]
    wave2 = [shared + ids(30), ids(77)]
    return wave1, wave2


async def serve_wave(server, prompts, max_tokens):
    async def via_generate(p):
        t0 = time.perf_counter()
        out = await server.generate(p, max_tokens=max_tokens)
        return out["tokens"], out["ttft_s"], time.perf_counter() - t0

    async def via_stream(p):
        t0 = time.perf_counter()
        toks, ttft = [], None
        async for tok in server.generate_stream(p, max_tokens=max_tokens):
            if ttft is None:
                ttft = time.perf_counter() - t0
            toks.append(tok)
        return toks, ttft, time.perf_counter() - t0

    return await asyncio.gather(*[
        (via_generate if i % 2 == 0 else via_stream)(p) for i, p in enumerate(prompts)])


def serving_config(preset, device, **kw):
    """The slice's engine settings (page 64, prefill_chunk 128, 8 slots,
    max_seq_len 2048, decode_chunk 8, seed 0), radix prefix cache on."""
    from ray_tpu_torch.serve.llm import LLMConfig
    cfg = dict(preset=preset, paged=True, page_size=64, max_batch_slots=8,
               max_seq_len=2048, prefill_chunk=128, decode_chunk=8, device=device, seed=0)
    cfg.update(kw)
    return LLMConfig(**cfg)


def run_slice(preset="llama_1b", device="cuda"):
    from ray_tpu_torch.models.llama import llama_param_count
    from ray_tpu_torch.serve.llm import LLMServer

    t0 = time.perf_counter()
    server = LLMServer(serving_config(preset, device))
    mc = server.model_cfg
    log(f"[slice] {preset}: d_model {mc.d_model}, {mc.n_layers} layers, "
        f"{mc.n_heads}/{mc.n_kv_heads} heads, head_dim {mc.head_dim}, "
        f"{llama_param_count(mc) / 1e6:.1f}M params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    model_check = check_model(server, device)
    summary = serve_and_count(server, "slice", device)
    summary["model_check"] = model_check
    summary["trace_off"] = check_trace_off(server)
    if device == "cuda":
        summary["profile"] = profile_wave(server, mc.vocab_size)
    return summary


def check_trace_off(server, max_tokens=32):
    """Tracing adds no host sync: two more pairs of the slice's waves on
    fresh prompts of the same lengths and shared-prefix structure (so the
    same prefill chunks, decode chunks and radix hit), one with tracing on
    and one with RAY_TPU_TRACE=0: equal host syncs and tokens, spans only in
    the first. Returns both readings; raises on a miss."""
    from ray_tpu_torch.util import tracing
    vocab = server.model_cfg.vocab_size
    out = {}
    for flag, seed in (("1", 777), ("0", 778)):
        with environ(RAY_TPU_TRACE=flag):
            tracing.refresh()
            tracing.clear()
            before = server.stats()
            for wave in slice_prompts(vocab, seed=seed):
                asyncio.run(serve_wave(server, wave, max_tokens))
            tokens, syncs, _, steps = decode_delta(server.stats(), before)
            spans = sum(e["name"] == "serve.decode_chunk" for e in tracing.events())
        out["on" if flag == "1" else "off"] = dict(tokens=tokens, host_syncs=syncs,
                                                   steps=steps, spans=spans)
    tracing.refresh()
    on, off = out["on"], out["off"]
    ok = (on["host_syncs"] == off["host_syncs"] and on["tokens"] == off["tokens"]
          and on["spans"] == on["host_syncs"] and off["spans"] == 0)
    log(f"[slice] {'ok  ' if ok else 'FAIL'} host syncs a token with tracing on "
        f"{on['host_syncs']}/{on['tokens']} == with RAY_TPU_TRACE=0 "
        f"{off['host_syncs']}/{off['tokens']}; spans {on['spans']} on, {off['spans']} off "
        f"({smi_line()})")
    if not ok:
        raise AssertionError(f"tracing changed the engine's host syncs: {out}")
    return out


def launch_counts():
    from ray_tpu_torch.ops import paged_attention as pa
    return dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), flash_counts()),
                paged_decode=pa.LAUNCHES, paged_decode_combine=pa.COMBINE_LAUNCHES)


def reset_launch_counts():
    from ray_tpu_torch.ops import paged_attention as pa
    reset_flash_counts()
    pa.LAUNCHES = pa.COMBINE_LAUNCHES = 0


def n_split_of(server, device):
    """The decode step's split plan (batch slots x kv heads over the table)."""
    from ray_tpu_torch.ops import paged_attention as pa
    slots, max_pages = server.cache.block_tables.shape
    if device != "cuda":
        return 1
    return pa.split_plan(slots, server.model_cfg.n_kv_heads, max_pages,
                         pa._sm_count(server.cache.block_tables.device))[0]


def decode_delta(after, before):
    """Decode tokens, host syncs, seconds in decode chunks and decode steps
    between two stats() readings."""
    a, b = after["decode"], before["decode"]
    steps = sum(int(k) * (v - b["chunk_sizes"].get(k, 0)) for k, v in a["chunk_sizes"].items())
    return (a["tokens"] - b["tokens"], a["host_syncs"] - b["host_syncs"],
            a["chunk_s_total"] - b["chunk_s_total"], steps)


def launch_checks(tag, launches, layers, fresh, steps, n_split):
    """B1 once a layer for every fresh first prefill chunk, B4 once a layer
    for every decode step, its combine pass as its plan says, no backward
    kernel. Logs each; raises on a miss."""
    checks = {
        f"flash launches == layers x fresh first chunks ({layers} x {fresh})":
            launches["flash_fwd"] == layers * fresh,
        f"paged launches == layers x decode steps ({layers} x {steps})":
            launches["paged_decode"] == layers * steps,
        f"a combine after every paged launch ({n_split} splits a call)":
            launches["paged_decode_combine"] == (launches["paged_decode"] if n_split > 1
                                                 else 0),
        "both kernels launched": launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
        "no backward kernel launched": launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 0,
    }
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} launch checks failed: {launches}")


def serve_and_count(server, tag, device="cuda"):
    """The two waves of `slice_prompts` (10 requests x 32 tokens, through
    generate and generate_stream) after a warm-up request, with the kernel
    launch counters reset and the trace ring cleared just before and read
    just after; then the checks of what the path launched (B1 per fresh
    first chunk, B4 per decode step, its combine pass per its split plan, no
    backward), of the radix hit, of the SLO metrics (TTFT and TPOT summaries
    in stats()["slo"], slo_snapshot()'s window counting the waves'
    requests, a prefix digest after the hit) and of the `serve.decode_chunk`
    spans (one a host sync). Returns the summary; raises on a failed
    check."""
    import torch
    from ray_tpu_torch.util import tracing

    mc = server.model_cfg
    # warm-up request (cuBLAS handles, allocator); its stats are subtracted
    asyncio.run(serve_wave(server, [list(range(1, 50))], 8))
    before = server.stats()
    server.slo_snapshot()             # the next window starts here
    wave1, wave2 = slice_prompts(mc.vocab_size)
    max_tokens = 32

    tracing.clear()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = asyncio.run(serve_wave(server, wave1, max_tokens))
    res += asyncio.run(serve_wave(server, wave2, max_tokens))
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    chunk_spans = [e for e in tracing.events() if e["name"] == "serve.decode_chunk"]
    after = server.stats()
    snap = server.slo_snapshot()
    digest = server.prefix_digest()
    n_split = n_split_of(server, device)
    tokens, syncs, decode_s, steps = decode_delta(after, before)
    fresh = after["prefill"]["chunk_local"] - before["prefill"]["chunk_local"]
    hit = after["prefix_hit_tokens"] - before["prefix_hit_tokens"]
    n_req = len(wave1) + len(wave2)

    for toks, _, _ in res:
        if len(toks) != max_tokens or not all(0 <= t < mc.vocab_size for t in toks):
            raise AssertionError(f"bad request output: {len(toks)} tokens {toks[:8]}...")
    launch_checks(tag, launches, mc.n_layers, fresh, steps, n_split)
    checks = {
        "every fresh prompt took the chunk-local path": fresh == n_req - 1,
        "radix prefix hit of the shared 256 tokens": hit >= 256,
        "host syncs below tokens (fused chunks)": syncs < tokens,
        "stats()['slo'] has TTFT and TPOT summaries":
            bool(after["slo"]["ttft_s"]) and bool(after["slo"]["tpot_ms"]),
        f"slo_snapshot() counts the waves' {n_req} requests": snap["ttft_count"] == n_req,
        "a prefix digest after the radix hit": bool(digest and digest["entries"]),
        f"serve.decode_chunk spans == host syncs ({len(chunk_spans)} == {syncs}), their "
        f"tokens == emitted tokens": len(chunk_spans) == syncs
        and sum(e["args"]["tokens"] for e in chunk_spans) == tokens,
    }
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed: launches {launches}, steps {steps}, "
                             f"fresh {fresh}, hit {hit}, syncs {syncs}, tokens {tokens}, "
                             f"slo snapshot {snap}, digest {digest}")
    ttft = sorted(r[1] for r in res)
    summary = dict(requests=n_req, max_tokens=max_tokens,
                   prompt_lens=[len(p) for p in wave1 + wave2],
                   ttft_p50_s=float(np.median(ttft)), ttft_max_s=ttft[-1],
                   decode_tokens=tokens, decode_host_syncs=syncs,
                   decode_steps=steps, decode_s=decode_s,
                   decode_tokens_per_s=tokens / decode_s if decode_s else None,
                   host_syncs_per_token=syncs / tokens,
                   wall_s=wall, launches=launches, paged_n_split=n_split,
                   fresh_first_chunks=fresh, prefix_hit_tokens=hit,
                   slo_snapshot=snap, prefix_digest_entries=len(digest["entries"]),
                   decode_chunk_spans=len(chunk_spans),
                   decode_chunk_span_s=sum(e["dur"] for e in chunk_spans), stats=after)
    log(f"[{tag}] {n_req} requests x {max_tokens} tokens in {wall:.2f} s: "
        f"TTFT p50 {summary['ttft_p50_s'] * 1e3:.1f} ms, decode "
        f"{summary['decode_tokens_per_s']:.1f} tokens/s over {syncs} host syncs "
        f"for {tokens} emitted tokens ({steps} steps, {syncs / tokens:.4f} syncs a token)")
    log(f"[{tag}] stats: {json.dumps(after['decode'])}; slo ttft_s "
        f"{json.dumps(after['slo']['ttft_s'])}, tpot_ms {json.dumps(after['slo']['tpot_ms'])}; "
        f"slo_snapshot {json.dumps(snap)}; digest {len(digest['entries'])} entries")
    return summary


# ------------------------------------------------------------------ moe
# Mixtral-8x7B at full width (LlamaConfig.mixtral_8x7b, from
# mistralai/Mixtral-8x7B-v0.1's config.json), 8 of its 32 layers: the whole
# model (93 GB in bf16) does not fit on one card
MOE_PRESET = "mixtral_8x7b"
MOE_LAYERS = 8


def check_moe_model(device="cuda", preset=MOE_PRESET, n_layers=2, tol=1e-3):
    """Mixtral width, 2 layers, f32, dropless (capacity_factor E/K, as the
    server sets it): the logits through the kernels (paged prefill whose
    first chunk runs B1 at D=128, G=4, then one decode step through B4)
    against the plain dense-cache path on one 100-token prompt, with
    check_model's tolerance; and the routing, the top-2 expert ids of every
    token in every layer, equal between the two paths."""
    import torch
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import KVCache, Llama, LlamaConfig
    from ray_tpu_torch.ops.paged_attention import PagedKVCache

    cfg = getattr(LlamaConfig, preset)(n_layers=n_layers, dtype=torch.float32,
                                       param_dtype=torch.float32, max_seq_len=256)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    model = init_params(Llama(cfg, device=device), torch.Generator(device=device).manual_seed(0))
    model.requires_grad_(False)
    ids = lambda: [blk.moe.last_gate_idx.clone() for blk in model.blocks()]
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 100))).to(device)
    before = flash_counts()
    with torch.no_grad():
        dense = KVCache.init(cfg, 1, 256, device=device)
        logits_d, dense = model(prompt, cache=dense)
        ids_d = ids()
        nxt = logits_d[:, -1].argmax(-1, keepdim=True)
        step_d, _ = model(nxt, cache=dense)
        ids_d += ids()
        paged = PagedKVCache.init(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 5, 64,
                                  1, 4, dtype=torch.float32, device=device)
        paged.block_tables[0] = torch.tensor([3, 1, 4, 2], dtype=torch.int32)
        logits_p, paged = model(prompt, cache=paged, paged_chunk_local=True)
        ids_p = ids()
        step_p, _ = model(nxt, cache=paged)
        ids_p += ids()
    launched = [a - b for a, b in zip(flash_counts(), before)]
    err_prefill = (logits_p - logits_d).abs().max().item()
    err_step = (step_p - step_d).abs().max().item()
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(ids_p, ids_d))
    want = [n_layers, 0, 0] if device == "cuda" else [0, 0, 0]
    finite = bool(torch.isfinite(logits_p).all() and torch.isfinite(step_p).all())
    log(f"[moe] {preset} x {n_layers} layers f32 kernel path vs plain path: prefill "
        f"logits max-abs {err_prefill:.3e}, decode-step logits max-abs {err_step:.3e} (tol "
        f"{tol}); top-2 expert ids differ for {flips} of {101 * n_layers} (token, layer) "
        f"pairs; fwd/dq/dkv launched {launched} (want {want})")
    if not (finite and err_prefill <= tol and err_step <= tol and flips == 0
            and launched == want):
        raise AssertionError(f"moe model check failed: finite={finite}, prefill "
                             f"{err_prefill}, step {err_step}, flips {flips}, "
                             f"launched {launched}")
    del model, dense, paged
    return dict(prefill_max_abs_err=err_prefill, step_max_abs_err=err_step, tol=tol,
                expert_id_flips=flips)


def run_moe(rng, device="cuda", preset=MOE_PRESET, n_layers=MOE_LAYERS):
    """The MoE serving path: (a) the f32 2-layer model check; (b) the paged
    LLMServer at Mixtral width with MOE_LAYERS layers, bf16 weights from
    seed 0, through `serve_and_count` and one profiled wave; (c) B1 and B4
    timed at its shapes."""
    import gc
    import torch
    from ray_tpu_torch.models.llama import llama_param_count
    from ray_tpu_torch.serve.llm import LLMServer

    out = dict(model_check=check_moe_model(device, preset))
    cuda = device == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = LLMServer(serving_config(preset, device, model_overrides={"n_layers": n_layers}))
    mc = server.model_cfg
    params = llama_param_count(mc)
    log(f"[moe] {preset} at {mc.n_layers} layers: d_model {mc.d_model}, "
        f"{mc.n_heads}/{mc.n_kv_heads} heads, head_dim {mc.head_dim}, ffn {mc.ffn_dim}, "
        f"{mc.n_experts} experts top-{mc.moe_top_k}, capacity_factor {mc.capacity_factor} "
        f"(dropless), {params:,} params, built in {time.perf_counter() - t0:.1f} s")
    summary = serve_and_count(server, "moe", device)
    out.update(summary, params=params, n_layers=mc.n_layers)
    if not cuda:
        return out
    peak = torch.cuda.max_memory_allocated()
    log(f"[moe] peak device memory {peak / 2**30:.2f} GiB")
    prof = profile_wave(server, mc.vocab_size, tag="moe", ranges=("moe_einsums",))
    prof["moe_einsums_ms"] = prof["ranges"]["moe_einsums"]["device_ms"]
    prof["moe_einsums_share"] = (prof["moe_einsums_ms"] / 1e3 / prof["device_kernel_s"]
                                 if prof["moe_einsums_ms"] else "not measured")
    log(f"[moe] MoE einsums (dispatch, three expert products, combine): "
        f"{prof['moe_einsums_ms']:.3f} ms of device time, share "
        f"{prof['moe_einsums_share']}")
    out.update(peak_memory_bytes=peak, profile=prof)
    serve_lengths = [n + 16 for n in summary["prompt_lens"][:8]]
    del server
    gc.collect()
    torch.cuda.empty_cache()
    out["flash_timing"] = time_flash(rng, 128, d=128)
    out["paged_timing"] = time_paged(rng, serve_lengths, d=128)
    for what, r in (("flash_fwd B=1 T=128 H=32 Kh=8 D=128", out["flash_timing"]),
                    ("paged_decode B=8 H=32 Kh=8 D=128 serve lengths", out["paged_timing"])):
        lib = f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "none"
        log(f"[moe] {what}: {r['ms']:.4f} ms (eager call {r['eager_ms']:.4f}), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    return out


# ------------------------------------------------------------------ replica
def check_spec_tiny(device="cuda"):
    """Speculation's accept path on the device: the tiny preset in f32 on
    weights made on the CPU from seed 0 (the CPU generator, so that a CPU
    run of this function drafts and accepts on the same weights and
    prompt: 16 of 35 drafted tokens), prompt P + O + P with O the plain
    server's continuation of P. speculate=4 must accept tokens and give
    the ids of plain decode."""
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer

    f32 = dict(preset="tiny", max_batch_slots=2, max_seq_len=512, seed=0,
               param_dtype="float32", dtype="float32")
    params = LLMServer(LLMConfig(device="cpu", **f32)).model.state_dict()
    plain = LLMServer(LLMConfig(device=device, **f32), params=params)
    spec = LLMServer(LLMConfig(speculate=4, device=device, **f32), params=params)
    head = np.random.default_rng(21).integers(1, 256, 16).tolist()
    prompt = head + asyncio.run(plain.generate(head, max_tokens=48))["tokens"] + head
    want = asyncio.run(plain.generate(prompt, max_tokens=48))["tokens"]
    got = asyncio.run(spec.generate(prompt, max_tokens=48))["tokens"]
    st = spec.stats()["speculation"]
    log(f"[replica] speculate=4 vs 0, tiny f32 dense (CPU-seeded weights), "
        f"{len(prompt)}-token prompt, 48 tokens: ids equal {got == want}; {st}")
    if got != want or st["accepted"] == 0:
        raise AssertionError(f"tiny speculation: ids {got} vs {want}, stats {st}")
    return dict(st, equal=got == want, tokens=len(got), prompt_len=len(prompt))


def run_replica(device="cuda", preset="llama_1b"):
    """The rest of the LLM replica at llama_1b width: (a) a dense f32 server
    with speculate=4 against the same weights with speculate=0 on a prompt
    that repeats itself (greedy ids equal, and speculative ticks must have
    run; f32, so that the [B, K+1] and [B, 1] products cannot round a
    near-tie apart). A random model's greedy output does not repeat the
    prompt's n-grams, so the prompt is P + O + P, where O is the plain
    server's continuation of P: after the second P the model's output
    tends to follow O, which the lookup drafts; (b) embed on a
    300-token prompt in bf16 through B1 (n_layers launches) against the
    same weights through attn_impl="xla", within TOL["bfloat16"] of the
    largest |value|; (c) a merged LoRA adapter served through
    LLMServer(params=...) for one request."""
    import gc
    import torch
    from ray_tpu_torch.models import lora as lora_mod
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer

    out = dict(speculation_tiny=check_spec_tiny(device))
    f32 = dict(preset=preset, max_batch_slots=2, max_seq_len=512, device=device,
               seed=0, param_dtype="float32", dtype="float32")
    plain = LLMServer(LLMConfig(**f32))
    spec = LLMServer(LLMConfig(speculate=4, **f32), params=plain.model.state_dict())
    vocab = plain.model_cfg.vocab_size
    rng = np.random.default_rng(21)
    head = rng.integers(1, vocab, 16).tolist() * 4
    prompt = head + asyncio.run(plain.generate(head, max_tokens=48))["tokens"] + head
    want = asyncio.run(plain.generate(prompt, max_tokens=48))["tokens"]
    got = asyncio.run(spec.generate(prompt, max_tokens=48))["tokens"]
    st = spec.stats()["speculation"]
    out["speculation"] = dict(st, equal=got == want, tokens=len(got), prompt_len=len(prompt))
    log(f"[replica] speculate=4 vs 0, {preset} f32 dense, {len(prompt)}-token repeating "
        f"prompt, 48 tokens: ids equal {got == want}; {st}")
    if got != want or st["spec_ticks"] == 0:
        raise AssertionError(f"speculation: ids {got} vs {want}, stats {st}")
    del plain, spec

    bf16 = dict(preset=preset, max_batch_slots=1, max_seq_len=512, device=device, seed=0)
    srv = LLMServer(LLMConfig(**bf16))
    ref_srv = LLMServer(LLMConfig(model_overrides={"attn_impl": "xla"}, **bf16),
                        params=srv.model.state_dict())
    prompt = rng.integers(1, vocab, 300).tolist()
    before = flash_counts()
    vec = np.asarray(asyncio.run(srv.embed(prompt)))
    launched = [a - b for a, b in zip(flash_counts(), before)]
    ref = np.asarray(asyncio.run(ref_srv.embed(prompt)))
    err = float(np.abs(vec - ref).max() / np.abs(ref).max())
    layers = srv.model_cfg.n_layers if device == "cuda" else 0
    out["embed"] = dict(rel_err=err, tol=TOL["bfloat16"], launched=launched,
                        dim=len(vec), finite=bool(np.isfinite(vec).all()))
    log(f"[replica] embed of 300 tokens (bucket 512), bf16: flash vs plain path max "
        f"error {err:.3e} of max |value| (tol {TOL['bfloat16']}); fwd/dq/dkv launched "
        f"{launched} (want [{layers}, 0, 0])")
    if not (err <= TOL["bfloat16"] and launched == [layers, 0, 0] and out["embed"]["finite"]):
        raise AssertionError(f"embed check failed: {out['embed']}")
    del ref_srv

    base = srv.model.state_dict()
    gen = torch.Generator(device=device).manual_seed(5)
    adapter = lora_mod.init_lora(gen, base, rank=8)
    with torch.no_grad():
        for f in adapter["factors"].values():
            f["b"].normal_(0.0, 0.02, generator=gen)
    merged = lora_mod.merge_lora(base, adapter)
    changed = sum(not torch.equal(merged[k], base[k]) for k in adapter["factors"])
    del srv
    lora_srv = LLMServer(LLMConfig(**bf16), params=merged)
    toks = asyncio.run(lora_srv.generate(prompt[:40], max_tokens=16))["tokens"]
    out["lora"] = dict(targets=len(adapter["factors"]), changed=changed,
                       params=lora_mod.lora_param_count(adapter), tokens=len(toks))
    log(f"[replica] LoRA rank 8 over {len(adapter['factors'])} weights "
        f"({out['lora']['params']:,} params), merged ({changed} weights changed) and served: "
        f"{len(toks)} tokens")
    if not (changed == len(adapter["factors"]) and len(toks) == 16
            and all(0 <= t < vocab for t in toks)):
        raise AssertionError(f"LoRA serve failed: {out['lora']}, tokens {toks}")
    del lora_srv, merged, base
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ pd
@contextlib.contextmanager
def environ(**values):
    """Set environment variables (None: unset) for the block."""
    import os
    keep = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Stopwatch:
    """Wraps a bound method: each call's wall time (the device synchronized
    on both sides, so earlier queued work is not counted) and its pages
    (from `pages(args, result)`)."""

    def __init__(self, obj, name, pages, device):
        self.fn, self.pages, self.device = getattr(obj, name), pages, device
        self.calls, self.n_pages, self.seconds = 0, 0, 0.0
        setattr(obj, name, self)

    def _sync(self):
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def __call__(self, *args):
        self._sync()
        t0 = time.perf_counter()
        out = self.fn(*args)
        self._sync()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.n_pages += self.pages(args, out)
        return out

    def ms_per_page(self):
        return self.seconds * 1e3 / self.n_pages if self.n_pages else None

    def restore(self):
        """Put the wrapped method back: later calls run unsynchronized."""
        vars(self.fn.__self__).pop(self.fn.__name__)


def time_seal_parts(server, n_pages=4, reps=5):
    """Where a seal's and an install's time goes, on `n_pages` pages (K and
    V) of the server's pool, in ms a page (least of `reps`, the device
    synchronized around each): the gather on the device; the copy to the
    host into pinned memory, into pageable memory touched before, and into
    a fresh shm segment (a whole seal, as `_publish_pages` does); a host
    copy from pinned memory into a fresh segment; and the install's copy
    from a segment to the device."""
    from multiprocessing import shared_memory

    import torch
    from ray_tpu_torch._private.object_store import StoreClient, seg_name
    from ray_tpu_torch.serve import kv_transfer as kt

    sync = torch.cuda.synchronize
    rows = torch.arange(1, n_pages + 1, device=server.cache.k_pages.device)
    pools = (server.cache.k_pages, server.cache.v_pages)
    k, v = (pool[:, :, rows] for pool in pools)
    nbytes = 2 * k.numel() * k.element_size()
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pageable = torch.zeros(nbytes, dtype=torch.uint8)
    flat = torch.cat([k.view(torch.uint8).reshape(-1), v.view(torch.uint8).reshape(-1)])
    store, seq = StoreClient(backend="pershm"), iter(range(10 ** 6))
    probe = f"sealprobe{kt._proc_tag}-"     # ids of this process only

    def fresh_copy():
        handle = store.create_writable(f"{probe}{next(seq)}", nbytes)
        seg = torch.frombuffer(handle.view, dtype=torch.uint8)
        seg.copy_(pinned)
        del seg
        handle.seal()

    def install():   # attach the first probe segment, copy it to the device
        shm = shared_memory.SharedMemory(name=seg_name(f"{probe}0"))
        att = torch.frombuffer(shm.buf, dtype=torch.uint8, count=nbytes)
        att.to(rows.device)
        del att
        shm.close()

    steps = dict(gather=lambda: [pool[:, :, rows] for pool in pools],
                 d2h_pinned=lambda: pinned.copy_(flat),
                 d2h_pageable=lambda: pageable.copy_(flat),
                 seal_fresh_segment=lambda: kt._seal_blocks(
                     store, f"{probe}{next(seq)}", k, v),
                 host_copy_fresh_segment=fresh_copy,
                 install_from_segment=install)
    out = {}
    for name, fn in steps.items():
        best = float("inf")
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        out[name] = best * 1e3 / n_pages
    for i in range(next(seq)):
        store.delete_segment(f"{probe}{i}")
    out["bytes_a_page"] = nbytes // n_pages
    log("[pd] seal and install parts, ms a page of " + str(nbytes // n_pages) + " B: "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items() if k != "bytes_a_page"))
    return out


async def wave_then_settle(server, prompts, max_tokens, device, settle_s=0.05):
    """serve_wave, then `settle_s` more on the loop, so that every request's
    `serve.pd.first_decode` poll records before asyncio.run ends; returns
    (results, the wave's seconds without the settle)."""
    import torch
    t0 = time.perf_counter()
    res = await serve_wave(server, prompts, max_tokens)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    await asyncio.sleep(settle_s)
    return res, seconds


def time_begins(source):
    """Wrap `source.begin` (the decode side's awaited prefill_begin, which
    no trace window covers) with a host stopwatch; returns the list its
    calls' seconds go to. `del source.begin` removes the wrapper."""
    real, seconds = source.begin, []

    async def begin(*args):
        t0 = time.perf_counter()
        out = await real(*args)
        seconds.append(time.perf_counter() - t0)
        return out
    source.begin = begin
    return seconds


PD_WINDOWS = ("queue", "prefill", "kv_ship", "first_decode")   # the decode side's
PD_SPANS = ("prefill_chunk", "kv_seal")                        # the prefill side's


def pd_breakdown(events, n_req, shipped_pages, ttft_p50_s, begin_s, tag="pd",
                 inside="in one process the wave's prefill chunks and decode ticks run "
                        "inside it"):
    """The PD wave's TTFT breakdown from the trace ring: per request (one
    trace id), the seconds of each `serve.pd.*` family summed; their p50
    over the requests and its share of TTFT p50. Checks: one trace a
    request, each holding exactly one queue and one first_decode window and
    at least one prefill, kv_ship, prefill_chunk and kv_seal (JAX records
    one prefill window a wait and one kv_ship window a segment), and the
    kv_seal spans' pages summing to the pages the wave shipped. Beside
    them, `begin_s`: each request's awaited prefill_begin (a stopwatch, not
    a window). Logs it; raises on a miss."""
    traces = {}
    for e in events:
        if e["name"].startswith("serve.pd."):
            fam = e["name"][len("serve.pd."):]
            t = traces.setdefault(e.get("trace_id"), {})
            t.setdefault(fam, []).append(e)
    counts = {f: sorted({len(t.get(f, [])) for t in traces.values()})
              for f in PD_WINDOWS + PD_SPANS}
    seal_pages = sum(e["args"]["pages"] for t in traces.values() for e in t.get("kv_seal", []))
    checks = {
        f"one trace id a request ({len(traces)} traces, {n_req} requests)":
            len(traces) == n_req and None not in traces,
        f"one queue and one first_decode window a request (counts {counts['queue']}, "
        f"{counts['first_decode']})": counts["queue"] == counts["first_decode"] == [1],
        f"prefill, kv_ship, prefill_chunk and kv_seal in every request (counts "
        f"{[counts[f] for f in ('prefill', 'kv_ship', 'prefill_chunk', 'kv_seal')]})":
            all(counts[f] and counts[f][0] >= 1
                for f in ("prefill", "kv_ship", "prefill_chunk", "kv_seal")),
        f"kv_seal pages == pages shipped ({seal_pages} == {shipped_pages:.0f})":
            seal_pages == shipped_pages,
        f"one prefill_begin a request ({len(begin_s)})": len(begin_s) == n_req,
    }
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} trace checks failed: {counts}, seal pages {seal_pages}")
    out = dict(ttft_p50_s=ttft_p50_s, windows_a_request=counts, kv_seal_pages=seal_pages,
               families={})
    for fam in PD_WINDOWS + PD_SPANS:
        per = sorted(sum(e["dur"] for e in t.get(fam, [])) for t in traces.values())
        p50 = float(np.median(per))
        out["families"][fam] = dict(p50_s=p50, max_s=per[-1], share_of_ttft_p50=p50 / ttft_p50_s)
    # what the windows before the first token cover: the rest of TTFT is
    # spent where no window is open (inside the awaited prefill_begin, the
    # event loop running other requests' work)
    before = [sum(e["dur"] for f in PD_WINDOWS + PD_SPANS if f != "first_decode"
                  for e in t.get(f, [])) for t in traces.values()]
    out["covered_before_first_token_p50_s"] = float(np.median(before))
    out["begin"] = dict(p50_s=float(np.median(begin_s)), max_s=max(begin_s),
                        share_of_ttft_p50=float(np.median(begin_s)) / ttft_p50_s,
                        calls=len(begin_s))
    log(f"[{tag}] TTFT breakdown over {n_req} requests (trace windows, p50 a request, share of "
        f"TTFT p50 {ttft_p50_s * 1e3:.1f} ms): " + ", ".join(
            f"{f} {r['p50_s'] * 1e3:.2f} ms ({r['share_of_ttft_p50']:.3f})"
            for f, r in out["families"].items())
        + f"; windows before the first token cover {float(np.median(before)) * 1e3:.2f} ms a "
        f"request (p50); the awaited prefill_begin (stopwatch, no window; {inside}) "
        f"{out['begin']['p50_s'] * 1e3:.2f} ms ({out['begin']['share_of_ttft_p50']:.3f}); "
        f"kv_seal pages {seal_pages}; first_decode falls after the first token ({smi_line()})")
    return out


# ------------------------------------------------------------------ serve deployments
def state_digest(sd):
    """sha256 over a state_dict's keys, dtypes, shapes and bytes."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for key, t in sd.items():
        t = t.detach().to("cpu").contiguous()
        h.update(f"{key}:{t.dtype}:{tuple(t.shape)};".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def prompt_key(prompt):
    """A short key of a prompt's ids, the same in every process."""
    import hashlib
    return hashlib.sha256(np.asarray(prompt, np.int64).tobytes()).hexdigest()[:16]


class EngineReplica:
    """One of the port's serving engines in a process of the port's runtime:
    a serve deployment's class (`serve_pd_proc`, `serve_app`, `--cards 4`
    `serve`) or a plain `num_gpus=1` actor (`runtime`). `kind` "llm"
    (LLMServer), "prefill" (PrefillServer) or "pd" (PDServer, whose
    `prefill` is a deployment handle), built in that process from `config`
    (seeded weights unless `params` is given), TF32 off as main() sets it.
    Through a deployment every other attribute is the engine's (the
    prefill methods; the prefix digest and SLO snapshot ride the replica's
    stats frame); a plain actor sees the methods defined here. Besides, it
    answers what the driver cannot see from its own process: the launch
    counts, the card binding, the kv_ship counters and trace ring, a digest
    of the weights, a stopwatch on the seal, each request it served
    (`served`: the prompt's key, the ids, TTFT and total seconds), the shm
    segments its prefill_wait frames announced, and where a tensor the
    driver sent landed."""

    def __init__(self, kind, config, params=None, prefill=None):
        import torch
        from ray_tpu_torch.serve.llm import LLMServer
        from ray_tpu_torch.serve.pd import PDServer, PrefillServer
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = "cuda" if config.device == "cuda" else "cpu"
        if kind == "pd":
            self.server = PDServer(config, params=params, prefill=prefill)
        else:
            self.server = {"llm": LLMServer, "prefill": PrefillServer}[kind](config, params=params)
        self._served, self._announced, self._watch = [], set(), {}

    def __getattr__(self, name):
        if name.startswith("__") or name == "server":
            raise AttributeError(name)
        return getattr(self.server, name)

    def _record(self, prompt, tokens, ttft_s, total_s):
        self._served.append(dict(key=prompt_key(prompt), tokens=list(tokens), ttft_s=ttft_s,
                                 total_s=total_s))

    async def generate(self, prompt_ids, max_tokens=32, eos_id=None, **kw):
        out = await self.server.generate(prompt_ids, max_tokens, eos_id, **kw)
        self._record(prompt_ids, out["tokens"], out.get("ttft_s"), out.get("total_s"))
        return out

    async def generate_stream(self, prompt_ids, max_tokens=32, eos_id=None, **kw):
        t0, toks, ttft = time.perf_counter(), [], None
        try:
            async for tok in self.server.generate_stream(prompt_ids, max_tokens, eos_id, **kw):
                if ttft is None:
                    ttft = time.perf_counter() - t0
                toks.append(tok)
                yield tok
        finally:
            self._record(prompt_ids, toks, ttft, time.perf_counter() - t0)

    async def prefill_wait(self, ship_id, have=0):
        from ray_tpu_torch._private.object_store import seg_name
        out = await self.server.prefill_wait(ship_id, have)
        self._announced.update(seg_name(s[k]) for s in out["segments"] for k in ("oid", "wire"))
        return out

    def served(self, clear=False):
        out = list(self._served)
        if clear:
            self._served.clear()
        return out

    def close_shipping(self):
        """Close the KV data server and the ship writer (which unlinks any
        segment not dropped), as a prefill replica's teardown does; returns
        the names of the segments its prefill_wait frames announced."""
        if self.server._kv_server is not None:
            self.server._kv_server.close()
        self.server._ship_writer.close()
        return sorted(self._announced)

    def stats(self):
        return self.server.stats()

    def launch_counts(self):
        return launch_counts()

    def reset_launch_counts(self):
        reset_launch_counts()

    def binding(self):
        return card_binding()

    def started(self):
        return process_start_time()

    def check_tensor(self, t, seed):
        """Where the driver's tensor landed, and whether it is bit-equal to
        the same draw made here."""
        return dict(device=str(t.device), equal=bool(torch_equal_draw(t, seed)))

    def plan(self):
        return dict(n_layers=self.server.model_cfg.n_layers,
                    n_split=n_split_of(self.server, self.device))

    def digest(self):
        return state_digest(self.server.model.state_dict())

    def ship_counters(self):
        from ray_tpu_torch.util import metrics
        return metrics.kv_ship_counters()

    def trace_events(self):
        from ray_tpu_torch.util import tracing
        return tracing.events()

    def trace_clear(self):
        from ray_tpu_torch.util import tracing
        tracing.clear()

    def watch_seal(self):
        self._watch["seal"] = Stopwatch(self.server, "_publish_pages",
                                        lambda a, out: out["n_pages"], self.device)

    def seal_watched(self):
        w = self._watch.pop("seal")
        w.restore()
        return dict(calls=w.calls, pages=w.n_pages, ms_per_page=w.ms_per_page())


PD_PROC_APP = "pd_proc"      # the serve app of `serve_pd_proc`'s prefill replica


def engine_class():
    """`EngineReplica` by reference to this module, which the replica or
    actor imports (run as a script, this file's own class would be pickled
    by value with every global it reaches)."""
    import importlib
    return importlib.import_module("chip_smoke").EngineReplica


def engine_deployment(name, num_replicas=1):
    """`EngineReplica` as a deployment: a card a replica (`num_gpus=1`; to a
    card-less session a "GPU" is a number), max_ongoing_requests the
    engine's 8 slots."""
    from ray_tpu_torch import serve
    return serve.deployment(engine_class(), name=name, num_replicas=num_replicas,
                            max_ongoing_requests=8, ray_actor_options={"num_gpus": 1})


def replicas_of(app, name):
    """The replica actors of a deployment, from the serve controller."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.controller import get_controller
    return rt.get(get_controller().get_replicas.remote(app, name))


def on_replica(actor, method, *args, timeout=600):
    """One method of one replica (not routed: that replica's own answer)."""
    import ray_tpu_torch as rt
    return rt.get(actor.handle_request.remote(method, *args), timeout=timeout)


def run_pd(device="cuda", preset="llama_1b", max_tokens=16):
    """Prefill/decode disaggregation at llama_1b width and depth: a
    colocated LLMServer, a PrefillServer and a PDServer on one card and one
    set of bf16 weights (seed 0), all with the radix prefix cache. (a) The
    slice's 10 prompts one at a time, 16 tokens each: PD ids equal the
    colocated ids (the decode batch shape and the shipped page bytes are
    the same); the 256-token shared prefix is not shipped again (saved
    pages >= 4); shipped bytes = pages x the page's K+V bytes; peak device
    memory during PD admission grows by less than one K pool (the install
    scatters in place). (b) One request without the same-host attach
    (pulled over the KV data server's streams) and one over the whole-KV
    RPC hand-off, each equal to colocated. (c) A concurrent wave of 10 fresh
    prompts through generate and generate_stream, the launch counters
    reset just before and read just after: B1 once a layer per fresh first
    chunk on the prefill side, B4 once a layer per decode step of the PD
    server, no backward kernel; the PD server itself prefills nothing; and
    its TTFT breakdown from the trace windows (`pd_breakdown`).
    Seal (device to shm) and install (shm to device) times per page are
    measured around every call of (a) and (b), the device synchronized on
    both sides; the wave runs without those syncs. (d) Path
    `serve_pd_proc` (`run_pd_proc`): (a)-(c) again with the prefill
    replica a serve deployment of the port's runtime (`EngineReplica`
    "prefill", num_gpus=1), deployed first, so that its start overlaps
    (a)-(c). The runtime's session is the caller's, or one opened here and
    shut down at the end."""
    import gc
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.serve.pd import PDServer, PrefillServer
    from ray_tpu_torch.util import metrics as tm
    from ray_tpu_torch.util import tracing

    cuda = device == "cuda"
    own = not rt.is_initialized()
    if own:
        open_session(device)
    shm_before = set(shm_segments())
    colo = LLMServer(serving_config(preset, device))
    params = colo.model.state_dict()
    t_deploy = time.perf_counter()
    handle = serve.run(engine_deployment("prefill").bind(
        "prefill", serving_config(preset, device)), name=PD_PROC_APP)
    try:   # the replica runs until run_pd_proc deletes its app
        prefill = PrefillServer(serving_config(preset, device), params=params)
        pd = PDServer(serving_config(preset, device), params=params, prefill=prefill)
        mc = pd.model_cfg
        L = mc.n_layers
        page_bytes = 2 * pd.cache.k_pages[:, :, 0].numel() * pd.cache.k_pages.element_size()
        pool_bytes = pd.cache.k_pages.numel() * pd.cache.k_pages.element_size()
        seal = Stopwatch(prefill, "_publish_pages", lambda a, out: out["n_pages"], device)
        install = Stopwatch(pd, "_install_pages", lambda a, out: a[2], device)
        gen = lambda srv, p, n=max_tokens: asyncio.run(srv.generate(p, max_tokens=n))["tokens"]
        gen(colo, list(range(1, 50)), 8)          # warm-up, both paths
        gen(pd, list(range(1, 50)), 8)

        wave1, wave2 = slice_prompts(mc.vocab_size)
        seq = wave1 + wave2
        k0 = tm.kv_ship_counters()
        if cuda:
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        equal, saved_at_hit, wants = [], None, []
        for i, p in enumerate(seq):
            want = gen(colo, p)
            wants.append(want)
            before_saved = tm.kv_ship_counters()["saved_pages"]
            got = gen(pd, p)
            equal.append(got == want)
            if i == len(wave1):   # wave 2's first prompt: the shared 256-token prefix
                saved_at_hit = tm.kv_ship_counters()["saved_pages"] - before_saved
        peak_growth = (torch.cuda.max_memory_allocated() - base_mem) if cuda else 0
        k1 = tm.kv_ship_counters()
        shipped = {k: k1[k] - k0[k] for k in k1}

        rng = np.random.default_rng(999)
        p_pull, p_rpc = rng.integers(1, mc.vocab_size, 200).tolist(), rng.integers(
            1, mc.vocab_size, 150).tolist()
        pulled = dict(pull=(p_pull, gen(colo, p_pull)), whole=(p_rpc, gen(colo, p_rpc)))
        with environ(RAY_TPU_KV_ATTACH="0"):
            before = tm.kv_ship_counters()
            pull_equal = gen(pd, p_pull) == pulled["pull"][1]
            pulls = tm.kv_ship_counters()["stream_pulls"] - before["stream_pulls"]
        with environ(RAY_TPU_KV_SHIP="0"):
            before = tm.kv_ship_counters()
            rpc_equal = gen(pd, p_rpc) == pulled["whole"][1]
            rpc_segments = tm.kv_ship_counters()["segments"] - before["segments"]

        checks = {
            f"PD ids == colocated ids for all {len(seq)} sequential requests": all(equal),
            f"the shared 256-token prefix was not shipped again (saved pages {saved_at_hit} >= 4)":
                (saved_at_hit or 0) >= 4,
            f"shipped bytes == pages x {page_bytes} B ({shipped['pages']:.0f} pages)":
                shipped["bytes"] == shipped["pages"] * page_bytes and shipped["pages"] > 0,
            "every segment attached same-host": shipped["attach_hits"] == shipped["segments"],
            f"peak memory during PD admission grew by less than one K pool "
            f"({peak_growth / 2**20:.1f} MiB < {pool_bytes / 2**20:.1f} MiB)":
                peak_growth < pool_bytes,
            f"RAY_TPU_KV_ATTACH=0: pulled over the data server ({pulls:.0f} stream pulls), "
            f"ids equal": pulls >= 1 and pull_equal,
            "RAY_TPU_KV_SHIP=0: whole-KV hand-off, no segment, ids equal":
                rpc_equal and rpc_segments == 0,
        }
        for what, ok in checks.items():
            log(f"[pd] {'ok  ' if ok else 'FAIL'} {what}")
        if not all(checks.values()):
            raise AssertionError(f"pd checks failed: equal {equal}, shipped {shipped}, "
                                 f"saved at hit {saved_at_hit}, peak growth {peak_growth}")
        out = dict(sequential_requests=len(seq), max_tokens=max_tokens, ids_equal=all(equal),
                   saved_pages_at_hit=saved_at_hit, shipped=shipped, page_bytes=page_bytes,
                   peak_growth_bytes=peak_growth, pool_bytes=pool_bytes,
                   stream_pulls=pulls, rpc_handoff_equal=rpc_equal)
        del colo
        gc.collect()

        # (c) the concurrent wave, on fresh prompts, without the stopwatches'
        # device syncs: its TTFT and tokens/s are those of the plain path. The
        # trace ring is cleared just before it and read after it.
        seal.restore()
        install.restore()
        wave1, wave2 = slice_prompts(mc.vocab_size, seed=4321)
        wmax = 32
        b_pd, b_pre = pd.stats(), prefill.stats()
        pd.slo_snapshot()
        k_wave = tm.kv_ship_counters()
        begin_s = time_begins(pd._ship_source())
        tracing.clear()
        reset_launch_counts()
        res, wall = [], 0.0
        for wave in (wave1, wave2):
            got, seconds = asyncio.run(wave_then_settle(pd, wave, wmax, device))
            res += got
            wall += seconds
        launches = launch_counts()
        del pd._ship_source().begin              # the class's method again
        wave_pages = tm.kv_ship_counters()["pages"] - k_wave["pages"]
        a_pd, a_pre = pd.stats(), prefill.stats()
        tokens, syncs, decode_s, steps = decode_delta(a_pd, b_pd)
        fresh = a_pre["prefill"]["chunk_local"] - b_pre["prefill"]["chunk_local"]
        n_req = len(wave1) + len(wave2)
        for toks, _, _ in res:
            if len(toks) != wmax or not all(0 <= t < mc.vocab_size for t in toks):
                raise AssertionError(f"bad PD output: {len(toks)} tokens {toks[:8]}...")
        wave_checks = {
            "the PD server prefilled nothing":
                a_pd["prefill"]["chunks"] == b_pd["prefill"]["chunks"],
            f"every fresh prompt took the chunk-local path on the prefill side ({fresh})":
                fresh == n_req - 1,
            f"slo_snapshot() counts the wave's {n_req} PD requests":
                pd.slo_snapshot()["ttft_count"] == n_req,
        }
        for what, ok in wave_checks.items():
            log(f"[pd] {'ok  ' if ok else 'FAIL'} {what}")
        if not all(wave_checks.values()):
            raise AssertionError(f"pd wave checks failed: fresh {fresh}, stats {a_pd}")
        launch_checks("pd", launches, L, fresh, steps, n_split_of(pd, device))
        ttft = sorted(r[1] for r in res)
        breakdown = pd_breakdown(tracing.events(), n_req, wave_pages, float(np.median(ttft)),
                                 begin_s)
        out.update(requests=n_req, wave_max_tokens=wmax, ttft_p50_s=float(np.median(ttft)),
                   ttft_max_s=ttft[-1], decode_tokens=tokens, decode_host_syncs=syncs,
                   decode_steps=steps, decode_s=decode_s,
                   decode_tokens_per_s=tokens / decode_s if decode_s else None,
                   host_syncs_per_token=syncs / tokens, wall_s=wall, launches=launches,
                   fresh_first_chunks=fresh, paged_n_split=n_split_of(pd, device),
                   seal=dict(calls=seal.calls, pages=seal.n_pages, ms_per_page=seal.ms_per_page()),
                   install=dict(calls=install.calls, pages=install.n_pages,
                                ms_per_page=install.ms_per_page()),
                   kv_ship=a_pd["kv_ship"], slo_pd=a_pd["slo"]["ttft_s"],
                   ttft_breakdown=breakdown)
        if cuda:
            out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            out["seal_parts"] = time_seal_parts(pd)
        log(f"[pd] sequential: {len(seq)} requests x {max_tokens} tokens, ids equal; shipped "
            f"{shipped['pages']:.0f} pages, {shipped['bytes'] / 2**20:.1f} MiB in "
            f"{shipped['segments']:.0f} segments, {shipped['saved_pages']:.0f} pages not shipped; "
            f"peak growth {peak_growth / 2**20:.1f} MiB")
        log(f"[pd] seal (device -> shm) {out['seal']['ms_per_page']:.4f} ms a page over "
            f"{seal.n_pages} pages, install (shm -> device) {out['install']['ms_per_page']:.4f} "
            f"ms a page over {install.n_pages} pages")
        log(f"[pd] wave: {n_req} requests x {wmax} tokens in {wall:.2f} s: TTFT p50 "
            f"{out['ttft_p50_s'] * 1e3:.1f} ms, decode {out['decode_tokens_per_s']:.1f} tokens/s "
            f"over {syncs} host syncs for {tokens} tokens ({steps} steps, "
            f"{syncs / tokens:.4f} syncs a token); launches {launches}")
        del pd, prefill
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    except BaseException:
        serve.delete(PD_PROC_APP)
        if own:
            close_session("pd")
        raise
    try:
        out["proc"] = run_pd_proc(handle, t_deploy, params, list(zip(seq, wants)), pulled, out,
                                  shm_before, device, preset, max_tokens)
    finally:
        if own:
            close_session("pd")
    out["sequential"] = list(zip(seq, wants))   # run_runtime's reference ids
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def shm_segments():
    """The port's shm segments (`rtpt-*`) now in /dev/shm."""
    from ray_tpu_torch._private.object_store import SEG_PREFIX
    root = Path("/dev/shm")
    return sorted(p.name for p in root.glob(f"{SEG_PREFIX}*")) if root.is_dir() else []


def _split_ship(parent, replica):
    """A kv_ship_counters() delta across the two processes: what prefill
    seals and serves is counted in the replica, what decode pulls here."""
    sealed = ("bytes", "pages", "segments", "requests", "saved_pages", "rpc_fallback_bytes")
    return {k: (replica if k in sealed else parent)[k] for k in parent}


def run_pd_proc(handle, t_deploy, params, sequential, pulled, inproc, shm_before, device="cuda",
                preset="llama_1b", max_tokens=16):
    """Path `serve_pd_proc`: `run_pd`'s checks with the PrefillServer a
    serve deployment of the port's runtime (run_pd's `EngineReplica`
    "prefill", num_gpus=1, deployed at `t_deploy`: its own process on the
    same card, two CUDA contexts time-slicing one H100) and a fresh
    PDServer here whose prefill replica is the deployment's handle. The
    replica built its weights from the seed: their digest equals the
    colocated server's. (a) The same sequential prompts: ids equal the
    colocated server's (from run_pd), the shared prefix not shipped again,
    every segment attached here and sealed there, no byte over the RPC
    fetch; (b) one request over the replica's KV data server
    (RAY_TPU_KV_ATTACH=0) and one over the whole-KV hand-off
    (RAY_TPU_KV_SHIP=0), ids equal; (c) the same concurrent wave as run_pd's
    (10 prompts, 32 tokens): B1 counted in the replica, once a layer per
    fresh first chunk, B4 here, once a layer per decode step, the PD server
    prefilling nothing and the replica decoding nothing; the TTFT breakdown
    with the replica's `prefill_chunk` / `kv_seal` spans merged by trace id,
    beside the in-process wave's. Every reading of the replica's process
    goes through the handle. Seal ms a page is a stopwatch in the replica,
    install ms a page one here, around (a) and (b). After the replica
    closes its shipping and its app is deleted, no `rtpt-*` segment it
    announced, and none new, is left in /dev/shm."""
    import gc
    import torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.pd import PDServer
    from ray_tpu_torch.util import metrics as tm
    from ray_tpu_torch.util import tracing

    cuda = device == "cuda"
    tag = "pd_proc"
    call = lambda name, *a: getattr(handle, name).remote(*a).result(timeout_s=600)
    try:
        info = call("binding")
        ready_s = time.perf_counter() - t_deploy
        theirs, mine = call("digest"), state_digest(params)
        if theirs != mine:
            raise AssertionError(f"the prefill replica's weights differ from the colocated "
                                 f"server's: digest {theirs} != {mine}")
        pd = PDServer(serving_config(preset, device), params=params, prefill=handle)
        mc = pd.model_cfg
        L = mc.n_layers
        page_bytes = 2 * pd.cache.k_pages[:, :, 0].numel() * pd.cache.k_pages.element_size()
        gen = lambda p, n=max_tokens: asyncio.run(pd.generate(p, max_tokens=n))["tokens"]
        gen(list(range(1, 50)), 8)                # warm-up
        install = Stopwatch(pd, "_install_pages", lambda a, out: a[2], device)
        call("watch_seal")
        k0, c0 = tm.kv_ship_counters(), call("ship_counters")
        n_wave1 = len(slice_prompts(mc.vocab_size)[0])
        equal, saved_at_hit = [], None
        for i, (p, want) in enumerate(sequential):
            before = call("ship_counters")["saved_pages"]
            equal.append(gen(p) == want)
            if i == n_wave1:
                saved_at_hit = call("ship_counters")["saved_pages"] - before
        k1, c1 = tm.kv_ship_counters(), call("ship_counters")
        shipped = _split_ship({k: k1[k] - k0[k] for k in k1}, {k: c1[k] - c0[k] for k in c1})
        with environ(RAY_TPU_KV_ATTACH="0"):
            before = tm.kv_ship_counters()
            pull_equal = gen(pulled["pull"][0]) == pulled["pull"][1]
            pulls = tm.kv_ship_counters()["stream_pulls"] - before["stream_pulls"]
        with environ(RAY_TPU_KV_SHIP="0"):
            before = call("ship_counters")
            whole_equal = gen(pulled["whole"][0]) == pulled["whole"][1]
            whole_segments = call("ship_counters")["segments"] - before["segments"]
        install.restore()
        seal = call("seal_watched")
        checks = {
            f"PD ids == colocated ids for all {len(sequential)} sequential requests, prefill "
            f"in process {info['pid']}": all(equal),
            f"the shared 256-token prefix was not shipped again (saved pages {saved_at_hit} "
            f">= 4)": (saved_at_hit or 0) >= 4,
            f"shipped bytes == pages x {page_bytes} B ({shipped['pages']:.0f} pages)":
                shipped["bytes"] == shipped["pages"] * page_bytes and shipped["pages"] > 0,
            f"every segment sealed in the replica attached here ({shipped['attach_hits']:.0f} "
            f"hits)": shipped["attach_hits"] == shipped["segments"] > 0,
            "no byte over the RPC fetch on the attach rung": shipped["rpc_fallback_bytes"] == 0,
            f"RAY_TPU_KV_ATTACH=0: pulled over the replica's data server ({pulls:.0f} stream "
            f"pulls), ids equal": pulls >= 1 and pull_equal,
            "RAY_TPU_KV_SHIP=0: whole-KV hand-off through the handle, no segment, ids equal":
                whole_equal and whole_segments == 0,
        }
        for what, ok in checks.items():
            log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
        if not all(checks.values()):
            raise AssertionError(f"{tag} checks failed: equal {equal}, shipped {shipped}, "
                                 f"saved at hit {saved_at_hit}")
        out = dict(replica_pid=info["pid"], replica_binding=info, ready_s=ready_s,
                   sequential_requests=len(sequential), ids_equal=True,
                   saved_pages_at_hit=saved_at_hit, shipped=shipped, page_bytes=page_bytes,
                   stream_pulls=pulls, whole_kv_equal=whole_equal, seal_in_replica=seal,
                   install=dict(calls=install.calls, pages=install.n_pages,
                                ms_per_page=install.ms_per_page()))

        # (c) the wave, each process's counters and ring reset just before
        wave1, wave2 = slice_prompts(mc.vocab_size, seed=4321)
        wmax = 32
        b_pd, b_pre = pd.stats(), call("stats")
        pd.slo_snapshot()
        k_wave, c_wave = tm.kv_ship_counters(), call("ship_counters")
        begin_s = time_begins(pd._ship_source())
        tracing.clear()
        call("trace_clear")
        reset_launch_counts()
        call("reset_launch_counts")
        res, wall = [], 0.0
        for wave in (wave1, wave2):
            got, seconds = asyncio.run(wave_then_settle(pd, wave, wmax, device))
            res += got
            wall += seconds
        here, there = launch_counts(), call("launch_counts")
        del pd._ship_source().begin
        events = tracing.events() + call("trace_events")
        k_end, c_end = tm.kv_ship_counters(), call("ship_counters")
        wave_ship = _split_ship({k: k_end[k] - k_wave[k] for k in k_end},
                                {k: c_end[k] - c_wave[k] for k in c_end})
        a_pd, a_pre = pd.stats(), call("stats")
        tokens, syncs, decode_s, steps = decode_delta(a_pd, b_pd)
        fresh = a_pre["prefill"]["chunk_local"] - b_pre["prefill"]["chunk_local"]
        n_req = len(wave1) + len(wave2)
        for toks, _, _ in res:
            if len(toks) != wmax or not all(0 <= t < mc.vocab_size for t in toks):
                raise AssertionError(f"bad PD output: {len(toks)} tokens {toks[:8]}...")
        launches = dict(flash_fwd=there["flash_fwd"],
                        flash_bwd_dq=here["flash_bwd_dq"] + there["flash_bwd_dq"],
                        flash_bwd_dkv=here["flash_bwd_dkv"] + there["flash_bwd_dkv"],
                        paged_decode=here["paged_decode"],
                        paged_decode_combine=here["paged_decode_combine"])
        wave_checks = {
            "the PD server prefilled nothing and launched no B1":
                a_pd["prefill"]["chunks"] == b_pd["prefill"]["chunks"]
                and here["flash_fwd"] == 0,
            "the prefill replica launched no B4":
                there["paged_decode"] == there["paged_decode_combine"] == 0,
            f"every fresh prompt took the chunk-local path in the replica ({fresh})":
                fresh == n_req - 1,
            f"slo_snapshot() counts the wave's {n_req} PD requests":
                pd.slo_snapshot()["ttft_count"] == n_req,
            f"every wave segment attached here ({wave_ship['attach_hits']:.0f} of "
            f"{wave_ship['segments']:.0f})": wave_ship["attach_hits"] == wave_ship["segments"] > 0,
        }
        for what, ok in wave_checks.items():
            log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
        if not all(wave_checks.values()):
            raise AssertionError(f"{tag} wave checks failed: here {here}, there {there}, "
                                 f"fresh {fresh}, shipped {wave_ship}")
        launch_checks(tag, launches, L, fresh, steps, n_split_of(pd, device))
        ttft = sorted(r[1] for r in res)
        breakdown = pd_breakdown(events, n_req, wave_ship["pages"], float(np.median(ttft)),
                                 begin_s, tag=tag,
                                 inside="the call and its reply cross the handle; the "
                                        "replica's prefill chunks run in its own process")
        out.update(requests=n_req, wave_max_tokens=wmax, ttft_p50_s=float(np.median(ttft)),
                   ttft_p99_s=float(np.percentile(ttft, 99)), ttft_max_s=ttft[-1],
                   decode_tokens=tokens, decode_host_syncs=syncs, decode_steps=steps,
                   decode_s=decode_s,
                   decode_tokens_per_s=tokens / decode_s if decode_s else None,
                   wall_s=wall, launches=launches, launches_here=here,
                   launches_in_replica=there, fresh_first_chunks=fresh,
                   paged_n_split=n_split_of(pd, device), wave_kv_ship=wave_ship,
                   ttft_breakdown=breakdown)
        log(f"[{tag}] wave across processes: {n_req} requests x {wmax} tokens in {wall:.2f} "
            f"s: TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms, p99 {out['ttft_p99_s'] * 1e3:.1f} "
            f"ms, decode {out['decode_tokens_per_s']:.1f} tokens/s (in process: TTFT p50 "
            f"{inproc['ttft_p50_s'] * 1e3:.1f} ms, max {inproc['ttft_max_s'] * 1e3:.1f} ms, "
            f"decode {inproc['decode_tokens_per_s']:.1f} tokens/s); B1 {there['flash_fwd']} "
            f"in the replica, B4 {here['paged_decode']} here; seal in the replica "
            f"{seal['ms_per_page']:.4f} ms a page over {seal['pages']} pages, install here "
            f"{out['install']['ms_per_page']:.4f} ms a page over {install.n_pages} pages (in "
            f"process {inproc['seal']['ms_per_page']:.4f} / "
            f"{inproc['install']['ms_per_page']:.4f}); two CUDA contexts on one card "
            f"({smi_line()})")
        del pd
    finally:
        try:
            announced = call("close_shipping")
        finally:
            serve.delete(PD_PROC_APP)
    gc.collect()
    new = sorted(set(shm_segments()) - shm_before)
    left = [n for n in announced if os.path.exists(f"/dev/shm/{n}")]
    ok = not left and not new and bool(announced)
    log(f"[{tag}] {'ok  ' if ok else 'FAIL'} no segment left in /dev/shm after the replica closed "
        f"its shipping and its app was deleted ({len(announced)} announced, "
        f"{len(left)} left, {len(new)} new rtpt-*)")
    if not ok:
        raise AssertionError(f"{tag}: segments left {left}, new {new}")
    out["segments_announced"] = len(announced)
    if cuda:
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ runtime
RUNTIME_TRIP_BYTES = 128 << 20     # the bf16 CUDA tensor's trips
RUNTIME_PUT_BYTES = 1 << 30        # the CPU tensor timed through put -> get


def card_binding():
    """This process's card binding as the runtime gave it."""
    import torch
    import ray_tpu_torch as rt
    out = dict(pid=os.getpid(), ppid=os.getppid(), gpu_ids=rt.get_gpu_ids(),
               cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
               device_count=torch.cuda.device_count())
    if out["device_count"]:
        out["uuids"] = [str(torch.cuda.get_device_properties(i).uuid)
                        for i in range(out["device_count"])]
    return out


def seeded_draw(nbytes, seed, device):
    """nbytes of bf16 normals from a generator on `device`: the same bits
    wherever the same draw is made on the same kind of device."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(nbytes // 2, generator=gen, device=device, dtype=torch.bfloat16)


def torch_equal_draw(t, seed):
    import torch
    return torch.equal(t, seeded_draw(t.numel() * 2, seed, t.device))


def draw_on_assigned_card(nbytes, seed, device):
    """A `num_gpus=1` task's tensor, made on its assigned card (a pooled
    worker sees every card: the runtime's ids index them)."""
    import torch
    import ray_tpu_torch as rt
    dev = torch.device("cuda", rt.get_gpu_ids()[0]) if device == "cuda" else "cpu"
    return seeded_draw(nbytes, seed, dev)


def plain_task_modules():
    """What a plain task's worker has loaded of torch, jax and ray_tpu."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "ray_tpu"))


def cpu_task_binding():
    import torch
    return dict(cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
                device_count=torch.cuda.device_count())


class Pinger:
    """A light `num_gpus` actor: its binding once it runs."""

    def binding(self):
        return card_binding()


def open_session(device):
    """init() of the port's runtime for the paths that use actors: the
    card counted as its "GPU" resource (one "GPU" number without a card).
    Returns init's seconds."""
    import ray_tpu_torch as rt
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=None if device == "cuda" else 1)
    return time.perf_counter() - t0


def close_session(tag):
    """serve.shutdown(), then stop_runtime; fails if a worker outlives it.
    Returns the number of workers the session started."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    serve.shutdown()
    workers, left = stop_runtime(rt)
    log(f"[{tag}] {'ok  ' if not left else 'FAIL'} every worker exited after shutdown() "
        f"({workers} workers)")
    if left:
        raise AssertionError(f"{tag}: workers still running after shutdown(): {left}")
    return workers


def stop_runtime(rt):
    """shutdown() and wait for every worker process the session started;
    returns (workers, pids still running after 30 s)."""
    ctl = rt.api._runtime.controller
    procs = [w.proc for w in list(ctl.workers.values()) + list(ctl.spawning.values())
             if w.proc is not None]
    rt.shutdown()
    left = []
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            left.append(p.pid)
    return len(procs), left


def run_runtime(sequential, device="cuda", preset="llama_1b", max_tokens=16,
                trip_bytes=RUNTIME_TRIP_BYTES, put_bytes=RUNTIME_PUT_BYTES):
    """Path `runtime`: the port's own task/actor runtime on one card.
    `sequential` is run_pd's (prompt, colocated ids) list. (a) init()
    counts the cards as the "GPU" resource; a plain task's worker has none
    of torch, jax or ray_tpu loaded, and a num_gpus=0 task sees no card;
    (b) a num_gpus=1 task returns a bf16 tensor of `trip_bytes` drawn on
    its card: it lands on a card here, bit-equal to the same draw made
    here; (c) a num_gpus=1 actor of EngineReplica "llm" builds the slice's
    LLMServer and, after a warm-up, answers the sequential prompts one
    .remote()/get each with ids equal to
    the colocated server's, its own launch counters reset just before and
    read just after (B1 once a layer a fresh first chunk, B4 once a layer a
    decode step, no backward kernel), its CUDA_VISIBLE_DEVICES equal to
    get_gpu_ids() and one card seen; (d) a bf16 tensor of `trip_bytes` goes
    from here to the actor: it lands on the actor's card, bit-equal to the
    same draw made there; (e) a second num_gpus=1 actor stays pending
    (wait with a timeout) until the first is killed, then starts and is
    bound to the freed card; (f) a CPU tensor of `put_bytes` through
    put -> get, timed, equal after a write to the first get's copy. The
    session is the caller's (main() opens one for run_pd, this path and
    run_serve_app), or one opened here: then every worker has exited after
    shutdown(). Returns the readings; raises on a failed check."""
    import torch
    import ray_tpu_torch as rt

    cuda = device == "cuda"
    tag = "runtime"
    out = {}
    own = not rt.is_initialized()
    try:
        out["init_s"] = open_session(device) if own else None
        res = rt.cluster_resources()
        n_cards = torch.cuda.device_count() if cuda else 1
        modules = rt.get(rt.remote(plain_task_modules).remote())
        cpu_view = rt.get(rt.remote(num_gpus=0)(cpu_task_binding).remote())
        checks = {
            f"init() counts the cards as the GPU resource ({res.get('GPU')} == {n_cards})":
                res.get("GPU") == n_cards,
            f"a plain task's worker loaded none of torch, jax, ray_tpu ({modules})":
                modules == [],
            f"a num_gpus=0 task sees no card ({cpu_view})":
                cpu_view == dict(cuda_visible_devices="", device_count=0),
        }

        # (b) a CUDA tensor from a GPU task to the driver
        task = rt.remote(num_gpus=1)(draw_on_assigned_card)
        rt.get(task.remote(1 << 20, 5, device))          # the worker's start and CUDA's
        t1 = time.perf_counter()
        got = rt.get(task.remote(trip_bytes, 7, device))
        if cuda:
            torch.cuda.synchronize()
        out["task_to_driver_ms"] = (time.perf_counter() - t1) * 1e3
        checks[f"a {trip_bytes >> 20} MiB bf16 tensor from a GPU task lands on "
               f"{got.device}, bit-equal to the same draw here"] = (
            got.device.type == ("cuda" if cuda else "cpu") and got.dtype == torch.bfloat16
            and got.numel() * 2 == trip_bytes and torch_equal_draw(got, 7))
        del got

        # (c) the slice's server in a GPU actor
        t1 = time.perf_counter()
        first = rt.remote(num_gpus=1)(engine_class()).remote("llm", serving_config(preset, device))
        binding = rt.get(first.binding.remote())
        out["serve_actor_start_s"] = time.perf_counter() - t1
        rt.get(first.generate.remote(list(range(1, 50)), 8))   # warm-up, as run_pd's
        prompts = [p for p, _ in sequential]
        before = rt.get(first.stats.remote())
        rt.get(first.reset_launch_counts.remote())
        t1 = time.perf_counter()
        ids = [rt.get(first.generate.remote(p, max_tokens))["tokens"] for p in prompts]
        out["sequential_s"] = time.perf_counter() - t1
        launches = rt.get(first.launch_counts.remote())
        after = rt.get(first.stats.remote())
        equal = [a == w for a, (_, w) in zip(ids, sequential)]
        _, _, _, steps = decode_delta(after, before)
        fresh = after["prefill"]["chunk_local"] - before["prefill"]["chunk_local"]
        plan = rt.get(first.plan.remote())
        checks[f"ids through .remote()/get == the colocated server's for all "
               f"{len(sequential)} sequential requests"] = all(equal) and len(ids) == len(prompts)
        if cuda:
            checks[f"the actor's CUDA_VISIBLE_DEVICES {binding['cuda_visible_devices']!r} == "
                   f"get_gpu_ids() {binding['gpu_ids']}, one card seen"] = (
                binding["cuda_visible_devices"] == ",".join(map(str, binding["gpu_ids"]))
                and binding["device_count"] == 1)

        # (d) a CUDA tensor from the driver to the actor
        sent = seeded_draw(trip_bytes, 11, torch.device("cuda", torch.cuda.current_device())
                           if cuda else "cpu")
        t1 = time.perf_counter()
        landed = rt.get(first.check_tensor.remote(sent, 11))
        out["driver_to_actor_ms"] = (time.perf_counter() - t1) * 1e3
        checks[f"a {trip_bytes >> 20} MiB bf16 tensor from here lands on the actor's "
               f"{landed['device']}, bit-equal to the same draw there"] = (
            landed["equal"] and landed["device"].startswith("cuda" if cuda else "cpu"))
        del sent

        # (e) a second GPU actor waits for the card
        second = rt.remote(num_gpus=1)(Pinger).remote()
        ref = second.binding.remote()
        ready, _ = rt.wait([ref], timeout=5)
        pending = not ready and rt.available_resources().get("GPU", 0) == 0
        rt.kill(first)
        t1 = time.perf_counter()
        second_binding = rt.get(ref, timeout=300)
        out["actor_start_after_kill_s"] = time.perf_counter() - t1
        checks["a second num_gpus=1 actor stays pending until the first is killed"] = pending
        checks[f"then it starts, bound to the freed card {second_binding['gpu_ids']}"] = (
            second_binding["gpu_ids"] == binding["gpu_ids"])
        rt.kill(second)                  # the card is the next path's

        # (f) a CPU tensor through put -> get
        big = torch.arange(put_bytes // 4, dtype=torch.int32)
        t1 = time.perf_counter()
        ref = rt.put(big)
        out["put_ms"] = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        back = rt.get(ref)
        out["get_ms"] = (time.perf_counter() - t1) * 1e3
        back[0] = -1
        again = rt.get(ref)
        checks[f"a {put_bytes >> 20} MiB CPU tensor through put -> get, equal; a write "
               f"to one get leaves the next unchanged"] = (
            torch.equal(again, big) and back[0].item() == -1)
        out["put_gb_s"] = put_bytes / out["put_ms"] / 1e6
        out["get_gb_s"] = put_bytes / out["get_ms"] / 1e6
        del big, back, again, ref
    finally:
        if own:
            workers, left = stop_runtime(rt)
    if own:
        checks[f"every worker exited after shutdown() ({workers} workers)"] = not left
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}")
    launch_checks(tag, launches, plan["n_layers"], fresh, steps, plan["n_split"])
    out.update(resources=res, launches=launches, binding=binding,
               second_binding=second_binding, sequential_requests=len(ids),
               ids_equal=all(equal), fresh_first_chunks=fresh, decode_steps=steps)
    log(f"[{tag}] " + (f"init {out['init_s']:.2f} s" if own else "the caller's session")
        + f"; the serve actor up in "
        f"{out['serve_actor_start_s']:.1f} s ({preset} built in it), a Pinger actor "
        f"{out['actor_start_after_kill_s']:.2f} s after the kill; {len(ids)} sequential "
        f"requests in {out['sequential_s']:.2f} s; {trip_bytes >> 20} MiB bf16 task -> "
        f"driver {out['task_to_driver_ms']:.1f} ms, driver -> actor "
        f"{out['driver_to_actor_ms']:.1f} ms; {put_bytes >> 20} MiB put "
        f"{out['put_ms']:.1f} ms ({out['put_gb_s']:.2f} GB/s), get {out['get_ms']:.1f} ms "
        f"({out['get_gb_s']:.2f} GB/s); launches in the actor {launches}"
        + (f" ({smi_line()})" if cuda else ""))
    return out


# -------------------------------------------------------------------- cluster
CLUSTER_NODE_RESOURCE = "gpu_node"      # a node-only resource of the provider's nodes


def seeded_state(config):
    """The state_dict LLMServer(config) draws from its seed (no mesh),
    made without building a server."""
    import torch
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    overrides = dict(max_seq_len=config.max_seq_len,
                     param_dtype=getattr(torch, config.param_dtype))
    if config.dtype is not None:
        overrides["dtype"] = getattr(torch, config.dtype)
    model = Llama(getattr(LlamaConfig, config.preset)(**overrides), device=config.device)
    init_params(model, torch.Generator(device=config.device).manual_seed(config.seed))
    return model.state_dict()


def state_bytes(sd):
    return sum(t.numel() * t.element_size() for t in sd.values())


def process_start_time():
    """When this process started, on time.time()'s clock (from /proc, to
    the clock tick)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")


def provider_cards(n, device):
    """The cards a provider binds its nodes to: this process's first n on
    the card, n card names without one."""
    from ray_tpu_torch.autoscaler.node_provider import visible_cards
    return visible_cards()[:n] if device == "cuda" else [str(i) for i in range(n)]


def wait_until(pred, timeout, what):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def replica_wave(actor, sequential, max_tokens, timeout=600):
    """The sequential prompts through a replica actor (warmed up), one
    .remote()/get each, its launch counters reset just before and read
    just after: (ids, launches, fresh first chunks, decode steps, plan)."""
    import ray_tpu_torch as rt
    before = rt.get(actor.stats.remote(), timeout=timeout)
    rt.get(actor.reset_launch_counts.remote(), timeout=timeout)
    ids = [rt.get(actor.generate.remote(p, max_tokens), timeout=timeout)["tokens"]
           for p, _ in sequential]
    launches = rt.get(actor.launch_counts.remote(), timeout=timeout)
    after = rt.get(actor.stats.remote(), timeout=timeout)
    _, _, _, steps = decode_delta(after, before)
    fresh = after["prefill"]["chunk_local"] - before["prefill"]["chunk_local"]
    return ids, launches, fresh, steps, rt.get(actor.plan.remote(), timeout=timeout)


def run_cluster(sequential, device="cuda", preset="llama_1b", max_tokens=16):
    """Path `cluster`: the port's runtime across nodes on one card. This
    process is a cluster head owning no card (rt.init(num_gpus=0,
    cluster_port=0)) in a session of its own; a SubprocessNodeProvider
    (gpus_per_node=1, bound to this process's card 0) installed with
    sdk.set_node_provider launches one node agent for
    sdk.request_resources(bundles=[{"GPU": 1}]). (a) cluster_resources()
    counts "GPU" 0 before the node registers and 1 after; a num_gpus=1
    actor lands on the node (its parent pid the agent's) bound to the
    card whose UUID is this process's card 0. (b) The slice's llama_1b
    weights (seeded bf16, drawn on the card here) are put at the head and
    passed as the creation argument of a num_gpus=1 EngineReplica "llm"
    on the node: the node takes them in with the creation and then starts
    the replica's process, so the seconds from create() to that process's
    start are their trip (bytes, seconds and GB/s logged beside the
    transfer deadline). Built from them (its weights' digest equal to
    theirs), it answers `sequential` (run_pd's prompts and colocated ids)
    one .remote()/get each with the colocated server's ids, B1 and B4
    counted in its process as path `runtime`'s are and 0 here. (c) The
    node agent's process group is SIGKILLed: nodes() drops to 1 within
    the heartbeat limit, the next call on the replica raises
    ActorDiedError, the head's reconciler launches a replacement node
    bound to the same card, and a new replica there, drawing the same
    weights from the seed on its card (its digest equal), answers with the
    same ids (its counts checked as the first's); the seconds from the
    kill to its first answer are logged. Every
    worker and agent is gone after shutdown. Returns the readings; raises
    on a failed check."""
    import signal

    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.cluster import node_death_timeout_s
    from ray_tpu_torch._private.node_agent import transfer_deadline_s
    from ray_tpu_torch.autoscaler import SubprocessNodeProvider, sdk
    from ray_tpu_torch.exceptions import ActorDiedError

    cuda = device == "cuda"
    tag = "cluster"
    out, checks = {}, {}
    t_path = time.perf_counter()
    reset_launch_counts()
    rt.init(num_cpus=2, num_gpus=0, cluster_port=0)
    provider = SubprocessNodeProvider(cpus_per_node=2.0, gpus_per_node=1,
                                      cards=provider_cards(1, device),
                                      extra_resources={CLUSTER_NODE_RESOURCE: 1})
    agents = []
    try:
        # (a) registration and a card-bound actor on the node
        gpus_before = rt.cluster_resources().get("GPU", 0.0)
        sdk.set_node_provider(provider, max_nodes=1)
        launched = sdk.request_resources(bundles=[{"GPU": 1}])["launched_nodes"]
        handle = launched[0] if launched else None
        agents.append(provider.pid_of(handle) if handle else None)
        out["register_s"] = wait_until(lambda: rt.cluster_resources().get("GPU", 0) == 1, 60,
                                       "the GPU node's registration")
        pinger = rt.remote(num_gpus=1)(Pinger).remote()
        first_binding = rt.get(pinger.binding.remote(), timeout=300)
        rt.kill(pinger)
        want_uuid = str(torch.cuda.get_device_properties(0).uuid) if cuda else None
        checks[f"cluster_resources()['GPU'] {gpus_before} before the node, 1 after; one node "
               f"launched by request_resources ({launched})"] = (
            gpus_before == 0 and len(launched) == 1)
        checks[f"a num_gpus=1 actor lands on the node (parent pid {first_binding['ppid']} == "
               f"the agent's {agents[0]}), card {provider.cards_of(handle)}"] = (
            first_binding["ppid"] == agents[0] and first_binding["gpu_ids"] == [0])
        if cuda:
            checks[f"its card's UUID == this process's card 0 ({want_uuid})"] = (
                first_binding.get("uuids") == [want_uuid])

        # (b) the weights across the data plane, then a replica on the node
        config = serving_config(preset, device)
        sd = seeded_state(config)
        want_digest = state_digest(sd)
        nbytes = state_bytes(sd)
        t1 = time.perf_counter()
        sd_ref = rt.put(sd)
        out["put_s"] = time.perf_counter() - t1
        del sd

        def replica_on_node(name, params=None):
            t1, t_create = time.perf_counter(), time.time()
            actor = rt.remote(num_gpus=1)(engine_class()).remote("llm", config, params=params)
            rt.get(actor.generate.remote(list(range(1, 50)), 8), timeout=600)   # warm-up
            t_first = time.perf_counter()
            if params is not None:
                trip = rt.get(actor.started.remote(), timeout=600) - t_create
                checks["the replica's process started after its creation was sent"] = trip > 0
                out["weights"] = dict(bytes=nbytes, seconds=trip,
                                      gb_s=nbytes / max(trip, 1e-3) / 1e9,
                                      deadline_s=transfer_deadline_s())
            binding = rt.get(actor.binding.remote(), timeout=600)
            digest = rt.get(actor.digest.remote(), timeout=600)
            ids, launches, fresh, steps, plan = replica_wave(actor, sequential, max_tokens)
            checks[f"{name}: on the node (parent pid {binding['ppid']}), its weights' digest == "
                   f"the head's ({'shipped' if params is not None else 'drawn from the seed'})"
                   ] = binding["ppid"] == agents[-1] and digest == want_digest
            checks[f"{name}: ids == the colocated server's for all {len(sequential)} "
                   f"sequential requests"] = ids == [w for _, w in sequential]
            if cuda:
                checks[f"{name}: bound to the card of UUID {want_uuid}"] = (
                    binding.get("uuids") == [want_uuid])
            launch_checks(f"{tag} {name}", launches, plan["n_layers"], fresh, steps,
                          plan["n_split"])
            return actor, dict(first_answer_s=t_first - t1, t_first=t_first, binding=binding,
                               launches=launches, fresh_first_chunks=fresh, decode_steps=steps)

        replica, out["replica"] = replica_on_node("replica", sd_ref)

        # (c) node death and replacement
        t_kill = time.perf_counter()
        os.killpg(agents[0], signal.SIGKILL)
        out["death_seen_s"] = wait_until(lambda: len(rt.nodes()) == 1,
                                         node_death_timeout_s() + 5, "the node's death")
        try:
            rt.get(replica.stats.remote(), timeout=60)
            died = False
        except ActorDiedError:
            died = True
        checks[f"nodes() drops to 1 within the heartbeat limit ({out['death_seen_s']:.2f} s <= "
               f"{node_death_timeout_s():g} s)"] = out["death_seen_s"] <= node_death_timeout_s()
        checks["the next call on the dead node's replica raises ActorDiedError"] = died
        wait_until(lambda: [h for h in provider.non_terminated_nodes() if h != handle], 30,
                   "the reconciler's replacement launch")
        new = [h for h in provider.non_terminated_nodes() if h != handle][0]
        agents.append(provider.pid_of(new))
        wait_until(lambda: rt.cluster_resources().get("GPU", 0) == 1, 60,
                   "the replacement's registration")
        out["kill_to_registered_s"] = time.perf_counter() - t_kill
        checks[f"the replacement node is bound to the dead node's card "
               f"({provider.cards_of(new)})"] = provider.cards_of(new) == provider_cards(1, device)
        _, out["replacement"] = replica_on_node("replacement replica")   # weights from the seed
        out["kill_to_first_answer_s"] = out["replacement"]["t_first"] - t_kill
        out["launches_here"] = launch_counts()
        checks["no kernel launched here"] = not any(out["launches_here"].values())
        out["reconciler"] = [dict(action=e["action"], handle=e["handle"])
                             for e in rt.api._runtime.controller.reconciler.events]
    finally:
        provider.shutdown()
        workers, left = stop_runtime(rt)
    checks[f"every worker exited after shutdown() ({workers} workers)"] = not left
    out["seconds"] = time.perf_counter() - t_path
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
    w = out.get("weights", {})
    log(f"[{tag}] node registered {out.get('register_s', 0):.2f} s after the request; "
        f"weights {w.get('bytes', 0)} bytes head -> the node (create() to the replica's process) in {w.get('seconds', 0):.2f} s "
        f"({w.get('gb_s', 0):.3f} GB/s; the transfer deadline is {w.get('deadline_s')} s); "
        f"replica's first answer {out.get('replica', {}).get('first_answer_s', 0):.1f} s "
        f"after its creation; death seen "
        f"{out.get('death_seen_s', 0):.2f} s after the kill, the replacement registered at "
        f"{out.get('kill_to_registered_s', 0):.1f} s, kill -> first answer on the "
        f"replacement {out.get('kill_to_first_answer_s', 0):.1f} s; path {out['seconds']:.1f} s"
        + (f" ({smi_line()})" if cuda else ""))
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}")
    out["launches"] = {k: out["replica"]["launches"][k] + out["replacement"]["launches"][k]
                       for k in out["replica"]["launches"]}
    return out



# ------------------------------------------------------------------ serve_app
SERVE_APP = "serve_app"     # the OpenAI app's serve app name
SERVE_MODEL = "llama_1b"    # the model id it serves


def http_call(port, method, path, body=None, timeout=600):
    """One request over http.client: (status, content type, bytes, seconds)."""
    import http.client
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data, time.perf_counter() - t0


def http_stream(port, body, timeout=600):
    """A streamed completion read event by event: (status, content type,
    the SSE data payloads, seconds to the first `data:` event, seconds)."""
    import http.client
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    events, first = [], None
    while True:
        line = resp.readline()
        if not line:
            break
        if line.startswith(b"data: "):
            if first is None:
                first = time.perf_counter() - t0
            events.append(line[6:].strip().decode())
    conn.close()
    return resp.status, resp.getheader("Content-Type"), events, first, time.perf_counter() - t0


def completion_checks(answer, record, prompt, tok, max_tokens):
    """An OpenAI completion (unary: the JSON; streamed: its SSE payloads)
    against the engine's record of the same request: the OpenAI shape, the
    text ByteTokenizer's decode of the ids, usage's counts. Returns a list
    of what failed."""
    bad = []
    if isinstance(answer, list):            # streamed
        if not answer or answer[-1] != "[DONE]":
            return ["no [DONE] event"]
        chunks = [json.loads(e) for e in answer[:-1]]
        if not chunks or any(c["object"] != "text_completion" or c["model"] != SERVE_MODEL
                             for c in chunks):
            bad.append("chunk shape")
        text = "".join(c["choices"][0]["text"] for c in chunks)
        finish = chunks[-1]["choices"][0]["finish_reason"] if chunks else None
    else:
        if answer.get("object") != "text_completion" or answer.get("model") != SERVE_MODEL \
                or not str(answer.get("id", "")).startswith("cmpl-"):
            bad.append("completion shape")
        text = answer["choices"][0]["text"]
        finish = answer["choices"][0]["finish_reason"]
        usage = answer["usage"]
        if usage != dict(prompt_tokens=len(prompt), completion_tokens=len(record["tokens"]),
                         total_tokens=len(prompt) + len(record["tokens"])):
            bad.append(f"usage {usage}")
    if text != tok.decode(record["tokens"]):
        bad.append("text != ByteTokenizer.decode(ids)")
    if finish not in ("stop", "length") or (finish == "length") != (
            len(record["tokens"]) == max_tokens):
        bad.append(f"finish_reason {finish}")
    return bad


def run_serve_app(sequential, device="cuda", preset="llama_1b", max_tokens=16):
    """Path `serve_app`: Serve's deployment layer on one card. The OpenAI
    app `serve.deployment(OpenAIIngress).bind({"llama_1b": llm})`, where
    `llm` is `EngineReplica` "llm" (the slice's llama_1b server,
    `serving_config`, seed 0) as a num_gpus=1 deployment and the ingress a
    CPU replica that claims no card, run with serve.run(route_prefix="/")
    behind serve.start's HTTP proxy on an ephemeral port. `sequential` is
    run_pd's (prompt, colocated ids) list. After a warm-up as the
    colocated server's, the replica's and this process's launch counters
    reset: (1) the prompts through serve.get_deployment_handle(...) ->
    generate.remote(ids), ids equal to the colocated server's request by
    request; (2) the prompts as POST /v1/completions over http.client one
    at a time, then (3) as one concurrent wave, then (4) one `stream: true`
    request alone and a concurrent wave of them: every answer 200 with the
    OpenAI shape, its text ByteTokenizer's decode of the ids the engine
    produced for it (its record in the replica) and usage's counts those
    ids'; B1 and B4 counted in the replica's process (launch_checks) and
    nothing in this one; the replica's binding the one card. Logged: the
    replica's start (deploy to its first answer), the time to the first
    SSE event against the engine's TTFT for the same requests, the proxy +
    ingress + handle overhead a request (HTTP seconds less the engine's
    own), decode tokens/s. The session is the caller's, or one opened and
    shut down here. Returns the readings; raises on a failed check."""
    import concurrent.futures
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.openai_api import ByteTokenizer, OpenAIIngress

    cuda = device == "cuda"
    tag = "serve_app"
    tok = ByteTokenizer()
    prompts = [p for p, _ in sequential]
    own = not rt.is_initialized()
    if own:
        open_session(device)
    completion = lambda p: {"model": SERVE_MODEL, "prompt": [p], "max_tokens": max_tokens}
    try:
        port = serve.start(http_options={"port": 0})
        t0 = time.perf_counter()
        llm = engine_deployment("llm").bind("llm", serving_config(preset, device))
        serve.run(serve.deployment(OpenAIIngress, name="openai").bind({SERVE_MODEL: llm}),
                  name=SERVE_APP, route_prefix="/")
        h = serve.get_deployment_handle("llm", SERVE_APP)
        binding = h.binding.remote().result(timeout_s=600)
        start_s = time.perf_counter() - t0
        models = http_call(port, "GET", "/v1/models")
        ingress_s = time.perf_counter() - t0
        plan = h.plan.remote().result(timeout_s=60)
        h.generate.remote(list(range(1, 50)), max_tokens=8).result(timeout_s=600)  # warm-up
        warm = http_call(port, "POST", "/v1/completions",     # shorter than a page: not cached
                         {"model": SERVE_MODEL, "prompt": [[1, 2, 3]], "max_tokens": 2})
        before = h.stats.remote().result(timeout_s=60)
        h.served.remote(True).result(timeout_s=60)
        h.reset_launch_counts.remote().result(timeout_s=60)
        reset_launch_counts()

        t1 = time.perf_counter()
        ids = [h.generate.remote(p, max_tokens=max_tokens).result(timeout_s=600)["tokens"]
               for p in prompts]
        handle_s = time.perf_counter() - t1
        seq_http = [http_call(port, "POST", "/v1/completions", completion(p)) for p in prompts]
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
            wave = list(ex.map(lambda p: http_call(port, "POST", "/v1/completions",
                                                   completion(p)), prompts))
        one = http_stream(port, dict(completion(prompts[0]), stream=True))
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
            streams = list(ex.map(lambda p: http_stream(port, dict(completion(p), stream=True)),
                                  prompts))
        launches = h.launch_counts.remote().result(timeout_s=60)
        here = launch_counts()
        after = h.stats.remote().result(timeout_s=60)
        served = h.served.remote().result(timeout_s=60)
    finally:
        serve.delete(SERVE_APP)
        if own:
            close_session(tag)

    n = len(prompts)
    by_key = lambda recs: {r["key"]: r for r in recs}
    seq_rec, wave_rec = served[n:2 * n], by_key(served[2 * n:3 * n])
    one_rec, stream_rec = served[3 * n], by_key(served[3 * n + 1:])
    keys = [prompt_key(p) for p in prompts]
    bad = {}
    for what, answers, recs in (("sequential", seq_http, seq_rec),
                                ("wave", wave, [wave_rec.get(k) for k in keys])):
        for i, (a, r) in enumerate(zip(answers, recs)):
            status, ctype, data, _ = a
            if status != 200 or ctype != "application/json" or r is None:
                bad[f"{what} {i}"] = [f"status {status} {ctype} {data[:200]!r}"]
                continue
            bad[f"{what} {i}"] = completion_checks(json.loads(data), r, prompts[i], tok, max_tokens)
    for what, answers, recs in (("stream alone", [one], [one_rec]),
                                ("stream wave", streams, [stream_rec.get(k) for k in keys])):
        for i, (a, r) in enumerate(zip(answers, recs)):
            status, ctype, events, _, _ = a
            if status != 200 or not (ctype or "").startswith("text/event-stream") or r is None:
                bad[f"{what} {i}"] = [f"status {status} {ctype}"]
                continue
            bad[f"{what} {i}"] = completion_checks(events, r, prompts[i], tok, max_tokens)
    bad = {k: v for k, v in bad.items() if v}
    tokens, _, decode_s, steps = decode_delta(after, before)
    fresh = after["prefill"]["chunk_local"] - before["prefill"]["chunk_local"]
    cut = lambda w: w[:w.index(tok.eos_id)] if tok.eos_id in w else w   # the app stops at eos
    same_as_handle = sum(r["tokens"] == cut(w) for r, w in zip(seq_rec, ids))
    checks = {
        f"ids through the handle == the colocated server's for all {n} sequential requests":
            [w for _, w in sequential] == ids,
        f"GET /v1/models answers 200 with [{SERVE_MODEL!r}]": models[0] == 200 and [
            m["id"] for m in json.loads(models[2])["data"]] == [SERVE_MODEL],
        f"every completion ({4 * n + 1} + the warm-up) 200 with the OpenAI shape, its text "
        f"ByteTokenizer's decode of its ids, usage their counts": not bad and warm[0] == 200,
        f"this process launched no kernel on the path ({here})": not any(here.values()),
        f"the engine served every request ({len(served)} records)": len(served) == 4 * n + 1,
    }
    if cuda:
        checks[f"the replica's CUDA_VISIBLE_DEVICES {binding['cuda_visible_devices']!r} == "
               f"get_gpu_ids() {binding['gpu_ids']}, one card seen"] = (
            binding["cuda_visible_devices"] == ",".join(map(str, binding["gpu_ids"]))
            and binding["device_count"] == 1)
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}; {bad}")
    launch_checks(tag, launches, plan["n_layers"], fresh, steps, plan["n_split"])
    first = [s[3] for s in streams] + [one[3]]
    engine_ttft = [stream_rec[k]["ttft_s"] for k in keys] + [one_rec["ttft_s"]]
    overhead = [a[3] - r["total_s"] for a, r in zip(seq_http, seq_rec)]
    pct = lambda xs, q: float(np.percentile(xs, q))
    out = dict(replica_start_s=start_s, ingress_up_s=ingress_s, binding=binding,
               launches=launches, launches_here=here, fresh_first_chunks=fresh,
               decode_steps=steps, decode_tokens=tokens, decode_s=decode_s,
               decode_tokens_per_s=tokens / decode_s if decode_s else None,
               sequential_requests=n, ids_equal=True, handle_s=handle_s,
               http_ids_equal_handle_ids=same_as_handle,
               http_sequential_s=[a[3] for a in seq_http],
               engine_total_s=[r["total_s"] for r in seq_rec],
               overhead_ms_p50=pct(overhead, 50) * 1e3, overhead_ms_mean=float(
                   np.mean(overhead)) * 1e3,
               first_event_p50_s=pct(first, 50), first_event_p99_s=pct(first, 99),
               first_event_alone_s=one[3], engine_ttft_p50_s=pct(engine_ttft, 50),
               engine_ttft_p99_s=pct(engine_ttft, 99), engine_ttft_alone_s=one_rec["ttft_s"],
               wave_s=max(a[3] for a in wave), stream_wave_s=max(s[4] for s in streams))
    log(f"[{tag}] the llama_1b replica answered {start_s:.2f} s after serve.run (the ingress "
        f"{ingress_s:.2f} s); {n} requests x {max_tokens} tokens through the handle "
        f"{handle_s:.2f} s, ids equal; over HTTP one at a time {sum(out['http_sequential_s']):.2f}"
        f" s, proxy + ingress + handle {out['overhead_ms_p50']:.1f} ms a request (p50; mean "
        f"{out['overhead_ms_mean']:.1f}) over the engine's own; the unary wave "
        f"{out['wave_s']:.2f} s; first SSE event p50 {out['first_event_p50_s'] * 1e3:.1f} ms, "
        f"p99 {out['first_event_p99_s'] * 1e3:.1f} ms (alone "
        f"{out['first_event_alone_s'] * 1e3:.1f}) against the engine's TTFT p50 "
        f"{out['engine_ttft_p50_s'] * 1e3:.1f} ms, p99 {out['engine_ttft_p99_s'] * 1e3:.1f} ms "
        f"(alone {out['engine_ttft_alone_s'] * 1e3:.1f}); decode "
        f"{out['decode_tokens_per_s'] or 0:.1f} tokens/s; the sequential HTTP requests' ids equal "
        f"the handle's, cut at the tokenizer's eos id, for {same_as_handle} of {n} (second "
        f"visits of each prompt, prefilled after radix hits); launches in the "
        f"replica {launches}" + (f" ({smi_line()})" if cuda else ""))
    return out


# ----------------------------------------------------------------------- jobs
JOB_ENV = "CHIP_SMOKE_JOB"       # the job's prompts and engine settings (JSON)
JOB_FREE_LIMIT_S = 60.0          # a stopped job's card is free again within this


def job_main(mode):
    """A submitted job's driver (path `jobs`): attaches to the session
    (init(address="auto")), starts one unnamed num_gpus=1 EngineReplica
    "llm" and serves the prompts of JOB_ENV through an ActorPool of it
    (map, in order) after run_runtime's warm-up, its launch counters reset
    just before and read just after. Prints one JSON line: the ids, the
    actor's launches, fresh first chunks, decode steps and plan, its card
    binding, and this process's own launches and CUDA_VISIBLE_DEVICES.
    mode "serve" returns then; mode "loop" (the job that is stopped) serves
    the prompts again and again."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import ActorPool

    job = json.loads(os.environ[JOB_ENV])
    rt.init(address="auto")
    reset_launch_counts()
    actor = rt.remote(num_gpus=1)(engine_class()).remote(
        "llm", serving_config(job["preset"], job["device"]))
    rt.get(actor.generate.remote(list(range(1, 50)), 8), timeout=600)   # warm-up
    pool = ActorPool([actor])
    serve = lambda a, p: a.generate.remote(p, job["max_tokens"])
    before = rt.get(actor.stats.remote())
    rt.get(actor.reset_launch_counts.remote())
    ids = [out["tokens"] for out in pool.map(serve, job["prompts"])]
    after = rt.get(actor.stats.remote())
    _, _, _, steps = decode_delta(after, before)
    print(json.dumps(dict(
        mode=mode, ids=ids, launches=rt.get(actor.launch_counts.remote()), decode_steps=steps,
        fresh=after["prefill"]["chunk_local"] - before["prefill"]["chunk_local"],
        plan=rt.get(actor.plan.remote()), binding=rt.get(actor.binding.remote()),
        actor_id=actor._actor_id, driver_launches=launch_counts(),
        driver_cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"))), flush=True)
    while mode == "loop":
        for _ in pool.map(serve, job["prompts"]):
            pass


def job_line(logs):
    """The JSON line a job's driver printed, or None."""
    rows = [ln for ln in logs.splitlines() if ln.startswith('{"mode"')]
    return json.loads(rows[-1]) if rows else None


def wait_job_line(client, jid, timeout, terminal=False):
    """Polls the job's logs (GET /api/jobs/<id>/logs) until its JSON line
    shows (and, with `terminal`, the job has ended); returns (line, logs)."""
    deadline = time.perf_counter() + timeout
    while True:
        logs = client.get_job_logs(jid)
        line = job_line(logs)
        done = client.get_job_status(jid).is_terminal()
        if (line is not None and (done or not terminal)) or done \
                or time.perf_counter() > deadline:
            return line, logs
        time.sleep(0.2)


def run_jobs(sequential, runtime, device="cuda", preset="llama_1b", max_tokens=16):
    """Path `jobs`: job submission, the dashboard, the CLI and util's
    ActorPool and state on the port's runtime, in the caller's session.
    `sequential` is run_pd's (prompt, colocated ids) list and `runtime`
    run_runtime's readings. (a) The dashboard on port 0:
    /api/cluster_status reports "GPU" total 1; `python -m ray_tpu_torch
    topology` names the card (torch.cuda.get_device_name(0)) and counts
    one; `python -m ray_tpu_torch status`, attached through RTPT_ADDRESS,
    lists the GPU. (b) Job A through JobSubmissionClient over HTTP, its
    entrypoint `python3 -c "import chip_smoke; chip_smoke.job_main('serve')"`
    with working_dir the repo root: SUCCEEDED, its line (read through
    /api/jobs/<id>/logs) holds ids equal to the colocated server's, the
    actor's launches equal the `runtime` path's actor's for the same
    prompts (launch_checks), the job's actor bound to the card, and no
    launch in this process or the job's driver, which sees no card. (c)
    Job B, the same entrypoint serving in a loop, stopped with POST
    /api/jobs/<id>/stop once its line shows: STOPPED, "GPU" available
    back to its total within JOB_FREE_LIMIT_S, then a new num_gpus=1 actor
    starts on the freed card, and util.state lists the job's actor dead.
    Returns the readings; raises on a failed check."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.util import state

    cuda = device == "cuda"
    tag = "jobs"
    repo = str(Path(__file__).resolve().parent)
    n_cards = torch.cuda.device_count() if cuda else 1
    out = {}
    checks = {}

    # (a) the dashboard and the CLI
    t0 = time.perf_counter()
    _actor, port = start_dashboard(port=0)
    base = f"http://127.0.0.1:{port}"
    out["dashboard_up_s"] = time.perf_counter() - t0
    status = json.loads(http_call(port, "GET", "/api/cluster_status")[2])
    checks[f"/api/cluster_status reports GPU total {status['total_resources'].get('GPU')} == "
           f"{n_cards}"] = status["total_resources"].get("GPU") == n_cards
    cli = lambda *a: subprocess.run([sys.executable, "-m", "ray_tpu_torch", *a], cwd=repo,
                                    capture_output=True, text=True, timeout=120)
    topo = cli("topology")
    topology = json.loads(topo.stdout) if topo.returncode == 0 else {"error": topo.stderr[-500:]}
    want_name = torch.cuda.get_device_name(0) if cuda else None
    checks[f"`python -m ray_tpu_torch topology` names the card ({topology.get('device_name')!r})"
           f" and counts {topology.get('num_chips')}"] = (
        topology.get("device_name") == want_name
        and topology.get("num_chips") == torch.cuda.device_count())
    st = cli("status", "--once")
    gpu_row = re.search(r"^  GPU\s+(\S+) / (\S+) free$", st.stdout, re.M)
    checks[f"`python -m ray_tpu_torch status` (RTPT_ADDRESS) lists the GPU "
           f"({gpu_row.group(0).strip() if gpu_row else st.stderr[-300:]!r})"] = (
        st.returncode == 0 and gpu_row is not None and float(gpu_row.group(2)) == n_cards)
    out.update(topology=topology, status_gpu_row=gpu_row.group(0).strip() if gpu_row else None)

    # (b) job A over HTTP
    client = JobSubmissionClient(base)
    entry = lambda mode: f"{sys.executable} -c \"import chip_smoke; chip_smoke.job_main({mode!r})\""
    env = {JOB_ENV: json.dumps(dict(prompts=[p for p, _ in sequential], preset=preset,
                                    device=device, max_tokens=max_tokens))}
    runtime_env = {"working_dir": repo, "env_vars": env}
    reset_launch_counts()
    t0 = time.perf_counter()
    jid = client.submit_job(entrypoint=entry("serve"), runtime_env=runtime_env)
    line, logs = wait_job_line(client, jid, 900, terminal=True)
    out["job_a_s"] = time.perf_counter() - t0
    status_a = client.get_job_status(jid).value
    here = launch_counts()
    if line is None:
        raise AssertionError(f"{tag}: job A ({status_a}) printed no line: {logs[-3000:]}")
    launches = line["launches"]
    binding = line["binding"]
    checks[f"job A {status_a} == SUCCEEDED"] = status_a == "SUCCEEDED"
    checks[f"job A's ids through an ActorPool == the colocated server's for all "
           f"{len(sequential)} sequential requests"] = line["ids"] == [w for _, w in sequential]
    checks[f"job A's actor launched what the runtime path's actor did "
           f"({launches} == {runtime['launches']})"] = launches == runtime["launches"]
    checks[f"no launch in this process ({here}) or the job's driver "
           f"({line['driver_launches']})"] = not any(here.values()) and not any(
        line["driver_launches"].values())
    checks[f"the job's driver sees no card (CUDA_VISIBLE_DEVICES "
           f"{line['driver_cuda_visible_devices']!r})"] = line["driver_cuda_visible_devices"] == ""
    if cuda:
        checks[f"job A's actor bound to one card: CUDA_VISIBLE_DEVICES "
               f"{binding['cuda_visible_devices']!r} == get_gpu_ids() {binding['gpu_ids']}"] = (
            binding["cuda_visible_devices"] == ",".join(map(str, binding["gpu_ids"]))
            and binding["device_count"] == 1)

    # (c) job B, stopped while it holds the card
    total = rt.cluster_resources()["GPU"]
    t0 = time.perf_counter()
    jid_b = client.submit_job(entrypoint=entry("loop"), runtime_env=runtime_env)
    line_b, logs_b = wait_job_line(client, jid_b, 900)
    out["job_b_first_answer_s"] = time.perf_counter() - t0
    if line_b is None:
        raise AssertionError(f"{tag}: job B printed no line: {logs_b[-3000:]}")
    held = rt.available_resources().get("GPU", 0)
    t0 = time.perf_counter()
    stopped = client.stop_job(jid_b)
    status_b = client.get_job_status(jid_b).value
    while (rt.available_resources().get("GPU", 0) < total
           and time.perf_counter() - t0 < JOB_FREE_LIMIT_S):
        time.sleep(0.05)
    out["gpu_free_after_stop_s"] = freed_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    pinger = rt.remote(num_gpus=1)(Pinger).remote()
    new_binding = rt.get(pinger.binding.remote(), timeout=300)
    out["new_actor_start_s"] = time.perf_counter() - t1
    rt.kill(pinger)
    dead = [a["state"] for a in state.list_actors(filters=[("actor_id", "=", line_b["actor_id"])])]
    checks[f"job B held the card while serving (GPU available {held})"] = held == 0
    checks[f"POST /api/jobs/<id>/stop stopped job B: {status_b} == STOPPED"] = (
        stopped and status_b == "STOPPED")
    checks[f"GPU available back to its total {total} {freed_s:.2f} s after the stop "
           f"(limit {JOB_FREE_LIMIT_S:.0f} s)"] = (
        rt.available_resources().get("GPU", 0) == total and freed_s < JOB_FREE_LIMIT_S)
    checks[f"then a new num_gpus=1 actor starts on the freed card {new_binding['gpu_ids']}"] = (
        new_binding["gpu_ids"] == binding["gpu_ids"])
    checks[f"util.state lists job B's actor as dead ({dead})"] = dead == ["DEAD"]
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}")
    launch_checks(tag, launches, line["plan"]["n_layers"], line["fresh"], line["decode_steps"],
                  line["plan"]["n_split"])
    out.update(launches=launches, binding=binding, new_binding=new_binding,
               sequential_requests=len(sequential), ids_equal=True,
               fresh_first_chunks=line["fresh"], decode_steps=line["decode_steps"],
               job_a_status=status_a, job_b_status=status_b)
    log(f"[{tag}] dashboard up in {out['dashboard_up_s']:.2f} s; job A (start, llama_1b "
        f"actor, warm-up, {len(sequential)} requests x {max_tokens} tokens) "
        f"{out['job_a_s']:.1f} s; job B's first answer {out['job_b_first_answer_s']:.1f} s after "
        f"submit, its card free {freed_s:.2f} s after the stop, a new actor up "
        f"{out['new_actor_start_s']:.2f} s later; launches in job A's actor {launches}"
        + (f" ({smi_line()})" if cuda else ""))
    return out


def logit_rows(model, prompt, ids, j, device):
    """The last row's f32 logits after prompt + ids[:j]."""
    import torch
    toks = torch.tensor([list(prompt) + list(ids[:j])], device=device)
    with torch.no_grad():
        return model(toks)[0][0, -1].float()


def run_radix_visits(sequential, device="cuda", preset="llama_1b", max_tokens=16):
    """Path `radix_visits`: why a prompt's second visit, prefilled after a
    radix hit, can give other greedy ids than its first (3 of 10 in bf16 on
    the card in `serve_app`, 0 of 10 in f32 on the CPU). The sequential
    prompts (run_pd's) go twice, one at a time, through an in-process
    server of `serve_app`'s settings with the radix prefix cache on, then
    through one with it off, then through one with the cache on in f32
    (its own seeded f32 weights). Where a bf16 second visit differs from
    the first,
    at the first position j that differs: the top-2 logit gap of the full
    forward over prompt + first[:j] in the server's bf16 (`near_tie`), the
    same in f32 on the same weights upcast, and the bf16 row's distance
    from the f32 row (the bf16 noise), each over the row's max |logit|.
    Held: the first visits equal the colocated server's ids; with the cache
    off the second visits equal the first; in f32 with the cache on they
    do too (the continuation path is exact where the arithmetic is); and
    every differing bf16 prompt is a near-tie: its bf16 gap under
    NEAR_TIE, or its f32 gap within twice the bf16 noise (the two
    candidates are inside bf16's rounding of the row). Otherwise the radix
    continuation is at fault, and this raises."""
    import gc

    import torch
    from ray_tpu_torch.models.llama import Llama
    from ray_tpu_torch.serve.llm import LLMServer

    prompts = [p for p, _ in sequential]
    visits, model = {}, None
    for name, kw in (("radix", {}), ("no_cache", dict(prefix_cache=False)),
                     ("radix_f32", dict(param_dtype="float32", dtype="float32"))):
        server = LLMServer(serving_config(preset, device, **kw))
        asyncio.run(server.generate(list(range(1, 50)), max_tokens=8))      # warm-up
        visits[name] = [[asyncio.run(server.generate(p, max_tokens=max_tokens))["tokens"]
                         for p in prompts] for _ in range(2)]
        if name == "radix":
            model = server.model
        del server
        gc.collect()
    first, second = visits["radix"]
    f32 = Llama(dataclasses.replace(model.cfg, dtype=torch.float32, param_dtype=torch.float32),
                device=device)
    f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    rows = []
    for i, (p, a, b) in enumerate(zip(prompts, first, second)):
        if a == b:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        gap, tie = near_tie(model, p, a, j, device)
        lo, hi = logit_rows(model, p, a, j, device), logit_rows(f32, p, a, j, device)
        top = hi.topk(2)
        gap32 = float((top.values[0] - top.values[1]) / hi.abs().max())
        noise = float((lo - hi).abs().max() / hi.abs().max())
        rows.append(dict(request=i, position=j, first=a[j] if j < len(a) else None,
                         second=b[j] if j < len(b) else None, gap_bf16=gap, near_tie=tie,
                         gap_f32=gap32, bf16_noise=noise, f32_top2=top.indices.tolist(),
                         within_noise=gap32 < 2 * noise))
    del f32, model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    off1, off2 = visits["no_cache"]
    f32_1, f32_2 = visits["radix_f32"]
    out = dict(prompts=len(prompts), max_tokens=max_tokens,
               differ_radix=len(rows), differ_no_cache=sum(x != y for x, y in zip(off1, off2)),
               differ_radix_f32=sum(x != y for x, y in zip(f32_1, f32_2)),
               first_equal_colocated=sum(a == w for a, (_, w) in zip(first, sequential)),
               no_cache_equal_first=sum(x == a for x, a in zip(off1, first)), rows=rows)
    checks = {
        f"first visits equal the colocated server's ids ({out['first_equal_colocated']} of "
        f"{len(prompts)})": out["first_equal_colocated"] == len(prompts),
        f"with the radix cache off, second visits equal first visits "
        f"({len(prompts) - out['differ_no_cache']} of {len(prompts)})":
            out["differ_no_cache"] == 0,
        f"in f32 with the radix cache on, second visits equal first visits "
        f"({len(prompts) - out['differ_radix_f32']} of {len(prompts)})":
            out["differ_radix_f32"] == 0,
        f"each of the {len(rows)} second visits that differ after a radix hit is a near-tie "
        f"(bf16 gap < {NEAR_TIE}, or f32 gap within twice the bf16 noise)":
            all(r["near_tie"] or r["within_noise"] for r in rows),
    }
    for r in rows:
        log(f"[radix_visits] request {r['request']} differs from position {r['position']} "
            f"({r['first']} -> {r['second']}): top-2 gap {r['gap_bf16']:.3e} of max |logit| in "
            f"bf16, {r['gap_f32']:.3e} in f32 (top-2 {r['f32_top2']}), the bf16 row "
            f"{r['bf16_noise']:.3e} from the f32 row")
    for what, ok in checks.items():
        log(f"[radix_visits] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"radix_visits checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}: {rows}")
    return out


# ------------------------------------------------------------------ tiered
TIER_FAMILIES, TIER_PREFIX, TIER_TAIL, TIER_NEW = 8, 1024, 16, 2


def tier_prompts(vocab, rounds=3):
    """8 families of a 1024-token prefix (16 pages); every visit adds a
    fresh 16-token tail. prompts[r][f] is family f's prompt in round r."""
    rng = np.random.default_rng(77)
    fams = [rng.integers(1, vocab, TIER_PREFIX).tolist() for _ in range(TIER_FAMILIES)]
    return fams, [[fam + rng.integers(1, vocab, TIER_TAIL).tolist() for fam in fams]
                  for _ in range(rounds)]


def tier_pages(server, prefix):
    """(k, v) of the resident radix pages of `prefix`, [L, Kh, 16, ps, D]."""
    import torch
    pids = [n.page for n in server.page_mgr._walk(prefix)]
    if len(pids) != TIER_PREFIX // server.config.page_size or None in pids:
        raise AssertionError(f"prefix pages not resident: {pids}")
    idx = torch.tensor(pids, device=server.cache.k_pages.device)
    return server.cache.k_pages[:, :, idx].clone(), server.cache.v_pages[:, :, idx].clone()


def tier_rounds(server, prompts, probe=None):
    """Visit every family round-robin, one request at a time; returns the
    ids of every visit, the TTFT of the rounds after the first, and the
    largest count of disk-resident stash objects seen. probe(r, f) runs
    after each visit."""
    ids, ttft, disk = [], [], 0
    for r, wave in enumerate(prompts):
        for f, p in enumerate(wave):
            out = asyncio.run(server.generate(p, max_tokens=TIER_NEW))
            ids.append(out["tokens"])
            if r:
                ttft.append(out["ttft_s"])
            stash = server.stats()["radix"].get("stash")
            disk = max(disk, stash["disk_objects"] if stash else 0)
            if probe is not None:
                probe(r, f)
    return ids, ttft, disk


def run_tiered(device="cuda", preset="llama_1b", stash_bytes=64 << 20):
    """Tiered KV at llama_1b width (the JAX bench's bench_tiered): 8
    families of 1024-token prefixes visited round-robin, one cold round and
    two measured rounds, each visit a fresh 16-token tail and 2 new tokens,
    on 2 slots and a pool of 32 usable pages (+ the null page), a quarter
    of the 128-page working set; the stash's shm budget is `stash_bytes`
    (64 MiB: 32 pages), so its disk rung is used too. Checks: family 0's 16
    K/V pages after their restore equal (torch.equal) their bytes before
    eviction; every id equals those of the same weights on a pool that
    never evicts (re-visits are resident hits); radix_counters() shows
    demoted and restored pages, the stash held disk objects, B1 ran only on
    the cold visits' first chunks and B4 once a layer per decode step.
    Reported without a claim: the measured rounds' TTFT p50 against the
    same rounds with RAY_TPU_SPILL_KV=0 (every re-visit prefills again),
    with the default 256 MiB budget (every demoted page stays in shm) and
    on the pool that never evicts, and spill_restore_ms."""
    import gc
    import torch
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.util import metrics as tm

    cuda = device == "cuda"
    kw = dict(max_batch_slots=2, num_pages=TIER_FAMILIES * TIER_PREFIX // 64 // 4 + 1)
    with environ(RAY_TPU_SPILL_STASH_BYTES=str(stash_bytes), RAY_TPU_SPILL_KV=None,
                 RAY_TPU_RADIX=None):
        tiered = LLMServer(serving_config(preset, device, **kw))
    params = tiered.model.state_dict()
    mc = tiered.model_cfg
    fams, prompts = tier_prompts(mc.vocab_size)
    snaps, restored = [], []

    def probe(r, f):
        if f == 0 and r < 2:   # family 0 cold, then after its first restore
            snaps.append(tier_pages(tiered, fams[0]))
            restored.append(tiered.page_mgr.restored_pages)

    r0, b0 = tm.radix_counters(), tiered.stats()
    reset_launch_counts()
    ids, ttft, disk = tier_rounds(tiered, prompts, probe)
    launches = launch_counts()
    r1, b1 = tm.radix_counters(), tiered.stats()
    radix = {k: r1[k] - r0[k] for k in r1 if k != "prefix_nodes"}
    tokens, syncs, decode_s, steps = decode_delta(b1, b0)
    fresh = b1["prefill"]["chunk_local"] - b0["prefill"]["chunk_local"]
    spill_ms = b1["slo"]["spill_restore_ms"]
    hist = {m["name"]: m for m in tm.collect()}.get("spill_restore_ms")
    spill_by_op = ({dict(k)["op"]: dict(count=n, mean_ms=hist["sum"][k] / n)
                    for k, n in hist["count"].items()} if hist else {})
    stash = b1["radix"]["stash"]
    n_split = n_split_of(tiered, device)
    (k0, v0), (k1, v1) = snaps
    bytes_equal = bool(torch.equal(k0, k1) and torch.equal(v0, v1))
    del tiered, snaps, k0, v0, k1, v1
    gc.collect()

    resident = LLMServer(serving_config(preset, device, max_batch_slots=2,
                                        num_pages=TIER_FAMILIES * 17 + 5), params=params)
    want, ttft_resident, _ = tier_rounds(resident, prompts)
    resident_evicted = resident.stats()["radix"]["evicted_pages"]
    del resident
    gc.collect()
    with environ(RAY_TPU_SPILL_KV="0"):
        thrash = LLMServer(serving_config(preset, device, **kw), params=params)
    ids_thrash, ttft_thrash, _ = tier_rounds(thrash, prompts)
    no_stash = thrash.stats()["radix"].get("stash") is None
    del thrash
    gc.collect()
    # the default budget (RAY_TPU_SPILL_STASH_BYTES unset: 256 MiB) holds the
    # whole working set in shm: the same rounds without the disk rung
    with environ(RAY_TPU_SPILL_STASH_BYTES=None, RAY_TPU_SPILL_KV=None, RAY_TPU_RADIX=None):
        shm_only = LLMServer(serving_config(preset, device, **kw), params=params)
    ids_shm, ttft_shm, disk_shm = tier_rounds(shm_only, prompts)
    del shm_only, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = {
        "family 0's 16 K/V pages restored byte for byte (torch.equal)": bytes_equal,
        f"family 0's first re-visit restored its 16 pages ({restored})":
            len(restored) == 2 and restored[1] - restored[0] >= TIER_PREFIX // 64,
        f"ids of all {len(ids)} visits equal a pool that never evicts": ids == want,
        "the never-evicting pool evicted nothing": resident_evicted == 0,
        f"radix_counters(): demoted {radix['demoted_pages']:.0f}, restored "
        f"{radix['restored_pages']:.0f} pages": radix["demoted_pages"] > 0
        and radix["restored_pages"] > 0,
        f"the stash used its disk rung (up to {disk} disk objects)": disk > 0,
        "spill_restore_ms observed": bool(spill_ms and spill_ms["count"] > 0),
        f"B1 only on the {TIER_FAMILIES} cold visits ({fresh} fresh first chunks)":
            fresh == TIER_FAMILIES,
        "RAY_TPU_SPILL_KV=0 builds no stash": no_stash,
        "the default stash budget kept every page in shm, ids equal":
            disk_shm == 0 and ids_shm == want,
    }
    for what, ok in checks.items():
        log(f"[tiered] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"tiered checks failed: radix {radix}, stash {stash}, "
                             f"restored {restored}, fresh {fresh}")
    launch_checks("tiered", launches, mc.n_layers, fresh, steps, n_split)
    p50 = lambda xs: float(np.median(xs))
    out = dict(families=TIER_FAMILIES, prefix_tokens=TIER_PREFIX, tail_tokens=TIER_TAIL,
               new_tokens=TIER_NEW, pool_pages=kw["num_pages"] - 1,
               stash_budget_bytes=stash_bytes, visits=len(ids),
               ttft_p50_s=p50(ttft), ttft_p50_spill_off_s=p50(ttft_thrash),
               ttft_p50_resident_s=p50(ttft_resident), ttft_p50_shm_only_s=p50(ttft_shm),
               ids_equal_spill_off=ids_thrash == want, radix=radix, stash=stash,
               disk_objects_max=disk, spill_restore_ms=spill_ms,
               spill_restore_ms_by_op=spill_by_op, launches=launches,
               fresh_first_chunks=fresh, decode_steps=steps, paged_n_split=n_split)
    log(f"[tiered] measured rounds' TTFT p50: restored from the stash "
        f"{out['ttft_p50_s'] * 1e3:.1f} ms, RAY_TPU_SPILL_KV=0 (prefill again) "
        f"{out['ttft_p50_spill_off_s'] * 1e3:.1f} ms, restored from shm only (default "
        f"budget) {out['ttft_p50_shm_only_s'] * 1e3:.1f} ms, resident hits "
        f"{out['ttft_p50_resident_s'] * 1e3:.1f} ms; spill_restore_ms {json.dumps(spill_ms)}, "
        f"by op {json.dumps(spill_by_op)}; "
        f"stash at the end {stash}; radix {radix}; SPILL_KV=0 ids equal "
        f"{out['ids_equal_spill_off']}; launches {launches}")
    return out


def profile_call(fn, device="cuda", ranges=()):
    """fn() under torch.profiler: wall time, the device's busy share of it
    (summed kernel time over wall time; the profiler's own cost is inside
    the wall time), the kernels that fill it, and for each named
    record_function range in `ranges` the device time of the kernels
    launched inside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device rows, less the ranges that annotate host calls on the device
    # timeline (such as Optimizer.step#AdamW.step), which would count twice
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    row = lambda e: dict(name=e.key[:90], calls=e.count,
                         device_ms=e.self_device_time_total / 1e3)
    # a CPU range's device_time_total sums the kernels of the ops inside it
    spans = {name: dict(calls=0, device_ms=0.0) for name in ranges}
    for e in prof.key_averages():
        if e.key in spans and e.device_type == DeviceType.CPU:
            spans[e.key]["calls"] += e.count
            spans[e.key]["device_ms"] += e.device_time_total / 1e3
    return dict(wall_s=wall, device_kernel_s=device_us / 1e6,
                nccl_device_s=sum(e.self_device_time_total for e in kernels
                                  if "nccl" in e.key.lower()) / 1e6,
                busy_share=(device_us / 1e6 / wall) if device_us else "not measured",
                launches=sum(e.count for e in kernels), top=[row(e) for e in top],
                flash=[row(e) for e in kernels if "flash_" in e.key], ranges=spans)


def log_profile(tag, what, out):
    share = (f"{out['busy_share']:.4f}" if out["device_kernel_s"] else "not measured")
    log(f"[{tag}] {what} under torch.profiler: wall {out['wall_s']:.3f} s, device "
        f"kernels {out['device_kernel_s']:.3f} s (busy share {share}), "
        f"{out['launches']} kernel launches")
    for row in out["top"]:
        log(f"[{tag}]   {row['device_ms']:9.3f} ms {row['calls']:6d} x {row['name']}")


def profile_wave(server, vocab, max_tokens=16, tag="profile", ranges=()):
    """One more wave of 8 fresh prompts under torch.profiler."""
    rng = np.random.default_rng(99)
    prompts = [rng.integers(1, vocab, n).tolist()
               for n in (17, 40, 64, 100, 128, 129, 200, 300)]
    before = server.stats()["decode"]
    out = profile_call(lambda: asyncio.run(serve_wave(server, prompts, max_tokens)),
                       ranges=ranges)
    after = server.stats()["decode"]
    out["decode_steps"] = sum(int(k) * (v - before["chunk_sizes"].get(k, 0))
                              for k, v in after["chunk_sizes"].items())
    out["decode_s"] = after["chunk_s_total"] - before["chunk_s_total"]
    log_profile(tag, f"8 requests x {max_tokens} tokens ({out['decode_steps']} "
                f"decode steps)", out)
    return out


# ------------------------------------------------------------------ train
def check_train_grads(device="cuda", tol=1e-4):
    """llama_1b width with 2 layers, f32, B=2, T=256: every parameter's
    gradient with attention through the kernels (forward, dQ, dK/dV)
    against the plain path (attn_impl="xla", autograd through
    mha_reference) on the same weights and batch. Tolerance: max error
    over the parameter's largest |grad| <= tol (the two paths differ in
    summation order only). Control: the plain path again with TF32 matrix
    products (10-bit mantissas), a lower-precision f32 path that must miss
    the limit."""
    import torch
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.ops.losses import chunked_cross_entropy

    grads, losses = [], []
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 32000, (2, 257))).to(device)
    for impl, tf32 in (("flash", False), ("xla", False), ("xla", True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        cfg = LlamaConfig.llama_1b(n_layers=2, dtype=torch.float32,
                                   param_dtype=torch.float32, attn_impl=impl)
        model = Llama(cfg, device=device)
        init_params(model, torch.Generator(device=device).manual_seed(3))
        before = flash_counts()
        hidden, _ = model(tokens[:, :-1], return_hidden=True)
        loss, _ = chunked_cross_entropy(hidden, model.lm_head.weight, tokens[:, 1:],
                                        chunk_size=256)
        loss.backward()
        launched = [a - b for a, b in zip(flash_counts(), before)]
        want = [2, 2, 2] if impl == "flash" else [0, 0, 0]
        if launched != want:
            raise AssertionError(f"attn_impl={impl}: fwd/dq/dkv launched {launched}")
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in model.named_parameters()})
        del model, hidden
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {n: rel_err(grads[0][n], g) for n, g in grads[1].items()}
    ctl = {n: rel_err(grads[2][n], g) for n, g in grads[1].items()}
    worst, ctl_worst = max(errs, key=errs.get), max(ctl, key=ctl.get)
    log(f"[train] llama_1b x 2 layers f32 B=2 T=256: loss kernels {losses[0]:.6f} vs "
        f"plain {losses[1]:.6f}; {len(errs)} parameter grads, worst {errs[worst]:.3e} "
        f"relative ({worst}; tol {tol}); control (plain path, TF32 products): loss "
        f"{losses[2]:.6f}, worst {ctl[ctl_worst]:.3e} ({ctl_worst})")
    if (errs[worst] > tol or abs(losses[0] - losses[1]) > 1e-5 * abs(losses[1])
            or ctl[ctl_worst] <= tol):
        raise AssertionError(f"train grads: {worst} err {errs[worst]}, control "
                             f"{ctl[ctl_worst]}, losses {losses}")
    return dict(loss_kernels=losses[0], loss_plain=losses[1], worst_param=worst,
                worst_rel_err=errs[worst], tol=tol, control_loss=losses[2],
                control_worst_param=ctl_worst, control_worst_rel_err=ctl[ctl_worst])


def check_head_bf16(device="cuda", b=4, t=2048, tol=1e-2):
    """The llama_1b step's loss head in bf16, B=4, T=2048, chunk 512:
    chunked_cross_entropy on bf16 hidden states and a bf16 lm_head weight
    (logits from a bf16 product with f32 output, dlogits cast to bf16
    before both backward products) against the same function on the
    operands widened to f32 (f32 products throughout). Limits: the loss
    within 1e-5 relative (the forward differs in summation order only), each
    gradient within tol of its largest |grad| (dlogits and both gradients
    rounded to bf16)."""
    import torch
    from ray_tpu_torch.ops.losses import chunked_cross_entropy

    gen = torch.Generator(device=device).manual_seed(11)
    hidden = torch.randn((b, t, 2048), generator=gen, device=device).bfloat16()
    w_head = (0.02 * torch.randn((32000, 2048), generator=gen, device=device)).bfloat16()
    labels = torch.randint(0, 32000, (b, t), generator=gen, device=device)
    res = []
    for dt in (torch.bfloat16, torch.float32):
        h = hidden.detach().to(dt).requires_grad_()
        w = w_head.detach().to(dt).requires_grad_()
        loss, aux = chunked_cross_entropy(h, w, labels, chunk_size=512)
        loss.backward()
        res.append((loss.item(), aux["accuracy"].item(), h.grad, w.grad))
        del h, w
    (loss16, acc16, dh16, dw16), (loss32, acc32, dh32, dw32) = res
    loss_err = abs(loss16 - loss32) / abs(loss32)
    dh_err, dw_err = rel_err(dh16, dh32), rel_err(dw16, dw32)
    log(f"[train] loss head bf16 vs f32-widened, B={b} T={t} chunk 512: loss {loss16:.6f} "
        f"vs {loss32:.6f} (rel {loss_err:.2e}, tol 1e-5), accuracy {acc16} vs {acc32}, "
        f"d hidden {dh_err:.3e}, d lm_head {dw_err:.3e} of max |grad| (tol {tol})")
    if loss_err > 1e-5 or dh_err > tol or dw_err > tol:
        raise AssertionError(f"bf16 head: loss rel {loss_err}, dh {dh_err}, dw {dw_err}")
    return dict(loss_bf16=loss16, loss_f32=loss32, loss_rel_err=loss_err,
                dhidden_rel_err=dh_err, dw_head_rel_err=dw_err, tol=tol)


def run_train(device="cuda", steps=10, warmup=2):
    """The training slice: train_llama("llama_1b", 4, 2048), its launch
    counts, throughput and peak memory; then one step under remat; then one
    step under torch.profiler."""
    import torch
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import train_llama
    from ray_tpu_torch.train.llm_step import build_llama_trainer

    layers = LlamaConfig.llama_1b().n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    res = train_llama("llama_1b", 4, 2048, steps=steps, warmup_steps=warmup, device=device)
    launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), flash_counts()))
    peak = torch.cuda.max_memory_allocated()
    n = steps + warmup
    # MFU only on a card whose dense bf16 rate util/gpu.py lists
    peak_flops = peak_flops_per_chip(torch.cuda.get_device_name())
    mfu = res["tflops_per_s"] * 1e12 / peak_flops if peak_flops else "not measured"
    checks = {
        f"fwd, dq, dkv each launched {layers} x {n} steps":
            all(c == layers * n for c in launches.values()),
        "every loss finite": all(np.isfinite(res["losses"])),
        "params finite": res["params_finite"],
        "remat off (bench.py default at B=4)": res["remat"] is False,
    }
    for what, ok in checks.items():
        log(f"[train] {'ok  ' if ok else 'FAIL'} {what}")
    log(f"[train] llama_1b B=4 T=2048 bf16: {res['ms_per_step']:.1f} ms/step, "
        f"{res['tokens_per_s']:.0f} tokens/s, {res['tflops_per_s']:.2f} TFLOP/s, MFU "
        f"{mfu if isinstance(mfu, str) else f'{mfu:.4f}'} (peak bf16 "
        f"{peak_flops}), peak memory {peak / 2**30:.2f} GiB, losses "
        f"{[round(x, 4) for x in res['losses']]}")
    if not all(checks.values()):
        raise AssertionError(f"train checks failed: launches {launches}, res {res}")
    out = dict(res, launches=launches, peak_memory_bytes=peak, mfu=mfu,
               peak_bf16_flops=peak_flops)

    # (c) remat: the block forward runs again in the backward
    torch.cuda.empty_cache()
    reset_flash_counts()
    rem = train_llama("llama_1b", 4, 2048, steps=1, warmup_steps=0, remat=True,
                      device=device)
    rem_launches = flash_counts()
    rem_err = abs(rem["losses"][0] - res["losses"][0]) / abs(res["losses"][0])
    log(f"[train] remat step: fwd/dq/dkv launched {rem_launches} (want "
        f"[{2 * layers}, {layers}, {layers}]), loss {rem['losses'][0]:.6f} vs "
        f"{res['losses'][0]:.6f} without remat (rel {rem_err:.2e}, tol 1e-5), "
        f"{rem['ms_per_step']:.1f} ms/step")
    if rem_launches != [2 * layers, layers, layers] or rem_err > 1e-5:
        raise AssertionError(f"remat step: launches {rem_launches}, loss err {rem_err}")
    out["remat_step"] = dict(launches=rem_launches, loss=rem["losses"][0], rel_err=rem_err,
                        ms_per_step=rem["ms_per_step"])

    # (d) one step under the profiler, after one warm step
    torch.cuda.empty_cache()
    model, _, step, batches, dev = build_llama_trainer("llama_1b", 4, 2048, device=device)
    feed = lambda i: torch.from_numpy(batches[i]).to(dev)
    step(feed(0))
    prof = profile_call(lambda: step(feed(1)))
    log_profile("train", "one llama_1b step (B=4, T=2048)", prof)
    out["profile"] = prof
    # the step's flash kernels by name: forward, dQ and dK/dV are the
    # tensor-core kernels, 16 calls each, and the scalar bodies do not run
    by_kernel = {}
    for r in prof["flash"]:
        name = re.search(r"flash_\w+_kernel", r["name"]).group(0)
        calls, ms = by_kernel.get(name, (0, 0.0))
        by_kernel[name] = (calls + r["calls"], ms + r["device_ms"])
    for name, (calls, ms) in sorted(by_kernel.items()):
        log(f"[train]   {ms:9.3f} ms {calls:6d} x {name}")
    want = {name: layers for name in TC_KERNELS}
    if {n: c for n, (c, _) in by_kernel.items()} != want:
        raise AssertionError(f"profiled step's flash kernels {by_kernel}, want calls {want}")
    del model, step
    return out


# ---------------------------------------------------------------- trainer
def check_topology():
    """(a) The port's topology helpers against the card: util/gpu.py's
    slice_topology() and visible_chip_ids() and api._detect_gpus() agree
    with torch.cuda.device_count() and nvidia-smi's name, and
    peak_flops_per_chip() gives the rate the MFU line uses."""
    import torch
    from ray_tpu_torch.api import _detect_gpus
    from ray_tpu_torch.util import gpu

    n = torch.cuda.device_count()
    name = torch.cuda.get_device_name(0)
    smi_name = smi_line().splitlines()[0].split(",")[0].strip()
    topo, ids = gpu.slice_topology(), gpu.visible_chip_ids()
    peak = gpu.peak_flops_per_chip()
    checks = {
        f"slice_topology {topo} has {n} card(s) on one host": (
            topo["num_chips"] == topo["chips_per_host"] == n and topo["num_hosts"] == 1
            and topo["worker_id"] == 0),
        f"device name {topo['device_name']!r} = torch's = nvidia-smi's {smi_name!r}":
            topo["device_name"] == name == smi_name,
        f"visible_chip_ids {ids} count {n}": len(ids) == n,
        f"_detect_gpus() = {_detect_gpus()} = {n}": _detect_gpus() == n,
        f"peak_flops_per_chip() = {peak} (the MFU line's rate)": peak == (
            PEAK_FLOPS["bfloat16"] if name == H100_SXM else None),
    }
    for what, ok in checks.items():
        log(f"[trainer] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"topology checks failed: {checks}")
    return dict(topology=topo, visible_chip_ids=ids, detect_gpus=_detect_gpus(),
                peak_flops=peak, smi_name=smi_name)


def op_ms(fn, iters=20):
    """Mean device time of one eager fn() call (CUDA events around `iters`
    back-to-back calls, after one warm call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_nccl_world():
    """(b) A one-rank world on NCCL: initialize_multihost() starts nothing at
    one process; init_collective_group(1, 0, backend="nccl") runs every op
    on a bf16 tensor of one llama_1b layer's parameter count, and at world
    1 each result equals its input; both barriers return; _world_info is
    (1, 0) for one worker and raises for two. Each op's ms is logged."""
    import types

    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.llama import LlamaConfig, llama_param_count
    from ray_tpu_torch.parallel import collective as col
    from ray_tpu_torch.parallel import distributed as tdist
    from ray_tpu_torch.train.worker_group import _world_info

    started = tdist.initialize_multihost()
    if started is not False or dist.is_initialized():
        raise AssertionError(f"initialize_multihost() at one process gave {started}")
    n = (llama_param_count(LlamaConfig.llama_1b(n_layers=2))
         - llama_param_count(LlamaConfig.llama_1b(n_layers=1)))
    x = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda").bfloat16()
    g = col.init_collective_group(1, 0, backend="nccl", group_name="smoke")
    try:
        ops = {f"allreduce_{op}": lambda op=op: col.allreduce(x, "smoke", op)
               for op in ("sum", "max", "min")}
        ops.update(
            allgather=lambda: col.allgather(x, "smoke"),
            reducescatter=lambda: col.reducescatter(x, "smoke"),
            broadcast=lambda: col.broadcast(x, 0, "smoke"),
            reduce=lambda: col.reduce(x, 0, "smoke"),
            alltoall=lambda: col.alltoall(x, "smoke"),
            send_recv_self=lambda: (col.send(x, 0, "smoke"), col.recv(x, 0, "smoke"))[1])
        equal = {name: torch.equal(fn(), x) for name, fn in ops.items()}
        times = {name: op_ms(fn) for name, fn in ops.items()}
        times["barrier"] = op_ms(lambda: col.barrier("smoke"))
        tdist.barrier()
        world = (g.world_size, g.rank, tdist.process_count(), tdist.process_index(),
                 dist.get_backend(g.pg))
        one = _world_info(types.SimpleNamespace(num_workers=1))
        try:
            _world_info(types.SimpleNamespace(num_workers=2))
            two = "did not raise"
        except ValueError as e:
            two = str(e)
    finally:
        col.destroy_collective_group("smoke")
    smi = smi_line()
    for name in times:
        log(f"[trainer] nccl world 1 {name}: {times[name]:.4f} ms"
            + (f", equal to its input: {equal[name]}" if name in equal else "")
            + f" (bf16 x {n}; {smi})")
    checks = {"every op's result equals its input": all(equal.values()),
              f"group world/rank/process count/index/backend {world}":
                  world == (1, 0, 1, 0, "nccl"),
              f"_world_info(num_workers=1) = {one}": one == (1, 0),
              "_world_info(num_workers=2) raises": "num_workers=2" in two,
              "no process group left": not dist.is_initialized()}
    for what, ok in checks.items():
        log(f"[trainer] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"nccl world checks failed: {checks}, {equal}, {two}")
    return dict(elements=n, dtype="bfloat16", equal=equal, ms=times, device=smi)


def run_steps(step, feed, n, sync):
    """n steps through `step`; returns (loss tensors, ms per step), host clock
    around work that ends in a device synchronise."""
    sync()
    t0 = time.perf_counter()
    losses = [step(next(feed)) for _ in range(n)]
    sync()
    return losses, (time.perf_counter() - t0) / n * 1e3


def snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def equal_trees(a, b):
    import torch
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def feed_copies(trace_path):
    """From a chrome trace: every host-to-device copy (kind, bytes, stream)
    and the streams of the flash forward kernel."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    copies = [dict(name=e["name"], bytes=e.get("args", {}).get("bytes"),
                   stream=e.get("args", {}).get("stream"))
              for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    fwd_streams = sorted({e.get("args", {}).get("stream") for e in events
                          if e.get("cat") == "kernel" and "flash_fwd" in e.get("name", "")})
    return copies, fwd_streams


WARM_KERNELS = 64


def profile_feed(step, batch, dev, sync):
    """One step fed by iter_device_batches under torch.profiler; returns the
    host-to-device copies of the batch's size, every host-to-device copy,
    the flash forward's streams, and how many of the WARM_KERNELS
    throwaway kernels at the window's start the trace holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.train import iter_device_batches

    trace = OUT_DIR / "trainer_trace.json"
    OUT_DIR.mkdir(exist_ok=True)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # After the earlier phases' traces, a session can lose its first
        # device records (on the card the first 15 were missing, the
        # batch's copy among them): throwaway kernels go first.
        for _ in range(WARM_KERNELS if dev.type == "cuda" else 0):
            torch.cuda._sleep(1000)
        sync()
        for tokens in iter_device_batches([batch], device=dev):
            step(tokens)
        sync()
    prof.export_chrome_trace(str(trace))
    all_copies, fwd_streams = feed_copies(trace)
    events = json.loads(trace.read_text())["traceEvents"]
    warm = sum(1 for e in events if e.get("cat") == "kernel" and "spin_kernel" in e.get("name", ""))
    return ([c for c in all_copies if c["bytes"] == batch.nbytes], all_copies, fwd_streams,
            warm)


def run_trainer(device="cuda", preset="llama_1b", batch=4, seq=2048, steps=6, save_at=3,
                keep=None):
    """(c) train_resume and (d) the feed under the profiler. llama_1b at full
    width and depth, bf16, B=4, T=2048, build_llama_trainer's defaults:
    run A takes `steps` steps fed by iter_device_batches(prefetch=2) and is
    checkpointed (model, AdamW state, step) after step `save_at`; run B takes
    the same steps from the same init fed by the plain .to(dev) copy, and
    its losses must equal A's; run C restores a fresh model and optimizer
    from the checkpoint and takes steps save_at+1..steps from a fresh
    iterator started at batch save_at+1: the params right after the
    restore, its losses and its final params are torch.equal to A's, and
    the flash kernels launch 16 times each per step. Then one step fed by
    the iterator runs under torch.profiler: the batch's copy must be a
    pinned copy on a stream that runs no flash forward kernel. `keep`, a
    dict, receives run A's loss tensors, its final params on the host, its
    ms a step after the save and the checkpoint's bytes (what `train_fit`
    is held to)."""
    import gc
    import os
    import tempfile

    import torch
    from ray_tpu_torch.models.llama import llama_param_count
    from ray_tpu_torch.train import Checkpoint, iter_device_batches
    from ray_tpu_torch.train.llm_step import build_llama_trainer

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        return build_llama_trainer(preset, batch, seq, device=device)

    smi = smi_line()
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = dict(device=smi, preset=preset, batch=batch, seq=seq, steps=steps, save_at=save_at)
    try:
        # A: the uninterrupted run, fed by the iterator, saved after save_at
        model, opt, step, batches, dev = fresh()
        n_params = llama_param_count(model.cfg)
        out["param_dtype"] = str(model.cfg.param_dtype).replace("torch.", "")
        need = 3 * n_params * model.cfg.param_dtype.itemsize   # params + 2 AdamW moments
        free = shutil.disk_usage(ckpt_dir).free
        log(f"[trainer] checkpoint reckoned {need / 2**30:.2f} GiB ({n_params} params x 3 "
            f"x {model.cfg.param_dtype}), {free / 2**30:.1f} GiB free in {ckpt_dir}")
        if free < 1.2 * need:
            raise AssertionError(f"disk too small for the checkpoint: {free} < 1.2 x {need}")
        feed = iter_device_batches(batches[:steps], device=dev, prefetch=2)
        losses_a, out["ms_per_step_first_iterator"] = run_steps(step, feed, save_at, sync)
        saved = snapshot(model)
        t0 = time.perf_counter()
        Checkpoint.from_state({"model": model.state_dict(), "optim": opt.state_dict(),
                               "step": save_at}, path=ckpt_dir)
        out["save_s"] = time.perf_counter() - t0
        out["checkpoint_bytes"] = os.path.getsize(os.path.join(ckpt_dir, "state.pt"))
        more, out["ms_per_step_iterator"] = run_steps(step, feed, steps - save_at, sync)
        losses_a += more
        final_a = snapshot(model)
        if keep is not None:
            keep.update(losses=losses_a, final={k: v.cpu() for k, v in final_a.items()},
                        ms_per_step=out["ms_per_step_iterator"],
                        checkpoint_bytes=out["checkpoint_bytes"])
        del model, opt, step, feed

        # B: the same steps from the same init, fed by the plain copy
        model, opt, step, _, _ = fresh()
        plain = (torch.from_numpy(b).to(dev) for b in batches[:steps])
        losses_b, out["ms_per_step_first_plain"] = run_steps(step, plain, save_at, sync)
        more, out["ms_per_step_plain"] = run_steps(step, plain, steps - save_at, sync)
        losses_b += more
        del model, opt, step

        # C: a fresh model and optimizer restored from the checkpoint
        model, opt, step, _, _ = fresh()
        sync()
        t0 = time.perf_counter()
        state = Checkpoint.from_directory(ckpt_dir).to_state(
            target={"model": model.state_dict(), "optim": opt.state_dict()})
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optim"])
        sync()
        out["restore_s"] = time.perf_counter() - t0
        del state
        restored_equal = equal_trees(snapshot(model), saved)
        del saved
        reset_flash_counts()
        feed = iter_device_batches(batches[save_at:steps], device=dev, prefetch=2)
        losses_c, out["ms_per_step_resumed"] = run_steps(step, feed, steps - save_at, sync)
        launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), flash_counts()))
        final_equal = equal_trees(snapshot(model), final_a)
        del final_a
        layers = model.cfg.n_layers

        # the two feeds timed in turns on the warm model, 3 steps a turn
        # (plain, iterator, iterator, plain), nothing else between them
        turns = {"plain": [], "iterator": []}
        ring = batches[steps:] + batches[:steps]
        for kind in ("plain", "iterator", "iterator", "plain"):
            feed = (iter_device_batches(ring[:3], device=dev, prefetch=2) if kind == "iterator"
                    else (torch.from_numpy(b).to(dev) for b in ring[:3]))
            turns[kind].append(run_steps(step, feed, 3, sync)[1])
        out["ms_per_step_turns"] = turns

        # (d) one step fed by the iterator under the profiler
        copies, all_copies, fwd_streams, warm = profile_feed(step, batches[steps], dev, sync)
        del model, opt, step
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out.update(
        checkpoint_bytes_reckoned=need, ckpt_removed=not os.path.exists(ckpt_dir),
        losses=[x.item() for x in losses_a], losses_plain=[x.item() for x in losses_b],
        losses_resumed=[x.item() for x in losses_c], launches=launches,
        feed_copies=copies, htod_copies=all_copies, flash_fwd_streams=fwd_streams,
        warm_kernels_traced=warm)
    equal = lambda xs, ys: len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))
    checks = {
        "params right after the restore torch.equal the saved ones": restored_equal,
        f"steps {save_at + 1}-{steps}: resumed losses torch.equal the uninterrupted run's":
            equal(losses_c, losses_a[save_at:]),
        "final params torch.equal the uninterrupted run's": final_equal,
        "losses of the iterator feed torch.equal the plain feed's": equal(losses_a, losses_b),
        f"fwd, dq, dkv each launched {layers} x {steps - save_at} resumed steps":
            all(c == layers * (steps - save_at) for c in launches.values()),
        "every loss finite": all(np.isfinite(out["losses"])),
        f"the batch's copy is pinned ({copies}; every HtoD copy {all_copies[:8]}; "
        f"{warm} of {WARM_KERNELS} throwaway kernels traced)":
            bool(copies) and all(
            c["name"] == "Memcpy HtoD (Pinned -> Device)" for c in copies),
        f"off the flash forward's stream(s) {fwd_streams}": bool(fwd_streams) and all(
            c["stream"] not in fwd_streams for c in copies),
        "checkpoint directory removed": out["ckpt_removed"],
    }
    for what, ok in checks.items():
        log(f"[trainer] {'ok  ' if ok else 'FAIL'} {what}")
    log(f"[trainer] {preset} B={batch} T={seq} {out['param_dtype']}: checkpoint "
        f"{out['checkpoint_bytes']} bytes (reckoned {need}), save {out['save_s']:.2f} s, "
        f"restore {out['restore_s']:.2f} s; ms/step over the cold steps 1-{save_at} of a "
        f"fresh model: iterator feed {out['ms_per_step_first_iterator']:.1f}, plain feed "
        f"{out['ms_per_step_first_plain']:.1f}; over steps {save_at + 1}-{steps}: "
        f"iterator feed right after the save {out['ms_per_step_iterator']:.1f}, plain feed "
        f"{out['ms_per_step_plain']:.1f}, resumed right after the restore "
        f"{out['ms_per_step_resumed']:.1f}; in turns on the warm model (plain, iterator, "
        f"iterator, plain): plain {[round(x, 1) for x in turns['plain']]}, iterator "
        f"{[round(x, 1) for x in turns['iterator']]}; losses "
        f"{[round(x, 4) for x in out['losses']]} ({smi})")
    if not all(checks.values()):
        raise AssertionError(f"trainer checks failed: {checks}")
    return out


@contextlib.contextmanager
def timed_calls(module, name):
    """Every outermost call of `module.name` in the block timed (a call it
    makes of itself, as copytree does for a subdirectory, is inside its
    caller's time): yields the list of each call's wall seconds."""
    real = getattr(module, name)
    seconds, depth = [], [0]

    def timed(*args, **kw):
        depth[0] += 1
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            depth[0] -= 1
            if not depth[0]:
                seconds.append(time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, real)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


FIT_SAVE_AT = (2, 4)    # train_fit reports a checkpoint after these steps
FIT_FAIL_AT = 3         # the step whose first attempt raises before its report


def run_train_fit(run_a, device="cuda", preset="llama_1b", batch=4, seq=2048, steps=6):
    """(e) Path `train_fit`: TorchTrainer(...).fit() over the loop of
    run_trainer's run A (the same build, seed and host batches, the batches
    given as datasets={"train": ...} and read through
    get_dataset_shard("train") and iter_device_batches(prefetch=2)), with
    RunConfig(storage_path=<a temporary directory>,
    CheckpointConfig(num_to_keep=1), FailureConfig(max_failures=1)): every
    step reports {"loss", "step"}, steps FIT_SAVE_AT also a checkpoint
    (model, AdamW, step); step FIT_FAIL_AT's first attempt raises after its
    step and before its report, and the retry restores from
    get_checkpoint() and takes the steps from there. Held: no error; the
    history's steps and losses, each loss tensor (the retried step's too)
    and the final params equal run A's (`run_a`, from run_trainer's
    `keep`); the book keeps the last checkpoint alone, which
    result.checkpoint names; the flash kernels launch 16 times each per
    step taken. Timed: the fit, its ms a step over its last two steps (each
    with its report) against run A's bare loop, each report() call, and
    rank 0's checkpoint copies."""
    import gc
    import tempfile

    import torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train.llm_step import build_llama_trainer, host_batches

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    smi = smi_line()
    root = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    scratch = os.path.join(root, "scratch")
    batches = host_batches(getattr(LlamaConfig, preset)().vocab_size, batch, seq)[:steps]
    seen = dict(attempts=0, resumed_from=[], losses={}, marks={}, reports=[], saves=[])

    def loop(config):
        seen["attempts"] += 1
        attempt = seen["attempts"]
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        model, opt, step, _, dev = build_llama_trainer(preset, batch, seq, device=device)
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            state = ckpt.to_state(target={"model": model.state_dict(),
                                          "optim": opt.state_dict()})
            model.load_state_dict(state["model"])
            opt.load_state_dict(state["optim"])
            start = state["step"]
            seen["resumed_from"].append(start)
            del state
        shard = train.get_dataset_shard("train")
        feed = train.iter_device_batches(shard[start:config["steps"]], device=dev, prefetch=2)
        for n, tokens in zip(range(start + 1, config["steps"] + 1), feed):
            seen["marks"][attempt, n] = time.perf_counter()
            loss = step(tokens)
            if n == FIT_FAIL_AT and attempt == 1:
                raise RuntimeError(f"injected failure at step {n}")
            seen["losses"][n] = loss
            metrics = {"loss": loss.item(), "step": n}
            ckpt = None
            if n in FIT_SAVE_AT:
                t0 = time.perf_counter()
                ckpt = train.Checkpoint.from_state(
                    {"model": model.state_dict(), "optim": opt.state_dict(), "step": n},
                    path=os.path.join(config["scratch"], f"step{n}"))
                seen["saves"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            train.report(metrics, checkpoint=ckpt)
            seen["reports"].append((n, ckpt is not None, time.perf_counter() - t0))
            if ckpt is not None:
                shutil.rmtree(ckpt.path)        # the run directory holds its copy
        sync()
        seen["marks"][attempt, "end"] = time.perf_counter()
        seen["final_equal"] = equal_trees({k: v.cpu() for k, v in model.state_dict().items()},
                                          run_a["final"])

    need = 3 * run_a["checkpoint_bytes"]     # the loop's, the old copy and the new at step 4
    free = shutil.disk_usage(root).free
    out = dict(device=smi, preset=preset, batch=batch, seq=seq, steps=steps,
               save_at=list(FIT_SAVE_AT), fail_at=FIT_FAIL_AT)
    try:
        if free < 1.2 * need:
            raise AssertionError(f"disk too small for train_fit: {free} < 1.2 x {need}")
        reset_flash_counts()
        with timed_calls(shutil, "copytree") as copies:
            t0 = time.perf_counter()
            result = train.TorchTrainer(
                loop, train_loop_config={"steps": steps, "scratch": scratch},
                datasets={"train": batches},
                run_config=train.RunConfig(
                    name="fit", storage_path=root,
                    checkpoint_config=train.CheckpointConfig(num_to_keep=1),
                    failure_config=train.FailureConfig(max_failures=1))).fit()
            out["fit_s"] = time.perf_counter() - t0
        launches = dict(zip(FLASH_NAMES, flash_counts()))
        kept = sorted(d for d in os.listdir(result.path) if d.startswith("checkpoint_"))
        out.update(
            error=repr(result.error), kept=kept, bytes_left=dir_bytes(result.path),
            checkpoint=result.checkpoint and os.path.basename(result.checkpoint.path),
            kept_step=(train.Checkpoint(result.checkpoint.path).get_metadata()["metrics"]["step"]
                       if result.checkpoint else None),
            progress_lines=len(open(os.path.join(result.path, "progress.jsonl")).readlines()))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    taken = sorted(k for k in seen["marks"] if k[1] != "end")
    last = seen["attempts"]
    ms_fit = (seen["marks"][last, "end"] - seen["marks"][last, steps - 1]) / 2 * 1e3
    history = result.metrics_history
    want = [x.item() for x in run_a["losses"]]
    out.update(
        attempts=seen["attempts"], resumed_from=seen["resumed_from"], steps_taken=len(taken),
        launches=launches, history_steps=[m["step"] for m in history],
        losses=[m["loss"] for m in history], losses_run_a=want,
        ms_per_step_fit=ms_fit, ms_per_step_bare=run_a["ms_per_step"],
        report_ms=[(n, ck, x * 1e3) for n, ck, x in seen["reports"]],
        save_s=seen["saves"], copy_s=copies, removed=not os.path.exists(root))
    layers = getattr(LlamaConfig, preset)().n_layers
    launches_due = layers * len(taken) if cuda else 0     # CPU tensors launch no kernel
    checks = {
        "fit() returned no error": result.error is None,
        f"one failure at step {FIT_FAIL_AT}, resumed from step {FIT_SAVE_AT[0]}":
            seen["attempts"] == 2 and seen["resumed_from"] == [FIT_SAVE_AT[0]],
        f"history steps 1-{steps}, losses equal run A's": out["history_steps"] == list(
            range(1, steps + 1)) and out["losses"] == want,
        "every loss tensor (the retried step's too) torch.equal run A's": all(
            torch.equal(seen["losses"][n], run_a["losses"][n - 1]) for n in range(1, steps + 1)),
        "final params torch.equal run A's": seen.get("final_equal", False),
        f"one checkpoint kept, checkpoint_000001 (step {FIT_SAVE_AT[-1]}), named by the result":
            kept == ["checkpoint_000001"] and out["checkpoint"] == "checkpoint_000001"
            and out["kept_step"] == FIT_SAVE_AT[-1],
        f"progress.jsonl holds {steps} lines": out["progress_lines"] == steps,
        f"two copies by report ({len(copies)})": len(copies) == len(FIT_SAVE_AT),
        f"fwd, dq, dkv each launched {layers} x {len(taken)} steps taken" + (
            "" if cuda else " (0 on the CPU)"): all(c == launches_due for c in launches.values()),
        "run directory removed": out["removed"],
    }
    for what, ok in checks.items():
        log(f"[train_fit] {'ok  ' if ok else 'FAIL'} {what}")
    bare_ms = [x for _, ck, x in out["report_ms"] if not ck]
    log(f"[train_fit] {preset} B={batch} T={seq}: fit {out['fit_s']:.2f} s over "
        f"{len(taken)} steps taken; ms/step over steps {steps - 1}-{steps} in fit() "
        f"{ms_fit:.1f} against the bare loop's {run_a['ms_per_step']:.1f}; report() without "
        f"a checkpoint {min(bare_ms):.3f}-{max(bare_ms):.3f} ms; saves "
        f"{[round(x, 2) for x in seen['saves']]} s, report's copies "
        f"{[round(x, 2) for x in copies]} s, reports with a checkpoint "
        f"{[round(x / 1e3, 2) for _, ck, x in out['report_ms'] if ck]} s; bytes left "
        f"{out['bytes_left']}; launches {launches} ({smi})")
    if not all(checks.values()):
        raise AssertionError(f"train_fit checks failed: {checks}")
    return out


def fit_actor_loop(config):
    """run_train_fit's loop for a TrainWorker actor (`train_fit_actor`):
    the same build, batches and checkpoints, in the actor's own process on
    its one card. The first attempt's process exits (os._exit(1)) after
    step FIT_FAIL_AT's step and before its report, writing the time and
    its launch counts to `config["flag"]` first; the respawn resumes from
    get_checkpoint(). Every report carries the step's loss, this process's
    pid, its launch counts since the loop began, and the host times around
    the step; the last one also the params' digest."""
    import torch
    from ray_tpu_torch import train
    from ray_tpu_torch.train.llm_step import build_llama_trainer
    loop_start = time.time()
    reset_launch_counts()
    model, opt, step, _, dev = build_llama_trainer(config["preset"], config["batch"],
                                                   config["seq"], device=config["device"])
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        state = ckpt.to_state(target={"model": model.state_dict(), "optim": opt.state_dict()})
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optim"])
        start = state["step"]
        del state
    shard = train.get_dataset_shard("train")
    feed = train.iter_device_batches(shard[start:config["steps"]], device=dev, prefetch=2)
    for n, tokens in zip(range(start + 1, config["steps"] + 1), feed):
        t0 = time.time()
        loss = step(tokens)
        value = loss.item()
        t1 = time.time()
        if n == FIT_FAIL_AT and not os.path.exists(config["flag"]):
            with open(config["flag"], "w") as f:
                json.dump({"t": time.time(), "pid": os.getpid(), "launches": launch_counts()}, f)
            os._exit(1)
        metrics = {"loss": value, "step": n, "pid": os.getpid(), "start": start,
                   "loop_start": loop_start, "t0": t0, "t1": t1, "launches": launch_counts(),
                   "binding": card_binding()}
        if n == config["steps"]:
            metrics["digest"] = state_digest(model.state_dict())
        ckpt = None
        if n in FIT_SAVE_AT:
            ckpt = train.Checkpoint.from_state(
                {"model": model.state_dict(), "optim": opt.state_dict(), "step": n},
                path=os.path.join(config["scratch"], f"step{n}"))
        train.report(metrics, checkpoint=ckpt)
        if ckpt is not None:
            shutil.rmtree(ckpt.path)        # the run directory holds its copy


def run_train_fit_actor(run_a, device="cuda", preset="llama_1b", batch=4, seq=2048, steps=6):
    """(f) Path `train_fit_actor`: TorchTrainer(use_worker_actor=True,
    ScalingConfig(use_gpu=True), RunConfig(FailureConfig(max_failures=1),
    CheckpointConfig(num_to_keep=1))).fit() in a session of the port's
    runtime: run_train_fit's loop (fit_actor_loop) in a TrainWorker actor
    that claims the card. Its process exits at step FIT_FAIL_AT on the
    first attempt; the actor is respawned on the card and resumes from the
    checkpoint of step FIT_SAVE_AT[0]. Held: no error; the history's steps
    1-6 and losses equal run A's (run_train_fit's reference, bit for bit as
    floats) and the final params' digest run A's; two processes, the
    second resumed from step 2; B1-B3 launched 16 x the steps each process
    took, there, and 0 times in this process; the actor's
    CUDA_VISIBLE_DEVICES its get_gpu_ids(); the card returned after the
    actor's death (a num_gpus=1 actor made afterwards starts). Timed: ms a
    step in the actor (its last two steps, each with its report) against
    run A's bare loop, the restart (the crash to the respawned loop's
    start, and to its first step), the fit."""
    import tempfile

    import torch
    import chip_smoke
    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train.llm_step import host_batches

    cuda = torch.device(device).type == "cuda"
    smi = smi_line()
    root = tempfile.mkdtemp(prefix="chip_smoke_fit_actor_")
    batches = host_batches(getattr(LlamaConfig, preset)().vocab_size, batch, seq)[:steps]
    config = dict(preset=preset, batch=batch, seq=seq, steps=steps, device=device,
                  scratch=os.path.join(root, "scratch"), flag=os.path.join(root, "died"))
    out = dict(device=smi, preset=preset, batch=batch, seq=seq, steps=steps,
               save_at=list(FIT_SAVE_AT), fail_at=FIT_FAIL_AT)
    own = not rt.is_initialized()
    try:
        if own:
            out["init_s"] = open_session(device)
        if cuda:
            torch.cuda.empty_cache()    # the card's memory is the actor's now
        reset_launch_counts()
        t0 = time.perf_counter()
        result = train.TorchTrainer(
            chip_smoke.fit_actor_loop, train_loop_config=config, datasets={"train": batches},
            scaling_config=train.ScalingConfig(use_gpu=cuda), use_worker_actor=True,
            run_config=train.RunConfig(
                name="fit_actor", storage_path=root,
                checkpoint_config=train.CheckpointConfig(num_to_keep=1),
                failure_config=train.FailureConfig(max_failures=1))).fit()
        out["fit_s"] = time.perf_counter() - t0
        here = launch_counts()
        # the card is back: a num_gpus=1 actor starts (gpu "number" 0 on the CPU)
        t0 = time.perf_counter()
        after = rt.get(rt.remote(num_gpus=1)(Pinger).remote().binding.remote(), timeout=300)
        out["card_back_s"] = time.perf_counter() - t0
        crash = json.load(open(config["flag"])) if os.path.exists(config["flag"]) else None
    finally:
        if own:
            out["session_workers"] = close_session("train_fit_actor")
        shutil.rmtree(root, ignore_errors=True)
    history = result.metrics_history
    want = [x.item() for x in run_a["losses"]]
    pids = [m["pid"] for m in history]
    procs = sorted(set(pids), key=pids.index)
    second = [m for m in history if m["pid"] == procs[-1]]
    layers = getattr(LlamaConfig, preset)().n_layers
    per = layers if cuda else 0                        # CPU tensors launch none
    # every process's launches: the crashed one's at its exit, the respawn's
    # at its last report
    taken = [FIT_FAIL_AT, steps - second[0]["start"]]
    counts = [crash["launches"] if crash else None, second[-1]["launches"]]
    launches = {k: sum(c[k] for c in counts if c) for k in counts[-1]}
    last, prev = second[-1], second[-2]
    ms_actor = (last["t1"] - prev["t0"]) / 2 * 1e3
    out.update(
        error=repr(result.error), history_steps=[m["step"] for m in history],
        losses=[m["loss"] for m in history], losses_run_a=want, pids=procs,
        resumed_from=second[0]["start"], launches=launches, launches_by_process=counts,
        launches_here=here, binding=second[0]["binding"], card_after=after,
        ms_per_step_actor=ms_actor, ms_per_step_bare=run_a["ms_per_step"],
        restart_s=second[0]["loop_start"] - crash["t"] if crash else None,
        restart_to_step_s=second[0]["t0"] - crash["t"] if crash else None,
        removed=not os.path.exists(root))
    b = out["binding"]
    checks = {
        "fit() returned no error": result.error is None,
        f"history steps 1-{steps}, losses equal run A's as floats":
            out["history_steps"] == list(range(1, steps + 1)) and out["losses"] == want,
        "final params' digest equal run A's": last.get("digest") == state_digest(run_a["final"]),
        f"two processes, the respawn resumed from step {FIT_SAVE_AT[0]} "
        f"({len(procs)}, {out['resumed_from']})":
            len(procs) == 2 and crash is not None and out["resumed_from"] == FIT_SAVE_AT[0],
        f"B1-B3 launched {layers} x the steps each process took {taken}, there, and B4 "
        f"none" + ("" if cuda else " (0 on the CPU)"): all(
            c is not None and all(c[f] == per * k for f in FLASH_NAMES)
            and c["paged_decode"] == c["paged_decode_combine"] == 0
            for c, k in zip(counts, taken)),
        f"this process launched no kernel ({here})": not any(here.values()),
        "the card returned after the actor's death: a num_gpus=1 actor started" + (
            " on it" if cuda else ""): after["gpu_ids"] == b["gpu_ids"] if cuda else bool(after),
        "run directory removed": out["removed"],
    }
    if cuda:
        checks[f"the actor's CUDA_VISIBLE_DEVICES {b['cuda_visible_devices']!r} == get_gpu_ids() "
               f"{b['gpu_ids']}, one card seen"] = (
            b["cuda_visible_devices"] == ",".join(map(str, b["gpu_ids"]))
            and b["device_count"] == 1)
    for what, ok in checks.items():
        log(f"[train_fit_actor] {'ok  ' if ok else 'FAIL'} {what}")
    if result.error is not None:
        log(f"[train_fit_actor] the fit's error: {str(result.error)[-4000:]}")
    log(f"[train_fit_actor] {preset} B={batch} T={seq} in a TrainWorker actor: fit "
        f"{out['fit_s']:.2f} s; ms/step over steps {steps - 1}-{steps} in the actor "
        f"{ms_actor:.1f} against the bare loop's {run_a['ms_per_step']:.1f}; the restart "
        f"{out['restart_s'] or 0:.2f} s from the crash to the respawned loop, "
        f"{out['restart_to_step_s'] or 0:.2f} s to its first step; resumed at step "
        f"{out['resumed_from'] + 1}; launches {launches} in the actor's processes {counts}, "
        f"{here} here; a num_gpus=1 actor started {out['card_back_s']:.2f} s after ({smi})")
    if not all(checks.values()):
        raise AssertionError(f"train_fit_actor checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}")
    return out


# ---------------------------------------------------------------------- tune
TUNE_LRS = (1e-4, 1e-5, 1e-6)     # run A's lr (build_llama_trainer's default) first
TUNE_LRS_CARDS = (1e-4, 1e-5, 1e-6, 3e-5)   # four trials, a card each
TUNE_MAX_T = 6                    # ASHA's horizon: iterations of one step, run A's steps
TUNE_ETA = 2                      # ASHA's reduction factor: rungs at 1, 2 and 4


def tune_loop(config, batches=None):
    """A Tune trial (`tune`): run_trainer's build (llama_1b, seeded weights,
    bf16) with the trial's `lr`, one step an iteration on `batches` (the
    host batches, through the store by `with_parameters`). Every report
    carries the step's loss, this process's pid and its launch counts since
    the loop began, the host times around the step and the loop's start;
    the first also the card binding."""
    import torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.llm_step import build_llama_trainer
    loop_start = time.time()
    reset_launch_counts()
    _, _, step, _, dev = build_llama_trainer(config["preset"], config["batch"], config["seq"],
                                             device=config["device"], lr=config["lr"])
    built = time.time()
    for n, batch in enumerate(batches[:config["max_t"]], 1):
        t0 = time.time()
        value = step(torch.tensor(batch, device=dev)).item()   # the store's arrays are read-only
        t1 = time.time()
        tune.report({"loss": value, "step": n, "pid": os.getpid(), "loop_start": loop_start,
                     "built": built, "t0": t0, "t1": t1, "launches": launch_counts(),
                     "binding": card_binding() if n == 1 else None})


def tune_sweep(lrs, device, preset, batch, seq, concurrent, root, tag):
    """One sweep: Tuner over `lrs` (grid_search), each trial tune_loop in a
    `with_resources({"cpu": 1, "gpu": 1})` actor, ASHAScheduler(metric=
    "loss", mode="min", max_t=TUNE_MAX_T, grace_period=1, reduction_factor=
    TUNE_ETA), `concurrent` trials at once. Returns the grid, the sweep's
    seconds and a record a trial (lr, losses, pid, binding, last launches,
    the loop's start, the built model's time, each step's host times)."""
    import chip_smoke
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train.llm_step import host_batches
    batches = host_batches(getattr(LlamaConfig, preset)().vocab_size, batch, seq)[:TUNE_MAX_T]
    trainable = tune.with_resources(tune.with_parameters(chip_smoke.tune_loop, batches=batches),
                                    {"cpu": 1, "gpu": 1})
    t0 = time.time()
    grid = tune.Tuner(
        trainable,
        param_space=dict(lr=tune.grid_search(list(lrs)), preset=preset, batch=batch, seq=seq,
                         device=device, max_t=TUNE_MAX_T),
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=concurrent,
            scheduler=tune.ASHAScheduler(max_t=TUNE_MAX_T, grace_period=1,
                                         reduction_factor=TUNE_ETA)),
        run_config=train.RunConfig(name=tag, storage_path=root)).fit()
    sweep_s = time.time() - t0
    trials = []
    for r in grid:
        h = r.metrics_history
        trials.append(dict(trial_id=r.trial_id, lr=r.config["lr"], error=r.error,
                           losses=[m["loss"] for m in h], steps=[m["step"] for m in h],
                           pids=sorted({m["pid"] for m in h}),
                           binding=h[0]["binding"] if h else None,
                           launches=h[-1]["launches"] if h else None,
                           loop_start=h[0]["loop_start"] if h else None,
                           built=h[0]["built"] if h else None,
                           t0=[m["t0"] for m in h], t1=[m["t1"] for m in h]))
    return grid, t0, sweep_s, trials


def tune_checks(trials, layers, cuda):
    """What every sweep holds: no trial errors; each trial actor's
    CUDA_VISIBLE_DEVICES its get_gpu_ids() and one card seen; B1-B3
    launched 16 x the steps it reported, there, and B4 none."""
    checks = {}
    per = layers if cuda else 0
    checks["no trial errors"] = all(t["error"] is None for t in trials)
    checks[f"B1-B3 launched {layers} x each trial's steps "
           f"{[len(t['losses']) for t in trials]} in its process, B4 none"
           + ("" if cuda else " (0 on the CPU)")] = all(
        t["launches"] is not None
        and all(t["launches"][f] == per * len(t["losses"]) for f in FLASH_NAMES)
        and t["launches"]["paged_decode"] == t["launches"]["paged_decode_combine"] == 0
        for t in trials)
    bindings = [t["binding"] or {} for t in trials]
    checks[f"each trial actor's CUDA_VISIBLE_DEVICES == its get_gpu_ids() "
           f"{[(b.get('cuda_visible_devices'), b.get('gpu_ids')) for b in bindings]}"
           + (", one card seen" if cuda else "")] = all(
        b.get("cuda_visible_devices") == ",".join(map(str, b.get("gpu_ids") or [None]))
        and (b.get("device_count") == 1 or not cuda) for b in bindings)
    return checks


def run_tune(run_a, device="cuda", preset="llama_1b", batch=4, seq=2048):
    """(g) Path `tune`: a Tune sweep in the session of the port's runtime
    (`tune.Tuner(...).fit()`): tune_sweep over TUNE_LRS, one trial at a
    time on the one card. Held: tune_checks; the run A trial's (lr 1e-4)
    losses equal run A's, bit for bit as floats; ASHA stopped at least one
    trial before TUNE_MAX_T, and get_best_result() is the trial with the
    lowest last loss; this process launched no kernel; the card came back
    after the sweep (a num_gpus=1 actor made afterwards starts). Timed: the
    sweep's wall time, each trial's actor start (its loop's start after
    the sweep's start or the previous trial's last step), its build, and
    ms a step in a trial (its last two steps, each with its report)
    against run A's bare loop."""
    import tempfile

    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.models.llama import LlamaConfig

    cuda = torch.device(device).type == "cuda"
    smi = smi_line()
    root = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    out = dict(device=smi, preset=preset, batch=batch, seq=seq, lrs=list(TUNE_LRS),
               max_t=TUNE_MAX_T, reduction_factor=TUNE_ETA)
    own = not rt.is_initialized()
    try:
        if own:
            out["init_s"] = open_session(device)
        if cuda:
            torch.cuda.empty_cache()
        reset_launch_counts()
        grid, start, out["sweep_s"], trials = tune_sweep(TUNE_LRS, device, preset, batch, seq,
                                                         1, root, "tune")
        here = launch_counts()
        t0 = time.perf_counter()
        after = rt.get(rt.remote(num_gpus=1)(Pinger).remote().binding.remote(), timeout=300)
        out["card_back_s"] = time.perf_counter() - t0
        best = grid.get_best_result()
    finally:
        if own:
            out["session_workers"] = close_session("tune")
        shutil.rmtree(root, ignore_errors=True)
    want = [x.item() for x in run_a["losses"]][:TUNE_MAX_T]
    run_a_trial = next(t for t in trials if t["lr"] == TUNE_LRS[0])
    prev_end = start
    for t in sorted(trials, key=lambda t: t["loop_start"] or 0):
        if t["loop_start"] is not None:
            t["actor_start_s"] = t["loop_start"] - prev_end
            t["build_s"] = t["built"] - t["loop_start"]
            prev_end = t["t1"][-1]
        if len(t["t0"]) >= 2:
            t["ms_per_step"] = (t["t1"][-1] - t["t0"][-2]) / 2 * 1e3
    lowest = min(trials, key=lambda t: t["losses"][-1])
    layers = getattr(LlamaConfig, preset)().n_layers
    out.update(trials=trials, launches_here=here, card_after=after, best_lr=best.config["lr"],
               losses_run_a=want, ms_per_step_bare=run_a["ms_per_step"],
               launches={f: sum(t["launches"][f] for t in trials) for f in here},
               removed=not os.path.exists(root))
    checks = tune_checks(trials, layers, cuda)
    checks.update({
        f"the run A trial's losses equal run A's as floats ({len(run_a_trial['losses'])} "
        f"steps)": bool(run_a_trial["losses"])
        and run_a_trial["losses"] == want[:len(run_a_trial["losses"])],
        f"ASHA stopped a trial before max_t={TUNE_MAX_T} "
        f"({[len(t['losses']) for t in trials]})":
            any(len(t["losses"]) < TUNE_MAX_T for t in trials),
        f"get_best_result() (lr {best.config['lr']}) is the lowest last loss's trial "
        f"(lr {lowest['lr']})": best.trial_id == lowest["trial_id"],
        f"this process launched no kernel ({here})": not any(here.values()),
        "the card returned after the sweep: a num_gpus=1 actor started"
        + (" on it" if cuda else ""): bool(after) and (
            not cuda or after["gpu_ids"] == (run_a_trial["binding"] or {}).get("gpu_ids")),
        "run directory removed": out["removed"],
    })
    for what, ok in checks.items():
        log(f"[tune] {'ok  ' if ok else 'FAIL'} {what}")
    for t in trials:
        log(f"[tune] lr {t['lr']:g}: {len(t['losses'])} steps, losses "
            f"{[round(x, 4) for x in t['losses']]}, actor start "
            f"{t.get('actor_start_s', 0):.2f} s (build {t.get('build_s', 0):.2f} s), "
            f"{t.get('ms_per_step', 0):.1f} ms a step; error {str(t['error'])[-2000:]}")
    log(f"[tune] {preset} B={batch} T={seq}, {len(trials)} trials one at a time: sweep "
        f"{out['sweep_s']:.2f} s; ms a step in the run A trial "
        f"{run_a_trial.get('ms_per_step', 0):.1f} against the bare loop's "
        f"{run_a['ms_per_step']:.1f}; best lr {best.config['lr']:g}; launches "
        f"{out['launches']} in the trials' processes, {here} here; a num_gpus=1 actor "
        f"started {out['card_back_s']:.2f} s after ({smi})")
    if not all(checks.values()):
        raise AssertionError(f"tune checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}")
    return out


def run_tune_cards(n, device="cuda", presets=None):
    """Group `tune` of `--cards n`: in a session of the port's runtime that
    counts the n cards, tune_sweep over TUNE_LRS_CARDS one trial at a time
    ("alone"), then the same sweep with n trials at once, a card each.
    Held: tune_checks on both; n distinct get_gpu_ids() at once, the n
    trials' loops overlapping; each trial's losses equal the same trial's
    losses alone over the steps both took (ASHA cuts at other points when
    the trials race). Timed: both sweeps' wall times."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.models.llama import LlamaConfig
    presets = presets or {}
    preset = presets.get("llama", "llama_1b")
    seq, batch = presets.get("tune_seq", 2048), presets.get("tune_batch", 4)
    cuda = device == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_tune_cards_")
    lrs = TUNE_LRS_CARDS[:n]
    t0 = time.perf_counter()
    rt.init(num_cpus=4 * n, num_gpus=None if cuda else n)
    try:
        _, _, alone_s, alone = tune_sweep(lrs, device, preset, batch, seq, 1, root, "alone")
        _, _, together_s, together = tune_sweep(lrs, device, preset, batch, seq, n, root,
                                                "together")
    finally:
        workers, left = stop_runtime(rt)
        shutil.rmtree(root, ignore_errors=True)
    layers = getattr(LlamaConfig, preset)().n_layers
    by_lr = {t["lr"]: t for t in alone}
    ids = [tuple((t["binding"] or {}).get("gpu_ids") or ()) for t in together]
    checks = {f"alone: {k}": v for k, v in tune_checks(alone, layers, cuda).items()}
    checks.update({f"together: {k}": v
                   for k, v in tune_checks(together, layers, cuda).items()})
    common = {t["lr"]: min(len(t["losses"]), len(by_lr[t["lr"]]["losses"])) for t in together}
    checks.update({
        f"{n} distinct get_gpu_ids() at once ({ids})": len(set(ids)) == n == len(together),
        f"the {n} trials' loops overlapped": max(t["loop_start"] for t in together)
        < min(t["t1"][-1] for t in together),
        f"each trial's losses equal its losses alone over {list(common.values())} steps":
            all(c > 0 and t["losses"][:c] == by_lr[t["lr"]]["losses"][:c]
                for t, c in zip(together, common.values())),
        f"every worker exited after shutdown() ({workers} workers)": not left,
    })
    for what, ok in checks.items():
        log(f"[cards tune] {'ok  ' if ok else 'FAIL'} {what}")
    res = dict(lrs=list(lrs), alone_s=alone_s, together_s=together_s, alone=alone,
               together=together, seconds=time.perf_counter() - t0)
    log(f"[cards tune] {preset} B={batch} T={seq}: {n} trials one at a time "
        f"{alone_s:.2f} s, {n} at once {together_s:.2f} s "
        f"({alone_s / together_s:.2f}x); steps alone {[len(t['losses']) for t in alone]}, "
        f"at once {[len(t['losses']) for t in together]}; the group took "
        f"{res['seconds']:.1f} s" + (f" ({smi_line()})" if cuda else ""))
    if not all(checks.values()):
        raise AssertionError(f"cards tune checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}")
    return res


CKPT_WHOLE_FROM = {"fsdp": 4}              # the mesh the ranks write on
CKPT_WHOLE_ONTO = {"fsdp": 2, "tp": 2}     # the mesh they restore onto
CKPT_WHOLE_TOKENS = 16                     # greedy tokens a prompt, both servers


class RssPeak:
    """Samples this process's resident set (/proc/self/statm) every `every`
    seconds on a thread between start() and stop(); `peak` and `base` in
    bytes."""

    def __init__(self, every=0.005):
        import threading
        self.every, self.base, self.peak = every, 0, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self.rss())
            self._stop.wait(self.every)

    def start(self):
        self.base = self.peak = self.rss()
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())
        return self.peak


def _bare_trainer(preset, seq, mesh, device, param_dtype="bfloat16"):
    """`preset`'s shard-local model on `mesh` and its AdamW, as
    build_llama_trainer makes them, with no weight drawn."""
    import torch
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.ops.optim import make_optimizer
    cfg = getattr(LlamaConfig, preset)(max_seq_len=seq,
                                       param_dtype=getattr(torch, param_dtype))
    model = Llama(cfg, device=device, mesh=mesh)
    opt, _ = make_optimizer(model.parameters(), lr=1e-4, optimizer="adamw", weight_decay=1e-4)
    return model, opt


def _meta_state(preset, seq, mesh, param_dtype="bfloat16"):
    """(state, specs) of train_state on the meta device: the target specs
    of a restore onto `mesh`."""
    from ray_tpu_torch.train.llm_step import train_state
    return train_state(*_bare_trainer(preset, seq, mesh, "meta", param_dtype))


def _ckpt_whole_rank(rank, world, store, results, root, preset, seq):
    """A gloo rank of `ckpt_whole` (CPU tensors): `preset`'s shard-local
    model on CKPT_WHOLE_FROM with its blocks of the seeded bf16 weights in
    `root`/seeded.pt, AdamW's state from one optimizer step at lr 0 on
    seeded gradients (real moments; the weights stay the seed's; a CPU
    training step of llama_1b on 4 gloo ranks would take most of a
    minute), written sharded with train_state's specs; then restored onto
    CKPT_WHOLE_ONTO with its specs, every block and moment held to the
    whole read's block under that mesh."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        from ray_tpu_torch.models.convert import shard_state_dict
        from ray_tpu_torch.parallel.mesh import make_mesh
        from ray_tpu_torch.parallel.sharding import local_slice
        from ray_tpu_torch.train import Checkpoint
        from ray_tpu_torch.train.llm_step import train_state
        _tp_rank_world(rank, world, store, "gloo", None)
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
        mesh = make_mesh(CKPT_WHOLE_FROM, device="cpu")
        t0 = time.perf_counter()
        model, opt = _bare_trainer(preset, seq, mesh, "cpu")
        seeded = torch.load(os.path.join(root, "seeded.pt"), map_location="cpu",
                            weights_only=True, mmap=True)
        model.load_state_dict(shard_state_dict(seeded, mesh))
        del seeded
        build_s = time.perf_counter() - t0

        def lr_zero(optim, args, kwargs):   # after make_optimizer's hook sets the rate
            for group in optim.param_groups:
                group["lr"] = 0.0

        opt.register_step_pre_hook(lr_zero)
        draw = torch.Generator().manual_seed(1000 + rank)
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=draw).to(p.dtype)
        opt.step()
        state, specs = train_state(model, opt, step=1)
        path = os.path.join(root, "ck")
        t0 = time.perf_counter()
        Checkpoint.from_state(state, path=path, mesh=mesh, specs=specs)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, "shards", f"rank-{rank:05d}.pt"))
        del model, opt, state
        other = make_mesh(CKPT_WHOLE_ONTO, device="cpu")
        target, tspecs = _meta_state(preset, seq, other)
        ckpt = Checkpoint.from_directory(path)
        t0 = time.perf_counter()
        got = ckpt.to_state(mesh=other, specs=tspecs)
        reshard_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole = ckpt.to_state()
        whole_s = time.perf_counter() - t0
        # the saved dtypes come back: bf16 weights and moments, f32 norm scales
        want = shard_state_dict(whole["model"], other)
        bad = [k for k, v in got["model"].items()
               if (v.dtype, v.shape) != (target["model"][k].dtype, target["model"][k].shape)
               or not torch.equal(v, want[k])]
        dtypes = [p.dtype for p in target["model"].values()]
        for i, spec in tspecs["optim"]["state"].items():
            for name in ("exp_avg", "exp_avg_sq"):
                g, w = got["optim"]["state"][i][name], whole["optim"]["state"][i][name]
                if g.dtype != dtypes[i] or not torch.equal(g, local_slice(w, spec[name], other)):
                    bad.append(f"optim {i} {name}")
        value = dict(bytes=nbytes, build_s=build_s, save_s=save_s,
                     reshard_s=reshard_s, whole_s=whole_s, bad=bad,
                     leaves=len(got["model"]) + 2 * len(got["optim"]["state"]),
                     moments_nonzero=bool(any(s["exp_avg_sq"].abs().sum() > 0
                                              for s in got["optim"]["state"].values())))
        del got, whole, want
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, value, None))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, None, traceback.format_exc()))


def run_ckpt_whole(device="cuda", preset="llama_1b", seq=16, world=4):
    """Path `ckpt_whole`: a sharded checkpoint read whole and onto another
    mesh. `world` gloo ranks on CPU tensors (spawn_ranks) write `preset`'s
    seeded bf16 weights and AdamW state on CKPT_WHOLE_FROM
    (`_ckpt_whole_rank`) and restore it onto CKPT_WHOLE_ONTO: each rank's
    blocks torch.equal the whole's blocks there. The seed's whole weights
    are drawn here (init_params on `device`) and reach the ranks through a
    torch.save file, each rank loading its blocks. Then this process reads
    the checkpoint whole with to_state() (its peak host RSS sampled during
    the read), every weight torch.equal to the seed's, and serves it:
    LLMServer(params=whole["model"]) on `device` gives the greedy ids of a
    server built from the seed's whole weights on the slice's prompts,
    with B1 and B4 counted on the first server. The checkpoint lives in a
    temporary directory removed at the end."""
    import gc
    import tempfile
    import torch
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.train import Checkpoint

    tag = "ckpt_whole"
    cfg = getattr(LlamaConfig, preset)(max_seq_len=seq, param_dtype=torch.bfloat16)
    root = tempfile.mkdtemp(prefix="chip_smoke_whole_")
    try:
        model = Llama(cfg, device=device)
        init_params(model, torch.Generator(device=device).manual_seed(0))
        ref = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
        del model
        torch.save(ref, os.path.join(root, "seeded.pt"))
        t0 = time.perf_counter()
        ranks = spawn_ranks(_ckpt_whole_rank, world, (root, preset, seq))
        ranks_s = time.perf_counter() - t0
        rss = RssPeak().start()
        t0 = time.perf_counter()
        whole = Checkpoint.from_directory(os.path.join(root, "ck")).to_state()
        read_s = time.perf_counter() - t0
        rss.stop()
        unequal = [k for k, v in whole["model"].items()
                   if k not in ref or v.dtype != ref[k].dtype or not torch.equal(v, ref[k])]
        weights_equal = whole["model"].keys() == ref.keys() and not unequal
        state_bytes = sum(t.numel() * t.element_size() for t in whole["model"].values()) + sum(
            t.numel() * t.element_size() for s in whole["optim"]["state"].values()
            for t in s.values())
        gen = lambda srv, p: asyncio.run(srv.generate(p, max_tokens=CKPT_WHOLE_TOKENS))["tokens"]
        wave1, wave2 = slice_prompts(cfg.vocab_size)
        prompts = wave1 + wave2
        served = LLMServer(serving_config(preset, device), params=whole["model"])
        del whole
        gc.collect()
        gen(served, list(range(1, 50)))              # warm-up
        before = served.stats()
        reset_launch_counts()
        got = [gen(served, p) for p in prompts]
        launches = launch_counts()
        after = served.stats()
        n_split = n_split_of(served, device)
        del served
        gc.collect()
        plain = LLMServer(serving_config(preset, device), params=ref)
        want = [gen(plain, p) for p in prompts]
        del plain, ref
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tokens, syncs, _, steps = decode_delta(after, before)
    fresh = after["prefill"]["chunk_local"] - before["prefill"]["chunk_local"]
    checks = {
        f"{world} ranks: every block and AdamW moment on {CKPT_WHOLE_ONTO} torch.equal the "
        f"whole's block there, bf16 kept ({ranks[0]['leaves']} leaves a rank)":
            all(not r["bad"] for r in ranks),
        "AdamW's moments were written (a step taken)": all(r["moments_nonzero"] for r in ranks),
        "the whole read's weights torch.equal the seed's whole weights, in their dtypes":
            weights_equal,
        f"greedy ids of the server built from the whole read == the seed's server's "
        f"({len(prompts)} prompts x {CKPT_WHOLE_TOKENS} tokens)": got == want,
        "the directory is removed": not os.path.exists(root),
    }
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed: {[r['bad'][:4] for r in ranks]}, "
                             f"weights unequal {unequal[:4]}, ids {got} vs {want}")
    launch_checks(tag, launches, cfg.n_layers, fresh, steps, n_split)
    out = dict(ranks=ranks, ranks_s=ranks_s, read_whole_s=read_s, state_bytes=state_bytes,
               rss_base_bytes=rss.base, rss_peak_bytes=rss.peak,
               rss_growth_bytes=rss.peak - rss.base, launches=launches,
               fresh_first_chunks=fresh, decode_steps=steps, prompts=len(prompts))
    log(f"[{tag}] {preset} bf16 on {CKPT_WHOLE_FROM} ({world} gloo ranks, CPU; AdamW stepped "
        f"at lr 0 on seeded gradients): build s {[round(r['build_s'], 1) for r in ranks]}, "
        f"bytes a rank {[r['bytes'] for r in ranks]}, save s "
        f"{[round(r['save_s'], 2) for r in ranks]}; reshard onto {CKPT_WHOLE_ONTO} s "
        f"{[round(r['reshard_s'], 2) for r in ranks]}; whole read on a rank s "
        f"{[round(r['whole_s'], 2) for r in ranks]}; the ranks took {ranks_s:.1f} s. This "
        f"process read {state_bytes / 2**30:.2f} GiB whole in {read_s:.2f} s, host RSS "
        f"{rss.base / 2**30:.2f} -> peak {rss.peak / 2**30:.2f} GiB during the read; served "
        f"on {device}: ids equal, launches {launches} ({smi_line()})")
    return out


# ------------------------------------------------------------------ mesh
# The device mesh, the sharding rules and the mesh collectives (paths
# `serve_tp` and, with four cards, `moe_ep`). The default run has one card:
# world 1 on NCCL. `--cards 4` runs the multi-card phases, one rank per card
# on NCCL.
def layer_elements():
    """One llama_1b layer's parameter count (45,092,864)."""
    from ray_tpu_torch.models.llama import LlamaConfig, llama_param_count
    return (llama_param_count(LlamaConfig.llama_1b(n_layers=2))
            - llama_param_count(LlamaConfig.llama_1b(n_layers=1)))


def xla_op_table(mesh, axis, x):
    """name -> fn() running each xla_ops op over `axis` on this rank's x."""
    from ray_tpu_torch.parallel import xla_ops as xo
    return {
        "psum": lambda: xo.psum(x, axis, mesh),
        "pmean": lambda: xo.pmean(x, axis, mesh),
        "pmax": lambda: xo.pmax(x, axis, mesh),
        "all_gather": lambda: xo.all_gather(x, axis, mesh),
        "reduce_scatter": lambda: xo.reduce_scatter(x, axis, mesh),
        "ppermute_shift": lambda: xo.ppermute_shift(x, axis, mesh, 1),
        "all_to_all": lambda: xo.all_to_all(x, axis, mesh, 0, 0),
    }


# NCCL-tests' bus bandwidth: the algorithm rate (bytes / time) times what a
# rank must move of it, for n ranks; the bytes are the input's, the
# output's for all_gather
BUS_FACTOR = {"psum": lambda n: 2 * (n - 1) / n, "pmean": lambda n: 2 * (n - 1) / n,
              "pmax": lambda n: 2 * (n - 1) / n, "all_gather": lambda n: (n - 1) / n,
              "reduce_scatter": lambda n: (n - 1) / n, "all_to_all": lambda n: (n - 1) / n,
              "ppermute_shift": lambda n: 1.0}


def xla_ops_world(mesh, axis, n_elems, device, tag):
    """Each xla_ops op over `axis` (n ranks) on n_elems bf16 elements, rank r
    holding the value r + 1 everywhere, so every result is exact: psum
    n(n+1)/2, pmean its 1/n, pmax n, the gathered blocks 1..n, rank r's
    reduced block n(n+1)/2, the shifted block r (mod n) + ..., the
    exchanged blocks 1..n. Returns {op: dict(equal, ms, bus_gb_s)} on every
    rank (times are this rank's CUDA-event readings)."""
    import torch
    from ray_tpu_torch.parallel import xla_ops as xo
    n = xo.axis_size(axis, mesh)
    r = xo.axis_index(axis, mesh)
    x = torch.full((n_elems,), float(r + 1), dtype=torch.bfloat16, device=device)
    blocks = torch.arange(1, n + 1, dtype=torch.bfloat16, device=device)
    per = n_elems // n
    total = n * (n + 1) / 2
    want = {"psum": torch.full_like(x, total), "pmean": torch.full_like(x, total / n),
            "pmax": torch.full_like(x, float(n)),
            "all_gather": blocks.repeat_interleave(n_elems),
            "reduce_scatter": torch.full((per,), total, dtype=x.dtype, device=device),
            "ppermute_shift": torch.full_like(x, float((r - 1) % n + 1)),
            "all_to_all": blocks.repeat_interleave(per)}
    out = {}
    for name, fn in xla_op_table(mesh, axis, x).items():
        res = dict(equal=bool(torch.equal(fn(), want[name])))
        if device.type == "cuda":
            ms = op_ms(fn)
            moved = x.numel() * x.element_size() * (n if name == "all_gather" else 1)
            # one rank moves nothing to another: no bus bandwidth
            res.update(ms=ms, bus_gb_s=(moved / (ms / 1e3) * BUS_FACTOR[name](n) / 1e9
                                        if n > 1 else None))
        out[name] = res
    ok = all(v["equal"] for v in out.values())
    if r == 0:
        for name, v in out.items():
            t = (f": {v['ms']:.4f} ms" if "ms" in v else "")
            t += f", bus {v['bus_gb_s']:.1f} GB/s" if v.get("bus_gb_s") else ""
            log(f"[{tag}] xla_ops.{name} over {axis}={n}, bf16 x {n_elems}{t}, exact "
                f"{v['equal']}")
    if not ok:
        raise AssertionError(f"{tag}: xla_ops results wrong: {out}")
    return out


def greedy_dense(model, cfg, prompt, steps):
    """Prefill `prompt` [1, T] into a dense cache, then `steps` greedy
    [1, 1] steps, as LLMServer's _prefill_row and _decode_chunk call the
    model; the logits of every call."""
    import torch
    from ray_tpu_torch.models.llama import KVCache
    kv_heads = cfg.n_kv_heads // (model.place.tp if model.place else 1)
    cache = KVCache.init(dataclasses.replace(cfg, n_kv_heads=kv_heads), 1,
                         prompt.shape[1] + steps, device=prompt.device)
    out, tok = [], prompt
    with torch.no_grad():
        for _ in range(steps + 1):
            logits, cache = model(tok, cache=cache)
            out.append(logits)
            tok = logits[:, -1:].argmax(-1)
    return out


def check_mesh_world1(device="cuda", preset="llama_1b"):
    """World 1 over NCCL (gloo on the CPU): make_mesh and auto_mesh; shard_tree
    of the preset's seeded bf16 state_dict from the host over a
    {"dp", "fsdp", "tp"} mesh of ones (every block torch.equal to the whole);
    serve_tp's model at world 1 (the shard-local model on {"tp": 1}, its
    collectives through the world's backend, a dense-cache prefill and 8
    greedy steps with logits torch.equal to the plain model's, no kernel
    launched); each xla_ops op on one layer's bf16 elements (each result
    equal to its input, each timed);
    iter_device_batches(sharding=data_sharding(mesh)) yielding DTensors
    equal to the host batches. Takes the world down."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.convert import init_params, shard_state_dict
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.parallel import mesh as pmesh
    from ray_tpu_torch.parallel.sharding import data_sharding, llama_rules, shard_tree
    from ray_tpu_torch.train.ingest import iter_device_batches

    dev = torch.device(device) if device == "cpu" else torch.device("cuda", 0)
    if dist.is_initialized():
        raise AssertionError("a process group is already up before the mesh phase")
    m1 = pmesh.make_mesh({"tp": 1}, device=device)
    auto = pmesh.auto_mesh(device=device)
    mesh = pmesh.make_mesh({"tp": 1, "fsdp": 1, "dp": -1}, device=device)
    backend = dist.get_backend()
    shapes = {"make_mesh": pmesh.axis_sizes(m1), "auto_mesh": pmesh.axis_sizes(auto),
              "mesh": pmesh.axis_sizes(mesh)}
    log(f"[mesh] world {dist.get_world_size()} on {backend}: {shapes}")

    cfg = getattr(LlamaConfig, preset)(param_dtype=torch.bfloat16)
    model = init_params(Llama(cfg, device=dev), torch.Generator(device=dev).manual_seed(0))
    whole = {k: v.detach() for k, v in model.state_dict().items()}
    host = {k: v.cpu() for k, v in whole.items()}
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    placed = shard_tree(host, mesh, llama_rules())
    sync()
    shard_s = time.perf_counter() - t0
    equal = all(torch.equal(placed[k].to_local(), whole[k]) for k in whole)
    on_dev = all(placed[k].to_local().device == dev for k in whole)
    n_bytes = sum(v.numel() * v.element_size() for v in host.values())
    log(f"[mesh] shard_tree of {preset}'s state_dict ({len(host)} tensors, {n_bytes:,} bytes) "
        f"from the host in {shard_s:.3f} s: every block equal to the whole {equal}, on "
        f"{dev} {on_dev}")

    local = Llama(cfg, device=dev, mesh=m1)
    local.load_state_dict(shard_state_dict(host, m1))
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 64))).to(dev)
    want = greedy_dense(model, cfg, prompt, 8)
    reset_launch_counts()
    got = greedy_dense(local, cfg, prompt, 8)
    tp_launches = launch_counts()
    tp_equal = all(torch.equal(a, b) for a, b in zip(want, got))
    tp_diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(want, got))
    log(f"[mesh] serve_tp at world 1: the shard-local {preset} on {{'tp': 1}} over {backend}, "
        f"a 64-token prefill and 8 greedy steps on the dense cache: logits equal to the plain "
        f"model's {tp_equal} (max |diff| {tp_diff:.3e}), launches {tp_launches}")
    serve_tp = dict(logits_equal=tp_equal, max_abs_diff=tp_diff, launches=tp_launches)
    del model, whole, host, placed, local

    n = layer_elements()
    ops = xla_ops_world(mesh, "tp", n, dev, "mesh")
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 2048), dtype=np.int32)}
               for _ in range(3)]
    got = list(iter_device_batches(iter(batches), sharding=data_sharding(mesh)))
    feed_ok = len(got) == 3 and all(
        torch.equal(g["tokens"].full_tensor().cpu(), torch.from_numpy(b["tokens"]))
        and g["tokens"].to_local().device == dev for g, b in zip(got, batches))
    log(f"[mesh] iter_device_batches(sharding=data_sharding(mesh)): 3 DTensor batches "
        f"equal to the host batches {feed_ok}, placements {got[0]['tokens'].placements}")
    checks = {"meshes of size 1 on the expected axes": shapes == {
                  "make_mesh": {"tp": 1}, "auto_mesh": {"dp": 1},
                  "mesh": {"dp": 1, "fsdp": 1, "tp": 1}},
              f"backend {backend}": backend == ("nccl" if dev.type == "cuda" else "gloo"),
              "shard_tree blocks equal the whole, on the device": equal and on_dev,
              "serve_tp's shard-local model at world 1 equals the plain model": tp_equal,
              "serve_tp at world 1 launched no kernel": not any(tp_launches.values()),
              "sharded feed equal to the host batches": feed_ok}
    for what, ok in checks.items():
        log(f"[mesh] {'ok  ' if ok else 'FAIL'} {what}")
    dist.destroy_process_group()
    if not all(checks.values()):
        raise AssertionError(f"mesh world-1 checks failed: {checks}")
    return dict(backend=backend, shapes=shapes, shard_tree_s=shard_s,
                shard_tree_bytes=n_bytes, serve_tp_world1=serve_tp, xla_ops=ops, elements=n)


def tp_server_config(preset, tp, dtype, device, **kw):
    """The slice's engine settings on the dense cache (tp needs it)."""
    cfg = dict(preset=preset, paged=False, max_batch_slots=8, max_seq_len=2048,
               prefill_chunk=128, decode_chunk=8, device=device, seed=0, tp=tp,
               param_dtype=dtype, dtype=dtype)
    cfg.update(kw)
    return cfg


def serve_waves(server, prompts, max_tokens=32, capture=False):
    """Rank 0 of a server: the slice's two waves (8 prompts, then 2) after a
    warm-up request; ids, TTFT p50, decode tokens/s and host syncs a token
    over the waves, and (capture=True) the first prefill's last-row logits."""
    import torch
    first = []
    if capture:
        real = server._prefill_row

        def keep(*a):
            row = real(*a)
            if not first:
                first.append(row.detach().float().cpu())
            return row
        server._prefill_row = keep
    asyncio.run(serve_wave(server, [list(range(1, 50))], 8))
    first.clear()
    before = server.stats()
    t0 = time.perf_counter()
    res = asyncio.run(serve_wave(server, prompts[:8], max_tokens))
    res += asyncio.run(serve_wave(server, prompts[8:], max_tokens))
    if server.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens, syncs, decode_s, steps = decode_delta(server.stats(), before)
    if capture:
        server._prefill_row = real
    return dict(ids=[r[0] for r in res], ttft_p50_s=float(np.median([r[1] for r in res])),
                stats=server.stats(),
                decode_tokens=tokens, decode_s=decode_s, decode_steps=steps,
                decode_tokens_per_s=tokens / decode_s if decode_s else None,
                host_syncs_per_token=syncs / tokens if tokens else None, wall_s=wall,
                first_logits=first[0] if first else None)


# a greedy id may differ between two servers only where the reference's
# top-2 logit gap is under this share of the row's max |logit|
NEAR_TIE = 1e-4


def near_tie(model, prompt, ids, j, device):
    """The tp=1 model's top-2 logit gap at generated position j (after
    prompt + ids[:j]) over the row's max |logit|, and whether it is under
    NEAR_TIE."""
    import torch
    toks = torch.tensor([list(prompt) + list(ids[:j])], device=device)
    with torch.no_grad():
        row = model(toks)[0][0, -1].float()
    top = row.topk(2).values
    gap = float((top[0] - top[1]) / row.abs().max())
    return gap, gap < NEAR_TIE


def compare_ids(tag, ref_server, prompts, want, got, device):
    """Greedy ids of two servers, request by request. A request may differ
    only from a position where the tp=1 server's top-2 logit gap is under
    1e-4 of the row's max |logit| (a near-tie, logged). Raises otherwise."""
    ties = []
    for i, (p, a, b) in enumerate(zip(prompts, want, got)):
        if a == b:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        gap, ok = near_tie(ref_server.model, p, a, j, device)
        ties.append(dict(request=i, position=j, gap=gap, near_tie=ok))
        log(f"[{tag}] request {i} differs from position {j}: tp=1 top-2 gap {gap:.3e} of max "
            f"|logit| ({'near-tie' if ok else 'NOT a near-tie'})")
        if not ok:
            raise AssertionError(f"{tag}: request {i} ids differ at {j} without a near-tie")
    equal = sum(a == b for a, b in zip(want, got))
    log(f"[{tag}] greedy ids equal for {equal} of {len(want)} requests; near-ties {len(ties)}")
    return dict(equal=equal, requests=len(want), near_ties=ties)


def _tp_rank_world(rank, world, store, backend, device_index):
    """A spawned rank's world: its card, the process group (its timeout
    ends a collective whose peer is gone), TF32 off for the f32 checks."""
    import datetime
    import torch
    import torch.distributed as dist
    if device_index is not None:
        torch.cuda.set_device(device_index)
    dist.init_process_group(backend, init_method=store, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=900))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# the four-card phases' limit, inside the call's (the default presets
# take about 100 s of it)
CARDS_TIMEOUT_S = 1300


def spawn_ranks(target, world, args):
    """target(rank, world, store, results, *args) in `world` spawned
    processes over a file store in a temporary directory; returns the
    results in rank order, raising any rank's error or a silence of
    CARDS_TIMEOUT_S. Every process is gone when it returns."""
    import multiprocessing as mp
    import queue
    import tempfile

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{tmp}/store"
        procs = [ctx.Process(target=target, args=(r, world, store, results) + tuple(args))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, errors = {}, []
        deadline = time.monotonic() + CARDS_TIMEOUT_S
        try:
            while len(out) < world and not errors:
                try:
                    rank, value, err = results.get(timeout=5)
                except queue.Empty:
                    # a rank that died without a word (a crash) ends the run
                    dead = [r for r, p in enumerate(procs) if r not in out
                            and p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"ranks {dead} exited without a result (exit codes "
                                      f"{[procs[r].exitcode for r in dead]})")
                    elif time.monotonic() > deadline:
                        errors.append(f"ranks {sorted(set(range(world)) - set(out))} gave "
                                      f"no result in {CARDS_TIMEOUT_S} s")
                    continue
                out[rank] = value
                if err:
                    errors.append(f"rank {rank}:\n{err}")
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if errors:
        raise AssertionError("\n".join(errors))
    return [out[r] for r in range(world)]


def run_mesh(device="cuda", preset="llama_1b"):
    """The `mesh` phase: world 1 on the one card."""
    out = check_mesh_world1(device, preset)
    out["launches"] = out["serve_tp_world1"]["launches"]
    return out


FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the 8B's attention shapes a card: fsdp (one row a card) and tp=2's heads
LLAMA_8B_SHAPES = ((1, 2048, 32, 8, 128), (1, 2048, 16, 4, 128))


def run_train_mesh(device="cuda", preset="llama_1b", batch=4, seq=2048, steps=3):
    """Path `train_mesh`: the mesh training step at world 1. build_llama_trainer
    on a {"dp": 1, "fsdp": 1, "tp": 1} mesh over NCCL (gloo on the CPU), its
    batch through iter_device_batches(sharding=data_sharding(mesh)), `steps`
    steps from the seeded weights, against the plain step's (no mesh) on
    the same weights and batches: losses and every param torch.equal, and
    B1, B2 and B3 launched as often. Then B1, B2 and B3 at the 8B's shapes
    (LLAMA_8B_SHAPES) against their plain versions, timed. Takes the world
    down."""
    import gc
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import data_sharding
    from ray_tpu_torch.train import iter_device_batches
    from ray_tpu_torch.train.llm_step import build_llama_trainer

    def run(mesh=None):
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        model, _, step, batches, dev = build_llama_trainer(preset, batch, seq, device=device,
                                                           mesh=mesh)
        feed = (iter_device_batches(batches[:steps], sharding=data_sharding(mesh)) if mesh
                else (torch.from_numpy(b).to(dev) for b in batches[:steps]))
        reset_flash_counts()
        losses = [step(t) for t in feed]
        launches = dict(zip(FLASH_NAMES, flash_counts()))
        return losses, snapshot(model), launches

    if dist.is_initialized():
        raise AssertionError("a process group is already up before the train_mesh phase")
    plain_losses, plain_params, plain_launches = run()
    mesh = make_mesh({"dp": 1, "fsdp": 1, "tp": 1}, device=device)
    backend = dist.get_backend()
    losses, params, launches = run(mesh)
    dist.destroy_process_group()
    equal = lambda xs, ys: len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))
    layers = 16 if preset == "llama_1b" else None
    checks = {
        f"losses torch.equal the plain step's over {steps} steps": equal(losses, plain_losses),
        "every param torch.equal the plain step's": equal_trees(params, plain_params),
        f"B1, B2, B3 launched as in the plain step ({plain_launches})":
            launches == plain_launches,
        f"backend {backend}": backend == ("nccl" if device == "cuda" else "gloo"),
    }
    if device == "cuda" and layers:
        checks[f"B1, B2, B3 each launched {layers} x {steps}"] = all(
            c == layers * steps for c in launches.values())
    for what, ok in checks.items():
        log(f"[train_mesh] {'ok  ' if ok else 'FAIL'} {what}")
    log(f"[train_mesh] {preset} B={batch} T={seq} on {{'dp': 1, 'fsdp': 1, 'tp': 1}} over "
        f"{backend}: losses {[round(x.item(), 5) for x in losses]}, launches {launches}")
    if not all(checks.values()):
        raise AssertionError(f"train_mesh checks failed: {checks}")
    del params, plain_params
    out = dict(backend=backend, losses=[x.item() for x in losses], launches=launches,
               plain_launches=plain_launches, checks=checks)
    if device == "cuda":
        rng = np.random.default_rng(128)
        out["kernels_8b_shapes"] = {
            f"B={b} T={t} H={h} Kh={kh} D={d}": time_flash_shape(rng, out.setdefault(
                "cases", []), b, t, h, kh, d) for b, t, h, kh, d in LLAMA_8B_SHAPES}
    return out


# --------------------------------------------------------------- seqpipe
# The ring Llama against a witness: the same weights widened to f32 with
# attn_impl="flash" on the whole sequence (the f32 kernels, remat). Each
# reading is the summed CE loss's relative error, the logits' max |error|
# over max |logit|, and the worst parameter's ||error|| / ||grad|| of the
# sp-psum'd gradients (its max |error| over max |grad| is logged). In f32
# the witness holds the ring's arithmetic. In bf16 each limit sits between
# the sound ring and a planted fault it must reject: llama_1b, T=2048, on
# an NVIDIA H100 80GB HBM3 (700 W) read loss 4.3e-5, logits 2.4e-2, grads
# 4.0e-2 for the ring (the bf16 flash model 2.3e-5, 2.6e-2, 4.0e-2: both
# bf16 paths lie as far from f32), and 3.8e-4, 9.5e-1, 7.7e-1 for the
# causal diagonal one key right (`see_next`). Scores rounded to bf16 read
# as the sound ring: no model-level limit can see that fault; the flash
# kernel's own check holds its scores in f32.
RING_TOL = {"bfloat16": {"loss": 1.2e-4, "logits": 5e-2, "grads": 1e-1},
            "float32": {"loss": 1e-5, "logits": 1e-4, "grads": 1e-4}}
# faults planted in ops/ring_attention.py for the bf16 control runs (see
# ring_control), and whether the limits must reject each (any reading over)
RING_CONTROLS = {"bf16_scores": False, "see_next": True, "drop_block": True}
PIPE_TOL = 1e-5         # pipelines against the whole model, f32, relative


def worst_rel(got, want, err=None):
    """The largest err(got, want) (rel_err: max |got - want| / max |want|)
    over matching tensors of two dicts, and its key."""
    errs = {k: (err or rel_err)(got[k], w) for k, w in want.items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def l2_rel_err(got, want):
    """||got - want|| / ||want||, in f32."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def ring_readings(got, want):
    """The readings of `got` against `want` (each a dict of loss, logits and
    grads): loss, logits and grads (L2) as RING_TOL names them, the worst
    parameter, and the worst max |error| over max |grad|."""
    grads, worst = worst_rel(got["grads"], want["grads"], l2_rel_err)
    grads_max, worst_max = worst_rel(got["grads"], want["grads"])
    return dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                logits=rel_err(got["logits"], want["logits"]), grads=grads,
                grads_worst=worst, grads_max=grads_max, grads_max_worst=worst_max)


def over_tol(readings, tol):
    """The readings that exceed their limits."""
    return [k for k in tol if readings[k] > tol[k]]


def fmt_readings(r):
    return (f"loss {r['loss']:.3e}, logits {r['logits']:.3e}, grads {r['grads']:.3e} "
            f"({r['grads_worst']}; max {r['grads_max']:.3e})")


@contextlib.contextmanager
def ring_control(name, sp):
    """A fault planted in ray_tpu_torch.ops.ring_attention for one control
    run, forward and backward alike: "bf16_scores" rounds every score to
    bf16 before the softmax (the port keeps them in f32, as JAX does);
    "see_next" moves the causal diagonal one key right, so that each query
    also sees the next token; "drop_block" (sp > 1) makes the ring's last
    rank skip the block from its first."""
    import importlib
    # the module, not the function that ray_tpu_torch.ops exports by its name
    ra = importlib.import_module("ray_tpu_torch.ops.ring_attention")
    scores, masked = ra._scores, ra._masked_out
    patch = {
        "bf16_scores": dict(_scores=lambda *a: scores(*a).bfloat16().float()),
        "see_next": dict(_scores=lambda q, k, scale, row, col, causal:
                         scores(q, k, scale, row + 1, col, causal)),
        "drop_block": dict(_masked_out=lambda causal, src, rank:
                           masked(causal, src, rank) or (src == 0 and rank == sp - 1)),
    }[name]
    for k, f in patch.items():
        setattr(ra, k, f)
    try:
        yield
    finally:
        ra._scores, ra._masked_out = scores, masked


def llama_outputs(model, tokens, labels, positions=None):
    """A summed CE loss's forward and backward: dict(loss, logits, grads)."""
    import torch.nn.functional as F
    model.zero_grad(set_to_none=True)
    logits = model(tokens, positions)[0]
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                           reduction="sum")
    loss.backward()
    return dict(loss=loss.detach(), logits=logits.detach(),
                grads={k: p.grad for k, p in model.named_parameters()})


def check_ring(mesh, dev, preset, dtype, b, t, overrides=None, timed=False, tag="seqpipe"):
    """Path `ring`: the shard-local Llama with attn_impl="ring" on `mesh`'s
    sp axis (weights from seed 0, broadcast from the axis's first rank),
    its [B, T] batch placed with iter_device_batches(sharding=
    data_sharding(mesh, True)) and global positions: the summed CE loss,
    the logits (gathered over sp) and the sp-psum'd parameter gradients
    against the witness (the same weights in f32 with attn_impl="flash" on
    the whole sequence, on the lead rank), within RING_TOL. In bf16 also
    the ring against the plain model with attn_impl="flash" in bf16 within
    RING_TOL, that model against the witness (logged), and each control
    of RING_CONTROLS against the witness: one the limits must reject that
    they pass fails the check. No
    hand kernel may launch on the ring path (on the card). With `timed`:
    the ms of a forward and of a forward + backward, the peak memory a
    card and the ms of one K/V shift. Every rank of the mesh calls it;
    the lead rank returns the readings."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.parallel import xla_ops
    from ray_tpu_torch.parallel.sharding import data_sharding
    from ray_tpu_torch.train.ingest import iter_device_batches

    dt = getattr(torch, dtype)
    sp, r = xla_ops.axis_size("sp", mesh), xla_ops.axis_index("sp", mesh)
    lead = dist.get_rank() == 0
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    cfg = getattr(LlamaConfig, preset)(**dict(overrides or {}, attn_impl="ring", dtype=dt,
                                              param_dtype=dt))
    model = init_params(Llama(cfg, device=dev, mesh=mesh),
                        torch.Generator(device=dev).manual_seed(0))
    group = mesh.get_group("sp")
    for p in model.parameters():
        dist.broadcast(p.data, dist.get_process_group_ranks(group)[0], group=group)
    rng = np.random.default_rng(6)
    host = {k: rng.integers(0, cfg.vocab_size, (b, t)) for k in ("tokens", "labels")}
    batch = next(iter(iter_device_batches(iter([host]), sharding=data_sharding(mesh, True))))
    tok, lab = (batch[k].to_local() for k in ("tokens", "labels"))
    tl = t // sp
    pos = (r * tl + torch.arange(tl, device=dev))[None].expand(b, tl)

    def ring_step():
        """The ring's loss, gathered logits and sp-psum'd grads (on every
        rank; the lead keeps them)."""
        got = llama_outputs(model, tok, lab, pos)
        got = dict(loss=float(xla_ops.psum(got["loss"], "sp", mesh)),
                   logits=xla_ops.all_gather(got["logits"], "sp", mesh, gather_axis=1),
                   grads={k: xla_ops.psum(g, "sp", mesh) for k, g in got["grads"].items()})
        model.zero_grad(set_to_none=True)
        return got if lead else None

    _reset_peak(dev.type)
    reset_launch_counts()
    llama_outputs(model, tok, lab, pos)
    sync()
    launches = launch_counts()
    out = dict(preset=preset, dtype=dtype, n_layers=cfg.n_layers, batch=b, seq=t, sp=sp,
               launches=launches)
    if timed and dev.type == "cuda":
        out["peak_bytes_per_card"] = [p for p, _ in _per_card(dev.type)][:sp]
        with torch.no_grad():
            out["forward_ms"] = op_ms(lambda: model(tok, pos), iters=3)
        out["forward_backward_ms"] = op_ms(lambda: llama_outputs(model, tok, lab, pos),
                                           iters=3)
        kv = torch.empty((b, tl, cfg.n_kv_heads, cfg.head_dim), dtype=dt, device=dev)
        out["kv_shift_ms"] = op_ms(lambda: xla_ops.ppermute_shift(kv, "sp", mesh, 1))
        del kv
    ring = ring_step()

    def flash_outputs(ref_dtype):
        """The lead's whole-sequence model with attn_impl="flash" in
        `ref_dtype` on the ring's weights (remat, to hold T=16384 in f32)."""
        ref = Llama(dataclasses.replace(cfg, attn_impl="flash", dtype=ref_dtype,
                                        param_dtype=ref_dtype, remat=True), device=dev)
        ref.load_state_dict(model.state_dict())
        got = llama_outputs(ref, torch.from_numpy(host["tokens"]).to(dev),
                            torch.from_numpy(host["labels"]).to(dev))
        got["loss"] = float(got["loss"])
        return got

    tol = RING_TOL[dtype]
    readings, bad = {}, []
    if lead:
        witness = flash_outputs(torch.float32)
        readings["ring"] = ring_readings(ring, witness)
        bad += [f"ring {k}" for k in over_tol(readings["ring"], tol)]
        if dt != torch.float32:
            flash = flash_outputs(dt)
            readings["flash"] = ring_readings(flash, witness)
            readings["ring_vs_flash"] = ring_readings(ring, flash)
            bad += [f"ring_vs_flash {k}" for k in over_tol(readings["ring_vs_flash"], tol)]
            del flash
        out.update(loss=ring["loss"], witness_loss=witness["loss"])
    del ring
    _world_barrier(dev.type)
    controls = [c for c in RING_CONTROLS if sp > 1 or c != "drop_block"]
    for name in controls if dt != torch.float32 else ():
        with ring_control(name, sp):
            got = ring_step()
        if lead:
            readings[name] = ring_readings(got, witness)
            if RING_CONTROLS[name] and not over_tol(readings[name], tol):
                bad.append(f"control {name} within the limits")
        del got
    if lead:
        del witness
        out.update(readings=readings, tol=tol)
        log(f"[{tag}] ring: {preset} x {cfg.n_layers} layers {dtype}, sp={sp}, B={b} T={t} "
            f"({tl} a card), global positions; against the f32 flash model (limits "
            f"{tol}): ring {fmt_readings(readings['ring'])}"
            + "".join(f"; {k} {fmt_readings(v)}" for k, v in readings.items() if k != "ring")
            + f"; launches {launches}"
            + (f"; forward {out['forward_ms']:.1f} ms, forward+backward "
               f"{out['forward_backward_ms']:.1f} ms, one K/V shift {out['kv_shift_ms']:.4f} "
               f"ms, peak {[round(p / 2**30, 2) for p in out['peak_bytes_per_card']]} GiB "
               f"a card" if "forward_ms" in out else ""))
        if bad:
            raise AssertionError(f"{tag} ring {dtype} sp={sp}: {bad}: {out}")
    if any(launches.values()):
        raise AssertionError(f"{tag}: a kernel launched on the ring path: {launches}")
    del model
    _reset_peak(dev.type)
    _world_barrier(dev.type)
    return out if lead else None


class LlamaStage:
    """Blocks [lo, hi) of a Llama as one pipeline stage: the embedding in
    front of the first, the final norm, the head and f32 logits behind the
    last. `fn(params, x)` runs it through torch.func.functional_call on
    `params` (named as in `module`), positions arange(T)."""

    def __init__(self, model, lo, hi, first, last):
        import torch
        from torch import nn

        class Stage(nn.Module):
            def __init__(self):
                super().__init__()
                if first:
                    self.embed = model.embed
                self.blocks = nn.ModuleList(model.blocks()[lo:hi])
                if last:
                    self.final_norm, self.lm_head = model.final_norm, model.lm_head

            def forward(self, x):
                if first:
                    x = self.embed(x)
                b, t = x.shape[:2]
                pos = torch.arange(t, device=x.device, dtype=torch.int32)[None].expand(b, t)
                for blk in self.blocks:
                    x, _ = blk(x, pos, None)
                return self.lm_head(self.final_norm(x)).float() if last else x

        self.module = Stage()
        ids = {id(p): k for k, p in model.named_parameters()}
        # the stage's parameter names -> the model's
        self.names = {k: ids[id(p)] for k, p in self.module.named_parameters()}

    def fn(self, params, x):
        import torch
        return torch.func.functional_call(self.module, params, (x,))

    def params(self, device):
        """Copies of the stage's parameters on `device`."""
        return {k: p.detach().to(device, copy=True) for k, p in self.module.named_parameters()}


def llama_stages(model, n_stages):
    per = model.cfg.n_layers // n_stages
    return [LlamaStage(model, i * per, (i + 1) * per, i == 0, i == n_stages - 1)
            for i in range(n_stages)]


def ce_mean(logits, labels):
    import torch.nn.functional as F
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def run_1f1b(stages, mbs, tgts, watch=None):
    """One 1F1B step of MPMDPipeline.train_step's schedule, in process: scan
    the stages round-robin, running each stage's next planned op once its
    input exists (the microbatch or the previous stage's activation for a
    forward, the next stage's input grad for a backward), then apply_grads
    on every stage. `watch(i, fn)` may wrap each op of stage i. Returns the
    per-microbatch losses (tensors) and the apply_grads results."""
    from collections import deque
    from ray_tpu_torch.train.mpmd import _one_f_one_b_plan
    n_stages, n_micro = len(stages), len(mbs)
    watch = watch or (lambda i, fn: fn())
    plans = [deque(_one_f_one_b_plan(i, n_stages, n_micro)) for i in range(n_stages)]
    acts, grads, losses = {}, {}, []
    last = n_stages - 1
    while any(plans):
        progressed = False
        for i, plan in enumerate(plans):
            if not plan:
                continue
            kind, m = plan[0]
            st = stages[i]
            if kind == "F":
                src = mbs[m] if i == 0 else acts.pop((i - 1, m), None)
                if src is None:
                    continue
                out = watch(i, lambda: st.forward(m, src, tgts[m] if i == last else None))
                (losses.append(out) if i == last else acts.__setitem__((i, m), out))
            else:
                g = None if i == last else grads.pop((i + 1, m), None)
                if i != last and g is None:
                    continue
                dx = watch(i, lambda: st.backward(m, g))
                if i:
                    grads[(i, m)] = dx
            plan.popleft()
            progressed = True
        if not progressed:
            raise RuntimeError(f"1F1B deadlock: {[list(p)[:3] for p in plans]}")
    return losses, [st.apply_grads(n_micro) for st in stages]


def whole_step(model, mbs, tgts, lr):
    """The whole model's step: the mean of the per-microbatch gradients and
    SGD(lr), in place. Returns the per-microbatch losses."""
    import torch
    model.zero_grad(set_to_none=True)
    losses = []
    for x, y in zip(mbs, tgts):
        loss = ce_mean(model(x)[0], y)
        loss.backward()
        losses.append(loss.detach())
    with torch.no_grad():
        for p in model.parameters():
            p -= lr * (p.grad / len(mbs))
    model.zero_grad(set_to_none=True)
    return losses


def pipeline_batch(vocab, n_micro, b, t, devices):
    """M microbatches of tokens (on devices[0]) and labels (on devices[-1])."""
    import torch
    rng = np.random.default_rng(10)
    return ([torch.from_numpy(rng.integers(0, vocab, (b, t))).to(devices[0])
             for _ in range(n_micro)],
            [torch.from_numpy(rng.integers(0, vocab, (b, t))).to(devices[-1])
             for _ in range(n_micro)])


def check_1f1b(devices, preset="llama_1b", n_micro=8, b=1, t=PIPE_SEQ, lr=0.1, overrides=None,
               tag="seqpipe"):
    """Path `pipeline`: the preset in f32 split into len(devices) PipelineStages
    (stage i on devices[i]; the embedding in stage 0, the final norm, head
    and mean CE loss in the last) driven by run_1f1b over M microbatches,
    with one sgd(lr) step, against whole_step on devices[0] from the same
    weights: the mean loss and every parameter after the step within
    PIPE_TOL relative; launches of each kernel counted over the step."""
    import torch
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.train.mpmd import PipelineStage, sgd

    cfg = getattr(LlamaConfig, preset)(**dict(overrides or {}, dtype=torch.float32,
                                              param_dtype=torch.float32))
    model = init_params(Llama(cfg, device=devices[0]),
                        torch.Generator(device=devices[0]).manual_seed(0))
    split = llama_stages(model, len(devices))
    first = [s.params(dev) for s, dev in zip(split, devices)]
    stages = [PipelineStage(i, len(split), s.fn, p, loss_fn=ce_mean if i == len(split) - 1
                            else None, optimizer=sgd(lr), device=dev)
              for i, (s, p, dev) in enumerate(zip(split, first, devices))]
    mbs, tgts = pipeline_batch(cfg.vocab_size, n_micro, b, t, devices)
    reset_launch_counts()
    losses, stats = run_1f1b(stages, mbs, tgts)
    launches = launch_counts()
    want_losses = whole_step(model, mbs, [y.to(devices[0]) for y in tgts], lr)
    loss = float(sum(float(x) for x in losses)) / n_micro
    want = float(sum(float(x) for x in want_losses)) / n_micro
    loss_err = abs(loss - want) / abs(want)
    ref = dict(model.named_parameters())
    param_err, upd_err = 0.0, 0.0
    for s, st, p0 in zip(split, stages, first):
        for k, p in st.get_params().items():
            w = ref[s.names[k]].detach()
            param_err = max(param_err, rel_err(p, w.to(p.device)))
            upd_err = max(upd_err, rel_err(p - p0[k], w.to(p.device) - p0[k]))
    n_layers = cfg.n_layers
    want_launches = dict(flash_fwd=2 * n_layers * n_micro, flash_bwd_dq=n_layers * n_micro,
                         flash_bwd_dkv=n_layers * n_micro, paged_decode=0,
                         paged_decode_combine=0)
    if devices[0].type != "cuda":
        want_launches = dict.fromkeys(want_launches, 0)
    log(f"[{tag}] pipeline: {preset} f32 in {len(split)} PipelineStages on "
        f"{[str(d) for d in devices]}, 1F1B over M={n_micro} of B={b} T={t}, sgd({lr}): "
        f"mean loss {loss:.6f} vs the whole model's {want:.6f} (rel {loss_err:.2e}), params "
        f"after the step {param_err:.2e} of max |param| (tol {PIPE_TOL}), updates "
        f"{upd_err:.2e} of max |update|; stash depths {[x['stash_depth'] for x in stats]}; "
        f"launches {launches} (want {want_launches})")
    if loss_err > PIPE_TOL or param_err > PIPE_TOL or launches != want_launches:
        raise AssertionError(f"{tag} pipeline check failed: loss {loss_err}, params "
                             f"{param_err}, launches {launches}")
    return dict(preset=preset, stages=len(split), microbatches=n_micro, batch=b, seq=t,
                loss=loss, whole_loss=want, loss_rel_err=loss_err, params_rel_err=param_err,
                updates_rel_err=upd_err, tol=PIPE_TOL, launches=launches)


def time_1f1b(devices, preset="llama_1b", n_micro=8, b=1, t=PIPE_SEQ, lr=0.1, overrides=None,
              tag="seqpipe"):
    """The preset with bf16 activations (f32 params), as check_1f1b splits
    it: one 1F1B step (after a warm one) and one whole-model step on
    devices[0], each ended by a synchronize of every card; per stage, the
    device time of its ops (CUDA events around each op on its card) over
    the step's wall time, against the GPipe bound of the idle share,
    (S - 1) / (M + S - 1); beside it each stage's bubble from its own
    `pipeline.fwd` / `pipeline.bwd` trace windows (`bubble_stats`: idle
    over the stage's span, its first window to its last), whose busy
    seconds must be within PIPE_BUSY_TOL of the CUDA-event busy ms; then
    one more step with RAY_TPU_TRACE=0, which must record no window and
    create no CUDA event."""
    import torch
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.train.mpmd import PipelineStage, sgd
    from ray_tpu_torch.util import tracing

    cfg = getattr(LlamaConfig, preset)(**(overrides or {}))
    model = init_params(Llama(cfg, device=devices[0]),
                        torch.Generator(device=devices[0]).manual_seed(0))
    split = llama_stages(model, len(devices))
    stages = [PipelineStage(i, len(split), s.fn, s.params(dev),
                            loss_fn=ce_mean if i == len(split) - 1 else None,
                            optimizer=sgd(lr), device=dev)
              for i, (s, dev) in enumerate(zip(split, devices))]
    mbs, tgts = pipeline_batch(cfg.vocab_size, n_micro, b, t, devices)
    sync = lambda: [torch.cuda.synchronize(d) for d in devices]
    events = [[] for _ in devices]

    def watch(i, fn):
        stream = torch.cuda.current_stream(devices[i])
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record(stream)
        out = fn()
        pair[1].record(stream)
        events[i].append(pair)
        return out

    run_1f1b(stages, mbs, tgts)
    sync()
    events = [[] for _ in devices]
    tracing.clear()
    t0 = time.perf_counter()
    run_1f1b(stages, mbs, tgts, watch)
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    busy = [sum(a.elapsed_time(z) for a, z in ev) for ev in events]
    windows = [e for e in tracing.events() if e["cat"] == "pipeline"]
    bubble = tracing.bubble_stats(tracing.to_chrome(windows), extra_cats=("pipeline",))
    per_stage = [bubble["workers"].get((os.getpid(), i), {}) for i in range(len(stages))]
    tracing.clear()
    with environ(RAY_TPU_TRACE="0"):
        tracing.refresh()
        n_events = tracing.DEVICE_EVENTS
        run_1f1b(stages, mbs, tgts)
        sync()
        off = dict(windows=len(tracing.events()), cuda_events=tracing.DEVICE_EVENTS - n_events)
    tracing.refresh()
    del stages
    tgts0 = [y.to(devices[0]) for y in tgts]
    whole_step(model, mbs, tgts0, lr)
    sync()
    t0 = time.perf_counter()
    whole_step(model, mbs, tgts0, lr)
    sync()
    whole_ms = (time.perf_counter() - t0) * 1e3
    n = len(devices)
    tokens = n_micro * b * t
    out = dict(step_ms=step_ms, whole_step_ms=whole_ms, tokens_per_s=tokens / step_ms * 1e3,
               whole_tokens_per_s=tokens / whole_ms * 1e3, busy_ms=busy,
               busy_share=[x / step_ms for x in busy],
               gpipe_idle_bound=(n - 1) / (n_micro + n - 1),
               window_bubble=[dict(w, stage=i) for i, w in enumerate(per_stage)],
               window_busy_over_event_busy=[w.get("busy_s", 0.0) * 1e3 / x
                                            for w, x in zip(per_stage, busy)],
               trace_off=off)
    log(f"[{tag}] 1F1B step, {preset} bf16, {n} stages on {[str(d) for d in devices]}, M="
        f"{n_micro} of B={b} T={t}: {step_ms:.1f} ms ({out['tokens_per_s']:.0f} tokens/s), "
        f"the whole model's step on {devices[0]} {whole_ms:.1f} ms "
        f"({out['whole_tokens_per_s']:.0f} tokens/s); each stage's device-busy share "
        f"(CUDA events, busy over the step's wall time) "
        f"{[round(x, 3) for x in out['busy_share']]} (GPipe idle bound "
        f"{out['gpipe_idle_bound']:.3f}) ({smi_line()})")
    log(f"[{tag}] 1F1B bubble from the stages' trace windows (bubble_stats: idle over each "
        f"stage's span, first window to last): " + "; ".join(
            f"stage {i}: {w.get('windows', 0)} windows, busy {w.get('busy_s', 0) * 1e3:.1f} ms "
            f"of span {w.get('span_s', 0) * 1e3:.1f} ms, bubble "
            f"{w.get('bubble_fraction', 0):.3f}" for i, w in enumerate(per_stage))
        + f"; GPipe bound {n - 1}/{n_micro + n - 1} = {out['gpipe_idle_bound']:.3f}; with "
        f"RAY_TPU_TRACE=0: {off['windows']} windows, {off['cuda_events']} CUDA events")
    checks = {
        f"{2 * n_micro} windows a stage": all(w.get("windows") == 2 * n_micro
                                             for w in per_stage),
        f"window busy within {PIPE_BUSY_TOL:.0%} of CUDA-event busy (ratios "
        f"{[round(r, 4) for r in out['window_busy_over_event_busy']]})":
            all(abs(r - 1) <= PIPE_BUSY_TOL for r in out["window_busy_over_event_busy"]),
        "RAY_TPU_TRACE=0: no window, no CUDA event": off == dict(windows=0, cuda_events=0),
    }
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} 1F1B trace: {what}")
    if not all(checks.values()):
        raise AssertionError(f"{tag} 1F1B trace windows: {out}")
    return out


def check_pipeline_apply(mesh, dev, dtype, n_micro, t, grad=True, timed=False,
                         preset="llama_1b", overrides=None, tag="seqpipe"):
    """pipeline_apply over `mesh`'s pp axis: the preset's blocks, n_layers / pp
    a stage, one stage a rank, M microbatches of hidden states [1, T, D]
    (made on each card from one seed) against the sequential blocks on the
    same weights (on every rank; the lead rank compares the outputs, each
    rank the gradients of its stage): the outputs, and with `grad` the
    gradient of sum(out * w), within PIPE_TOL relative. With `timed`, the
    ms of a forward (no grad) and of the sequential forward on one card.
    Every rank calls it; the lead rank returns the readings."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.parallel import xla_ops
    from ray_tpu_torch.parallel.pipeline import (pipeline_apply, shard_pipeline_params,
                                                 stack_stage_params)

    n_stages, s = xla_ops.axis_size("pp", mesh), xla_ops.axis_index("pp", mesh)
    lead = dist.get_rank() == 0
    cfg = getattr(LlamaConfig, preset)(**dict(overrides or {}, dtype=getattr(torch, dtype),
                                              param_dtype=torch.float32))
    model = init_params(Llama(cfg, device=dev), torch.Generator(device=dev).manual_seed(0))
    split = [LlamaStage(model, i * cfg.n_layers // n_stages,
                        (i + 1) * cfg.n_layers // n_stages, False, False)
             for i in range(n_stages)]
    mine = {k: v.clone().requires_grad_(grad) for k, v in shard_pipeline_params(
        stack_stage_params([st.params(dev) for st in split]), mesh, "pp").items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    xs = torch.randn((n_micro, 1, t, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    w = torch.randn(xs.shape, generator=gen, device=dev)
    fn = split[0].fn           # every stage has the same structure

    def sequential(x):
        for blk in model.blocks():
            x, _ = blk(x, torch.arange(t, device=dev)[None], None)
        return x

    with torch.set_grad_enabled(grad):
        outs = pipeline_apply(fn, mine, xs, mesh, "pp")
        if grad:
            (outs.float() * w).sum().backward()
    with torch.set_grad_enabled(grad):
        seq = []
        for x, wm in zip(xs, w):
            y = sequential(x)
            if grad:
                (y.float() * wm).sum().backward()
            seq.append(y.detach())
        seq = torch.stack(seq)
    out_err = rel_err(outs.detach(), seq)
    res = dict(dtype=dtype, stages=n_stages, microbatches=n_micro, seq=t,
               outputs_rel_err=out_err, tol=PIPE_TOL)
    if grad:
        ref = dict(model.named_parameters())
        names = split[s].names
        mine_err = worst_rel({names[k]: v.grad[0] for k, v in mine.items()},
                             {names[k]: ref[names[k]].grad for k in mine})[0]
        errs = [None] * dist.get_world_size()
        dist.all_gather_object(errs, mine_err)
        res["grads_rel_err_per_stage"] = errs
    if timed and dev.type == "cuda":
        with torch.no_grad():
            res["forward_ms"] = op_ms(lambda: pipeline_apply(fn, mine, xs, mesh, "pp"), iters=3)
            res["sequential_forward_ms"] = op_ms(lambda: [sequential(x) for x in xs], iters=3)
    if lead:
        log(f"[{tag}] pipeline_apply: {preset} blocks, {dtype}, pp={n_stages} "
            f"({cfg.n_layers // n_stages} blocks a stage), M={n_micro} of [1, {t}, "
            f"{cfg.d_model}]: outputs {out_err:.2e} of max |out| from the sequential blocks"
            + (f", stage grads {res['grads_rel_err_per_stage']}" if grad else "")
            + (f" (tol {PIPE_TOL})" if dtype == "float32" else "")
            + (f"; forward {res['forward_ms']:.1f} ms, sequential forward on one card "
               f"{res['sequential_forward_ms']:.1f} ms" if "forward_ms" in res else ""))
    bad = dtype == "float32" and (out_err > PIPE_TOL or any(
        e > PIPE_TOL for e in res.get("grads_rel_err_per_stage", [])))
    del model, mine, outs, seq
    _reset_peak(dev.type)
    _world_barrier(dev.type)
    if bad:
        raise AssertionError(f"{tag} pipeline_apply pp={n_stages}: {res}")
    return res if lead else None


def run_seqpipe(device="cuda", preset="llama_1b", t=2048, t_pipe=PIPE_SEQ, n_micro=8,
                overrides=None):
    """The `seqpipe` phase on one card (world 1 on NCCL): path `ring` (bf16
    at the preset's depth, then f32 at 2 layers), path `pipeline` (f32
    check, then the bf16 timing), and pipeline_apply at pp=1 against the
    stacked sequential forward. Takes the world down."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(device) if device == "cpu" else torch.device("cuda", 0)
    mesh = pmesh.make_mesh({"sp": 1}, device=device)
    ov = overrides or {}
    ring = dict(bf16=check_ring(mesh, dev, preset, "bfloat16", 1, t, ov),
                f32_2layer=check_ring(mesh, dev, preset, "float32", 1, t,
                                      dict(ov, n_layers=2)))
    pp1 = check_pipeline_apply(pmesh.make_mesh({"pp": 1}, device=device), dev, "float32",
                               n_micro=4, t=t_pipe, grad=False, preset=preset, overrides=ov)
    dist.destroy_process_group()
    pipe = check_1f1b([dev] * 4, preset, n_micro=n_micro, t=t_pipe, overrides=ov)
    timing = (time_1f1b([dev] * 4, preset, n_micro=n_micro, t=t_pipe, overrides=ov)
              if dev.type == "cuda" else None)
    return dict(ring=ring, pipeline=pipe, pipeline_timing=timing, pipeline_apply_pp1=pp1,
                launches={"ring": ring["bf16"]["launches"], "pipeline": pipe["launches"]})


# ------------------------------------------------------------------ rl
RL_METRIC_TOL = 1e-4     # cuda vs cpu learner metrics, of max(1, |value|)
# Params after an update. Adam's first steps move each coordinate by about
# lr * sign(g), so one whose gradient is at rounding level may land up to
# 2 lr a step from the other side's: every coordinate is held to that
# bound, and at most RL_FAR_SHARE of them may lie more than lr / 100 apart
# (a wrong gradient moves most coordinates by ~lr).
RL_FAR_SHARE = 1e-3
CARTPOLE_TOL = 1e-6      # TorchCartPole.step state, cuda vs cpu, absolute
RL_BAR = 60.0            # JAX's IMPALA bar (tests/test_rllib_algos.py): best return
PPO_PROFILE_STEPS = 50   # PPO minibatch steps in the profiled window of `rl_device` (its
                         # trace's processing is slow: 37 s for 186 steps)


def rl_batch(rng, t, b, obs_shape=(4,), n_actions=2):
    """A numpy-seeded [T, B] batch with every column PPO and IMPALA read
    (uint8 frames for an image obs_shape)."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    obs = (rng.integers(0, 256, (t, b) + obs_shape).astype(np.uint8) if len(obs_shape) == 3
           else f(t, b, *obs_shape))
    return {"obs": obs, "actions": rng.integers(0, n_actions, (t, b)),
            "action_logp": np.log(rng.uniform(0.3, 0.7, (t, b))).astype(np.float32),
            "advantages": f(t, b), "vf_preds": f(t, b) * 0.1, "value_targets": f(t, b),
            "rewards": np.ones((t, b), np.float32),
            "dones": (rng.random((t, b)) < 0.05).astype(np.float32),
            "bootstrap_value": f(b)}


def learner_pair(learner_cls, cfg_cls, spec, device, **training):
    """The learner on `device` and on the CPU, holding the same weights."""
    from ray_tpu_torch.rllib import RLModule
    cpu = learner_cls(RLModule(spec), cfg_cls().training(**training).resources(device="cpu"))
    dev = learner_cls(RLModule(spec), cfg_cls().training(**training).resources(device=device))
    dev.set_weights(cpu.get_weights())
    return dev, cpu


def param_gap(got, want, lr):
    """(max |got - want| over every coordinate, share of coordinates more
    than lr / 100 apart) of two state_dicts."""
    import torch
    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    return float(diff.max()), float((diff > lr / 100).float().mean())


def compare_updates(tag, dev, cpu, update, lr, steps, online=None):
    """`update(learner)` on both (host-float metrics); metrics within
    RL_METRIC_TOL and finite, every param within the Adam bound (2 lr a
    step) with at most RL_FAR_SHARE of the coordinates more than lr / 100
    apart, while the update itself moved most of them that far. `online`,
    when given, picks the state_dict keys the share and the moved share are
    taken over (the nets the update steps, not their Polyak targets, which
    move by tau of a step). Returns the readings."""
    before = cpu.get_weights()
    got, want = update(dev), update(cpu)
    errs = {k: abs(got[k] - w) / max(1.0, abs(w)) for k, w in want.items()}
    worst = max(errs, key=errs.get)
    metric_err = errs[worst]
    wc, wd = cpu.get_weights(), dev.get_weights()
    pick = (lambda d: {k: v for k, v in d.items() if online(k)}) if online else (lambda d: d)
    worst_abs = param_gap(wd, wc, lr)[0]
    far = param_gap(pick(wd), pick(wc), lr)[1]
    moved = param_gap(pick(wc), pick(before), lr)[1]
    out = dict(metric_err=metric_err, metric_errs=errs, param_max_abs=worst_abs,
               far_share=far, moved_share=moved, adam_bound=2 * lr * steps,
               loss=want.get("total_loss", want.get("loss", want.get("critic_loss"))))
    log(f"[rl] {tag} {dev.device} vs cpu: metrics {metric_err:.3e} ({worst}; limit "
        f"{RL_METRIC_TOL:g}), params max |err| {worst_abs:.3e} (Adam bound "
        f"{2 * lr * steps:.1e}), share > lr/100 apart {far:.2e} (limit {RL_FAR_SHARE:g}; "
        f"the update moved {moved:.3f} of them)")
    if (metric_err > RL_METRIC_TOL or worst_abs > 2 * lr * steps or far > RL_FAR_SHARE
            or moved < 0.5 or not all(np.isfinite(v) for v in want.values())):
        raise AssertionError(f"rl: {tag} on {dev.device} disagrees with the CPU: {out}")
    return out


def replay_batch(rng, n, obs_shape, n_actions=None, action_dim=1, low=-2.0, high=2.0):
    """n numpy-seeded transitions: uint8 frames for an image obs_shape,
    discrete actions below n_actions or continuous ones in [low, high]."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    frames = lambda: rng.integers(0, 256, (n,) + obs_shape, dtype=np.uint8)
    image = len(obs_shape) == 3
    return {"obs": frames() if image else f(n, *obs_shape),
            "actions": (rng.integers(0, n_actions, n) if n_actions
                        else rng.uniform(low, high, (n, action_dim)).astype(np.float32)),
            "rewards": f(n), "next_obs": frames() if image else f(n, *obs_shape),
            "terminateds": (rng.random(n) < 0.05).astype(np.float32)}


def sac_draws(rng, b, d, n_act=None, low=-2.0, high=2.0):
    """Standard normals for SAC's two draws (the target's action at s', the
    actor's at s); with n_act, CQL's three more (uniform actions in [low,
    high] and the policy's draws at the repeated s and s')."""
    f = lambda n: rng.standard_normal((n, d)).astype(np.float32)
    out = {"next": f(b), "pi": f(b)}
    if n_act:
        out.update(rand=rng.uniform(low, high, (n_act * b, d)).astype(np.float32),
                   pi_rep=f(n_act * b), pin_rep=f(n_act * b))
    return out


def offpolicy_pair(learner_cls, cfg, spec, device, *args):
    """An off-policy learner on `device` and on the CPU, holding the same
    weights (targets included)."""
    cpu = learner_cls(spec, cfg.copy().resources(device="cpu"), *args)
    dev = learner_cls(spec, cfg.copy().resources(device=device), *args)
    dev.set_weights(cpu.get_weights())
    return dev, cpu


def not_target(key):
    return "_target" not in key.split(".")[0]


def check_offpolicy_parity(device="cuda"):
    """(a, continued) Each off-policy and offline update on `device` against
    the CPU's from the same weights, minibatch and injected draws, at the
    configs' defaults: DQN (MLP, double-Q, with PER weights), SAC, TQC,
    CQL (a bc_iters step and a SAC-objective step), IQL, BC and MARWIL."""
    from ray_tpu_torch.rllib import (BCConfig, CQLConfig, DQNConfig, IQLConfig, MARWILConfig,
                                     ModuleSpec, SACConfig, TQCConfig)
    from ray_tpu_torch.rllib.algorithms.bc import BCLearner
    from ray_tpu_torch.rllib.algorithms.cql import CQLLearner
    from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner
    from ray_tpu_torch.rllib.algorithms.iql import IQLLearner
    from ray_tpu_torch.rllib.algorithms.sac import SACLearner
    from ray_tpu_torch.rllib.algorithms.tqc import TQCLearner
    from ray_tpu_torch.rllib.learner import _host_metrics

    rng = np.random.default_rng(11)
    out = {}
    cartpole = ModuleSpec((4,), "discrete", 2)
    batch = replay_batch(rng, 32, (4,), n_actions=2)
    batch["_weights"] = rng.uniform(0.2, 1.0, 32).astype(np.float32)
    cfg = DQNConfig()
    dev, cpu = offpolicy_pair(DQNLearner, cfg, cartpole, device)
    out["dqn"] = compare_updates("DQNLearner.update (double-Q, PER weights)", dev, cpu,
                                 lambda l: _host_metrics([l.update(batch)]), cfg.lr, 1)

    pendulum = ModuleSpec((3,), "continuous", 1)
    batch = replay_batch(rng, 256, (3,))
    for name, cls, cfg in (("sac", SACLearner, SACConfig()), ("tqc", TQCLearner, TQCConfig())):
        draws = sac_draws(rng, 256, 1)
        dev, cpu = offpolicy_pair(cls, cfg, pendulum, device, -2.0, 2.0)
        out[name] = compare_updates(f"{cls.__name__}.update", dev, cpu,
                                    lambda l: _host_metrics([l.update(batch, draws)]), cfg.lr, 1,
                                    online=not_target)
    cfg = CQLConfig()
    for bc_phase in (True, False):
        draws = sac_draws(rng, 256, 1, cfg.num_cql_actions)
        dev, cpu = offpolicy_pair(CQLLearner, cfg, pendulum, device, -2.0, 2.0)
        out[f"cql_bc{int(bc_phase)}"] = compare_updates(
            f"CQLLearner.update (bc_phase={bc_phase})", dev, cpu,
            lambda l: _host_metrics([l.update(batch, draws, bc_phase=bc_phase)]), cfg.lr, 1,
            online=not_target)
    cfg = IQLConfig()
    dev, cpu = offpolicy_pair(IQLLearner, cfg, pendulum, device, -2.0, 2.0)
    out["iql"] = compare_updates("IQLLearner.update", dev, cpu,
                                 lambda l: _host_metrics([l.update(batch)]), cfg.lr, 1,
                                 online=not_target)

    data = expert_data()
    batch = {k: v[:256] for k, v in data.items()}
    batch["advantages"] = rng.standard_normal(256).astype(np.float32) * 3
    for name, cfg_cls in (("bc", BCConfig), ("marwil", MARWILConfig)):
        dev, cpu = learner_pair(BCLearner, cfg_cls, ModuleSpec((4,), "discrete", 2), device)
        out[name] = compare_updates(f"BCLearner.update_once ({name})", dev, cpu,
                                    lambda l: _host_metrics([l.update_once(batch)]),
                                    cfg_cls().lr, 1)
    return out


def check_rl_parity(device="cuda"):
    """(a) Each learner's update on `device` against the same update on the
    CPU, from the same weights on the same numpy-seeded batch: PPO (2
    epochs, 4 minibatches of 128 each) and IMPALA ([50, 64]) at (256, 256),
    and one CNN update_once on [8, 4, 84, 84, 4] uint8 frames; then
    TorchCartPole.step on both devices."""
    import torch
    from ray_tpu_torch.rllib import IMPALAConfig, ModuleSpec, PPOConfig, SampleBatch, TorchCartPole
    from ray_tpu_torch.rllib.algorithms.impala import IMPALALearner
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner

    rng = np.random.default_rng(10)
    mlp = ModuleSpec((4,), "discrete", 2)
    cnn = ModuleSpec((84, 84, 4), "discrete", 6, use_cnn=True)
    out = {}
    dev, cpu = learner_pair(PPOLearner, PPOConfig, mlp, device, num_epochs=2,
                            entropy_coeff=0.01)
    batch = SampleBatch(rl_batch(rng, 64, 8))
    out["ppo"] = compare_updates("PPOLearner.update (2 epochs)", dev, cpu,
                                 lambda l: l.update(batch), 3e-4, 2 * 4)
    dev, cpu = learner_pair(IMPALALearner, IMPALAConfig, mlp, device)
    batch = SampleBatch(rl_batch(rng, 50, 64))
    out["impala"] = compare_updates("IMPALALearner.update", dev, cpu,
                                    lambda l: l.update(batch), 5e-4, 1)
    dev, cpu = learner_pair(IMPALALearner, IMPALAConfig, cnn, device)
    batch = {k: v for k, v in rl_batch(rng, 8, 4, (84, 84, 4), 6).items()
             if k in IMPALALearner._TRAIN_KEYS}
    from ray_tpu_torch.rllib.learner import _host_metrics
    out["cnn"] = compare_updates("CNN IMPALALearner.update_once [8, 4, 84, 84, 4]", dev, cpu,
                                 lambda l: _host_metrics([l.update_once(batch)]), 5e-4, 1)
    x = (rng.uniform(-1, 1, (4096, 4)) * [2.6, 2.0, 0.25, 2.5]).astype(np.float32)
    t = rng.integers(490, 500, 4096).astype(np.int32)
    a = rng.integers(0, 2, 4096)
    args = [torch.from_numpy(v) for v in (x, t, a)]
    want = TorchCartPole.step(*args)
    got = [v.cpu() for v in TorchCartPole.step(*(v.to(device) for v in args))]
    state_err = float((got[0] - want[0]).abs().max())
    flags_equal = all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
    log(f"[rl] TorchCartPole.step {device} vs cpu on 4096 states: state max |err| {state_err:.3e} "
        f"(limit {CARTPOLE_TOL:g}), step counts, rewards and flags equal: {flags_equal}")
    if state_err > CARTPOLE_TOL or not flags_equal:
        raise AssertionError(f"rl: TorchCartPole.step on {device} disagrees with the CPU")
    out["cartpole"] = dict(state_max_abs=state_err, flags_equal=flags_equal)
    return out


def run_rl_device(device="cuda", iters=50, ppo_iters=3):
    """(b) Path `rl_device`: DeviceRollout(TorchCartPole, 64 envs, 50 steps)
    on `device` feeding the IMPALA learner at (256, 256), lr 3e-3, entropy
    0.01 (JAX's test settings), until the best episode_return_mean passes
    RL_BAR or `iters` iterations; then `ppo_iters` PPO iterations at PPO's
    defaults on DeviceRollout(8 envs, 500 steps) batches through
    compute_gae and PPOLearner.update; then one PPOLearner.update of about
    PPO_PROFILE_STEPS minibatch steps (fewer epochs) on the last batch
    under torch.profiler. The kernel
    counters are reset before and read after; none may launch."""
    import torch
    from ray_tpu_torch.rllib import DeviceRollout, IMPALAConfig, PPOConfig, TorchCartPole
    from ray_tpu_torch.rllib.algorithms.impala import IMPALALearner
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner
    from ray_tpu_torch.rllib.connectors import compute_gae, standardize_advantages

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    reset_launch_counts()
    roll = DeviceRollout(TorchCartPole, num_envs=64, rollout_len=50, seed=0, device=device)
    cfg = IMPALAConfig().training(lr=3e-3, entropy_coeff=0.01).resources(device=device)
    learner = IMPALALearner(roll.module, cfg, seed=0)
    curve, best, sample_s, update_s = [], 0.0, [], []
    for i in range(iters):
        t0 = time.perf_counter()
        batch = roll.sample(learner.net.state_dict())
        t1 = time.perf_counter()
        m = learner.update(batch)
        t2 = time.perf_counter()
        sample_s.append(t1 - t0)
        update_s.append(t2 - t1)
        ret = roll.pop_metrics().get("episode_return_mean")
        curve.append(ret)
        best = max(best, ret or 0.0)
        if not np.isfinite(m["total_loss"]):
            raise AssertionError(f"rl_device: IMPALA loss {m['total_loss']} at iteration {i}")
        if best > RL_BAR:
            break
    steps = roll.num_envs * roll.rollout_len
    warm = sample_s[1:] or sample_s            # the first sample builds the net
    impala = dict(iterations=len(curve), best_return=best, return_curve=curve,
                  env_steps_per_s=steps * len(warm) / sum(warm),
                  sample_ms=1e3 * float(np.median(warm)),
                  update_ms=1e3 * float(np.median(update_s[1:] or update_s)))
    log(f"[rl] rl_device IMPALA: best episode_return_mean {best:.1f} after {len(curve)} "
        f"iterations (bar {RL_BAR}); curve " + " ".join(f"{r:.1f}" if r else "-" for r in curve))
    log(f"[rl] rl_device IMPALA: {impala['env_steps_per_s']:.0f} env-steps/s acting "
        f"(sample of 64 x 50 {impala['sample_ms']:.2f} ms), update on 3200 rows "
        f"{impala['update_ms']:.2f} ms (medians)")
    if best <= RL_BAR:
        raise AssertionError(f"rl_device: IMPALA best return {best:.1f} <= {RL_BAR}")

    roll = DeviceRollout(TorchCartPole, num_envs=8, rollout_len=500, seed=1, device=device)
    pcfg = PPOConfig().resources(device=device)
    ppo = PPOLearner(roll.module, pcfg, seed=1)

    def ppo_iteration():
        t0 = time.perf_counter()
        b = roll.sample(ppo.net.state_dict())
        t1 = time.perf_counter()
        b = holder_batch["b"] = standardize_advantages(compute_gae(b, pcfg.gamma, pcfg.lambda_))
        t2 = time.perf_counter()
        m = ppo.update(b)
        sync()
        t3 = time.perf_counter()
        return m, (t1 - t0, t2 - t1, t3 - t2)

    rows, holder_batch = [], {}
    for _ in range(ppo_iters):
        m, (ts, tg, tu) = ppo_iteration()
        rows.append(dict(sample_ms=1e3 * ts, gae_ms=1e3 * tg, update_ms=1e3 * tu,
                         total_loss=m["total_loss"], return_mean=roll.pop_metrics().get(
                             "episode_return_mean")))
    prof = None
    n_mb = (roll.num_envs * roll.rollout_len // pcfg.minibatch_size) * pcfg.num_epochs
    if cuda:   # one PPOLearner.update of about PPO_PROFILE_STEPS minibatch steps
        epochs = max(1, round(PPO_PROFILE_STEPS * pcfg.num_epochs / n_mb))
        window = PPOLearner(roll.module, pcfg.copy().training(num_epochs=epochs), seed=1)
        window.set_weights(ppo.get_weights())
        t0 = time.perf_counter()
        prof = profile_call(lambda: window.update(holder_batch["b"]))
        prof["seconds_with_processing"] = time.perf_counter() - t0
        log_profile("rl", f"PPOLearner.update of {epochs} epochs "
                    f"({epochs * n_mb // pcfg.num_epochs} minibatch steps of "
                    f"{pcfg.minibatch_size} rows)", prof)
    for r in rows:
        log(f"[rl] rl_device PPO iteration: sample {r['sample_ms']:.1f} ms, gae "
            f"{r['gae_ms']:.1f} ms, update {r['update_ms']:.1f} ms ({r['update_ms'] / n_mb:.3f} "
            f"ms a minibatch step), total_loss {r['total_loss']:.4f}")
        if not np.isfinite(r["total_loss"]):
            raise AssertionError(f"rl_device: PPO loss {r['total_loss']}")
    sync()
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"rl_device: a kernel launched on the RL path: {launches}")
    return dict(impala=impala, ppo=rows, ppo_minibatch_steps=n_mb, profile=prof,
                launches=launches)


def run_rl_cnn(device="cuda", t=50, b=32, n=10, warmup=2):
    """(c) Path `rl_cnn`: the Nature CNN module (84x84x4 uint8, 6 actions)
    in an IMPALALearner, `n` timed update_once calls (after `warmup`) on
    [T, B] frames from seed 0; ms an update, peak memory, finite losses;
    no kernel may launch."""
    import torch
    from ray_tpu_torch.rllib import IMPALAConfig, ModuleSpec, RLModule
    from ray_tpu_torch.rllib.algorithms.impala import IMPALALearner

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    batch = {k: v for k, v in rl_batch(np.random.default_rng(0), t, b, (84, 84, 4), 6).items()
             if k in IMPALALearner._TRAIN_KEYS}
    learner = IMPALALearner(RLModule(ModuleSpec((84, 84, 4), "discrete", 6, use_cnn=True)),
                            IMPALAConfig().resources(device=device))
    reset_launch_counts()
    for _ in range(warmup):
        learner.update_once(batch)
    sync()
    _reset_peak("cuda" if cuda else "cpu")
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        m = learner.update_once(batch)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(m["total_loss"])
    losses = [float(v) for v in losses]
    sync()
    launches = launch_counts()
    out = dict(batch=[t, b, 84, 84, 4], frame_bytes=int(batch["obs"].nbytes),
               update_ms=1e3 * float(np.median(times)), update_ms_all=[1e3 * v for v in times],
               peak_memory_bytes=torch.cuda.max_memory_allocated() if cuda else None,
               losses=losses, launches=launches)
    peak = f"{out['peak_memory_bytes'] / 2**30:.2f} GiB" if cuda else "not measured"
    log(f"[rl] rl_cnn: IMPALA update_once on [{t}, {b}, 84, 84, 4] uint8 "
        f"({out['frame_bytes'] / 1e6:.1f} MB): {out['update_ms']:.2f} ms (median of {n}), "
        f"peak {peak}, losses {losses[0]:.4f} .. {losses[-1]:.4f}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"rl_cnn: losses not finite: {losses}")
    if any(launches.values()):
        raise AssertionError(f"rl_cnn: a kernel launched on the RL path: {launches}")
    return out


RL_WARM = 3            # untimed updates before each timing
RL_TIMED = 10          # timed updates an algorithm (their median is reported)
RL_PROFILED = 10       # updates in each profiled window
CNN_REPLAY = 4000      # the CNN DQN's buffer (DQN's default capacity is 50,000)


def expert_data(n=2000, seed=0):
    """JAX's BC case (tests/test_rllib_algos.py): 2000 x 4 normal obs,
    action obs[0] > 0."""
    obs = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return {"obs": obs, "actions": (obs[:, 0] > 0).astype(np.int64)}


def pendulum_dataset(n_steps=3000, seed=0):
    """Offline transitions of Pendulum-v1 (gymnasium's dynamics written out
    in numpy, as the chip machine has no gymnasium: g 10, m 1, l 1, dt 0.05,
    speed clipped to 8, torque to 2, reward -(θ² + 0.1 θ̇² + 0.001 u²) with
    θ wrapped to [-π, π), episodes cut at 200 steps, a reset drawing θ in
    [-π, π] and θ̇ in [-1, 1]), recorded from tests/test_rllib_cql.py's
    noisy energy controller, every draw from one generator seeded `seed`."""
    rng = np.random.default_rng(seed)
    g, m, length, dt = 10.0, 1.0, 1.0, 0.05
    cols = {k: [] for k in ("obs", "actions", "rewards", "next_obs", "terminateds")}
    th, thdot, t = rng.uniform(-np.pi, np.pi), rng.uniform(-1.0, 1.0), 0
    for _ in range(n_steps):
        obs = [np.cos(th), np.sin(th), thdot]
        u = float(np.clip(-1.0 * obs[1] - 0.3 * thdot + rng.normal(0, 0.4), -2, 2))
        wrapped = (th + np.pi) % (2 * np.pi) - np.pi
        cost = wrapped ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = float(np.clip(thdot + (3 * g / (2 * length) * np.sin(th)
                                       + 3.0 / (m * length ** 2) * u) * dt, -8, 8))
        th, t = th + thdot * dt, t + 1
        for k, v in zip(cols, (obs, [u], -cost, [np.cos(th), np.sin(th), thdot], 0.0)):
            cols[k].append(v)
        if t == 200:
            th, thdot, t = rng.uniform(-np.pi, np.pi), rng.uniform(-1.0, 1.0), 0
    return {k: np.asarray(v, np.float32) for k, v in cols.items()}


def time_updates(step, device, n=RL_TIMED, warm=RL_WARM, profiled=RL_PROFILED):
    """`step()` (one update) timed: the median ms of `n` synced calls after
    `warm`, then `profiled` more under torch.profiler on the card (busy
    share of the window, kernel launches an update)."""
    import torch
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(warm):
        step()
    times = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        step()
        sync()
        times.append(time.perf_counter() - t0)
    out = dict(ms=1e3 * float(np.median(times)), ms_all=[1e3 * v for v in times])
    if cuda:
        prof = profile_call(lambda: [step() for _ in range(profiled)])
        out.update(busy_share=prof["busy_share"], launches_per_update=prof["launches"] / profiled,
                   profile_wall_s=prof["wall_s"], top=prof["top"][:5])
    else:
        out.update(busy_share="not measured", launches_per_update="not measured")
    return out


def log_timing(tag, what, r, profiled=RL_PROFILED):
    share = r["busy_share"]
    share = f"{share:.4f}" if isinstance(share, float) else share
    per = r["launches_per_update"]
    per = f"{per:.0f}" if isinstance(per, float) else per
    log(f"[rl] {tag} {what}: {r['ms']:.3f} ms an update (median of {len(r['ms_all'])}), "
        f"busy share {share} over {profiled} profiled updates, {per} launches an update")


def no_launches(tag, device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"{tag}: a kernel launched on the RL path: {launches}")
    return launches


def run_rl_offline(device="cuda", bc_iters=60, iters=4):
    """(d) Path `rl_offline`, through the Algorithms' entry points on
    `device`: BC on JAX's expert data (lr 1e-2, batch 256) until
    action_accuracy passes 0.95 (at most `bc_iters` iterations); one
    MARWIL iteration (an advantages column, finite loss); CQL and IQL at
    their defaults ((256, 256), batch 256, CQL's 4 sampled actions, seed 7)
    for `iters` iterations on 3000 Pendulum-v1 transitions, IQL at its
    train_intensity 8, CQL at JAX's ablation's 10 updates an iteration and
    10 bc_iters, its cql_penalty at cql_alpha 1.0 below the one at 0.0;
    ms an update of each. No kernel may launch."""
    from ray_tpu_torch.rllib import BCConfig, CQLConfig, IQLConfig, MARWILConfig

    reset_launch_counts()
    out = {}
    bc = BCConfig().training(lr=1e-2, train_batch_size=256).resources(device=device)
    algo = bc.offline_data_source(expert_data()).build()
    curve = []
    for _ in range(bc_iters):
        curve.append(algo.train()["learner"]["action_accuracy"])
        if curve[-1] > 0.95:
            break
    mb = {k: v[:256] for k, v in algo._data.items()}
    out["bc"] = dict(iterations=len(curve), accuracy=curve[-1], curve=curve,
                     **time_updates(lambda: algo.learner.update_once(mb), device))
    log(f"[rl] rl_offline BC: action_accuracy {curve[-1]:.4f} after {len(curve)} iterations "
        f"(bar 0.95)")
    log_timing("rl_offline", "BC update_once (batch 256)", out["bc"])
    if curve[-1] <= 0.95:
        raise AssertionError(f"rl_offline: BC accuracy {curve[-1]:.4f} <= 0.95")

    data = expert_data()
    data["advantages"] = np.random.default_rng(1).standard_normal(2000).astype(np.float32)
    marwil = MARWILConfig().resources(device=device).offline_data_source(data).build()
    loss = marwil.train()["learner"]["total_loss"]
    out["marwil"] = dict(total_loss=loss)
    log(f"[rl] rl_offline MARWIL: one iteration, total_loss {loss:.4f}")
    if not np.isfinite(loss):
        raise AssertionError(f"rl_offline: MARWIL loss {loss}")

    data = pendulum_dataset()
    ablation = dict(train_intensity=10, bc_iters=10)      # tests/test_rllib_cql.py's settings
    for name, cfg in (("cql", CQLConfig().training(**ablation)),
                      ("cql_ablation", CQLConfig().training(cql_alpha=0.0, **ablation)),
                      ("iql", IQLConfig())):
        algo = cfg.offline_data_source(data).resources(device=device).debugging(seed=7).build()
        rows = [algo.train()["learner"] for _ in range(iters)]
        if not all(np.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"rl_offline: {name} metrics not finite: {rows}")
        out[name] = dict(last=rows[-1])
        log(f"[rl] rl_offline {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in rows[-1].items()))
        if name != "cql_ablation":
            mb = {k: v[:256] for k, v in algo._data.items()}
            out[name].update(time_updates(lambda: algo.learner.update(mb), device))
            log_timing("rl_offline", f"{name.upper()} update (batch 256)", out[name])
    pen, ablation = out["cql"]["last"]["cql_penalty"], out["cql_ablation"]["last"]["cql_penalty"]
    log(f"[rl] rl_offline CQL: cql_penalty {pen:.4f} at cql_alpha 1.0 against {ablation:.4f} at 0.0")
    if not pen < ablation:
        raise AssertionError(f"rl_offline: CQL's penalty {pen} is not below its ablation's "
                             f"{ablation}")
    if not 0 < out["iql"]["last"]["awr_weight_mean"] < 101:
        raise AssertionError(f"rl_offline: IQL awr_weight_mean {out['iql']['last']}")
    out["launches"] = no_launches("rl_offline", device)
    return out


def run_rl_offpolicy(device="cuda", fill=10_000):
    """(e) Path `rl_offpolicy`: the online algorithms' learners at their
    defaults fed from the port's replay buffers, filled with `fill`
    numpy-seeded transitions (their Algorithms' setup probes a gymnasium
    env, which the chip machine lacks): DQN ((256, 256), batch 32,
    double-Q) on CartPole-v1's shapes from ReplayBuffer and from
    PrioritizedReplayBuffer (priorities written back), through
    dqn.learn_from_replay; DQN on the Nature CNN (84x84x4 uint8 frames, 6
    actions, batch 32) from a CNN_REPLAY-transition buffer, with the
    learner's peak memory; SAC and TQC ((256, 256), batch 256, 25 quantiles
    x 2 critics, 2 dropped a net) on Pendulum-v1's shapes. ms an update,
    busy share and launches an update of each; finite losses; no kernel
    may launch."""
    import torch
    from ray_tpu_torch.rllib import (DQNConfig, ModuleSpec, PrioritizedReplayBuffer,
                                     ReplayBuffer, SACConfig, TQCConfig)
    from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner, learn_from_replay
    from ray_tpu_torch.rllib.algorithms.sac import SACLearner
    from ray_tpu_torch.rllib.algorithms.tqc import TQCLearner
    from ray_tpu_torch.rllib.learner import _host_metrics

    cuda = torch.device(device).type == "cuda"
    rng = np.random.default_rng(12)
    reset_launch_counts()
    out = {}

    def dqn_case(name, spec, cfg, buffer):
        learner = DQNLearner(spec, cfg.resources(device=device))
        state = {"sgd": 0, "losses": []}

        def step():
            losses, state["sgd"] = learn_from_replay(learner, buffer, cfg, state["sgd"])
            state["losses"] += losses
        r = time_updates(step, device)
        r["loss_last"] = float(state["losses"][-1])
        r["sgd_steps"] = state["sgd"]
        if not np.isfinite([float(v) for v in state["losses"]]).all():
            raise AssertionError(f"rl_offpolicy: {name} losses not finite")
        return r

    cartpole = ModuleSpec((4,), "discrete", 2)
    for per in (False, True):
        cfg = DQNConfig().training(prioritized_replay=per)
        buf = (PrioritizedReplayBuffer(cfg.replay_buffer_capacity, alpha=cfg.per_alpha)
               if per else ReplayBuffer(cfg.replay_buffer_capacity))
        buf.add_batch(replay_batch(rng, fill, (4,), n_actions=2))
        name = "dqn_per" if per else "dqn"
        out[name] = dqn_case(name, cartpole, cfg, buf)
        log_timing("rl_offpolicy", f"DQN {'PER' if per else 'uniform'} replay (batch 32)",
                   out[name])

    buf = ReplayBuffer(CNN_REPLAY)
    buf.add_batch(replay_batch(rng, CNN_REPLAY, (84, 84, 4), n_actions=6))
    _reset_peak("cuda" if cuda else "cpu")
    out["dqn_cnn"] = dqn_case("dqn_cnn", ModuleSpec((84, 84, 4), "discrete", 6, use_cnn=True),
                              DQNConfig(), buf)
    out["dqn_cnn"].update(replay_bytes=int(sum(v.nbytes for v in buf._store.values())),
                          peak_memory_bytes=torch.cuda.max_memory_allocated() if cuda else None)
    del buf
    peak = (f"{out['dqn_cnn']['peak_memory_bytes'] / 2**30:.3f} GiB" if cuda
            else "not measured")
    log_timing("rl_offpolicy", "DQN Nature CNN (84x84x4 uint8, batch 32)", out["dqn_cnn"])
    log(f"[rl] rl_offpolicy DQN CNN: learner peak {peak}, replay of {CNN_REPLAY} transitions "
        f"{out['dqn_cnn']['replay_bytes'] / 1e6:.1f} MB on the host")

    pendulum = ModuleSpec((3,), "continuous", 1)
    for name, cls, cfg in (("sac", SACLearner, SACConfig()), ("tqc", TQCLearner, TQCConfig())):
        learner = cls(pendulum, cfg.resources(device=device), -2.0, 2.0)
        buf = ReplayBuffer(cfg.replay_buffer_capacity)
        buf.add_batch(replay_batch(rng, fill, (3,)))
        last = {}
        out[name] = time_updates(
            lambda: last.update(learner.update(buf.sample(cfg.train_batch_size))), device)
        out[name]["last"] = _host_metrics([last])
        if not all(np.isfinite(v) for v in out[name]["last"].values()):
            raise AssertionError(f"rl_offpolicy: {name} metrics not finite: {out[name]['last']}")
        log_timing("rl_offpolicy", f"{cls.__name__} (batch 256)", out[name])
    out["launches"] = no_launches("rl_offpolicy", device)
    return out


class MatchGame:
    """tests/test_rllib_multi_agent.py's two-agent game in numpy (no
    gymnasium spaces): both agents see a one-hot random target in {0, 1};
    each gets +1 for picking it and +1 more when both do; 16-step
    episodes."""

    possible_agents = ["a0", "a1"]

    def __init__(self, episode_len=16, seed=0):
        self.episode_len = episode_len
        self._rng = np.random.default_rng(seed)
        self._t = self._target = 0

    def _obs(self):
        onehot = np.zeros(2, np.float32)
        onehot[self._target] = 1.0
        return {a: onehot.copy() for a in self.possible_agents}

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._target = int(self._rng.integers(2))
        return self._obs(), {a: {} for a in self.possible_agents}

    def step(self, action_dict):
        correct = {a: int(action_dict[a]) == self._target for a in self.possible_agents}
        bonus = 1.0 if all(correct.values()) else 0.0
        rewards = {a: float(correct[a]) + bonus for a in self.possible_agents}
        self._t += 1
        self._target = int(self._rng.integers(2))
        done = self._t >= self.episode_len
        terms = {**{a: done for a in self.possible_agents}, "__all__": done}
        truncs = {**{a: False for a in self.possible_agents}, "__all__": False}
        return self._obs(), rewards, terms, truncs, {a: {} for a in self.possible_agents}


def run_rl_multi_agent(device="cuda", iters=3):
    """(f) Path `rl_multi_agent`: a MultiAgentEnvRunner acting on the host
    CPU (the numpy MatchGame, 64-step rollouts) feeding one PPOLearner a
    policy on `device` (JAX's multi-agent settings: batch 256, minibatch
    64, 4 epochs, lr 1e-2, entropy 0.01), `iters` iterations of
    ppo.multi_agent_training_step in shared mode (one policy) and in
    independent mode (one a agent); the ModuleSpecs are built directly
    (module_specs_for reads gymnasium spaces). Finite losses; no kernel
    may launch."""
    from ray_tpu_torch.rllib import ModuleSpec, PPOConfig, RLModule
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner, multi_agent_training_step
    from ray_tpu_torch.rllib.learner import make_learner_group
    from ray_tpu_torch.rllib.multi_agent import MultiAgentEnvRunner

    reset_launch_counts()
    cfg = (PPOConfig().training(train_batch_size=256, minibatch_size=64, num_epochs=4, lr=1e-2,
                                entropy_coeff=0.01).resources(device=device))
    spec = ModuleSpec((2,), "discrete", 2)
    out = {}
    for mode, mapping in (("shared", lambda aid: "shared"), ("independent", lambda aid: aid)):
        pids = sorted({mapping(a) for a in MatchGame.possible_agents})
        groups = {pid: make_learner_group(PPOLearner, RLModule(spec), cfg, seed=i)
                  for i, pid in enumerate(pids)}
        runner = MultiAgentEnvRunner(MatchGame, policy_mapping_fn=mapping,
                                     modules={p: g.learner.module for p, g in groups.items()},
                                     rollout_len=64)
        rows = []
        for _ in range(iters):
            t0 = time.perf_counter()
            r = multi_agent_training_step(runner, groups, cfg)
            rows.append(dict(seconds=time.perf_counter() - t0,
                             return_mean=r.get("episode_return_mean"),
                             losses={p: m["total_loss"] for p, m in r["learner"].items()}))
        out[mode] = rows
        log(f"[rl] rl_multi_agent {mode}: " + "; ".join(
            f"{row['seconds'] * 1e3:.0f} ms, return {row['return_mean']}, losses "
            + ", ".join(f"{p} {v:.4f}" for p, v in row["losses"].items()) for row in rows))
        if sorted(rows[-1]["losses"]) != pids or not all(
                np.isfinite(v) for row in rows for v in row["losses"].values()):
            raise AssertionError(f"rl_multi_agent: {mode}: {rows}")
    out["launches"] = no_launches("rl_multi_agent", device)
    return out


class _Space:
    """The two attributes of a gymnasium space that DreamerV3 reads."""

    def __init__(self, shape=(), n=None):
        self.shape = shape
        if n is not None:
            self.n = n


class NumpyCartPole:
    """gymnasium's CartPole-v1 in numpy (the chip machine has no gymnasium):
    its Euler dynamics in float64 (gravity 9.8, cart 1.0, pole 0.1 of half
    length 0.5, force 10, tau 0.02), termination past 12 degrees or 2.4,
    reward 1, TimeLimit's truncation at 500 steps, float32 observations,
    and a reset drawing the state uniform in [-0.05, 0.05] from
    default_rng(seed), as gymnasium seeds its np_random.
    tests/test_torch_rl_dreamerv3.py steps it against gymnasium's."""

    observation_space = _Space((4,))
    action_space = _Space(n=2)
    max_steps = 500

    def __init__(self):
        self._rng = None
        self.state = None
        self._t = 0

    def reset(self, seed=None):
        if seed is not None or self._rng is None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(-0.05, 0.05, size=(4,))
        self._t = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self.state
        force = 10.0 if action == 1 else -10.0
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + 0.05 * np.square(theta_dot) * sintheta) / 1.1
        thetaacc = (9.8 * sintheta - costheta * temp) / (
            0.5 * (4.0 / 3.0 - 0.1 * np.square(costheta) / 1.1))
        xacc = temp - 0.05 * thetaacc * costheta / 1.1
        x, x_dot = x + 0.02 * x_dot, x_dot + 0.02 * xacc
        theta, theta_dot = theta + 0.02 * theta_dot, theta_dot + 0.02 * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -2.4 or x > 2.4 or theta < -12 * 2 * np.pi / 360
                          or theta > 12 * 2 * np.pi / 360)
        self._t += 1
        return (np.array(self.state, dtype=np.float32), 1.0, terminated,
                self._t >= self.max_steps, {})

    def close(self):
        pass


DREAMER_ITERS = 4          # rl_dreamer's train() iterations with an update, after the collection
DREAMER_PROFILED = 1       # profiled updates (~5,500 launches each; the trace's processing is slow)


def dreamer_batch(rng, b, t, obs_dim=4, n_actions=2):
    """A numpy-seeded [B, T] DreamerV3 batch (one-hot actions)."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"obs": f(b, t, obs_dim),
            "action": np.eye(n_actions, dtype=np.float32)[rng.integers(0, n_actions, (b, t))],
            "reward": f(b, t), "is_first": (rng.random((b, t)) < 0.05).astype(np.float32),
            "is_terminated": (rng.random((b, t)) < 0.02).astype(np.float32)}


def check_dreamer_parity(device="cuda"):
    """(a) One DreamerV3 update on `device` against one on the CPU at full
    width (DreamerV3Config()'s defaults), from the same weights, on a
    seeded [8, 24] batch with the same injected draws: the sampled
    indices equal first (a mismatch reports the CPU's top-two gap there),
    then the metrics within RL_METRIC_TOL and each net's params as
    compare_updates holds them, the EMA critic within 1e-6 plus (1 -
    decay) of the critic's gap."""
    import torch
    from ray_tpu_torch.rllib import DreamerV3Config

    algos = {d: DreamerV3Config().environment(NumpyCartPole).resources(device=d).build()
             for d in ("cpu", device)}
    cpu, dev = algos["cpu"], algos[device]
    dev.set_weights(cpu.get_weights())
    cfg = cpu.config
    batch = dreamer_batch(np.random.default_rng(12), cfg.batch_size_B, cfg.batch_length_T)
    noise = cpu._update_noise(torch.Generator().manual_seed(12))
    before = cpu.get_weights()
    draws = {d: {} for d in algos}
    got = {d: {k: float(v) for k, v in a._update(batch, noise, draws[d]).items()}
           for d, a in algos.items()}
    flips = {}
    for k, want in draws["cpu"].items():
        g, w = draws[device][k].argmax(-1).cpu(), want.argmax(-1)
        top = want.topk(2, -1).values
        gaps = (top[..., 0] - top[..., 1])[g != w]
        flips[k] = dict(draws=int(w.numel()), differ=int((g != w).sum()),
                        gaps=gaps.tolist()[:8])
    n_draws = sum(f["draws"] for f in flips.values())
    log(f"[rl] rl_dreamer (a) DreamerV3 update {device} vs cpu: {n_draws} categorical draws, "
        f"differing: " + ", ".join(f"{k} {f['differ']} (top-two gaps {f['gaps']})"
                                   for k, f in flips.items()))
    if any(f["differ"] for f in flips.values()):
        raise AssertionError(f"rl_dreamer: sampled indices differ on {device}: {flips}")
    errs = {k: abs(got[device][k] - w) / max(1.0, abs(w)) for k, w in got["cpu"].items()}
    worst = max(errs, key=errs.get)
    wc, wd = cpu.get_weights(), dev.get_weights()
    params = {}
    for net, lr in (("wm", cfg.wm_lr), ("actor", cfg.ac_lr), ("critic", cfg.ac_lr)):
        worst_abs, far = param_gap(wd[net], wc[net], lr)
        params[net] = dict(max_abs=worst_abs, far_share=far, adam_bound=2 * lr,
                           moved_share=param_gap(wc[net], before[net], lr)[1])
    ema_over = max(float(((wd["critic_ema"][k] - wc["critic_ema"][k]).abs()
                          - 1e-6 - (1 - cfg.critic_ema_decay)
                          * (wd["critic"][k] - wc["critic"][k]).abs()).max())
                   for k in wc["critic_ema"])
    log(f"[rl] rl_dreamer (a) metrics {errs[worst]:.3e} ({worst}; limit {RL_METRIC_TOL:g}); "
        + "; ".join(f"{n} max |err| {r['max_abs']:.3e} (bound {r['adam_bound']:.1e}), share "
                    f"> lr/100 apart {r['far_share']:.2e} (moved {r['moved_share']:.3f})"
                    for n, r in params.items())
        + f"; EMA excess over its limit {ema_over:.3e} (<= 0)")
    bad = [n for n, r in params.items() if r["max_abs"] > r["adam_bound"]
           or r["far_share"] > RL_FAR_SHARE or r["moved_share"] < 0.5]
    if errs[worst] > RL_METRIC_TOL or bad or ema_over > 0 or not all(
            np.isfinite(v) for v in got["cpu"].values()):
        raise AssertionError(f"rl_dreamer: the update on {device} disagrees with the CPU: "
                             f"metrics {errs}, params {params}, EMA {ema_over}")
    for a in algos.values():
        a.stop()
    n_params = {n: sum(v.numel() for v in w.values()) for n, w in wc.items()}
    return dict(draws=flips, metric_err=errs[worst], metric_errs=errs, params=params,
                ema_excess=ema_over, n_params=n_params, metrics=got[device])


def run_rl_dreamer(device="cuda", iters=DREAMER_ITERS):
    """Path `rl_dreamer`: (a) check_dreamer_parity; (b) DreamerV3 at full
    width through `train()`, its env the numpy CartPole (a callable:
    gymnasium's CartPole-v1 dynamics), 512 env steps of 64 an iteration
    (learning starts at 512: 7 collect-only iterations, the 8th the first
    of `iters` with an update); ms an act
    step (the collect-only iterations' time over their env steps), ms an
    update (time_updates: median, busy share, launches), peak memory,
    env steps a second with updates; (c) JAX's world-model case
    (tests/test_rllib_dreamerv3.py: deter 64, hiddens (64, 64), B 8, T 16,
    H 5, 128 steps an iteration, 8 updates each, seed 1) on the card:
    wm_recon below 0.7 of its first value. B1-B4 launch 0 times."""
    import torch
    from ray_tpu_torch.rllib import DreamerV3Config

    out = dict(parity=check_dreamer_parity(device))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    algo = DreamerV3Config().environment(NumpyCartPole).resources(device=device).build()
    cfg = algo.config
    collect_s, train_s, rows = [], [], []
    # learning starts in the iteration whose collection reaches 512 steps
    n_collect = cfg.num_steps_sampled_before_learning_starts // cfg.rollout_fragment_length
    for i in range(n_collect + iters - 1):
        t0 = time.perf_counter()
        r = algo.train()
        (train_s if "learner" in r else collect_s).append(time.perf_counter() - t0)
        if "learner" in r:
            rows.append(r["learner"])
    if len(rows) != iters:
        raise AssertionError(f"rl_dreamer: {len(rows)} iterations updated, want {iters}")
    if not all(np.isfinite(v) for row in rows for v in row.values()):
        raise AssertionError(f"rl_dreamer: non-finite learner metrics {rows}")
    frag = cfg.rollout_fragment_length
    act_ms = 1e3 * float(np.median(collect_s[1:])) / frag
    timing = time_updates(lambda: algo._update(algo.replay.sample(cfg.batch_size_B,
                                                                   cfg.batch_length_T)), device,
                          profiled=DREAMER_PROFILED)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    steps_per_s = frag * iters / sum(train_s)
    out["train"] = dict(collect_iters=len(collect_s), act_step_ms=act_ms,
                        iteration_s=dict(collect=collect_s, with_update=train_s),
                        env_steps_per_s=steps_per_s, update=timing, peak_bytes=peak,
                        last_learner=rows[-1], episode_return_mean=r.get("episode_return_mean"))
    algo.stop()
    log(f"[rl] rl_dreamer (b) DreamerV3Config() defaults on {device}: {len(collect_s)} "
        f"collect-only iterations, {act_ms:.3f} ms an act step (median iteration / {frag}); "
        f"{steps_per_s:.1f} env steps/s over {iters} iterations with an update; peak "
        f"{(peak or 0) / 2**30:.3f} GiB; last wm_loss {rows[-1]['wm_loss']:.4f}")
    log_timing("rl_dreamer (b)", "DreamerV3._update [8, 24], H 15", timing, DREAMER_PROFILED)

    algo = (DreamerV3Config().environment(NumpyCartPole).resources(device=device)
            .training(deter=64, stoch=4, classes=4, model={"hiddens": (64, 64)},
                      batch_size_B=8, batch_length_T=16, horizon=5, rollout_fragment_length=128,
                      num_steps_sampled_before_learning_starts=128, train_intensity=8)
            .debugging(seed=1).build())
    recon = [lm["wm_recon"] for lm in (algo.train().get("learner") for _ in range(6)) if lm]
    algo.stop()
    out["world_model"] = dict(wm_recon=recon, ratio=recon[-1] / recon[0])
    log(f"[rl] rl_dreamer (c) JAX's world-model case on {device}: wm_recon {recon[0]:.4f} -> "
        f"{recon[-1]:.4f} (ratio {recon[-1] / recon[0]:.3f}, bar 0.7)")
    if not recon[-1] < 0.7 * recon[0]:
        raise AssertionError(f"rl_dreamer: the world model did not learn: {recon}")
    out["launches"] = no_launches("rl_dreamer", device)
    return out


def check_dp_raises(device="cuda"):
    """The dp learner group on one card: num_learners=2 on a world of one
    rank raises JAX's ValueError."""
    from ray_tpu_torch.rllib import ModuleSpec, PPOConfig, RLModule, make_learner_group
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner
    import torch.distributed as dist
    cfg = PPOConfig().learners(num_learners=2).resources(device=device)
    started = not dist.is_initialized()
    try:
        make_learner_group(PPOLearner, RLModule(ModuleSpec((4,), "discrete", 2)), cfg)
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError("rl: num_learners=2 on a world of one rank did not raise")
    if started:        # the one-rank world the group started to count its ranks
        dist.destroy_process_group()
    if not msg.startswith("num_learners=2 but only 1 "):
        raise AssertionError(f"rl: num_learners=2 raised {msg!r}")
    log(f"[rl] num_learners=2 on one card: ValueError({msg[:60]!r}...)")
    return msg


def device_impala():
    """The port's IMPALA on CartPole's module spec, built without its
    inline EnvRunner (gymnasium is not on the chip machine): the learner
    alone, fed by DeviceRollout(TorchCartPole)."""
    from ray_tpu_torch.rllib import TorchCartPole
    from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALALearner
    from ray_tpu_torch.rllib.learner import make_learner_group
    from ray_tpu_torch.rllib.rl_module import RLModule

    class DeviceIMPALA(IMPALA):
        def setup(self, config):
            self.learner_group = make_learner_group(
                IMPALALearner, RLModule(TorchCartPole.spec()), config, seed=config.seed)
            self.learner = self.learner_group.learner

    return DeviceIMPALA


def run_rl_sebulba(device="cuda", iters=3):
    """(h) Path `rl_sebulba`: the sebulba pipeline's lockstep schedule, in
    process, as ray_tpu's SebulbaPipeline drives it over actors: the port's
    RolloutActor on jax_env="cartpole" (DeviceRollout(TorchCartPole) on
    `device`) at IMPALA's defaults (1 env x 50 steps, seed 0), its weights
    at version 0, then `iters` times sample_traj, IMPALA's _sebulba_update
    on the trajectory without its version and actor, and set_weights(w,
    version). The IMPALA is the port's, built without its inline EnvRunner
    (gymnasium is not on the chip machine). Its params must be torch.equal
    to the same learner fed the same DeviceRollout directly, the recompile
    guard must read 1, the `pipeline.act` windows must carry versions
    0..iters-1, and no kernel may launch."""
    import torch
    from ray_tpu_torch.rllib import DeviceRollout, IMPALAConfig, TorchCartPole
    from ray_tpu_torch.rllib.algorithms.impala import IMPALALearner
    from ray_tpu_torch.rllib.rl_module import RLModule
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    from ray_tpu_torch.rllib.sebulba import RolloutActor
    from ray_tpu_torch.util import tracing

    DeviceIMPALA = device_impala()
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    cfg = IMPALAConfig().resources(device=device).sebulba(enabled=False, lockstep=True,
                                                          jax_env="cartpole")
    kw = dict(num_envs=cfg.num_envs_per_env_runner, rollout_len=cfg.rollout_fragment_length,
              seed=cfg.seed)
    algo = DeviceIMPALA(cfg)
    actor = RolloutActor({**kw, "device": cfg.device}, index=0, jax_env=cfg.sebulba_jax_env)
    ref = IMPALALearner(RLModule(TorchCartPole.spec()), cfg, seed=cfg.seed)
    ref_roll = DeviceRollout(TorchCartPole, device=device, **kw)
    tracing.clear()
    reset_launch_counts()
    actor.set_weights(algo.get_weights(), 0)
    times = []
    for version in range(1, iters + 1):
        t0 = time.perf_counter()
        traj, info = actor.sample_traj()
        algo._sebulba_update(SampleBatch({k: v for k, v in traj.items()
                                          if k not in ("version", "actor")}))
        actor.set_weights(algo.get_weights(), version)
        sync()
        times.append(time.perf_counter() - t0)
        ref_roll.set_weights(ref.get_weights(), version - 1)
        ref.update(ref_roll.sample())
    launches = no_launches("rl_sebulba", device)
    got, want = algo.get_weights(), ref.get_weights()
    equal = got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    versions = [e["args"]["version"] for e in tracing.events() if e["name"] == "pipeline.act"]
    cache = algo.learner.jit_cache_size()
    checks = {
        f"params torch.equal to the learner fed DeviceRollout directly, after {iters} "
        f"iterations": equal,
        f"jit_cache_size() == 1 ({cache})": cache == 1,
        f"pipeline.act windows carry versions {list(range(iters))} ({versions})":
            versions == list(range(iters)),
        f"info steps == {kw['num_envs'] * kw['rollout_len']} ({info['steps']})":
            info["steps"] == kw["num_envs"] * kw["rollout_len"],
    }
    for what, ok in checks.items():
        log(f"[rl] rl_sebulba {'ok  ' if ok else 'FAIL'} {what}")
    log(f"[rl] rl_sebulba lockstep on {device}: {iters} iterations of sample_traj + "
        f"_sebulba_update + set_weights, {1e3 * float(np.median(times)):.2f} ms an iteration "
        f"(median; {smi_line()})")
    if not all(checks.values()):
        raise AssertionError(f"rl_sebulba checks failed: {checks}")
    return dict(iterations=iters, params_equal=equal, jit_cache_size=cache,
                act_versions=versions, ms_an_iteration=[1e3 * t for t in times],
                launches=launches)


def run_rl_sebulba_actors(device="cuda", iters=3, async_updates=20):
    """(i) Path `rl_sebulba_actors`: the port's own SebulbaPipeline on the
    port's runtime, through `.sebulba(enabled=True, ...)` of IMPALA at its
    defaults (1 env x 50 steps, seed 0; train_batch_size one rollout):
    one RolloutActor of DeviceRollout(TorchCartPole) on `device`, which
    claims the card (num_gpus=1), and one ReplayActor; the learner here.
    Lockstep (fifo replay, blocking broadcasts): after `iters` train()
    iterations the params must be torch.equal to the same learner fed
    DeviceRollout directly, the gap 0 on every update and the signature
    cache 1. Async: 1 rollout actor with 2 rollouts in flight until
    `async_updates` updates: env-steps/s, the off-policy gap counts and
    the stale drops read. No kernel may launch here."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import DeviceRollout, IMPALAConfig, TorchCartPole
    from ray_tpu_torch.rllib.algorithms.impala import IMPALALearner
    from ray_tpu_torch.rllib.rl_module import RLModule

    cuda = torch.device(device).type == "cuda"
    DeviceIMPALA = device_impala()

    def config():
        base = IMPALAConfig().resources(device=device)
        return base.training(train_batch_size=base.num_envs_per_env_runner
                             * base.rollout_fragment_length)

    out = {}
    own = not rt.is_initialized()
    try:
        if own:
            out["init_s"] = open_session(device)
        reset_launch_counts()
        cfg = config().sebulba(enabled=True, lockstep=True, jax_env="cartpole")
        t0 = time.perf_counter()
        algo = DeviceIMPALA(cfg)
        out["pipeline_up_s"] = time.perf_counter() - t0
        try:
            binding = rt.get(algo._sebulba.actors[0].node_info.remote(), timeout=120)
            t0 = time.perf_counter()
            results = [algo.train() for _ in range(iters)]
            out["lockstep_s"] = time.perf_counter() - t0
            got = algo.get_weights()
        finally:
            algo.stop()
        stats = results[-1]["sebulba"]
        ref = IMPALALearner(RLModule(TorchCartPole.spec()), cfg, seed=cfg.seed)
        roll = DeviceRollout(TorchCartPole, device=device, num_envs=cfg.num_envs_per_env_runner,
                             rollout_len=cfg.rollout_fragment_length, seed=cfg.seed)
        for version in range(stats["updates"]):
            roll.set_weights(ref.get_weights(), version)
            ref.update(roll.sample())
        want = ref.get_weights()
        equal = got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)

        acfg = config().sebulba(enabled=True, num_rollout_actors=1, inflight_rollouts=2,
                                jax_env="cartpole")
        algo = DeviceIMPALA(acfg)
        try:
            t0 = time.perf_counter()
            while algo._sebulba.updates < async_updates:
                last = algo.train()
            async_s = time.perf_counter() - t0
            replay = rt.get(algo._sebulba.replay.stats.remote(), timeout=120)
        finally:
            algo.stop()
        launches = no_launches("rl_sebulba_actors", device)
    finally:
        if own:
            out["session_workers"] = close_session("rl_sebulba_actors")
    s = last["sebulba"]
    out.update(iterations=iters, params_equal=equal, lockstep=dict(
        updates=stats["updates"], gap_counts=stats["gap_counts"],
        jit_cache_size=stats["jit_cache_size"], broadcasts=stats["broadcasts"]),
        rollout_actor=binding, launches=launches, async_=dict(
            updates=s["updates"], env_steps=s["env_steps"], seconds=async_s,
            env_steps_per_s=s["env_steps"] / async_s, gap_counts=s["gap_counts"],
            stale_dropped=s["stale_dropped"], broadcasts_async=s["broadcasts_async"],
            replay=replay))
    checks = {
        f"lockstep params torch.equal to the learner fed DeviceRollout directly after {iters} "
        f"iterations ({stats['updates']} updates)": equal and stats["updates"] == iters,
        f"lockstep gap 0 on every update ({stats['gap_counts']}), signature cache 1 "
        f"({stats['jit_cache_size']})": stats["gap_counts"] == {0: iters}
        and stats["jit_cache_size"] == 1,
        f"the rollout actor ran in its own process ({binding['pid']})":
            binding["pid"] != os.getpid(),
        f"async: {s['updates']} updates >= {async_updates}": s["updates"] >= async_updates,
    }
    for what, ok in checks.items():
        log(f"[rl] rl_sebulba_actors {'ok  ' if ok else 'FAIL'} {what}")
    log(f"[rl] rl_sebulba_actors on {device}: pipeline up {out['pipeline_up_s']:.2f} s; "
        f"lockstep {iters} iterations {out['lockstep_s']:.2f} s; async (1 actor, 2 in flight) "
        f"{s['updates']} updates, {s['env_steps']} env steps in {async_s:.2f} s = "
        f"{s['env_steps'] / async_s:.1f} env-steps/s, gap counts {s['gap_counts']}, stale "
        f"drops {s['stale_dropped']}, async broadcasts {s['broadcasts_async']}"
        + (f" ({smi_line()})" if cuda else ""))
    if not all(checks.values()):
        raise AssertionError(f"rl_sebulba_actors checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}")
    return out


RL_PATHS = ("rl_device", "rl_cnn", "rl_offline", "rl_offpolicy", "rl_multi_agent",
            "rl_dreamer", "rl_sebulba", "rl_sebulba_actors")


def run_rl(device="cuda"):
    """The `rl` phase: (a) cuda-against-cpu parity of every learner's update,
    (b) path `rl_device`, (c) path `rl_cnn`, (d) path `rl_offline`, (e) path
    `rl_offpolicy`, (f) path `rl_multi_agent`, (g) path `rl_dreamer`, (h)
    path `rl_sebulba`, (i) path `rl_sebulba_actors`, and the dp learner
    group's ValueError on one card. Path `rl_ppo`
    (PPOConfig().environment("CartPole-v1")...build().train()), the online
    off-policy Algorithms' `train()` and `PPOConfig().multi_agent(...)`
    need gymnasium, which the chip machine does not have: they are held by
    the CPU tests."""
    out, seconds = {}, {}
    for name, fn in (("parity", check_rl_parity), ("parity_offpolicy", check_offpolicy_parity),
                     ("rl_device", run_rl_device), ("rl_cnn", run_rl_cnn),
                     ("rl_offline", run_rl_offline), ("rl_offpolicy", run_rl_offpolicy),
                     ("rl_multi_agent", run_rl_multi_agent), ("rl_dreamer", run_rl_dreamer),
                     ("rl_sebulba", run_rl_sebulba),
                     ("rl_sebulba_actors", run_rl_sebulba_actors),
                     ("dp_raises", check_dp_raises)):
        t0 = time.perf_counter()
        out[name] = fn(device)
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = sum(seconds.values())
    out["phase_seconds"] = seconds
    out["launches"] = {path: out[path]["launches"] for path in RL_PATHS}
    log(f"[rl] phase took {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in seconds.items()) + ")")
    return out


# ------------------------------------------------------------------ cards
CARDS_OUT = "chip_smoke_cards4.json"
CARDS_PHASES = ("runtime", "serve", "actors", "cluster", "tune", "rl_dp", "seqpipe", "tp",
                "fsdp")
RING_SEQ_CARDS = 16384          # ring at sp=4: 4096 tokens a card


def _cards_rank(rank, world, store, results, device, presets, max_tokens, phases, prior):
    import os
    import traceback
    ok = False
    try:
        _tp_rank_world(rank, world, store, "nccl" if device == "cuda" else "gloo",
                       rank if device == "cuda" else None)
        out = cards_phases(rank, world, device, presets, max_tokens, phases, prior)
        results.put((rank, out, None))
        ok = True
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, None, traceback.format_exc()))
    # the last phase leaves a failed tp server: over NCCL a stream may hold
    # a collective that waits for the failed rank, and a teardown of the
    # process group would wait on it. The result is flushed; the process
    # exits as it is.
    results.close()
    results.join_thread()
    os._exit(0 if ok else 1)


def _world_barrier(device):
    import torch
    import torch.distributed as dist
    if device == "cuda":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _per_card(device):
    """Every rank's (peak allocated bytes since its last reset, kernel
    launches since the last reset of the counts)."""
    import torch
    import torch.distributed as dist
    mine = (torch.cuda.max_memory_allocated() if device == "cuda" else None, launch_counts())
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, mine)
    return seen


def _reset_peak(device):
    import gc
    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _serve_tp_world(rank, tp, preset, dtype, device, prompts, max_tokens, capture=False,
                    keep=False, **kw):
    """Every rank builds LLMServer(tp) (rank 0 alone for tp=1); rank 0 serves
    the waves, ranks 1..tp-1 follow, the rest wait. No rank may launch a
    kernel (the dense cache attends with the plain decode_attention).
    Returns (rank 0's summary or None, the server when keep=True on rank
    0)."""
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer
    _reset_peak(device)
    reset_launch_counts()
    out, server = None, None
    if tp > 1 or rank == 0:
        t0 = time.perf_counter()
        server = LLMServer(LLMConfig(**tp_server_config(preset, tp, dtype, device, **kw)))
        build_s = time.perf_counter() - t0
        if rank == 0:
            out = serve_waves(server, prompts, max_tokens, capture=capture)
            out["build_s"] = build_s
            server.shutdown()
        else:
            server.follow()
    seen = _per_card(device)
    launched = {name: sum(c[name] for _, c in seen) for name in seen[0][1]}
    if any(launched.values()):
        raise AssertionError(f"{preset} tp={tp}: kernels launched on the tp ranks: {launched}")
    if out is not None:
        out["peak_bytes_per_card"] = [p for p, _ in seen[:tp]]
        out["launches"] = launched
    if not (keep and rank == 0):
        server = None
    _reset_peak(device)
    _world_barrier(device)
    return out, server


def _spec_tp_world(rank, world, device):
    """Speculation's accept path at tp=world, as check_spec_tiny does on one
    card: the tiny preset (vocab 256; n_kv_heads raised to `world`, so that
    tp divides it) in f32 on weights made on the CPU from seed 0, prompt
    P + O + P with O the plain tp server's continuation of P, speculate=4
    against speculate=0 at the same tp. A random llama_1b rarely follows
    its own continuation, so it drafts nothing. Rank 0 returns both ids
    and the speculation stats."""
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer
    kw = dict(model_overrides={"n_kv_heads": world}, max_seq_len=512, max_batch_slots=2)
    params = LLMServer(LLMConfig(**tp_server_config("tiny", 1, "float32", "cpu", **kw))
                       ).model.state_dict()
    head = np.random.default_rng(21).integers(1, 256, 16).tolist()
    out = {}
    for spec in (0, 4):
        server = LLMServer(LLMConfig(**tp_server_config("tiny", world, "float32", device,
                                                        speculate=spec, **kw)), params=params)
        if rank == 0:
            if not spec:
                cont = asyncio.run(server.generate(head, max_tokens=48))["tokens"]
                out["prompt"] = head + cont + head
            out[spec] = asyncio.run(server.generate(out["prompt"], max_tokens=48))["tokens"]
            out["stats"] = server.stats().get("speculation")
            server.shutdown()
        else:
            server.follow()
        del server
        _world_barrier(device)
    return out if rank == 0 else None


def seqpipe_cards(world, dev, presets):
    """The ranks' `seqpipe` phases: ring at sp=world (bf16 at the preset's
    depth, timed; f32 at 2 layers) and pipeline_apply at pp=world (f32 with
    its gradient; bf16 timed). Returns the lead rank's readings."""
    from ray_tpu_torch.parallel.mesh import make_mesh
    llama, ov = presets["llama"], presets.get("seqpipe_overrides", {})
    t_ring, t_pipe = presets.get("ring_seq", RING_SEQ_CARDS), presets.get("pipe_seq", 2048)
    sp_mesh = make_mesh({"sp": world}, device=dev.type)
    ring = dict(bf16=check_ring(sp_mesh, dev, llama, "bfloat16", 1, t_ring, ov, timed=True,
                                tag="cards"),
                f32_2layer=check_ring(sp_mesh, dev, llama, "float32", 1, t_ring // 4,
                                      dict(ov, n_layers=2), tag="cards"))
    pp_mesh = make_mesh({"pp": world}, device=dev.type)
    pipe = dict(f32=check_pipeline_apply(pp_mesh, dev, "float32", 8, t_pipe, preset=llama,
                                         overrides=ov, tag="cards"),
                bf16=check_pipeline_apply(pp_mesh, dev, "bfloat16", 8, t_pipe, grad=False,
                                          timed=True, preset=llama, overrides=ov, tag="cards"))
    return dict(ring_sp=ring, pipeline_apply_pp=pipe)


# ------------------------------------------------------------------ fsdp
# Training over meshes of four cards (`--cards 4`, group `fsdp`): the 8B at
# full width over fsdp=4 and fsdp=2 x tp=2, f32 llama_1b and Mixtral-width
# layouts against one card, and a sharded checkpoint.
FSDP_PRESET = "llama_8b"
FSDP_MESHES = ({"fsdp": 4}, {"fsdp": 2, "tp": 2})
FSDP_WARM, FSDP_TIMED = 2, 5
# Step 1's loss of the 8B on the two meshes, relative. The meshes' sound
# gap is rounding (fsdp=2 x tp=2's psums of bf16 partial sums); on an
# NVIDIA H100 80GB HBM3 (700 W) it read 5.58e-5, and the planted faults
# (FSDP_CONTROLS) read 7.22e-4 (a rank's gather out of order) and 9.27e-5
# (the gradient mean skipped) at step 2. The limit sits between the sound
# gap and the weaker fault; every reading is deterministic (the kernels,
# cuBLAS and NCCL give the same bits on the same inputs), and the skipped
# mean is also read by the replicated params, which it makes differ across
# ranks (1e-3) where every sound run keeps them equal.
FSDP_LOSS_TOL = 7.5e-5
FSDP_CONTROLS = ("gather_order", "no_grad_mean")
LAYOUT_LOSS_TOL = 1e-5   # f32 layouts against one card, relative
LAYOUT_MESHES = ({"fsdp": 4}, {"dp": 2, "fsdp": 2}, {"fsdp": 2, "tp": 2})
MOE_LAYOUT_MESHES = ({"ep": 4}, {"ep": 2, "tp": 2})


@contextlib.contextmanager
def fsdp_control(name, rank):
    """A planted fault for the 8B's loss limit: "gather_order", rank 1
    gathers its fsdp blocks with the first two swapped (every weight, each
    step); "no_grad_mean", no rank means its gradients over the batch axes
    (no all-reduce of the replicated params, no division)."""
    import torch
    from ray_tpu_torch.models.llama import ShardPlace
    from ray_tpu_torch.train.llm_step import GradMean
    cls, attr = (ShardPlace, "gather_fsdp") if name == "gather_order" else (GradMean, "__call__")
    real = getattr(cls, attr)

    def wrong_order(self, w, dim):
        w = real(self, w, dim)
        if self.fsdp == 1:
            return w
        blocks = list(w.chunk(self.fsdp, dim))
        blocks[0], blocks[1] = blocks[1], blocks[0]
        return torch.cat(blocks, dim)

    if name == "gather_order" and rank == 1:
        setattr(cls, attr, wrong_order)
    elif name == "no_grad_mean":
        setattr(cls, attr, lambda self: None)
    try:
        yield
    finally:
        setattr(cls, attr, real)


def _fsdp_run(rank, world, device, axes, preset, seq, warm, timed, control=None,
              profile=False):
    """Path `train_fsdp` on one mesh: build_llama_trainer(preset, world rows
    of `seq`, remat on, mesh=...) from seed 0, fed by
    iter_device_batches(sharding=data_sharding(mesh)); `warm` untimed and
    `timed` timed steps, the launch counts reset just before and read
    just after, then (`profile`) one more step under torch.profiler on
    rank 0. Returns this rank's readings."""
    import torch
    from ray_tpu_torch.models.llama import llama_compute_flops, llama_param_count
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import data_sharding
    from ray_tpu_torch.train import iter_device_batches
    from ray_tpu_torch.train.llm_step import build_llama_trainer
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mesh = make_mesh(axes, device=device)
    _reset_peak(device)
    with fsdp_control(control, rank) if control else contextlib.nullcontext():
        t0 = time.perf_counter()
        model, opt, step, batches, _ = build_llama_trainer(preset, world, seq, remat=True,
                                                         device=device, mesh=mesh)
        sync()
        build_s = time.perf_counter() - t0
        n = warm + timed + (1 if profile else 0)
        feed = iter_device_batches([batches[i % len(batches)] for i in range(n)], prefetch=2,
                                   sharding=data_sharding(mesh))
        reset_flash_counts()
        losses = [step(next(feed)) for _ in range(warm)]
        sync()
        t0 = time.perf_counter()
        losses += [step(next(feed)) for _ in range(timed)]
        sync()
        dt = time.perf_counter() - t0
        launches = dict(zip(FLASH_NAMES, flash_counts()))
        prof = None
        if profile:
            if rank == 0 and cuda:
                prof = profile_call(lambda: step(next(feed)))
            else:
                step(next(feed))
                sync()
    # the replicated params (norm scales) after the steps, on every rank
    replicated = {k: v.detach().float().cpu() for k, v in model.state_dict().items()
                  if k.endswith("scale")}
    replicas = [None] * world
    torch.distributed.all_gather_object(replicas, replicated)
    cfg = model.cfg
    out = dict(axes=axes, losses=[x.item() for x in losses], launches=launches,
               build_s=build_s, ms_per_step=dt / timed * 1e3 if timed else None,
               tokens_per_s=world * seq * timed / dt if timed else None,
               tflops_per_card=(llama_compute_flops(cfg, world, seq) / (dt / timed) / world
                                / 1e12 if timed else None),
               params=llama_param_count(cfg), layers=cfg.n_layers, profile=prof,
               replicated=replicated,
               replicas_equal=all(equal_trees(r, replicated) for r in replicas))
    del model, opt, step, feed
    seen = _per_card(device)
    out["peak_bytes_per_card"] = [p for p, _ in seen]
    _reset_peak(device)
    _world_barrier(device)
    return out


def _rel(a, b):
    return abs(a - b) / abs(b)


def train_fsdp_cards(rank, world, device, presets):
    """(a) The 8B over FSDP_MESHES and the planted faults (module note on
    FSDP_LOSS_TOL); rank 0 returns the readings, and raises where a check
    fails."""
    preset = presets.get("fsdp", FSDP_PRESET)
    seq = presets.get("fsdp_seq", 2048)
    runs = {}
    for axes in FSDP_MESHES:
        runs[str(axes)] = _fsdp_run(rank, world, device, axes, preset, seq, FSDP_WARM,
                                    FSDP_TIMED, profile=True)
    for control in FSDP_CONTROLS:
        runs[control] = _fsdp_run(rank, world, device, FSDP_MESHES[0], preset, seq, 2, 0,
                                  control=control)
    if rank != 0:
        return None
    a, b = (runs[str(axes)] for axes in FSDP_MESHES)
    layers = a["layers"]
    n_steps = FSDP_WARM + FSDP_TIMED
    want = {"flash_fwd": 2 * layers * n_steps, "flash_bwd_dq": layers * n_steps,
            "flash_bwd_dkv": layers * n_steps}
    readings = {"meshes_step1": _rel(b["losses"][0], a["losses"][0])}
    for c in FSDP_CONTROLS:
        got = runs[c]
        readings[c] = dict(step1=_rel(got["losses"][0], a["losses"][0]),
                           step2=_rel(got["losses"][1], a["losses"][1]),
                           replicated_max_abs_diff=max(
                               float((got["replicated"][k] - a["replicated"][k]).abs().max())
                               for k in a["replicated"]))
    peak = 989e12 if device == "cuda" else None
    checks = {
        "every loss finite": all(np.isfinite(r["losses"]).all() for r in runs.values()),
        f"step 1's loss on {FSDP_MESHES[1]} within {FSDP_LOSS_TOL:g} of {FSDP_MESHES[0]}'s "
        f"({readings['meshes_step1']:.3e})": readings["meshes_step1"] <= FSDP_LOSS_TOL,
    }
    for r in (a, b):
        checks[f"{r['axes']}: the replicated params equal on every rank"] = r["replicas_equal"]
    # each control must miss the loss limit at step 2; its replicas'
    # agreement is logged beside it (AdamW's step is blind to a uniform
    # gradient scale, so a skipped mean shows first in the replicated
    # params). A CPU rehearsal at the tiny size reads the skipped mean by
    # its replicas: there it moves the loss less than the meshes' rounding.
    for c in FSDP_CONTROLS:
        readings[c]["replicas_equal"] = runs[c]["replicas_equal"]
        rejected = readings[c]["step2"] > FSDP_LOSS_TOL
        if device == "cpu":
            rejected = rejected or not runs[c]["replicas_equal"]
        checks[f"control {c} rejected at step 2: loss gap {readings[c]['step2']:.3e} > "
               f"{FSDP_LOSS_TOL:g} (replicas equal across ranks "
               f"{runs[c]['replicas_equal']})"] = rejected
    if device == "cuda":
        for r in (a, b):
            checks[f"{r['axes']}: B1, B2, B3 launched {want} on rank 0"] = r["launches"] == want
    for what, ok in checks.items():
        log(f"[fsdp] {'ok  ' if ok else 'FAIL'} {what}")
    for r in (a, b):
        prof = r["profile"]
        nccl = (prof["nccl_device_s"] / prof["device_kernel_s"]
                if prof and prof["device_kernel_s"] else None)
        r["nccl_share"] = nccl
        mfu = r["tflops_per_card"] * 1e12 / peak if peak else None
        r["mfu"] = mfu
        log(f"[fsdp] {preset} ({r['params']:,} params, {layers} layers) on {r['axes']}, "
            f"{world} x {seq} tokens a step, f32 master weights, bf16 activations, remat: "
            f"{r['ms_per_step']} ms a step, {r['tokens_per_s']} tokens/s, "
            f"{r['tflops_per_card']} model TFLOP/s a card (share of 989: {mfu}), peak "
            f"{[round(p / 2**30, 2) if p else None for p in r['peak_bytes_per_card']]} GiB a "
            f"card, NCCL share of a profiled step {nccl}, built in {r['build_s']:.1f} s, "
            f"losses {[round(x, 5) for x in r['losses']]}")
        if prof:
            log_profile("fsdp", f"one step on {r['axes']}", prof)
    log(f"[fsdp] readings (relative loss gaps): {readings}")
    res = dict(runs={k: {kk: vv for kk, vv in v.items() if kk != "replicated"}
                     for k, v in runs.items()},
               readings=readings, tol=FSDP_LOSS_TOL, checks=checks, want_launches=want)
    if not all(checks.values()):
        raise AssertionError(f"train_fsdp checks failed: {checks}")
    return res


def _layout_runs(rank, world, device, preset, batch, seq, meshes, overrides, tag, steps=2):
    """f32 `steps` steps of `preset` on each mesh against the whole model's on
    card 0, from the same seeded weights and batches: losses within
    LAYOUT_LOSS_TOL relative, the gathered params (gather_state_dict) with
    at most RL_FAR_SHARE of their coordinates lr / 100 apart and none more
    than 2 lr a step. Rank 0 returns the readings."""
    import gc
    import torch
    from ray_tpu_torch.models.convert import gather_state_dict
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import data_sharding
    from ray_tpu_torch.train import iter_device_batches
    from ray_tpu_torch.train.llm_step import build_llama_trainer
    lr = 1e-4
    build = lambda mesh=None: build_llama_trainer(preset, batch, seq, device=device,
                                                  dtype=torch.float32, mesh=mesh,
                                                  overrides=overrides)
    host = lambda model: {k: v.detach().to("cpu", copy=True)
                          for k, v in model.state_dict().items()}
    ref = None
    if rank == 0:       # the whole model on card 0; its params kept on the host
        model, opt, step, batches, dev = build()
        before = host(model)
        losses = [step(torch.from_numpy(b).to(dev)) for b in batches[:steps]]
        ref = dict(losses=[x.item() for x in losses], params=host(model), before=before)
        del model, opt, step, before
    _reset_peak(device)
    _world_barrier(device)
    out = {}
    for axes in meshes:
        mesh = make_mesh(axes, device=device)
        model, opt, step, batches, _ = build(mesh)
        losses = [step(t).item() for t in iter_device_batches(
            batches[:steps], sharding=data_sharding(mesh))]
        whole = gather_state_dict(model.state_dict(), mesh)
        whole = {k: v.cpu() for k, v in whole.items()} if rank == 0 else None
        del model, opt, step
        diffs = moved = None
        if rank == 0:
            diffs = torch.cat([(whole[k].float() - ref["params"][k].float()).abs().flatten()
                               for k in ref["params"]])
            moved = torch.cat([(ref["params"][k].float() - ref["before"][k].float()).abs()
                               .flatten() for k in ref["params"]])
            out[str(axes)] = dict(
                losses=losses, ref_losses=ref["losses"],
                loss_rel=max(_rel(x, y) for x, y in zip(losses, ref["losses"])),
                param_max_abs=float(diffs.max()),
                far_share=float((diffs > lr / 100).float().mean()),
                moved_share=float((moved > lr / 100).float().mean()))
            r = out[str(axes)]
            log(f"[fsdp] {tag} f32 on {axes} against one card: losses {losses} vs "
                f"{ref['losses']} (rel {r['loss_rel']:.3e}, limit {LAYOUT_LOSS_TOL:g}), params "
                f"max |diff| {r['param_max_abs']:.3e} (bound {2 * lr * steps:.1e}), share "
                f"lr/100 apart {r['far_share']:.2e} (limit {RL_FAR_SHARE:g}; the steps moved "
                f"{r['moved_share']:.3f})")
        del whole, diffs, moved
        gc.collect()
        _reset_peak(device)
        _world_barrier(device)
    del ref
    if rank != 0:
        return None
    bad = {k: v for k, v in out.items() if not (
        v["loss_rel"] <= LAYOUT_LOSS_TOL and v["param_max_abs"] <= 2 * lr * steps
        and v["far_share"] <= RL_FAR_SHARE and v["moved_share"] > 0.5)}
    if bad:
        raise AssertionError(f"{tag} layouts disagree with one card: {bad}")
    return out


def checkpoint_fsdp_cards(rank, world, device, preset, seq, steps=6, save_at=3):
    """(c) The sharded checkpoint: `preset` (bf16 params) on {"fsdp": world},
    `world` rows of `seq`, saved after step `save_at` of `steps` (each rank
    writing its own blocks of the params and AdamW's moments, in a
    temporary directory removed at the end), restored into a fresh model
    and AdamW on the same mesh, steps save_at+1..steps: losses and every
    rank's blocks torch.equal to the uninterrupted run. Then the same
    checkpoint is read whole and restored onto another mesh
    (`_whole_fsdp_cards`). Rank 0 returns the bytes a rank and the seconds
    to save, to restore, to read whole and to reshard."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.convert import gather_state_dict
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import data_sharding
    from ray_tpu_torch.train import Checkpoint, iter_device_batches
    from ray_tpu_torch.train.llm_step import build_llama_trainer, train_state
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    mesh = make_mesh({"fsdp": world}, device=device)
    where = [tempfile.mkdtemp(prefix="chip_smoke_shards_") if rank == 0 else None]
    dist.broadcast_object_list(where, src=0)
    path = os.path.join(where[0], "ck")
    build = lambda seed: build_llama_trainer(preset, world, seq, device=device, seed=seed,
                                             mesh=mesh)
    feed = lambda bs: iter_device_batches(bs, sharding=data_sharding(mesh))
    try:
        model, opt, step, batches, _ = build(0)
        losses = [step(t) for t in feed(batches[:save_at])]
        state, specs = train_state(model, opt, step=save_at)
        sync()
        t0 = time.perf_counter()
        Checkpoint.from_state(state, path=path, mesh=mesh, specs=specs)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, "shards", f"rank-{rank:05d}.pt"))
        live = gather_state_dict(model.state_dict(), mesh)     # the whole, by collectives
        live = {k: v.to("cpu", copy=True) for k, v in live.items()} if rank == 0 else None
        losses += [step(t) for t in feed(batches[save_at:steps])]
        final = snapshot(model)
        del model, opt, step, state
        _reset_peak(device)
        model, opt, step, _, _ = build(1)
        sync()
        t0 = time.perf_counter()
        got = Checkpoint.from_directory(path).to_state(target=train_state(model, opt)[0],
                                                       mesh=mesh)
        model.load_state_dict(got["model"])
        opt.load_state_dict(got["optim"])
        sync()
        restore_s = time.perf_counter() - t0
        del got
        resumed = [step(t) for t in feed(batches[save_at:steps])]
        equal = dict(losses=all(torch.equal(x, y) for x, y in zip(resumed, losses[save_at:])),
                     blocks=equal_trees(snapshot(model), final))
        del model, opt, step, final
        _reset_peak(device)
        whole = _whole_fsdp_cards(rank, device, preset, seq, path, live)
        del live
    finally:
        _world_barrier(device)
        if rank == 0:
            shutil.rmtree(where[0], ignore_errors=True)
    seen = [None] * world
    dist.all_gather_object(seen, dict(equal=equal, bytes=nbytes, save_s=save_s,
                                      restore_s=restore_s, whole=whole))
    _reset_peak(device)
    if rank != 0:
        return None
    out = dict(ranks=seen, losses=[x.item() for x in losses], removed=not os.path.exists(where[0]))
    ok = all(r["equal"]["losses"] and r["equal"]["blocks"] and not r["whole"]["bad"]
             for r in seen) and out["removed"] and seen[0]["whole"]["ids_equal"] and seen[0][
        "whole"]["weights_equal"]
    log(f"[fsdp] sharded checkpoint, {preset} bf16 on {{'fsdp': {world}}}, saved after step "
        f"{save_at} of {steps}, restored into a fresh model and AdamW: losses and every "
        f"rank's blocks torch.equal the uninterrupted run "
        f"{[r['equal'] for r in seen]}; bytes a rank {[r['bytes'] for r in seen]}, save s "
        f"{[round(r['save_s'], 3) for r in seen]}, restore s "
        f"{[round(r['restore_s'], 3) for r in seen]}; directory removed {out['removed']}")
    w = [r["whole"] for r in seen]
    log(f"[fsdp] the same checkpoint read whole on every rank ({w[0]['read_threads']} threads "
        f"a rank; s {[round(x['whole_s'], 2) for x in w]}): rank 0's whole weights torch.equal "
        f"gather_state_dict of the live blocks {w[0]['weights_equal']}, served on card 0 with "
        f"greedy ids equal a server built from the gathered weights {w[0]['ids_equal']} "
        f"({w[0]['prompts']} prompts x {CKPT_WHOLE_TOKENS} tokens); restored onto "
        f"{CKPT_WHOLE_ONTO} (s {[round(x['reshard_s'], 2) for x in w]}), every block and moment "
        f"torch.equal shard_state_dict / local_slice of the whole there: "
        f"{[not x['bad'] for x in w]}")
    if not ok:
        raise AssertionError(f"sharded checkpoint: {out}")
    return out


def _whole_fsdp_cards(rank, device, preset, seq, path, live):
    """(c, continued) The fsdp checkpoint at `path` read whole on every
    rank (host tensors); rank 0 serves it on its card: its weights equal
    `live` (gather_state_dict of the blocks when they were saved) and its
    greedy ids on the slice's prompts equal a server built from `live`.
    Then every rank restores it onto CKPT_WHOLE_ONTO with the target's
    specs, each block and AdamW moment torch.equal the whole's block
    there (shard_state_dict, local_slice), in the saved dtype. The reads
    run with the host's cores shared among the ranks, as torchrun's
    OMP_NUM_THREADS does: with torch's default (every core in each of 4
    ranks) a whole read took 55-56 s a rank on four H100s (32 host cores)."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.convert import shard_state_dict
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import local_slice
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.train import Checkpoint
    ckpt = Checkpoint.from_directory(path)
    threads, read_threads = torch.get_num_threads(), max(
        1, (os.cpu_count() or 1) // dist.get_world_size())
    torch.set_num_threads(read_threads)
    t0 = time.perf_counter()
    whole = ckpt.to_state()
    whole_s = time.perf_counter() - t0
    other = make_mesh(CKPT_WHOLE_ONTO, device=device)
    dtype = str(whole["model"]["layers_0.attn.wq.weight"].dtype).rsplit(".", 1)[-1]
    _, tspecs = _meta_state(preset, seq, other, dtype)
    t0 = time.perf_counter()
    got = ckpt.to_state(mesh=other, specs=tspecs)
    reshard_s = time.perf_counter() - t0
    want = shard_state_dict(whole["model"], other)
    bad = [k for k, v in got["model"].items()
           if v.dtype != whole["model"][k].dtype or not torch.equal(v, want[k])]
    for i, spec in tspecs["optim"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            g, w = got["optim"]["state"][i][name], whole["optim"]["state"][i][name]
            if g.dtype != w.dtype or not torch.equal(g, local_slice(w, spec[name], other)):
                bad.append(f"optim {i} {name}")
    del got, want
    torch.set_num_threads(threads)
    out = dict(whole_s=whole_s, reshard_s=reshard_s, bad=bad, read_threads=read_threads)
    if rank == 0:
        prompts = sum(slice_prompts(whole["model"]["embed.embedding"].shape[0]), [])
        gen = lambda srv, p: asyncio.run(srv.generate(p, max_tokens=CKPT_WHOLE_TOKENS))["tokens"]
        served = LLMServer(serving_config(preset, device), params=whole["model"])
        got_ids = [gen(served, p) for p in prompts]
        del served
        ref = LLMServer(serving_config(preset, device), params=live)
        want_ids = [gen(ref, p) for p in prompts]
        del ref
        out.update(prompts=len(prompts), ids_equal=got_ids == want_ids,
                   weights_equal=all(torch.equal(v, live[k]) for k, v in whole["model"].items()))
    del whole
    _reset_peak(device)
    _world_barrier(device)
    return out


def fit_fsdp_cards(rank, world, device, preset, seq, steps=4, save_at=2):
    """(d) Path `fsdp_fit`: (c)'s loop under TorchTrainer on every rank,
    ScalingConfig(num_workers=world), in a temporary directory shared by
    the ranks (removed at the end): a first fit takes `steps` steps and
    reports a sharded checkpoint after step `save_at`; a second fit in a
    fresh directory resumes from the first run's checkpoint_000000 (rank 0's
    copy, whose path every rank knows from the run directory) and takes the
    rest. Rank 0 returns the readings, and raises where a check fails."""
    import tempfile
    import torch
    import torch.distributed as dist
    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import data_sharding
    from ray_tpu_torch.train.llm_step import build_llama_trainer, train_state
    from ray_tpu_torch.train.worker_group import _world_info
    cuda = device == "cuda"
    mesh = make_mesh({"fsdp": world}, device=device)
    where = [tempfile.mkdtemp(prefix="chip_smoke_fit_") if rank == 0 else None]
    dist.broadcast_object_list(where, src=0)
    root = where[0]
    scaling = train.ScalingConfig(num_workers=world, use_gpu=cuda)
    seen = {"losses": {}, "saves": []}

    def loop(config):
        model, opt, step, batches, _ = build_llama_trainer(preset, world, seq, device=device,
                                                           mesh=mesh)
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            got = ckpt.to_state(target=train_state(model, opt)[0], mesh=mesh)
            model.load_state_dict(got["model"])
            opt.load_state_dict(got["optim"])
            start = got["step"]
            del got
        feed = train.iter_device_batches(batches[start:steps], sharding=data_sharding(mesh))
        for n, tokens in zip(range(start + 1, steps + 1), feed):
            loss = step(tokens)
            seen["losses"][n] = loss
            ckpt = None
            if n == save_at:
                state, specs = train_state(model, opt, step=n)
                t0 = time.perf_counter()
                ckpt = train.Checkpoint.from_state(
                    state, path=os.path.join(root, "scratch", f"step{n}"), mesh=mesh,
                    specs=specs)
                seen["saves"].append(time.perf_counter() - t0)
            train.report({"loss": loss.item(), "step": n}, checkpoint=ckpt)
        seen["final"] = snapshot(model)

    def fit(name, resume=None):
        return train.TorchTrainer(loop, scaling_config=scaling,
                                  run_config=train.RunConfig(name=name, storage_path=root),
                                  resume_from_checkpoint=resume).fit()

    world_info = _world_info(scaling)
    try:
        reset_flash_counts()
        with timed_calls(shutil, "copytree") as copies:
            t0 = time.perf_counter()
            first = fit("first")
            first_s = time.perf_counter() - t0
            losses, final = dict(seen["losses"]), seen.pop("final")
            _world_barrier(device)
            kept = os.path.join(first.path, "checkpoint_000000")
            t0 = time.perf_counter()
            second = fit("second", resume=train.Checkpoint(kept))
            second_s = time.perf_counter() - t0
        launches = dict(zip(FLASH_NAMES, flash_counts()))
        equal = dict(losses=all(torch.equal(seen["losses"][n], losses[n])
                                for n in range(save_at + 1, steps + 1)),
                     blocks=equal_trees(seen.pop("final"), final))
        del final
        _world_barrier(device)
        listing = dict(
            first=sorted(os.listdir(first.path)), second=sorted(os.listdir(second.path)),
            kept=sorted(os.listdir(kept)), shards=sorted(os.listdir(os.path.join(kept, "shards"))),
            progress=[len(open(os.path.join(r.path, "progress.jsonl")).readlines())
                      for r in (first, second)])
        mine = dict(equal=equal, world_info=world_info, launches=launches,
                    errors=[repr(first.error), repr(second.error)],
                    steps=[[m["step"] for m in r.metrics_history] for r in (first, second)],
                    copy_s=copies, save_s=seen["saves"], fit_s=[first_s, second_s],
                    bytes_copied=dir_bytes(kept) if rank == 0 else None)
    finally:
        _world_barrier(device)
        if rank == 0:
            shutil.rmtree(root, ignore_errors=True)
    seen_all = [None] * world
    dist.all_gather_object(seen_all, mine)
    _reset_peak(device)
    if rank != 0:
        return None
    layers = getattr(LlamaConfig, preset)().n_layers
    due = layers * (steps + steps - save_at) if cuda else 0     # CPU tensors launch none
    shards = ["layout.json"] + [f"rank-{r:05d}.pt" for r in range(world)]
    out = dict(ranks=seen_all, listing=listing, losses=[losses[n].item()
                                                         for n in sorted(losses)],
               removed=not os.path.exists(root))
    checks = {
        "no error in either fit": all(r["errors"] == ["None", "None"] for r in seen_all),
        f"_world_info is ({world}, rank) on every rank": all(
            tuple(r["world_info"]) == (world, i) for i, r in enumerate(seen_all)),
        f"steps 1-{steps}, then {save_at + 1}-{steps}, on every rank": all(
            r["steps"] == [list(range(1, steps + 1)), list(range(save_at + 1, steps + 1))]
            for r in seen_all),
        f"losses of steps {save_at + 1}-{steps} and every rank's blocks torch.equal": all(
            r["equal"]["losses"] and r["equal"]["blocks"] for r in seen_all),
        f"progress.jsonl by rank 0 alone: {steps}, then {steps - save_at} lines":
            listing["progress"] == [steps, steps - save_at],
        "one checkpoint copy, with every rank's shard and the layout":
            listing["first"] == [".run_id", "checkpoint_000000", "progress.jsonl"]
            and listing["shards"] == shards and len(seen_all[0]["copy_s"]) == 1
            and all(not r["copy_s"] for r in seen_all[1:]),
        f"B1, B2, B3 {due} launches each on every rank ({layers} x {2 * steps - save_at} "
        f"steps)": all(c == due for r in seen_all for c in r["launches"].values()),
        "directory removed": out["removed"],
    }
    for what, ok in checks.items():
        log(f"[fsdp] fit {'ok  ' if ok else 'FAIL'} {what}")
    log(f"[fsdp] fit: {preset} on {{'fsdp': {world}}} through TorchTrainer, sharded "
        f"checkpoint at step {save_at} ({seen_all[0]['bytes_copied']} bytes copied by rank 0 in "
        f"{[round(x, 3) for x in seen_all[0]['copy_s']]} s; saves a rank "
        f"{[[round(x, 3) for x in r['save_s']] for r in seen_all]} s); fit s a rank "
        f"{[[round(x, 2) for x in r['fit_s']] for r in seen_all]}; launches a rank "
        f"{[r['launches'] for r in seen_all]}")
    if not all(checks.values()):
        raise AssertionError(f"fsdp fit checks failed: {checks}")
    return out


def fsdp_cards(rank, world, device, presets):
    """The `fsdp` group: (a) train_fsdp_cards, (b) the f32 layouts of
    llama_1b and a 2-layer Mixtral-width MoE against one card, (c)
    checkpoint_fsdp_cards, (d) fit_fsdp_cards."""
    t0 = time.perf_counter()
    res = dict(train_fsdp=train_fsdp_cards(rank, world, device, presets))
    t1 = time.perf_counter()
    layout_seq = presets.get("layout_seq", 512)
    res["layouts"] = _layout_runs(rank, world, device, presets["llama"], 4, layout_seq,
                                  LAYOUT_MESHES, presets.get("llama_overrides"), "llama")
    moe_ov = dict(presets.get("moe_overrides", {}), n_layers=2)
    res["moe_layouts"] = _layout_runs(rank, world, device, presets["moe"], 4, layout_seq,
                                      MOE_LAYOUT_MESHES, moe_ov, "moe")
    t2 = time.perf_counter()
    res["checkpoint"] = checkpoint_fsdp_cards(rank, world, device, presets["llama"],
                                              presets.get("fsdp_seq", 2048))
    t3 = time.perf_counter()
    res["fit"] = fit_fsdp_cards(rank, world, device, presets["llama"],
                                presets.get("fsdp_seq", 2048))
    res["seconds"] = dict(train_fsdp=t1 - t0, layouts=t2 - t1, checkpoint=t3 - t2,
                          fit=time.perf_counter() - t3)
    if rank == 0:
        log(f"[fsdp] group took {res['seconds']}")
    return res if rank == 0 else {}


DP_TIMED = 10            # timed dp updates an N (their median is reported)


def _dp_cases(rng):
    """rl_dp's learners: PPO at its defaults on one 128-row minibatch, and
    IMPALA at its defaults on a [50, 32] batch; (learner, config, batch)."""
    from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig
    from ray_tpu_torch.rllib.algorithms.impala import IMPALALearner
    from ray_tpu_torch.rllib.algorithms.ppo import PPOLearner
    flat = rl_batch(rng, 128, 1)
    ppo = {k: flat[k].reshape((128,) + flat[k].shape[2:]) for k in PPOLearner._TRAIN_KEYS}
    tb = rl_batch(rng, 50, 32)
    impala = {k: tb[k] for k in IMPALALearner._TRAIN_KEYS}
    return dict(ppo=(PPOLearner, PPOConfig(), ppo), impala=(IMPALALearner, IMPALAConfig(), impala))


def _dp_rank(rank, world, store, results, device, port):
    """A rank of the `rl_dp` phase started as torchrun starts one: the
    launcher's variables in its environment, no process group up and no
    card bound. `make_learner_group` starts the world and binds the card."""
    import os
    import traceback
    import torch
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ok = False
    try:
        results.put((rank, rl_dp_cards(rank, world, device), None))
        ok = True
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, None, traceback.format_exc()))
    if ok:
        dist.destroy_process_group()
    results.close()
    results.join_thread()
    os._exit(0 if ok else 1)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rl_dp_cards(rank, world, device):
    """The `rl_dp` phase, on ranks that `_dp_rank` started: the dp learner
    group of N = `world` and 2 ranks, built through
    `make_learner_group(cls, module, cfg.learners(num_learners=N))` as an
    Algorithm builds it, against one learner (num_learners=1) on card 0,
    each from the same seeded weights on the same batch (_dp_cases):
    each rank's learner on its own card (cuda:rank), metrics within
    RL_METRIC_TOL, params as compare_updates holds them, and bitwise equal
    on every rank of the group; then ms an update (median of DP_TIMED) at
    N = 1, 2 and `world`, and the bytes all-reduced an update. N = `world`
    comes first, so that every rank has bound its card before the world's
    first collective. Ranks outside a group build its mesh as the group's
    ranks do (a collective call) and wait. No kernel may launch."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.rllib import ModuleSpec, RLModule, make_learner_group
    from ray_tpu_torch.rllib.learner import _host_metrics

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    reset_launch_counts()
    res = {}
    for name, (cls, cfg, batch) in _dp_cases(np.random.default_rng(13)).items():
        cfg = cfg.copy().resources(device=device)
        spec = ModuleSpec((4,), "discrete", 2)
        rows = {}
        for n in (world, 2, 1):
            row = None
            if rank < n:
                group = make_learner_group(cls, RLModule(spec), cfg.copy().learners(num_learners=n),
                                           seed=0)
                learner = group.learner
                want = torch.device("cuda", rank) if cuda else torch.device("cpu")
                on = {learner.device} | {p.device for p in learner.net.parameters()}
                if on != {want} or (n > 1) != (group.mesh is not None):
                    raise AssertionError(f"rl_dp {name} N={n}: rank {rank}'s learner on {on}, "
                                         f"want {want}; mesh {group.mesh}")
                before = learner.get_weights()
                metrics = _host_metrics([learner.update_once(batch)])
                after = learner.get_weights()
                times = []
                for _ in range(DP_TIMED):
                    sync()
                    t0 = time.perf_counter()
                    learner.update_once(batch)
                    sync()
                    times.append(time.perf_counter() - t0)
                row = dict(metrics=metrics, before=before, after=after,
                           ms=1e3 * float(np.median(times)), ms_all=[1e3 * t for t in times],
                           dp_bytes=learner.dp_bytes, card=str(want))
                del group, learner
            elif n > 1:
                make_mesh({"dp": n}, devices=range(n), device=device)
            if n == 1:
                if rank == 0:
                    rows[1] = row
                _world_barrier(device)
                continue
            seen = [None] * world
            dist.all_gather_object(seen, None if row is None else
                                   {k: row[k] for k in ("metrics", "after", "card")})
            if rank == 0:
                same = all(all(torch.equal(o["after"][k], row["after"][k]) for k in row["after"])
                           for o in seen[:n])
                rows[n] = dict(row, ranks_bitwise_equal=same,
                               cards=[o["card"] for o in seen[:n]])
            _world_barrier(device)
        if rank == 0:
            one = rows[1]
            lr = cfg.lr
            out = {}
            for n in (2, world):
                r = rows[n]
                errs = {k: abs(r["metrics"][k] - w) / max(1.0, abs(w))
                        for k, w in one["metrics"].items()}
                worst_abs, far = param_gap(r["after"], one["after"], lr)
                moved = param_gap(one["after"], one["before"], lr)[1]
                out[n] = dict(metric_err=max(errs.values()), metric_errs=errs,
                              param_max_abs=worst_abs, far_share=far, moved_share=moved,
                              ranks_bitwise_equal=r["ranks_bitwise_equal"], cards=r["cards"],
                              ms=r["ms"], ms_all=r["ms_all"], dp_bytes=r["dp_bytes"])
                log(f"[cards] rl_dp {name} dp={n} (learners on {', '.join(r['cards'])}) vs one "
                    f"learner on {one['card']}: metrics "
                    f"{max(errs.values()):.3e} (limit {RL_METRIC_TOL:g}), params max |err| "
                    f"{worst_abs:.3e} (Adam bound {2 * lr:.1e}), share > lr/100 apart {far:.2e} "
                    f"(moved {moved:.3f}), ranks bitwise equal {r['ranks_bitwise_equal']}; "
                    f"{r['ms']:.3f} ms an update, {r['dp_bytes']} bytes all-reduced")
                if (max(errs.values()) > RL_METRIC_TOL or worst_abs > 2 * lr
                        or far > RL_FAR_SHARE or moved < 0.5 or not r["ranks_bitwise_equal"]):
                    raise AssertionError(f"rl_dp {name} dp={n}: {out[n]}")
            out[1] = dict(ms=one["ms"], ms_all=one["ms_all"], card=one["card"])
            log(f"[cards] rl_dp {name}: ms an update at N=1 {one['ms']:.3f}, "
                + ", ".join(f"N={n} {out[n]['ms']:.3f}" for n in (2, world)))
            res[name] = out
    sync()
    seen = _per_card(device)
    launched = {k: sum(c[k] for _, c in seen) for k in seen[0][1]}
    if any(launched.values()):
        raise AssertionError(f"rl_dp: kernels launched on the dp ranks: {launched}")
    res["launches"] = launched
    return res if rank == 0 else {}


def cards_phases(rank, world, device, presets, max_tokens, phases=CARDS_PHASES, prior=None):
    """The four-card phases of a world whose ranks bound their cards, on
    every rank; rank 0 returns the results (from `prior`, the results of
    the phases run before, on) and writes them to
    chip_smoke_out/chip_smoke_cards4.json after each phase. `phases`
    selects "tp" (the collectives, tp serving, the MoE model and the
    failing follower; last, as it leaves the world unusable) and "seqpipe"
    (seqpipe_cards); "rl_dp" runs in a world of its own (main_cards)."""
    import gc
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.convert import init_params, init_params_sharded
    from ray_tpu_torch.models.llama import KVCache, Llama, LlamaConfig
    from ray_tpu_torch.parallel.mesh import make_mesh

    llama, moe, moe_layers = presets["llama"], presets["moe"], presets.get("moe_layers")
    lkw = dict(model_overrides=presets["llama_overrides"]) if "llama_overrides" in presets else {}
    mover = presets.get("moe_overrides", {})
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    res = dict(prior or {}, world=world, backend=dist.get_backend())
    lead = rank == 0

    def save():
        if lead:
            OUT_DIR.mkdir(exist_ok=True)
            (OUT_DIR / CARDS_OUT).write_text(json.dumps(res, indent=1, default=str))

    if "seqpipe" in phases:
        res.update(seqpipe_cards(world, dev, presets))
        save()
    if "fsdp" in phases:
        res["fsdp"] = fsdp_cards(rank, world, device, presets)
        save()
    if "tp" not in phases:
        return res if lead else {}

    # (5) first, as the cheapest: the collectives at world 4 on one layer's bytes
    mesh = make_mesh({"tp": world}, device=device)
    n = layer_elements() if device == "cuda" else 4096
    res["xla_ops"] = xla_ops_world(mesh, "tp", n, dev, "cards")
    if lead and device == "cuda":
        nvl = subprocess.run(["nvidia-smi", "nvlink", "-s"], capture_output=True, text=True,
                             timeout=60).stdout
        res["nvlink"] = nvl
        log("[cards] nvidia-smi nvlink -s (card 0):\n" + "\n".join(nvl.splitlines()[:20]))
    save()

    # (1) f32 greedy ids at tp 1, 2 and 4; the tp=1 server stays on rank 0
    # for the near-tie readings. Then speculate=4 at tp=4 against the plain
    # tp=4 server, in f32 so that the [B, K+1] and [B, 1] products cannot
    # round a near-tie apart: on the waves, and on a prompt that drafts
    # (_spec_tp_world).
    vocab = getattr(LlamaConfig, llama)(**lkw.get("model_overrides", {})).vocab_size
    wave1, wave2 = slice_prompts(vocab)
    prompts = wave1 + wave2
    f32 = {}
    ref_server = None
    for tp in (1, 2, world):
        f32[tp], srv = _serve_tp_world(rank, tp, llama, "float32", device, prompts, max_tokens,
                                       keep=tp == 1, **lkw)
        ref_server = srv if tp == 1 else ref_server
    spec, _ = _serve_tp_world(rank, world, llama, "float32", device, prompts, max_tokens,
                              speculate=4, **lkw)
    drafting = _spec_tp_world(rank, world, device)
    if lead:
        drop = lambda r: {k: v for k, v in r.items() if k not in ("first_logits", "stats")}
        res["f32"] = {tp: drop(r) for tp, r in f32.items()}
        for tp in (2, world):
            res["f32"][tp]["compare"] = compare_ids(f"cards f32 tp={tp}", ref_server, prompts,
                                                    f32[1]["ids"], f32[tp]["ids"], device)
        st = spec["stats"]["speculation"]
        same = spec["ids"] == f32[world]["ids"]
        res["f32_spec"] = dict(drop(spec), speculation=st, ids_equal_plain=same)
        log(f"[cards] {llama} f32 tp={world} speculate=4 on the waves: ids equal the plain "
            f"tp={world} server's {same}; {st}")
        dst = drafting["stats"]
        dsame = drafting[4] == drafting[0]
        res["spec_drafting"] = dict(ids_equal_plain=dsame, speculation=dst,
                                    prompt_len=len(drafting["prompt"]))
        log(f"[cards] tiny f32 (Kh {world}, CPU-seeded) tp={world} speculate=4, "
            f"{len(drafting['prompt'])}-token P + O + P prompt, 48 tokens: ids equal plain "
            f"{dsame}; {dst}")
        if not (same and dsame and dst["accepted"] > 0):
            raise AssertionError(f"speculation at tp={world}: ids equal {same} / {dsame}, "
                                 f"stats {st} / {dst}")
    del ref_server
    _world_barrier(device)
    save()

    # (2) bf16 at tp 1, 2 and 4: the serving numbers
    bf16 = {}
    for tp in (1, 2, world):
        bf16[tp], _ = _serve_tp_world(rank, tp, llama, "bfloat16", device, prompts, max_tokens,
                                      capture=True, **lkw)
    if lead:
        first = bf16[1]["first_logits"]
        res["bf16"] = {}
        for tp, r in bf16.items():
            err = float((r["first_logits"] - first).abs().max())
            res["bf16"][tp] = dict({k: v for k, v in r.items()
                                    if k not in ("first_logits", "ids", "stats")},
                                   first_prefill_max_abs_diff=err)
            peaks = r["peak_bytes_per_card"]
            log(f"[cards] {llama} bf16 tp={tp}: TTFT p50 {r['ttft_p50_s'] * 1e3:.1f} ms, "
                f"{r['decode_tokens_per_s']:.1f} decode tokens/s, "
                f"{r['host_syncs_per_token']:.4f} host syncs a token, peak "
                f"{[round(p / 2**30, 2) if p else None for p in peaks]} GiB a card, first "
                f"prefill logits max |diff| from tp=1 {err:.3e}")
    save()

    # (3) the MoE model at tp=4: first a 2-layer f32 check against tp=1
    # (logits and every token's experts), then (4) moe_ep on that model,
    # then the whole model in bf16 serving the wave
    mcfg = getattr(LlamaConfig, moe)(**dict(mover, n_layers=2, dtype=torch.float32,
                                            param_dtype=torch.float32, max_seq_len=256))
    mcfg = dataclasses.replace(mcfg, capacity_factor=mcfg.n_experts / mcfg.moe_top_k)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    whole = [(k, p.shape) for k, p in Llama(mcfg, device="meta").named_parameters()]
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, mcfg.vocab_size,
                                                                (1, 100))).to(dev)
    ids_of = lambda m: [b.moe.last_gate_idx.clone() for b in m.blocks()]

    def cached_forward(model, kv_heads):
        kv = KVCache.init(dataclasses.replace(mcfg, n_kv_heads=kv_heads), 1, 256, device=dev)
        with torch.no_grad():
            logits, kv = model(prompt, cache=kv)
            ids = ids_of(model)
            step, _ = model(logits[:, -1].argmax(-1, keepdim=True), cache=kv)
        return logits, step, ids + ids_of(model)

    ref_model = None
    if lead:
        ref_model = init_params(Llama(mcfg, device=dev), gen()).requires_grad_(False)
        ref_logits, ref_step, ref_ids = cached_forward(ref_model, mcfg.n_kv_heads)
    tp_mesh = make_mesh({"tp": world}, device=device)
    tp_model = init_params_sharded(Llama(mcfg, device=dev, mesh=tp_mesh), whole, gen(), tp_mesh)
    tp_logits, tp_step, tp_ids = cached_forward(tp_model.requires_grad_(False),
                                                mcfg.n_kv_heads // world)
    del tp_model
    if lead:
        err = float((tp_logits - ref_logits).abs().max())
        err_step = float((tp_step - ref_step).abs().max())
        flips = sum(int((a != b).any(-1).sum()) for a, b in zip(tp_ids, ref_ids))
        res["moe_tp_check"] = dict(prefill_max_abs_err=err, step_max_abs_err=err_step,
                                   expert_id_flips=flips, tol=1e-3)
        log(f"[cards] {moe} x 2 layers f32, tp={world} vs tp=1 (dense cache): prefill logits "
            f"max |diff| {err:.3e}, decode step {err_step:.3e} (tol 1e-3); top-2 expert ids "
            f"differ for {flips} of {101 * 2} (token, layer) pairs")
        if not (err <= 1e-3 and err_step <= 1e-3 and flips == 0):
            raise AssertionError(f"moe tp check failed: {res['moe_tp_check']}")
    save()

    # (4) moe_ep: the banks over ep (and tp), no cache: attention through B1
    # (f32 route, "auto" on cuda) on each rank's heads, held against the
    # unsharded model's weights with plain attention (attn_impl="xla")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, mcfg.vocab_size,
                                                                (1, 128))).to(dev)
    res["moe_ep"] = {}
    if lead:
        plain = Llama(dataclasses.replace(mcfg, attn_impl="xla"), device="meta")
        plain.load_state_dict(ref_model.state_dict(), assign=True)
        with torch.no_grad():
            ref_out = plain(tokens)[0]
        del plain
    for axes in ({"ep": world}, {"ep": 2, "tp": world // 2}):
        ep_mesh = make_mesh(axes, device=device)
        model = init_params_sharded(Llama(mcfg, device=dev, mesh=ep_mesh), whole, gen(),
                                    ep_mesh).requires_grad_(False)
        reset_launch_counts()
        with torch.no_grad():
            out = model(tokens)[0]
        launches = launch_counts()
        # B1 once a layer on this rank's heads (f32 route), nothing else
        want = dict.fromkeys(launches, 0)
        want["flash_fwd"] = mcfg.n_layers if device == "cuda" else 0
        if launches != want:
            raise AssertionError(f"moe_ep {axes} launches {launches}, want {want}")
        fwd = lambda: model(tokens)
        with torch.no_grad():
            ms = op_ms(fwd, iters=5) if device == "cuda" else None
        if lead:
            err = float((out - ref_out).abs().max())
            res["moe_ep"][str(axes)] = dict(max_abs_err=err, forward_ms=ms,
                                           launches=launches, experts=model.layers_0.moe.w_gate.shape[0])
            log(f"[cards] moe_ep {axes}: {moe} x 2 layers f32, B=1 T=128: logits max |diff| "
                f"from the unsharded plain-attention forward {err:.3e}, forward {ms} ms, "
                f"launches on rank 0 {launches}")
        del model
        _world_barrier(device)
    if lead:
        with torch.no_grad():
            ref_ms = op_ms(lambda: ref_model(tokens), iters=5) if device == "cuda" else None
        res["moe_ep"]["unsharded_forward_ms"] = ref_ms
        bad = [k for k, v in res["moe_ep"].items()
               if isinstance(v, dict) and not v["max_abs_err"] <= 1e-3]
        if bad:
            raise AssertionError(f"moe_ep disagrees with the unsharded plain-attention forward: "
                                 f"{res['moe_ep']}")
    del ref_model
    _reset_peak(device)
    _world_barrier(device)
    save()

    # (3, continued) the whole MoE model, bf16, tp=4, dense cache
    overrides = dict(mover, **({} if moe_layers is None else {"n_layers": moe_layers}))
    full, _ = _serve_tp_world(rank, world, moe, "bfloat16", device, prompts, max_tokens,
                              model_overrides=overrides)
    if lead:
        res["moe_serve"] = {k: v for k, v in full.items()
                            if k not in ("first_logits", "ids", "stats")}
        mc = getattr(LlamaConfig, moe)(**overrides)
        from ray_tpu_torch.models.llama import llama_param_count
        res["moe_serve"].update(n_layers=mc.n_layers, params=llama_param_count(mc))
        peaks = full["peak_bytes_per_card"]
        log(f"[cards] {moe} at {mc.n_layers} layers ({llama_param_count(mc):,} params), bf16, "
            f"tp={world}, dense cache: TTFT p50 {full['ttft_p50_s'] * 1e3:.1f} ms, "
            f"{full['decode_tokens_per_s']:.1f} decode tokens/s, peak "
            f"{[round(p / 2**30, 2) if p else None for p in peaks]} GiB a card "
            f"(built in {full['build_s']:.1f} s)")
        ok = all(len(i) == max_tokens and all(0 <= t < mc.vocab_size for t in i)
                 for i in full["ids"])
        if not ok:
            raise AssertionError("the MoE tp server's output is malformed")
    save()

    # last, as it leaves the world unusable: a follower that fails
    error, seconds = _failing_follower_world(rank, world, device)
    mine = dict(error=error, seconds=seconds)
    if lead:
        res["failing_follower"] = mine
        log(f"[cards] a follower that fails at tp={world} (rank 1's decode step raises): rank 0 "
            f"raised after {seconds:.3f} s: {error}")
        want = ("tp follower failed in _decode_chunk: rank 1: RuntimeError: follower lost "
                "its card")
        if error is None or want not in error or seconds > FAILING_FOLLOWER_S:
            raise AssertionError(f"the failing follower: rank 0 {mine}, want {want!r} within "
                                 f"{FAILING_FOLLOWER_S} s")
        save()
    return res if lead else dict(failing_follower=mine)


# rank 0 must raise a follower's error within this many seconds of the
# request (the NCCL group's own timeout is 900 s)
FAILING_FOLLOWER_S = 60


def _failing_follower_world(rank, world, device):
    """tiny f32 at tp=world (n_kv_heads raised to `world`) whose rank 1 fails
    in its first decode step. Rank 0 serves one request and must raise the
    follower's report of it; ranks 2.. are left waiting for a next call
    until rank 0's process exits. Returns (this rank's error text, or
    None; seconds from the request to it)."""
    from ray_tpu_torch.serve.llm import LLMConfig, LLMServer
    kw = dict(model_overrides={"n_kv_heads": world}, max_seq_len=256, max_batch_slots=2)
    server = LLMServer(LLMConfig(**tp_server_config("tiny", world, "float32", device, **kw)))
    if rank == 1:
        def lost(*args):
            raise RuntimeError("follower lost its card")
        server._decode_chunk = lost
    t0 = time.perf_counter()
    try:
        if rank == 0:
            asyncio.run(server.generate(list(range(1, 17)), max_tokens=8))
        else:
            server.follow()
    except RuntimeError as e:
        return (f"{e} <- {e.__cause__}" if e.__cause__ else str(e)), time.perf_counter() - t0
    return None, time.perf_counter() - t0


SERVE_CARDS_APP, SERVE_CARDS_PD = "serve_cards", "serve_cards_pd"
SERVE_CARDS_PREFIX = 256    # tokens of each of the four shared prefixes (4 pages of 64)


def serve_cards_prompts(vocab, seed=2024, families=4, repeats=2, tail=16):
    """Four families of a 256-token prefix: wave 1 one prompt each, wave 2
    `repeats` more each (rounds of one a family), every tail fresh."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, vocab, SERVE_CARDS_PREFIX).tolist() for _ in range(families)]
    wave1 = [p + rng.integers(1, vocab, tail).tolist() for p in prefixes]
    rounds = [[p + rng.integers(1, vocab, tail).tolist() for p in prefixes]
              for _ in range(repeats)]
    return prefixes, wave1, rounds


def _stream_ttft(handle, prompt, max_tokens, eos_id):
    """A streamed generate through a deployment handle: (ids, seconds to
    the first id)."""
    t0 = time.perf_counter()
    toks, first = [], None
    for tok in handle.options(stream=True).generate_stream.remote(prompt, max_tokens=max_tokens,
                                                                  eos_id=eos_id):
        if first is None:
            first = time.perf_counter() - t0
        toks.append(tok)
    return toks, first


def run_serve_cards(n, device="cuda", preset="llama_1b", max_tokens=16):
    """Group `serve` of `--cards n`, in this process: what exists only
    across cards. (a) The `serve_app` app with its llama_1b deployment at
    num_replicas=2, a card each: wave 1 (four prompts opening with four
    256-token prefixes) through the deployment's handle at once (p2c
    spreads them two and two), then, after the digests' refresh interval,
    two rounds of one more prompt a family over HTTP through the OpenAI
    ingress (whose handle routes by prefix affinity): the two replicas'
    bindings distinct cards, both replicas answered, every repeat of a
    family served by the replica that served its first and advertised its
    prefix in the digest the controller held (the stats piggyback), and
    every request's ids (from its replica's record) equal to an in-process
    server's on the same waves in this process, the app's eos id cut
    included. (b) PD as two deployments: `EngineReplica` "prefill" on one
    card and "pd" bound with the prefill deployment's handle on another,
    the same waves through the PD handle as streams (TTFT a request read
    here): ids equal (a)'s for the same prompts, the PD replica prefilling
    nothing and launching no B1, the prefill replica decoding nothing and
    launching no B4. Both apps deploy at once, their four replicas starting
    together. Returns the readings; raises on a miss."""
    import concurrent.futures
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import prefix_digest as pdg
    from ray_tpu_torch.serve.controller import get_controller
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.serve.openai_api import ByteTokenizer, OpenAIIngress

    cuda = device == "cuda"
    tag = "cards serve"
    tok = ByteTokenizer()
    if cuda:
        from ray_tpu_torch.ops import _build
        _build.build()          # once, before four replicas would each build it
    cfg = serving_config(preset, device)
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=None if cuda else n)
    try:
        port = serve.start(http_options={"port": 0})
        llm = engine_deployment("llm", num_replicas=2).bind("llm", cfg)
        serve.run(serve.deployment(OpenAIIngress, name="openai").bind({SERVE_MODEL: llm}),
                  name=SERVE_CARDS_APP, route_prefix="/")
        prefill = engine_deployment("prefill").bind("prefill", cfg)
        h_pd = serve.run(engine_deployment("pd").bind("pd", cfg, prefill=prefill),
                         name=SERVE_CARDS_PD, route_prefix="/pd")
        # the one-replica reference, built here while the four replicas start
        ref = LLMServer(cfg)
        vocab = ref.model_cfg.vocab_size
        prefixes, wave1, rounds = serve_cards_prompts(vocab)
        gen = lambda p: ref.generate(p, max_tokens=max_tokens, eos_id=tok.eos_id)

        async def ref_waves():
            out = await asyncio.gather(*[gen(p) for p in wave1])
            for r in rounds:
                out += await asyncio.gather(*[gen(p) for p in r])
            return [o["tokens"] for o in out]

        want = dict(zip(map(prompt_key, wave1 + sum(rounds, [])), asyncio.run(ref_waves())))
        reps = replicas_of(SERVE_CARDS_APP, "llm")
        bindings = [on_replica(r, "binding") for r in reps]
        h_pre = serve.get_deployment_handle("prefill", SERVE_CARDS_PD)
        pd_bindings = [h_pre.binding.remote().result(timeout_s=600),
                       h_pd.binding.remote().result(timeout_s=600)]
        start_s = time.perf_counter() - t0
        h_llm = serve.get_deployment_handle("llm", SERVE_CARDS_APP)
        for r in reps:                                  # warm-up, each replica
            on_replica(r, "generate", list(range(1, 50)), 8)
        h_pd.generate.remote(list(range(1, 50)), max_tokens=8).result(timeout_s=600)
        http_call(port, "POST", "/v1/completions",
                  {"model": SERVE_MODEL, "prompt": [[1, 2, 3]], "max_tokens": 2})
        for r in reps:
            on_replica(r, "served", True)

        # (a) wave 1 through the handle, spread by p2c; the repeats over HTTP
        t1 = time.perf_counter()
        resps = [h_llm.generate.remote(p, max_tokens=max_tokens, eos_id=tok.eos_id)
                 for p in wave1]
        for r in resps:
            r.result(timeout_s=600)
        time.sleep(2.0)          # past the digests' 1 s TTL and the handles' 0.5 s refresh
        state = rt.get(get_controller().get_replica_state.remote(SERVE_CARDS_APP, "llm"))
        answers = []
        with concurrent.futures.ThreadPoolExecutor(len(prefixes)) as ex:
            for r in rounds:
                answers += list(ex.map(lambda p: http_call(port, "POST", "/v1/completions", {
                    "model": SERVE_MODEL, "prompt": [p], "max_tokens": max_tokens}), r))
        wall_a = time.perf_counter() - t1
        served = [on_replica(r, "served") for r in reps]

        # (b) the same waves through PD, as streams
        t1 = time.perf_counter()
        pd_out = {}
        with concurrent.futures.ThreadPoolExecutor(len(prefixes)) as ex:
            for wave in [wave1] + rounds:
                for p, res in zip(wave, ex.map(
                        lambda p: _stream_ttft(h_pd, p, max_tokens, tok.eos_id), wave)):
                    pd_out[prompt_key(p)] = res
        wall_b = time.perf_counter() - t1
        pre_launch = h_pre.launch_counts.remote().result(timeout_s=60)
        pd_launch = h_pd.launch_counts.remote().result(timeout_s=60)
        pre_stats = h_pre.stats.remote().result(timeout_s=60)
        pd_stats = h_pd.stats.remote().result(timeout_s=60)
        llm_launch = [on_replica(r, "launch_counts") for r in reps]
    finally:
        serve.delete(SERVE_CARDS_APP)
        serve.delete(SERVE_CARDS_PD)
        serve.shutdown()
        workers, left = stop_runtime(rt)

    # which replica served what, by its actor id in the controller's state
    idx_of = {getattr(h, "_actor_id", None): i for i, h in enumerate(state["replicas"])}
    where = {}
    for r, recs in zip(reps, served):
        for rec in recs:
            where.setdefault(rec["key"], []).append((idx_of.get(r._actor_id), rec["tokens"]))
    fams = []
    for i, prefix in enumerate(prefixes):
        hashes = pdg.prompt_chain_hashes(prefix, cfg.page_size)
        advertised = sorted(j for j, dg in state["digests"].items()
                            if pdg.match_depth(dg, hashes) >= len(hashes))
        first = [j for j, _ in where.get(prompt_key(wave1[i]), [])]
        repeats = [j for r in rounds for j, _ in where.get(prompt_key(r[i]), [])]
        fams.append(dict(first=first, advertised=advertised, repeats=repeats))
    ids_a = {k: v[0][1] for k, v in where.items() if len(v) == 1}
    cards = [b["gpu_ids"] for b in bindings + pd_bindings]
    ttft = sorted(v[1] for v in pd_out.values() if v[1] is not None)   # None: eos first
    n_req = len(want)
    checks = {
        f"the two llm replicas hold distinct cards {cards[:2]}, PD's prefill and decode two "
        f"more {cards[2:]}": len({tuple(c) for c in cards}) == 4 and all(len(c) == 1 for c in cards),
        f"both replicas answered wave 1 ({[f['first'] for f in fams]})":
            sorted({f["first"][0] for f in fams if len(f["first"]) == 1}) == [0, 1],
        "every HTTP answer 200": all(a[0] == 200 for a in answers),
        "each family's repeats went to the replica that served its first and advertised its "
        f"prefix ({fams})": all(len(f["first"]) == 1 and f["advertised"] == f["first"]
                                and f["repeats"] == f["first"] * len(rounds) for f in fams),
        f"every request's ids equal the one-server reference's ({len(ids_a)} of {n_req})":
            ids_a == want,
        "PD's ids equal (a)'s for the same prompts": {k: v[0] for k, v in pd_out.items()} == want,
        "the PD replica prefilled nothing and launched no B1, the prefill replica decoded "
        "nothing and launched no B4": pd_stats["prefill"]["chunks"] == 0
        and pd_launch["flash_fwd"] == 0 and pre_stats["decode"]["tokens"] == 0
        and pre_launch["paged_decode"] == 0,
        f"every worker exited after shutdown() ({workers} workers)": not left,
    }
    if cuda:
        checks["B1 launched in the prefill replica and both llm replicas, B4 in the PD and "
               "both llm replicas"] = (pre_launch["flash_fwd"] > 0 and pd_launch["paged_decode"] > 0
                                       and all(c["flash_fwd"] > 0 and c["paged_decode"] > 0
                                               for c in llm_launch))
        checks["each replica sees one card"] = all(b["device_count"] == 1
                                                   for b in bindings + pd_bindings)
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"{tag}: {[what for what, ok in checks.items() if not ok]}")
    out = dict(replicas_start_s=start_s, bindings=bindings, pd_bindings=pd_bindings,
               families=fams, requests=n_req, wall_a_s=wall_a, wall_b_s=wall_b,
               pd_ttft_p50_s=float(np.median(ttft)), pd_ttft_max_s=ttft[-1],
               launches=dict(llm=llm_launch, prefill=pre_launch, pd=pd_launch),
               seconds=time.perf_counter() - t0)
    log(f"[{tag}] four replicas up {start_s:.1f} s after the deploys (the reference built "
        f"here meanwhile); (a) {n_req} requests in {wall_a:.2f} s, families {fams}; (b) PD "
        f"across two cards: {n_req} streamed requests in {wall_b:.2f} s, TTFT p50 "
        f"{out['pd_ttft_p50_s'] * 1e3:.1f} ms, max {out['pd_ttft_max_s'] * 1e3:.1f} ms; "
        f"launches {out['launches']}" + (f" ({smi_line()})" if cuda else ""))
    return out


def run_runtime_cards(n, device="cuda"):
    """Group `runtime` of `--cards n`: the port's runtime counts the n cards
    as its "GPU" resource; n num_gpus=1 actors are bound to n distinct
    cards (each sees one, CUDA_VISIBLE_DEVICES equal to its get_gpu_ids(),
    its card's uuid one of this process's n), then, with those killed, a
    num_gpus=2 actor sees two of them. No model and no NCCL. Every worker
    has exited after shutdown(). Returns the bindings; raises on a miss."""
    import torch
    import ray_tpu_torch as rt
    cuda = device == "cuda"
    mine = ([str(torch.cuda.get_device_properties(i).uuid) for i in range(n)] if cuda
            else None)
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=None if cuda else n)
    try:
        res = rt.cluster_resources()
        ones = [rt.remote(num_gpus=1)(Pinger).remote() for _ in range(n)]
        singles = rt.get([a.binding.remote() for a in ones], timeout=300)
        for a in ones:
            rt.kill(a)
        pair = rt.get(rt.remote(num_gpus=2)(Pinger).remote().binding.remote(), timeout=300)
    finally:
        workers, left = stop_runtime(rt)
    seconds = time.perf_counter() - t0
    cvd = lambda b: b["cuda_visible_devices"] == ",".join(map(str, b["gpu_ids"]))
    checks = {
        f"init() counts {n} cards as the GPU resource ({res.get('GPU')})": res.get("GPU") == n,
        f"{n} num_gpus=1 actors hold {n} distinct ids "
        f"{sorted(i for b in singles for i in b['gpu_ids'])}":
            sorted(i for b in singles for i in b["gpu_ids"]) == list(range(n)),
        "each one's CUDA_VISIBLE_DEVICES == its get_gpu_ids()": all(map(cvd, singles)),
        f"a num_gpus=2 actor holds two ids {pair['gpu_ids']}, CUDA_VISIBLE_DEVICES "
        f"{pair['cuda_visible_devices']!r}": len(set(pair["gpu_ids"])) == 2 and cvd(pair),
        f"every worker exited after shutdown() ({workers} workers)": not left,
    }
    if cuda:
        uuids = [b["uuids"][0] for b in singles]
        checks[f"each sees one card, {n} distinct uuids equal to this process's {n}"] = (
            all(b["device_count"] == 1 for b in singles) and sorted(uuids) == sorted(mine))
        checks["the num_gpus=2 actor sees two of them"] = (
            pair["device_count"] == 2 and set(pair["uuids"]) <= set(mine)
            and len(set(pair["uuids"])) == 2)
    for what, ok in checks.items():
        log(f"[cards runtime] {'ok  ' if ok else 'FAIL'} {what}")
    if not all(checks.values()):
        raise AssertionError(f"runtime on {n} cards: {singles}, {pair}, left {left}")
    return dict(resources=res, singles=singles, pair=pair, seconds=seconds)


# ------------------------------------------------------------- actors
ACTORS_STEPS, ACTORS_SAVE_AT, ACTORS_FAIL_AT, ACTORS_FAIL_RANK = 4, 2, 3, 2
ALLREDUCE_BYTES = 256 << 20      # the NCCL group's timed all-reduce


def group_fit_loop(config):
    """(a)'s loop in every TrainWorker of the group: the preset at
    {"fsdp": world} (B=1 a card), build_llama_trainer's batches, a sharded
    checkpoint after step ACTORS_SAVE_AT. Rank ACTORS_FAIL_RANK exits
    (os._exit(1)) at the start of step ACTORS_FAIL_AT when `flag` does not
    exist yet, writing the time and its card to it; with
    `config["kill_node"]` it SIGKILLs its node agent's process group
    instead (itself with it). Each step's record (pid, card, launches,
    host times; at the last step a digest of this rank's blocks)
    overwrites this process's file in `config["records"]`; rank 0 reports
    the loss and the times."""
    import torch
    from ray_tpu_torch import train
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.sharding import data_sharding
    from ray_tpu_torch.train.llm_step import build_llama_trainer, train_state
    loop_start = time.time()
    reset_launch_counts()
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    device = config["device"]
    mesh = make_mesh({"fsdp": world}, device=device)
    model, opt, step, batches, _ = build_llama_trainer(config["preset"], world, config["seq"],
                                                       device=device, mesh=mesh)
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        got = ckpt.to_state(target=train_state(model, opt)[0], mesh=mesh)
        model.load_state_dict(got["model"])
        opt.load_state_dict(got["optim"])
        start = got["step"]
        del got
    binding = card_binding()
    feed = train.iter_device_batches(batches[start:config["steps"]], sharding=data_sharding(mesh))
    for n, tokens in zip(range(start + 1, config["steps"] + 1), feed):
        flag = config.get("flag")
        if flag and rank == ACTORS_FAIL_RANK and n == ACTORS_FAIL_AT and not os.path.exists(flag):
            # die once step ACTORS_SAVE_AT's checkpoint is in the run
            # directory (rank 0 copies it in its report), so that the
            # group resumes from it
            kept = os.path.join(ctx.get_trial_dir(), "checkpoint_000000")
            for _ in range(600):
                if os.path.isdir(kept):
                    break
                time.sleep(0.1)
            with open(flag, "w") as f:
                json.dump({"t": time.time(), "pid": os.getpid(), "ppid": os.getppid(),
                           "binding": binding}, f)
            if config.get("kill_node"):
                import signal
                os.killpg(os.getpgid(0), signal.SIGKILL)
            os._exit(1)
        t0 = time.time()
        loss = step(tokens)
        value = loss.item()
        t1 = time.time()
        ckpt = None
        if n == ACTORS_SAVE_AT:
            state, specs = train_state(model, opt, step=n)
            ckpt = train.Checkpoint.from_state(
                state, path=os.path.join(config["scratch"], f"step{n}"), mesh=mesh, specs=specs)
        record = dict(rank=rank, pid=os.getpid(), step=n, start=start, loop_start=loop_start,
                      binding=binding, launches=launch_counts())
        if n == config["steps"]:
            record["digest"] = state_digest(model.state_dict())
        with open(os.path.join(config["records"], f"rank{rank}-{os.getpid()}.json"), "w") as f:
            json.dump(record, f)
        train.report({"loss": value, "step": n, "start": start, "loop_start": loop_start,
                      "t0": t0, "t1": t1}, checkpoint=ckpt)


def final_digests(recs):
    """Each rank's digest of its blocks after the last step, by rank."""
    return {r["rank"]: r["digest"] for r in recs if "digest" in r}


def worker_group_cards(n, device, preset, seq):
    """(a) The worker group: TorchTrainer(use_worker_actor=True,
    ScalingConfig(num_workers=n, use_gpu=True)) places n TrainWorker actors
    with num_gpus=1 each in a placement group; group_fit_loop at
    {"fsdp": n}. The killed run's rank ACTORS_FAIL_RANK exits at step
    ACTORS_FAIL_AT of the first attempt; the whole group is torn down and
    retried (FailureConfig(max_failures=1)), resuming from the checkpoint of
    step ACTORS_SAVE_AT. Held against an unkilled run of the same group:
    no error, the same steps and losses; every rank of an attempt on its
    own card; B1-B3 launched 16 x the steps each rank's process took, on
    every rank, and none here."""
    import tempfile

    import torch
    import chip_smoke
    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import LlamaConfig
    cuda = device == "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_group_")
    runs, records = {}, {}
    try:
        for name, killed in (("killed", True), ("whole", False)):
            rec = os.path.join(root, f"records_{name}")
            os.makedirs(rec)
            config = dict(preset=preset, seq=seq, steps=ACTORS_STEPS, device=device,
                          scratch=os.path.join(root, f"scratch_{name}"), records=rec,
                          flag=os.path.join(root, "died") if killed else None)
            reset_launch_counts()
            t0 = time.perf_counter()
            runs[name] = train.TorchTrainer(
                chip_smoke.group_fit_loop, train_loop_config=config, use_worker_actor=True,
                scaling_config=train.ScalingConfig(num_workers=n, use_gpu=cuda),
                run_config=train.RunConfig(
                    name=name, storage_path=root,
                    failure_config=train.FailureConfig(max_failures=1 if killed else 0))).fit()
            runs[name + "_s"] = time.perf_counter() - t0
            runs[name + "_here"] = launch_counts()
            records[name] = [json.load(open(os.path.join(rec, f))) for f in sorted(os.listdir(rec))]
        crash = json.load(open(os.path.join(root, "died")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    killed, whole = runs["killed"], runs["whole"]
    layers = getattr(LlamaConfig, preset)().n_layers
    per = layers if cuda else 0
    hist = lambda r: [(m["step"], m["loss"]) for m in r.metrics_history]
    # the killed run's attempts: the processes that started at step 0, then
    # those resumed from the checkpoint
    attempts = {name: [[r for r in recs if r["start"] == s] for s in sorted({r["start"]
                       for r in recs})] for name, recs in records.items()}
    taken = lambda r: r["step"] - r["start"]
    cards = lambda group: {r["binding"]["uuids"][0] if cuda else r["binding"]["pid"]
                           for r in group}
    second = [m for m in killed.metrics_history if m["start"] == ACTORS_SAVE_AT]
    last = whole.metrics_history
    ms_step = (last[-1]["t1"] - last[-2]["t0"]) / 2 * 1e3
    out = dict(preset=preset, world=n, seq=seq, batch_per_card=1, steps=ACTORS_STEPS,
               errors=[repr(killed.error), repr(whole.error)], history=hist(whole),
               killed_history=hist(killed), fit_s=[runs["killed_s"], runs["whole_s"]],
               ms_per_step=ms_step, ms_last_step=(last[-1]["t1"] - last[-1]["t0"]) * 1e3,
               group_restart_s=second[0]["loop_start"] - crash["t"] if second else None,
               group_restart_to_step_s=second[0]["t0"] - crash["t"] if second else None,
               launches={k: [r["launches"] for r in v] for k, v in records.items()},
               launches_here=[runs["killed_here"], runs["whole_here"]],
               cards=[sorted(cards(a)) for a in attempts["killed"] + attempts["whole"]],
               digests=final_digests(records["whole"]))
    checks = {
        "no error in either run": killed.error is None and whole.error is None,
        f"steps 1-{ACTORS_STEPS} and losses of the restarted group equal the unkilled "
        f"group's": hist(killed) == hist(whole)
        and [s for s, _ in hist(whole)] == list(range(1, ACTORS_STEPS + 1)),
        f"the killed run: two attempts, the second resumed from step {ACTORS_SAVE_AT}, "
        f"{n} ranks each": [len(a) for a in attempts["killed"]] == [n, n]
        and attempts["killed"][1][0]["start"] == ACTORS_SAVE_AT,
        f"every rank of an attempt on a card of its own": all(
            len(cards(a)) == len(a) for a in attempts["killed"] + attempts["whole"]),
        f"B1-B3 launched {layers} x the steps each rank's process took, on every rank"
        + ("" if cuda else " (0 on the CPU)"): all(
            r["launches"][f] == per * taken(r) for recs in records.values() for r in recs
            for f in FLASH_NAMES),
        "no kernel launched here": not any(v for h in out["launches_here"]
                                           for v in h.values()),
    }
    for what, ok in checks.items():
        log(f"[cards actors] group {'ok  ' if ok else 'FAIL'} {what}")
    for r in (killed, whole):
        if r.error is not None:
            log(f"[cards actors] group: a run's error: {str(r.error)[-4000:]}")
    log(f"[cards actors] group: {preset} at {{'fsdp': {n}}} B=1 a card T={seq} in {n} "
        f"TrainWorker actors: {ms_step:.1f} ms a step (unkilled run, steps "
        f"{ACTORS_STEPS - 1}-{ACTORS_STEPS}); rank {ACTORS_FAIL_RANK} died at step "
        f"{ACTORS_FAIL_AT}, the group restarted {out['group_restart_s'] or 0:.2f} s later "
        f"(first step {out['group_restart_to_step_s'] or 0:.2f} s), resumed at step "
        f"{ACTORS_SAVE_AT + 1}; fits {out['fit_s'][0]:.1f} s and {out['fit_s'][1]:.1f} s")
    if not all(checks.values()):
        raise AssertionError(f"actors group checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}")
    return out


class StageFn:
    """A pipeline stage's function for a stage actor: LlamaStage over a
    Llama of the stage's blocks alone, built on the meta device at the
    first call (the weights are the stage's params), so that the function
    ships without weights."""

    def __init__(self, preset, overrides, n_blocks, first, last):
        self.args = (preset, dict(overrides), n_blocks, first, last)
        self._stage = None

    def __getstate__(self):
        return {"args": self.args, "_stage": None}

    def __call__(self, params, x):
        if self._stage is None:
            from ray_tpu_torch.models.llama import Llama, LlamaConfig
            preset, overrides, n_blocks, first, last = self.args
            cfg = getattr(LlamaConfig, preset)(**dict(overrides, n_layers=n_blocks))
            self._stage = LlamaStage(Llama(cfg, device="meta"), 0, n_blocks, first, last)
        return self._stage.fn(params, x)


class HopProbe:
    """One end of an activation's hop: receives a tensor through the
    object store onto its card."""

    def touch(self, x):
        return [str(x.device), float(x.float().sum())]


def pipeline_cards(n, device, preset, t, overrides=None, n_micro=8, lr=0.1):
    """(b) build_pipeline: n PipelineStage actors with num_gpus=1 (stage i
    on a card of its own), the preset in f32 cut into n stages by
    LlamaStage (StageFn), one 1F1B train_step over n_micro microbatches of
    B=1, T=t, sgd(lr). Held: the mean loss and every parameter after the
    step against whole_step within PIPE_TOL (check_1f1b's tolerance), and
    against run_1f1b in this process on the same cards; at most S + 1
    live refs. Timed: a second step (ms), and the activation's hop
    through the store (put of a CUDA activation here, get onto a card in
    a num_gpus=1 actor)."""
    import torch
    import chip_smoke
    import ray_tpu_torch as rt
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.train.mpmd import PipelineStage, build_pipeline, sgd
    cuda = device == "cuda"
    ov = dict(overrides or {}, dtype=torch.float32, param_dtype=torch.float32)
    cfg = getattr(LlamaConfig, preset)(**ov)
    devices = [torch.device("cuda", i) if cuda else torch.device("cpu") for i in range(n)]
    model = init_params(Llama(cfg, device=devices[0]),
                        torch.Generator(device=devices[0]).manual_seed(0))
    split = llama_stages(model, n)
    first = [s.params("cpu") for s in split]
    per = cfg.n_layers // n
    fns = [chip_smoke.StageFn(preset, ov, per, i == 0, i == n - 1) for i in range(n)]
    mbs, tgts = pipeline_batch(cfg.vocab_size, n_micro, 1, t, [torch.device("cpu")])
    t0 = time.perf_counter()
    pipe = build_pipeline(fns, first, loss_fn=chip_smoke.ce_mean, optimizer=sgd(lr),
                          actor_options={"num_gpus": 1}, device=device)
    up_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        got = pipe.train_step(mbs, tgts)
        first_s = time.perf_counter() - t0
        params = [{k: v.to("cpu") for k, v in p.items()} for p in pipe.get_params()]
        t0 = time.perf_counter()
        second = pipe.train_step(mbs, tgts)
        step_s = time.perf_counter() - t0
        stage_pids = [rt.get(h.ping.remote(), timeout=60) for h in pipe.stages]
    finally:
        pipe.shutdown()
    stages = [PipelineStage(i, n, s.fn, {k: v.to(dev) for k, v in p.items()},
                            loss_fn=ce_mean if i == n - 1 else None, optimizer=sgd(lr),
                            device=dev)
              for i, (s, p, dev) in enumerate(zip(split, first, devices))]
    losses, _ = run_1f1b(stages, [x.to(devices[0]) for x in mbs],
                         [y.to(devices[-1]) for y in tgts])
    inproc = [{k: v.to("cpu") for k, v in st.get_params().items()} for st in stages]
    inproc_loss = float(sum(float(x) for x in losses)) / n_micro
    del stages
    want_losses = whole_step(model, [x.to(devices[0]) for x in mbs],
                             [y.to(devices[0]) for y in tgts], lr)
    want = float(sum(float(x) for x in want_losses)) / n_micro
    ref = {k: v.detach().to("cpu") for k, v in model.named_parameters()}
    param_err = max(rel_err(p[k], ref[s.names[k]]) for s, p in zip(split, params) for k in p)
    inproc_err = max(rel_err(p[k], q[k]) for p, q in zip(params, inproc) for k in p)
    bit_equal = all(torch.equal(p[k], q[k]) for p, q in zip(params, inproc) for k in p)
    loss_err = abs(got["loss"] - want) / abs(want)
    # an activation's hop: [1, t, d] f32 from this process's card to a stage's
    act = torch.randn(1, t, cfg.d_model, generator=torch.Generator(device=devices[0])
                      .manual_seed(1), device=devices[0])
    probe = rt.remote(num_gpus=1)(HopProbe).remote()
    rt.get(probe.touch.remote(rt.put(act)), timeout=120)          # the actor's start
    hops = []
    for _ in range(5):
        t0 = time.perf_counter()
        where, total = rt.get(probe.touch.remote(rt.put(act)), timeout=120)
        hops.append((time.perf_counter() - t0) * 1e3)
    rt.kill(probe)
    del model
    out = dict(preset=preset, stages=n, microbatches=n_micro, batch=1, seq=t, dtype="float32",
               loss=got["loss"], whole_loss=want, inproc_loss=inproc_loss,
               loss_rel_err=loss_err, params_rel_err=param_err, inproc_rel_err=inproc_err,
               inproc_bit_equal=bit_equal, tol=PIPE_TOL, pipeline_up_s=up_s,
               first_step_s=first_s, ms_per_step=step_s * 1e3,
               peak_live_refs=got["stats"]["peak_live_refs"],
               stash_depths=[x["stash_depth"] for x in second["stats"]["stages"]],
               hop_bytes=act.numel() * 4, hop_ms=hops, hop_landed=where, stage_pings=stage_pids)
    checks = {
        f"loss against whole_step within {PIPE_TOL} ({loss_err:.2e})": loss_err <= PIPE_TOL,
        f"params after the step against whole_step within {PIPE_TOL} ({param_err:.2e})":
            param_err <= PIPE_TOL,
        f"params against run_1f1b in this process on the same cards within {PIPE_TOL} "
        f"({inproc_err:.2e}, bit-equal {bit_equal})": inproc_err <= PIPE_TOL,
        f"peak live refs {out['peak_live_refs']} <= {n + 1}": out["peak_live_refs"] <= n + 1,
        "every stash drained": out["stash_depths"] == [0] * n,
    }
    for what, ok in checks.items():
        log(f"[cards actors] pipeline {'ok  ' if ok else 'FAIL'} {what}")
    log(f"[cards actors] pipeline: {preset} f32 in {n} PipelineStage actors (num_gpus=1 each), "
        f"1F1B over M={n_micro} of B=1 T={t}: up {up_s:.2f} s, first step {first_s:.2f} s, "
        f"then {out['ms_per_step']:.1f} ms a step; peak live refs {out['peak_live_refs']}; an "
        f"activation's hop ({out['hop_bytes']} bytes) {float(np.median(hops)):.2f} ms (median "
        f"of 5, landed on {where})")
    if not all(checks.values()):
        raise AssertionError(f"actors pipeline checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}")
    return out


def collective_inputs(world, seed=7):
    """Rank r's blocks: integer floats (every summation order gives the
    same sums) and positive ones for PRODUCT."""
    rng = np.random.default_rng(seed + world)
    return (rng.integers(-8, 9, (world, 2 * world, 3)).astype(np.float32),
            rng.integers(1, 4, (world, 2 * world, 3)).astype(np.float32))


class CollectiveMember:
    """A member of (c)'s groups: joins through JAX's `_init_collective`
    signature and runs every operation of a group."""

    def _init_collective(self, world_size, rank, backend, group_name):
        from ray_tpu_torch.parallel import collective as col
        col.init_collective_group(world_size, rank, backend, group_name)
        self.rank, self.world = rank, world_size
        return True

    def binding(self):
        return card_binding()

    def run(self, group, tensors):
        """Every operation on this rank's blocks, results as numpy; the host
        group takes numpy, the nccl group CUDA tensors."""
        import torch
        from ray_tpu_torch.parallel import collective as col
        r, w = self.rank, self.world
        x, pos = collective_inputs(w)
        to = (lambda a: torch.from_numpy(a).cuda()) if tensors else np.asarray
        back = lambda t: t.cpu().numpy() if tensors else np.asarray(t)
        cat = lambda xs: back(xs) if tensors else np.concatenate([np.asarray(a) for a in xs])
        out = {f"allreduce_{op}": back(col.allreduce(to(x[r]), group, op))
               for op in ("sum", "max", "min")}
        if not tensors:
            out["allreduce_product"] = back(col.allreduce(pos[r], group, "product"))
        out["allgather"] = cat(col.allgather(to(x[r]), group))
        out["reducescatter"] = back(col.reducescatter(to(x[r]), group))
        out["broadcast"] = back(col.broadcast(to(x[r]), 0, group))
        out["reduce"] = back(col.reduce(to(x[r]), 1, group))
        col.barrier(group)
        out["alltoall"] = cat(col.alltoall(to(x[r]) if tensors else np.split(x[r], w), group))
        like = to(x[r])
        if r % 2 == 0:
            col.send(to(x[r]), (r + 1) % w, group)
            out["recv"] = back(col.recv(like, (r - 1) % w, group))
        else:
            out["recv"] = back(col.recv(like, (r - 1) % w, group))
            col.send(to(x[r]), (r + 1) % w, group)
        return out

    def allreduce_ms(self, group, nbytes, iters=5):
        """Host ms of an all-reduce of nbytes of f32 on the nccl group,
        after two warm ones, each ended by a synchronize."""
        import torch
        from ray_tpu_torch.parallel import collective as col
        t = torch.ones(nbytes // 4, device="cuda")
        for _ in range(2):
            col.allreduce(t, group)
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            col.barrier(group)
            t0 = time.perf_counter()
            col.allreduce(t, group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times


def collective_expected(world):
    """The host rule (numpy over the ranks' blocks in rank order) for every
    operation of CollectiveMember.run, rank by rank."""
    x, pos = collective_inputs(world)
    total = x.sum(0)
    out = []
    for r in range(world):
        want = {"allreduce_sum": total, "allreduce_max": x.max(0), "allreduce_min": x.min(0),
                "allreduce_product": pos.prod(0), "allgather": np.concatenate(list(x)),
                "reducescatter": np.split(total, world)[r], "broadcast": x[0],
                "reduce": total if r == 1 else x[r],
                "alltoall": np.concatenate([np.split(x[j], world)[r] for j in range(world)]),
                "recv": x[(r - 1) % world]}
        out.append(want)
    return out


def collective_cards(n, device):
    """(c) create_collective_group: n actors with num_gpus=1 join a "host"
    group (the rendezvous actor's; made first, while no process group is
    up in them) and then, on the card, an "nccl" group (rank 0's address
    published through the group's rendezvous actor) through their
    `_init_collective` methods. Every operation's result equals the host
    rule on the same seeded blocks, rank by rank. Timed: the bus GB/s of
    a 256 MiB all-reduce on the nccl group."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.parallel.collective import create_collective_group
    cuda = device == "cuda"
    members = [rt.remote(num_gpus=1)(CollectiveMember).remote() for _ in range(n)]
    try:
        bindings = rt.get([m.binding.remote() for m in members], timeout=300)
        t0 = time.perf_counter()
        create_collective_group(members, n, list(range(n)), backend="host", group_name="host_g")
        host_up = time.perf_counter() - t0
        got = {"host": rt.get([m.run.remote("host_g", False) for m in members], timeout=300)}
        if cuda:
            t0 = time.perf_counter()
            create_collective_group(members, n, list(range(n)), backend="nccl",
                                    group_name="nccl_g")
            nccl_up = time.perf_counter() - t0
            got["nccl"] = rt.get([m.run.remote("nccl_g", True) for m in members], timeout=300)
            times = rt.get([m.allreduce_ms.remote("nccl_g", ALLREDUCE_BYTES)
                            for m in members], timeout=300)
    finally:
        for m in members:
            rt.kill(m)
    want = collective_expected(n)
    bad = [f"{g} rank {r} {k}" for g, outs in got.items() for r, o in enumerate(outs)
           for k, v in o.items() if not np.array_equal(v, want[r][k])]
    out = dict(host_up_s=host_up, bindings=bindings, groups=sorted(got), mismatches=bad)
    if cuda:
        ms = float(np.median([max(col) for col in zip(*times)]))
        out.update(nccl_up_s=nccl_up, allreduce_ms=times, allreduce_bytes=ALLREDUCE_BYTES,
                   allreduce_bus_gb_s=2 * (n - 1) / n * ALLREDUCE_BYTES / (ms / 1e3) / 1e9)
    checks = {
        f"every operation of the {'host and nccl groups' if cuda else 'host group'} equals the "
        f"host rule on every rank ({len(bad)} mismatches)": not bad,
        f"{n} members on {n} cards" if cuda else f"{n} members":
            (len({b["uuids"][0] for b in bindings}) == n) if cuda else len(bindings) == n,
    }
    for what, ok in checks.items():
        log(f"[cards actors] collective {'ok  ' if ok else 'FAIL'} {what}")
    log(f"[cards actors] collective: host group up {host_up:.2f} s" + (
        f", nccl group up {out['nccl_up_s']:.2f} s; a 256 MiB all-reduce {ms:.2f} ms = "
        f"{out['allreduce_bus_gb_s']:.1f} GB/s bus (median of 5, slowest rank)" if cuda
        else "; no nccl on the CPU"))
    if not all(checks.values()):
        raise AssertionError(f"actors collective checks failed: {bad}")
    return out


def run_actors_cards(n, device="cuda", presets=None):
    """Group `actors` of `--cards n`: in one session of the port's runtime
    that counts the n cards, (a) worker_group_cards, (b) pipeline_cards and
    (c) collective_cards."""
    import ray_tpu_torch as rt
    presets = presets or {}
    preset = presets.get("llama", "llama_1b")
    t0 = time.perf_counter()
    rt.init(num_cpus=4 * n, num_gpus=None if device == "cuda" else n)
    try:
        res = dict(group=worker_group_cards(n, device, preset, presets.get("group_seq", 2048)),
                   pipeline=pipeline_cards(n, device, preset,
                                           presets.get("pipe_seq", PIPE_SEQ),
                                           presets.get("seqpipe_overrides")),
                   collective=collective_cards(n, device))
    finally:
        workers, left = stop_runtime(rt)
    res["seconds"] = time.perf_counter() - t0
    log(f"[cards actors] {'ok  ' if not left else 'FAIL'} every worker exited after "
        f"shutdown() ({workers} workers); the group took {res['seconds']:.1f} s")
    if left:
        raise AssertionError(f"actors: workers still running after shutdown(): {left}")
    return res


CLUSTER_MACHINE = "a3-highgpu-1g"   # the cluster group's node shape: one H100 a host


def run_cluster_cards(n, device="cuda", presets=None, whole=None):
    """Group `cluster` of `--cards n`: the port's runtime across n node
    agents, one a card. This process is a head owning no card
    (rt.init(num_gpus=0, cluster_port=0)); GcpGpuNodeProvider(CLUSTER_MACHINE)
    on FakeGpuApi over this process's n cards, installed with
    sdk.set_node_provider, launches the nodes one request_resources at a
    time, so node k registers k-th, bound to card k. (a) n num_gpus=1
    actors with SPREAD: n node agents, their cards' UUIDs this process's
    n. (b) The trainer's worker group across the agents:
    TorchTrainer(group_fit_loop, use_worker_actor=True,
    ScalingConfig(num_workers=n, use_gpu=True,
    resources_per_worker={<the machine's marker>: 1})) places one
    TrainWorker an agent ({"fsdp": n}, llama_1b, B=1 a card, T=2048, 4
    steps, a sharded checkpoint at step 2); rank ACTORS_FAIL_RANK SIGKILLs
    its agent's process group at step 3 of the first attempt, the head's
    reconciler launches a replacement bound to that card, and the group
    restarts (FailureConfig(max_failures=1)) from step 2's checkpoint. Held
    to `whole`, the unkilled run of group `actors` (a) on a single-node
    session of this invocation (run here when that group did not run):
    the loss history equal, every rank's blocks' digest equal, every rank
    of an attempt on its own card and agent, B1-B3 counted on every rank,
    none here. Logs the last step's ms (the resumed attempt's second,
    NCCL up) against the single node's and the seconds from the kill to
    the resumed step."""
    import tempfile

    import torch
    import chip_smoke
    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.autoscaler import FakeGpuApi, GcpGpuNodeProvider, sdk
    from ray_tpu_torch.models.llama import LlamaConfig

    presets = presets or {}
    preset, seq = presets.get("llama", "llama_1b"), presets.get("group_seq", 2048)
    cuda = device == "cuda"
    tag = "cards cluster"
    t_group = time.perf_counter()
    if whole is None:
        rt.init(num_cpus=4 * n, num_gpus=None if cuda else n)
        try:
            whole = worker_group_cards(n, device, preset, seq)
        finally:
            stop_runtime(rt)
    out, checks = dict(preset=preset, world=n, seq=seq, machine=CLUSTER_MACHINE), {}
    reset_launch_counts()
    rt.init(num_cpus=4, num_gpus=0, cluster_port=0)
    cards = provider_cards(n, device)
    api = FakeGpuApi(cards=cards)
    provider = GcpGpuNodeProvider(machine_type=CLUSTER_MACHINE, api=api)
    marker = provider.registration_marker
    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    try:
        sdk.set_node_provider(provider, max_nodes=n)
        t1 = time.perf_counter()
        handles = []
        for k in range(n):
            handles += sdk.request_resources(bundles=[{"GPU": 1}] * (k + 1))["launched_nodes"]
            wait_until(lambda: rt.cluster_resources().get("GPU", 0) == k + 1, 60,
                       f"node {k}'s registration")
        out["register_s"] = time.perf_counter() - t1
        agents = [provider.pid_of(h) for h in handles]
        card_of_agent = {provider.pid_of(h): api.cards_of(h)[0] for h in handles}
        checks[f"{n} nodes launched one request at a time, node k bound to card k "
               f"({[api.cards_of(h) for h in handles]})"] = (
            [api.cards_of(h) for h in handles] == [[c] for c in cards])
        want_uuids = ([str(torch.cuda.get_device_properties(i).uuid) for i in range(n)]
                      if cuda else None)

        # (a) placement
        pingers = [rt.remote(num_gpus=1, scheduling_strategy="SPREAD")(Pinger).remote()
                   for _ in range(n)]
        bindings = rt.get([p.binding.remote() for p in pingers], timeout=120)
        for p in pingers:
            rt.kill(p)
        out["placement"] = bindings
        checks[f"{n} num_gpus=1 actors with SPREAD on {n} node agents"] = (
            sorted(b["ppid"] for b in bindings) == sorted(agents))
        if cuda:
            checks[f"their cards' UUIDs are this process's {n}"] = (
                sorted(b["uuids"][0] for b in bindings) == sorted(want_uuids))

        # (b) the worker group across the agents, a node killed mid-run
        rec = os.path.join(root, "records")
        os.makedirs(rec)
        config = dict(preset=preset, seq=seq, steps=ACTORS_STEPS, device=device,
                      scratch=os.path.join(root, "scratch"), records=rec,
                      flag=os.path.join(root, "died"), kill_node=True)
        t1 = time.perf_counter()
        result = train.TorchTrainer(
            chip_smoke.group_fit_loop, train_loop_config=config, use_worker_actor=True,
            scaling_config=train.ScalingConfig(num_workers=n, use_gpu=cuda,
                                               resources_per_worker={marker: 1}),
            run_config=train.RunConfig(name="cluster", storage_path=root,
                                       failure_config=train.FailureConfig(max_failures=1))).fit()
        out["fit_s"] = time.perf_counter() - t1
        out["launches_here"] = launch_counts()
        records = [json.load(open(os.path.join(rec, f))) for f in sorted(os.listdir(rec))]
        crash = json.load(open(os.path.join(root, "died")))
        events = [dict(action=e["action"], handle=e["handle"])
                  for e in rt.api._runtime.controller.reconciler.events]
        out["replaced_on"] = [api.cards_of(e["handle"]) for e in events
                              if e["action"] == "replace"]
        out["reconciler"] = events
    finally:
        provider.shutdown()
        workers, left = stop_runtime(rt)
        shutil.rmtree(root, ignore_errors=True)
    layers = getattr(LlamaConfig, preset)().n_layers
    per = layers if cuda else 0
    hist = [(m["step"], m["loss"]) for m in result.metrics_history]
    attempts = [[r for r in records if r["start"] == st] for st in sorted({r["start"]
                                                                            for r in records})]
    dead_card = card_of_agent.get(crash["ppid"])
    second = [m for m in result.metrics_history if m["start"] == ACTORS_SAVE_AT]
    last = result.metrics_history
    out.update(history=hist, errors=repr(result.error), records=records, crash=crash,
               ms_per_step=(last[-1]["t1"] - last[-2]["t0"]) / 2 * 1e3,
               ms_last_step=(last[-1]["t1"] - last[-1]["t0"]) * 1e3,
               ms_last_step_single_node=whole["ms_last_step"],
               kill_to_restart_s=second[0]["loop_start"] - crash["t"] if second else None,
               kill_to_resumed_step_s=second[0]["t0"] - crash["t"] if second else None)
    agent_of = lambda group: {r["binding"]["ppid"] for r in group}
    checks.update({
        "no error in the fit": result.error is None,
        f"steps 1-{ACTORS_STEPS} and losses equal the single-node unkilled group's":
            hist == [tuple(h) for h in whole["history"]],
        f"two attempts, the second resumed from step {ACTORS_SAVE_AT}, {n} ranks each":
            [len(a) for a in attempts] == [n, n] and attempts[1][0]["start"] == ACTORS_SAVE_AT,
        "every rank of an attempt on its own node agent" + (" and card" if cuda else ""): all(
            len(agent_of(a)) == len(a) and (not cuda or len(
                {r["binding"]["cuda_visible_devices"] for r in a}) == len(a)) for a in attempts),
        f"rank {ACTORS_FAIL_RANK}'s node (card {dead_card}) killed and replaced by the "
        f"reconciler on the same card ({out['replaced_on']})":
            out["replaced_on"] == [[dead_card]],
        "every rank's blocks equal the single-node group's (digests)":
            final_digests(records) == {int(k): v for k, v in whole["digests"].items()}
            and len(whole["digests"]) == n,
        f"B1-B3 launched {layers} x the steps each rank's process took, on every rank"
        + ("" if cuda else " (0 on the CPU)"): all(
            r["launches"][f] == per * (r["step"] - r["start"]) for r in records
            for f in FLASH_NAMES),
        "no kernel launched here": not any(out["launches_here"].values()),
        f"every worker exited after shutdown() ({workers} workers)": not left,
    })
    out["seconds"] = time.perf_counter() - t_group
    for what, ok in checks.items():
        log(f"[{tag}] {'ok  ' if ok else 'FAIL'} {what}")
    if result.error is not None:
        log(f"[{tag}] the fit's error: {str(result.error)[-4000:]}")
    log(f"[{tag}] {preset} at {{'fsdp': {n}}} B=1 a card T={seq} over {n} node agents: step "
        f"{ACTORS_STEPS} {out['ms_last_step']:.1f} ms (the resumed attempt's second step) against "
        f"{whole['ms_last_step']:.1f} ms on one node's unkilled run; steps {ACTORS_STEPS - 1}-"
        f"{ACTORS_STEPS} with their reports {out['ms_per_step']:.1f} ms a step (the first after "
        f"the restart starting NCCL) against {whole['ms_per_step']:.1f}; "
        f"rank {ACTORS_FAIL_RANK}'s node killed at step {ACTORS_FAIL_AT}, the group restarted "
        f"{out['kill_to_restart_s'] or 0:.2f} s later, its first step "
        f"{out['kill_to_resumed_step_s'] or 0:.2f} s after the kill; nodes up in "
        f"{out['register_s']:.1f} s; fit {out['fit_s']:.1f} s; group {out['seconds']:.1f} s"
        + (f" ({smi_line()})" if cuda else ""))
    if not all(checks.values()):
        raise AssertionError(f"cluster group checks failed: "
                             f"{[what for what, ok in checks.items() if not ok]}")
    out.pop("records")
    return out


def main_cards(n, device="cuda", presets=None, max_tokens=32, phases=CARDS_PHASES):
    """`--cards n`: with "runtime", run_runtime_cards in this process; with
    "serve", run_serve_cards in this process (replicas of the port's runtime
    on the cards); with "actors", run_actors_cards in this process (the
    trainer's worker group, build_pipeline and create_collective_group over
    GPU actors); with "cluster", run_cluster_cards in this process (n node
    agents a card each under a head owning none, the worker group across
    them with a node killed and replaced, held to "actors"' unkilled
    group, run first when "actors" did not run); with "tune", run_tune_cards in this
    process (a Tune sweep one trial at a time, then n trials at once, a card
    each); with "rl_dp", rl_dp_cards in a world of its own whose
    ranks start as torchrun's do (_dp_rank); then one rank per card over
    NCCL, the phases of cards_phases; then, with "seqpipe", MPMD 1F1B in
    this process with stage i on card i
    (check_1f1b in f32, time_1f1b in bf16). `presets` names the dense and
    MoE presets (llama_1b and Mixtral-8x7B at all 32 layers by default),
    with optional overrides and sequence lengths, for rehearsals at a small
    size."""
    presets = presets or dict(llama="llama_1b", moe=MOE_PRESET)
    import torch
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"--cards {n} needs {n} visible cards, have "
                           f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    if device == "cuda" and {"actors", "cluster", "tune", "seqpipe", "tp", "fsdp"} & set(phases):
        from ray_tpu_torch.ops import _build
        _build.build()      # once, before actors or ranks load it (rl_dp launches none)
    prior = {}
    if "runtime" in phases:
        prior["runtime"] = run_runtime_cards(n, device)
    if "serve" in phases:
        prior["serve"] = run_serve_cards(n, device, presets["llama"], max_tokens=16)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / CARDS_OUT).write_text(json.dumps(prior, indent=1, default=str))
    if "actors" in phases:
        prior["actors"] = run_actors_cards(n, device, presets)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / CARDS_OUT).write_text(json.dumps(prior, indent=1, default=str))
    if "cluster" in phases:
        prior["cluster"] = run_cluster_cards(n, device, presets,
                                             (prior.get("actors") or {}).get("group"))
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / CARDS_OUT).write_text(json.dumps(prior, indent=1, default=str))
    if "tune" in phases:
        prior["tune"] = run_tune_cards(n, device, presets)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / CARDS_OUT).write_text(json.dumps(prior, indent=1, default=str))
    if "rl_dp" in phases:
        prior["rl_dp"] = spawn_ranks(_dp_rank, n, (device, _free_port()))[0]
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / CARDS_OUT).write_text(json.dumps(prior, indent=1, default=str))
    res = dict(prior, world=n)
    if {"seqpipe", "tp", "fsdp"} & set(phases):
        ranks = spawn_ranks(_cards_rank, n, (device, presets, max_tokens, tuple(phases), prior))
        res = ranks[0]
    if "tp" in phases:
        # the failed follower raised its own error; the others ended when
        # rank 0's process went
        res["failing_follower"]["followers"] = [r["failing_follower"] for r in ranks[1:]]
        log(f"[cards] the followers of the failed server: "
            f"{res['failing_follower']['followers']}")
        if not ranks[1]["failing_follower"]["error"] == "follower lost its card":
            raise AssertionError(f"the failing follower's own error: "
                                 f"{ranks[1]['failing_follower']}")
    if "seqpipe" in phases:
        import torch
        devices = ([torch.device("cuda", i) for i in range(n)] if device == "cuda"
                   else [torch.device("cpu")] * n)
        ov = presets.get("seqpipe_overrides", {})
        res["mpmd"] = dict(check=check_1f1b(devices, presets["llama"], overrides=ov,
                                            tag="cards"))
        if device == "cuda":
            res["mpmd"]["timing"] = time_1f1b(devices, presets["llama"], overrides=ov,
                                              tag="cards")
    res["seconds"] = time.perf_counter() - t0
    if device == "cuda":
        res["device"] = smi_line()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / CARDS_OUT).write_text(json.dumps(res, indent=1, default=str))
    log(f"[cards] done in {res['seconds']:.1f} s; results in chip_smoke_out/{CARDS_OUT}")
    return res


def cards_arg(argv):
    """The n of `--cards n` (None without it)."""
    if "--cards" not in argv:
        return None
    return int(argv[argv.index("--cards") + 1])


def phases_arg(argv):
    """The four-card phases of `--phases a,b` (all of CARDS_PHASES without
    it, the run that checks a change; one group alone is a rehearsal aid)."""
    if "--phases" not in argv:
        return CARDS_PHASES
    phases = tuple(argv[argv.index("--phases") + 1].split(","))
    if not set(phases) <= set(CARDS_PHASES):
        raise ValueError(f"--phases takes some of {CARDS_PHASES}, got {phases}")
    return phases


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build

    cards = cards_arg(sys.argv[1:])
    if cards:
        log(f"[device] {smi_line()} | torch {torch.__version__} cuda {torch.version.cuda} | "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        main_cards(cards, phases=phases_arg(sys.argv[1:]))
        print(smi_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{kind} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    path_seconds = {}   # each path's (or phase's) wall seconds, in the order run

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            path_seconds[name] = time.perf_counter() - t

    t0 = time.perf_counter()
    _build.load_library()
    build_seconds = _build.build_seconds
    path_seconds["build"] = time.perf_counter() - t0
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "build_log.txt").write_text(_build.build_log)
    mma_counts = check_tensor_cores(_build.build())
    registers = check_spills(ptxas_report(_build.build_log))

    rng = np.random.default_rng(0)
    cases = []
    t0 = time.perf_counter()
    flash_err = check_flash(rng, cases)
    bwd_err, bwd_readings = check_flash_bwd(rng, cases)  # max-abs error of each kernel
    paged_err = check_paged(rng, cases)
    flash_t = {t: time_flash(rng, t) for t in (16, 128, 2048)}
    for t, r in flash_t.items():
        log(f"[kernels] flash_fwd T={t}: {r['ms']:.4f} ms (eager call {r['eager_ms']:.4f}), "
            f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    train_t = time_flash_train(rng, cases)
    path_seconds["kernels"] = time.perf_counter() - t0

    summary = timed("serve", run_slice)
    # B4 timed at the slice's decode batch (prompt lengths + 16 generated)
    # and at the long shape (every row a full 2048-token table), the latter
    # over 4 input sets (135 MB of K and V, more than the L2 cache holds)
    serve_lengths = [n + 16 for n in summary["prompt_lens"][:8]]
    t0 = time.perf_counter()
    paged_t = time_paged(rng, serve_lengths)
    paged_long = time_paged(rng, [2048] * 8, copies=4)
    paged_plans = sweep_paged_plan(rng, serve_lengths)
    path_seconds["paged_timing"] = time.perf_counter() - t0
    for what, r in (("serve lengths", paged_t), ("long, lengths 2048", paged_long)):
        log(f"[kernels] paged_decode B=8 {what}: {r['ms']:.4f} ms (eager call "
            f"{r['eager_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}), plan (n_split, pages_per_split) "
            f"{r['plan']}")

    import gc
    gc.collect()
    torch.cuda.empty_cache()   # the llama_1b server is gone; Mixtral needs the room
    moe = timed("serve_moe", run_moe, rng)
    replica = timed("replica", run_replica)
    # one session of the port's runtime for the paths that use actors: PD's
    # prefill replica, the runtime's checks, Serve's OpenAI app, then jobs
    session_init_s = timed("session_init", open_session, "cuda")
    pd = timed("serve_pd", run_pd)
    sequential = pd.pop("sequential")
    runtime = timed("runtime", run_runtime, sequential)
    runtime["init_s"] = session_init_s
    serve_app = timed("serve_app", run_serve_app, sequential)
    jobs = timed("jobs", run_jobs, sequential, runtime)
    runtime["session_workers"] = timed("session_close", close_session, "session")
    cluster = timed("cluster", run_cluster, sequential)
    radix_visits = timed("radix_visits", run_radix_visits, sequential)
    tiered = timed("serve_tiered", run_tiered)

    train = timed("train", lambda: dict(grads=check_train_grads(), head_bf16=check_head_bf16(),
                                        **run_train()))
    topology, nccl = timed("topology_nccl", lambda: (check_topology(), check_nccl_world()))
    run_a = {}
    trainer = dict(timed("train_resume", run_trainer, keep=run_a), topology=topology, nccl=nccl)
    trainer["fit"] = timed("train_fit", run_train_fit, run_a)
    # a second session of the port's runtime: the trainer's actor, then
    # Tune's trials
    fit_init_s = timed("session2_init", open_session, "cuda")
    trainer["fit_actor"] = timed("train_fit_actor", run_train_fit_actor, run_a)
    trainer["fit_actor"]["init_s"] = fit_init_s
    tune = timed("tune", run_tune, run_a)
    tune["session_workers"] = timed("session2_close", close_session, "train_fit_actor+tune")
    del run_a
    trainer["ckpt_whole"] = timed("ckpt_whole", run_ckpt_whole)
    mesh = timed("serve_tp", run_mesh)
    train_mesh = timed("train_mesh", run_train_mesh)
    seqpipe = timed("seqpipe", run_seqpipe)
    rl = timed("rl", run_rl)

    # one row per kernel; launches counted on each main path that was driven,
    # timings at the training shape for the flash kernels (the serving shapes
    # are in chip_smoke.json and PERF.md), max-abs error over the checked
    # cases and the training shape
    paths = {"serve": summary["launches"], "serve_moe": moe["launches"],
             "serve_pd": pd["launches"], "serve_pd_proc": pd["proc"]["launches"],
             "runtime": runtime["launches"], "serve_app": serve_app["launches"],
             "jobs": jobs["launches"], "cluster": cluster["launches"],
             "serve_tiered": tiered["launches"],
             "ckpt_whole": trainer["ckpt_whole"]["launches"],
             "train": train["launches"], "train_resume": trainer["launches"],
             "train_fit": trainer["fit"]["launches"],
             "train_fit_actor": trainer["fit_actor"]["launches"], "tune": tune["launches"],
             "serve_tp": mesh["launches"], "train_mesh": train_mesh["launches"],
             "ring": seqpipe["launches"]["ring"],
             "pipeline": seqpipe["launches"]["pipeline"], **rl["launches"]}
    serve_paths = ("serve", "serve_moe", "serve_pd", "serve_pd_proc", "runtime", "serve_app",
                   "jobs", "cluster", "serve_tiered", "ckpt_whole", "serve_tp", "ring", "pipeline",
                   "tune") + RL_PATHS

    def flash_row(name, source, replaces, err):
        t = train_t[name]
        by_path = {k: v[name] for k, v in paths.items()}
        at_8b = [rows[name]["max_abs_err"] for rows in train_mesh["kernels_8b_shapes"].values()]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=sum(by_path.values()), launches_by_path=by_path,
                    max_abs_err=max(err, t["max_abs_err"], *at_8b), ms=t["ms"],
                    plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"])

    kernels = [
        flash_row("flash_fwd", "ray_tpu_torch/ops/csrc/flash_fwd.cu",
                  "ray_tpu/ops/flash_attention.py:37", flash_err),
        flash_row("flash_bwd_dq", "ray_tpu_torch/ops/csrc/flash_bwd.cu",
                  "ray_tpu/ops/flash_attention.py:138", bwd_err["flash_bwd_dq"]),
        flash_row("flash_bwd_dkv", "ray_tpu_torch/ops/csrc/flash_bwd.cu",
                  "ray_tpu/ops/flash_attention.py:175", bwd_err["flash_bwd_dkv"]),
        dict(name="paged_decode", route="cuda",
             source="ray_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="ray_tpu/ops/paged_attention.py:38",
             launches=sum(paths[k]["paged_decode"] for k in serve_paths),
             launches_by_path={k: paths[k]["paged_decode"] for k in serve_paths},
             combine_launches=sum(paths[k]["paged_decode_combine"] for k in serve_paths),
             max_abs_err=paged_err, ms=paged_t["ms"], plain_ms=paged_t["plain_ms"],
             bound_ms=paged_t["bound_ms"], bound_by=paged_t["bound_by"], library_ms=None),
    ]
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_seconds=build_seconds, tensor_core_instructions=mma_counts,
        ptxas=registers, cases=cases, bwd_readings=bwd_readings,
        flash_timing=list(flash_t.values()), train_kernel_timing=train_t,
        paged_timing=paged_t, paged_timing_long=paged_long, paged_plans=paged_plans,
        slice=summary, moe=moe, replica=replica, pd=pd, runtime=runtime, serve_app=serve_app,
        jobs=jobs, cluster=cluster, radix_visits=radix_visits,
        tiered=tiered,
        train=train,
        trainer=trainer, tune=tune, mesh=mesh, train_mesh=train_mesh, seqpipe=seqpipe, rl=rl,
        kernels=kernels, path_seconds=path_seconds),
        indent=1, default=str))
    log(f"[paths] seconds a path, in the order run: "
        f"{json.dumps({k: round(v, 2) for k, v in path_seconds.items()})}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
