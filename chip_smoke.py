#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py             # from the repository root
    python3 chip_smoke.py --kernels   # phases 1-3 of K1/K2 only
    python3 chip_smoke.py --mesh      # phases 1-2, 4, 6 and 15 only
    python3 chip_smoke.py --fleet     # phases 1-2, 4 and 16 only
    python3 chip_smoke.py --eager     # phases 1-2, 4 and 17 only
    python3 chip_smoke.py --dist      # phases 1-2, 4 and 18 only
    python3 chip_smoke.py --hybrid    # phases 1-2, 4 and 19 only
    python3 chip_smoke.py --moe-ps    # phases 1-2, 4 and 20 only
    python3 chip_smoke.py --tensor-api  # phases 1-2 and 21 only
    python3 chip_smoke.py --nn        # phases 1-2 and 22 only
    python3 chip_smoke.py --vision    # phases 1-2 and 23 only
    python3 chip_smoke.py --quant-seq # phases 1-2 and 24 only

(``--durability-child`` is phase 13's own child process,
``--fleet-child`` phase 16's replica, ``--acp-child`` phase 18's
auto-checkpoint job, ``--hybrid-child`` the whole run's phase 19, which
runs beside phase 20.)

Phases, in order; any failure exits non-zero:

1. card   — require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build  — compile every kernel under paddle_tpu_torch/ops/csrc with
   nvcc for sm_90a; print the registers, local (stack and spill) bytes
   and shared memory of every flash and K1/K2 kernel instantiation, as
   the CUDA runtime reports them, and fail if one at head_dim 64 uses
   local memory (a spill);
3. kernel — hold kernels K1 (ragged paged attention) and K2 (the same
   over int8 pages, made by `paged_quant_write` from random f32 K/V)
   against their plain PyTorch version on the card, f32 and bf16, at
   the serving path's decode and mixed-step shapes, at GQA shapes, at
   the mixed step over 16-position pages, at a decode with every slot
   near the horizon, at the speculative verify windows of K=4 and K=8 (5
   and 9 query rows a sequence, from offsets 0 to the horizon, write caps
   0 to K+1), at the ragged step's steady state (64 rows a sequence,
   one live) and at a mesh rank's shard of the ragged step (``mp=2``: 6
   heads, mixed and steady state); check that two launches give
   bitwise-equal
   outputs; time each kernel (beside the simple design's earlier time,
   `PAGED_SIMPLE_MS`), the plain version and one PyTorch library call, and
   give the bound with the unit it assumes (`paged_unit`) and its share;
4. serve  — serve GPT-2-small at full width (random weights from a
   seed) through `DecodeEngine` at default flags: 16 requests, prompts
   of 64-512 tokens, half sharing a 128-token prefix, 64 new tokens
   each; check the drain, the prefix cache and that every step's
   attention went through K1; then hold a recorded mixed step's and
   decode step's attention outputs against the plain version, and one
   short request's greedy tokens against the CPU engine.  Every serve
   of 4-7 and 12 runs its steps as captured CUDA graphs (the engine's
   default): after its first run no ``*_retraces`` counter may have
   moved and each step kind it runs must have counted one compile (a
   legacy serve one prefill compile a bucket); the split f32, the int8,
   the ragged f32 and the split prompt-lookup serves run again under
   ``disable_capture()``, where the greedy tokens must equal the
   captured serve's request by request and the K1/K2 launches the
   captured serve's; the recorders run under ``disable_capture()`` (a
   replay never calls the Python they wrap);
5. quant  — the same serve with ``kv_quant="int8", serve_weights="int8"``:
   the checks of 4, int8 pages, reset page scales, 48 folded weight
   matrices, every step's attention through K2 and none through K1; the
   recorded steps against the plain version; then the int8 pools of one
   short request on the card against the CPU engine's (scales and
   payloads within `POOL_TOL`) and the greedy tokens (printed);
6. ragged — the serves of 4 and 5 with ``ragged_step=True``: every step
   one unified ragged step, K1 (K2) launched num_layers x steps; a
   recorded chunk-carrying step and a steady-state ragged step (every
   slot one live row) against the plain version; one short request's
   greedy tokens against the CPU's split engine (f32), the int8 pools
   against the CPU's (int8);
7. spec   — the serve of 4 with ``spec_decode_k=4``: prompt lookup on the
   ragged and the split path, GPT-2-small as its own draft model (split;
   acceptance at least 0.9) and a ``draft_config()`` draft with random
   weights (ragged; acceptance printed); K1 launched exactly num_layers x
   (mixed steps + verify rounds) + draft layers x draft steps; a recorded
   verify step against the plain version; one short request's greedy
   tokens, split and ragged spec engines against the CPU's non-spec
   engine.  Every serve of 4-7 and 12 runs 3 times: tokens/s of each run
   and their spread, the host milliseconds a step and the peak memory
   (captured and eager side by side where both ran), acceptance and
   tokens equal to the f32 split serve's are printed, not gated;
8. flash  — hold kernels K3 (flash-attention forward) and K4 (its
   backward: dkv and dq) against their plain versions on the card at
   the train path's shape (B=16, H=12, S=1024, D=64, causal; f32 and
   bf16), non-causal, at a ragged S=1000, and at B=2, H=16, S=2048,
   D=128 (bf16); time each kernel (with its achieved TFLOP/s and share
   of its bound), the plain versions and PyTorch's
   ``scaled_dot_product_attention`` forward and backward; check that two
   backward launches on the train case give bitwise-equal dq, dk and dv;
9. train  — train GPT-2-small at full width with ``bench.py``'s bf16
   AdamW `jit.TrainStep` (batch 16 x 1024): 2 warm-up and 10 timed
   steps; check finite, falling losses that start near ln(vocab) and
   that every step's attention went through K3 and K4; hold one layer's
   recorded attention inputs and output gradient against the plain
   versions; then train a small GPT (D=64) 3 steps on the card and on
   the CPU from the same weights, in f32 and under bf16 AMP, and hold
   losses and parameters against each other;
10. ln    — hold kernel K5 (row LayerNorm forward) against its plain
   version at [16384, 768] and [4096, 4096], f32 and bf16, timed with
   the plain version and ``torch.nn.functional.layer_norm``;
11. ln train — the train of 9 with ``FLAGS_use_pallas_layernorm`` on: 2
   warm-up and 3 timed steps; K5 launched once per LayerNorm module (25)
   per step, K3/K4 12 times; the first loss against 9's;
12. legacy — the serve of 4 with ``chunked_prefill=False`` (each prompt
   one `_gpt_prefill` pass between steps, one graph a power-of-two
   bucket), in f32 and with int8 KV pages and weights: K1 (K2) launched
   num_layers x decode steps; one short request's greedy tokens against
   the CPU's legacy engine (f32), or its int8 pools against the CPU's;
13. reliability — the f32 serve of 4 through the serving stack around
   the engine: (a) `ServingFrontend` under ``sched_policy`` "fifo" and
   "slo", every `TokenStream` consumed concurrently, 3 serves each beside
   3 of ``engine.run``: tokens equal ``engine.run``'s request by request,
   K1 launched num_layers x steps, one mixed and one decode graph, no
   retrace, the engine never rebuilt; tokens/s, TTFT and TPOT
   p50/p95 (from the streams) printed; (b) the serve under `FAULT_PLAN`
   (retries, pool exhaustion, a dropped callback, three mixed-step faults
   that degrade to the legacy prefill, a poisoned request): the poisoned
   request alone finishes "fault" with a `FaultInfo`, the others with
   the clean tokens, no retrace; every scheduled fault fired once,
   ``faults_injected`` counts exactly what fired and the ladder contained
   nothing else; (c) `resilience.recover` twice mid-serve,
   with graph handoff (no graph captured) and cold: the clean tokens, and
   the allocated memory after both within one engine's pools of before;
   seconds printed; (d) a journaled serve in a child process
   (``--durability-child``) killed with SIGKILL after `KILL_STEP` steps
   and restored by another, f32 and int8: the uninterrupted serve's
   tokens, every streamed token exactly once across the two lives, sidecar
   pages installed bit-equal to the dead process's; restore seconds,
   pages installed, tokens recomputed and the journal's tokens/s cost
   printed; (e) ``step_timeout_ms`` and a `slow_step` stall through the
   frontend: the worker abandoned, the streams finish with the clean
   tokens, the abandoned engine's late return launches nothing.  Every
   serve without a fault plan (each timed run of 4-13, each frontend,
   recovery and durability serve) and the watchdog's beside its one
   stall must leave the ladder's counters (`LADDER_KEYS`) where they
   were and contain nothing (`check_unfaulted`);
14. telemetry — the serving telemetry plane (`paddle_tpu_torch.
   observability`): (a) the split f32 serve with JAX's defaults
   (``flight_window=64``, ``cost_model=True``), disarmed, the recorder
   alone and the cost model alone, 3 runs each in turns: equal tokens,
   K1 launched num_layers x steps, no retrace; host ms a step, tokens/s,
   GC passes, and the hooks' own microseconds printed; (b) a probe every
   step on the f32 (also through `ServingFrontend`), int8 and ragged
   serves: each step's time by flight phase, the probes' device/host
   split and MFU printed; then the whole plane (alerts, the ops server on
   127.0.0.1:0 scraped every 20 ms during the serve and after it) on the
   f32 and int8 serves through the frontend and the ragged one: every
   catalog name in /metrics, probe device seconds within each step's
   wall, every MFU and HBM-utilisation gauge in (0, 1.05], the ledger's
   kv_pages and weights equal to the pools' and the parameters' bytes,
   the residue printed; (c) a capture session with ``FLAGS_profile_dir``:
   the torch.profiler trace and the merged chrome trace load, the latter
   with engine, requests and device tracks; (d) the `FAULT_PLAN` serve's
   window renders the poisoned request through the port's
   explain_request, and a fatal fault dumps by itself and recovers.
   Every captured serve of 4-7 and 12 is also held to a twin with the
   plane disarmed: the same tokens and K1/K2 launches;
15. mesh  — tensor-parallel serving (``serve_mesh``) of the ragged serve
   of 6: (a) ``mp=2`` in f32 (one card: both ranks share it over gloo,
   steps eager): K1 launched num_layers x steps on every rank, the
   unsharded ragged serve's tokens (a parting only at a near-tie of the
   unsharded logits, `MESH_NEAR_TIE`, printed), the first step's logits
   within `MESH_LOGIT_TOL` (`MESH_LOGIT_TOL_INT8` with int8 pages) of
   the unsharded step's, the collective bytes
   a step equal to the formula; tokens/s and host ms a step beside the
   unsharded captured and eager serves', the all-reduces' share of a
   step from a torch.profiler pass, the chip skew of a probed serve; (b)
   the same with int8 KV pages and weights, on K2; (c) ``mp=1`` on NCCL,
   captured: one graph with its 24 all-reduces recorded inside it, the
   unsharded captured serve's tokens exactly, no retrace; (d) NCCL with
   a card a rank: on two cards or more (a) and (b) themselves run on
   NCCL, captured, and on four ``mp=4`` f32 runs as (a) (else a printed
   skip).  Backend and placement are printed;
16. fleet — the serve of 4 through the fleet layer (`paddle_tpu_torch.
   fleet`): replica child processes (``--fleet-child``), all on cuda:0,
   each GPT-2-small behind an `EdgeServer` with its ops server and
   captured steps, four fresh pairs started together once the kernels
   are built; every stream's tokens must equal 4's for its prompt.  (a)
   4's prompts in waves of two (`fleet_waves`) through a round-robin and
   an affinity `FleetRouter`, each on its own pair: the fleet-wide
   prefix-cache page hit rate (the replicas' /metrics) strictly higher
   under affinity; the 16 at once on a third pair, tokens/s against 4's
   ``engine.run``; (b) chaos on the fourth pair, journals at
   ``fsync=always`` under the git-ignored `FLEET_ROOT` and
   FLAGS_fleet_trace on in the parent and the children: 6 streams in
   flight, the replica holding most killed with SIGKILL once each has a
   token and none has finished, 4 more submitted: the victim died by
   SIGKILL, zero loss and 4's tokens for every stream, a failover counted
   (``paddle_fleet_failovers_total``), the parent's /alertz rollup names
   the dead replica, ``/fleetz?trace=`` puts each migrated request on one
   lane across both replicas; kill to all complete, TTFT and the
   journal's records and bytes printed; (c) every replica's report,
   written on SIGTERM: K1 launched num_layers x steps, no retrace, one
   graph a compile (the survivor's adopted requests replay its graphs),
   the survivor adopted; (d) the captured serve of 4 under
   FLAGS_sanitize and FLAGS_kv_pool_debug between two unarmed ones: 4's
   tokens, no `SanitizerError`, a host sync and a pool audit a step, no
   lock-order cycle; host ms a step printed;
17. eager — the dygraph loop of GPT-2-small at full width (the train of
   9's weights and batch, shuffled by a `DataLoader` under one
   ``np.random.seed``): (a) ``loss.backward(); opt.step();
   opt.clear_grad(); sched.step()`` with AdamW over
   ``LinearWarmup(CosineAnnealingDecay)`` and ``ClipGradByGlobalNorm``
   for `EAGER_STEPS` steps against `jit.TrainStep` with the same recipe
   from the same weights on the same batches: losses within
   `EAGER_LOSS_TOL` (bit equality printed), K3/K4 launched num_layers x
   steps each, one recorded step's attention against the plain
   versions, peak memory of each loop and, from `EAGER_TURNS` steps of
   each taken in turns after both, ms a step and tokens/s; then one eager
   step with ``FLAGS_use_pallas_layernorm``: K5 once a LayerNorm (25);
   (d) ``paddle.save``/``paddle.load`` of the eager model and optimizer
   into another pair: one more step of each, bit-equal loss and
   parameters; (b) the loop at ``dropout=0.1`` from ``GPT(cfg)``'s own
   init under ``paddle.seed``: finite, falling losses, bit-equal under
   one seed, other under another; (c) ``paddle.Model(...).fit`` for
   `EAGER_FIT_STEPS` steps on a `TensorDataset` of the batch: its logged
   losses against (a)'s TrainStep losses; (e) 4's model, ``eval()``,
   greedy ``generate`` of `GEN_NEW_TOKENS` over 4's prompts with the
   concat and the prealloc cache: equal tokens, equal to 4's engine
   tokens (a parting only at a near-tie, `first_parting`), K3 launched
   num_layers times a concat call and never by a prealloc call,
   tokens/s of each; (f) ``FLAGS_check_nan_inf``: no mode installed
   with the flags off; on, a NaN put into a bias raises
   FloatingPointError, and a captured serve of two prompts gives 4's
   tokens;
18. dist  — GPT-2-small at full width with bench.py's bf16 recipe
   (AdamW 1e-4, the forward under bf16 ``auto_cast``): (a) two ranks
   from ``paddle.distributed.spawn``, each ``fleet.init(is_collective=
   True)``, ``fleet.distributed_model``, ``fleet.distributed_optimizer(
   AdamW)`` and `DIST_STEPS` dygraph steps on its half (8 x 1024) of
   the train batch, against one process on batch 16 from the same
   weights: losses within `DIST_LOSS_TOL`, K3/K4 launched num_layers x
   steps on each rank, every rank exits 0; ms a step, the all-reduce's
   share (the reducer's host seconds), bytes reduced a step, peak memory
   a rank; the backend is the rule's (gloo on one card, staged through
   host memory; NCCL with a card a rank), and on four cards 4 ranks of
   batch 4 run as well; (b) in this process, gradient
   merge ``k_steps=2`` through ``fleet.build_train_step`` against the
   batch-16 ``jit.TrainStep`` (`DIST_LOSS_TOL`), and recompute on
   against off: equal losses and a lower peak; (c) each of the ten
   optimizers (`DIST_OPTIMIZERS`), `OPT_STEPS` dygraph steps against
   ``jit.TrainStep`` from the same weights and seed: bit-equal, finite
   losses; (d) ``profiler.profiler()`` around two dygraph steps and a
   captured serve of 4: the table's ``serving.*_step`` rows count the
   serve's steps, the chrome trace has host events; a
   ``start_trace``/``stop_trace`` of a dygraph step names K3/K4; a
   ``RecordEvent``'s microseconds and the serve's ms a step with the
   profiler armed against disarmed, in turns; (e) auto-checkpoint: a
   child (``--acp-child``, GPT-2-small at dropout 0.1) killed with
   SIGKILL after epoch 1 of ``train_epoch_range``, restarted from
   another seed and init, resumes at epoch 2 and ends with an unbroken
   child's parameters and losses, bit for bit;
19. hybrid — (in the whole run, a child process of this script started
   before phase 20 and read after it: the two run side by side)
   GPT-2-small at full width, bench.py's bf16 recipe, ranks
   from ``paddle.distributed.spawn`` (gloo on one card, NCCL with a card
   a rank): (a) ``fleet`` with ``mp_degree=2``: the model's parallel
   layers (6 heads a rank), `HYBRID_STEPS` dygraph steps through
   ``distributed_model`` (`TensorParallel`) and as many
   ``build_train_step`` steps on the 8 x 1024 half of the train batch,
   the vocab-parallel cross entropy; step 1's loss against one process
   on the same batch (`DIST_LOSS_TOL`), K3/K4 launched num_layers x
   steps a rank; (b) ``strategy.sharding`` at stages 1, 2, 3 and 1 with
   offload, dp = 2, `HYBRID_STEPS` steps each on the batch-16 train
   batch against phase 18's one-process steps (`DIST_LOSS_TOL`), peak
   memory a rank against the data-parallel run's; (c) a
   `gpt_pipeline_layer` GPT at pp = 2,
   ``accumulate_steps=4``, through ``build_train_step`` (the 1F1B
   `PipelineTrainStep`), step 1 against one process; (e)
   ``ring_attention`` at [4, 12, 1024, 64] bf16 causal, sp = 2, against
   ``flash_attention_fwd`` in one process (`FLASH_TOL`), K3 launched
   once on rank 0 and twice on rank 1, a backward's gradient finite;
   (d) ``gpt_spmd.build_spmd_train_step`` at (1, 2, 2, 2) on 8 ranks,
   batch 4 x 1024: f32 against the dense ``reference_loss`` and its SGD
   update on the card (`SPMD_TOL`), then bf16: ms a step, K3 launched
   a ring block (1 or 2 a layer by sp rank); for each part ms a step,
   the collectives' share (`collective.comm_stats`: host seconds, which
   over gloo are wall seconds), peak memory and K3/K4 launches a rank;
20. moe-ps — the rest of distributed training, ranks from
   ``paddle.distributed.spawn``: (a) JAX's tests/test_moe.py:87 net at
   GPT-2-small's MLP width (`MoELayer(768, 3072, num_experts=8, k=2,
   capacity_factor=1.25)` and a ``Linear(768, 768)`` head, f32, MSE plus
   0.01 x the auxiliary loss, SGD): the explicit mode at ep = 2 (each
   rank its 8 x 1024 half of 16 samples, 4 experts a rank, C = 2560, two
   all-to-alls forward and one backward a step) against one process's
   dense ``moe_forward`` of the same tokens with all 8 experts (outputs,
   aux and step 1's gradients within `MOE_TOL`); then the fleet mode
   (``ep_axis="mp"``, ``mp_degree=2``) through ``build_train_step``, 3
   steps on batches of 8 x 1024 fed by a `DataLoader` with two worker
   processes (bit-equal to the ``num_workers=0`` batches), against one
   process's dense steps (`DIST_LOSS_TOL`); (b) the parameter server:
   GPT-2-small's 124,475,904 f32 parameters as one dense table of
   ``fleet.init_server`` (server-side SGD), two trainers through
   ``fleet.init_worker()`` on their halves of the batch-16 train batch,
   read from MultiSlot files this phase writes through
   `InMemoryDataset` (equal to the in-memory batch), with bench.py's
   bf16 forward and backward (K3/K4 num_layers x steps a trainer): 3
   sync steps on one server, then on two (`ShardedPSClient`), each
   trainer's pull after step 1 equal, bit for bit, to p0 - lr g_a - lr
   g_b in one of the two orders the server can apply the pushes; then
   geo with ``k_steps=2`` for 4 steps, the table against p0 plus the
   merged deltas (`PS_GEO_TOL`); for each part ms a step, the
   collectives' or the PS round trip's share, bytes moved and peak
   memory a rank;
21. tensor-api — the port's functional tensor API and nn's activations,
   losses and norms (`tensor_api_phase`): (a) the op tables of
   ``tests/torch_op_tables.py`` (the CPU parity tests' own) on the card
   against the port on the CPU, elementwise ops and reductions on
   `TA_STREAM` in f32 and in bf16 under ``auto_cast``, scans, sorts and
   searches on the logits `TA_LOGITS`, linear algebra at `TA_LINALG` (a
   decomposition held by the CPU tests' own invariants,
   ``torch_op_tables.linalg_excess``), the norms on `TA_NORMS` (ResNet's
   first stage), each within `TA_TOL`; (b) every creation and random op,
   ``to_tensor`` and a new layer without a place on the current card
   (cuda:0; cuda:1 after ``torch.cuda.set_device(1)`` where there is a
   second card), on the CPU after ``set_device("cpu")``; (c) `TA_DRAWS` draws of each distribution:
   moments, Kolmogorov-Smirnov and chi-square tests, and ``paddle.seed``
   repeating a draw; (d) ``nn.LayerNorm(768)`` and ``F.layer_norm`` under
   ``FLAGS_use_pallas_layernorm`` on [16384, 768]: K5 launched once a call,
   within `LN_TOL`; a few op times with the card line;
22. nn — the rest of nn at full width (`nn_phase`): (a) BERT-base
   pretraining (`models.bert`, bert-base-uncased's widths) for 3 bf16
   AdamW steps of 16 x 512 through ``jit.TrainStep`` (ms a step, tokens/s,
   peak memory; its masked attention composed, K3/K4 launched 0 times),
   step 1's f32 loss at 2 x 128 within `NN_BERT_LOSS_RTOL` of the CPU's;
   (b) the unmasked pre-norm ``nn.TransformerEncoder`` at ViT-B/16's width
   on [64, 197, 768] bf16: output and gradients within `NN_VIT_TOL` of the
   composed form, then 3 steps launching K3, K4's dkv and dq 12 times a
   step each; (c) ``nn.Transformer(512, 8, 6, 6, 2048)``: one masked train
   step (K3/K4 12 each), then ``dynamic_decode`` at beam 4 over 32 steps
   through the decoder's caches, tokens equal to the CPU's; (d) the PTB
   medium ``LSTM`` against the CPU, and the conv, pool and sampling tables
   of ``tests/torch_op_tables.py`` at ResNet-50's stages (`NN_STAGES`) in
   f32 and bf16 within `TA_TOL`; (e) ``SyncBatchNorm`` over spawned ranks
   (two over gloo on one card, four over NCCL on four) against
   ``BatchNorm`` on the global batch;
23. vision — ``paddle_tpu_torch.vision`` at full width (`vision_phase`):
   (a) ResNet-50 (1000 classes) through ``paddle.Model.fit``:
   ``Momentum(0.1, 0.9)`` with L2 1e-4, bf16 by ``prepare(amp_configs=)``,
   batch 64 from a ``DataLoader`` of 8 worker processes over
   ``FakeData(image_shape=(3, 256, 256))`` through ``RandomResizedCrop(224)``,
   a flip and ImageNet's normalisation: images/s of the timed steps, the
   loader's own images/s, ms a step, peak memory; the f32 eval logits of 2
   images against the port on the CPU (`VISION_CPU_TOL`); (b) ViT-B/16 at
   64 x 3 x 224 x 224, 3 bf16 AdamW steps through ``jit.TrainStep``: K3 and
   K4's dkv and dq launched 12 times a step each (`vision_vit_b16` in
   their ``launches_by_path``), ms a step, images/s, peak memory; the f32
   eval logits (K3's f32 kernel) against the CPU's composed form; (c)
   YOLOv3-DarkNet53 (80 classes) at 8 x 3 x 608 x 608 with 50 padded
   ground-truth rows an image, 3 bf16 steps; then the eval decode at the
   model's defaults: the card's ``multiclass_nms`` on the card's
   ``yolo_box`` candidates equal to the CPU's on the same candidates
   (rows, indices, counts), ms of the heads, the decode and the NMS apart;
   (d) the vision op table at detection-model shapes (`VISION_ROI`,
   `VISION_DEFORM`): ``roi_align``/``roi_pool`` and ``deform_conv2d`` with
   gradients, ``nms``, ``generate_proposals``' defaults, the multiclass and
   matrix NMS, ``yolo_box``, ``box_coder``, ``prior_box``, each within
   `TA_TOL` of the CPU port (indices and counts equal), with the card's ms;
24. quant-seq — quantization, 2:4 sparsity, the CRF and the op long tail
   (`quant_seq_phase`): (a) ResNet-50 (1000 classes) at batch 64: QAT
   (``ImperativeQuantAware``, 3 f32 Momentum steps; each quantized layer's
   ``_act_scale`` on the EMA rule, every weight's gradient finite and
   nonzero through the straight-through estimator), then PTQ of a fresh
   model over 4 calibration batches and ``convert_to_int8``: 53 integer
   convolutions and 1 integer linear a forward, all through
   ``torch._int_mm``; the stem's and a stage-4 3x3's s32 accumulators
   bit-equal to an f64 convolution of the same int8 operands; two images
   against the CPU layer by layer (`_qs_cascade`: every int8 layer
   bit-equal on the card's own input, the first moved int8 input one
   level off on float inputs within `QS_EDGE_LEVELS`), their logits within
   `QS_INT8_CPU_TOL` of the CPU's and the batch's of the fake-quant
   model's, top-1 equal to the fake-quant model's off a fixed band
   (`QS_TOP1_BAND`, at most `QS_MAX_NEAR_TIES` near-ties); ms a batch and
   images/s of the f32,
   fake-quant and int8 evals, peak memory; (b) GPT-2-small pruned 2:4
   (``sparsity.prune_model``, ``decorate(AdamW)``), `QS_SPARSE_STEPS` bf16
   dygraph steps at 16 x 1024: K3 and K4's dkv and dq 12 a step each
   (`quant_seq_sparse_gpt2` in their ``launches_by_path``), after every
   step ``check_mask`` on every pruned parameter and its zeros exactly its
   mask's; ms a step beside the unpruned model's; (c) a BERT-base CRF
   tagger (``Linear(768, 67)`` emissions, ``linear_chain_crf`` over a
   [69, 67] transition) on ``Conll05st``'s synthetic corpus at 32 x 128
   through a ``DataLoader`` and ``sequence_pad``, 3 bf16 AdamW steps; the
   card's ``crf_decoding`` equal to the CPU's, the IOB chunk counts and
   ``ChunkEvaluator``'s precision, recall and F1 equal; ms a step, of the
   CRF's forward+backward and of the Viterbi decode; (d) every op of the
   sequence, CRF, control-flow, industrial and misc modules, ``Auc``,
   ``DetectionMAP`` and the distributions' densities at realistic shapes
   (`_qs_op_cases`) within `TA_TOL` of the CPU port (integer outputs
   equal), with the card's ms; the samplers' draws checked, the
   distributions' moments over `QS_DRAWS` draws within `QS_SIGMAS`
   standard errors;
25. deployment (``--static``): f32, TF32 off, served by
   ``inference.create_predictor`` (one CUDA graph a feed signature): (a)
   ResNet-50 at [32, 3, 224, 224] as a ProgramDesc through ``fx_export``
   (logits against eager, top-1 equal, ms a batch captured and op by
   op); (b) ResNet-50 at batch 1 through ``jit.save`` (latency captured
   and op by op); (c) ViT-B/16 at [8, 3, 224, 224] through ``jit.save``,
   K3 12 launches a run through its custom op; (d) BERT-base at 16 x 128
   as a ProgramDesc (sequence and pooled outputs against eager); each
   part's export and load seconds, peak memory and op count;
26. report — one JSON line of kernels, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

The whole result also goes to chiprun_out/chip_smoke.json.  The script
imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,    # H100 SXM, f32 outside the tensor cores
              "bfloat16": 989e12,  # H100 SXM, dense bf16 tensor cores
              # dense TF32 tensor cores, three products per f32 product
              # (the 3xTF32 split of K1/K2's tensor-core path in f32)
              "tf32x3": 494.7e12 / 3}
# K1/K2 run on the tensor cores from q_len * group = 16 rows (f32 as
# 3xTF32, bf16 as bf16), below it on the CUDA cores in f32
PAGED_TC_MIN_ROWS = 16
# K1/K2 times of their first, simple design (one block per 16 query rows, no
# split-KV, CUDA-core math), measured by this script's kernel phase
# (``--kernels``, run in a checkout of that design) on one H100 80GB HBM3
# at 700.00 W: printed beside the new times as a yardstick, never
# reported as this run's
PAGED_SIMPLE_MS = {
    ("K1", "decode", "float32"): 0.1272,
    ("K1", "decode", "bfloat16"): 0.0891,
    ("K1", "mixed", "float32"): 0.2339,
    ("K1", "mixed", "bfloat16"): 0.1939,
    ("K1", "gqa_decode", "float32"): 0.3299,
    ("K1", "gqa_decode", "bfloat16"): 0.2686,
    ("K1", "gqa_mixed", "float32"): 0.5097,
    ("K1", "gqa_mixed", "bfloat16"): 0.5411,
    ("K1", "mixed_p16", "float32"): 0.2358,
    ("K1", "mixed_p16", "bfloat16"): 0.1959,
    ("K1", "decode_long", "float32"): 0.1344,
    ("K1", "decode_long", "bfloat16"): 0.091,
    ("K2", "decode", "float32"): 0.0828,
    ("K2", "decode", "bfloat16"): 0.089,
    ("K2", "mixed", "float32"): 0.192,
    ("K2", "mixed", "bfloat16"): 0.1987,
    ("K2", "gqa_decode", "float32"): 0.2581,
    ("K2", "gqa_decode", "bfloat16"): 0.2709,
    ("K2", "gqa_mixed", "float32"): 0.5841,
    ("K2", "gqa_mixed", "bfloat16"): 0.59,
    ("K2", "mixed_p16", "float32"): 0.1925,
    ("K2", "mixed_p16", "bfloat16"): 0.1995,
    ("K2", "decode_long", "float32"): 0.0833,
    ("K2", "decode_long", "bfloat16"): 0.0898,
}
# stated tolerances of K1 against the plain version, by dtype:
# f32 — the kernel scales q before the dot (the Pallas form) where the
#   plain version scales the product (the XLA form), and sums in another
#   order: a few f32 ulps of logits, far under 1e-4 on outputs of O(1);
# bf16 — the plain version rounds logits and probabilities to bf16
#   (the XLA cast discipline) while the kernel keeps them in f32; both
#   round the output to bf16, whose ulp is 2**-7 near 1: 2e-2 holds two
#   output ulps for values below 2 plus the rounding of the logits.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
K1_SOURCE = "paddle_tpu_torch/ops/csrc/paged_attention.cu"
K1_REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:339"
# K2 (int8 pages) holds to K1's tolerances: it dequantizes K and V exactly
# as the plain version does (int8 -> f32, times the page's scale, rounded
# through q's dtype), so both attend over bit-identical operands and only
# K1's differences remain
K2_REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:403"
# card against CPU, quantized pools after one short request: layer 0's
# K/V come from identical inputs up to the matmul's summation order, so
# its scales (absmax / 127) agree within 1e-6 relative.  A later layer
# also reads the earlier layers' 1-LSB rounding flips (each moves a
# dequantized K/V element by a whole int8 step) through attention, and
# the difference compounds with depth; its scales may differ by less
# than one int8 step, 1/127 relative, under which every row still
# quantizes within 1 LSB.  Payloads everywhere within 1 LSB.
POOL_TOL = dict(scale_rel_layer0=1e-6, scale_rel=1.0 / 127,
                payload_lsb=1)
# K5 against its plain version: f32 1e-5 (the same f32 statistics summed
# in another order); bf16 one output ulp, |d| <= 2**-7 |ref| + 1e-6
LN_TOL = {"float32": dict(abs=1e-5, rel=0.0),
          "bfloat16": dict(abs=1e-6, rel=2.0 ** -7)}
LN_SOURCE = "paddle_tpu_torch/ops/csrc/layer_norm.cu"
LN_REPLACES = "paddle_tpu/ops/pallas/layer_norm.py:30"
# the flag-on train's first loss against the flag-off train's on the same
# weights and batch: only LayerNorm's summation order differs (~1e-7 of
# its outputs), which can flip a bf16 rounding of a matmul input; the
# loss is a mean over 16k tokens, so ~1e-4 is expected and 1e-3 allowed
LN_TRAIN_LOSS_TOL = 1e-3
LN_TRAIN_STEPS = 3
# stated tolerances of K3/K4 against the plain versions, by dtype and
# output: f32 as K1's (q scaled before the product against the product
# scaled, sums in another order); bf16 outputs and gradients 2e-2 as K1's
# (both sides work in f32 on the same bf16 inputs and round the result to
# bf16: two ulps below 2), bf16 lse 5e-2 (the plain forward rounds the
# logits to bf16, |logit| up to ~8 at these inputs: 2**-8 * 8 = 3e-2)
FLASH_TOL = {"float32": dict(out=1e-4, lse=1e-4, dq=1e-4, dk=1e-4, dv=1e-4),
             "bfloat16": dict(out=2e-2, lse=5e-2, dq=2e-2, dk=2e-2,
                              dv=2e-2)}
FLASH_SOURCE = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
# bf16 times at the train shape of the SIMT kernels that the tensor-core
# kernels replaced, measured by an earlier version of this script (one
# H100 80GB HBM3 at 700 W): printed beside the new times as a yardstick,
# never reported as this run's
FLASH_SIMT_MS = {"fwd": 1.0608, "dkv": 2.2296, "dq": 1.7334}
FLASH_KERNELS = {  # wrapper name -> (TPU kernel replaced, products, outputs)
    "fwd": ("paddle_tpu/ops/pallas/flash_attention.py:69", 2,
            ("out", "lse")),
    "dkv": ("paddle_tpu/ops/pallas/flash_attention.py:298", 4, ("dk", "dv")),
    "dq": ("paddle_tpu/ops/pallas/flash_attention.py:359", 3, ("dq",)),
}
TRAIN_STEPS = 10
# the device sleep before each timed launch (`time_ms`): ~0.2 ms at the
# H100's ~1.98 GHz boost clock
SLEEP_CYCLES = 400_000


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------
def quant_pages(torch, hkv, npages, page, d, gen):
    """int8 pages and their scales as the serving path makes them:
    `paged_quant_write` of random f32 K or V rows filling every page, each
    page at its own magnitude, 0.25 to 1 times K1's unit-normal K/V (so
    K1's bf16 tolerance, stated for those, holds: larger K makes larger
    logits, whose bf16 rounding in the plain version grows with them)."""
    from paddle_tpu_torch.ops.paged_attention import paged_quant_write

    dev = "cuda"
    rows = npages * page
    vals = torch.randn(rows, hkv, d, generator=gen, device=dev)
    vals *= (0.25 + 0.75 * torch.rand(npages, generator=gen, device=dev)
             ).repeat_interleave(page)[:, None, None]
    pages = torch.zeros(hkv, npages, page, d, dtype=torch.int8, device=dev)
    scales = torch.zeros(hkv, npages, device=dev)
    # every row written, none dropped: the pages need no drop page
    paged_quant_write(pages, scales, (
        torch.arange(npages, device=dev).repeat_interleave(page),
        torch.arange(page, device=dev).repeat(npages),
        torch.arange(npages, device=dev)), vals)
    return pages, scales


def kernel_inputs(torch, case, dtype, gen, quant=False):
    b, qn, hq, d = case["B"], case["Q"], case["Hq"], case["D"]
    hkv, page, pages_max = case["Hkv"], case["page"], case["pages_max"]
    npages = b * pages_max + 3
    dev = "cuda"
    scales = {}
    if quant:
        k_pages, ks = quant_pages(torch, hkv, npages, page, d, gen)
        v_pages, vs = quant_pages(torch, hkv, npages, page, d, gen)
        scales = dict(k_scales=ks, v_scales=vs)
    else:
        k_pages = torch.randn(hkv, npages, page, d, generator=gen,
                              device=dev).to(dtype)
        v_pages = torch.randn(hkv, npages, page, d, generator=gen,
                              device=dev).to(dtype)
    # a shuffled block table: the indirection must really be exercised
    bt = torch.randperm(npages, generator=gen, device=dev)[:b * pages_max]
    bt = bt.reshape(b, pages_max).to(torch.int32).contiguous()
    q = torch.randn(b, qn, hq, d, generator=gen, device=dev).to(dtype)
    seq_lens = torch.tensor(case["seq_lens"], dtype=torch.int32, device=dev)
    q_offsets = torch.tensor(case["q_offsets"], dtype=torch.int32,
                             device=dev)
    return (q, k_pages, v_pages, bt, seq_lens, q_offsets), scales


def paged_unit(case, dname):
    """The unit K1/K2's products run on at ``case``: a key of
    `PEAK_FLOPS`."""
    if case["Q"] * case["Hq"] // case["Hkv"] < PAGED_TC_MIN_ROWS:
        return "float32"  # the SIMT path: f32 on the CUDA cores
    return "tf32x3" if dname == "float32" else "bfloat16"


def work_of(torch, case, dtype, quant=False, unit=None):
    """Bytes the function must move (live K/V — int8 with quant, with one
    f32 scale per live page and head — q, out, indices once) and the
    flops these inputs need (4 * D per visible (row, kv) pair), the flops
    at the rate of ``unit`` (default: the dtype's).  Returns ``(bound_ms,
    bound_by)``."""
    item = torch.empty((), dtype=dtype).element_size()
    b, qn, hq, d = case["B"], case["Q"], case["Hq"], case["D"]
    hkv, page = case["Hkv"], case["page"]
    horizon = page * case["pages_max"]
    live = sum(min(s, horizon) for s in case["seq_lens"])
    kv_item = 1 if quant else item
    live_pages = sum(-(-min(s, horizon) // page) for s in case["seq_lens"])
    nbytes = (2 * live * hkv * d * kv_item + 2 * b * qn * hq * d * item
              + 4 * (b * case["pages_max"] + 2 * b)
              + (2 * 4 * live_pages * hkv if quant else 0))
    pairs = sum(max(min(s, o + i + 1, horizon), 0)
                for s, o in zip(case["seq_lens"], case["q_offsets"])
                for i in range(qn))
    flops = 4 * d * hq * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[unit or str(dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps=30, warm=3):
    """Median CUDA-event time of ``fn``; a 128 MB write before every
    timed launch evicts the 50 MB L2, as the serving path (which walks
    every layer's pages in turn) finds it cold.  A ~0.2 ms device sleep
    after the write keeps the card busy while the host enqueues ``fn``,
    so the events time the device's work and not the host's (a Python
    wrapper can take longer to enqueue a launch than the write takes to
    run)."""
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    for _ in range(warm):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _wrappers():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.ops import paged_attention as pa
    return dict(paged_attention=pa.paged_attention_cuda,
                paged_attention_q=pa.paged_attention_cuda_q,
                fwd=fa.flash_attention_cuda_fwd,
                dkv=fa.flash_attention_cuda_dkv,
                dq=fa.flash_attention_cuda_dq,
                layer_norm=ln.layer_norm_cuda)


def reset_counts():
    """Set every kernel's launch count to 0."""
    for w in _wrappers().values():
        w.launches = 0


def read_counts():
    return {k: w.launches for k, w in _wrappers().items()}


def kernel_phase(torch, quant=False):
    """K1 (or, with ``quant``, K2 over int8 pages) against the plain
    version at the serving path's shapes, f32 and bf16, timed; two
    launches of every case bitwise equal."""
    from paddle_tpu_torch.nn.functional.attention import \
        multi_query_causal_mask
    from paddle_tpu_torch.ops import paged_attention as pa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    decode_lens = [0, 1, 63, 64, 65, 517, 1000, 1024]
    long_lens = [1000, 1003, 1008, 1011, 1016, 1019, 1022, 1024]
    mixed_offs = [0, 37, 64, 200, 447, 0, 700, 960]
    mixed_caps = [64, 64, 64, 10, 64, 0, 1, 64]
    mixed_lens = [o + c for o, c in zip(mixed_offs, mixed_caps)]
    # verify windows: K+1 rows written from offsets 0, 63, 64 ... up to the
    # horizon, caps 0 (a slot still prefilling), 1 and the whole window
    verify_offs = [0, 63, 64, 200, 517, 1000, 1019, 1023]
    verify_caps = {5: [5, 5, 1, 0, 5, 3, 5, 1], 9: [9, 9, 1, 0, 9, 3, 5, 1]}
    # the ragged steady state: every slot one live row of Q_r = 64
    ragged_lens = [1, 2, 64, 65, 66, 518, 1001, 1024]
    base = dict(B=8, page=64, pages_max=16)
    cases = [
        # the serving path's two shapes (GPT-2-small, 8 slots, 64-token
        # pages, 1024 horizon) and a GQA shape
        dict(base, name="decode", Q=1, Hq=12, Hkv=12, D=64,
             seq_lens=decode_lens, q_offsets=[s - 1 for s in decode_lens]),
        dict(base, name="mixed", Q=64, Hq=12, Hkv=12, D=64,
             seq_lens=mixed_lens, q_offsets=mixed_offs),
        dict(base, name="gqa_decode", Q=1, Hq=32, Hkv=8, D=128,
             seq_lens=decode_lens, q_offsets=[s - 1 for s in decode_lens]),
        dict(base, name="gqa_mixed", Q=64, Hq=32, Hkv=8, D=128,
             seq_lens=mixed_lens, q_offsets=mixed_offs),
        # the mixed step over 16-position pages: a 64-position tile spans
        # four pages
        dict(base, name="mixed_p16", Q=64, Hq=12, Hkv=12, D=64, page=16,
             pages_max=64, seq_lens=mixed_lens, q_offsets=mixed_offs),
        # decode with every slot near the horizon, where split-KV matters
        # most
        dict(base, name="decode_long", Q=1, Hq=12, Hkv=12, D=64,
             seq_lens=long_lens, q_offsets=[s - 1 for s in long_lens]),
        # the speculative verify step at K=4 (5 rows a KV head: one SIMT
        # row tile) and K=8 (9 rows: two row tiles, each combined)
        dict(base, name="verify", Q=5, Hq=12, Hkv=12, D=64,
             seq_lens=[o + c for o, c in zip(verify_offs, verify_caps[5])],
             q_offsets=verify_offs),
        dict(base, name="verify_k8", Q=9, Hq=12, Hkv=12, D=64,
             seq_lens=[o + c for o, c in zip(verify_offs, verify_caps[9])],
             q_offsets=verify_offs),
        # the ragged step with every slot decoding: the tensor-core path
        dict(base, name="ragged_decode", Q=64, Hq=12, Hkv=12, D=64,
             seq_lens=ragged_lens, q_offsets=[s - 1 for s in ragged_lens]),
        # a rank's shard of the ragged step at serve_mesh="mp=2": half
        # the heads, a chunk-carrying step and the steady state
        dict(base, name="mesh_mixed", Q=64, Hq=6, Hkv=6, D=64,
             seq_lens=mixed_lens, q_offsets=mixed_offs),
        dict(base, name="mesh_ragged_decode", Q=64, Hq=6, Hkv=6, D=64,
             seq_lens=ragged_lens, q_offsets=[s - 1 for s in ragged_lens]),
    ]
    kname = "K2" if quant else "K1"
    kernel = pa.paged_attention_cuda_q if quant else pa.paged_attention_cuda
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = []
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            (q, kp, vp, bt, sl, qo), sc = kernel_inputs(torch, case, dtype,
                                                        gen, quant)
            out = kernel(q, kp, vp, bt, sl, qo, **sc)
            again = kernel(q, kp, vp, bt, sl, qo, **sc)
            ref = pa.paged_attention_reference(q, kp, vp, bt, sl,
                                               q_offsets=qo, **sc)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                fail(f"{kname} {case['name']} {dname}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            bitwise = torch.equal(out, again)
            zero_rows = [i for i, s in enumerate(case["seq_lens"]) if s == 0]
            if zero_rows and out[zero_rows].abs().max().item() != 0.0:
                fail(f"{kname} {case['name']} {dname}: seq_len 0 not exact "
                     f"zeros")
            ms = time_ms(torch, lambda: kernel(q, kp, vp, bt, sl, qo, **sc))
            plain_ms = time_ms(torch, lambda: pa.paged_attention_reference(
                q, kp, vp, bt, sl, q_offsets=qo, **sc))
            # library yardstick: SDPA over K/V (dequantized and) gathered
            # to dense [B, Hq, S, D] AHEAD of the timing (excluded)
            g = case["Hq"] // case["Hkv"]
            kd = kp[:, bt.long()]
            vd = vp[:, bt.long()]
            if quant:
                kd = (kd.float() * sc["k_scales"][:, bt.long()][
                    ..., None, None]).to(dtype)
                vd = (vd.float() * sc["v_scales"][:, bt.long()][
                    ..., None, None]).to(dtype)
            kd = kd.movedim(1, 0).flatten(2, 3)
            vd = vd.movedim(1, 0).flatten(2, 3)
            kd = kd.repeat_interleave(g, dim=1).contiguous()
            vd = vd.repeat_interleave(g, dim=1).contiguous()
            qd = q.transpose(1, 2).contiguous()
            mask = multi_query_causal_mask(qo, case["Q"], sl,
                                           kd.shape[2])[:, None]
            library_ms = time_ms(torch, lambda: sdpa(qd, kd, vd,
                                                     attn_mask=mask))
            unit = paged_unit(case, dname)
            bound_ms, bound_by = work_of(torch, case, dtype, quant, unit)
            row = dict(case=case["name"], dtype=dname,
                       shape=dict(B=case["B"], Q=case["Q"], Hq=case["Hq"],
                                  Hkv=case["Hkv"], D=case["D"],
                                  page=case["page"],
                                  pages_max=case["pages_max"]),
                       max_abs_err=err, tol=TOL[dname], ok=err <= TOL[dname],
                       bitwise_equal_launches=bitwise, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       bound_unit=unit, bound_share=bound_ms / ms,
                       simple_design_ms=PAGED_SIMPLE_MS.get(
                           (kname, case["name"], dname)))
            if hasattr(pa, "split_plan"):
                row["splits"], row["chunk"] = pa.split_plan(
                    case["B"], case["Q"] * g, case["Hkv"],
                    case["page"] * case["pages_max"], sms)
            extra = ""
            if unit == "tf32x3":  # the same work at the f32 CUDA-core rate
                row["bound_ms_f32_cuda_cores"], _ = work_of(
                    torch, case, dtype, quant, "float32")
                extra = (f", {row['bound_ms_f32_cuda_cores']:.4f} at the "
                         f"f32 CUDA-core rate")
            results.append(row)
            simple = row["simple_design_ms"]
            print(f"kernel {kname} {case['name']:>11} {dname:>8}: "
                  f"max_abs_err {err:.3g} (tol {TOL[dname]}) ms {ms:.4f} "
                  f"(the simple design's earlier time "
                  f"{'not measured' if simple is None else simple}) "
                  f"plain_ms "
                  f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
                  f"{bound_ms:.4f} ({bound_by}, {unit}{extra}; "
                  f"{bound_ms / ms:.1%} of it) splits "
                  f"{row.get('splits')} bitwise {bitwise}", flush=True)
            if not row["ok"]:
                fail(f"{kname} {case['name']} {dname}: max_abs_err {err} > "
                     f"{TOL[dname]}")
            if not bitwise:
                fail(f"{kname} {case['name']} {dname}: two launches differ")
    return results


# ---------------------------------------------------------------------------
# phases 4-5: serve GPT-2-small, in f32 and quantized
# ---------------------------------------------------------------------------
class AttentionRecorder:
    """Records the inputs and output of the first call of each kind the
    serving path's attention makes, passing every call through unchanged:
    "decode" (q of rank 3), "verify" (a speculative window of
    ``spec_k + 1`` rows on the split path), "ragged" (a ragged step whose
    slots write one row or none) and "mixed" (any other multi-row step)."""

    def __init__(self, module, spec_k=None):
        self.module = module
        self.inner = module.paged_attention
        self.spec_k = spec_k
        self.calls = {}

    def kind(self, q, seq_lens, q_offsets):
        if q.dim() == 3:
            return "decode"
        if self.spec_k is not None and q.shape[1] == self.spec_k + 1:
            return "verify"
        if int((seq_lens - q_offsets).max()) <= 1:
            return "ragged"
        return "mixed"

    def __call__(self, q, k_pages, v_pages, block_tables, seq_lens,
                 scale=None, q_offsets=None, k_scales=None, v_scales=None):
        out = self.inner(q, k_pages, v_pages, block_tables, seq_lens,
                         scale=scale, q_offsets=q_offsets, k_scales=k_scales,
                         v_scales=v_scales)
        kind = self.kind(q, seq_lens, q_offsets)
        if kind not in self.calls:
            self.calls[kind] = dict(
                args=[t.clone() for t in (q, k_pages, v_pages,
                                          block_tables, seq_lens)],
                kw=dict(q_offsets=q_offsets, k_scales=k_scales,
                        v_scales=v_scales),
                out=out.clone())
            self.calls[kind]["kw"] = {
                k: None if t is None else t.clone()
                for k, t in self.calls[kind]["kw"].items()}
        return out

    def __enter__(self):
        self.module.paged_attention = self
        return self

    def __exit__(self, *exc):
        self.module.paged_attention = self.inner


SERVE_RUNS = 3  # timed serves of each configuration, for the spread
# the step trackers' compile counters (`inference.serving._StepGraph`)
COMPILE_KEYS = ("decode_compiles", "mixed_compiles", "ragged_compiles",
                "verify_compiles", "draft_compiles", "prefill_compiles",
                "kv_quant_compiles")


def compiles(**kinds):
    """The compile counters a serve must show: ``kinds`` (e.g.
    ``decode=1``), every other kind 0."""
    return {k: kinds.get(k[:-len("_compiles")], 0) for k in COMPILE_KEYS}


def capturing(capture):
    """The steps as captured graphs (the engine's default), or eager."""
    from paddle_tpu_torch.inference.serving import disable_capture

    return contextlib.nullcontext() if capture else disable_capture()


# the containment ladder's counters (process-wide `decode_stats` keys):
# a serve with no fault plan moves none of them.  On the card the ladder
# takes only what a plan injects, so a kernel's or a capture's exception
# leaves the serve; these checks hold that no retry, degradation to the
# legacy prefill's plain attention or quarantine happened all the same
LADDER_KEYS = ("faults_injected", "step_retries", "legacy_fallbacks",
               "spec_disables", "finished_fault")


def ladder_counts():
    from paddle_tpu_torch.inference import serving

    st = serving.decode_stats()
    return {k: st[k] for k in LADDER_KEYS}


def check_unfaulted(label, before, engines, injected=0):
    """Fail unless, since ``before`` (`ladder_counts`), the ladder
    counters moved by nothing but ``injected`` faults the plan injected
    (stalls, which the ladder never sees) and no engine of ``engines``
    contained anything."""
    after = ladder_counts()
    moved = {k: after[k] - before[k] for k in LADDER_KEYS}
    want = dict.fromkeys(LADDER_KEYS, 0)
    want["faults_injected"] = injected
    contained = {f"{name}{' (injected)' if inj else ''}": n
                 for eng in engines
                 for (name, inj), n in eng._resilience.contained.items()}
    if moved != want or contained:
        fail(f"{label}: the containment ladder acted in a serve without "
             f"faults to contain: counters moved {moved} (want {want}), "
             f"contained {contained}")


def serve_once(torch, new_engine, prompts, capture=True):
    """One serve of ``prompts`` on a fresh engine, its steps captured or
    eager: ``(engine, requests, wall seconds)``; the ladder left idle
    (`check_unfaulted`)."""
    from paddle_tpu_torch.tools import serve_profile

    before = ladder_counts()
    with capturing(capture):
        eng = new_engine()
        t0 = time.perf_counter()
        reqs = [eng.add_request(p, max_new_tokens=serve_profile.NEW_TOKENS)
                for p in prompts]
        eng.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_unfaulted("serve", before, [eng])
    return eng, reqs, wall


def drive_serve(torch, new_engine, prompts, cfg, label, want, capture=True):
    """Serve ``prompts`` on a fresh engine with every count set to 0 just
    before, its steps captured (or, with ``capture=False``, eager); check
    that every request finished by length with tokens in the vocabulary,
    that the pool drained, that the prefix cache hit (chunked engines),
    that no retrace counter moved, that the compile counters are
    ``want`` and, captured, that each compiled step took one graph;
    then serve them `SERVE_RUNS` - 1 more times for the spread of
    tokens/s.  Returns ``(engine, stats, counts, summary)``; the summary
    keeps each request's tokens under ``tokens`` (not printed)."""
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.tools import serve_profile

    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    serving.reset_decode_stats()
    reset_counts()
    eng, reqs, wall = serve_once(torch, new_engine, prompts, capture)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    st = eng.decode_stats()
    pst = serving.decode_stats()
    retraces = {k: v for k, v in pst.items()
                if k.endswith("_retraces") or k == "retraces_after_warmup"}
    if any(retraces.values()):
        fail(f"{label}: a step retraced after warm-up: {retraces}")
    got = {k: pst[k] for k in COMPILE_KEYS}
    if got != want:
        fail(f"{label}: compile counters {got} != {want}")
    graphs = eng.graph_captures()
    if graphs != (sum(want.values()) if capture else 0):
        fail(f"{label}: {graphs} graphs captured for the compiles {want} "
             f"({'captured' if capture else 'eager'} serve)")

    for r in reqs:
        toks = r.generated_ids
        if (r.finish_reason != "length"
                or len(toks) != serve_profile.NEW_TOKENS):
            fail(f"{label} request {r.request_id}: {r.finish_reason} after "
                 f"{len(toks)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{label} request {r.request_id}: token outside the vocab")
    if eng.pool.available_count != eng.pool.num_pages:
        fail(f"{label}: pool did not drain: {eng.pool.available_count} of "
             f"{eng.pool.num_pages} pages available")
    if eng._chunked and st["prefix_hits"] <= 0:
        fail(f"{label}: no prefix-cache hit")
    rates = [st["tokens"] / wall] + [
        st["tokens"] / serve_once(torch, new_engine, prompts, capture)[2]
        for _ in range(SERVE_RUNS - 1)]
    if capture:
        disarmed_twin(torch, new_engine, prompts, label, reqs, counts)
    spec = st["spec_steps"] > 0
    decode_steps = 0 if spec else st["steps"] - st["mixed_steps"]
    summary = dict(
        requests=len(reqs), prompt_tokens=sum(len(p) for p in prompts),
        new_tokens=st["tokens"], wall_s=wall,
        tokens_per_s=st["tokens"] / wall, tokens_per_s_runs=rates,
        tokens_per_s_median=statistics.median(rates),
        tokens_per_s_spread=(max(rates) - min(rates))
        / statistics.median(rates),
        steps=st["steps"], mixed_steps=st["mixed_steps"],
        decode_steps=decode_steps, ragged_steps=st["ragged_steps"],
        mean_mixed_step_ms=(st["mixed_step_s"] / st["mixed_steps"] * 1e3
                            if st["mixed_steps"] else None),
        mean_decode_step_ms=(st["decode_step_s"] / decode_steps * 1e3
                             if decode_steps else None),
        host_ms_per_step=wall / st["steps"] * 1e3,
        prefix_hits=st["prefix_hits"], launches=counts,
        peak_memory_bytes=peak,
        # the serve's own: what earlier phases left allocated excluded
        peak_memory_above_start_bytes=peak - start_bytes,
        captured=capture, compiles=got,
        graphs=graphs, capture_s=eng._graph_memory.capture_s,
        prefills=pst["prefills"],
        stalled_decode_steps=pst["stalled_decode_steps"])
    if spec:
        summary.update(
            {k: st[k] for k in ("spec_steps", "spec_proposed",
                                "spec_accepted", "spec_emitted",
                                "acceptance_rate",
                                "mean_accepted_per_step", "draft_time_s",
                                "verify_time_s")},
            mean_round_ms=(st["draft_time_s"] + st["verify_time_s"])
            / st["spec_steps"] * 1e3)
    summary["tokens"] = [r.generated_ids for r in reqs]
    return eng, st, counts, summary


# the telemetry plane disarmed: no flight recorder and no cost model (the
# profiling plane and the alerts are off by default); every serve of
# phases 4-7 and 12 is held to such a twin, and phase 14 measures the
# difference
DISARMED = dict(flight_window=0, cost_model=False)


def disarmed_twin(torch, new_engine, prompts, label, reqs, counts):
    """The serve again on a fresh engine with the telemetry plane
    disarmed (`DISARMED`): its greedy tokens must equal the armed serve's
    request by request, and its K1/K2 launches the armed serve's
    (``counts``)."""
    reset_counts()
    twin, twin_reqs, _ = serve_once(
        torch, lambda: new_engine(**DISARMED), prompts)
    got = read_counts()
    if twin._flight is not None or twin._cost is not None:
        fail(f"{label}: the disarmed twin armed the telemetry plane")
    if [r.generated_ids for r in twin_reqs] != \
            [r.generated_ids for r in reqs]:
        fail(f"{label}: the greedy tokens differ between the serve with "
             f"the telemetry plane armed and disarmed")
    for k in ("paged_attention", "paged_attention_q"):
        if got[k] != counts[k]:
            fail(f"{label}: {k} launches {counts[k]} armed, {got[k]} "
                 f"disarmed")


def printable(summary):
    return json.dumps({k: v for k, v in summary.items()
                       if k not in ("tokens", "eager")})


def eager_twin(torch, new_engine, prompts, cfg, label, want, serve,
               kernel):
    """The serve of ``serve`` again with every step eager
    (`disable_capture`): the greedy tokens must equal the captured
    serve's request by request, and ``kernel``'s launches the captured
    serve's.  Prints both serves' tokens/s (median and spread), host
    milliseconds a step and peak memory side by side; stores the eager
    summary under ``serve["eager"]``."""
    _, _, counts, eager = drive_serve(torch, new_engine, prompts, cfg,
                                      f"{label} (eager)", want,
                                      capture=False)
    for i, (a, b) in enumerate(zip(serve["tokens"], eager["tokens"])):
        if a != b:
            fail(f"{label}: request {i}'s greedy tokens differ between the "
                 f"captured and the eager serve")
    if counts[kernel] != serve["launches"][kernel]:
        fail(f"{label}: {kernel} launches {serve['launches'][kernel]} "
             f"captured, {counts[kernel]} eager")
    print(f"{label} captured / eager: tokens/s median "
          f"{serve['tokens_per_s_median']:.1f} / "
          f"{eager['tokens_per_s_median']:.1f} (spread "
          f"{serve['tokens_per_s_spread']:.1%} / "
          f"{eager['tokens_per_s_spread']:.1%}), host ms a step "
          f"{serve['host_ms_per_step']:.3f} / {eager['host_ms_per_step']:.3f}"
          f", peak memory above the start "
          f"{serve['peak_memory_above_start_bytes']} / "
          f"{eager['peak_memory_above_start_bytes']} bytes; "
          f"{serve['graphs']} graphs "
          f"captured in {serve['capture_s']:.3f} s; tokens equal, "
          f"{kernel} launches {counts[kernel]} both", flush=True)
    serve["eager"] = {k: v for k, v in eager.items() if k != "tokens"}


def token_share(a, b):
    """The share of positions where two serves' tokens are equal."""
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return sum(x == y for x, y in pairs) / len(pairs)


def check_recorded_steps(torch, model, prompts, label,
                         kinds=("mixed", "decode"), max_new=3,
                         **engine_kw):
    """The attention outputs of one real step of each of ``kinds``,
    recorded on the path, against the plain version on the same inputs
    (a check, not a route the engine can take)."""
    from paddle_tpu_torch.inference.serving import (DecodeEngine,
                                                    disable_capture)
    from paddle_tpu_torch.ops import paged_attention as pa

    # eager: a replayed graph never calls the Python the recorder wraps
    with disable_capture(), \
            AttentionRecorder(pa, engine_kw.get("spec_decode_k")) as rec:
        DecodeEngine(model, max_batch_size=2, page_size=64,
                     **engine_kw).generate(
            [prompts[0][:100], prompts[2][:150]], max_new_tokens=max_new)
    checks = {}
    for kind in kinds:
        if kind not in rec.calls:
            fail(f"{label}: no {kind} step recorded")
        call = rec.calls[kind]
        ref = pa.paged_attention_reference(*call["args"], **call["kw"])
        err = (call["out"] - ref).abs().max().item()
        checks[kind] = err
        print(f"{label} {kind} step attention vs plain: max_abs_err "
              f"{err:.3g} (tol {TOL['float32']})", flush=True)
        if not err <= TOL["float32"]:
            fail(f"{label} {kind} step attention disagrees with the plain "
                 f"version")
    return checks


def greedy_card_vs_cpu(model, cpu_model, prompt, label, card_kw,
                       cpu_kw=None):
    """Greedy tokens of one short request (8 new) on an engine on the card
    (``card_kw`` added) against the CPU's default engine (the plain
    version; ``cpu_kw`` added), same weights."""
    from paddle_tpu_torch.inference.serving import DecodeEngine

    kw = dict(max_batch_size=1, max_seq_len=128, page_size=64)
    gpu = DecodeEngine(model, **kw, **card_kw).generate([prompt], 8)[0]
    cpu = DecodeEngine(cpu_model, device="cpu", **kw,
                       **(cpu_kw or {})).generate([prompt], 8)[0]
    print(f"{label} greedy tokens, card vs CPU engine: {gpu} / {cpu}",
          flush=True)
    if gpu != cpu:
        fail(f"{label}: greedy tokens of the card's engine differ from the "
             f"CPU's")
    return gpu


def serve_phase(torch):
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools import serve_profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # GPT-2-small at full width, its prompts and its engine, warmed up
    model, prompts, new_engine = serve_profile.gpt2_small_serve("cuda")
    cfg = model.cfg
    want = compiles(decode=1, mixed=1)
    _, st, counts, serve = drive_serve(torch, new_engine, prompts, cfg,
                                       "serve", want)
    launches = counts["paged_attention"]
    if launches <= 0 or launches != cfg.num_layers * st["steps"]:
        fail(f"K1 launches {launches} != num_layers x steps "
             f"({cfg.num_layers} x {st['steps']})")
    print("serve: " + printable(serve), flush=True)
    eager_twin(torch, new_engine, prompts, cfg, "serve", want, serve,
               "paged_attention")
    checks = check_recorded_steps(torch, model, prompts, "serve")

    # end to end on a small input: greedy tokens of the card's engine
    # (K1) against the CPU engine (the plain version) on the same weights
    cpu_model = GPT.random(cfg, seed=serve_profile.SEED,
                           device="cpu")  # the same weights
    greedy_card_vs_cpu(model, cpu_model, prompts[1][:64], "serve", {})
    serve["step_attention_max_abs_err"] = checks
    serve["greedy_tokens_match_cpu"] = True
    return serve, launches


def serve_quant_phase(torch, f32_serve):
    """The serve of `serve_phase` with int8 KV pages (kernel K2) and int8
    weights, then the quantized pools of the card against the CPU's."""
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools import serve_profile

    model, prompts, new_engine = serve_profile.gpt2_small_serve(
        "cuda", kv_quant="int8", serve_weights="int8")
    cfg = model.cfg
    want = compiles(decode=1, mixed=1, kv_quant=1)
    eng, st, counts, serve = drive_serve(torch, new_engine, prompts, cfg,
                                         "quantized serve", want)
    launches = counts["paged_attention_q"]
    if launches <= 0 or launches != cfg.num_layers * st["steps"]:
        fail(f"K2 launches {launches} != num_layers x steps "
             f"({cfg.num_layers} x {st['steps']})")
    if counts["paged_attention"] != 0:
        fail(f"K1 launched {counts['paged_attention']} times in the "
             f"quantized serve")
    if eng._k_pages.dtype != torch.int8 or eng._v_pages.dtype != torch.int8:
        fail(f"quantized serve pages are {eng._k_pages.dtype}")
    if st["kv_quant_pages"] <= 0:
        fail("quantized serve reset no page scale")
    # qkv, out, fc1 and fc2 of each block; the head is tied to wte
    if st["weight_quant_mats"] != 4 * cfg.num_layers:
        fail(f"weight_quant_mats {st['weight_quant_mats']} != 4 x "
             f"{cfg.num_layers}")
    serve.update({k: st[k] for k in ("kv_quant_pages", "kv_quant_refolds",
                                     "weight_quant_mats",
                                     "weight_quant_bytes_saved")})
    serve["kv_bytes_per_token"] = eng._kv_byte_occupancy()["bytes_per_token"]
    serve["vs_f32"] = {k: serve[k] / f32_serve[k] for k in (
        "tokens_per_s_median", "mean_mixed_step_ms", "mean_decode_step_ms",
        "peak_memory_bytes") if serve[k] and f32_serve[k]}
    print("quantized serve: " + printable(serve), flush=True)
    eager_twin(torch, new_engine, prompts, cfg, "quantized serve", want,
               serve, "paged_attention_q")
    serve["step_attention_max_abs_err"] = check_recorded_steps(
        torch, model, prompts, "quantized serve", kv_quant="int8",
        serve_weights="int8")
    cpu_model = GPT.random(cfg, seed=serve_profile.SEED, device="cpu")
    serve["card_vs_cpu"] = quant_pools_card_vs_cpu(
        torch, model, cpu_model, prompts[1][:64])
    return serve, launches


def quant_pools_card_vs_cpu(torch, model, cpu_model, prompt, new=8,
                            **engine_kw):
    """One short request on a quantized engine (``engine_kw`` added) on
    the card and on the CPU, same weights; the two int8 pools after it,
    over the positions written
    from the same tokens, against `POOL_TOL`; the greedy tokens, with the
    first step where they part (printed, not failed: a 1-LSB flip may
    move a token)."""
    from paddle_tpu_torch.inference.serving import DecodeEngine

    runs = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        eng = DecodeEngine(m, max_batch_size=1, max_seq_len=128,
                           page_size=64, kv_quant="int8",
                           serve_weights="int8", device=dev, **engine_kw)
        req = eng.add_request(prompt, new)
        pages = []
        while req.state != "done":
            eng.step()
            pages = list(req.pages) or pages
        runs[dev] = (req.generated_ids, pages,
                     [t.cpu() for t in (eng._k_pages, eng._v_pages,
                                        eng._k_scales, eng._v_scales)])
    (gt, gpages, gpool), (ct, cpages, cpool) = runs["cuda"], runs["cpu"]
    same = next((i for i, (a, b) in enumerate(zip(gt, ct)) if a != b),
                len(gt))
    if gpages != cpages:
        fail(f"card vs CPU quantized pools: page ids {gpages} / {cpages}")
    # position p holds the K/V of prompt token p or of generated token
    # p - len(prompt); the last generated token's K/V is never written
    n_pos = len(prompt) + min(same, new - 1)
    page = gpool[0].shape[3]
    # a page's scale is comparable when every row written to it is
    n_full = -(-n_pos // page) if same >= new - 1 else n_pos // page
    full = gpages[:n_full]
    res = dict(tokens_card=gt, tokens_cpu=ct,
               first_diverging_step=None if same == len(gt) else same,
               positions_compared=n_pos, pages_compared_scales=len(full))
    diff_bytes = total_bytes = 0
    max_lsb = 0
    for name, g, c in (("k", gpool[0], cpool[0]), ("v", gpool[1], cpool[1])):
        for p in range(n_pos):
            pid, slot = gpages[p // page], p % page
            d = (g[:, :, pid, slot].int() - c[:, :, pid, slot].int()).abs()
            max_lsb = max(max_lsb, int(d.max()))
            diff_bytes += int((d > 0).sum())
            total_bytes += d.numel()
    scale_rel = []
    for g, c in ((gpool[2], cpool[2]), (gpool[3], cpool[3])):
        gs, cs = g[:, :, full], c[:, :, full]
        rel = (gs - cs).abs() / cs.abs().clamp(min=1e-30)
        scale_rel.append(rel.amax(dim=(1, 2)))
    per_layer = torch.stack(scale_rel).amax(dim=0).tolist()
    res.update(payload_max_lsb=max_lsb,
               payload_bytes_differing=diff_bytes,
               payload_bytes_compared=total_bytes,
               payload_share_differing=diff_bytes / total_bytes,
               scale_max_rel_err_by_layer=per_layer, tol=POOL_TOL)
    print(f"quantized pools, card vs CPU: {json.dumps(res)}", flush=True)
    if (max_lsb > POOL_TOL["payload_lsb"]
            or per_layer[0] > POOL_TOL["scale_rel_layer0"]
            or max(per_layer) > POOL_TOL["scale_rel"]):
        fail("quantized pools of the card and the CPU beyond their bound")
    return res


# ---------------------------------------------------------------------------
# phases 6-7: the unified ragged step and speculative decoding
# ---------------------------------------------------------------------------
SPEC_K = 4
# the self-drafted serve: the draft runs the target's own weights, so
# every draft is the target's token unless the draft's one-row steps and
# the verify's window round a near-tie apart
SELF_DRAFT_MIN_ACCEPTANCE = 0.9


def ragged_serve_phase(torch, f32_serve):
    """The serve of `serve_phase` with ``ragged_step=True``, in f32 (K1)
    and with int8 KV pages and weights (K2): every step is one ragged
    step, each launching the kernel once a layer.  A recorded mixed and
    steady-state ragged step against the plain version; one short
    request's greedy tokens against the CPU's split engine; the int8
    pools against the CPU's."""
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools import serve_profile

    out = {}
    for label, quant in (("ragged serve", {}),
                         ("quantized ragged serve",
                          dict(kv_quant="int8", serve_weights="int8"))):
        kname = "paged_attention_q" if quant else "paged_attention"
        model, prompts, new_engine = serve_profile.gpt2_small_serve(
            "cuda", ragged_step=True, **quant)
        cfg = model.cfg
        want = compiles(ragged=1, kv_quant=int(bool(quant)))
        _, st, counts, serve = drive_serve(torch, new_engine, prompts, cfg,
                                           label, want)
        n = counts[kname]
        if st["ragged_steps"] != st["steps"] or \
                n != cfg.num_layers * st["steps"] or n <= 0:
            fail(f"{label}: {kname} launches {n}, ragged steps "
                 f"{st['ragged_steps']}, steps {st['steps']}: want "
                 f"{cfg.num_layers} x steps, every step ragged")
        other = "paged_attention" if quant else "paged_attention_q"
        if counts[other]:
            fail(f"{label}: {other} launched {counts[other]} times")
        serve["tokens_equal_to_split_f32_serve"] = token_share(
            serve["tokens"], f32_serve["tokens"])
        print(f"{label}: " + printable(serve), flush=True)
        if not quant:
            eager_twin(torch, new_engine, prompts, cfg, label, want, serve,
                       kname)
        serve["step_attention_max_abs_err"] = check_recorded_steps(
            torch, model, prompts, label, kinds=("mixed", "ragged"),
            ragged_step=True, **quant)
        cpu_model = GPT.random(cfg, seed=serve_profile.SEED, device="cpu")
        if quant:
            serve["card_vs_cpu"] = quant_pools_card_vs_cpu(
                torch, model, cpu_model, prompts[1][:64], ragged_step=True)
        else:
            greedy_card_vs_cpu(model, cpu_model, prompts[1][:64], label,
                               dict(ragged_step=True))
        serve["launches_of_path"] = n
        out["int8" if quant else "f32"] = serve
    return out


def spec_serve_phase(torch, f32_serve):
    """The serve of `serve_phase` with ``spec_decode_k=4``: prompt lookup
    on the ragged and the split path, GPT-2-small drafting for itself
    (acceptance at least `SELF_DRAFT_MIN_ACCEPTANCE`) and a
    ``draft_config()`` draft with random weights (acceptance printed).  K1
    launches exactly num_layers x (mixed steps + verify rounds) for the
    target and draft layers x draft steps for the draft model.  A
    recorded verify step against the plain version; one short request's
    greedy tokens, spec engines against the CPU's non-spec engine."""
    from paddle_tpu_torch.inference.speculative import DraftModelDrafter
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools import serve_profile

    out = {}
    for name, kw, want_compiles in (
            ("prompt_lookup_ragged", dict(ragged_step=True),
             compiles(ragged=1)),
            ("prompt_lookup_split", {}, compiles(mixed=1, verify=1)),
            # the draft's chunk ingest, catch-up and single-token step
            ("self_split", dict(drafter="self"),
             compiles(mixed=1, verify=1, draft=3)),
            ("draft_model_ragged", dict(ragged_step=True,
                                        drafter="draft_model"),
             compiles(ragged=1, draft=3))):
        label = f"spec serve {name}"
        model, prompts, new_engine = serve_profile.gpt2_small_serve(
            "cuda", spec_decode_k=SPEC_K, **kw)
        cfg = model.cfg
        eng, st, counts, serve = drive_serve(torch, new_engine, prompts,
                                             cfg, label, want_compiles)
        drafter = eng._spec.drafter
        draft_layers = draft_steps = 0
        if isinstance(drafter, DraftModelDrafter):
            draft_layers = len(drafter._params["blocks"])
            draft_steps = drafter.steps
        want = cfg.num_layers * (st["mixed_steps"] + st["spec_steps"]) + \
            draft_layers * draft_steps
        n = counts["paged_attention"]
        if n != want or st["spec_steps"] <= 0:
            fail(f"{label}: K1 launches {n} != {cfg.num_layers} x "
                 f"({st['mixed_steps']} mixed + {st['spec_steps']} verify) "
                 f"+ {draft_layers} x {draft_steps} draft steps")
        if kw.get("ragged_step") and \
                st["ragged_steps"] != st["mixed_steps"] + st["spec_steps"]:
            fail(f"{label}: a step went around the ragged step")
        serve.update(draft_layers=draft_layers, draft_steps=draft_steps,
                     launches_of_path=n,
                     tokens_equal_to_split_f32_serve=token_share(
                         serve["tokens"], f32_serve["tokens"]))
        print(f"{label}: " + printable(serve), flush=True)
        if name == "prompt_lookup_split":
            eager_twin(torch, new_engine, prompts, cfg, label,
                       want_compiles, serve, "paged_attention")
        if name == "self_split" and \
                st["acceptance_rate"] < SELF_DRAFT_MIN_ACCEPTANCE:
            fail(f"{label}: acceptance_rate {st['acceptance_rate']} < "
                 f"{SELF_DRAFT_MIN_ACCEPTANCE}")
        out[name] = serve
    cpu_model = GPT.random(cfg, seed=serve_profile.SEED, device="cpu")
    out["prompt_lookup_split"]["step_attention_max_abs_err"] = \
        check_recorded_steps(torch, model, prompts, "spec serve",
                             kinds=("mixed", "verify"), max_new=8,
                             spec_decode_k=SPEC_K)
    for ragged in (False, True):
        greedy_card_vs_cpu(model, cpu_model, prompts[1][:64],
                           f"spec serve {'ragged' if ragged else 'split'}",
                           dict(spec_decode_k=SPEC_K, ragged_step=ragged))
    return out


def legacy_serve_phase(torch, f32_serve):
    """The serve of `serve_phase` with ``chunked_prefill=False``, in f32
    (K1) and with int8 KV pages and weights (K2): each prompt one legacy
    prefill pass between steps (one graph a bucket), every step a decode
    step launching the kernel once a layer; one short request's greedy
    tokens against the CPU's legacy engine (f32), its int8 pools against
    the CPU's (int8)."""
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools import serve_profile

    out = {}
    for label, quant in (("legacy serve", {}),
                         ("quantized legacy serve",
                          dict(kv_quant="int8", serve_weights="int8"))):
        kname = "paged_attention_q" if quant else "paged_attention"
        model, prompts, new_engine = serve_profile.gpt2_small_serve(
            "cuda", chunked_prefill=False, **quant)
        cfg = model.cfg
        buckets = {new_engine()._prefill_bucket(len(p)) for p in prompts}
        want = compiles(decode=1, prefill=len(buckets),
                        kv_quant=int(bool(quant)))
        _, st, counts, serve = drive_serve(torch, new_engine, prompts, cfg,
                                           label, want)
        n = counts[kname]
        if st["mixed_steps"] or n <= 0 or n != cfg.num_layers * st["steps"]:
            fail(f"{label}: {kname} launches {n}, steps {st['steps']}, mixed "
                 f"steps {st['mixed_steps']}: want {cfg.num_layers} x decode "
                 f"steps and no mixed step")
        if serve["prefills"] != len(prompts):
            fail(f"{label}: {serve['prefills']} prefills of {len(prompts)} "
                 f"prompts")
        serve.update(launches_of_path=n, prefill_buckets=sorted(buckets),
                     tokens_equal_to_split_f32_serve=token_share(
                         serve["tokens"], f32_serve["tokens"]))
        print(f"{label}: " + printable(serve), flush=True)
        cpu_model = GPT.random(cfg, seed=serve_profile.SEED, device="cpu")
        legacy = dict(chunked_prefill=False)
        if quant:
            serve["card_vs_cpu"] = quant_pools_card_vs_cpu(
                torch, model, cpu_model, prompts[1][:64], **legacy)
        else:
            greedy_card_vs_cpu(model, cpu_model, prompts[1][:64], label,
                               legacy, cpu_kw=legacy)
        out["int8" if quant else "f32"] = serve
    return out


# ---------------------------------------------------------------------------
# phase 8: K3/K4 against their plain versions
# ---------------------------------------------------------------------------
def flash_build_report(_build):
    """Registers, local (stack and spill) bytes and shared memory of every
    flash kernel a launch can run, as the CUDA runtime reports them."""
    query = _build.load("flash_attention").flash_attention_kernel_attrs
    query.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    rows = []
    for dtype, dname in enumerate(("float32", "bfloat16")):
        for d in (64, 128):
            for which, kern in enumerate(FLASH_KERNELS):
                attrs = (ctypes.c_int * 4)()
                err = query(which, d, dtype, attrs)
                if err:
                    fail(f"cudaFuncGetAttributes of flash {kern} {dname} "
                         f"D={d}: CUDA error {err}")
                rows.append(dict(kernel=f"flash {kern}", dtype=dname,
                                 head_dim=d,
                                 registers=attrs[0], local_bytes=attrs[1],
                                 static_smem_bytes=attrs[2],
                                 dynamic_smem_bytes=attrs[3]))
    return rows


PAGED_PATHS = ("simt_1row", "simt_8rows", "tensor_cores")


def paged_build_report(_build):
    """Registers, local (stack and spill) bytes and shared memory of every
    K1/K2 kernel instantiation, as the CUDA runtime reports them."""
    query = _build.load("paged_attention").paged_attention_kernel_attrs
    query.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    rows = []
    for quant, kern in ((0, "K1"), (1, "K2")):
        for dtype, dname in enumerate(("float32", "bfloat16")):
            for d in (64, 128):
                for path, pname in enumerate(PAGED_PATHS):
                    attrs = (ctypes.c_int * 4)()
                    err = query(path, d, dtype, quant, attrs)
                    if err:
                        fail(f"cudaFuncGetAttributes of {kern} {pname} "
                             f"{dname} D={d}: CUDA error {err}")
                    rows.append(dict(kernel=f"{kern} {pname}", dtype=dname,
                                     head_dim=d, registers=attrs[0],
                                     local_bytes=attrs[1],
                                     static_smem_bytes=attrs[2],
                                     dynamic_smem_bytes=attrs[3]))
    return rows


def flash_work(torch, case, dtype, kernel):
    """Bound of one K3/K4 kernel: bytes = its inputs read once and its
    outputs written once; flops = 2 * D per visible (query, key) pair for
    each of its products (forward 2, dkv 4, dq 3).  Returns ``(bound_ms,
    bound_by, flops)``."""
    item = torch.empty((), dtype=dtype).element_size()
    bh, s, d = case["B"] * case["H"], case["S"], case["D"]
    rows = bh * s * d * item  # one [B, H, S, D] tensor
    nbytes = {"fwd": 4 * rows + 4 * bh * s,              # q k v -> out lse
              "dkv": 7 * rows + 4 * bh * s,              # q k v o do lse -> dk dv
              "dq": 6 * rows + 4 * bh * s}[kernel]       # ... -> dq
    pairs = bh * (s * (s + 1) // 2 if case["causal"] else s * s)
    flops = FLASH_KERNELS[kernel][1] * 2 * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops)


def flash_backward_deterministic(torch, fa, q, k, v, o, lse, do, causal):
    """Two launches of K4 (dkv and dq) on the same inputs: bitwise-equal
    dq, dk and dv (every gradient tile has one writer)."""
    runs = [(fa.flash_attention_cuda_dq(q, k, v, o, lse, do, causal),
             *fa.flash_attention_cuda_dkv(q, k, v, o, lse, do, causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(*runs))


def flash_errors(torch, fa, q, k, v, do, causal):
    """Max abs errors of K3 (out, lse) and K4 (dq, dk, dv) against the
    plain versions; both backwards take the plain forward's out and lse,
    so every kernel sees the same inputs as its plain version.  Returns
    ``(errors, plain out, plain lse)``."""
    b, h, s, _ = q.shape
    out, lse = fa.flash_attention_cuda_fwd(q, k, v, causal)
    ref, ref_lse = fa._composed_attention(q, k, v, None, causal, None,
                                          want_lse=True)
    ref_lse = ref_lse.reshape(b * h, s)
    dk, dv = fa.flash_attention_cuda_dkv(q, k, v, ref, ref_lse, do, causal)
    dq = fa.flash_attention_cuda_dq(q, k, v, ref, ref_lse, do, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, ref, ref_lse, do,
                                            causal, None)
    torch.cuda.synchronize()
    got = dict(out=(out, ref), lse=(lse, ref_lse), dq=(dq, want[0]),
               dk=(dk, want[1]), dv=(dv, want[2]))
    errs = {}
    for name, (a, r) in got.items():
        if not torch.isfinite(a.float()).all():
            fail(f"K3/K4: non-finite {name}")
        errs[name] = (a.float() - r.float()).abs().max().item()
    return errs, ref, ref_lse


def flash_phase(torch):
    from paddle_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [
        dict(name="train", B=16, H=12, S=1024, D=64, causal=True,
             dtypes=("float32", "bfloat16")),
        dict(name="full", B=16, H=12, S=1024, D=64, causal=False,
             dtypes=("float32", "bfloat16")),
        dict(name="ragged", B=16, H=12, S=1000, D=64, causal=True,
             dtypes=("float32", "bfloat16")),
        dict(name="d128", B=2, H=16, S=2048, D=128, causal=True,
             dtypes=("bfloat16",)),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for case in cases:
        shape = (case["B"], case["H"], case["S"], case["D"])
        c = case["causal"]
        for dname in case["dtypes"]:
            dtype = getattr(torch, dname)
            q, k, v, do = (torch.randn(*shape, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            errs, o, lse = flash_errors(torch, fa, q, k, v, do, c)
            tol = FLASH_TOL[dname]
            ms = dict(
                fwd=time_ms(torch, lambda: fa.flash_attention_cuda_fwd(
                    q, k, v, c)),
                dkv=time_ms(torch, lambda: fa.flash_attention_cuda_dkv(
                    q, k, v, o, lse, do, c)),
                dq=time_ms(torch, lambda: fa.flash_attention_cuda_dq(
                    q, k, v, o, lse, do, c)))
            plain_fwd = time_ms(torch, lambda: fa._composed_attention(
                q, k, v, None, c, None, want_lse=True), reps=10)
            plain_bwd = time_ms(torch, lambda: fa.flash_attention_bwd_reference(
                q, k, v, o, lse, do, c, None), reps=10)
            # library yardstick: SDPA forward, and its autograd backward
            # as (forward + backward) - forward; the port never calls it
            qg, kg, vg = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            lib_fwd = time_ms(torch, lambda: sdpa(q, k, v, is_causal=c))
            lib_both = time_ms(torch, lambda: torch.autograd.grad(
                sdpa(qg, kg, vg, is_causal=c), (qg, kg, vg), do))
            row = dict(case=case["name"], dtype=dname, causal=c,
                       shape=dict(zip("BHSD", shape)), max_abs_err=errs,
                       tol=tol, kernels={})
            yardstick = case["name"] == "train" and dname == "bfloat16"
            for kern, (_, _, outs) in FLASH_KERNELS.items():
                bound_ms, bound_by, flops = flash_work(torch, case, dtype,
                                                       kern)
                row["kernels"][kern] = dict(
                    ms=ms[kern], max_abs_err=max(errs[n] for n in outs),
                    plain_ms=plain_fwd if kern == "fwd" else plain_bwd,
                    library_ms=(lib_fwd if kern == "fwd"
                                else lib_both - lib_fwd),
                    bound_ms=bound_ms, bound_by=bound_by,
                    tflops=flops / ms[kern] * 1e-9,
                    bound_share=bound_ms / ms[kern])
            if case["name"] == "train":
                row["backward_bitwise_deterministic"] = \
                    flash_backward_deterministic(torch, fa, q, k, v, o, lse,
                                                 do, c)
            results.append(row)
            print(f"kernel K3/K4 {case['name']:>6} {dname:>8}: max_abs_err "
                  + " ".join(f"{n} {e:.3g}" for n, e in errs.items())
                  + " | ms " + " ".join(
                      f"{n} {r['ms']:.4f} (bound {r['bound_ms']:.4f}, "
                      f"{r['tflops']:.1f} TFLOP/s, {r['bound_share']:.1%}"
                      + (f", SIMT kernel's earlier time {FLASH_SIMT_MS[n]}"
                         if yardstick else "")
                      + ")" for n, r in row["kernels"].items())
                  + f" | plain fwd {plain_fwd:.4f} bwd {plain_bwd:.4f}"
                  f" | library fwd {lib_fwd:.4f} bwd "
                  f"{lib_both - lib_fwd:.4f}", flush=True)
            bad = [n for n, e in errs.items() if not e <= tol[n]]
            if bad:
                fail(f"K3/K4 {case['name']} {dname}: {bad} beyond {tol}")
            if row.get("backward_bitwise_deterministic") is False:
                fail(f"K4 {case['name']} {dname}: two launches differ")
    return results


# ---------------------------------------------------------------------------
# phase 9: train GPT-2-small
# ---------------------------------------------------------------------------
class FlashRecorder:
    """Records q, k, v, the output and (through a hook on the output)
    the output's gradient of the first call of the train path's
    attention, passing every call through unchanged."""

    def __init__(self, module):
        self.module = module
        self.inner = module.flash_attention_fwd
        self.call = None

    def __call__(self, q, k, v, mask=None, is_causal=False, scale=None):
        out = self.inner(q, k, v, mask, is_causal, scale)
        if self.call is None:
            self.call = dict(args=[t.detach().contiguous().clone()
                                   for t in (q, k, v)],
                             causal=is_causal, out=out.detach().clone())
            out.register_hook(lambda g: self.call.__setitem__(
                "dout", g.detach().contiguous().clone()))
        return out

    def __enter__(self):
        self.module.flash_attention_fwd = self
        return self

    def __exit__(self, *exc):
        self.module.flash_attention_fwd = self.inner


def train_phase(torch):
    import math

    from paddle_tpu_torch.nn.functional import attention as attn_mod
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.tools import train_profile as tp

    torch.cuda.reset_peak_memory_stats()
    model, step, tokens, labels, warm = tp.gpt2_small_train("cuda")
    cfg = model.cfg
    reset_counts()
    t0 = time.perf_counter()
    losses = [step(tokens, labels) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = warm + [float(x) for x in losses]
    ntok = tokens.numel() * TRAIN_STEPS
    train = dict(batch=list(tokens.shape), warmup_steps=len(warm),
                 steps=TRAIN_STEPS, wall_s=wall, tokens_per_s=ntok / wall,
                 mean_step_ms=wall / TRAIN_STEPS * 1e3, losses=losses,
                 launches=counts, peak_memory_bytes=peak)
    print("train: " + json.dumps(train), flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite train loss: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        fail(f"first loss {losses[0]} not within 0.5 of "
             f"ln({cfg.vocab_size})")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall on a fixed batch: {losses}")
    want = cfg.num_layers * TRAIN_STEPS
    if any(counts[k] != want for k in FLASH_KERNELS):
        fail(f"K3/K4 launches {counts} != num_layers x steps = {want}")

    # one layer's attention on the path, recorded during a real step,
    # against the plain versions on the same inputs
    with FlashRecorder(attn_mod) as rec:
        step(tokens, labels)
    torch.cuda.synchronize()
    if rec.call is None or "dout" not in rec.call:
        fail("no train-path attention recorded")
    q, k, v = rec.call["args"]
    if q.dtype != torch.bfloat16:
        fail(f"train-path attention ran in {q.dtype}, not bfloat16 under AMP")
    errs, ref, _ = flash_errors(torch, fa, q, k, v, rec.call["dout"],
                                rec.call["causal"])
    errs["path_out"] = (rec.call["out"].float() - ref.float()).abs().max(
        ).item()
    tol = dict(FLASH_TOL["bfloat16"], path_out=FLASH_TOL["bfloat16"]["out"])
    print(f"train-path attention vs plain: {errs} (tol {tol})", flush=True)
    bad = [n for n, e in errs.items() if not e <= tol[n]]
    if bad:
        fail(f"train-path attention disagrees with the plain version: {bad}")
    train["step_attention_max_abs_err"] = errs
    train["card_vs_cpu"] = card_vs_cpu(torch, fa)
    return train


# card against CPU: losses within f32 1e-4 / bf16 2e-2 (bf16 rounds the
# activations at ~2**-8); parameters within 10 * lr at most (Adam moves
# each parameter about lr a step, so a near-zero gradient whose sign the
# two devices round apart moves it up to 2 * lr apart a step) and within
# f32 1e-6 / bf16 1e-5 on average over every parameter
CARD_CPU_TOL = {"float32": dict(loss=1e-4, param_mean=1e-6),
                "bf16_amp": dict(loss=2e-2, param_mean=1e-5)}


def card_vs_cpu(torch, fa):
    import numpy as np

    from paddle_tpu_torch.inference.weights import params_to_numpy
    from paddle_tpu_torch.jit import train_step
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.tools.train_profile import amp_loss_fn

    lr = 1e-4
    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_heads=4, max_seq_len=256, use_parallel_layers=False)
    rng = np.random.default_rng(SEED)
    batch = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256))
                              .astype(np.int32)) for _ in range(2)]
    out = {}
    for mode, loss_fn in (("float32", gpt_loss_fn),
                          ("bf16_amp", amp_loss_fn)):
        runs = {}
        for dev in ("cuda", "cpu"):
            model = GPT.random(cfg, seed=SEED, device=dev)
            step = train_step(model, loss_fn, AdamW(
                learning_rate=lr, parameters=model.parameters(),
                weight_decay=0.01))
            n0 = fa.flash_attention_cuda_fwd.launches
            losses = [float(step(*(t.to(dev) for t in batch)))
                      for _ in range(3)]
            runs[dev] = (losses, params_to_numpy(model.params()),
                         fa.flash_attention_cuda_fwd.launches - n0)
        (gl, gp, gn), (cl, cp, cn) = runs["cuda"], runs["cpu"]
        if gn != 3 * cfg.num_layers or cn != 0:
            fail(f"card vs CPU {mode}: K3 launched {gn} times on the card "
                 f"and {cn} on the CPU")
        diffs = [np.abs(a - b) for a, b in zip(_leaves(gp), _leaves(cp))]
        res = dict(losses_card=gl, losses_cpu=cl,
                   loss_max_abs_err=max(abs(a - b) for a, b in zip(gl, cl)),
                   param_max_abs_err=max(float(d.max()) for d in diffs),
                   param_mean_abs_err=float(np.concatenate(
                       [d.ravel() for d in diffs]).mean()),
                   tol=dict(CARD_CPU_TOL[mode], param_max=10 * lr))
        print(f"card vs CPU {mode}: {json.dumps(res)}", flush=True)
        tol = res["tol"]
        if not (res["loss_max_abs_err"] <= tol["loss"]
                and res["param_max_abs_err"] <= tol["param_max"]
                and res["param_mean_abs_err"] <= tol["param_mean"]):
            fail(f"card vs CPU {mode}: beyond tolerance")
        out[mode] = res
    return out


def _leaves(tree):
    flat = [tree[k] for k in sorted(tree) if k != "blocks"]
    for blk in tree["blocks"]:
        flat += [blk[k] for k in sorted(blk)]
    return flat


# ---------------------------------------------------------------------------
# phases 10-11: K5 against its plain version, and the train with K5
# ---------------------------------------------------------------------------
def ln_phase(torch):
    """K5 against `layer_norm` at the train path's shape ([16 * 1024,
    768], f32 and bf16) and one wider row (d = 4096), timed with the plain
    version and ``torch.nn.functional.layer_norm``."""
    from paddle_tpu_torch.ops.layer_norm import layer_norm, layer_norm_cuda

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    eps = 1e-5
    results = []
    for name, rows, d in (("train", 16 * 1024, 768), ("wide", 4096, 4096)):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = (torch.randn(rows, d, generator=gen, device="cuda") * 2
                 + 0.5).to(dtype)
            w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
            b = 0.1 * torch.randn(d, generator=gen, device="cuda")
            out = layer_norm_cuda(x, w, b, eps)
            ref = layer_norm(x, w, b, eps)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                fail(f"K5 {name} {dname}: non-finite output")
            diff = (out.float() - ref.float()).abs()
            tol = LN_TOL[dname]
            excess = (diff - tol["abs"] - tol["rel"] * ref.float().abs())
            err = diff.max().item()
            ok = excess.max().item() <= 0
            ms = time_ms(torch, lambda: layer_norm_cuda(x, w, b, eps))
            plain_ms = time_ms(torch, lambda: layer_norm(x, w, b, eps))
            wl, bl = w.to(dtype), b.to(dtype)
            library_ms = time_ms(torch, lambda: torch.nn.functional.layer_norm(
                x, (d,), wl, bl, eps))
            # one read of x, one write of y, w and b once; ~8 flops an
            # element at the f32 rate
            nbytes = 2 * x.numel() * x.element_size() + 2 * d * 4
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = 8 * x.numel() / PEAK_FLOPS["float32"]
            row = dict(case=name, dtype=dname, shape=[rows, d],
                       max_abs_err=err, tol=tol, ok=ok, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations")
            results.append(row)
            print(f"kernel K5 {name:>5} {dname:>8} [{rows}, {d}]: "
                  f"max_abs_err {err:.3g} ms {ms:.4f} plain_ms "
                  f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
                  f"{row['bound_ms']:.4f}", flush=True)
            if not ok:
                fail(f"K5 {name} {dname}: beyond tolerance {tol} "
                     f"(max_abs_err {err})")
    return results


def ln_train_phase(torch, train):
    """The train of `train_phase` with ``FLAGS_use_pallas_layernorm`` on:
    every LayerNorm forward runs K5, which launches once per LayerNorm
    module per step; K3/K4 as before; the first loss against the flag-off
    train's on the same weights and batch."""
    import math

    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.nn.layer import LayerNorm
    from paddle_tpu_torch.ops import layer_norm as ln
    from paddle_tpu_torch.tools import train_profile as tp

    seen = []
    inner = ln.layer_norm_cuda

    def record(x2d, w, b, eps):  # what the path hands K5, warm-up steps
        seen.append((tuple(x2d.shape), str(x2d.dtype).split(".")[-1]))
        return inner(x2d, w, b, eps)

    flags.set_flags({"use_pallas_layernorm": True})
    ln.layer_norm_cuda = record
    try:
        torch.cuda.reset_peak_memory_stats()
        model, step, tokens, labels, warm = tp.gpt2_small_train("cuda")
        ln.layer_norm_cuda = inner
        cfg = model.cfg
        n_ln = sum(isinstance(m, LayerNorm) for m in model.modules())
        reset_counts()
        t0 = time.perf_counter()
        losses = [step(tokens, labels) for _ in range(LN_TRAIN_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        ln.layer_norm_cuda = inner
        flags.set_flags({"use_pallas_layernorm": False})
    peak = torch.cuda.max_memory_allocated()
    losses = warm + [float(x) for x in losses]
    ntok = tokens.numel() * LN_TRAIN_STEPS
    res = dict(batch=list(tokens.shape), warmup_steps=len(warm),
               steps=LN_TRAIN_STEPS, wall_s=wall, tokens_per_s=ntok / wall,
               mean_step_ms=wall / LN_TRAIN_STEPS * 1e3, losses=losses,
               layer_norm_modules=n_ln, k5_inputs=sorted(set(seen)),
               launches=counts, peak_memory_bytes=peak,
               first_loss_vs_flag_off=abs(losses[0] - train["losses"][0]),
               first_loss_tol=LN_TRAIN_LOSS_TOL)
    res["vs_flag_off"] = {k: res[k] / train[k] for k in (
        "tokens_per_s", "mean_step_ms", "peak_memory_bytes")}
    print("train with K5: " + json.dumps(res), flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite K5 train loss: {losses}")
    # ln1 and ln2 of every block and ln_f
    if n_ln != 2 * cfg.num_layers + 1:
        fail(f"{n_ln} LayerNorm modules, not 2 x {cfg.num_layers} + 1")
    if len(seen) != n_ln * len(warm):
        fail(f"K5 called {len(seen)} times in {len(warm)} warm-up steps")
    if counts["layer_norm"] != n_ln * LN_TRAIN_STEPS:
        fail(f"K5 launches {counts['layer_norm']} != {n_ln} x "
             f"{LN_TRAIN_STEPS}")
    want = cfg.num_layers * LN_TRAIN_STEPS
    if any(counts[k] != want for k in FLASH_KERNELS):
        fail(f"K3/K4 launches {counts} != num_layers x steps = {want}")
    if not res["first_loss_vs_flag_off"] <= LN_TRAIN_LOSS_TOL:
        fail(f"first loss with K5 {losses[0]} vs {train['losses'][0]} "
             f"without")
    return res


# ---------------------------------------------------------------------------
# 13. the serving stack around the engine: frontend, containment,
# recovery, durability, watchdog
# ---------------------------------------------------------------------------
# the containment serve's fault plan; {poison} is a token of one prompt
# alone (the JAX package's grammar, at its default ladder flags:
# step_retries=2, degrade_after=3)
FAULT_PLAN = ("step@3,7;pool@2;host_callback@5;mixed_step@9,10,11;"
              "poison@{poison}")
# the durability children: a journaled serve killed with SIGKILL after
# engine step KILL_STEP (a snapshot every SNAPSHOT_STEPS steps), restored
# by a fresh process
KILL_STEP = 50
SNAPSHOT_STEPS = 4
JOURNAL_ROOT = Path("build") / "chip_smoke_journal"
# the watchdog phase: a step budget far above a replayed step's few ms
# and a capture's tens, and a stall far above the budget
STEP_TIMEOUT_MS = 1000.0
SLOW_MS = 3000.0
# the slow_step consult that stalls: the warm-up request's 4 steps, then
# the 8th step of the serve
SLOW_AT = 12


def retrace_counts(stats):
    return {k: v for k, v in stats.items()
            if k.endswith("_retraces") or k == "retraces_after_warmup"}


def stream_serve(torch, eng, prompts, warm=None, **frontend_kw):
    """Serve ``prompts`` through `ServingFrontend` over ``eng`` (steps in
    its worker thread), every `TokenStream` consumed concurrently:
    ``(streams, tokens, ttft_s, tpot_s, wall_s)``, TTFT and TPOT read from
    each stream's token arrival times.  ``warm`` (a prompt) is served to
    its end first, outside the timing."""
    import asyncio

    from paddle_tpu_torch.inference.frontend import ServingFrontend
    from paddle_tpu_torch.tools import serve_profile

    async def consume(fe, prompt):
        t_sub = time.perf_counter()
        stream = await fe.submit(prompt,
                                 max_new_tokens=serve_profile.NEW_TOKENS)
        toks, times = [], []
        async for tok in stream:
            times.append(time.perf_counter())
            toks.append(tok)
        return stream, toks, times, t_sub

    async def go():
        async with ServingFrontend(eng, **frontend_kw) as fe:
            if warm is not None:
                await (await fe.submit(warm, max_new_tokens=4)).collect()
            t0 = time.perf_counter()
            res = await asyncio.gather(*[consume(fe, p) for p in prompts])
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        return fe, res, wall

    fe, res, wall = asyncio.run(go())
    ttft = [times[0] - t_sub for _, _, times, t_sub in res]
    tpot = [(times[-1] - times[0]) / (len(times) - 1)
            for _, _, times, _ in res if len(times) > 1]
    return fe, [r[0] for r in res], [r[1] for r in res], ttft, tpot, wall


def quantile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def frontend_check(torch, new_engine, prompts, cfg, want_tokens):
    """(a) The set through `ServingFrontend` under FIFO and SLO, 3 serves
    each, beside `engine.run`'s 3 in the same call."""
    from paddle_tpu_torch.inference import serving

    out = {}
    rates = []
    for _ in range(SERVE_RUNS):
        eng, reqs, wall = serve_once(torch, new_engine, prompts)
        rates.append(sum(len(r.generated_ids) for r in reqs) / wall)
    out["engine_run"] = dict(tokens_per_s_runs=rates,
                             tokens_per_s_median=statistics.median(rates))
    for policy in ("fifo", "slo"):
        rates, ttft, tpot = [], [], []
        for run in range(SERVE_RUNS):
            eng = new_engine(scheduler=policy)
            serving.reset_decode_stats()
            reset_counts()
            before = ladder_counts()
            fe, streams, toks, t1, t2, wall = stream_serve(torch, eng,
                                                           prompts)
            counts = read_counts()
            st, pst = eng.decode_stats(), serving.decode_stats()
            if fe.engine is not eng or fe._recoveries:
                fail(f"frontend {policy}: the engine was rebuilt")
            check_unfaulted(f"frontend {policy}", before, [eng])
            if toks != want_tokens:
                fail(f"frontend {policy}: streamed tokens differ from "
                     f"engine.run's")
            if [s.generated_ids for s in streams] != want_tokens or any(
                    s.finish_reason != "length" for s in streams):
                fail(f"frontend {policy}: requests did not finish with "
                     f"engine.run's tokens")
            if counts["paged_attention"] != cfg.num_layers * st["steps"]:
                fail(f"frontend {policy}: K1 launches "
                     f"{counts['paged_attention']} != num_layers x steps "
                     f"({st['steps']})")
            if any(retrace_counts(pst).values()):
                fail(f"frontend {policy}: a step retraced: "
                     f"{retrace_counts(pst)}")
            compiled = {k: pst[k] for k in COMPILE_KEYS if pst[k]}
            if compiled != dict(mixed_compiles=1, decode_compiles=1) or \
                    eng.graph_captures() != 2:
                fail(f"frontend {policy}: compiles {compiled}, "
                     f"{eng.graph_captures()} graphs (want one mixed and "
                     f"one decode graph)")
            rates.append(st["tokens"] / wall)
            ttft += t1
            tpot += t2
        out[policy] = dict(
            tokens_per_s_runs=rates,
            tokens_per_s_median=statistics.median(rates),
            tokens_per_s_spread=(max(rates) - min(rates))
            / statistics.median(rates),
            ttft_p50_s=quantile(ttft, 0.5), ttft_p95_s=quantile(ttft, 0.95),
            tpot_p50_s=quantile(tpot, 0.5), tpot_p95_s=quantile(tpot, 0.95),
            k1_launches=counts["paged_attention"], steps=st["steps"])
        print(f"frontend {policy}: tokens/s median "
              f"{out[policy]['tokens_per_s_median']:.1f} (spread "
              f"{out[policy]['tokens_per_s_spread']:.1%}) against "
              f"engine.run {out['engine_run']['tokens_per_s_median']:.1f}; "
              f"TTFT p50 {out[policy]['ttft_p50_s'] * 1e3:.1f} ms, p95 "
              f"{out[policy]['ttft_p95_s'] * 1e3:.1f} ms; TPOT p50 "
              f"{out[policy]['tpot_p50_s'] * 1e3:.2f} ms, p95 "
              f"{out[policy]['tpot_p95_s'] * 1e3:.2f} ms; tokens equal, "
              f"K1 {counts['paged_attention']} = {cfg.num_layers} x "
              f"{st['steps']}",
              flush=True)
    return out


def poison_token(prompts, i, generated):
    """A token of prompt ``i`` that no other prompt holds and no request
    generates (a preempted request's replay prompt holds its tokens)."""
    others = set(t for j, p in enumerate(prompts) if j != i for t in p)
    others.update(t for g in generated for t in g)
    return next(t for t in prompts[i] if t not in others)


def containment_check(torch, new_engine, prompts, want_tokens):
    """(b) The set under `FAULT_PLAN`: the poisoned request alone
    finishes "fault", the others with the clean serve's tokens; the
    mixed-step faults degrade to the legacy prefill; retries replay the
    captured graphs."""
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.inference.errors import StepFault

    victim = 5
    plan = FAULT_PLAN.format(poison=poison_token(prompts, victim,
                                                 want_tokens))
    serving.reset_decode_stats()
    eng = new_engine(fault_plan=plan)
    streamed = [[] for _ in prompts]
    reqs = [eng.add_request(p, max_new_tokens=len(want_tokens[0]),
                            on_token=streamed[i].append)
            for i, p in enumerate(prompts)]
    try:
        eng.run()
    except StepFault as e:
        fail(f"containment: a fault escaped the ladder: {e!r}")
    torch.cuda.synchronize()
    pst = serving.decode_stats()
    bad = reqs[victim]
    if bad.finish_reason != "fault" or bad.fault_info is None or \
            bad.fault_info.recovered:
        fail(f"containment: the poisoned request finished "
             f"{bad.finish_reason!r} with {bad.fault_info}")
    for i, r in enumerate(reqs):
        if i != victim and (r.finish_reason != "length"
                            or r.generated_ids != want_tokens[i]):
            fail(f"containment: request {i} finished {r.finish_reason!r}, "
                 f"tokens equal to the clean serve's: "
                 f"{r.generated_ids == want_tokens[i]}")
    dropped = [i for i, r in enumerate(reqs) if r.fault_info is not None
               and r.fault_info.site == "host_callback"]
    if len(dropped) != 1 or streamed[dropped[0]] != \
            reqs[dropped[0]].generated_ids[:len(streamed[dropped[0]])]:
        fail(f"containment: host_callback fault not contained: {dropped}")
    if pst["legacy_fallbacks"] < 1 or pst["prefill_compiles"] < 1:
        fail("containment: the mixed-step faults did not fall back to the "
             "legacy prefill")
    if any(retrace_counts(pst).values()):
        fail(f"containment: a retried step retraced: "
             f"{retrace_counts(pst)}")
    graphs = eng.graph_captures()
    compiled = sum(pst[k] for k in COMPILE_KEYS)
    if graphs != compiled:
        fail(f"containment: {graphs} graphs for {compiled} compiles")
    # every scheduled fault fired once, the poison at least once, and the
    # ladder took those and nothing else
    fired, sched = eng._fault.fired, eng._fault.schedule
    contained = {f"{name}{' (injected)' if inj else ''}": n
                 for (name, inj), n in eng._resilience.contained.items()}
    if any(fired.get(site, 0) != len(occ) for site, occ in sched.items()) \
            or fired.get("poison", 0) < 1 \
            or pst["faults_injected"] != sum(fired.values()):
        fail(f"containment: faults fired {fired} for the schedule "
             f"{ {k: sorted(v) for k, v in sched.items()} }, "
             f"faults_injected {pst['faults_injected']}")
    if any(not inj for _, inj in eng._resilience.contained):
        fail(f"containment: the ladder contained a fault the plan did not "
             f"inject: {contained}")
    keys = ("faults_injected", "step_retries", "finished_fault",
            "preemptions", "resumes", "legacy_fallbacks", "recoveries",
            "prefill_compiles", "mixed_compiles", "decode_compiles")
    out = {k: pst[k] for k in keys}
    out.update(poisoned_request=victim, fault_info=bad.fault_info.as_dict(),
               callback_dropped_request=dropped[0], graphs=graphs,
               plan=plan, fired=dict(fired), contained=contained)
    print(f"containment: {plan}: request {victim} quarantined "
          f"({bad.fault_info.site}, {bad.fault_info.attempts} attempts), "
          f"the other 15 with the clean tokens; faults fired "
          f"{json.dumps(fired)}, contained {json.dumps(contained)}; "
          f"counters {json.dumps({k: pst[k] for k in keys})}", flush=True)
    return out


def recovery_check(torch, new_engine, prompts, want_tokens, pool_bytes):
    """(c) `recover` twice mid-serve, with handoff, then cold."""
    import gc

    from paddle_tpu_torch.inference import resilience, serving

    before = ladder_counts()
    eng = new_engine()
    engines = [eng]
    reqs = [eng.add_request(p, max_new_tokens=len(want_tokens[0]))
            for p in prompts]
    # run until both step kinds have their graph
    while not (eng._decode_fn is not None and eng._decode_fn.captures
               and eng._mixed_fn is not None and eng._mixed_fn.captures):
        eng.step()
    torch.cuda.synchronize()
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    graphs0 = eng.graph_captures()
    compiled0 = {k: serving.decode_stats()[k] for k in COMPILE_KEYS}
    seconds = {}
    t0 = time.perf_counter()
    eng = resilience.recover(eng, handoff=True)
    seconds["handoff_recover_s"] = time.perf_counter() - t0
    engines.append(eng)
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    seconds["handoff_first_step_s"] = time.perf_counter() - t0
    for _ in range(20):
        eng.step()
    compiled1 = {k: serving.decode_stats()[k] for k in COMPILE_KEYS}
    if eng.graph_captures() != graphs0 or compiled1 != compiled0:
        fail(f"recovery: the handoff recovery captured graphs: "
             f"{eng.graph_captures()} against {graphs0}, compiles "
             f"{compiled1} against {compiled0}")
    t0 = time.perf_counter()
    eng = resilience.recover(eng, handoff=False)
    seconds["cold_recover_s"] = time.perf_counter() - t0
    engines.append(eng)
    torch.cuda.synchronize()
    gc.collect()
    mem2 = torch.cuda.memory_allocated()
    if abs(mem2 - mem0) > pool_bytes:
        fail(f"recovery: {mem2} bytes allocated after two recoveries "
             f"against {mem0} before (one engine's pools {pool_bytes})")
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    seconds["cold_first_step_s"] = time.perf_counter() - t0
    eng.run()
    if [r.generated_ids for r in reqs] != want_tokens:
        fail("recovery: tokens differ from the clean serve's")
    check_unfaulted("recovery", before, engines)
    out = dict(seconds, memory_before=mem0, memory_after=mem2,
               pool_bytes=pool_bytes, graphs_handed_over=graphs0,
               exec_handoffs=serving.decode_stats()["exec_handoffs"])
    print(f"recovery: handoff {seconds['handoff_recover_s']:.4f} s "
          f"(first step {seconds['handoff_first_step_s']:.4f} s, no graph "
          f"captured), cold {seconds['cold_recover_s']:.4f} s (first step "
          f"{seconds['cold_first_step_s']:.4f} s); memory {mem0} -> {mem2} "
          f"bytes; tokens equal the clean serve's", flush=True)
    return out


def _journaled_serve(new_engine, prompts, d, log):
    """The child's serve: journal in ``d``, every streamed token appended
    to ``log`` as "request token", SIGKILL after engine step
    `KILL_STEP`."""
    import os
    import signal

    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.tools import serve_profile

    flags.set_flags({"snapshot_interval_steps": SNAPSHOT_STEPS})
    before = ladder_counts()
    eng = new_engine(journal_dir=str(d))
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    ids = []
    for p in prompts:
        r = eng.add_request(p, max_new_tokens=serve_profile.NEW_TOKENS)
        r.on_token = (lambda rid: lambda t: os.write(
            fd, f"{rid} {t}\n".encode()))(r.request_id)
        ids.append(r.request_id)
    (Path(d) / "ids.json").write_text(json.dumps(ids))
    for _ in range(KILL_STEP):
        eng.step()
    check_unfaulted("durability serve", before, [eng])
    os.kill(os.getpid(), signal.SIGKILL)


def _restore(torch, model, d, log):
    """The second process: restore from ``d``, check the installed
    sidecar pages against the dead process's bytes, finish the serve
    appending to ``log``; returns the result."""
    import io
    import os

    import numpy as np

    from paddle_tpu_torch.inference import durability, serving

    serving.reset_decode_stats()
    before = ladder_counts()
    t0 = time.perf_counter()
    eng, rmap = durability.restore_from_dir(str(d), model)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    snap = durability.load_snapshot(str(d))
    data = np.load(io.BytesIO((Path(d) / snap.kv["file"]).read_bytes()))
    index = {bytes.fromhex(h): i for i, h in enumerate(snap.kv["hashes"])}
    installed = dict(eng.pool._page_hash)  # page -> hash, before serving
    names = [("k", "_k_pages"), ("v", "_v_pages")]
    if eng._kv_quant:
        names += [("ks", "_k_scales"), ("vs", "_v_scales")]
    equal = all(np.array_equal(getattr(eng, attr)[:, :, p].cpu().numpy(),
                               data[key][:, :, index[h]])
                for p, h in installed.items() for key, attr in names)
    replay = sum(len(r.prompt_ids) for r in rmap.values())
    fd = os.open(log, os.O_WRONLY | os.O_APPEND)
    for rid, r in rmap.items():
        r.on_token = (lambda i: lambda t: os.write(
            fd, f"{i} {t}\n".encode()))(rid)
    eng.run()
    torch.cuda.synchronize()
    check_unfaulted("durability restore", before, [eng])
    st = serving.decode_stats()
    return dict(restore_s=restore_s, pages_installed=len(installed),
                installed_equal_sidecar=equal, requests=len(rmap),
                replayed_tokens=replay,
                tokens_recomputed=replay - st["prefix_cached_tokens"],
                tokens={str(rid): r.generated_ids
                        for rid, r in rmap.items()},
                fault_sites=sorted({r.fault_info.site
                                    for r in rmap.values()}))


def durability_child(argv) -> int:
    """``--durability-child serve|restore MODE``: one life of the
    durability check (see `durability_check`)."""
    import torch

    from paddle_tpu_torch.tools import serve_profile

    role, mode = argv
    quant = mode == "int8"
    model, prompts, new_engine = serve_profile.gpt2_small_serve(
        "cuda", kv_quant="int8" if quant else "off",
        serve_weights="int8" if quant else "off")
    d = JOURNAL_ROOT / mode
    if role == "serve":
        _journaled_serve(new_engine, prompts, d, d / "streamed.log")
        return 1  # not reached: the serve kills its process
    res = _restore(torch, model, d, d / "streamed.log")
    (d / "restored.json").write_text(json.dumps(res))
    return 0


def durability_check(torch, new_engine, prompts, clean):
    """(d) A journaled serve in a child process, killed with SIGKILL
    after `KILL_STEP` steps, restored by another process, f32 and int8
    side by side:
    the restored tokens against the uninterrupted serve's (``clean``,
    by mode), every streamed token exactly once across the two lives, at
    least one sidecar page installed bit-equal to the dead process's
    bytes; then the journal's cost in this process."""
    import shutil
    import signal

    out = {}
    modes = ("f32", "int8")
    shutil.rmtree(JOURNAL_ROOT, ignore_errors=True)
    for mode in modes:
        (JOURNAL_ROOT / mode).mkdir(parents=True)
    me = [sys.executable, str(Path(__file__).resolve()),
          "--durability-child"]
    t0 = time.perf_counter()
    # the two modes' lives run side by side: each first life, then each
    # second life
    for role, want_rc in (("serve", -signal.SIGKILL), ("restore", 0)):
        lives = {mode: subprocess.Popen(me + [role, mode],
                                        stdout=subprocess.DEVNULL,
                                        stderr=subprocess.PIPE, text=True)
                 for mode in modes}
        for mode, life in lives.items():
            try:
                err = life.communicate(timeout=300)[1]
            except subprocess.TimeoutExpired:
                for other in lives.values():
                    other.kill()
                fail(f"durability {mode}: the {role} ran past 300 s")
            if life.returncode != want_rc:
                fail(f"durability {mode}: the {role} exited "
                     f"{life.returncode}, want {want_rc}:\n{err[-2000:]}")
    two_lives_s = time.perf_counter() - t0
    for mode in modes:
        d = JOURNAL_ROOT / mode
        res = json.loads((d / "restored.json").read_text())
        logs = {}
        for line in (d / "streamed.log").read_text().split("\n"):
            if line:
                rid, tok = line.split()
                logs.setdefault(rid, []).append(int(tok))
        ids = [str(i) for i in json.loads((d / "ids.json").read_text())]
        want = dict(zip(ids, clean[mode]))
        if not res["tokens"] or any(res["tokens"][rid] != want[rid]
                                    for rid in res["tokens"]):
            fail(f"durability {mode}: restored tokens differ from the "
                 f"uninterrupted serve's")
        if logs != want:
            fail(f"durability {mode}: the streamed log across both lives "
                 f"is not every token exactly once")
        if res["pages_installed"] < 1 or not res["installed_equal_sidecar"]:
            fail(f"durability {mode}: sidecar pages installed "
                 f"{res['pages_installed']}, bit-equal "
                 f"{res['installed_equal_sidecar']}")
        res.pop("tokens")
        res["two_lives_s"] = two_lives_s  # both modes' lives, side by side
        out[mode] = res
        print(f"durability {mode}: killed after step {KILL_STEP}, restored "
              f"{res['requests']} requests in {res['restore_s']:.4f} s, "
              f"{res['pages_installed']} sidecar pages installed "
              f"(bit-equal), {res['tokens_recomputed']} tokens recomputed "
              f"of {res['replayed_tokens']} replayed; tokens equal, each "
              f"streamed once", flush=True)
    # the journal's cost: fsync=step at the default snapshot cadence (32
    # steps, with the KV sidecar), then with snapshots off, between two
    # serves without a journal
    from paddle_tpu_torch.core import flags

    rates = {}
    for label, journal, interval in (
            ("none", False, 32), ("fsync_step", True, 32),
            ("fsync_step_no_snapshots", True, 0), ("none_again", False, 32)):
        runs = []
        flags.set_flags({"snapshot_interval_steps": interval})
        for i in range(SERVE_RUNS):
            kw = {}
            if journal:
                jd = JOURNAL_ROOT / f"cost_{label}_{i}"
                shutil.rmtree(jd, ignore_errors=True)
                kw = dict(journal_dir=str(jd))
            eng, reqs, wall = serve_once(
                torch, lambda: new_engine(**kw), prompts)
            runs.append(sum(len(r.generated_ids) for r in reqs) / wall)
        rates[label] = dict(runs=runs, median=statistics.median(runs))
    flags.set_flags({"snapshot_interval_steps": 32})
    out["journal_cost"] = rates
    print(f"durability: tokens/s median with the journal (fsync=step) "
          f"{rates['fsync_step']['median']:.1f}, without its snapshots "
          f"{rates['fsync_step_no_snapshots']['median']:.1f}, against "
          f"{rates['none']['median']:.1f} / "
          f"{rates['none_again']['median']:.1f} without a journal (runs "
          f"{json.dumps({k: v['runs'] for k, v in rates.items()})})",
          flush=True)
    return out


def watchdog_check(torch, new_engine, prompts, want_tokens, cfg):
    """(e) ``step_timeout_ms`` armed and a `slow_step` stall through the
    frontend: the worker is abandoned, the engine rebuilt from the
    pre-step snapshot, the streams finish with the clean tokens, and the
    abandoned engine's late return launches nothing."""
    from paddle_tpu_torch.inference import serving

    serving.reset_decode_stats()
    before = ladder_counts()
    eng = new_engine(fault_plan=f"slow_step@{SLOW_AT};slow_ms={SLOW_MS}",
                     step_timeout_ms=STEP_TIMEOUT_MS)
    reset_counts()
    t0 = time.perf_counter()
    fe, streams, toks, _, _, wall = stream_serve(
        torch, eng, prompts, warm=prompts[0][:64])
    # the abandoned worker wakes from its stall: let it return
    time.sleep(max(0.0, SLOW_MS / 1e3 - (time.perf_counter() - t0)) + 0.5)
    torch.cuda.synchronize()
    counts = read_counts()
    new = fe.engine
    pst = serving.decode_stats()
    if fe._recoveries != 1 or new is eng or pst["hung_steps"] != 1:
        fail(f"watchdog: {fe._recoveries} recoveries, {pst['hung_steps']} "
             f"hung steps")
    if toks != want_tokens or any(s.finish_reason != "length"
                                  for s in streams):
        fail("watchdog: the streams did not finish with the clean tokens")
    # the stall is the one fault; the ladder saw none of it
    check_unfaulted("watchdog", before, [eng, new], injected=1)
    steps = eng.decode_stats()["steps"] + new.decode_stats()["steps"]
    if counts["paged_attention"] != cfg.num_layers * steps:
        fail(f"watchdog: K1 launches {counts['paged_attention']} != "
             f"num_layers x the two engines' steps ({steps}): the "
             f"abandoned engine's late step launched")
    out = dict(recoveries=fe._recoveries, hung_steps=pst["hung_steps"],
               wall_s=wall, k1_launches=counts["paged_attention"],
               abandoned_engine_steps=eng.decode_stats()["steps"],
               successor_steps=new.decode_stats()["steps"])
    print(f"watchdog: step {SLOW_AT} stalled {SLOW_MS:.0f} ms against a "
          f"{STEP_TIMEOUT_MS:.0f} ms budget: worker abandoned, engine "
          f"rebuilt, streams finished with the clean tokens in "
          f"{wall:.2f} s; K1 {counts['paged_attention']} = "
          f"{cfg.num_layers} x {steps} "
          f"steps (the late return launched nothing)", flush=True)
    return out


def reliability_phase(torch, serve, int8_tokens):
    """Phase 13: (a) frontend, (b) containment, (c) recovery, (d)
    durability, (e) watchdog, on the serve of phase 4 (f32, captured;
    its tokens are the clean serve's) and, for (d), the int8 serve of
    phase 5 (``int8_tokens``)."""
    from paddle_tpu_torch.tools import serve_profile

    model, prompts, new_engine = serve_profile.gpt2_small_serve("cuda")
    cfg = model.cfg
    clean = serve["tokens"]
    probe = new_engine()
    pool_bytes = sum(t.numel() * t.element_size() for t in (
        probe._k_pages, probe._v_pages))
    del probe
    out = dict(frontend=frontend_check(torch, new_engine, prompts, cfg,
                                       clean))
    out["containment"] = containment_check(torch, new_engine, prompts,
                                           clean)
    out["recovery"] = recovery_check(torch, new_engine, prompts, clean,
                                     pool_bytes)
    out["durability"] = durability_check(
        torch, new_engine, prompts, dict(f32=clean, int8=int8_tokens))
    out["watchdog"] = watchdog_check(torch, new_engine, prompts, clean, cfg)
    return out


# ---------------------------------------------------------------------------
# phase 14: the telemetry plane
# ---------------------------------------------------------------------------
TELEMETRY_ROOT = Path("build") / "chip_smoke_telemetry"
# a window that keeps every record of one serve (the default keeps 64)
FULL_WINDOW = 1024
# the HBM ledger audits this often in the full-plane serves (default 128)
LEDGER_STEPS = 16
CAPTURE_STEPS = 4
# the ops server's endpoints, scraped during and after the serves (the
# engine's own id is added to the engine-scoped ones: an earlier engine
# may still live)
OPS_PATHS = ("/metrics", "/statusz", "/statusz?format=text", "/flightz",
             "/healthz", "/readyz", "/alertz", "/profilez", "/tracez")
# the poller's pause between scrapes (a scrape renders the whole catalog,
# the flight window or the trace: a tighter loop starves the engine
# thread of the interpreter)
POLL_S = 0.02


def ops_path(path, engine_id):
    if not path.startswith(("/statusz", "/flightz", "/profilez")):
        return path
    return path + ("&" if "?" in path else "?") + f"engine={engine_id}"
# the gauges that are shares of a ceiling: each lies in (0, MAX_SHARE]
SHARE_GAUGES = ("paddle_phase_mfu", "paddle_phase_hbm_util",
                "paddle_phase_mfu_measured")
MAX_SHARE = 1.05


def hook_cost_us(new_engine, prompts, iters=2000):
    """Host microseconds a step of the flight recorder's and the cost
    model's hooks, alone: an armed engine paused mid-serve (8 slots
    decoding) runs each hook sequence ``iters`` times, no step between."""
    eng = new_engine()
    for p in prompts[:8]:
        eng.add_request(p, max_new_tokens=40)
    while eng._prefilling_any() or eng._queue:
        eng.step()
    for _ in range(3):  # decode steps: every profile the hooks read
        eng.step()
    fr, cm = eng._flight, eng._cost
    t0 = time.perf_counter()
    for _ in range(iters):
        fr.begin_step()
        with eng._excl_phase("admit"):
            pass
        fr.note_batch()
        with eng._phase("cache"):
            pass
        with eng._phase("decode"):
            pass
        fr.add_phase("fetch", 1e-4)
        with eng._excl_phase("emit"):
            for s in range(eng._slots):
                fr.note_emit(s, 1)
        fr.end_step()
    t1 = time.perf_counter()
    for _ in range(iters):
        fr.begin_step()
        cm.note_step_begin(fr)
        rec = fr.end_step()
        cm.observe(rec)
    t2 = time.perf_counter()
    for _ in range(iters):
        fr.begin_step()
        fr.end_step()
    t3 = time.perf_counter()
    empty = (t3 - t2) / iters * 1e6
    return dict(flight_us=(t1 - t0) / iters * 1e6,
                cost_us=(t2 - t1) / iters * 1e6 - empty,
                empty_record_us=empty)


def default_on_cost(torch, new_engine, prompts, cfg, want_tokens):
    """(a) The split f32 captured serve with JAX's defaults
    (``flight_window=64``, ``cost_model=True``) and disarmed (`DISARMED`),
    and with the flight recorder or the cost model alone, `SERVE_RUNS`
    each in turns: equal greedy tokens, K1 launched num_layers x steps in
    every arm, no retrace once warm.  Host ms a step, tokens/s and the
    garbage collector's passes and seconds of every run, and the hooks'
    own host microseconds a step (`hook_cost_us`)."""
    import gc

    from paddle_tpu_torch.inference import serving

    arms = dict(armed={}, disarmed=DISARMED,
                flight_only=dict(cost_model=False),
                cost_only=dict(flight_window=0))
    out = {arm: dict(host_ms_per_step=[], tokens_per_s=[], gc_passes=[],
                     gc_s=[]) for arm in arms}
    gcs = dict(n=0, s=0.0, t0=0.0)

    def on_gc(phase, info):
        if phase == "start":
            gcs["t0"] = time.perf_counter()
        else:
            gcs["n"] += 1
            gcs["s"] += time.perf_counter() - gcs["t0"]

    serving.reset_decode_stats()
    gc.callbacks.append(on_gc)
    try:
        for run in range(SERVE_RUNS):
            for arm, kw in arms.items():
                reset_counts()
                gcs.update(n=0, s=0.0)
                eng, reqs, wall = serve_once(
                    torch, lambda: new_engine(**kw), prompts)
                counts = read_counts()
                st = eng.decode_stats()
                if [r.generated_ids for r in reqs] != want_tokens:
                    fail(f"telemetry {arm}: greedy tokens differ from the "
                         f"serve's")
                if counts["paged_attention"] != \
                        cfg.num_layers * st["steps"]:
                    fail(f"telemetry {arm}: K1 launches "
                         f"{counts['paged_attention']} != num_layers x "
                         f"steps ({st['steps']})")
                if (eng._flight is None) != ("flight_window" in kw) or \
                        (eng._cost is None) != ("cost_model" in kw):
                    fail(f"telemetry {arm}: armed flight "
                         f"{eng._flight is not None}, cost "
                         f"{eng._cost is not None}")
                o = out[arm]
                o["host_ms_per_step"].append(wall / st["steps"] * 1e3)
                o["tokens_per_s"].append(st["tokens"] / wall)
                o["gc_passes"].append(gcs["n"])
                o["gc_s"].append(gcs["s"])
                o["steps"] = st["steps"]
    finally:
        gc.callbacks.remove(on_gc)
    retraces = retrace_counts(serving.decode_stats())
    if any(retraces.values()):
        fail(f"telemetry: a step retraced after warm-up: {retraces}")
    for arm in arms:
        for k in ("host_ms_per_step", "tokens_per_s"):
            out[arm][k + "_median"] = statistics.median(out[arm][k])
    base = out["disarmed"]["host_ms_per_step_median"]
    for arm in arms:
        out[arm]["minus_disarmed_host_ms_per_step"] = \
            out[arm]["host_ms_per_step_median"] - base
    out["hooks"] = hook_cost_us(new_engine, prompts)
    print(f"telemetry (a) default-on cost, split f32 captured serve, "
          f"{SERVE_RUNS} runs an arm in turns; host ms a step, tokens/s, "
          f"GC passes (seconds):", flush=True)
    for arm, o in out.items():
        if arm == "hooks":
            continue
        print(f"  {arm:>11}: {o['host_ms_per_step']} (median "
              f"{o['host_ms_per_step_median']:.4f}, "
              f"{o['minus_disarmed_host_ms_per_step']:+.4f} against "
              f"disarmed); {o['tokens_per_s']} (median "
              f"{o['tokens_per_s_median']:.1f}); GC {o['gc_passes']} "
              f"({[round(x, 4) for x in o['gc_s']]})", flush=True)
    print(f"  hooks alone, host us a step: "
          f"{json.dumps({k: round(v, 2) for k, v in out['hooks'].items()})}"
          f"; tokens equal, K1 {cfg.num_layers} x steps in every arm, no "
          f"retrace", flush=True)
    return out


def _get(base, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def serve_breakdown(eng, kernel_launches, wall):
    """Per-phase host milliseconds a step, the probes' device/host split,
    the serve's wall a step outside every step's record (between steps),
    and the roofline (predicted) and probed (measured) MFU of the decode
    and mixed steps, from one engine's sealed flight records."""
    recs = [r for r in eng._flight.records() if r.get("kind") == "step"]
    phases = {}
    for r in recs:
        for k, v in r["phases"].items():
            phases[k] = phases.get(k, 0.0) + v
    n = len(recs)
    cost, prof = eng._cost, eng._profiling
    probed = [r for r in recs if "probe" in r]
    roof, meas = {}, {}
    for r in recs:
        for ph, (mfu, hbm) in cost.roofline(r).items():
            roof.setdefault(ph, []).append((mfu, hbm))
    for r in probed:
        for kind, dev in r["probe"]["device"].items():
            if kind in ("decode", "mixed", "ragged") and dev > 0:
                p = cost.profile_for(kind)
                meas.setdefault(kind, []).append(
                    (p.flops / dev / cost.peaks["flops"],
                     p.bytes_accessed / dev / cost.peaks["bytes_per_s"]))
    mean = statistics.mean
    out = dict(
        steps=n, wall_ms_per_step=sum(r["dur_s"] for r in recs) / n * 1e3,
        serve_wall_ms_per_step=wall / n * 1e3,
        between_steps_ms=(wall - sum(r["dur_s"] for r in recs)) / n * 1e3,
        phase_ms_per_step={k: v / n * 1e3 for k, v in
                           sorted(phases.items())},
        probed_steps=len(probed),
        device_ms_per_step=(mean(r["probe"]["device_s"] for r in probed)
                            * 1e3 if probed else None),
        host_ms_per_step=(mean(r["probe"]["host_s"] for r in probed)
                          * 1e3 if probed else None),
        mfu_roofline={k: mean(m for m, _ in v) for k, v in roof.items()},
        hbm_util_roofline={k: mean(h for _, h in v)
                           for k, v in roof.items()},
        mfu_measured={k: mean(m for m, _ in v) for k, v in meas.items()},
        hbm_util_measured={k: mean(h for _, h in v)
                           for k, v in meas.items()},
        profile_flops={k: cost.profile_for(k).flops
                       for k in ("decode", "mixed", "ragged")},
        peaks=dict(cost.peaks), launches=kernel_launches,
        probe_clock=prof.clock if prof is not None else None)
    return out


def plane_serve(torch, label, eng, prompts, want_tokens, frontend):
    """One serve of ``prompts`` through `ServingFrontend` or
    ``engine.run``: ``(tokens, wall seconds)``; the engine never
    rebuilt."""
    if frontend:
        fe, _, toks, _, _, wall = stream_serve(torch, eng, prompts)
        if fe.engine is not eng:
            fail(f"{label}: the engine was rebuilt")
        return toks, wall
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=len(want_tokens[0]))
            for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    return [r.generated_ids for r in reqs], time.perf_counter() - t0


def breakdown_serve(torch, label, new_engine, prompts, cfg, want_tokens,
                    kernel, frontend=False):
    """Where a serve's time goes, from its flight records and a probe on
    every step (no ops server polling it): `serve_breakdown` of a serve
    held to its tokens and its kernel's num_layers x steps launches."""
    eng = new_engine(profile=True, profile_sample_steps=1,
                     flight_window=FULL_WINDOW)
    before = ladder_counts()
    reset_counts()
    toks, wall = plane_serve(torch, label, eng, prompts, want_tokens,
                             frontend)
    counts = read_counts()
    check_unfaulted(label, before, [eng])
    st = eng.decode_stats()
    if toks != want_tokens:
        fail(f"{label}: tokens differ from the serve's")
    if counts[kernel] != cfg.num_layers * st["steps"]:
        fail(f"{label}: {kernel} launches {counts[kernel]} != num_layers "
             f"x steps ({st['steps']})")
    b = serve_breakdown(eng, counts[kernel], wall)
    b["tokens_per_s"] = st["tokens"] / wall
    print(f"{label}: tokens/s {b['tokens_per_s']:.1f}; per step (ms): "
          f"serve wall {b['serve_wall_ms_per_step']:.4f}, in the step "
          f"records {b['wall_ms_per_step']:.4f}, between steps "
          f"{b['between_steps_ms']:.4f}; phases "
          f"{json.dumps({k: round(v, 4) for k, v in b['phase_ms_per_step'].items()})}; "
          f"probes ({b['probe_clock']}) device {b['device_ms_per_step']:.4f}"
          f" / host {b['host_ms_per_step']:.4f}; MFU roofline "
          f"{json.dumps(b['mfu_roofline'])}, measured "
          f"{json.dumps(b['mfu_measured'])}; HBM util roofline "
          f"{json.dumps(b['hbm_util_roofline'])}, measured "
          f"{json.dumps(b['hbm_util_measured'])}", flush=True)
    return b


def full_plane_check(torch, label, new_engine, prompts, cfg, want_tokens,
                     kernel, frontend=True):
    """(b) The serve with the whole plane armed (profiling every step,
    the alerts, the ops server on 127.0.0.1:0), through `ServingFrontend`
    (or ``engine.run``): every endpoint scraped during the serve and
    after it; every ported catalog name in /metrics; probe device
    seconds within each step's wall; every share gauge in (0, 1.05];
    the ledger's kv_pages and weights equal to the pools' and the
    parameters' bytes; the residue printed; the tokens equal the serve's
    and the kernel launched num_layers x steps."""
    import threading

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.inference import serving

    port = obs.start_ops_server(port=0, host="127.0.0.1")
    base = f"http://127.0.0.1:{port}"
    obs.reset()
    for name in SHARE_GAUGES:  # this serve's phases only
        obs.registry._metrics[name].clear()
    serving.reset_decode_stats()
    flags.set_flags({"cost_ledger_interval_steps": LEDGER_STEPS})
    try:
        eng = new_engine(profile=True, profile_sample_steps=1, alerts=True,
                         flight_window=FULL_WINDOW)
    finally:
        flags.set_flags({"cost_ledger_interval_steps": 128})
    during, stop = {}, threading.Event()

    def poll():
        i = 0
        while not stop.is_set():
            p = OPS_PATHS[i % len(OPS_PATHS)]
            during.setdefault(p, []).append(
                _get(base, ops_path(p, eng._engine_id))[0])
            i += 1
            time.sleep(POLL_S)

    before = ladder_counts()
    reset_counts()
    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        toks, wall = plane_serve(torch, label, eng, prompts, want_tokens,
                                 frontend)
    finally:
        stop.set()
        poller.join(timeout=60)
    counts = read_counts()
    check_unfaulted(label, before, [eng])
    st = eng.decode_stats()
    if toks != want_tokens:
        fail(f"{label}: tokens differ from the serve's")
    if counts[kernel] != cfg.num_layers * st["steps"]:
        fail(f"{label}: {kernel} launches {counts[kernel]} != num_layers "
             f"x steps ({st['steps']})")
    after = {p: _get(base, ops_path(p, eng._engine_id)) for p in OPS_PATHS}
    if set(during) != set(OPS_PATHS):
        fail(f"{label}: endpoints not scraped during the serve: "
             f"{sorted(set(OPS_PATHS) - set(during))}")
    for p, (code, body) in after.items():
        codes = set(during[p]) | {code}
        if not codes <= {200, 503}:
            fail(f"{label}: {p} answered {sorted(codes)}")
        if not p.startswith("/metrics") and "format=text" not in p:
            json.loads(body)
    metrics = after["/metrics"][1]
    missing = [n for n in obs.registry._metrics
               if f"# TYPE {n} " not in metrics]
    if missing:
        fail(f"{label}: catalog names missing from /metrics: {missing}")
    for r in eng._flight.records():
        pr = r.get("probe")
        if pr is not None and not 0 < pr["device_s"] <= r["dur_s"]:
            fail(f"{label}: step {r['step']} probe device "
                 f"{pr['device_s']} s against a wall of {r['dur_s']} s")
    if eng._profiling.clock != "cuda_event":
        fail(f"{label}: the probes read {eng._profiling.clock}")
    snap = obs.snapshot()
    shares = {}
    for name in SHARE_GAUGES:
        series = snap[name]["series"]
        if not series:
            fail(f"{label}: {name} has no series")
        for s in series:
            v = s["value"]
            shares[f"{name}{{phase={s['labels']['phase']}}}"] = v
            if not 0 < v <= MAX_SHARE:
                fail(f"{label}: {name} {s['labels']} = {v}, outside "
                     f"(0, {MAX_SHARE}]")
    led = eng._cost.hbm_ledger()
    cats = led["categories"]
    pools = sum(t.numel() * t.element_size()
                for t in (eng._k_pages, eng._v_pages))
    params = [v for k, v in eng._params.items() if k != "blocks"
              and v is not None] + \
        [v for b in eng._params["blocks"] for v in b.values()]
    weights = sum(t.numel() * t.element_size() for t in params)
    got_w = cats["weights"] + cats["weights_int8"] + cats["weight_scales"]
    if cats["kv_pages"] != pools or got_w != weights:
        fail(f"{label}: ledger kv_pages {cats['kv_pages']} (pools {pools}),"
             f" weights {got_w} (parameters {weights})")
    if led["unattributed_bytes"] is None:
        fail(f"{label}: no audit measured the ledger's residue")
    z = json.loads(after["/statusz"][1])
    out = dict(
        wall_s=wall, tokens_per_s=st["tokens"] / wall, steps=st["steps"],
        breakdown=serve_breakdown(eng, counts[kernel], wall),
        shares=shares,
        ledger=led, statusz_keys=sorted(z),
        scrapes_during=sum(len(v) for v in during.values()),
        alerts_firing=eng._alerts.firing(),
        profile_probes=serving.decode_stats()["profile_probes"],
        flight_records=serving.decode_stats()["flight_records"])
    b = out["breakdown"]
    print(f"{label}: {out['scrapes_during']} scrapes of "
          f"{len(OPS_PATHS)} endpoints during the serve, all answered; "
          f"{len(obs.registry._metrics)} catalog names in /metrics; "
          f"tokens equal, {kernel} {counts[kernel]} = {cfg.num_layers} x "
          f"{st['steps']}; tokens/s {out['tokens_per_s']:.1f}; per step "
          f"(ms): wall {b['wall_ms_per_step']:.4f}, "
          f"{json.dumps({k: round(v, 4) for k, v in b['phase_ms_per_step'].items()})}; "
          f"probes ({b['probe_clock']}) device "
          f"{b['device_ms_per_step']:.4f} / host "
          f"{b['host_ms_per_step']:.4f} ms a step; MFU roofline "
          f"{json.dumps(b['mfu_roofline'])}, measured "
          f"{json.dumps(b['mfu_measured'])}; HBM util roofline "
          f"{json.dumps(b['hbm_util_roofline'])}, measured "
          f"{json.dumps(b['hbm_util_measured'])}; gauges "
          f"{json.dumps(shares)}; ledger {json.dumps(cats)}, "
          f"unattributed residue {led['unattributed_bytes']} of "
          f"{led['total_live_bytes']} allocated bytes; alerts firing "
          f"{out['alerts_firing']}", flush=True)
    return out


def capture_session_check(torch, new_engine, prompts):
    """(c) ``FLAGS_profile_dir`` set and a bounded capture of
    `CAPTURE_STEPS` steps: the torch.profiler trace and the merged chrome
    trace are written and load as JSON, the merged one with engine,
    requests and device tracks."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.observability import profiling

    d = TELEMETRY_ROOT / "profile"
    flags.set_flags({"profile_dir": str(d)})
    try:
        eng = new_engine(profile=True, profile_sample_steps=100000)
        # the graphs are captured before the session: it traces replays
        eng.generate(prompts[:4], 16)
        torch.cuda.synchronize()
        obs.clear_spans()
        profiling.request_capture(CAPTURE_STEPS, engine=eng)
        eng.generate(prompts[4:8], 16)
        torch.cuda.synchronize()
    finally:
        flags.set_flags({"profile_dir": ""})
    st = eng._profiling.capture_status()
    if st["captures_completed"] != 1 or \
            st["captured_steps"] != CAPTURE_STEPS or st["torch_trace"]:
        fail(f"capture session: {st}")
    path = Path(st["trace_path"])
    torch_trace = json.loads((path / "torch_trace.json").read_text())
    merged = json.loads((path / "merged_trace.json").read_text())
    tracks = {e["args"]["name"] for e in merged["traceEvents"]
              if e.get("ph") == "M"}
    if not {"engine", "requests", "device"} <= tracks:
        fail(f"capture session: merged trace tracks {sorted(tracks)}")
    device_spans = [e for e in merged["traceEvents"] if e.get("ph") == "X"
                    and e.get("name") in ("decode", "mixed")
                    and e.get("args", {}).get("clock") == "cuda_event"]
    if len(device_spans) != CAPTURE_STEPS:
        fail(f"capture session: {len(device_spans)} device spans for "
             f"{CAPTURE_STEPS} captured steps")
    kernels = [e for e in torch_trace.get("traceEvents", [])
               if e.get("cat") == "kernel"]
    out = dict(trace_path=str(path), tracks=sorted(tracks),
               torch_trace_events=len(torch_trace.get("traceEvents", [])),
               torch_trace_kernel_events=len(kernels),
               device_spans=len(device_spans))
    print(f"telemetry (c) capture session: {CAPTURE_STEPS} steps; "
          f"torch.profiler trace {out['torch_trace_events']} events "
          f"({len(kernels)} kernels), merged trace tracks "
          f"{sorted(tracks)}, {len(device_spans)} device spans", flush=True)
    return out


def black_box_check(torch, new_engine, prompts, want_tokens):
    """(d) The `FAULT_PLAN` serve with ``flight_dir`` set: the window it
    leaves (a dump of every record of the serve) renders the poisoned
    request's timeline through the port's ``explain_request``; and a
    fatal fault (a step failing past its retries) dumps by itself, and
    the serve recovers with the clean tokens."""
    import subprocess

    from paddle_tpu_torch.inference import resilience

    d = TELEMETRY_ROOT / "flight"
    victim = 5
    plan = FAULT_PLAN.format(poison=poison_token(prompts, victim,
                                                 want_tokens))
    eng = new_engine(fault_plan=plan, flight_dir=str(d),
                     flight_window=FULL_WINDOW)
    reqs = [eng.add_request(p, max_new_tokens=len(want_tokens[0]))
            for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    bad = reqs[victim]
    if bad.finish_reason != "fault":
        fail(f"black box: the poisoned request finished "
             f"{bad.finish_reason!r}")
    path = eng._flight.dump("manual")
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.explain_request",
         str(Path(path).resolve()), "--request", str(bad.request_id)],
        capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parent)
    text = res.stdout
    if res.returncode != 0 or "quarantine" not in text or \
            "finished: fault" not in text or \
            f"request {bad.request_id}" not in text:
        fail(f"black box: explain_request did not render the poisoned "
             f"request: rc {res.returncode}, {res.stderr[-500:]}")
    # a fatal fault: the escaping StepFault leaves its window by itself
    fatal = new_engine(fault_plan="step@3;step@6-16", flight_dir=str(d))
    freqs = [fatal.add_request(p, max_new_tokens=len(want_tokens[0]))
             for p in prompts]
    new, recoveries = resilience.serve_with_recovery(fatal,
                                                     max_recoveries=4)
    torch.cuda.synchronize()
    dumps = sorted(d.glob(f"flight_eng{fatal._engine_id}_*_fault.json"))
    if not recoveries or not dumps or \
            [r.generated_ids for r in freqs] != want_tokens:
        fail(f"black box: fatal fault: {recoveries} recoveries, dumps "
             f"{[p.name for p in dumps]}, tokens clean "
             f"{[r.generated_ids for r in freqs] == want_tokens}")
    window = json.loads(dumps[0].read_text())
    kinds = sorted({ev["kind"] for rec in window["records"]
                    for ev in rec.get("events", [])})
    out = dict(dump=str(path), explain_lines=len(text.splitlines()),
               fatal_dump=str(dumps[0]), fatal_events=kinds,
               recoveries=recoveries)
    print(f"telemetry (d) black box: {plan}: request {victim}'s timeline "
          f"rendered from {Path(path).name} ({out['explain_lines']} "
          f"lines, quarantine and finish found); the fatal "
          f"step@3;step@6-16 serve "
          f"dumped {dumps[0].name} (events {kinds}) and recovered "
          f"{recoveries}x with the clean tokens", flush=True)
    print("\n".join("  " + ln for ln in text.splitlines()[:6]), flush=True)
    return out


def telemetry_phase(torch, serve, int8_tokens, ragged_tokens):
    """Phase 14: (a) the default-on cost, (b) the full plane on the f32,
    int8 (both through `ServingFrontend`) and ragged serves, each held to
    the tokens of its serve in phases 4-6, (c) a capture session, (d)
    the black box."""
    import shutil

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.tools import serve_profile

    shutil.rmtree(TELEMETRY_ROOT, ignore_errors=True)
    model, prompts, new_engine = serve_profile.gpt2_small_serve("cuda")
    cfg = model.cfg
    clean = serve["tokens"]
    out = dict(default_on_cost=default_on_cost(torch, new_engine, prompts,
                                               cfg, clean))
    _, _, new_q = serve_profile.gpt2_small_serve(
        "cuda", kv_quant="int8", serve_weights="int8")
    _, _, new_r = serve_profile.gpt2_small_serve("cuda", ragged_step=True)
    out["breakdown"] = dict(
        f32=breakdown_serve(torch, "telemetry (b) f32 breakdown",
                            new_engine, prompts, cfg, clean,
                            "paged_attention"),
        f32_frontend=breakdown_serve(
            torch, "telemetry (b) f32 breakdown through the frontend",
            new_engine, prompts, cfg, clean, "paged_attention",
            frontend=True),
        int8=breakdown_serve(torch, "telemetry (b) int8 breakdown", new_q,
                             prompts, cfg, int8_tokens, "paged_attention_q"),
        ragged=breakdown_serve(torch, "telemetry (b) ragged f32 breakdown",
                               new_r, prompts, cfg, ragged_tokens,
                               "paged_attention"))
    try:
        out["full_plane_f32"] = full_plane_check(
            torch, "telemetry (b) f32 through the frontend", new_engine,
            prompts, cfg, clean, "paged_attention")
        out["full_plane_int8"] = full_plane_check(
            torch, "telemetry (b) int8 through the frontend", new_q,
            prompts, cfg, int8_tokens, "paged_attention_q")
        out["full_plane_ragged"] = full_plane_check(
            torch, "telemetry (b) ragged f32", new_r, prompts, cfg,
            ragged_tokens, "paged_attention", frontend=False)
    finally:
        obs.stop_ops_server()
    out["capture_session"] = capture_session_check(torch, new_engine,
                                                   prompts)
    out["black_box"] = black_box_check(torch, new_engine, prompts, clean)
    return out


# ---------------------------------------------------------------------------
# 15. tensor-parallel serving: serve_mesh
# ---------------------------------------------------------------------------
# one sharded step's logits (the first step of the f32 serve) against the
# unsharded step's on the same inputs: the row-split out and fc2 products
# add two halves where the unsharded product sums once (f32 on the CUDA
# cores, TF32 off), a few ulps of 768- and 3072-long sums through 12
# blocks and the 50304-wide head, far under this
MESH_LOGIT_TOL = 1e-3
# with int8 KV pages the sharded and unsharded steps' K/V, a few f32 ulps
# apart, can round an element on its page's int8 grid a step apart (the
# 1 LSB of `POOL_TOL`), and one step, 1/127 of the page head's absmax,
# moves the logits by about as much: 5e-2 holds a few such steps (one
# H100 80GB HBM3 at 700 W read 1.1e-2 here, and 5.6e-6 in f32)
MESH_LOGIT_TOL_INT8 = 5e-2
# where a sharded serve's greedy tokens part from the unsharded serve's,
# the unsharded logits at the first parting must rank the two tokens
# within this of each other (a near-tie the summation order can flip)
MESH_NEAR_TIE = 1e-3
# the probed sharded serve of the chip-skew reading: its first prompts
MESH_SKEW_REQUESTS = 4


def mesh_launches(mesh, reset=False):
    """K1/K2 launches of every rank of ``mesh``: rank 0 (this process)
    and each worker (`Mesh.stats`); ``reset`` zeroes them after."""
    counts = read_counts()
    out = {0: {"K1": counts["paged_attention"],
               "K2": counts["paged_attention_q"]}}
    for st in mesh.stats(reset):
        out[st["rank"]] = st["launches"]
    if reset:
        reset_counts()
    return out


def first_step_logits(torch, new_engine, prompts):
    """The logits of the first step of a fresh engine over ``prompts``
    (8 slots of prompt chunks), read where the step samples; steps
    eager, so the step's Python runs."""
    from paddle_tpu_torch.inference import serving

    seen = []
    real = serving._sample

    def sample(params, h, eps, generator, sampling):
        if not seen:
            seen.append(serving._logits_of(params, serving._ln(
                h, params["lnf_w"], params["lnf_b"], eps)).float().clone())
        return real(params, h, eps, generator, sampling)

    serving._sample = sample
    try:
        with serving.disable_capture():
            eng = new_engine()
            for p in prompts[:8]:
                eng.add_request(p, max_new_tokens=2)
            eng.step()
            torch.cuda.synchronize()
    finally:
        serving._sample = real
    return seen[0]


def first_parting(torch, model, prompts, ref, got, label):
    """None when ``got``'s tokens equal ``ref``'s request by request; else
    the first parting, which must sit at a near-tie of the unsharded
    model's logits (`MESH_NEAR_TIE`): printed, and returned."""
    for i, (a, b) in enumerate(zip(ref, got)):
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        ids = torch.tensor([list(prompts[i]) + list(a[:j])],
                           device=model.params()["wte"].device)
        with torch.no_grad():
            logits = model(ids)[0, -1].float()
        gap = float(logits[a[j]] - logits[b[j]])
        top2 = torch.topk(logits, 2).values
        out = dict(request=i, position=j, ref_token=int(a[j]),
                   token=int(b[j]), logit_gap=gap,
                   top2_gap=float(top2[0] - top2[1]))
        print(f"{label}: first parting from the unsharded serve at "
              f"request {i} position {j}: {out}", flush=True)
        if abs(gap) > MESH_NEAR_TIE:
            fail(f"{label}: the tokens part at request {i} position {j} "
                 f"where the unsharded logits are {gap} apart (no "
                 f"near-tie, tolerance {MESH_NEAR_TIE})")
        return out
    return None


def mesh_serve(torch, label, model, prompts, new_engine, ref, kname,
               quant):
    """One sharded serve of ``prompts`` with every count (both ranks')
    set to 0 just before: the checks of `drive_serve` (drain, vocabulary,
    no retrace, one ragged compile, eager steps: no graph), ``kname``
    launched num_layers x steps on every rank and the other kernel on
    none, the tokens against the unsharded ragged serve's ``ref``
    (`first_parting`), the first step's logits against the unsharded
    step's, the step's collective bytes against the formula."""
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.parallel import partition
    from paddle_tpu_torch.tools import serve_profile

    cfg = model.cfg
    mesh = new_engine()._mesh  # started outside the timing
    print(f"{label}: backend {mesh.backend}, placement "
          f"{[str(d) for d in mesh.devices]}, steps "
          f"{'captured' if mesh.capturable else 'eager'} "
          f"(rule: {mesh.describe()['rule']})", flush=True)
    if torch.cuda.device_count() < mesh.mp and mesh.backend != "gloo":
        fail(f"{label}: ranks share a card but the backend is "
             f"{mesh.backend}")
    serving.reset_decode_stats()
    mesh_launches(mesh, reset=True)
    eng, reqs, wall = serve_once(torch, new_engine, prompts,
                                 capture=mesh.capturable)
    ranks = mesh_launches(mesh)
    st = eng.decode_stats()
    pst = serving.decode_stats()
    retraces = {k: v for k, v in pst.items()
                if k.endswith("_retraces") or k == "retraces_after_warmup"}
    if any(retraces.values()):
        fail(f"{label}: a step retraced after warm-up: {retraces}")
    want = compiles(ragged=1, kv_quant=int(bool(quant)))
    got = {k: pst[k] for k in COMPILE_KEYS}
    if got != want:
        fail(f"{label}: compile counters {got} != {want}")
    graphs = eng.graph_captures()
    if graphs != (sum(want.values()) if mesh.capturable else 0):
        fail(f"{label}: {graphs} graphs for {want}")
    for r in reqs:
        if r.finish_reason != "length" or \
                len(r.generated_ids) != serve_profile.NEW_TOKENS or \
                not all(0 <= t < cfg.vocab_size for t in r.generated_ids):
            fail(f"{label} request {r.request_id}: {r.finish_reason} "
                 f"after {len(r.generated_ids)} tokens")
    if eng.pool.available_count != eng.pool.num_pages:
        fail(f"{label}: pool did not drain")
    other = "K1" if kname == "K2" else "K2"
    want_n = cfg.num_layers * st["steps"]
    for rank, n in ranks.items():
        if n[kname] != want_n or n[other]:
            fail(f"{label}: rank {rank} launched {kname} {n[kname]} times "
                 f"and {other} {n[other]} (want {want_n} = "
                 f"{cfg.num_layers} layers x {st['steps']} steps, and 0)")
    tokens = [r.generated_ids for r in reqs]
    parting = first_parting(torch, model, prompts, ref["tokens"], tokens,
                            label)
    prof = eng._cost.profile_for("ragged")
    formula = partition.collective_bytes(
        rows=eng._slots * eng._q_ragged, hidden=cfg.hidden_size,
        layers=cfg.num_layers, mp=mesh.mp, kv_int8=eng._kv_quant)
    if prof.collective_bytes != formula:
        fail(f"{label}: collective bytes {prof.collective_bytes} != the "
             f"formula's {formula}")
    out = dict(
        backend=mesh.backend, placement=[str(d) for d in mesh.devices],
        captured=mesh.capturable, steps=st["steps"],
        ragged_steps=st["ragged_steps"], new_tokens=st["tokens"],
        wall_s=wall, tokens_per_s=st["tokens"] / wall,
        host_ms_per_step=wall / st["steps"] * 1e3,
        launches_by_rank=ranks, graphs=graphs,
        tokens_equal_to_unsharded=parting is None,
        token_share_with_unsharded=token_share(ref["tokens"], tokens),
        first_parting=parting, collective_bytes_per_step=
        prof.collective_bytes, collective_bytes_formula=formula,
        interconnect_ceiling_bytes_per_s=eng._cost.peaks[
            "ici_bytes_per_s"])
    return eng, out


def mesh_profile_pass(torch, new_engine, prompts, steps=8):
    """torch.profiler over ``steps`` steps of a sharded serve past its
    warm-up: the share of the steps' wall inside the mesh's all-reduces
    (`Mesh.all_reduce`'s named range: with gloo, the host staging and
    the reduce), and the device time of NCCL kernels."""
    eng = new_engine()
    for p in prompts:
        eng.add_request(p, max_new_tokens=16)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the named range's host side (the profiler also keeps a device-side
    # copy of each range, which would count every reduce twice)
    host = [e for e in prof.key_averages() if e.key == "mesh.all_reduce"
            and str(e.device_type).endswith("CPU")]
    reduce_us = sum(e.cpu_time_total for e in host)
    n_reduce = sum(e.count for e in host)
    nccl_us = sum(getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0))
                  for e in prof.key_averages() if "nccl" in e.key.lower())
    return dict(steps=steps, wall_ms_per_step=wall / steps * 1e3,
                all_reduces=n_reduce,
                all_reduce_host_ms_per_step=reduce_us / 1e3 / steps,
                all_reduce_share_of_step=reduce_us / 1e6 / wall,
                nccl_device_ms_per_step=nccl_us / 1e3 / steps)


def mesh_case(torch, label, spec, quant, kname, ref):
    """One sharded configuration: `mesh_serve` against the unsharded
    ragged serve ``ref``, the first step's logits against the unsharded
    step's, and (f32) a profile pass and a probed serve's chip skew."""
    from paddle_tpu_torch.tools import serve_profile

    model, prompts, new_engine = serve_profile.gpt2_small_serve(
        "cuda", ragged_step=True, **quant)

    def sharded(**kw):
        return new_engine(serve_mesh=spec, **kw)

    eng, res = mesh_serve(torch, label, model, prompts, sharded, ref, kname,
                          quant)
    a = first_step_logits(torch, new_engine, prompts)
    b = first_step_logits(torch, sharded, prompts)
    err = float((a - b).abs().max())
    tol = MESH_LOGIT_TOL_INT8 if quant else MESH_LOGIT_TOL
    res.update(step_logits_max_abs_err=err, step_logits_tol=tol)
    print(f"{label}: first step's logits against the unsharded step's: "
          f"max abs err {err:.3e} (tolerance {tol})", flush=True)
    if not err <= tol:
        fail(f"{label}: step logits differ by {err}")
    res["unsharded_captured_tokens_per_s_median"] = \
        ref["tokens_per_s_median"]
    res["unsharded_captured_host_ms_per_step"] = ref["host_ms_per_step"]
    if "eager" in ref:
        res["unsharded_eager_tokens_per_s_median"] = \
            ref["eager"]["tokens_per_s_median"]
        res["unsharded_eager_host_ms_per_step"] = \
            ref["eager"]["host_ms_per_step"]
    if not quant:
        res["profile"] = mesh_profile_pass(torch, sharded, prompts)
        skew_eng = sharded(profile=True, profile_sample_steps=1)
        skew_eng.generate(prompts[:MESH_SKEW_REQUESTS], 16)
        sk = skew_eng._profiling.statusz()["chip_skew_seconds"]
        if not sk or sk["probes"] <= 0:
            fail(f"{label}: no chip skew recorded on probed steps")
        res["chip_skew_seconds"] = sk
    print(f"{label}: " + json.dumps(res), flush=True)
    res["tokens"] = None
    return res


def mesh_phase(torch, ragged):
    """(a) mp=2 in f32 on K1 and (b) with int8 KV pages and weights on
    K2 (`mesh_case`), on the backend the mesh's rule picks: gloo and
    eager steps on one card, NCCL and captured steps where every rank
    has a card (which is part (d)); (c) mp=1 on NCCL, captured: one
    graph, its all-reduces recorded inside it, the unsharded captured
    serve's tokens exactly; (d) also mp=4 f32 where the machine has four
    cards.  A part the machine cannot run prints a skip line."""
    from paddle_tpu_torch.tools import serve_profile

    out = {}
    n_dev = torch.cuda.device_count()
    int8 = dict(kv_quant="int8", serve_weights="int8")
    out["mp2_f32"] = mesh_case(torch, "mesh serve mp=2 f32", "mp=2", {},
                               "K1", ragged["f32"])
    out["mp2_int8"] = mesh_case(torch, "mesh serve mp=2 int8", "mp=2", int8,
                                "K2", ragged["int8"])

    # (c) mp=1 on NCCL, captured
    model, prompts, new_engine = serve_profile.gpt2_small_serve(
        "cuda", ragged_step=True)
    label = "mesh serve mp=1 nccl"
    mesh = new_engine(serve_mesh="mp=1")._mesh
    if mesh.backend != "nccl" or not mesh.capturable:
        fail(f"{label}: backend {mesh.backend}, want nccl, captured")
    captured = [0]
    real = mesh.all_reduce

    def counted(t):
        if torch.cuda.is_current_stream_capturing():
            captured[0] += 1
        return real(t)

    mesh.all_reduce = counted
    try:
        eng, st, counts, res = drive_serve(
            torch, lambda **kw: new_engine(serve_mesh="mp=1", **kw),
            prompts, model.cfg, label, compiles(ragged=1))
        profile = mesh_profile_pass(
            torch, lambda **kw: new_engine(serve_mesh="mp=1", **kw),
            prompts)
    finally:
        del mesh.all_reduce
    want = 2 * model.cfg.num_layers
    # one capture of the ragged step a serve: drive_serve's serves and
    # the disarmed twin, then the profile pass's engine
    serves = SERVE_RUNS + 2
    if captured[0] != want * serves:
        fail(f"{label}: {captured[0]} all-reduces recorded inside "
             f"captures, want {want} a graph x {serves} engines")
    if res["tokens"] != ragged["f32"]["tokens"]:
        fail(f"{label}: tokens differ from the unsharded captured ragged "
             f"serve's")
    res.update(backend=mesh.backend, all_reduces_in_graph=want,
               profile=profile, tokens_equal_to_unsharded=True)
    print(f"{label}: captured, {res['graphs']} graph(s), {want} "
          f"all-reduces inside each; " + printable(res), flush=True)
    res["tokens"] = None
    out["mp1_nccl"] = res

    # (d) NCCL with a card a rank
    for mp in (2, 4):
        if n_dev < mp:
            print(f"mesh serve mp={mp} nccl: skipped, {n_dev} card(s) on "
                  f"this machine (NCCL needs a card a rank)", flush=True)
        elif mp == 2:
            print("mesh serve mp=2 nccl: parts (a) and (b) above ran on "
                  "NCCL, captured", flush=True)
        else:
            out["mp4_f32"] = mesh_case(torch, "mesh serve mp=4 f32",
                                       "mp=4", {}, "K1", ragged["f32"])
    return out


# ---------------------------------------------------------------------------
# phase 16: the fleet on the card
# ---------------------------------------------------------------------------
FLEET_ROOT = Path("build") / "chip_smoke_fleet"
# replica pairs, each on fresh child processes: round robin and affinity
# over the same waves, the 16 prompts at once (tokens/s), and the chaos
# pair (journals at fsync=always, FLAGS_fleet_trace on)
FLEET_PAIRS = {"rr": "plain", "af": "plain", "tp": "plain", "ch": "chaos"}
FLEET_BEFORE_KILL = 6   # chaos: streams in flight at the kill
FLEET_AFTER_KILL = 4    # chaos: requests submitted after it
FLEET_BOOT_S = 300      # a child's budget to announce its ports
FLEET_STREAM_S = 300    # a stream's budget to finish
FLEET_POLL_S = 0.005    # the chaos leg's watch of its streams
DEBUG_FLAGS = {"sanitize": True, "kv_pool_debug": True}


def fleet_child(argv) -> int:
    """``--fleet-child NAME MODE``: one replica of phase 16 — GPT-2-small
    (`serve_profile.gpt2_small_serve`, seed 0, on ``cuda`` exactly as
    the engine resolves it) behind an `EdgeServer`, its ops server and
    the edge on ephemeral ports of 127.0.0.1, steps captured.  MODE
    "chaos" arms a journal at ``fsync=always`` under `FLEET_ROOT` and
    FLAGS_fleet_trace.  Prints ``FLEET_CHILD name=.. edge=.. ops=..``,
    serves until its standard input closes, and on SIGTERM drains, writes
    its engine's report (K1 launches, steps, compiles, graphs, retraces,
    adoptions) to ``FLEET_ROOT/NAME.json`` and exits 0."""
    import os
    import signal

    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.fleet import EdgeServer
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.observability import opsserver
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.tools import serve_profile

    name, mode = argv
    chaos = mode == "chaos"
    if chaos:
        flags.set_flags({"fleet_trace": True, "journal_fsync": "always"})
    _, _, new_engine = serve_profile.gpt2_small_serve("cuda")
    serving.reset_decode_stats()  # the warm-up engine's counts
    pa.paged_attention_cuda.launches = 0
    eng = new_engine(journal_dir=str(FLEET_ROOT / name) if chaos else None)
    ops = opsserver.start_ops_server(port=0, host="127.0.0.1")
    edge = EdgeServer(eng)
    port = edge.start()

    def report(_sig, _frame):
        edge.close(drain=True)
        e = edge.frontend.engine
        st, pst = e.decode_stats(), serving.decode_stats()
        (FLEET_ROOT / f"{name}.json").write_text(json.dumps(dict(
            k1_launches=pa.paged_attention_cuda.launches,
            k2_launches=pa.paged_attention_cuda_q.launches,
            steps=st["steps"], graphs=e.graph_captures(),
            compiles={k: pst[k] for k in COMPILE_KEYS},
            retraces={k: v for k, v in pst.items()
                      if k.endswith("_retraces")
                      or k == "retraces_after_warmup"},
            adoptions=pst["adoptions"], tokens=st["tokens"],
            num_layers=len(e._params["blocks"]),
            same_engine=e is eng, journal=e.journal_info())))
        os._exit(0)

    signal.signal(signal.SIGTERM, report)
    print(f"FLEET_CHILD name={name} edge={port} ops={ops}", flush=True)
    sys.stdin.read()  # the parent went away
    return 0


class _Replica:
    """A replica child process of phase 16 and its ports."""

    def __init__(self, name, mode):
        self.name = name
        FLEET_ROOT.mkdir(parents=True, exist_ok=True)
        self.err = FLEET_ROOT / f"{name}.err"
        with open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--fleet-child", name, mode],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
                text=True)
        self.edge = self.ops = None

    def wait_ports(self, deadline):
        import threading

        box = []
        t = threading.Thread(target=lambda: box.append(
            self.proc.stdout.readline()), daemon=True)
        t.start()
        t.join(max(deadline - time.monotonic(), 1.0))
        line = box[0] if box else ""
        if not line.startswith("FLEET_CHILD "):
            self.stop()
            fail(f"fleet: replica {self.name} never announced its ports "
                 f"(exit {self.proc.poll()}):\n{self.tail()}")
        kv = dict(f.split("=", 1) for f in line.split()[1:])
        self.edge, self.ops = int(kv["edge"]), int(kv["ops"])
        # keep the pipe drained: a child never blocks on its stdout
        threading.Thread(target=self.proc.stdout.read, daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.edge}"

    def tail(self):
        try:
            return self.err.read_text()[-3000:]
        except OSError:
            return ""

    def report(self):
        """SIGTERM the child and read the report it writes."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.stop()
            fail(f"fleet: replica {self.name} did not exit on SIGTERM")
        path = FLEET_ROOT / f"{self.name}.json"
        if rc != 0 or not path.exists():
            fail(f"fleet: replica {self.name} exited {rc} without its "
                 f"report:\n{self.tail()}")
        return json.loads(path.read_text())

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
        if self.proc.stdin:
            self.proc.stdin.close()


def fleet_waves(n):
    """Phase 4's prompts as waves of two: shared-prefix prompt i (even)
    with the prompt after it, the shared one first in even waves and
    second in odd ones, so round robin cannot pin the family to one
    replica by the parity of its arrival."""
    waves = []
    for w, i in enumerate(range(0, n, 2)):
        waves.append([i, i + 1] if w % 2 == 0 else [i + 1, i])
    return waves


def fleet_router(policy, reps, **kw):
    from paddle_tpu_torch.fleet import FleetRouter

    router = FleetRouter(policy=policy, poll_interval_s=0.02, dead_after=3,
                         admit_timeout_s=FLEET_STREAM_S, rollup_every=5,
                         **kw)
    for rep in reps:
        router.add_replica(rep.name, rep.url)
    router.start()
    return router


def prefix_counts(reps):
    """Fleet-wide prefix-cache page (hits, misses) off each replica's
    /metrics."""
    import urllib.request

    hits = misses = 0.0
    for rep in reps:
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{rep.ops}/metrics", timeout=30).read().decode()
        for line in text.splitlines():
            if line.startswith("paddle_prefix_cache_page_hits_total"):
                hits += float(line.rsplit(None, 1)[1])
            elif line.startswith("paddle_prefix_cache_page_misses_total"):
                misses += float(line.rsplit(None, 1)[1])
    return hits, misses


def fleet_results(label, streams, want):
    """Wait for ``streams``; fail unless each finished eos/length with
    phase 4's tokens for its prompt."""
    for s in streams:
        try:
            toks = s.result(timeout=FLEET_STREAM_S)
        except Exception as e:  # a stream's own error, or a timeout
            fail(f"{label}: a stream failed: {e!r}")
        if s.finish_reason not in ("eos", "length"):
            fail(f"{label}: a stream finished {s.finish_reason!r}")
        if toks != want[tuple(s.prompt_ids)]:
            fail(f"{label}: a stream's tokens differ from phase 4's for "
                 f"its prompt")


def check_replica_report(label, rep, rpt):
    """(c) for any replica: K1 launched num_layers x steps, no retrace,
    one graph a compile, nothing on K2."""
    want = rpt["num_layers"] * rpt["steps"]
    if rpt["steps"] <= 0 or rpt["k1_launches"] != want:
        fail(f"{label} {rep.name}: K1 launches {rpt['k1_launches']} != "
             f"{rpt['num_layers']} x {rpt['steps']} steps")
    if rpt["k2_launches"]:
        fail(f"{label} {rep.name}: K2 launched {rpt['k2_launches']} times")
    if any(rpt["retraces"].values()):
        fail(f"{label} {rep.name}: retraced: {rpt['retraces']}")
    if rpt["graphs"] != sum(rpt["compiles"].values()) or \
            rpt["compiles"] != compiles(decode=1, mixed=1):
        fail(f"{label} {rep.name}: {rpt['graphs']} graphs for the "
             f"compiles {rpt['compiles']} (want one mixed and one decode "
             f"graph: adopted requests replay them)")
    if not rpt["same_engine"]:
        fail(f"{label} {rep.name}: the frontend rebuilt the engine")


def _fleet_json(url, path):
    status, body = _get(url, path)
    if status != 200:
        fail(f"fleet: GET {url}{path} -> {status}: {body[:500]}")
    return json.loads(body)


def affinity_leg(prompts, want, pairs, engine_run_tps):
    """(a) the waves of `fleet_waves` through a round-robin and an
    affinity router, each on a fresh pair: every stream phase 4's
    tokens, and the fleet-wide prefix-cache page hit rate (from the
    replicas' /metrics) strictly higher under affinity; then the 16
    prompts at once through the affinity router on a third fresh pair,
    tokens/s against phase 4's ``engine.run``."""
    from paddle_tpu_torch.tools.serve_profile import NEW_TOKENS as NEW

    out = {}
    for policy, key in (("round_robin", "rr"), ("affinity", "af")):
        reps = pairs[key]
        h0, m0 = prefix_counts(reps)
        router = fleet_router(policy, reps)
        t0 = time.perf_counter()
        try:
            streams = []
            for wave in fleet_waves(len(prompts)):
                got = [router.submit(prompts[i], max_new_tokens=NEW)
                       for i in wave]
                fleet_results(f"fleet {policy}", got, want)
                streams += got
        finally:
            router.close()
        wall = time.perf_counter() - t0
        h1, m1 = prefix_counts(reps)
        hits, misses = h1 - h0, m1 - m0
        out[policy] = dict(
            prefix_page_hits=hits, prefix_page_misses=misses,
            prefix_hit_rate=hits / (hits + misses) if hits + misses else 0.0,
            router_affinity_hits=router.stats["affinity_hits"],
            placement=[s.replica for s in streams],
            tokens_per_s=sum(len(s.tokens) for s in streams) / wall,
            wall_s=wall)
        print(f"fleet {policy}: prefix-cache page hit rate "
              f"{out[policy]['prefix_hit_rate']:.4f} ({hits:.0f} hits, "
              f"{misses:.0f} misses over {len(streams)} requests in waves "
              f"of 2); {out[policy]['tokens_per_s']:.1f} tokens/s; tokens "
              f"equal phase 4's", flush=True)
    if not out["affinity"]["prefix_hit_rate"] > \
            out["round_robin"]["prefix_hit_rate"]:
        fail(f"fleet: affinity's prefix hit rate "
             f"{out['affinity']['prefix_hit_rate']:.4f} is not above round "
             f"robin's {out['round_robin']['prefix_hit_rate']:.4f}")
    # the 16 at once, as phase 4's engine.run serves them
    reps = pairs["tp"]
    router = fleet_router("affinity", reps)
    try:
        t0 = time.perf_counter()
        streams = [router.submit(p, max_new_tokens=NEW) for p in prompts]
        fleet_results("fleet throughput", streams, want)
        wall = time.perf_counter() - t0
    finally:
        router.close()
    tps = sum(len(s.tokens) for s in streams) / wall
    ttft = [s.ttft_s for s in streams]
    out["at_once"] = dict(
        tokens_per_s=tps, wall_s=wall, engine_run_tokens_per_s=engine_run_tps,
        ratio=tps / engine_run_tps, ttft_p50_s=quantile(ttft, 0.5),
        ttft_p99_s=quantile(ttft, 0.99),
        placement=[s.replica for s in streams])
    print(f"fleet at once: 16 requests over 2 replicas on one card "
          f"(affinity) {tps:.1f} tokens/s against engine.run's "
          f"{engine_run_tps:.1f} ({tps / engine_run_tps:.3f}x), TTFT p50 "
          f"{quantile(ttft, 0.5) * 1e3:.1f} ms p99 "
          f"{quantile(ttft, 0.99) * 1e3:.1f} ms; tokens equal phase 4's",
          flush=True)
    return out


def _alertz_names(ops_port, victim, deadline):
    """The parent's /alertz fleet rollup once it reports ``victim``
    unreachable and narrates its failover (the monitor refreshes it every
    few polls)."""
    while True:
        doc = _fleet_json(f"http://127.0.0.1:{ops_port}", "/alertz")
        roll = doc.get("fleet") or {}
        rep = (roll.get("replicas") or {}).get(victim)
        if rep is not None and not rep.get("reachable") and any(
                e.get("event") == "failover" and e.get("replica") == victim
                for e in roll.get("events", [])):
            return roll
        if time.monotonic() > deadline:
            fail(f"fleet chaos: /alertz's fleet rollup never named the "
                 f"dead replica {victim}: {json.dumps(roll)[:1500]}")
        time.sleep(0.05)


def _one_lane(doc, victim, survivor):
    """The merged trace of a `/fleetz?trace=` document puts the trace on
    one requests lane, with spans from both replicas."""
    ev = doc["trace"]["traceEvents"]
    names = {e["pid"]: e["args"]["name"] for e in ev
             if e.get("name") == "process_name"}
    lane = [e for e in ev if e.get("ph") == "X"
            and names.get(e["pid"]) == "requests"]
    lanes = {(e["pid"], e["tid"]) for e in lane}
    return len(lanes) == 1 and \
        {e["args"].get("replica") for e in lane} == {victim, survivor}


def chaos_leg(prompts, want, reps):
    """(b) six streams in flight through the affinity router over the
    chaos pair; once every one has a token and none has finished, SIGKILL
    the replica holding the most, then submit four more: the victim died
    by SIGKILL, FLAGS_fleet_trace held throughout, every stream phase 4's
    tokens (nothing re-emitted or dropped), a failover counted, the
    parent's /alertz rollup naming the dead replica, and each migrated
    request on one lane of ``/fleetz?trace=`` across both replicas."""
    import signal

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.inference import durability
    from paddle_tpu_torch.observability import opsserver
    from paddle_tpu_torch.tools.serve_profile import NEW_TOKENS as NEW

    flags.set_flags({"fleet_trace": True})
    ops_port = opsserver.start_ops_server(port=0, host="127.0.0.1")
    router = fleet_router("affinity", reps)
    try:
        streams = [router.submit(p, max_new_tokens=NEW)
                   for p in prompts[:FLEET_BEFORE_KILL]]
        deadline = time.monotonic() + FLEET_STREAM_S
        while not all(s.tokens for s in streams):
            if any(s.done for s in streams):
                fail("fleet chaos: a stream finished before every stream "
                     "had a token: no moment to kill mid-generation")
            if time.monotonic() > deadline:
                fail("fleet chaos: the streams never all started")
            time.sleep(FLEET_POLL_S)
        if any(s.done for s in streams):
            fail("fleet chaos: a stream finished before the kill")
        by_rep = {}
        for s in streams:
            by_rep.setdefault(s.replica, []).append(s)
        victim = max(by_rep, key=lambda n: len(by_rep[n]))
        survivor = next(r.name for r in reps if r.name != victim)
        held = {id(s): len(s.tokens) for s in by_rep[victim]}
        # the victim's segment of each trace it serves, pulled while it
        # lives: /fleetz keeps a dead replica's last pull in its merge
        for s in by_rep[victim]:
            _fleet_json(f"http://127.0.0.1:{ops_port}",
                        f"/fleetz?trace={s.trace_id}")
        proc = next(r for r in reps if r.name == victim).proc
        t_kill = time.perf_counter()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
        fleet_results("fleet chaos", streams, want)
        kill_to_complete = time.perf_counter() - t_kill
        late = [router.submit(p, max_new_tokens=NEW) for p in
                prompts[FLEET_BEFORE_KILL:FLEET_BEFORE_KILL +
                        FLEET_AFTER_KILL]]
        fleet_results("fleet chaos (after the kill)", late, want)
        if proc.returncode != -signal.SIGKILL:
            fail(f"fleet chaos: the victim exited {proc.returncode}, not "
                 f"by SIGKILL")
        if not flags.flag("fleet_trace") or any(
                s.trace_id is None for s in streams + late):
            fail("fleet chaos: FLAGS_fleet_trace was not on throughout")
        clocks = {r.name: router._replicas[r.name]._clock.snapshot()
                  for r in reps}
        if not all(clocks.values()):
            fail(f"fleet chaos: a replica's /readyz never carried now_ns "
                 f"(FLAGS_fleet_trace off in the child): {clocks}")
        migrated = [s for s in by_rep[victim] if s.failovers]
        if not migrated or any(len(s.tokens) < held[id(s)]
                               for s in by_rep[victim]):
            fail("fleet chaos: no stream migrated, or one lost a token it "
                 "held")
        failovers = obs.FLEET_FAILOVERS.value()
        if failovers < 1:
            fail(f"fleet chaos: paddle_fleet_failovers_total {failovers}")
        roll = _alertz_names(ops_port, victim,
                             time.monotonic() + FLEET_STREAM_S)
        for s in migrated:
            doc = _fleet_json(f"http://127.0.0.1:{ops_port}",
                              f"/fleetz?trace={s.trace_id}")
            if not _one_lane(doc, victim, survivor):
                fail(f"fleet chaos: /fleetz?trace={s.trace_id} does not "
                     f"put the migrated request on one lane across "
                     f"{victim} and {survivor}")
        survivor_info = _fleet_json(
            next(r.url for r in reps if r.name == survivor), "/v1/info")
        victim_journal = FLEET_ROOT / victim / durability.JOURNAL_NAME
        ttft1 = [s.ttft_s for s in streams]
        ttft2 = [s.ttft_s for s in late]
        out = dict(
            victim=victim, survivor=survivor,
            streams_on_victim=len(by_rep[victim]),
            streams_migrated=len(migrated),
            tokens_held_at_kill=sorted(held.values()),
            failovers=failovers,
            failover_s=router.stats["failover_seconds"],
            kill_to_all_complete_s=kill_to_complete,
            ttft_p50_before_kill_s=quantile(ttft1, 0.5),
            ttft_p99_before_kill_s=quantile(ttft1, 0.99),
            ttft_p99_after_kill_s=quantile(ttft2, 0.99),
            survivor_journal=survivor_info["journal"],
            victim_journal_bytes=victim_journal.stat().st_size,
            victim_journal_records=len(durability.read_journal(
                str(victim_journal))[0]),
            clock_offsets_ns={r.name: router._replicas[r.name]
                              .clock_offset_ns() for r in reps},
            poll_rtt_s={r.name: router._replicas[r.name].poll_rtt_s
                        for r in reps},
            rollup_events=roll.get("events", [])[-4:])
    finally:
        router.close()
        opsserver.stop_ops_server()
        flags.set_flags({"fleet_trace": False})
    j = out["survivor_journal"]
    print(f"fleet chaos: killed {victim} (SIGKILL) with "
          f"{out['streams_on_victim']} streams on it holding "
          f"{out['tokens_held_at_kill']} tokens; {len(migrated)} migrated "
          f"to {survivor}, failover {out['failover_s']:.4f} s, kill to all "
          f"complete {kill_to_complete:.4f} s; TTFT p50 "
          f"{out['ttft_p50_before_kill_s'] * 1e3:.1f} ms p99 "
          f"{out['ttft_p99_before_kill_s'] * 1e3:.1f} ms before the kill, "
          f"p99 {out['ttft_p99_after_kill_s'] * 1e3:.1f} ms after; "
          f"survivor journal {j['records']} records {j['bytes']} bytes "
          f"(fsync {j['fsync']}), victim journal "
          f"{out['victim_journal_records']} records "
          f"{out['victim_journal_bytes']} bytes; clock offsets "
          f"{out['clock_offsets_ns']} ns, poll RTT {out['poll_rtt_s']}; "
          f"every stream phase 4's tokens, one lane a migrated trace",
          flush=True)
    return out


def debug_modes_check(torch, new_engine, prompts, want_tokens):
    """(d) the captured f32 serve under FLAGS_sanitize and
    FLAGS_kv_pool_debug, `SERVE_RUNS` times in turns with unarmed serves:
    each armed serve phase 4's tokens, no SanitizerError, a host sync a
    step (the relation the CPU test holds to JAX's), a lock-order graph
    without a cycle, the pool audited each step; host ms a step armed
    against unarmed (medians), with the collector's passes by generation
    during each serve."""
    import gc

    from paddle_tpu_torch.analysis import sanitizer
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.inference import serving

    audits = [0]
    real = serving.KVBlockPool.assert_consistent

    def counted(pool, live_pages=None):
        audits[0] += 1
        return real(pool, live_pages)

    def passes():
        return [g["collections"] for g in gc.get_stats()]

    runs = {"unarmed": [], "armed": []}
    for label in ("unarmed", "armed") * SERVE_RUNS:
        armed = label == "armed"
        if armed:
            flags.set_flags(DEBUG_FLAGS)
            sanitizer.reset()
            audits[0] = 0
            serving.KVBlockPool.assert_consistent = counted
        gc0 = passes()
        try:
            eng, reqs, wall = serve_once(torch, new_engine, prompts)
        except sanitizer.SanitizerError as e:
            fail(f"debug modes: the serve raised {e!r}")
        finally:
            if armed:
                serving.KVBlockPool.assert_consistent = real
                flags.set_flags({k: False for k in DEBUG_FLAGS})
        steps = eng.decode_stats()["steps"]
        if [r.generated_ids for r in reqs] != want_tokens:
            fail(f"debug modes ({label}): tokens differ from phase 4's")
        run = dict(steps=steps, wall_s=wall,
                   host_ms_per_step=wall / steps * 1e3,
                   gc_passes=[b - a for a, b in zip(gc0, passes())])
        if armed:
            rep = sanitizer.get().report()
            edges = {tuple(e) for e in rep["lock_edges"]}
            if rep["steps"] != steps or rep["host_syncs"] != steps or \
                    rep["warm_retraces"]:
                fail(f"debug modes: sanitizer report {rep} against "
                     f"{steps} steps (want a host sync a step)")
            if any((b, a) in edges for a, b in edges):
                fail(f"debug modes: lock-order cycle in {sorted(edges)}")
            if audits[0] != steps:
                fail(f"debug modes: {audits[0]} pool audits for {steps} "
                     f"steps")
            run.update(report=rep, pool_audits=audits[0])
        runs[label].append(run)
    med = {k: statistics.median(r["host_ms_per_step"] for r in v)
           for k, v in runs.items()}
    out = dict(runs=runs, host_ms_per_step_median=med)
    rep = runs["armed"][-1]["report"]
    print(f"debug modes: FLAGS_sanitize + FLAGS_kv_pool_debug "
          f"{med['armed']:.4f} host ms a step (median of {SERVE_RUNS}) "
          f"against {med['unarmed']:.4f} unarmed (runs, in turns: "
          f"{[round(r['host_ms_per_step'], 4) for r in runs['armed']]} / "
          f"{[round(r['host_ms_per_step'], 4) for r in runs['unarmed']]}; "
          f"collector passes by generation "
          f"{[r['gc_passes'] for r in runs['armed']]} / "
          f"{[r['gc_passes'] for r in runs['unarmed']]}); {rep['steps']} "
          f"steps, {rep['host_syncs']} host syncs, {audits[0]} pool "
          f"audits, lock edges {rep['lock_edges']}; tokens equal phase 4's",
          flush=True)
    return out


def fleet_phase(torch, serve):
    """Phase 16: the fleet on the card (see the module docstring)."""
    import shutil

    from paddle_tpu_torch.tools import serve_profile

    _, prompts, new_engine = serve_profile.gpt2_small_serve("cuda")
    want = {tuple(p): t for p, t in zip(prompts, serve["tokens"])}
    shutil.rmtree(FLEET_ROOT, ignore_errors=True)
    FLEET_ROOT.mkdir(parents=True)
    t0 = time.perf_counter()
    pairs = {key: [_Replica(f"{key}{i}", mode) for i in range(2)]
             for key, mode in FLEET_PAIRS.items()}
    reps = [r for pair in pairs.values() for r in pair]
    out = {}
    try:
        deadline = time.monotonic() + FLEET_BOOT_S
        for rep in reps:
            rep.wait_ports(deadline)
        out["boot_s"] = time.perf_counter() - t0
        print(f"fleet: {len(reps)} replica processes on cuda:0 up in "
              f"{out['boot_s']:.1f} s", flush=True)
        out["affinity"] = affinity_leg(prompts, want, pairs,
                                       serve["tokens_per_s_median"])
        out["chaos"] = chaos_leg(prompts, want, pairs["ch"])
        reports = {}
        for rep in reps:
            if rep.proc.poll() is None:
                reports[rep.name] = rpt = rep.report()
                check_replica_report("fleet", rep, rpt)
        survivor = reports[out["chaos"]["survivor"]]
        if survivor["adoptions"] < 1:
            fail("fleet chaos: the survivor adopted nothing")
        out["replica_reports"] = reports
        print(f"fleet: the survivor {out['chaos']['survivor']} ran "
              f"{survivor['steps']} steps, K1 {survivor['k1_launches']} = "
              f"{survivor['num_layers']} x steps, {survivor['graphs']} "
              f"graphs for compiles {sum(survivor['compiles'].values())}, "
              f"no retrace, {survivor['adoptions']} adoption(s); every "
              f"replica's K1 = num_layers x steps", flush=True)
    finally:
        for rep in reps:
            rep.stop()
    out["debug_modes"] = debug_modes_check(torch, new_engine, prompts,
                                           serve["tokens"])
    return out


# ---------------------------------------------------------------------------
# phase 17: eager train and generate
# ---------------------------------------------------------------------------
EAGER_ROOT = Path("build") / "chip_smoke_eager"
EAGER_STEPS = 10
# steps of the dygraph loop and of TrainStep taken in turns after both
# loops, for the time comparison (the first mover alternates)
EAGER_TURNS = 6
EAGER_DROPOUT_STEPS = 6
EAGER_FIT_STEPS = 3
GEN_NEW_TOKENS = 32
# the eager loop against jit.TrainStep (and fit against it): the same
# torch ops on the same inputs in the same order, so the losses should be
# bit-equal (printed); the gate allows 1e-4 of a ~10.8 loss in case a
# library reduction sums in another order between two calls
EAGER_LOSS_TOL = 1e-4


def eager_recipe(model, lr_peak=3e-4):
    """The dygraph loop's optimizer: AdamW (weight decay 0.01) over
    `LinearWarmup(CosineAnnealingDecay(lr_peak, T_max=100), 10, 0,
    lr_peak)` with `ClipGradByGlobalNorm(1.0)`."""
    from paddle_tpu_torch import nn, optimizer

    sched = optimizer.lr.LinearWarmup(optimizer.lr.CosineAnnealingDecay(
        lr_peak, T_max=100), 10, 0.0, lr_peak)
    opt = optimizer.AdamW(sched, parameters=model.parameters(),
                          weight_decay=0.01,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0))
    return sched, opt


def eager_step(torch, model, opt, sched, x, y):
    """One step of the dygraph loop; returns the detached loss."""
    from paddle_tpu_torch import amp, nn

    with amp.auto_cast(dtype="bfloat16"):
        logits = model(x)
    loss = nn.functional.cross_entropy(logits, y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    sched.step()
    return loss.detach()


def _timed_steps(torch, run, batches):
    """``run(x, y)`` over ``batches``, each step synchronized; returns
    ``(losses, step seconds)``."""
    losses, times = [], []
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(run(x, y))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return [float(v) for v in losses], times


def _bits_equal(a, b):
    return [float(x) for x in a] == [float(x) for x in b]


def eager_vs_train_step(torch, tp, cfg, batches):
    """(a) GPT-2-small from `train_profile`'s weights, the dygraph loop
    for `EAGER_STEPS` steps against `jit.TrainStep` with the same recipe
    from the same weights on the same batches: losses, K3/K4 launches
    12 x steps each, one recorded step's attention against the plain
    versions, ms a step and peak memory of each loop; then `EAGER_TURNS`
    more steps of each in turns, whose medians compare the two.  Returns
    ``(result, the live eager model, its optimizer and scheduler)``."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.nn.functional import attention as attn_mod
    from paddle_tpu_torch.ops import flash_attention as fa

    model = GPT.random(cfg, seed=tp.SEED, device="cuda")
    sched, opt = eager_recipe(model)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with FlashRecorder(attn_mod) as rec:
        eager, eager_t = _timed_steps(
            torch, lambda x, y: eager_step(torch, model, opt, sched, x, y),
            batches)
    counts = read_counts()
    eager_peak = torch.cuda.max_memory_allocated() - base
    want = cfg.num_layers * len(batches)
    if any(counts[k] != want for k in FLASH_KERNELS):
        fail(f"eager loop: K3/K4 launches {counts} != num_layers x steps "
             f"= {want}")
    if any(p.grad is not None for p in model.parameters()):
        fail("eager loop: clear_grad left a gradient")
    if rec.call is None or "dout" not in rec.call:
        fail("eager loop: no attention recorded")
    q, k, v = rec.call["args"]
    errs, ref, _ = flash_errors(torch, fa, q, k, v, rec.call["dout"],
                                rec.call["causal"])
    errs["path_out"] = (rec.call["out"].float() - ref.float()).abs().max(
        ).item()
    tol = dict(FLASH_TOL["bfloat16"], path_out=FLASH_TOL["bfloat16"]["out"])
    if q.dtype != torch.bfloat16 or any(not e <= tol[n]
                                        for n, e in errs.items()):
        fail(f"eager loop: the recorded attention ({q.dtype}) disagrees "
             f"with the plain version: {errs} (tol {tol})")
    del rec

    model2 = GPT.random(cfg, seed=tp.SEED, device="cuda")
    sched2, opt2 = eager_recipe(model2)
    step = jit.train_step(model2, tp.amp_loss_fn, opt2)
    torch.cuda.synchronize()
    base2 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def staged(x, y):
        loss = step(x, y)
        sched2.step()
        return loss

    staged_l, staged_t = _timed_steps(torch, staged, batches)
    staged_peak = torch.cuda.max_memory_allocated() - base2
    runs = {"eager": lambda x, y: eager_step(torch, model, opt, sched, x, y),
            "train_step": staged}
    turns = {k: ([], []) for k in runs}
    for i, batch in enumerate(batches[:EAGER_TURNS]):
        for name in sorted(runs, reverse=bool(i % 2)):
            loss, t = _timed_steps(torch, runs[name], [batch])
            turns[name][0].extend(loss)
            turns[name][1].extend(t)
    eager += turns["eager"][0]
    staged_l += turns["train_step"][0]
    diff = max(abs(a - b) for a, b in zip(eager, staged_l))
    med = statistics.median
    ntok = batches[0][0].numel()
    res = dict(
        steps=len(batches), turns=EAGER_TURNS, losses_eager=eager,
        losses_train_step=staged_l,
        loss_max_abs_diff=diff, bit_equal=_bits_equal(eager, staged_l),
        tol=EAGER_LOSS_TOL, launches=counts,
        step_attention_max_abs_err=errs,
        eager_ms_per_step=med(eager_t[1:]) * 1e3,
        train_step_ms_per_step=med(staged_t[1:]) * 1e3,
        eager_ms_in_turns=med(turns["eager"][1]) * 1e3,
        train_step_ms_in_turns=med(turns["train_step"][1]) * 1e3,
        eager_first_step_ms=eager_t[0] * 1e3,
        eager_tokens_per_s=ntok / med(turns["eager"][1]),
        train_step_tokens_per_s=ntok / med(turns["train_step"][1]),
        eager_peak_memory_bytes_above_start=eager_peak,
        train_step_peak_memory_bytes_above_start=staged_peak,
        weights_and_state_bytes_before_eager=base)
    print("eager (a): " + json.dumps(res), flush=True)
    if not all(math.isfinite(x) for x in eager) or not diff <= \
            EAGER_LOSS_TOL:
        fail(f"eager loop against TrainStep: losses {eager} vs {staged_l} "
             f"(tolerance {EAGER_LOSS_TOL})")

    # K5 on the eager path: one more step of the TrainStep's model,
    # eagerly, with FLAGS_use_pallas_layernorm on (25 LayerNorms)
    from paddle_tpu_torch.core import flags
    flags.set_flags({"use_pallas_layernorm": True})
    try:
        reset_counts()
        eager_step(torch, model2, opt2, sched2, *batches[0])
        torch.cuda.synchronize()
        ln_counts = read_counts()
    finally:
        flags.set_flags({"use_pallas_layernorm": False})
    want_ln = 2 * cfg.num_layers + 1
    if ln_counts["layer_norm"] != want_ln or ln_counts["fwd"] != \
            cfg.num_layers:
        fail(f"eager step with K5: launches {ln_counts}, want "
             f"{want_ln} LayerNorms and {cfg.num_layers} K3")
    res["k5_step_launches"] = ln_counts
    del step, model2, opt2
    return res, (model, opt, sched)


def eager_dropout_check(torch, cfg, batch):
    """(b) The loop at ``dropout=0.1`` from ``GPT(cfg)``'s own init (the
    JAX package's, from `seed`): `EAGER_DROPOUT_STEPS` steps on the fixed
    batch with AdamW(1e-4) and the global-norm clip, three runs (seeds 1,
    1, 2): finite losses that fall, bit-equal under one seed, other
    losses under another."""
    import dataclasses

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.models.gpt import GPT

    dcfg = dataclasses.replace(cfg, dropout=0.1, use_parallel_layers=True)

    def run(seed):
        paddle.seed(seed)
        model = GPT(dcfg, device="cuda")
        opt = optimizer.AdamW(1e-4, parameters=model.parameters(),
                              weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        sched = optimizer.lr.LambdaDecay(1.0, lambda e: 1.0)
        losses = [eager_step(torch, model, opt, sched, *batch)
                  for _ in range(EAGER_DROPOUT_STEPS)]
        return [float(x) for x in losses]

    runs = [run(1), run(1), run(2)]
    res = dict(steps=EAGER_DROPOUT_STEPS, losses_seed1=runs[0],
               losses_seed1_again=runs[1], losses_seed2=runs[2])
    print("eager (b) dropout 0.1: " + json.dumps(res), flush=True)
    if not all(math.isfinite(x) for r in runs for x in r):
        fail("dropout loop: non-finite loss")
    if not runs[0][-1] < runs[0][0]:
        fail(f"dropout loop: the loss did not fall: {runs[0]}")
    if runs[0] != runs[1]:
        fail(f"dropout loop: one seed, two runs, other losses: {runs[0]} "
             f"vs {runs[1]}")
    if runs[0] == runs[2]:
        fail("dropout loop: seeds 1 and 2 gave the same losses")
    return res


def eager_fit_check(torch, tp, cfg, tokens, labels, staged_losses):
    """(c) ``paddle.Model(GPT-2-small).fit`` on a `TensorDataset` of the
    batch, shuffled under the same ``np.random.seed`` as (a)'s loader,
    `EAGER_FIT_STEPS` epochs of one batch, the forward under bf16
    ``amp_configs``: its logged losses against (a)'s TrainStep losses."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io, nn
    from paddle_tpu_torch.hapi import callbacks
    from paddle_tpu_torch.models.gpt import GPT

    logged = []

    class Log(callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            logged.append(logs["loss"])

    model = GPT.random(cfg, seed=tp.SEED, device="cuda")
    _, opt = eager_recipe(model)
    m = paddle.Model(model)
    m.prepare(opt, nn.CrossEntropyLoss(), amp_configs={"dtype": "bfloat16"})
    ds = io.TensorDataset([tokens.cpu().numpy(), labels.cpu().numpy()])
    np.random.seed(SEED)
    m.fit(ds, batch_size=tokens.shape[0], epochs=EAGER_FIT_STEPS,
          shuffle=True, verbose=0, callbacks=[Log()])
    want = staged_losses[:EAGER_FIT_STEPS]
    diff = max(abs(a - b) for a, b in zip(logged, want))
    res = dict(losses=logged, train_step_losses=want, loss_max_abs_diff=diff,
               bit_equal=_bits_equal(logged, want), tol=EAGER_LOSS_TOL)
    print("eager (c) fit: " + json.dumps(res), flush=True)
    if len(logged) != EAGER_FIT_STEPS or not diff <= EAGER_LOSS_TOL:
        fail(f"fit against TrainStep: {logged} vs {want}")
    return res


def eager_save_load_check(torch, cfg, live, batch):
    """(d) ``paddle.save`` the live eager model's and optimizer's
    ``state_dict``, ``paddle.load`` them into another GPT-2-small and
    optimizer: one more step of each pair gives the same loss and the
    same parameters, bit for bit."""
    import shutil

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt import GPT

    model, opt, sched = live
    EAGER_ROOT.mkdir(parents=True, exist_ok=True)
    p, q = str(EAGER_ROOT / "gpt.pdparams"), str(EAGER_ROOT / "gpt.pdopt")
    t0 = time.perf_counter()
    paddle.save(model.state_dict(), p)
    paddle.save(opt.state_dict(), q)
    save_s = time.perf_counter() - t0
    other = GPT.random(cfg, seed=SEED + 7, device="cuda")
    sched2, opt2 = eager_recipe(other)
    t0 = time.perf_counter()
    missing, unexpected = other.set_state_dict(paddle.load(p))
    opt2.set_state_dict(paddle.load(q))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    nbytes = sum((EAGER_ROOT / n).stat().st_size
                 for n in ("gpt.pdparams", "gpt.pdopt"))
    shutil.rmtree(EAGER_ROOT)
    if missing or unexpected:
        fail(f"save/load: missing {missing}, unexpected {unexpected}")
    la = float(eager_step(torch, model, opt, sched, *batch))
    lb = float(eager_step(torch, other, opt2, sched2, *batch))
    same = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  other.parameters()))
    res = dict(loss_live=la, loss_loaded=lb, params_bit_equal=same,
               file_bytes=nbytes, save_s=save_s, load_s=load_s,
               lr_live=opt.get_lr(), lr_loaded=opt2.get_lr())
    print("eager (d) save/load: " + json.dumps(res), flush=True)
    if la != lb or not same or opt.get_lr() != opt2.get_lr():
        fail("save/load: the loaded pair's next step differs from the "
             "live pair's")
    return res


def eager_generate_check(torch, serve):
    """(e) GPT-2-small of phase 4 (the same weights), ``eval()``, greedy
    ``generate`` of `GEN_NEW_TOKENS` over each of phase 4's prompts with
    the concat and the prealloc cache: equal tokens (a parting only at a
    near-tie, `first_parting`), and both equal to phase 4's engine
    tokens; K3 launched num_layers times a concat call (the prompt) and
    never by a prealloc call (masked: the composed form); tokens/s of
    each."""
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools import serve_profile

    model, prompts, _ = serve_profile.gpt2_small_serve("cuda")
    model.eval()
    cfg = model.cfg
    engine_tokens = [list(t[:GEN_NEW_TOKENS]) for t in serve["tokens"]]
    out, res = {}, {}
    for mode in ("concat", "prealloc"):
        toks, k3, wall = [], [], 0.0
        for p in prompts:
            ids = torch.tensor([p], device="cuda")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = model.generate(ids, max_new_tokens=GEN_NEW_TOKENS,
                                 use_cache=mode)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            k3.append(read_counts()["fwd"])
            toks.append(got[0].tolist())
        want = cfg.num_layers if mode == "concat" else 0
        if any(n != want for n in k3):
            fail(f"generate {mode}: K3 launches a call {k3}, want {want}")
        out[mode] = toks
        res[mode] = dict(k3_launches_per_call=want, calls=len(prompts),
                         tokens_per_s=len(prompts) * GEN_NEW_TOKENS / wall,
                         wall_s=wall)
    res["parting_concat_prealloc"] = first_parting(
        torch, model, prompts, out["concat"], out["prealloc"],
        "generate prealloc against concat")
    for mode in ("concat", "prealloc"):
        res[f"parting_engine_{mode}"] = first_parting(
            torch, model, prompts, engine_tokens, out[mode],
            f"generate {mode} against the engine")
    res["tokens_equal"] = out["concat"] == out["prealloc"] == engine_tokens
    print("eager (e) generate: " + json.dumps(res), flush=True)
    return res, model, prompts


def eager_nan_check(torch, model, prompts, serve):
    """(f) ``FLAGS_check_nan_inf``: off, no mode is installed; on, a NaN
    put into the middle block's fc1 bias raises FloatingPointError in the
    forward; on, a captured serve of two prompts (its captures run with
    the mode suspended) gives phase 4's tokens."""
    from paddle_tpu_torch.core import dispatch, flags
    from paddle_tpu_torch.inference.serving import DecodeEngine

    if dispatch.active_mode() is not None:
        fail("check_nan_inf: a mode is installed with the flags off")
    ids = torch.tensor([prompts[1][:64]], device="cuda")
    bias = model.blocks[len(model.blocks) // 2].fc1.bias
    keep = bias.detach()[0].item()
    raised = None
    flags.set_flags({"check_nan_inf": True})
    try:
        with torch.no_grad():
            bias[0] = float("nan")
            try:
                model(ids)
            except FloatingPointError as e:
                raised = str(e)
            bias[0] = keep
        eng = DecodeEngine(model, max_batch_size=8, page_size=64,
                           device="cuda")
        got = eng.generate(prompts[:2], 8)
        graphs = eng.graph_captures()
    finally:
        flags.set_flags({"check_nan_inf": False})
    res = dict(raised=raised, captured_graphs=graphs,
               serve_tokens_equal=[list(t) for t in got] == [
                   list(t[:8]) for t in serve["tokens"][:2]],
               mode_after=dispatch.active_mode() is not None)
    print("eager (f) check_nan_inf: " + json.dumps(res), flush=True)
    if raised is None:
        fail("check_nan_inf: a NaN activation did not raise")
    if graphs < 1 or res["mode_after"]:
        fail(f"check_nan_inf: the captured serve took {graphs} graphs, "
             f"mode left installed {res['mode_after']}")
    if not res["serve_tokens_equal"]:
        fail("check_nan_inf: the serve under the flag gave other tokens")
    return res


def eager_phase(torch, serve):
    """Phase 17: (a)-(f) of the eager train and generate."""
    import numpy as np

    from paddle_tpu_torch import io
    from paddle_tpu_torch.tools import train_profile as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tp.gpt2_small_config()
    tokens, labels = tp.train_batch(cfg, "cuda")
    ds = io.TensorDataset([tokens.cpu().numpy(), labels.cpu().numpy()])
    loader = io.DataLoader(ds, places="cuda", batch_size=tokens.shape[0],
                           shuffle=True)
    np.random.seed(SEED)
    batches = [b for _ in range(EAGER_STEPS) for b in loader]
    card = card_line()
    out = dict(card=card)
    out["eager_vs_train_step"], live = eager_vs_train_step(torch, tp, cfg,
                                                           batches)
    out["save_load"] = eager_save_load_check(torch, cfg, live, batches[0])
    del live
    out["dropout"] = eager_dropout_check(torch, cfg, (tokens, labels))
    out["fit"] = eager_fit_check(torch, tp, cfg, tokens, labels,
                                 out["eager_vs_train_step"][
                                     "losses_train_step"])
    out["generate"], model, prompts = eager_generate_check(torch, serve)
    out["check_nan_inf"] = eager_nan_check(torch, model, prompts, serve)
    a, g = out["eager_vs_train_step"], out["generate"]
    print(f"eager: {a['eager_ms_in_turns']:.2f} ms a step eager against "
          f"{a['train_step_ms_in_turns']:.2f} TrainStep in turns, "
          f"{a['eager_tokens_per_s']:.0f} trained tokens/s, peak "
          f"{a['eager_peak_memory_bytes_above_start'] / 2**30:.2f} GiB above "
          f"the weights; generate {g['concat']['tokens_per_s']:.1f} "
          f"(concat) / {g['prealloc']['tokens_per_s']:.1f} (prealloc) "
          f"tokens/s at batch 1; {card}", flush=True)
    return out


DIST_ROOT = Path("build") / "chip_smoke_dist"
DIST_RANKS = 2
DIST_STEPS = 2
# the data-parallel run (2 ranks x batch 8) against one process on batch
# 16 from the same weights, bf16 AMP: step 1's loss differs only in the
# bf16 rounding of the two half-batch forwards (the same products in
# other tiles), ~1e-5 of a loss of ~10.9, and 1e-3 relative is allowed;
# from step 2 the weights differ by the rounding of gradients averaged
# as two half-batch means against one full-batch mean, which Adam's
# normalized step turns into ~lr-sized moves of near-zero gradients:
# 5e-3 relative
DIST_LOSS_TOL = dict(first=1e-3, rest=5e-3)
# gradient merge (two micro-batches of 8) against the batch-16 step: the
# same bound, for the same reason
STRATEGY_STEPS = 2
# the ten optimizers at GPT-2-small: keywords, the same in both loops
DIST_OPTIMIZERS = {
    "SGD": dict(learning_rate=1e-2),
    "Momentum": dict(learning_rate=1e-2, momentum=0.9),
    "Adagrad": dict(learning_rate=1e-3),
    "Adadelta": dict(learning_rate=1.0),
    "Adamax": dict(learning_rate=2e-3),
    "RMSProp": dict(learning_rate=1e-4),
    "Lamb": dict(learning_rate=1e-3),
    "Lars": dict(learning_rate=1e-2),
    "Ftrl": dict(learning_rate=1e-2),
    "Dpsgd": dict(learning_rate=1e-3, clip=1.0, batch_size=16.0, sigma=1.0),
}
OPT_STEPS = 2
ACP_EPOCHS = 3
PROFILE_RUNS = 3


def dist_adamw(model):
    """bench.py's optimizer: AdamW(1e-4, weight decay 0.01)."""
    from paddle_tpu_torch import optimizer

    return optimizer.AdamW(1e-4, parameters=model.parameters(),
                           weight_decay=0.01)


def dist_rank(out_dir, steps):
    """One rank of 18(a), started by ``paddle.distributed.spawn``:
    ``fleet.init``, ``distributed_model``, ``distributed_optimizer``
    (AdamW) and ``steps`` dygraph steps on this rank's half of the train
    batch; writes ``rank<r>.json``."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools import train_profile as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    t_init = time.perf_counter()
    fleet.init(is_collective=True)
    r, n = fleet.worker_index(), fleet.worker_num()
    init_s = time.perf_counter() - t_init
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = tp.gpt2_small_config()
    tokens, labels = tp.train_batch(cfg, dev)
    per = tokens.shape[0] // n
    x, y = tokens[r * per:(r + 1) * per], labels[r * per:(r + 1) * per]
    model = GPT.random(cfg, seed=tp.SEED, device=dev)
    dp = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(dist_adamw(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times, comm = [], [], []
    for _ in range(steps):
        before = dp.reducer_stats["comm_s"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tp.amp_loss_fn(dp, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        comm.append(dp.reducer_stats["comm_s"] - before)
        g = loss.detach().clone()
        dist.all_reduce(g, op=dist.ReduceOp.AVG)
        losses.append(float(g))
    res = dict(rank=r, world=n, device=str(dev),
               backend=dist.parallel.backend(), launches=read_counts(),
               losses=losses, step_s=times, comm_s=comm,
               reducer=dp.reducer_stats, init_s=init_s,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               tokens_per_rank_step=x.numel())
    (Path(out_dir) / f"rank{r}.json").write_text(json.dumps(res))


def _dygraph_losses(torch, model, opt, loss_fn, batches):
    out = []
    for x, y in batches:
        loss = loss_fn(model, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss.detach()))
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _check_losses(label, got, want):
    rel = [_rel(a, b) for a, b in zip(got, want)]
    if len(got) != len(want) or not all(math.isfinite(x) for x in got) \
            or rel[0] > DIST_LOSS_TOL["first"] or \
            any(e > DIST_LOSS_TOL["rest"] for e in rel[1:]):
        fail(f"{label}: losses {got} against {want} (relative {rel}, "
             f"tolerance {DIST_LOSS_TOL})")
    return rel


def dist_dp_check(torch, tp, cfg, tokens, labels, nranks=DIST_RANKS):
    """(a) ``nranks`` ranks from ``paddle.distributed.spawn`` (the backend
    rule: gloo when they share a card, NCCL with a card a rank) against
    one process on batch 16 from the same weights and data."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.models.gpt import GPT

    model = GPT.random(cfg, seed=tp.SEED, device="cuda")
    opt = dist_adamw(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = _dygraph_losses(torch, model, opt, tp.amp_loss_fn,
                           [(tokens, labels)] * DIST_STEPS)
    torch.cuda.synchronize()
    single_s = (time.perf_counter() - t0) / DIST_STEPS
    del model, opt
    torch.cuda.empty_cache()
    shutil.rmtree(DIST_ROOT, ignore_errors=True)
    DIST_ROOT.mkdir(parents=True)
    t0 = time.perf_counter()
    dist.spawn(dist_rank, args=(str(DIST_ROOT), DIST_STEPS),
               nprocs=nranks)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((DIST_ROOT / f"rank{r}.json").read_text())
             for r in range(nranks)]
    want_launch = cfg.num_layers * DIST_STEPS
    for rk in ranks:
        if any(rk["launches"][k] != want_launch for k in FLASH_KERNELS):
            fail(f"dist rank {rk['rank']}: K3/K4 launches "
                 f"{rk['launches']}, want {want_launch} each")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        fail(f"dist: the ranks' global losses differ: "
             f"{[rk['losses'] for rk in ranks]}")
    rel = _check_losses("dist (a)", ranks[0]["losses"], want)
    med = statistics.median
    step_ms = [med(rk["step_s"][1:]) * 1e3 for rk in ranks]
    comm_ms = [med(rk["comm_s"][1:]) * 1e3 for rk in ranks]
    bytes_step = ranks[0]["reducer"]["bytes"] / DIST_STEPS
    res = dict(backend=ranks[0]["backend"], devices=[rk["device"]
                                                     for rk in ranks],
               ranks=nranks, batch_per_rank=tokens.shape[0] // nranks,
               seq=tokens.shape[1], steps=DIST_STEPS,
               losses=ranks[0]["losses"], single_process_losses=want,
               loss_rel_err=rel, tol=DIST_LOSS_TOL,
               launches_by_rank={rk["rank"]: rk["launches"] for rk in ranks},
               ms_per_step_by_rank=step_ms,
               allreduce_ms_per_step_by_rank=comm_ms,
               allreduce_share=[c / s for c, s in zip(comm_ms, step_ms)],
               bytes_reduced_per_step=bytes_step,
               buckets_per_step=ranks[0]["reducer"]["buckets"] / DIST_STEPS,
               tokens_per_s=tokens.numel() / (max(step_ms) / 1e3),
               single_process_ms_per_step=single_s * 1e3,
               peak_memory_bytes_by_rank=[rk["peak_memory_bytes"]
                                          for rk in ranks],
               init_s=[rk["init_s"] for rk in ranks], spawn_s=spawn_s,
               nccl="ran" if ranks[0]["backend"] == "nccl" else
               f"not run: {torch.cuda.device_count()} card(s), the rule "
               f"gives gloo to ranks that share one")
    res["card"] = card_line()
    print("dist (a) data parallel: " + json.dumps(res), flush=True)
    shutil.rmtree(DIST_ROOT, ignore_errors=True)
    return res


def dist_strategy_check(torch, tp, cfg, tokens, labels):
    """(b) ``fleet.build_train_step`` in this process (world size 1):
    gradient merge ``k_steps=2`` on batch 16 against the batch-16
    ``jit.TrainStep``; recompute on against off: losses, and peak memory
    lower with it."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.sharded_step import \
        ShardedTrainStep
    from paddle_tpu_torch.models.gpt import GPT

    def run(make_step):
        model = GPT.random(cfg, seed=tp.SEED, device="cuda")
        step = make_step(model, dist_adamw(model))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(tokens, labels)) for _ in range(STRATEGY_STEPS)]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del step, model
        torch.cuda.empty_cache()
        return losses, peak

    base_l, base_peak = run(lambda m, o: jit.train_step(m, tp.amp_loss_fn,
                                                        o))
    st = fleet.DistributedStrategy()
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 2, "avg": True}
    fleet.init(is_collective=True, strategy=st)
    gm_l, gm_peak = run(lambda m, o: fleet.build_train_step(
        m, tp.amp_loss_fn, fleet.distributed_optimizer(o)))
    fleet.init(is_collective=True)
    gm_rel = _check_losses("dist (b) gradient merge", gm_l, base_l)
    off_l, off_peak = run(lambda m, o: ShardedTrainStep(
        m, tp.amp_loss_fn, o, recompute=False))
    on_l, on_peak = run(lambda m, o: ShardedTrainStep(
        m, tp.amp_loss_fn, o, recompute=True))
    rc_rel = [_rel(a, b) for a, b in zip(on_l, off_l)]
    res = dict(steps=STRATEGY_STEPS, train_step_losses=base_l,
               gradient_merge_losses=gm_l, gradient_merge_rel_err=gm_rel,
               train_step_peak_bytes=base_peak,
               gradient_merge_peak_bytes=gm_peak,
               recompute_off_losses=off_l, recompute_on_losses=on_l,
               recompute_rel_err=rc_rel,
               recompute_bit_equal=on_l == off_l,
               recompute_off_peak_bytes=off_peak,
               recompute_on_peak_bytes=on_peak,
               recompute_saving=1 - on_peak / off_peak)
    res["card"] = card_line()
    print("dist (b) strategy: " + json.dumps(res), flush=True)
    if any(e > 1e-5 for e in rc_rel) or not on_peak < off_peak:
        fail(f"recompute: losses {on_l} against {off_l}, peak "
             f"{on_peak} against {off_peak}")
    return res


def dist_optimizers_check(torch, tp, cfg, tokens, labels):
    """(c) Each of the ten optimizers, `OPT_STEPS` steps of the dygraph
    loop against ``jit.TrainStep`` from the same weights and generator
    seed: bit-equal, finite losses."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models.gpt import GPT

    out = {}
    batches = [(tokens, labels)] * OPT_STEPS
    for name, kw in DIST_OPTIMIZERS.items():
        runs = {}
        for form in ("eager", "train_step"):
            paddle.seed(SEED)
            model = GPT.random(cfg, seed=tp.SEED, device="cuda")
            opt = getattr(optimizer, name)(parameters=model.parameters(),
                                           **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if form == "eager":
                losses = _dygraph_losses(torch, model, opt, tp.amp_loss_fn,
                                         batches)
            else:
                step = jit.train_step(model, tp.amp_loss_fn, opt)
                losses = [float(step(x, y)) for x, y in batches]
            torch.cuda.synchronize()
            runs[form] = (losses, (time.perf_counter() - t0) / OPT_STEPS)
            del model, opt
        out[name] = dict(eager=runs["eager"][0],
                         train_step=runs["train_step"][0],
                         bit_equal=runs["eager"][0] == runs["train_step"][0],
                         eager_ms_per_step=runs["eager"][1] * 1e3,
                         train_step_ms_per_step=runs["train_step"][1] * 1e3)
        torch.cuda.empty_cache()
    print("dist (c) optimizers: " + json.dumps(dict(out, card=card_line())),
          flush=True)
    bad = [n for n, r in out.items() if not r["bit_equal"] or not all(
        math.isfinite(v) for v in r["eager"])]
    if bad:
        fail(f"optimizers: eager against TrainStep not bit-equal or not "
             f"finite: {bad}")
    return out


def dist_profiler_check(torch, tp, cfg, tokens, labels):
    """(d) ``profiler.profiler()`` around two dygraph steps and a captured
    serve: the table's rows, the chrome trace's host track; a device
    trace of a dygraph step naming K3/K4; a ``RecordEvent``'s cost and
    the captured serve's ms a step with the profiler armed against
    disarmed, in turns."""
    import shutil

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.tools import serve_profile

    root = DIST_ROOT / "profile"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    model = GPT.random(cfg, seed=tp.SEED, device="cuda")
    opt = dist_adamw(model)
    smodel, prompts, new_engine = serve_profile.gpt2_small_serve("cuda")

    def train_steps(n):
        for _ in range(n):
            with profiler.RecordEvent("train.dygraph_step"):
                _dygraph_losses(torch, model, opt, tp.amp_loss_fn,
                                [(tokens, labels)])
                torch.cuda.synchronize()

    trace_path = root / "merged.json"
    with profiler.profiler(profile_path=str(trace_path)):
        train_steps(2)
        eng, _, _ = serve_once(torch, new_engine, prompts)
    table = profiler.summary_string()
    rows = {ln[:40].strip(): int(ln[40:48])
            for ln in table.splitlines()[2:]}
    host = [e for e in json.loads(trace_path.read_text())["traceEvents"]
            if e.get("pid") == 0 and e["ph"] == "X"]
    steps = eng.decode_stats()["steps"]
    serving_rows = {k: v for k, v in rows.items()
                    if k.startswith("serving.")}
    if rows.get("train.dygraph_step") != 2 or not serving_rows or \
            sum(serving_rows.values()) != steps or not host:
        fail(f"profiler: rows {rows}, serve steps {steps}, host events "
             f"{len(host)}")
    profiler.reset_profiler()

    with profiler.trace(str(root / "device")):
        train_steps(1)
    files = list((root / "device").glob("trace_*.json"))
    names = {e.get("name", "") for f in files
             for e in json.loads(f.read_text())["traceEvents"]}
    found = {k: any(f"{k}_kernel" in n for n in names)
             for k in ("fwd", "dkv", "dq")}
    if len(files) != 1 or not all(found.values()):
        fail(f"device trace: {len(files)} files, K3/K4 names found {found}")

    def event_us(armed, n=20000):
        if armed:
            profiler.start_profiler()
        t0 = time.perf_counter()
        for _ in range(n):
            with profiler.RecordEvent("probe"):
                pass
        dt = (time.perf_counter() - t0) / n * 1e6
        if armed:
            profiler.stop_profiler(print_table=False)
            profiler.reset_profiler()
        return dt

    turns = {"armed": [], "disarmed": []}
    for i in range(PROFILE_RUNS):
        for label in sorted(turns, reverse=bool(i % 2)):
            if label == "armed":
                profiler.start_profiler()
            e, _, wall = serve_once(torch, new_engine, prompts)
            if label == "armed":
                profiler.stop_profiler(print_table=False)
                profiler.reset_profiler()
            turns[label].append(wall / e.decode_stats()["steps"] * 1e3)
    med = statistics.median
    res = dict(rows=rows, host_events=len(host),
               serving_rows=serving_rows, serve_steps=steps,
               device_trace_kernels=found,
               record_event_us_armed=event_us(True),
               record_event_us_disarmed=event_us(False),
               serve_ms_per_step_armed=turns["armed"],
               serve_ms_per_step_disarmed=turns["disarmed"],
               armed_cost_ms_per_step=med(turns["armed"])
               - med(turns["disarmed"]),
               host_buffer_cap=tracing.MAX_HOST_EVENTS)
    res["card"] = card_line()
    print("dist (d) profiler: " + json.dumps(res), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return res


def acp_child(argv) -> int:
    """``--acp-child DIR JOB MODE``: one life of 18(e).  GPT-2-small at
    ``dropout=0.1`` from ``GPT(cfg)``'s init under ``paddle.seed`` and
    AdamW under ``train_epoch_range(ACP_EPOCHS)``, one dygraph step an
    epoch; MODE "pause" stops at the start of epoch 2 (epoch 1 saved),
    writes ``paused`` and waits to be killed; "run" trains to the end and
    saves its parameters to ``final.pdparams``."""
    import dataclasses
    import os

    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as acp
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools import train_profile as tp

    root, job, mode = argv
    os.environ.update(PADDLE_RUNNING_ENV="PADDLE_EDL_AUTO_CHECKPOINT",
                      PADDLE_JOB_ID=job, PADDLE_EDL_CHECKPOINT_DIR=root)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(tp.gpt2_small_config(), dropout=0.1,
                              use_parallel_layers=True)
    tokens, labels = tp.train_batch(cfg, "cuda")
    paddle.seed(SEED + (0 if mode == "pause" or job == "unbroken" else 5))
    model = GPT(cfg, device="cuda")
    opt = dist_adamw(model)
    acp.register(model=model, optimizer=opt)
    d = Path(root) / job
    ran, losses = [], []
    for epoch in acp.train_epoch_range(ACP_EPOCHS):
        if mode == "pause" and epoch == 2:
            (d / "paused").write_text("1")
            time.sleep(600)
        ran.append(epoch)
        losses += _dygraph_losses(torch, model, opt, tp.amp_loss_fn,
                                  [(tokens, labels)])
    paddle.save(model.state_dict(), str(d / "final.pdparams"))
    (d / "ran.json").write_text(json.dumps(dict(epochs=ran, losses=losses)))
    return 0


def dist_acp_check(torch):
    """(e) A child killed with SIGKILL after epoch 1 of
    ``train_epoch_range``, restarted from another seed and init, resumes
    at epoch 2 and ends with an unbroken run's parameters, bit for bit
    (both children run at once: the unbroken one and the one killed)."""
    import shutil
    import signal

    import paddle_tpu_torch as paddle

    root = DIST_ROOT / "acp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    me = [sys.executable, str(Path(__file__).resolve()), "--acp-child",
          str(root)]
    t0 = time.perf_counter()
    unbroken = subprocess.Popen(me + ["unbroken", "run"],
                                stderr=subprocess.PIPE, text=True)
    victim = subprocess.Popen(me + ["job", "pause"], stderr=subprocess.PIPE,
                              text=True)
    paused = root / "job" / "paused"
    deadline = time.monotonic() + 600
    while not paused.exists() and victim.poll() is None and \
            time.monotonic() < deadline:
        time.sleep(0.2)
    if not paused.exists():
        victim.kill()
        fail(f"acp: the child never reached epoch 2 (exit {victim.poll()})"
             f":\n{victim.stderr.read()[-2000:]}")
    meta = json.loads((root / "job" / "meta.json").read_text())
    victim.send_signal(signal.SIGKILL)
    victim.wait()
    victim.stderr.close()
    resumed = subprocess.run(me + ["job", "run"], capture_output=True,
                             text=True, timeout=600)
    unbroken_err = unbroken.communicate(timeout=600)[1]
    if resumed.returncode != 0 or unbroken.returncode != 0:
        fail(f"acp: resumed exit {resumed.returncode}, unbroken exit "
             f"{unbroken.returncode}:\n{resumed.stderr[-2000:]}\n"
             f"{unbroken_err[-2000:]}")
    ran = json.loads((root / "job" / "ran.json").read_text())
    ran_all = json.loads((root / "unbroken" / "ran.json").read_text())
    a = paddle.load(str(root / "job" / "final.pdparams"), device="cpu")
    b = paddle.load(str(root / "unbroken" / "final.pdparams"), device="cpu")
    equal = sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                           for k in a)
    res = dict(killed_after_epoch=meta["epoch_no"],
               victim_exit=victim.returncode, resumed_epochs=ran["epochs"],
               resumed_losses=ran["losses"],
               unbroken_losses=ran_all["losses"], params_bit_equal=equal,
               wall_s=time.perf_counter() - t0)
    res["card"] = card_line()
    print("dist (e) auto-checkpoint: " + json.dumps(res), flush=True)
    if meta["epoch_no"] != 1 or victim.returncode != -signal.SIGKILL or \
            ran["epochs"] != list(range(2, ACP_EPOCHS)) or not equal or \
            ran["losses"] != ran_all["losses"][2:]:
        fail(f"acp: resume {res}")
    shutil.rmtree(root, ignore_errors=True)
    return res


def dist_phase(torch):
    """Phase 18: (a)-(e) of data-parallel training and the rest of eager
    training."""
    from paddle_tpu_torch.tools import train_profile as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()  # the ranks and children share this card
    cfg = tp.gpt2_small_config()
    tokens, labels = tp.train_batch(cfg, "cuda")
    card = card_line()
    out = dict(card=card)
    out["acp"] = dist_acp_check(torch)
    out["data_parallel"] = dist_dp_check(torch, tp, cfg, tokens, labels)
    if torch.cuda.device_count() >= 4:  # as --mesh runs mp=4 on four
        out["data_parallel_4"] = dist_dp_check(torch, tp, cfg, tokens,
                                               labels, nranks=4)
    out["strategy"] = dist_strategy_check(torch, tp, cfg, tokens, labels)
    out["optimizers"] = dist_optimizers_check(torch, tp, cfg, tokens,
                                              labels)
    out["profiler"] = dist_profiler_check(torch, tp, cfg, tokens, labels)
    a, b = out["data_parallel"], out["strategy"]
    print(f"dist: {a['ranks']} ranks on {a['backend']} "
          f"{max(a['ms_per_step_by_rank']):.1f} ms a step "
          f"({a['tokens_per_s']:.0f} tokens/s) against "
          f"{a['single_process_ms_per_step']:.1f} ms in one process, "
          f"all-reduce {max(a['allreduce_share']):.0%} of a step "
          f"({a['bytes_reduced_per_step'] / 2**20:.1f} MiB a step), peak "
          f"{max(a['peak_memory_bytes_by_rank']) / 2**30:.2f} GiB a rank; "
          f"recompute saves {b['recompute_saving']:.0%} of peak; "
          f"profiler armed costs "
          f"{out['profiler']['armed_cost_ms_per_step']:.3f} ms a serve "
          f"step; {card}", flush=True)
    return out


HYBRID_ROOT = Path("build") / "chip_smoke_hybrid"
# two steps a part, for the whole run's time limit: step 1 against one
# process, step 2's time
HYBRID_STEPS = 2
# (a) tensor parallel against one process on the same 8 x 1024 batch,
# step 1: the row-split products' two partial sums are rounded to bf16
# before the all-reduce sums them, where one process sums the whole K in
# one bf16 product; the same order of differences as `DIST_LOSS_TOL`'s
# step 1, and the same bound.  (b) ZeRO against phase 18's one-process
# batch-16 steps: `DIST_LOSS_TOL`, for phase 18's reasons (the update of
# each element is the data-parallel step's).  (c) the pipeline against
# one process: four micro-batch means against one batch mean, the same
# rows in other tiles: `DIST_LOSS_TOL`'s step-1 bound
HYBRID_ZERO = (("stage1", 1, False), ("stage2", 2, False),
               ("stage3", 3, False), ("stage1_offload", 1, True))
HYBRID_PP_MICRO = 4
# (d) gpt_spmd at (dp, pp, sp, mp) = (1, 2, 2, 2) on 8 ranks, batch 4 x
# 1024, two micro-batches: in f32 against the dense `reference_loss` on
# the card, JAX's bar (tests/test_gpt.py: rtol 1e-3 on the loss, atol
# 2e-3 on the SGD update)
SPMD_DEGREES = dict(pp=2, sp=2, mp=2)
SPMD_BATCH, SPMD_MICRO, SPMD_LR = 4, 2, 1e-3
SPMD_TOL = dict(loss_rtol=1e-3, update_atol=2e-3)
# (e) ring attention at [4, 12, 1024, 64] bf16, causal, sp = 2, against
# `flash_attention_fwd` in one process: K3's bf16 tolerance
RING_SHAPE = (4, 12, 1024, 64)


def _hybrid_fleet(**kw):
    """``fleet.init`` of a strategy whose attributes are ``kw``."""
    from paddle_tpu_torch.distributed import fleet

    st = fleet.DistributedStrategy()
    for k, v in kw.items():
        setattr(st, k, v)
    fleet.init(is_collective=True, strategy=st)
    return fleet, fleet.get_hybrid_communicate_group()


def _timed_part(torch, run_step, steps):
    """``steps`` calls of ``run_step() -> loss``: the losses (global),
    host seconds and collective seconds a step, the peak memory and the
    kernels' launches."""
    from paddle_tpu_torch.distributed.collective import comm_stats

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_s, comm_s = [], [], []
    for _ in range(steps):
        comm_stats(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = run_step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        comm_s.append(comm_stats()["seconds"])
        losses.append(float(loss))
    return dict(losses=losses, step_s=step_s, comm_s=comm_s,
                launches=read_counts(),
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def hybrid_rank(out_dir):
    """One of the two ranks of 19 (a), (b), (c) and (e), started by
    ``paddle.distributed.spawn``; writes ``rank<r>.json``."""
    import dataclasses

    import torch

    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed import parallel as par
    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import \
        parallel_cross_entropy
    from paddle_tpu_torch.distributed.topology import (
        HybridCommunicateGroup, set_hybrid_communicate_group)
    from paddle_tpu_torch.models.gpt import GPT, gpt_pipeline_layer
    from paddle_tpu_torch.nn.functional.loss import cross_entropy
    from paddle_tpu_torch.parallel.ring_attention import ring_attention
    from paddle_tpu_torch.tools import train_profile as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    dense = tp.gpt2_small_config()
    cfg = dataclasses.replace(dense, use_parallel_layers=True)

    # (a) tensor parallel, mp = 2
    fleet, hcg = _hybrid_fleet(hybrid_configs={"mp_degree": 2})
    r = par.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    tokens, labels = tp.train_batch(dense, dev)
    half = tokens.shape[0] // 2
    x, y = tokens[:half], labels[:half]
    group = hcg.get_model_parallel_group()

    def tp_loss(model, xb, yb):
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            logits = model(xb, parallel_output=True)
        return parallel_cross_entropy(logits, yb, group).mean()

    model = GPT.random(cfg, seed=tp.SEED, device=dev)
    wrapped = fleet.distributed_model(model)
    opt = dist_adamw(model)

    def dygraph():
        loss = tp_loss(wrapped, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    a = dict(wrapper=type(wrapped).__name__,
             heads_local=model.blocks[0].num_heads,
             qkv_shape=list(model.blocks[0].qkv.weight.shape),
             dygraph=_timed_part(torch, dygraph, HYBRID_STEPS))
    del model, wrapped, opt
    _free(torch)
    model = GPT.random(cfg, seed=tp.SEED, device=dev)
    step = fleet.build_train_step(model, tp_loss, dist_adamw(model))
    a["train_step"] = _timed_part(torch, lambda: step(x, y), HYBRID_STEPS)
    out["tp"] = a
    del model, step
    _free(torch)

    # (b) ZeRO over dp = 2: each rank its half of the batch-16 train batch
    zero = {}
    for label, stage, offload in HYBRID_ZERO:
        fleet, hcg = _hybrid_fleet(
            sharding=True, sharding_configs={"stage": stage,
                                             "offload": offload,
                                             "sharding_degree": 2})
        model = GPT.random(dense, seed=tp.SEED, device=dev)
        step = fleet.build_train_step(model, tp.amp_loss_fn,
                                      dist_adamw(model))
        part = _timed_part(torch, lambda: step(tokens, labels),
                           HYBRID_STEPS)
        part["at_rest"] = step.at_rest_bytes()
        part["zero_stage"] = step.zero_stage
        zero[label] = part
        del model, step
        _free(torch)
    out["zero"] = zero

    # (c) the GPT as a PipelineLayer, pp = 2, through build_train_step
    fleet, hcg = _hybrid_fleet(hybrid_configs={"pp_degree": 2},
                               pipeline=True,
                               pipeline_configs={
                                   "accumulate_steps": HYBRID_PP_MICRO})
    tree = GPT.random(dense, seed=tp.SEED, device="cpu").params()
    pl = gpt_pipeline_layer(dense, tree, device=dev)
    del tree
    step = fleet.build_train_step(
        pl, lambda o, t: cross_entropy(o, t, reduction="mean"),
        optimizer.AdamW(1e-4, parameters=[], weight_decay=0.01))

    def pipe():
        with amp.auto_cast(enable=True, dtype="bfloat16"):
            return step(x, y)

    c = _timed_part(torch, pipe, HYBRID_STEPS)
    c.update(stage=hcg.get_stage_id(), segments=pl.segment_parts,
             p2p=step.stats, step_type=type(step).__name__)
    out["pipeline"] = c
    del pl, step
    _free(torch)

    # (e) ring attention, sp = 2, causal, bf16
    hcg = HybridCommunicateGroup(sp=2)
    set_hybrid_communicate_group(hcg)
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(RING_SHAPE, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    reset_counts()
    o = ring_attention(q, k, v, hcg, causal=True)
    launches = read_counts()
    if r == 0:
        torch.save(o.cpu(), Path(out_dir) / "ring_out.pt")
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring_attention(q, k, v, hcg, causal=True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    qg = q.clone().requires_grad_(True)
    ring_attention(qg, k, v, hcg, causal=True).float().sum().backward()
    out["ring"] = dict(launches=launches, ms=ms,
                       grad_finite=bool(torch.isfinite(qg.grad).all()))
    out.update(rank=r, device=str(dev), backend=par.backend())
    (Path(out_dir) / f"rank{r}.json").write_text(json.dumps(out))


def spmd_rank(out_dir):
    """One of the eight ranks of 19 (d): `build_spmd_train_step` at
    (1, 2, 2, 2) on GPT-2-small, f32 then bf16; rank 0 also holds the
    f32 step against the dense `reference_loss` and its SGD update on the
    card; writes ``rank<r>.json``."""
    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import parallel as par
    from paddle_tpu_torch.models import gpt_spmd as S
    from paddle_tpu_torch.tools import train_profile as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    fleet, hcg = _hybrid_fleet(hybrid_configs={
        f"{k}_degree": v for k, v in SPMD_DEGREES.items()})
    r = par.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = tp.gpt2_small_config()
    whole = S.init_params(cfg, seed=tp.SEED, device="cpu")
    local = S.shard_params(whole, hcg, device=dev)
    rng = np.random.default_rng(tp.SEED)
    toks, labs = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SPMD_BATCH, tp.SEQ)).astype(np.int64)).to(dev)
        for _ in range(2))
    step = S.build_spmd_train_step(cfg, hcg, num_micro=SPMD_MICRO,
                                   lr=SPMD_LR, compute_dtype=torch.float32)
    reset_counts()
    loss, new = step(local, toks, labs)
    f32 = dict(loss=float(loss), launches=read_counts())
    gathered = S.gather_params(new, hcg)
    del new
    if r == 0:
        p = {k: v.to(dev).requires_grad_(True) for k, v in whole.items()}
        ref = S.reference_loss(cfg, p, toks, labs)
        ref.backward()
        f32["reference_loss"] = float(ref)
        f32["update_max_abs_err"] = max(
            float((gathered[k].to(dev) - (p[k] - SPMD_LR * p[k].grad))
                  .abs().max()) for k in p)
        del p, ref
    del gathered, whole
    _free(torch)
    from paddle_tpu_torch.distributed.collective import barrier
    barrier()
    step = S.build_spmd_train_step(cfg, hcg, num_micro=SPMD_MICRO,
                                   lr=SPMD_LR)
    state = {"p": local}

    def bf16_step():
        loss, state["p"] = step(state["p"], toks, labs)
        return loss

    part = _timed_part(torch, bf16_step, HYBRID_STEPS)
    res = dict(rank=r, coords=[hcg.axis_rank(a) for a in
                               ("dp", "pp", "sp", "mp")],
               f32=f32, bf16=part, backend=par.backend(),
               local_param_bytes=sum(t.numel() * t.element_size()
                                     for t in local.values()))
    (Path(out_dir) / f"rank{r}.json").write_text(json.dumps(res))


def _part_row(part):
    med = statistics.median
    step_ms = med(part["step_s"][1:]) * 1e3
    comm_ms = med(part["comm_s"][1:]) * 1e3
    return dict(ms_per_step=step_ms, collective_ms_per_step=comm_ms,
                collective_share=comm_ms / step_ms,
                peak_gib=part["peak_memory_bytes"] / 2 ** 30,
                losses=part["losses"],
                k3_k4=[part["launches"][k] for k in FLASH_KERNELS])


def hybrid_phase(torch):
    """Phase 19: (a)-(e) of hybrid-parallel training (see the module
    docstring)."""
    import shutil

    import numpy as np

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.tools import train_profile as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    card = card_line()
    cfg = tp.gpt2_small_config()
    tokens, labels = tp.train_batch(cfg, "cuda")
    half = tokens.shape[0] // 2
    # one process: step 1 on the 8 x 1024 half, the steps on batch 16
    model = GPT.random(cfg, seed=tp.SEED, device="cuda")
    with torch.no_grad():
        first_half = float(tp.amp_loss_fn(model, tokens[:half],
                                          labels[:half]))
    want16 = _dygraph_losses(torch, model, dist_adamw(model),
                             tp.amp_loss_fn,
                             [(tokens, labels)] * HYBRID_STEPS)
    del model
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(RING_SHAPE, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    ring_ref = flash_attention_fwd(q, k, v, is_causal=True).float().cpu()
    del q, k, v
    torch.cuda.empty_cache()

    shutil.rmtree(HYBRID_ROOT, ignore_errors=True)
    HYBRID_ROOT.mkdir(parents=True)
    t0 = time.perf_counter()
    dist.spawn(hybrid_rank, args=(str(HYBRID_ROOT),), nprocs=2)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((HYBRID_ROOT / f"rank{r}.json").read_text())
             for r in range(2)]
    out = dict(card=card, spawn_s=spawn_s, backend=ranks[0]["backend"],
               one_process=dict(step1_loss_batch8=first_half,
                                losses_batch16=want16))
    nl = cfg.num_layers

    # (a)
    a = {}
    for kind in ("dygraph", "train_step"):
        rows = [_part_row(rk["tp"][kind]) for rk in ranks]
        if ranks[0]["tp"][kind]["losses"] != ranks[1]["tp"][kind]["losses"]:
            fail(f"hybrid (a) {kind}: the mp ranks' losses differ")
        got = ranks[0]["tp"][kind]["losses"]
        rel = _rel(got[0], first_half)
        if not all(math.isfinite(x) for x in got) or \
                rel > DIST_LOSS_TOL["first"]:
            fail(f"hybrid (a) {kind}: step-1 loss {got[0]} against one "
                 f"process's {first_half} (relative {rel})")
        for row in rows:
            if row["k3_k4"] != [nl * HYBRID_STEPS] * 3:
                fail(f"hybrid (a) {kind}: K3/K4 launches {row['k3_k4']}, "
                     f"want {nl * HYBRID_STEPS} each")
        a[kind] = dict(by_rank=rows, step1_rel_err=rel)
    if ranks[0]["tp"]["heads_local"] != cfg.num_heads // 2:
        fail(f"hybrid (a): {ranks[0]['tp']['heads_local']} heads a rank")
    a.update(wrapper=ranks[0]["tp"]["wrapper"],
             qkv_shape=ranks[0]["tp"]["qkv_shape"])
    out["tensor_parallel"] = a

    # (b)
    b = {}
    for label, stage, offload in HYBRID_ZERO:
        got = [rk["zero"][label]["losses"] for rk in ranks]
        if got[0] != got[1]:
            fail(f"hybrid (b) {label}: the ranks' losses differ: {got}")
        rel = _check_losses(f"hybrid (b) {label}", got[0], want16)
        rows = [_part_row(rk["zero"][label]) for rk in ranks]
        want_k3 = nl * HYBRID_STEPS * (2 if stage == 3 else 1)
        for row in rows:
            if row["k3_k4"] != [want_k3] + [nl * HYBRID_STEPS] * 2:
                fail(f"hybrid (b) {label}: K3/K4 launches {row['k3_k4']}")
        b[label] = dict(by_rank=rows, loss_rel_err=rel,
                        at_rest=[rk["zero"][label]["at_rest"]
                                 for rk in ranks])
    out["zero"] = b

    # (c)
    c = dict(by_rank=[_part_row(rk["pipeline"]) for rk in ranks],
             segments=ranks[0]["pipeline"]["segments"],
             p2p=[rk["pipeline"]["p2p"] for rk in ranks],
             step_type=ranks[0]["pipeline"]["step_type"])
    got = ranks[0]["pipeline"]["losses"]
    if got != ranks[1]["pipeline"]["losses"] or \
            c["step_type"] != "PipelineTrainStep":
        fail(f"hybrid (c): {c['step_type']}, losses "
             f"{[rk['pipeline']['losses'] for rk in ranks]}")
    c["step1_rel_err"] = _rel(got[0], first_half)
    if not all(math.isfinite(x) for x in got) or \
            c["step1_rel_err"] > DIST_LOSS_TOL["first"]:
        fail(f"hybrid (c): step-1 loss {got[0]} against {first_half}")
    per_stage = (nl // 2) * HYBRID_PP_MICRO * HYBRID_STEPS
    for row in c["by_rank"]:
        if row["k3_k4"] != [per_stage] * 3:
            fail(f"hybrid (c): K3/K4 launches {row['k3_k4']}, want "
                 f"{per_stage} each")
    out["pipeline"] = c

    # (e)
    ring_out = torch.load(HYBRID_ROOT / "ring_out.pt").float()
    err = float((ring_out - ring_ref).abs().max())
    e = dict(max_abs_err=err, tol=FLASH_TOL["bfloat16"]["out"],
             launches=[rk["ring"]["launches"]["fwd"] for rk in ranks],
             ms=[statistics.median(rk["ring"]["ms"]) for rk in ranks],
             grad_finite=[rk["ring"]["grad_finite"] for rk in ranks])
    if err > e["tol"] or e["launches"] != [1, 2] or not all(
            e["grad_finite"]):
        fail(f"hybrid (e) ring attention: {e}")
    out["ring"] = e
    shutil.rmtree(HYBRID_ROOT, ignore_errors=True)

    # (d)
    HYBRID_ROOT.mkdir(parents=True)
    n = int(np.prod(list(SPMD_DEGREES.values())))
    t0 = time.perf_counter()
    dist.spawn(spmd_rank, args=(str(HYBRID_ROOT),), nprocs=n)
    spmd_s = time.perf_counter() - t0
    rs = [json.loads((HYBRID_ROOT / f"rank{r}.json").read_text())
          for r in range(n)]
    f32 = rs[0]["f32"]
    d = dict(spawn_s=spmd_s, tol=SPMD_TOL, f32_loss=f32["loss"],
             reference_loss=f32["reference_loss"],
             loss_rel_err=_rel(f32["loss"], f32["reference_loss"]),
             update_max_abs_err=f32["update_max_abs_err"],
             bf16=[_part_row(rk["bf16"]) for rk in rs],
             coords=[rk["coords"] for rk in rs],
             local_param_bytes=[rk["local_param_bytes"] for rk in rs])
    if len({rk["f32"]["loss"] for rk in rs}) != 1 or \
            d["loss_rel_err"] > SPMD_TOL["loss_rtol"] or \
            d["update_max_abs_err"] > SPMD_TOL["update_atol"]:
        fail(f"hybrid (d) gpt_spmd f32: {d}")
    for rk, row in zip(rs, d["bf16"]):
        sp_rank = rk["coords"][2]
        blocks = (nl // SPMD_DEGREES["pp"]) * SPMD_MICRO * HYBRID_STEPS
        want = [blocks * (sp_rank + 1), 0, 0]
        if row["k3_k4"] != want or not all(math.isfinite(x)
                                           for x in row["losses"]):
            fail(f"hybrid (d) rank {rk['rank']}: K3/K4 {row['k3_k4']} "
                 f"(want {want}), losses {row['losses']}")
    out["gpt_spmd"] = d
    shutil.rmtree(HYBRID_ROOT, ignore_errors=True)

    for label, rows in [("(a) mp=2 dygraph", a["dygraph"]["by_rank"]),
                        ("(a) mp=2 build_train_step",
                         a["train_step"]["by_rank"])] + \
            [(f"(b) zero {k}", v["by_rank"]) for k, v in b.items()] + \
            [("(c) pp=2", c["by_rank"]), ("(d) gpt_spmd bf16", d["bf16"])]:
        print(f"hybrid {label}, by rank (ms a step, collectives' share, "
              f"peak GiB, K3/K4 launches): " + json.dumps(
                  [[round(r["ms_per_step"], 2),
                    round(r["collective_share"], 4), round(r["peak_gib"], 3),
                    r["k3_k4"]] for r in rows]), flush=True)
    print(f"hybrid (e) ring: {json.dumps(e)}", flush=True)
    dp_peak = 9.39  # GiB a rank, phase 18 (a), PERF.md section 5
    print("hybrid: (a) mp=2 "
          f"{a['dygraph']['by_rank'][0]['ms_per_step']:.0f} ms a dygraph "
          f"step, collectives "
          f"{a['dygraph']['by_rank'][0]['collective_share']:.0%}; (b) "
          + ", ".join(f"{k} {v['by_rank'][0]['ms_per_step']:.0f} ms peak "
                      f"{max(r['peak_gib'] for r in v['by_rank']):.2f} "
                      f"GiB" for k, v in b.items())
          + f" (DP {dp_peak} GiB); (c) pp=2 "
          f"{c['by_rank'][0]['ms_per_step']:.0f} ms a step; (d) gpt_spmd "
          f"bf16 {max(r['ms_per_step'] for r in d['bf16']):.0f} ms a step; "
          f"(e) ring {max(e['ms']):.2f} ms; {card}", flush=True)
    return out


def hybrid_child(argv) -> int:
    """``--hybrid-child OUT``: phase 19 in a process of its own, started
    by `HybridChild` so that it runs beside phase 20; writes phase 19's
    result, with its seconds as ``phase_s``, to OUT as JSON."""
    import torch

    t0 = time.perf_counter()
    res = hybrid_phase(torch)
    res["phase_s"] = time.perf_counter() - t0
    Path(argv[0]).write_text(json.dumps(res))
    return 0


class HybridChild:
    """Phase 19 under a child process of this script (`hybrid_child`),
    its output kept in ``HYBRID_ROOT.parent/chip_smoke_hybrid.log``.  Its
    ranks are processes of their own, bound by gloo on the host like
    phase 20's, and neither phase reads the other's counts, files or
    environment, so the two run side by side."""

    TIMEOUT_S = 900

    def __init__(self):
        self.out = HYBRID_ROOT.parent / "chip_smoke_hybrid_child.json"
        self.log = HYBRID_ROOT.parent / "chip_smoke_hybrid.log"
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.out.unlink(missing_ok=True)
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--hybrid-child", str(self.out)],
                stdout=log, stderr=subprocess.STDOUT)

    def result(self):
        """Wait for the child, print its output, return its result."""
        try:
            rc = self.proc.wait(timeout=self.TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.stop()
            fail(f"phase 19's child ran past {self.TIMEOUT_S} s")
        text = self.log.read_text()
        print(text, end="" if text.endswith("\n") else "\n", flush=True)
        if rc != 0 or not self.out.exists():
            fail(f"phase 19's child exited {rc} (its output above)")
        return json.loads(self.out.read_text())

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def hybrid_launches(hybrid, kern) -> dict:
    """Phase 19's launches of one K3/K4 wrapper, by part and rank."""
    i = list(FLASH_KERNELS).index(kern)
    out = {}
    for kind in ("dygraph", "train_step"):
        for r, row in enumerate(hybrid["tensor_parallel"][kind]["by_rank"]):
            out[f"hybrid_mp2_{kind}_rank{r}"] = row["k3_k4"][i]
    for label, part in hybrid["zero"].items():
        for r, row in enumerate(part["by_rank"]):
            out[f"hybrid_zero_{label}_rank{r}"] = row["k3_k4"][i]
    for r, row in enumerate(hybrid["pipeline"]["by_rank"]):
        out[f"hybrid_pp2_stage{r}"] = row["k3_k4"][i]
    if kern == "fwd":
        for r, n in enumerate(hybrid["ring"]["launches"]):
            out[f"hybrid_ring_sp2_rank{r}"] = n
        for r, row in enumerate(hybrid["gpt_spmd"]["bf16"]):
            out[f"hybrid_gpt_spmd_rank{r}"] = row["k3_k4"][i]
    return out


# ---------------------------------------------------------------------------
# phase 20: expert parallelism, the parameter server, the data feed
# ---------------------------------------------------------------------------
MOE_PS_ROOT = Path("build") / "chip_smoke_moe_ps"
# (a) JAX's tests/test_moe.py:87 net at GPT-2-small's MLP width: an
# 8-expert top-2 MoELayer(768, 3072) and a Linear(768, 768) head, f32, the
# MSE loss plus 0.01 x the auxiliary loss, SGD
MOE_H, MOE_F, MOE_E, MOE_K, MOE_CF = 768, 3072, 8, 2, 1.25
MOE_SEQ = 1024
MOE_LR = 0.01
MOE_STEPS = 3
MOE_SEED = 11
# the explicit mode (ep = 2, each rank its 8 x 1024 tokens) against one
# process's dense `moe_forward` of the same tokens with all 8 experts, in
# f32 without TF32: the same products, the experts' batched over both
# ranks' tokens (other GEMM shapes, other summation order), so max
# |error| / max |reference| of the outputs, the auxiliary loss and step
# 1's gradients within 1e-4
MOE_TOL = 1e-4
# (b) the parameter server: GPT-2-small's parameters as one dense table,
# server-side SGD; two trainers a run
PS_LR = 1e-3
PS_STEPS = 3
PS_GEO_STEPS = 4
PS_GEO_K = 2
# geo: the table against p0 plus both trainers' deltas summed in f64: the
# server adds four f32 deltas in its own order, a few f32 roundings
PS_GEO_TOL = 1e-6


class MoEData:
    """Phase 20 (a)'s samples: sample ``i`` is a ``[MOE_SEQ, MOE_H]`` f32
    input and its target, drawn from numpy seed ``MOE_SEED + i`` (a
    `paddle_tpu_torch.io.DataLoader` dataset; its workers import this
    script)."""

    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        import numpy as np

        rng = np.random.default_rng(MOE_SEED + int(i))
        return (rng.standard_normal((MOE_SEQ, MOE_H), dtype=np.float32),
                rng.standard_normal((MOE_SEQ, MOE_H), dtype=np.float32))

    def __len__(self):
        return self.n


def moe_net(torch, device, **moe_kw):
    """The (a) net: `MoELayer` then a ``Linear(768, 768)`` head; its loss
    is `moe_loss`."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import MoELayer

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.moe = MoELayer(MOE_H, MOE_F, MOE_E, k=MOE_K,
                                capacity_factor=MOE_CF, device=device,
                                **moe_kw)
            self.head = nn.Linear(MOE_H, MOE_H, device=device)

        def forward(self, x):
            return self.head(self.moe(x))

    return Net()


def moe_loss(model, x, y):
    inner = getattr(model, "_layers", model)
    return ((model(x) - y) ** 2).mean() + 0.01 * inner.moe.aux_loss


def _ps_flat(params):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in params])


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def moe_rank(out_dir):
    """One of the two ranks of 20 (a), started by
    ``paddle.distributed.spawn``: the explicit mode over
    ``new_group(axis_name="ep")``, then the fleet mode at mp = 2 fed by a
    `DataLoader` with two worker processes; writes ``rank<r>.json`` and
    the tensors the parent holds against one process."""
    import numpy as np
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.collective import comm_stats
    from paddle_tpu_torch.inference.weights import shard_state_dict
    from paddle_tpu_torch.io import DataLoader

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(out_dir)
    fleet, hcg = _hybrid_fleet()
    r = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    whole = torch.load(out_dir / "moe_init.pt")
    data = MoEData(16)
    res = dict(rank=r, backend=dist.parallel.backend(), device=str(dev))

    # explicit mode: 4 experts a rank, this rank's 8 x 1024 tokens
    group = collective.new_group([0, 1], axis_name="ep")
    net = moe_net(torch, dev, ep_axis="ep", ep_degree=2)
    shard_state_dict(net, whole)
    xs, ys = (torch.from_numpy(np.stack(
        [data[i][j] for i in range(8 * r, 8 * r + 8)])).to(dev)
        for j in (0, 1))
    params = list(net.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for step in range(MOE_STEPS):
        comm_stats(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net(xs)
        loss = ((out - ys) ** 2).mean() + 0.01 * net.moe.aux_loss
        loss.backward()
        # the head is replicated over the ep ranks, as gate_weight is:
        # its gradient summed over them (the MoE sums gate_weight's)
        dist.all_reduce(net.head.weight.grad)
        dist.all_reduce(net.head.bias.grad)
        if step == 0:
            torch.save(dict(out=out.detach().cpu(),
                            aux=net.moe.aux_loss.detach().cpu(),
                            **{f"grad.{n}": p.grad.detach().cpu()
                               for n, p in net.named_parameters()}),
                       out_dir / f"moe_ep_rank{r}.pt")
        with torch.no_grad():
            for p in params:
                p -= MOE_LR * p.grad
                p.grad = None
        torch.cuda.synchronize()
        st = comm_stats()
        steps.append(dict(s=time.perf_counter() - t0, comm_s=st["seconds"],
                          comm_bytes=st["bytes"],
                          loss=float(loss.detach())))
    cap = max(1, math.ceil(xs.shape[0] * xs.shape[1] * MOE_K / MOE_E
                           * MOE_CF))
    # two exchanges forward, one backward (the input tokens take no
    # gradient, so the dispatch exchange's transpose never runs)
    res["ep"] = dict(steps=steps, capacity=cap,
                     a2a_bytes_per_step=3 * MOE_E * cap * MOE_H * 4,
                     w1_local_shape=list(net.moe.w1.shape),
                     in_scope=net.moe.ep_group() is group,
                     peak_memory_bytes=torch.cuda.max_memory_allocated())
    del net, params, out, loss, xs, ys
    _free(torch)

    # fleet mode: the experts split over mp = 2, the batches from workers
    fleet, hcg = _hybrid_fleet(hybrid_configs={"mp_degree": 2})
    net = moe_net(torch, dev, ep_axis="mp")
    shard_state_dict(net, whole)
    step_fn = fleet.build_train_step(net, moe_loss, optimizer.SGD(
        MOE_LR, parameters=net.parameters()))
    feed = MoEData(8 * MOE_STEPS)
    plain = list(DataLoader(feed, places=dev, batch_size=8))
    loader = DataLoader(feed, places=dev, batch_size=8, num_workers=2,
                        multiprocess_mode="process", persistent_workers=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, equal, pool_pids = [], [], set()
    t_load = time.perf_counter()
    batches = list(loader)
    load_s = time.perf_counter() - t_load
    pool = loader._pool
    if pool is not None:
        pool_pids = {p.pid for p in pool.workers}
        pool.shutdown()
    for (x, y), (px, py) in zip(batches, plain):
        equal.append(bool(torch.equal(x, px) and torch.equal(y, py)))
        comm_stats(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step_fn(x, y)
        torch.cuda.synchronize()
        st = comm_stats()
        steps.append(dict(s=time.perf_counter() - t0, comm_s=st["seconds"],
                          comm_bytes=st["bytes"], loss=float(loss)))
    res["fleet"] = dict(steps=steps, batches_equal=equal,
                        n_batches=len(batches), loader_s=load_s,
                        worker_processes=len(pool_pids),
                        w1_local_shape=list(net.moe.w1.shape),
                        peak_memory_bytes=torch.cuda.max_memory_allocated())
    (out_dir / f"rank{r}.json").write_text(json.dumps(res))


class _Slot:
    """A MultiSlot variable: a name, an int64 dtype, a ``[-1, 1024]``
    shape."""

    def __init__(self, name):
        self.name, self.dtype, self.shape = name, "int64", [-1, 1024]


@contextlib.contextmanager
def _env(**kv):
    import os

    saved = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ps_trainer(out_dir, runs):
    """One of the two trainers of 20 (b), started by
    ``paddle.distributed.spawn``: its half of the batch from its MultiSlot
    file through `InMemoryDataset`, then for each run ``(name, endpoints,
    mode, steps)`` ``fleet.init(is_collective=False)``,
    ``fleet.init_worker()`` and the steps (sync: pull, bf16 forward and
    backward, push, barrier; geo: a local SGD step and the communicator's
    ``geo_step``), then ``fleet.stop_worker()``; writes ``trainer<r>.json``
    and the arrays the parent checks."""
    import os

    import numpy as np
    import torch

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools import train_profile as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(out_dir)
    r = int(os.environ["PADDLE_TRAINER_ID"])
    dev = torch.device("cuda", r % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    cfg = tp.gpt2_small_config()
    ds = fleet.InMemoryDataset()
    ds.init(batch_size=tp.BATCH // 2, thread_num=1,
            use_var=[_Slot("tokens"), _Slot("labels")])
    ds.set_filelist([str(out_dir / f"part-{r}.txt")])
    ds.load_into_memory()
    (batch,) = list(ds.iter_batches())
    tokens, labels = tp.train_batch(cfg, "cpu")
    half = slice(r * tp.BATCH // 2, (r + 1) * tp.BATCH // 2)
    res = dict(rank=r, device=str(dev), batch_equal=bool(
        np.array_equal(batch["tokens"], tokens[half].numpy()) and
        np.array_equal(batch["labels"], labels[half].numpy())))
    x = torch.from_numpy(batch["tokens"]).to(dev)
    y = torch.from_numpy(batch["labels"]).to(dev)
    model = GPT(cfg, device=dev)
    params = list(model.parameters())
    flat = torch.empty(sum(p.numel() for p in params), device=dev)
    off = 0
    for p in params:  # the parameters become views of one flat buffer
        n = p.numel()
        flat[off:off + n].copy_(p.detach().reshape(-1))
        p.data = flat[off:off + n].view_as(p)
        off += n
    size = flat.numel()
    runs_out = {}
    for name, eps, mode, steps in runs:
        st = fleet.DistributedStrategy()
        if mode == "geo":
            st.a_sync = True
            st.a_sync_configs = {"k_steps": PS_GEO_K}
        with _env(TRAINING_ROLE="TRAINER",
                  PADDLE_PSERVERS_IP_PORT_LIST=",".join(eps)):
            fleet.init(is_collective=False, strategy=st)
        client = fleet.init_worker()
        comm = fleet.fleet._ps_communicator
        flat.copy_(torch.from_numpy(client.pull_dense(0, size)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        log, delta_sum = [], None
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rt = 0.0
            if mode == "sync" and step:
                t1 = time.perf_counter()
                pulled = client.pull_dense(0, size)
                rt += time.perf_counter() - t1
                if step == 1 and r == 0:
                    np.save(out_dir / f"{name}_p1.npy", pulled)
                flat.copy_(torch.from_numpy(pulled))
            loss = tp.amp_loss_fn(model, x, y)
            loss.backward()
            g = _ps_flat([p.grad for p in params])
            for p in params:
                p.grad = None
            if mode == "sync":
                g_host = g.cpu().numpy()
                if step == 0:
                    np.save(out_dir / f"{name}_g1_rank{r}.npy", g_host)
                t1 = time.perf_counter()
                client.push_dense_grad(0, g_host)
                client.barrier(trainer_id=r)
                rt += time.perf_counter() - t1
            else:
                with torch.no_grad():
                    flat -= PS_LR * g
                local = flat.cpu().numpy()
                t1 = time.perf_counter()
                if (step + 1) % PS_GEO_K == 0:
                    d = local - comm._geo_old.get(0, local)
                    delta_sum = d if delta_sum is None else delta_sum + d
                back = comm.geo_step(0, local)
                rt += time.perf_counter() - t1
                if back is not local:
                    flat.copy_(torch.from_numpy(back))
            torch.cuda.synchronize()
            log.append(dict(s=time.perf_counter() - t0, ps_s=rt,
                            loss=float(loss.detach())))
        if delta_sum is not None:
            np.save(out_dir / f"{name}_deltas_rank{r}.npy", delta_sum)
        runs_out[name] = dict(
            steps=log, launches=read_counts(), mode=comm.mode,
            client=type(client).__name__, bytes_each_way=size * 4,
            peak_memory_bytes=torch.cuda.max_memory_allocated())
        fleet.stop_worker()
    res.update(runs=runs_out, params=size)
    (out_dir / f"trainer{r}.json").write_text(json.dumps(res))


def _ps_servers(endpoints, table):
    """A `Fleet` per endpoint in the server role, each `init_server` of
    ``table`` (the global dense size cut per server)."""
    from paddle_tpu_torch.distributed.fleet.base import (
        Fleet, PaddleCloudRoleMaker)

    out = []
    for ep in endpoints:
        with _env(TRAINING_ROLE="PSERVER",
                  PADDLE_PSERVERS_IP_PORT_LIST=",".join(endpoints),
                  PADDLE_CURRENT_ENDPOINT=ep, PADDLE_TRAINERS_NUM=2):
            f = Fleet().init(role_maker=PaddleCloudRoleMaker(False),
                             is_collective=False)
            f.init_server(tables={0: table})
        out.append(f)
    return out


def _sgd_orders(p0, g1, g2, lr):
    import numpy as np

    lr = np.float32(lr)
    return [(p0 - lr * a) - lr * b for a, b in ((g1, g2), (g2, g1))]


def moe_ps_phase(torch):
    """Phase 20: (a) expert parallelism and (b) the parameter server (see
    the module docstring)."""
    import shutil

    import numpy as np

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.distributed.fleet.meta_parallel import moe_forward
    from paddle_tpu_torch.distributed.spawn import free_port
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools import train_profile as tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    card = card_line()
    med = statistics.median
    shutil.rmtree(MOE_PS_ROOT, ignore_errors=True)
    MOE_PS_ROOT.mkdir(parents=True)
    out = dict(card=card)

    # (a) one process: the dense net and its steps
    import paddle_tpu_torch as paddle

    paddle.seed(MOE_SEED)
    net = moe_net(torch, "cuda")
    whole = {k: v.detach().cpu().clone() for k, v in
             net.state_dict().items()}
    torch.save(whole, MOE_PS_ROOT / "moe_init.pt")
    data = MoEData(8 * MOE_STEPS)
    feed = [tuple(torch.from_numpy(np.stack([data[i][j] for i in range(
        8 * t, 8 * t + 8)])).cuda() for j in (0, 1))
        for t in range(MOE_STEPS)]
    opt = optimizer.SGD(MOE_LR, parameters=net.parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = _dygraph_losses(torch, net, opt, moe_loss, feed)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) / MOE_STEPS * 1e3
    del net, opt, feed
    _free(torch)
    t0 = time.perf_counter()
    dist.spawn(moe_rank, args=(str(MOE_PS_ROOT),), nprocs=2)
    moe_spawn_s = time.perf_counter() - t0
    ranks = [json.loads((MOE_PS_ROOT / f"rank{r}.json").read_text())
             for r in range(2)]
    # the explicit mode against one process's dense moe_forward on each
    # rank's tokens with all 8 experts
    ref = moe_net(torch, "cuda")
    ref.set_state_dict(whole)
    errs = []
    got = [torch.load(MOE_PS_ROOT / f"moe_ep_rank{r}.pt") for r in range(2)]
    for r in range(2):
        x, y = (torch.from_numpy(np.stack([data[i][j] for i in range(
            8 * r, 8 * r + 8)])).cuda() for j in (0, 1))
        m = ref.moe
        o, aux = moe_forward(x.reshape(-1, MOE_H), m.gate_weight, m.w1,
                             m.b1, m.w2, m.b2, k=MOE_K,
                             capacity_factor=MOE_CF)
        o = ref.head(o.reshape(x.shape))
        loss = ((o - y) ** 2).mean() + 0.01 * aux
        loss.backward()  # the gradients sum over both ranks' losses
        errs.append(dict(out=_rel_err(got[r]["out"].cuda(), o.detach()),
                         aux=abs(float(got[r]["aux"])
                                 - float(aux.detach()))))
        del x, y, o, aux, loss
    grads = {n: p.grad for n, p in ref.named_parameters()}
    for r in range(2):
        for n, g in grads.items():
            if n.startswith("moe.") and n != "moe.gate_weight":
                g = g.chunk(2, 0)[r]
            errs[r][f"grad.{n}"] = _rel_err(got[r][f"grad.{n}"].cuda(), g)
    del ref, grads, got
    _free(torch)
    worst = max(v for e in errs for v in e.values())
    ep = ranks[0]["ep"]
    a = dict(
        spawn_s=moe_spawn_s, backend=ranks[0]["backend"],
        single_process_ms_per_step=single_ms,
        explicit=dict(
            errors_by_rank=errs, worst_error=worst, tol=MOE_TOL,
            capacity=ep["capacity"], w1_local_shape=ep["w1_local_shape"],
            a2a_bytes_per_step=ep["a2a_bytes_per_step"],
            by_rank=[dict(
                ms_per_step=med(s["s"] for s in rk["ep"]["steps"][1:]) * 1e3,
                collective_share=med(s["comm_s"] / s["s"]
                                     for s in rk["ep"]["steps"][1:]),
                collective_bytes_per_step=rk["ep"]["steps"][-1][
                    "comm_bytes"],
                peak_gib=rk["ep"]["peak_memory_bytes"] / 2 ** 30,
                losses=[s["loss"] for s in rk["ep"]["steps"]])
                for rk in ranks]))
    if worst > MOE_TOL or not all(rk["ep"]["in_scope"] for rk in ranks) \
            or ep["w1_local_shape"] != [MOE_E // 2, MOE_H, MOE_F]:
        fail(f"moe (a) explicit ep=2 against one process: {a['explicit']}")
    fl = [rk["fleet"] for rk in ranks]
    losses = [[s["loss"] for s in f["steps"]] for f in fl]
    if losses[0] != losses[1]:
        fail(f"moe (a) fleet: the mp ranks' losses differ: {losses}")
    rel = _check_losses("moe (a) fleet mp=2", losses[0], want)
    if not all(all(f["batches_equal"]) and f["n_batches"] == MOE_STEPS
               and f["worker_processes"] == 2 for f in fl) or \
            fl[0]["w1_local_shape"] != [MOE_E // 2, MOE_H, MOE_F]:
        fail(f"moe (a) fleet: the DataLoader's worker batches {fl}")
    a["fleet"] = dict(
        losses=losses[0], single_process_losses=want, loss_rel_err=rel,
        tol=DIST_LOSS_TOL, loader_s=[f["loader_s"] for f in fl],
        by_rank=[dict(
            ms_per_step=med(s["s"] for s in f["steps"][1:]) * 1e3,
            collective_share=med(s["comm_s"] / s["s"]
                                 for s in f["steps"][1:]),
            collective_bytes_per_step=f["steps"][-1]["comm_bytes"],
            peak_gib=f["peak_memory_bytes"] / 2 ** 30) for f in fl])
    out["moe"] = a

    # (b) the parameter server at GPT-2-small's width
    cfg = tp.gpt2_small_config()
    model = GPT.random(cfg, seed=tp.SEED, device="cuda")
    p0 = _ps_flat(list(model.parameters())).cpu().numpy()
    del model
    _free(torch)
    n = p0.size
    tokens, labels = tp.train_batch(cfg, "cpu")
    half = tp.BATCH // 2
    for r in range(2):  # each trainer's MultiSlot file
        lines = [f"{tp.SEQ} " + " ".join(map(str, tokens[i].tolist()))
                 + f" {tp.SEQ} " + " ".join(map(str, labels[i].tolist()))
                 for i in range(r * half, (r + 1) * half)]
        (MOE_PS_ROOT / f"part-{r}.txt").write_text("\n".join(lines) + "\n")
    eps = {k: [f"127.0.0.1:{free_port()}" for _ in range(m)]
           for k, m in (("sync", 1), ("sharded", 2), ("geo", 1))}
    servers = {k: _ps_servers(v, ("dense", n, PS_LR,
                                  "sum" if k == "geo" else "sgd"))
               for k, v in eps.items()}
    t0 = time.perf_counter()
    for k, v in eps.items():
        c = ps.ShardedPSClient(v) if len(v) > 1 else \
            ps.PSClient("127.0.0.1", int(v[0].rsplit(":", 1)[1]))
        c.set_dense(0, p0)
        c.close()
    set_s = time.perf_counter() - t0
    runs = [("sync", eps["sync"], "sync", PS_STEPS),
            ("sharded", eps["sharded"], "sync", PS_STEPS),
            ("geo", eps["geo"], "geo", PS_GEO_STEPS)]
    t0 = time.perf_counter()
    dist.spawn(ps_trainer, args=(str(MOE_PS_ROOT), runs), nprocs=2)
    ps_spawn_s = time.perf_counter() - t0
    trainers = [json.loads((MOE_PS_ROOT / f"trainer{r}.json").read_text())
                for r in range(2)]
    if not all(t["batch_equal"] for t in trainers):
        fail("ps (b): a trainer's InMemoryDataset batch differs from the "
             "train batch")
    b = dict(params=n, bytes_each_way_per_step=n * 4, spawn_s=ps_spawn_s,
             set_dense_s=set_s, runs={})
    nl = cfg.num_layers
    for name, _, mode, steps in runs:
        rows = [t["runs"][name] for t in trainers]
        row = dict(mode=rows[0]["mode"], client=rows[0]["client"],
                   by_rank=[dict(
                       ms_per_step=med(s["s"] for s in rr["steps"][1:])
                       * 1e3,
                       ps_share=med(s["ps_s"] / s["s"]
                                    for s in rr["steps"][1:]),
                       peak_gib=rr["peak_memory_bytes"] / 2 ** 30,
                       losses=[s["loss"] for s in rr["steps"]],
                       k3_k4=[rr["launches"][k] for k in FLASH_KERNELS])
                       for rr in rows])
        for rr in row["by_rank"]:
            if rr["k3_k4"] != [nl * steps] * 3 or not all(
                    math.isfinite(x) for x in rr["losses"]):
                fail(f"ps (b) {name}: K3/K4 launches {rr['k3_k4']} (want "
                     f"{nl * steps} each), losses {rr['losses']}")
        if mode == "sync":
            p1 = np.load(MOE_PS_ROOT / f"{name}_p1.npy")
            g = [np.load(MOE_PS_ROOT / f"{name}_g1_rank{r}.npy")
                 for r in range(2)]
            sizes = ps.shard_dense_sizes(n, len(eps[name]))
            off, exact = 0, []
            for s in sizes:  # each server applies the pushes in its order
                sl = slice(off, off + s)
                exact.append(any(np.array_equal(p1[sl], o) for o in
                                 _sgd_orders(p0[sl], g[0][sl], g[1][sl],
                                             PS_LR)))
                off += s
            row["step1_equals_one_process_update"] = exact
            if not all(exact) or rows[0]["client"] != (
                    "ShardedPSClient" if len(sizes) > 1 else "PSClient"):
                fail(f"ps (b) {name}: the pulled parameters after step 1 "
                     f"are not p0 - lr g_a - lr g_b ({exact}, "
                     f"{rows[0]['client']})")
            del p1, g
        else:
            c = ps.PSClient("127.0.0.1", int(eps[name][0].rsplit(":", 1)[1]))
            table = c.pull_dense(0, n)
            c.close()
            want_t = p0.astype(np.float64) + sum(
                np.load(MOE_PS_ROOT / f"{name}_deltas_rank{r}.npy")
                .astype(np.float64) for r in range(2))
            row["table_max_abs_err"] = float(np.abs(table - want_t).max())
            row["tol"] = PS_GEO_TOL
            if row["table_max_abs_err"] > PS_GEO_TOL or row["mode"] != "geo":
                fail(f"ps (b) geo: the table against p0 + the merged "
                     f"deltas: {row['table_max_abs_err']} ({row['mode']})")
            del table, want_t
        b["runs"][name] = row
    for fl_ in servers.values():
        for f in fl_:
            f.stop_server()
    out["ps"] = b
    shutil.rmtree(MOE_PS_ROOT, ignore_errors=True)

    e, f_ = a["explicit"], a["fleet"]
    print("moe (a) explicit ep=2, by rank (ms a step, collectives' share, "
          "collective bytes a step, peak GiB): " + json.dumps(
              [[round(x["ms_per_step"], 2), round(x["collective_share"], 4),
                x["collective_bytes_per_step"], round(x["peak_gib"], 3)]
               for x in e["by_rank"]]) + f"; all-to-all bytes a step "
          f"{e['a2a_bytes_per_step']}; worst error {e['worst_error']:.3g} "
          f"(tol {MOE_TOL})", flush=True)
    print("moe (a) fleet mp=2, by rank (ms a step, collectives' share, "
          "collective bytes a step, peak GiB): " + json.dumps(
              [[round(x["ms_per_step"], 2), round(x["collective_share"], 4),
                x["collective_bytes_per_step"], round(x["peak_gib"], 3)]
               for x in f_["by_rank"]]) + f"; losses {f_['losses']} against "
          f"{f_['single_process_losses']}", flush=True)
    for name, row in b["runs"].items():
        print(f"ps (b) {name} ({row['client']}, {row['mode']}), by rank (ms "
              f"a step, PS round trip's share, peak GiB, K3/K4): "
              + json.dumps([[round(x["ms_per_step"], 2),
                             round(x["ps_share"], 4), round(x["peak_gib"], 3),
                             x["k3_k4"]] for x in row["by_rank"]])
              + f"; {n * 4} bytes pushed and {n * 4} pulled a step",
              flush=True)
    print(f"moe_ps: explicit ep=2 "
          f"{e['by_rank'][0]['ms_per_step']:.0f} ms a step, fleet mp=2 "
          f"{f_['by_rank'][0]['ms_per_step']:.0f} ms (one process "
          f"{a['single_process_ms_per_step']:.0f}); PS sync "
          f"{b['runs']['sync']['by_rank'][0]['ms_per_step']:.0f} ms, "
          f"sharded {b['runs']['sharded']['by_rank'][0]['ms_per_step']:.0f}"
          f" ms, geo {b['runs']['geo']['by_rank'][0]['ms_per_step']:.0f} ms "
          f"a step; {card}", flush=True)
    return out


def moe_ps_launches(moe_ps, kern) -> dict:
    """Phase 20's launches of one K3/K4 wrapper, by run and trainer."""
    i = list(FLASH_KERNELS).index(kern)
    return {f"ps_{name}_trainer{r}": row["k3_k4"][i]
            for name, run in moe_ps["ps"]["runs"].items()
            for r, row in enumerate(run["by_rank"])}


# ---------------------------------------------------------------------------
# phase 21: the functional tensor API and nn's activations, losses, norms
# ---------------------------------------------------------------------------
# the op tables of tests/torch_op_tables.py (the CPU parity tests' own) at
# GPT-2-small widths: elementwise ops and reductions on the residual
# stream, search on the logits, linear algebra on a projection and on a
# layer's per-head blocks, the norms on ResNet's first stage
TA_STREAM = (8, 1024, 768)
TA_LOGITS = (8, 50304)
TA_LINALG = ((768, ()), (64, (12,)))
TA_NORMS = (32, 256, 56, 56)
TA_DRAWS = 2 ** 24
TA_LN_ROWS, TA_LN_STEPS = 16384, 3
TA_CPU_THREADS = 4
# the card against the port on the CPU, by family and dtype, (rtol, atol):
# f32 elementwise ops are one rounding of one formula through another
# math library (CUDA's libdevice: a few ulps), special functions the CPU
# tests' bound; a reduction sums in another order (a tree on the card,
# cascades or a sequence on the CPU): rtol 1e-4 and an absolute 1e-4,
# which a row's ``acc`` scales by the n terms behind one output: by
# sqrt(n) for a sum or scan of O(1) terms (random-walk partial sums of
# size sqrt(n), rounded at eps each), by 1/sqrt(n) for a mean, var or
# std (that sum over n), not at all for a selection (max, median,
# quantile), a product or a log-sum; bf16 results round the same f32 value to bf16 on
# both sides and may sit across a rounding edge: two bf16 ulps (2**-6
# relative); linear algebra, LAPACK against cuSOLVER at n = 768 with
# condition ~3: n eps cond ~ 1.4e-4, held at 1e-3; the norms' statistics
# sum 1e5 terms a channel: 1e-4 on their O(1) outputs
TA_TOL = {"float32": {"ew": (1e-5, 1e-6), "special": (1e-5, 5e-6),
                      "reduce": (1e-4, 1e-4), "linalg": (1e-3, 1e-3),
                      "norm": (1e-4, 1e-4)},
          "bfloat16": {"ew": (2.0 ** -6, 1e-5), "special": (2.0 ** -6, 1e-5),
                       "reduce": (2.0 ** -6, 1e-4)}}


def _op_tables():
    """tests/torch_op_tables.py, beside this script (loaded from its
    file: ``sys.path`` stays as it was)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "torch_op_tables.py"
    spec = importlib.util.spec_from_file_location("torch_op_tables", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ta_excess(torch, got, ref, family, dtype, n_terms=1, acc=None):
    """How far ``got`` (card) is beyond its tolerance of ``ref`` (CPU):
    max(|d| - atol - rtol |ref|) over the elements, <= 0 within it (NaN
    matching NaN); exact families must be equal.  ``acc`` scales atol by
    the ``n_terms`` behind one output (see `TA_TOL`)."""
    got, ref = got.detach(), ref.detach().to(got.device)
    if got.shape != ref.shape:
        return float("inf")
    if family == "exact" or not ref.is_floating_point():
        return 0.0 if torch.equal(got, ref) else float("inf")
    g, r = got.double(), ref.double()
    both_nan = torch.isnan(g) & torch.isnan(r)
    rtol, atol = TA_TOL[dtype][family]
    if acc == "sum":
        atol *= math.sqrt(n_terms)
    elif acc == "mean":
        atol /= math.sqrt(n_terms)
    d = torch.where(both_nan, 0.0, (g - r).abs() - atol - rtol * r.abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max()) \
        if d.numel() else 0.0


def _ta_terms(op, kw, shape):
    """The number of input elements behind one output of a reduction or
    scan (all of them without an axis)."""
    axis = kw.get("axis", kw.get("dim"))
    if axis is None and op.family == "reduce" and op.name not in (
            "cumsum", "cumprod"):
        return math.prod(shape)
    axes = axis if isinstance(axis, (list, tuple)) else [-1 if axis is None
                                                          else axis]
    return math.prod(shape[a] for a in axes)


def _ta_card_vs_cpu(torch, T, tab, op, inputs, shape, dtype, pool):
    """``op`` of the port on the card and on the CPU (``inputs(device,
    dtype)``: the op's inputs there, float ones in ``dtype``; ``auto_cast``
    for "bfloat16"); the worst excess over its variants' outputs.  The
    CPU variants run on ``pool``'s threads, beside the card's (a sort or a
    selection over one row keeps a single core busy)."""
    def run(device, v):
        xs = inputs(device, dtype)
        with T.amp.auto_cast(enable=dtype == "bfloat16", dtype="bfloat16"):
            return tab.flat(op.fn(T)(*xs, **dict(op.kw, **v)))

    cpu = [pool.submit(run, "cpu", v) for v in op.variants]
    card = [run("cuda", v) for v in op.variants]
    worst = -float("inf")
    for v, gs, rs in zip(op.variants, card, cpu):
        n = _ta_terms(op, dict(op.kw, **v), shape)
        for g, r in zip(gs, rs.result()):
            worst = max(worst, _ta_excess(torch, g, r, op.family, dtype, n,
                                          op.acc))
    return worst


def _ta_linalg_check(tab, op, got, ref, a):
    """Hold a card decomposition by its invariants against the CPU's
    (`torch_op_tables.linalg_excess`, the CPU tests' own checker): the
    worst excess over them."""
    def host(ts):
        return [t.detach().cpu().numpy() for t in ts]

    return max(tab.linalg_excess(op.check, host(got), host(ref),
                                 a.numpy(), *TA_TOL["float32"]["linalg"])
               .values())


def _ta_table_inputs(torch, rng, shape):
    """``inputs_of(op) -> (inputs(device, dtype), cpu tensors)``: one draw
    of each input kind (a draw an argument position) for a whole table,
    placed once on each device and in each dtype (floats only)."""
    drawn, placed = {}, {}

    def inputs_of(op):
        keys = [(kind, i) for i, kind in enumerate(op.ins)]
        for key in keys:
            if key not in drawn:
                drawn[key] = torch.from_numpy(key[0](rng, shape))

        def inputs(device, dtype):
            for key in keys:
                if key + (device, dtype) not in placed:
                    t = drawn[key].to(device)
                    placed[key + (device, dtype)] = t.to(
                        getattr(torch, dtype)) if t.is_floating_point() else t
            return [placed[key + (device, dtype)] for key in keys]
        return inputs, [drawn[k] for k in keys]
    return inputs_of


def _ta_linalg_rows(torch, T, tab, rng, pool, record):
    for n, batch in TA_LINALG:
        cases = [(op, [torch.from_numpy(a)
                       for a in op.inputs(rng, n, batch)])
                 for op in tab.LINALG]
        refs = [pool.submit(lambda op, xs: tab.flat(op.fn(T)(*xs, **op.kw)),
                            op, xs) for op, xs in cases]
        for (op, xs), ref in zip(cases, refs):
            got = tab.flat(op.fn(T)(*[x.cuda() for x in xs], **op.kw))
            record("linalg", f"{op.ns}.{op.label}".lstrip("."), "float32",
                   _ta_linalg_check(tab, op, got, ref.result(), xs[0]),
                   list(xs[0].shape))


def _ta_norm_rows(torch, T, tab, rng, record):
    import numpy as np

    x = tab.normal(rng, TA_NORMS)
    for op in tab.NORMS:
        outs = {}
        for device in ("cuda", "cpu"):
            args, kw = tab.norm_args(
                op, x, np.random.default_rng(SEED),
                lambda a: torch.from_numpy(a).to(device))
            out = op.fn(T)(torch.from_numpy(x).to(device), *args,
                           **dict(op.kw, **kw))
            outs[device] = [out] + [a for a in args
                                    if isinstance(a, torch.Tensor)]
        record("norm", op.label, "float32", max(
            _ta_excess(torch, g, r, "norm", "float32")
            for g, r in zip(outs["cuda"], outs["cpu"])), TA_NORMS)


def tensor_api_tables(torch, T, tab, rng):
    """Part (a): each row of the op tables on the card against the port on
    the CPU, within `TA_TOL`.  The CPU references that hold one core each
    (a sort over one row, a LAPACK factorization) run on `TA_CPU_THREADS`
    threads beside the card's work."""
    rows, seconds = [], {}

    def record(family, label, dtype, excess, shape):
        rows.append(dict(family=family, op=label, dtype=dtype,
                         shape=list(shape), excess=float(excess),
                         ok=bool(excess <= 0)))

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(TA_CPU_THREADS) as pool:
        for family, table, shape in (
                ("elementwise", tab.ELEMENTWISE, TA_STREAM),
                ("reduction", tab.REDUCTIONS, TA_STREAM),
                ("search", tab.SEARCH, TA_LOGITS)):
            seconds[family] = -time.perf_counter()
            inputs_of = _ta_table_inputs(torch, rng, shape)
            for op in table:
                inputs, tensors = inputs_of(op)
                floats = any(t.dtype == torch.float32 for t in tensors)
                for dtype in ["float32"] + (
                        ["bfloat16"] if family != "search" and floats
                        else []):
                    record(family, op.label, dtype, _ta_card_vs_cpu(
                        torch, T, tab, op, inputs, shape, dtype, pool),
                        shape)
            seconds[family] += time.perf_counter()
        seconds["linalg"] = -time.perf_counter()
        _ta_linalg_rows(torch, T, tab, rng, pool, record)
        seconds["linalg"] += time.perf_counter()
    seconds["norm"] = -time.perf_counter()
    _ta_norm_rows(torch, T, tab, rng, record)
    seconds["norm"] += time.perf_counter()
    print("tensor api (a) seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    bad = [f"{r['family']} {r['op']} {r['dtype']} {r['shape']} (excess "
           f"{r['excess']:.3g})" for r in rows if not r["ok"]]
    if bad:
        fail(f"phase 21 (a): beyond tolerance: {'; '.join(bad)}")
    return rows


def tensor_api_devices(torch, T):
    """Part (b): every creation and random op, ``to_tensor`` and a new
    layer's parameters and buffers, without a place, land on the current
    card (cuda:0 here), on the CPU after ``set_device("cpu")``, and, where
    the machine has a second card, on cuda:1 after
    ``torch.cuda.set_device(1)`` (as a launched rank sets its card); an op
    over a tensor keeps its device.  The expected device is restored."""
    from paddle_tpu_torch.core import place as tplace

    made = {
        "zeros": lambda: T.zeros([2, 3]), "ones": lambda: T.ones([2]),
        "full": lambda: T.full([2], 1.5), "empty": lambda: T.empty([2]),
        "arange": lambda: T.arange(5), "linspace": lambda: T.linspace(0, 1, 3),
        "logspace": lambda: T.logspace(0, 1, 3), "eye": lambda: T.eye(3),
        "assign": lambda: T.assign([1.0, 2.0]),
        "to_tensor": lambda: T.to_tensor([1, 2]),
        "uniform": lambda: T.uniform([4]), "rand": lambda: T.rand([4]),
        "normal": lambda: T.normal(0.0, 1.0, [4]),
        "gaussian": lambda: T.gaussian([4]), "randn": lambda: T.randn([4]),
        "standard_normal": lambda: T.standard_normal([4]),
        "randint": lambda: T.randint(0, 5, [4]),
        "randperm": lambda: T.randperm(6),
        "nn.Linear.weight": lambda: T.nn.Linear(4, 4).weight,
        "nn.BatchNorm2D._mean": lambda: T.nn.BatchNorm2D(4)._mean,
    }
    keeps = {"zeros_like": T.zeros_like, "full_like":
             lambda x: T.full_like(x, 2.0), "randint_like":
             lambda x: T.randint_like(x, 0, 3), "normal_like": T.normal_like,
             "bernoulli": lambda x: T.bernoulli(x * 0 + 0.5),
             "shuffle": T.shuffle}
    card = f"cuda:{torch.cuda.current_device()}"
    settings = [("default", None, card), ("cpu", "cpu", "cpu")]
    if torch.cuda.device_count() >= 2:
        settings.append(("current card 1", 1, "cuda:1"))
    res = {}
    prev = tplace._EXPECTED_DEVICE[0]
    for place, setting, want in settings:
        tplace._EXPECTED_DEVICE[0] = None
        try:
            if setting == "cpu":
                T.set_device("cpu")
            elif setting is not None:
                torch.cuda.set_device(setting)
            got = {k: str(fn().device) for k, fn in made.items()}
            x = torch.ones(4, device=card)
            got.update({k: str(fn(x).device) for k, fn in keeps.items()})
        finally:
            tplace._EXPECTED_DEVICE[0] = prev
            torch.cuda.set_device(int(card[5:]))
        want_of = {k: (card if k in keeps else want) for k in got}
        bad = {k: v for k, v in got.items() if v != want_of[k]}
        if bad:
            fail(f"phase 21 (b) {place}: tensors on the wrong device: {bad}")
        res[place] = got
    print(f"tensor api (b): {len(made)} creation and random ops, to_tensor "
          f"and new layers land on the current card by default "
          f"({', '.join(w for p, _, w in settings if p != 'cpu')}) and on "
          f"the CPU after set_device('cpu'); {len(keeps)} ops over a card "
          "tensor stay on it", flush=True)
    return res


def tensor_api_random(torch, T):
    """Part (c): 2**24 draws of each distribution on the card: moments
    within 5 standard errors, a Kolmogorov-Smirnov test against the
    uniform and normal CDFs and chi-square tests of the discrete draws at
    p > 1e-4 (fixed seeds: the p-values are the card's, fixed); the same
    ``paddle.seed`` repeats a draw on the card, another seed changes it."""
    import numpy as np
    import scipy.stats

    n = TA_DRAWS
    res = {}
    T.seed(SEED)

    def normal_cdf(mean, std):
        return lambda x: 0.5 * (1 + torch.erf((x - mean) / (std * 2 ** 0.5)))

    def ks_pvalue(x, cdf):
        """The one-sample Kolmogorov-Smirnov p-value of ``x`` against
        ``cdf``; the sort and the statistic in f64 on the card."""
        f = cdf(torch.sort(x).values)
        i = torch.arange(1, n + 1, device=x.device, dtype=torch.float64)
        d = max(float((i / n - f).max()), float((f - (i - 1) / n).max()))
        return float(scipy.stats.kstwo.sf(d, n))

    checks = {
        "uniform": (lambda: T.uniform([n], min=-2.0, max=3.0), 0.5, 25 / 12,
                    lambda x: (x + 2.0) / 5.0),
        "randn": (lambda: T.randn([n]), 0.0, 1.0, normal_cdf(0.0, 1.0)),
        "normal": (lambda: T.normal(1.0, 2.0, [n]), 1.0, 4.0,
                   normal_cdf(1.0, 2.0)),
    }
    for name, (draw, mean, var, cdf) in checks.items():
        x = draw().double()
        m, v = float(x.mean()), float(x.var())
        ks = ks_pvalue(x, cdf)
        ok = (abs(m - mean) <= 5 * math.sqrt(var / n)
              and abs(v - var) <= 5 * var * math.sqrt(2 / n) and ks > 1e-4)
        res[name] = dict(mean=m, var=v, ks_p=ks, ok=bool(ok))
        if not ok:
            fail(f"phase 21 (c) {name}: mean {m} var {v} KS p {ks}")
    discrete = {
        "randint": (lambda: T.randint(0, 10, [n]), [0.1] * 10),
        "bernoulli": (lambda: T.bernoulli(T.full([n], 0.3)), [0.7, 0.3]),
        "multinomial": (lambda: T.multinomial(T.to_tensor(
            [0.1, 0.2, 0.3, 0.4]), n), [0.1, 0.2, 0.3, 0.4]),
        "poisson": (lambda: torch.clamp(T.poisson(T.full([n], 3.0)), max=9),
                    [scipy.stats.poisson(3.0).pmf(k) for k in range(9)]
                    + [scipy.stats.poisson(3.0).sf(8)]),
    }
    for name, (draw, p) in discrete.items():
        counts = torch.bincount(draw().long(), minlength=len(p)).cpu().numpy()
        chi = float(scipy.stats.chisquare(counts, np.asarray(p) * n).pvalue)
        res[name] = dict(counts=counts.tolist(), chi2_p=chi,
                         ok=bool(chi > 1e-4))
        if chi <= 1e-4:
            fail(f"phase 21 (c) {name}: chi-square p {chi} ({counts})")
    T.seed(SEED + 1)
    a = T.randn([1024])
    T.seed(SEED + 1)
    b = T.randn([1024])
    T.seed(SEED + 2)
    c = T.randn([1024])
    if not torch.equal(a, b) or torch.equal(a, c):
        fail("phase 21 (c): paddle.seed does not repeat a draw on the card")
    res["seed_repeats"] = True
    print(f"tensor api (c): {TA_DRAWS} draws each: " + ", ".join(
        f"{k} p={v.get('ks_p', v.get('chi2_p')):.3g}" for k, v in res.items()
        if isinstance(v, dict)) + "; the same seed repeats a draw",
        flush=True)
    return res


def tensor_api_layer_norm(torch, T):
    """Part (d): ``nn.LayerNorm(768)`` and ``nn.functional.layer_norm`` under
    ``FLAGS_use_pallas_layernorm`` on [16384, 768]: K5 launched once a call
    (counted from 0 over the path's run), each output within `LN_TOL` of
    the plain version."""
    from paddle_tpu_torch.core import flags as tflags
    from paddle_tpu_torch.ops.layer_norm import layer_norm

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(TA_LN_ROWS, 768, generator=gen, device="cuda") * 2 + 0.5
    ln = T.nn.LayerNorm(768)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(768, generator=gen,
                                              device="cuda"))
        ln.bias.copy_(0.1 * torch.randn(768, generator=gen, device="cuda"))
    tflags.set_flags({"use_pallas_layernorm": True})
    try:
        with torch.no_grad():
            reset_counts()
            outs = [ln(x) for _ in range(TA_LN_STEPS)]
            outs.append(T.nn.functional.layer_norm(x, 768, ln.weight,
                                                   ln.bias))
            torch.cuda.synchronize()
            launches = read_counts()["layer_norm"]
            ref = layer_norm(x, ln.weight, ln.bias, 1e-5)
    finally:
        tflags.set_flags({"use_pallas_layernorm": False})
    tol = LN_TOL["float32"]
    err = max(float((o - ref).abs().max()) for o in outs)
    want = TA_LN_STEPS + 1
    if launches != want:
        fail(f"phase 21 (d): K5 launched {launches} times through "
             f"nn.LayerNorm and F.layer_norm, want {want}")
    if err > tol["abs"]:
        fail(f"phase 21 (d): K5 through nn.LayerNorm beyond {tol}: {err}")
    print(f"tensor api (d): nn.LayerNorm(768) x {TA_LN_STEPS} and "
          f"F.layer_norm on [{TA_LN_ROWS}, 768] under the flag: K5 "
          f"launched {launches} times, max_abs_err {err:.3g}", flush=True)
    return dict(launches=launches, max_abs_err=err, calls=want)


def tensor_api_phase(torch):
    """Phase 21: the op tables on the card against the CPU (a), the device
    default (b), random draws (c), K5 through ``nn.LayerNorm`` (d); a few
    op times printed with the card line."""
    import numpy as np

    import paddle_tpu_torch as T

    tab = _op_tables()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    rows = tensor_api_tables(torch, T, tab, rng)
    tables_s = time.perf_counter() - t0
    by_family = {}
    for r in rows:
        by_family.setdefault(f"{r['family']} {r['dtype']}", []).append(r)
    print("tensor api (a): " + "; ".join(
        f"{k}: {len(v)} ops, worst excess {max(r['excess'] for r in v):.3g}"
        for k, v in by_family.items()) + f" ({tables_s:.1f} s)", flush=True)
    x = torch.randn(*TA_STREAM, device="cuda")
    logits = torch.randn(*TA_LOGITS, device="cuda")
    img = torch.randn(*TA_NORMS, device="cuda")
    rm = torch.zeros(TA_NORMS[1], device="cuda")
    rv = torch.ones(TA_NORMS[1], device="cuda")
    timed = {
        f"add f32 {list(TA_STREAM)}": lambda: T.add(x, x),
        f"sum axis=-1 f32 {list(TA_STREAM)}": lambda: T.sum(x, axis=-1),
        f"topk k=5 f32 {list(TA_LOGITS)}": lambda: T.topk(logits, 5),
        f"batch_norm train f32 {list(TA_NORMS)}":
            lambda: T.nn.functional.batch_norm(img, rm, rv, training=True)}
    times = {k: time_ms(torch, fn, reps=10) for k, fn in timed.items()}
    del x, logits, img
    card = card_line()
    print(f"tensor api op ms on {card}: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    res = dict(tables=rows, tables_s=tables_s, op_ms=times, card=card,
               devices=tensor_api_devices(torch, T),
               random=tensor_api_random(torch, T),
               layer_norm=tensor_api_layer_norm(torch, T))
    return res


# ---------------------------------------------------------------------------
# phase 22: the rest of nn at full width
# ---------------------------------------------------------------------------
NN_ROOT = Path("build") / "chip_smoke_nn"
# (a) BERT-base pretraining (BertConfig()'s defaults: bert-base-uncased):
# batch 16 x 512 with 80 masked positions a row (15% of 512, rounded up to
# a multiple of 16), 3 AdamW steps under bf16 auto_cast.  In f32 at 2 x
# 128 (20 masks), dropout off, the card against the port on the CPU: the
# loss before each of NN_BERT_F32_STEPS AdamW steps within 1e-4 relative
# (the two sum each product in another order over 12 layers, ~1e-6 of an
# O(10) loss), and the first step's parameter update within
# NN_BERT_UPDATE_TOL (relative norm): Adam's first update is
# lr * g / (|g| + eps), elementwise about lr * sign(g), so an element
# whose gradient lies within the devices' rounding of 0 can move 2 lr the
# other way; 1e-2 allows 2.5e-5 of the elements to flip.  The same
# 16 x 512 steps at each (lr, dropout, bf16 auto_cast or f32) of
# NN_BERT_CONTROLS are run beside them as controls of the loss's trend
# (their losses are reported, not checked)
NN_BERT = dict(batch=16, seq=512, masks=80, steps=3)
NN_BERT_CPU = dict(batch=2, seq=128, masks=20)
NN_BERT_LOSS_RTOL = 1e-4
NN_BERT_F32_STEPS = 3
NN_BERT_UPDATE_TOL = 1e-2
NN_BERT_CONTROLS = ((1e-5, 0.1, True), (1e-4, 0.0, True),
                    (1e-5, 0.0, True), (1e-4, 0.0, False),
                    (1e-5, 0.0, False))
# (b) ViT-B/16's encoder: 197 tokens (196 patches and the class token) of
# 768, 12 pre-norm GELU layers, batch 64 in bf16; each output and gradient
# within NN_VIT_TOL (relative norm) of the composed form on the card: the
# kernels round p and ds to bf16 where the composed form rounds the
# probabilities once (FLASH_TOL's 2e-2), compounded over 12 layers
NN_VIT = (64, 197, 768)
NN_VIT_STEPS = 3
NN_VIT_TOL = 3e-2
# (c) Transformer-base (512 wide, 8 heads, 6 + 6 layers, 2048), a shared
# vocabulary of WMT14 en-de's size, one masked train step on 16 x 128, then
# beam 4 over 32 steps at batch 2 from 32 source tokens: tokens equal to
# the CPU's, scores within 1e-4 relative
NN_TRANS_VOCAB = 37000
NN_TRANS_TRAIN = (16, 128)
NN_BEAM = dict(beam=4, steps=32, batch=2, src=32)
NN_BEAM_SCORE_RTOL = 1e-4
# (d) the PTB "medium" LSTM: vocabulary 10000, 650 wide, 2 layers, 35
# steps, batch 20; and the conv, pool and sampling tables of
# tests/torch_op_tables.py at ResNet-50's four stages, batch 4
NN_LSTM = dict(vocab=10000, hidden=650, layers=2, steps=35, batch=20)
NN_LSTM_GRAD_TOL = 1e-4  # f32 gradients, relative norm
NN_STAGES = ((4, 64, 56, 56), (4, 128, 28, 28), (4, 256, 14, 14),
             (4, 512, 7, 7))
# (e) SyncBatchNorm over ranks on [16, 256, 28, 28] (global), each
# channel's mean about 100 against a std of 1 (where a one-pass variance
# cancels), against BatchNorm on the whole batch on the card, TA_TOL's
# "norm"
NN_SYNC_BN = (16, 256, 28, 28)


def _rel_norm(torch, a, b):
    """||a - b|| / ||b|| in f64."""
    a, b = a.detach().double(), b.detach().double().to(a.device)
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _bert_batch(torch, cfg, batch, seq, masks, gen, device):
    """Token ids with the last 32 (seq / 16) tokens of every other row
    padding, two segments, masked positions and labels, NSP labels."""
    v = cfg.vocab_size

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen).to(device)

    ids = ints(3, v, batch, seq)
    ids[1::2, -seq // 16:] = cfg.pad_token_id
    types = (torch.arange(seq) >= seq // 2).long().expand(batch, seq)
    return [ids, types.to(device).contiguous(), ints(0, seq, batch, masks),
            ints(3, v, batch, masks), ints(0, 2, batch),
            torch.ones(batch, masks, device=device)]


def _bert_f32_steps(torch, T, B, cfg, device, batch, state):
    """``NN_BERT_F32_STEPS`` f32 AdamW steps of ``cfg``'s BertForPretraining
    on ``device`` from ``state`` (its state dict on the CPU): the losses
    and the first step's update of every parameter (on the CPU, in
    f64)."""
    model = B.BertForPretraining(cfg, device=device).train()
    _, unexpected = model.set_state_dict(state)
    if unexpected:
        fail(f"phase 22 (a): names BERT lacks: {unexpected}")
    step = T.jit.TrainStep(model, B.bert_pretrain_loss_fn, dist_adamw(model))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    losses = [float(step(*batch))]
    update = {k: (p.detach() - before[k]).cpu().double()
              for k, p in model.named_parameters()}
    losses += [float(step(*batch)) for _ in range(NN_BERT_F32_STEPS - 1)]
    return losses, update


def _bert_card_steps(torch, T, B, cfg, batch, lr, bf16=True):
    """``NN_BERT["steps"]`` AdamW(lr) steps under bf16 ``auto_cast`` (or
    in f32) through ``jit.TrainStep`` on the card (seed SEED): the
    losses, each step's seconds, the launches and the peak memory."""
    T.seed(SEED)
    model = B.BertForPretraining(cfg, device="cuda").train()

    def loss_fn(m, *b):
        with T.amp.auto_cast(enable=bf16, dtype="bfloat16"):
            return B.bert_pretrain_loss_fn(m, *b)

    step = T.jit.TrainStep(model, loss_fn, T.optimizer.AdamW(
        lr, parameters=model.parameters(), weight_decay=0.01))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for _ in range(NN_BERT["steps"]):
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    del model, step
    torch.cuda.empty_cache()
    return losses, times, launches, peak


def nn_bert_check(torch, T):
    """(a) BERT-base: f32 AdamW steps at 2 x 128 on the card against the
    same on the CPU, then 3 bf16 AdamW steps at 16 x 512 through
    ``jit.TrainStep`` (and NN_BERT_CONTROLS' runs); the attention is the
    composed form (BERT's additive mask), so K3/K4 launch 0 times."""
    import dataclasses

    from paddle_tpu_torch.models import bert as B

    cfg = B.BertConfig()
    quiet = dataclasses.replace(cfg, hidden_dropout=0.0,
                                attention_dropout=0.0)
    gen = torch.Generator().manual_seed(SEED)
    small = _bert_batch(torch, cfg, **NN_BERT_CPU, gen=gen, device="cpu")
    T.seed(SEED)
    state = {k: v.detach().cpu().clone() for k, v in B.BertForPretraining(
        quiet, device="cuda").state_dict().items()}
    got, d_card = _bert_f32_steps(torch, T, B, quiet, "cuda",
                                  [t.cuda() for t in small], state)
    torch.cuda.empty_cache()
    want, d_cpu = _bert_f32_steps(torch, T, B, quiet, "cpu", small, state)
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    if not rel <= NN_BERT_LOSS_RTOL:
        fail(f"phase 22 (a): BERT-base f32 losses {got} on the card, {want} "
             f"on the CPU (relative {rel:.3g} > {NN_BERT_LOSS_RTOL})")
    num = sum(float((d_card[k] - d).pow(2).sum()) for k, d in d_cpu.items())
    den = sum(float(d.pow(2).sum()) for d in d_cpu.values())
    update_rel = math.sqrt(num / den)
    if not update_rel <= NN_BERT_UPDATE_TOL:
        fail(f"phase 22 (a): BERT-base's first f32 AdamW update on the card "
             f"is {update_rel:.3g} (relative norm) off the CPU's "
             f"(> {NN_BERT_UPDATE_TOL})")
    del d_card, d_cpu

    batch = _bert_batch(torch, cfg, NN_BERT["batch"], NN_BERT["seq"],
                        NN_BERT["masks"], gen, "cuda")
    losses, times, launches, peak = _bert_card_steps(
        torch, T, B, cfg, batch, 1e-4)
    controls = [dict(lr=lr, dropout=p, bf16=bf16, losses=_bert_card_steps(
        torch, T, B, dataclasses.replace(cfg, hidden_dropout=p,
                                         attention_dropout=p),
        batch, lr, bf16)[0]) for lr, p, bf16 in NN_BERT_CONTROLS]
    if not all(math.isfinite(x) for x in
               losses + [y for c in controls for y in c["losses"]]):
        fail(f"phase 22 (a): BERT-base losses {losses}, {controls}")
    if any(launches[k] for k in FLASH_KERNELS):
        fail(f"phase 22 (a): BERT's masked attention launched K3/K4 "
             f"{launches}; the composed form was expected")
    ms = statistics.median(times[1:]) * 1e3
    tokens = NN_BERT["batch"] * NN_BERT["seq"]
    print(f"nn (a): BERT-base 16 x 512 bf16: {ms:.1f} ms a step, "
          f"{tokens / ms * 1e3:.0f} tokens/s, peak "
          f"{peak / 2 ** 30:.2f} GiB, losses "
          f"{[round(x, 4) for x in losses]} (lr, dropout, bf16: "
          + "; ".join(f"{c['lr']}, {c['dropout']}, {c['bf16']}: "
                      f"{[round(x, 4) for x in c['losses']]}"
                      for c in controls)
          + f"); f32 2 x 128 losses "
          f"{[round(x, 6) for x in got]} (CPU "
          f"{[round(x, 6) for x in want]}, relative {rel:.2e}), first "
          f"update {update_rel:.2e} off the CPU's", flush=True)
    return dict(step_ms=ms, step_s=times, tokens_per_s=tokens / ms * 1e3,
                peak_memory_bytes=peak, losses=losses, controls=controls,
                launches=launches, f32_losses=got, cpu_losses=want,
                f32_loss_rel=rel, f32_update_rel=update_rel)


def nn_vit_check(torch, T):
    """(b) The unmasked pre-norm encoder at ViT-B/16 width in bf16: one
    forward and backward through K3/K4 against the same with an all-zero
    additive mask (the composed form), then 3 AdamW steps with the launches
    counted from 0: 12 forward, 12 dkv and 12 dq a step."""
    nn = T.nn
    T.seed(SEED)
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        768, 12, 3072, activation="gelu", normalize_before=True), 12)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x0 = torch.randn(*NN_VIT, generator=gen, device="cuda").bfloat16()
    cot = torch.randn(*NN_VIT, generator=gen, device="cuda")
    params = [p for p in enc.parameters()]
    enc.eval()

    def run(mask):
        x = x0.clone().requires_grad_(True)
        with T.amp.auto_cast(dtype="bfloat16"):
            out = enc(x, src_mask=mask)
        grads = torch.autograd.grad((out.float() * cot).sum(), [x] + params)
        return out.detach(), grads

    reset_counts()
    out, grads = run(None)
    one = read_counts()
    ref, ref_grads = run(torch.zeros(1, 1, 1, NN_VIT[1], device="cuda"))
    # the parameters' gradients as one vector: a key bias's gradient is 0
    # up to rounding (the softmax ignores a shift of a query's logits)
    errs = dict(out=_rel_norm(torch, out, ref),
                dx=_rel_norm(torch, grads[0], ref_grads[0]),
                params=_rel_norm(torch,
                                 torch.cat([g.flatten() for g in grads[1:]]),
                                 torch.cat([r.flatten()
                                            for r in ref_grads[1:]])))
    if any(one[k] != 12 for k in FLASH_KERNELS):
        fail(f"phase 22 (b): one pass launched {one}, want 12 each")
    if not max(errs.values()) <= NN_VIT_TOL:
        fail(f"phase 22 (b): K3/K4 at S=197 against the composed form "
             f"beyond {NN_VIT_TOL} (relative norm): {errs}")
    del grads, ref_grads
    enc.train()
    y = torch.randn(*NN_VIT, generator=gen, device="cuda")

    def loss_fn(m, x, y):
        with T.amp.auto_cast(dtype="bfloat16"):
            return ((m(x).float() - y) ** 2).mean()

    step = T.jit.TrainStep(enc, loss_fn, dist_adamw(enc))
    torch.cuda.synchronize()
    reset_counts()
    times, losses = [], []
    for _ in range(NN_VIT_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(x0, y)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts()
    want = 12 * NN_VIT_STEPS
    if any(launches[k] != want for k in FLASH_KERNELS):
        fail(f"phase 22 (b): the encoder's steps launched {launches}, want "
             f"{want} each of K3 and K4's dkv and dq")
    ms = statistics.median(times[1:]) * 1e3
    print(f"nn (b): ViT-B/16 encoder [64, 197, 768] bf16: K3/K4 "
          f"{launches['fwd']}/{launches['dkv']}/{launches['dq']} over "
          f"{NN_VIT_STEPS} steps, {ms:.1f} ms a step; against the composed "
          f"form {', '.join(f'{k} {v:.2e}' for k, v in errs.items())}",
          flush=True)
    del enc, step
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=ms, losses=losses,
                composed_rel_err=errs)


class _Seq2Seq:
    """Transformer-base with a shared embedding (scaled by sqrt(512)),
    sinusoidal positions and an output projection."""

    def __init__(self, T, device):
        import torch

        from paddle_tpu_torch.core.place import expected_device

        nn = T.nn
        with expected_device(device):
            self.net = nn.LayerDict(dict(
                emb=nn.Embedding(NN_TRANS_VOCAB, 512,
                                 weight_attr=nn.initializer.Normal(
                                     0.0, 512 ** -0.5)),
                tf=nn.Transformer(512, 8, 6, 6, 2048),
                head=nn.Linear(512, NN_TRANS_VOCAB)))
        pos = torch.arange(1024.0)[:, None]
        freq = torch.exp(torch.arange(0, 512, 2) * (-math.log(1e4) / 512))
        self.pe = torch.stack([torch.sin(pos * freq), torch.cos(pos * freq)],
                              -1).reshape(1024, 512)

    def embed(self, ids, start=0):
        pe = self.pe[start:start + ids.shape[-1]].to(ids.device)
        return self.net["emb"](ids) * math.sqrt(512) + pe

    def loss(self, net, src, tgt_in, tgt_out, T):
        mask = net["tf"].generate_square_subsequent_mask(tgt_in.shape[1])
        with T.amp.auto_cast(dtype="bfloat16"):
            h = net["tf"](self.embed(src), self.embed(tgt_in),
                          tgt_mask=mask.to(src.device))
            logits = net["head"](h)
        return T.nn.functional.cross_entropy(
            logits.float().reshape(-1, NN_TRANS_VOCAB), tgt_out.reshape(-1))

    def beam(self, T, src):
        """Beam search over the decoder's incremental caches (a concat
        cache and the static memory a layer); a step's position is the
        length of the first layer's cache."""
        tf = self.net["tf"]
        memory = tf.encoder(self.embed(src))
        caches = tf.decoder.gen_cache(memory)

        def cell(inp, states):
            x = self.embed(inp[:, None], states[0][0].k.shape[2])
            out, new = tf.decoder(x, memory, None, None, states)
            return out[:, 0], new

        dec = T.nn.BeamSearchDecoder(cell, 1, 2, NN_BEAM["beam"],
                                     output_fn=self.net["head"])
        return T.nn.dynamic_decode(dec, caches,
                                   max_step_num=NN_BEAM["steps"],
                                   batch_size=src.shape[0])


def nn_transformer_check(torch, T):
    """(c) Transformer-base: one masked bf16 AdamW step (K3/K4 on the
    encoder's self-attention and the decoder's cross-attention, the
    decoder's masked self-attention composed), then beam 4 over 32 steps
    on the card and on the CPU from the same weights: equal tokens."""
    import copy

    T.seed(SEED)
    s2s = _Seq2Seq(T, "cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    b, s = NN_TRANS_TRAIN
    src, tgt = (torch.randint(3, NN_TRANS_VOCAB, (b, s + 1), generator=gen)
                .cuda() for _ in range(2))
    step = T.jit.TrainStep(
        s2s.net, lambda net, a, t_in, t_out: s2s.loss(net, a, t_in, t_out,
                                                      T),
        dist_adamw(s2s.net))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    loss = float(step(src[:, :s], tgt[:, :-1], tgt[:, 1:]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_counts()
    if not math.isfinite(loss) or any(train_launches[k] != 12
                                      for k in FLASH_KERNELS):
        fail(f"phase 22 (c): Transformer-base step loss {loss}, launches "
             f"{train_launches} (want 12 each: 6 encoder self-attentions "
             f"and 6 cross-attentions; the masked self-attention composed)")
    del step
    s2s.net.eval()
    beam_src = torch.randint(3, NN_TRANS_VOCAB,
                             (NN_BEAM["batch"], NN_BEAM["src"]),
                             generator=gen)
    cpu = copy.copy(s2s)
    cpu.net = copy.deepcopy(s2s.net).to("cpu")
    with torch.no_grad():
        reset_counts()
        t0 = time.perf_counter()
        seqs, scores = s2s.beam(T, beam_src.cuda())
        torch.cuda.synchronize()
        beam_s = time.perf_counter() - t0
        decode_launches = read_counts()["fwd"]
        want_seqs, want_scores = cpu.beam(T, beam_src)
    steps = seqs.shape[1]
    if not torch.equal(seqs.cpu(), want_seqs):
        first = int((seqs.cpu() != want_seqs).nonzero()[0, 1])
        fail(f"phase 22 (c): beam tokens on the card differ from the CPU's "
             f"from step {first}: {seqs.cpu()[:, first].tolist()} against "
             f"{want_seqs[:, first].tolist()}")
    score_rel = float(((scores.cpu() - want_scores).abs()
                       / want_scores.abs()).max())
    if not score_rel <= NN_BEAM_SCORE_RTOL:
        fail(f"phase 22 (c): beam scores relative {score_rel:.3g}")
    # the encoder's 6 self-attentions over the source, then 6 self- and 6
    # cross-attentions a step
    want_launches = 6 + 12 * steps
    if decode_launches != want_launches:
        fail(f"phase 22 (c): the decode launched K3 {decode_launches} "
             f"times over {steps} steps, want {want_launches}")
    print(f"nn (c): Transformer-base train step {train_s * 1e3:.1f} ms "
          f"(loss {loss:.4f}; K3/K4 {train_launches['fwd']}/"
          f"{train_launches['dkv']}/{train_launches['dq']}); beam 4 x "
          f"{steps} steps at batch 2 in {beam_s:.2f} s, tokens equal to "
          f"the CPU's, scores within {score_rel:.2e}; K3 {decode_launches}",
          flush=True)
    del s2s, cpu
    torch.cuda.empty_cache()
    return dict(train_s=train_s, loss=loss, train_launches=train_launches,
                beam_s=beam_s, beam_steps=steps,
                decode_launches=decode_launches, score_rel=score_rel,
                tokens=seqs.cpu().tolist())


def nn_lstm_check(torch, T):
    """(d) The PTB medium LSTM language model, forward and backward in
    f32 on the card and on the CPU from the same weights: the loss and
    the outputs within TA_TOL's f32 "reduce" (its atol scaled by the
    1300 products behind a gate), every gradient within NN_LSTM_GRAD_TOL
    (relative norm)."""
    import copy

    cfg = NN_LSTM
    nn = T.nn
    T.seed(SEED)
    from paddle_tpu_torch.core.place import expected_device
    with expected_device("cuda"):
        net = nn.LayerDict(dict(
            emb=nn.Embedding(cfg["vocab"], cfg["hidden"]),
            rnn=nn.LSTM(cfg["hidden"], cfg["hidden"], cfg["layers"]),
            head=nn.Linear(cfg["hidden"], cfg["vocab"])))
    cpu = copy.deepcopy(net).to("cpu")
    gen = torch.Generator().manual_seed(SEED + 2)
    ids = torch.randint(0, cfg["vocab"], (cfg["batch"], cfg["steps"] + 1),
                        generator=gen)

    def run(m, ids):
        out, _ = m["rnn"](m["emb"](ids[:, :-1]))
        loss = T.nn.functional.cross_entropy(
            m["head"](out).reshape(-1, cfg["vocab"]), ids[:, 1:].reshape(-1))
        loss.backward()
        return out.detach(), loss.detach(), {
            k: p.grad for k, p in m.named_parameters()}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, loss, grads = run(net, ids.cuda())
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    ref, ref_loss, ref_grads = run(cpu, ids)
    n = 2 * cfg["hidden"]
    excess = max(_ta_excess(torch, out, ref, "reduce", "float32", n, "sum"),
                 _ta_excess(torch, loss, ref_loss, "reduce", "float32"))
    grad_err = max(_rel_norm(torch, grads[k], ref_grads[k]) for k in grads)
    if not (excess <= 0 and grad_err <= NN_LSTM_GRAD_TOL):
        fail(f"phase 22 (d): LSTM card against CPU: excess {excess}, "
             f"gradient relative {grad_err}")
    print(f"nn (d): LSTM 2 x 650, 35 steps, batch 20: forward and backward "
          f"{card_s * 1e3:.1f} ms on the card, loss {float(loss):.5f}, "
          f"worst excess {excess:.3g}, gradients within {grad_err:.2e}",
          flush=True)
    return dict(card_s=card_s, loss=float(loss), excess=excess,
                grad_rel_err=grad_err)


def _nn_terms(op, xs):
    """Products or elements behind one output of a table row."""
    if op.name.startswith("conv"):
        return math.prod(xs[1].shape[1:])
    if op.name == "adaptive_avg_pool2d":
        return math.prod(xs[0].shape[2:])
    if op.name.startswith("avg_pool"):
        k = op.kw["kernel_size"]
        return k * k
    if op.name in ("nce", "hsigmoid_loss"):
        return xs[0].shape[1] * 16
    return 1


def nn_table_rows(torch, T, tab, rng, pool):
    """(d) The conv, pool and sampling rows at each ResNet-50 stage, f32
    and bf16 (under ``auto_cast``), on the card against the port on the
    CPU (the CPU side on ``pool``'s thread): the worst TA_TOL excess a
    row.  cuDNN's TF32 starts at PyTorch's default (on; phase 4 turned it
    off): the port's convolutions must keep f32 in f32 themselves."""
    torch.backends.cudnn.allow_tf32 = True
    rows = []
    for shape in NN_STAGES:
        for op in tab.CONV_POOL + tab.SAMPLED:
            arrays = op.inputs(rng, shape)
            for dtype in ("float32", "bfloat16"):
                def run(device, arrays=arrays, dtype=dtype, op=op):
                    xs = [torch.from_numpy(a).to(device) for a in arrays]
                    xs = [x.to(getattr(torch, dtype))
                          if x.is_floating_point() else x for x in xs]
                    with T.amp.auto_cast(enable=dtype == "bfloat16",
                                         dtype="bfloat16"):
                        return tab.flat(op.call(T, *xs))

                ref = pool.submit(run, "cpu")
                got = run("cuda")
                n = _nn_terms(op, arrays)
                # index outputs must be equal (0 or inf); the row reports
                # its float outputs' worst excess
                ex = [(g.is_floating_point(),
                       _ta_excess(torch, g, r, op.family, dtype, n, op.acc))
                      for g, r in zip(got, ref.result())]
                ex = max([e for fl, e in ex if fl]
                         + [e for fl, e in ex if not fl and e > 0])
                rows.append(dict(op=op.label, shape=list(shape), dtype=dtype,
                                 excess=ex))
                if not ex <= 0:
                    fail(f"phase 22 (d): {op.label} {dtype} at {shape} "
                         f"beyond TA_TOL by {ex}")
    if torch.backends.cudnn.allow_tf32:
        fail("phase 22 (d): the port's f32 convolutions left cuDNN's TF32 "
             "on")
    return rows


def nn_syncbn_rank(out_dir):
    """One rank of 22(e), started by ``paddle.distributed.spawn``: a
    SyncBatchNorm over this rank's rows of the global batch, its output,
    the input's gradient and the running buffers saved."""
    import torch

    import paddle_tpu_torch as T
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env()
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    x, cot = _syncbn_inputs(torch)
    per = x.shape[0] // n
    x = x[r * per:(r + 1) * per].to(dev).requires_grad_(True)
    bn = T.nn.SyncBatchNorm(NN_SYNC_BN[1], device=dev)
    out = bn(x)
    dx, = torch.autograd.grad(out, [x], cot[r * per:(r + 1) * per].to(dev))
    torch.save(dict(rank=r, world=n, backend=dist.parallel.backend(),
                    out=out.detach().cpu(), dx=dx.cpu(), mean=bn._mean.cpu(),
                    var=bn._variance.cpu()),
               Path(out_dir) / f"rank{r}.pt")


def _syncbn_inputs(torch):
    gen = torch.Generator().manual_seed(SEED + 3)
    c = NN_SYNC_BN[1]
    return (torch.randn(*NN_SYNC_BN, generator=gen) + 100
            + torch.randn(1, c, 1, 1, generator=gen),
            torch.randn(*NN_SYNC_BN, generator=gen))


def nn_syncbn_check(torch, T):
    """(e) SyncBatchNorm over ranks from ``spawn`` (two sharing the card
    over gloo; one a card over NCCL when there are four cards) against
    BatchNorm over the global batch on the card."""
    import shutil

    from paddle_tpu_torch import distributed as dist

    nranks = 4 if torch.cuda.device_count() >= 4 else 2
    shutil.rmtree(NN_ROOT, ignore_errors=True)
    NN_ROOT.mkdir(parents=True)
    t0 = time.perf_counter()
    dist.spawn(nn_syncbn_rank, args=(str(NN_ROOT),), nprocs=nranks)
    spawn_s = time.perf_counter() - t0
    x, cot = _syncbn_inputs(torch)
    bn = T.nn.BatchNorm2D(NN_SYNC_BN[1], device="cuda")
    xg = x.cuda().requires_grad_(True)
    out = bn(xg)
    dx, = torch.autograd.grad(out, [xg], cot.cuda())
    per = x.shape[0] // nranks
    worst, backends = -float("inf"), set()
    for r in range(nranks):
        got = torch.load(NN_ROOT / f"rank{r}.pt")
        backends.add(got["backend"])
        rows = slice(r * per, (r + 1) * per)
        worst = max(worst, *(_ta_excess(torch, got[k].cuda(), want, "norm",
                                        "float32") for k, want in (
            ("out", out[rows]), ("dx", dx[rows]), ("mean", bn._mean),
            ("var", bn._variance))))
    if not worst <= 0:
        fail(f"phase 22 (e): SyncBatchNorm over {nranks} ranks beyond "
             f"TA_TOL's norm by {worst}")
    print(f"nn (e): SyncBatchNorm over {nranks} ranks ({', '.join(backends)})"
          f" on {list(NN_SYNC_BN)}: equal to BatchNorm on the global batch "
          f"(worst excess {worst:.3g}), {spawn_s:.1f} s with the spawn",
          flush=True)
    return dict(nranks=nranks, backends=sorted(backends), excess=worst,
                spawn_s=spawn_s)


def nn_phase(torch):
    """Phase 22: BERT-base (a), the ViT-B/16-width encoder on K3/K4 (b),
    Transformer-base with beam search (c), the LSTM and the conv, pool and
    sampling tables (d), SyncBatchNorm over ranks (e)."""
    import numpy as np

    import paddle_tpu_torch as T

    tab = _op_tables()
    res = dict(bert=nn_bert_check(torch, T), vit=nn_vit_check(torch, T),
               transformer=nn_transformer_check(torch, T),
               lstm=nn_lstm_check(torch, T))
    t0 = time.perf_counter()
    # one CPU thread pool runs the references beside the card's rows
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        rows = nn_table_rows(torch, T, tab, np.random.default_rng(SEED),
                             pool)
    worst = {}
    for r in rows:
        key = f"{r['op']} {r['dtype']}"
        worst[key] = max(worst.get(key, -float("inf")), r["excess"])
    print(f"nn (d): {len(rows)} conv/pool/sampling rows at ResNet-50's "
          f"stages within TA_TOL ({time.perf_counter() - t0:.1f} s); worst "
          f"excess {max(worst.values()):.3g}", flush=True)
    res["tables"] = rows
    res["syncbn"] = nn_syncbn_check(torch, T)
    res["card"] = card_line()
    return res


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# (a) ResNet-50 on ImageNet's training recipe (PaddleClas' ResNet50:
# Momentum 0.1, 0.9, L2 1e-4, batch 64 a card): FakeData of 3 x 256 x 256
# through RandomResizedCrop(224), a flip and ImageNet's normalisation in 8
# DataLoader workers, bf16 through Model.prepare(amp_configs=...), 3
# warm-up and 10 timed steps of Model.fit; then the f32 eval logits of 2
# images on the card against the port on the CPU from the same state,
# within VISION_CPU_TOL (relative norm: the card's convolutions stay f32,
# the two sum each product in another order over 50 layers)
VISION_RESNET = dict(batch=64, image=(3, 256, 256), crop=224, warm=3,
                     steps=10, workers=8)
VISION_CPU_TOL = 1e-4
# (b) ViT-B/16 (224, patches of 16: 197 tokens of 768, 12 layers and
# heads), batch 64, bf16 AdamW through jit.TrainStep, 3 steps: K3 and K4's
# dkv and dq 12 a step each; then the f32 eval logits of 2 images (dropout
# off), K3's f32 kernel on the card against the composed form on the CPU,
# within VISION_CPU_TOL
VISION_VIT = dict(batch=64, steps=3)
# (c) YOLOv3-DarkNet53 at COCO's width (80 classes) and
# PaddleDetection's yolov3_darknet53_270e_coco input: 8 images of 608 x 608
# a card, 50 ground-truth rows an image (5 to 30 real, the rest padding),
# Momentum 0.9 and L2 5e-4 at its lr 0.001 after a linear warm-up from 0
# over 4000 steps, 3 bf16 steps (the random weights barely move: the
# decode keeps its candidates); then the eval decode at the
# model's defaults (score 0.01, nms_top_k 400, keep_top_k 100, IoU 0.45):
# the card's multiclass_nms on the card's yolo_box outputs against the
# CPU's on the same outputs (labels, indices and counts equal; boxes and
# scores selected from equal inputs, so equal too)
VISION_YOLO = dict(batch=8, size=608, rows=50, real=(5, 30), steps=3,
                   warmup=4000)
# (d) the vision op table at detection-model shapes: a Faster R-CNN C4
# feature map of an 800 x 1344 image (stride 4 for the ROI ops: [2, 256,
# 200, 336], 512 ROIs an image of 16-256 pixels, 7 x 7, ratio 2), a
# deformable 3 x 3 of 256 channels on ResNet's [8, 256, 56, 56] stage,
# RPN proposals on stride 16 ([2, 15, 50, 84], 15 anchors a cell, the
# defaults 6000 -> 1000), NMS over 2000 boxes, the multiclass and matrix
# NMS over [4, 80, 2000], YOLOv3's stride-8 head [8, 255, 76, 76], the box
# coder over 20000 priors and SSD's conv4_3 priors; each card output (and
# gradient, where the op has one) against the CPU's within TA_TOL's f32
# "reduce" (atol grown by sqrt(n) for a sum of n terms), indices and
# counts equal
VISION_ROI = dict(feat=(2, 256, 200, 336), rois=512, image=(800, 1344),
                  scale=0.25, out=7, ratio=2)
VISION_DEFORM = (8, 256, 56, 56)


def _vision_sync_ms(torch, fn):
    """``(result, ms)`` of ``fn()`` between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _vision_cpu_copy(model):
    import copy

    return copy.deepcopy(model).to("cpu")


def vision_resnet_check(torch, T):
    """(a) ResNet-50 through Model.fit on the input pipeline, the loader
    alone, and the f32 eval logits against the CPU."""
    V = T.vision
    cfg = VISION_RESNET
    T.seed(SEED)
    net = V.models.resnet50()
    opt = T.optimizer.Momentum(0.1, 0.9, parameters=net.parameters(),
                               weight_decay=T.regularizer.L2Decay(1e-4))
    model = T.Model(net)
    model.prepare(opt, T.nn.CrossEntropyLoss(),
                  amp_configs={"dtype": "bfloat16"})
    tf = V.transforms
    pipe = tf.Compose([tf.RandomResizedCrop(cfg["crop"]),
                       tf.RandomHorizontalFlip(),
                       tf.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
    n_steps = cfg["warm"] + cfg["steps"]
    ds = V.datasets.FakeData(num_samples=cfg["batch"] * n_steps,
                             image_shape=cfg["image"], num_classes=1000,
                             transform=pipe, seed=SEED)
    ends = []

    class Clock(T.hapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            ends.append((time.perf_counter(), float(logs["loss"])))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(ds, batch_size=cfg["batch"], epochs=1, shuffle=False,
              drop_last=True, num_workers=cfg["workers"], verbose=0,
              callbacks=[Clock()])
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [l for _, l in ends]
    if len(ends) != n_steps or not all(math.isfinite(l) for l in losses):
        fail(f"phase 23 (a): fit ran {len(ends)} steps of {n_steps}, "
             f"losses {losses}")
    gaps = [b - a for (a, _), (b, _) in zip(ends[cfg["warm"] - 1:-1],
                                           ends[cfg["warm"]:])]
    step_ms = statistics.median(gaps) * 1e3
    fit_imgs = cfg["batch"] * len(gaps) / sum(gaps)
    # the card's step alone: train_batch on one batch already on the card
    xb = torch.randn(cfg["batch"], 3, cfg["crop"], cfg["crop"],
                     device="cuda")
    yb = torch.randint(0, 1000, (cfg["batch"],), device="cuda")
    card_gaps = []
    for _ in range(cfg["warm"] + 3):
        t1 = time.perf_counter()
        model.train_batch([xb], [yb])
        card_gaps.append(time.perf_counter() - t1)
    card_ms = statistics.median(card_gaps[cfg["warm"]:]) * 1e3
    # the loader alone, from its first batch to its last, to the card
    loader = T.io.DataLoader(ds, batch_size=cfg["batch"], drop_last=True,
                             num_workers=cfg["workers"], places="cuda")
    it = iter(loader)
    next(it)
    t1 = time.perf_counter()
    n = sum(1 for _ in it)
    torch.cuda.synchronize()
    loader_imgs = cfg["batch"] * n / (time.perf_counter() - t1)
    # f32 eval logits, card against the CPU, one state
    net.eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(2, 3, cfg["crop"], cfg["crop"], generator=gen,
                    device="cuda")
    with torch.no_grad():
        card = net(x)
        ref = _vision_cpu_copy(net)(x.cpu())
    err = _rel_norm(torch, card, ref)
    if not err <= VISION_CPU_TOL:
        fail(f"phase 23 (a): ResNet-50's f32 eval logits {err:.3g} off the "
             f"CPU's (relative norm), beyond {VISION_CPU_TOL}")
    res = dict(step_ms=step_ms, fit_images_per_s=fit_imgs,
               card_step_ms=card_ms,
               loader_images_per_s=loader_imgs, fit_s=fit_s,
               peak_gib=peak / 2 ** 30, losses=losses, cpu_rel_err=err,
               batch=cfg["batch"], workers=cfg["workers"])
    print(f"vision (a): ResNet-50 Model.fit bf16 batch {cfg['batch']}: "
          f"{step_ms:.1f} ms a step, {fit_imgs:.1f} images/s (the card's "
          f"step alone {card_ms:.1f} ms; the loader alone "
          f"{loader_imgs:.1f} images/s, {cfg['workers']} workers), "
          f"peak {peak / 2 ** 30:.2f} GiB, losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; f32 eval logits against the CPU {err:.2e}",
          flush=True)
    del model, net, opt
    torch.cuda.empty_cache()
    return res


def vision_vit_check(torch, T):
    """(b) ViT-B/16: 3 bf16 AdamW steps with K3/K4 counted from 0, then
    the f32 eval logits against the CPU."""
    V = T.vision
    cfg = VISION_VIT
    T.seed(SEED)
    vit = V.models.vit_b_16()
    F = T.nn.functional

    def loss_fn(m, x, y):
        with T.amp.auto_cast(dtype="bfloat16"):
            logits = m(x)
        return F.cross_entropy(logits.float(), y)

    step = T.jit.TrainStep(vit, loss_fn, dist_adamw(vit))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(cfg["batch"], 3, 224, 224, generator=gen, device="cuda")
    y = torch.randint(0, 1000, (cfg["batch"],), generator=gen,
                      device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for _ in range(cfg["steps"]):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = 12 * cfg["steps"]
    if any(launches[k] != want for k in FLASH_KERNELS):
        fail(f"phase 23 (b): ViT-B/16's steps launched {launches}, want "
             f"{want} each of K3 and K4's dkv and dq")
    if not all(math.isfinite(l) for l in losses):
        fail(f"phase 23 (b): ViT-B/16's losses {losses}")
    step_ms = statistics.median(times[1:]) * 1e3
    vit.eval()
    xe = x[:2].float()
    reset_counts()
    with torch.no_grad():
        card = vit(xe)
        k3_f32 = read_counts()["fwd"]
        ref = _vision_cpu_copy(vit)(xe.cpu())
    err = _rel_norm(torch, card, ref)
    if k3_f32 != 12 or not err <= VISION_CPU_TOL:
        fail(f"phase 23 (b): ViT-B/16's f32 eval forward launched K3 "
             f"{k3_f32} times (want 12), logits {err:.3g} off the CPU's "
             f"(relative norm), beyond {VISION_CPU_TOL}")
    res = dict(launches=launches, step_ms=step_ms,
               images_per_s=cfg["batch"] * 1e3 / step_ms,
               peak_gib=peak / 2 ** 30, losses=losses, cpu_rel_err=err)
    print(f"vision (b): ViT-B/16 bf16 batch {cfg['batch']}: K3/K4 "
          f"{launches['fwd']}/{launches['dkv']}/{launches['dq']} over "
          f"{cfg['steps']} steps, {step_ms:.1f} ms a step "
          f"({res['images_per_s']:.1f} images/s), peak "
          f"{peak / 2 ** 30:.2f} GiB; f32 eval logits (K3 f32) against the "
          f"CPU {err:.2e}", flush=True)
    del step, vit
    torch.cuda.empty_cache()
    return res


def _yolo_gt(torch, cfg, gen):
    """Ground-truth rows [N, rows, 4] (centre x, y, w, h in [0, 1]) with
    a random count of real boxes an image, the rest zeros, and labels."""
    n, rows = cfg["batch"], cfg["rows"]
    xy = torch.rand(n, rows, 2, generator=gen, device="cuda") * 0.8 + 0.1
    wh = torch.rand(n, rows, 2, generator=gen, device="cuda") * 0.4 + 0.02
    real = torch.randint(cfg["real"][0], cfg["real"][1] + 1, (n, 1),
                         generator=gen, device="cuda")
    keep = torch.arange(rows, device="cuda")[None] < real
    gt = torch.where(keep[..., None], torch.cat([xy, wh], -1), 0.0)
    labels = torch.randint(0, 80, (n, rows), generator=gen, device="cuda")
    return gt, torch.where(keep, labels, 0)


def vision_yolo_check(torch, T):
    """(c) YOLOv3-DarkNet53: 3 bf16 steps, then the eval decode, the
    card's NMS against the CPU's on the card's candidates."""
    V = T.vision
    cfg = VISION_YOLO
    T.seed(SEED)
    yolo = V.models.yolov3_darknet53(80)
    sched = T.optimizer.lr.LinearWarmup(0.001, cfg["warmup"], 0.0, 0.001)
    opt = T.optimizer.Momentum(sched, 0.9, parameters=yolo.parameters(),
                               weight_decay=T.regularizer.L2Decay(5e-4))

    def loss_fn(m, img, gb, gl):
        with T.amp.auto_cast(dtype="bfloat16"):
            return m(img, gb, gl)

    step = T.jit.TrainStep(yolo, loss_fn, opt)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    s = cfg["size"]
    img = torch.randn(cfg["batch"], 3, s, s, generator=gen, device="cuda")
    gt, labels = _yolo_gt(torch, cfg, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(cfg["steps"]):
        t0 = time.perf_counter()
        losses.append(float(step(img, gt, labels)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        sched.step()
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(l) for l in losses):
        fail(f"phase 23 (c): YOLOv3's losses {losses}")
    step_ms = statistics.median(times[1:]) * 1e3
    yolo.eval()
    im_shape = torch.full((cfg["batch"], 2), s, dtype=torch.int32,
                          device="cuda")
    kw = dict(score_threshold=0.01, nms_top_k=400, keep_top_k=100,
              nms_threshold=0.45, background_label=-1, return_index=True)
    with torch.no_grad():
        with T.amp.auto_cast(dtype="bfloat16"):
            outs, heads_ms = _vision_sync_ms(torch, lambda: yolo._heads(img))
        (boxes, scores), decode_ms = _vision_sync_ms(
            torch, lambda: yolo.decode(outs, im_shape))
        nms_ms = []
        for _ in range(2):  # the first includes the sort's warm-up
            got, ms = _vision_sync_ms(torch, lambda: V.ops.multiclass_nms(
                boxes, scores, **kw))
            nms_ms.append(ms)
        t0 = time.perf_counter()
        want = V.ops.multiclass_nms(boxes.cpu(), scores.cpu(), **kw)
        cpu_nms_s = time.perf_counter() - t0
    bad = [name for name, g, w in zip(("rows", "index", "count"), got, want)
           if not torch.equal(g.cpu(), w)]
    counts = got[2].tolist()
    if bad or min(counts) <= 0:
        fail(f"phase 23 (c): the card's multiclass_nms differs from the "
             f"CPU's on the same candidates in {bad} (counts {counts})")
    res = dict(step_ms=step_ms, losses=losses, peak_gib=peak / 2 ** 30,
               heads_ms=heads_ms, decode_ms=decode_ms, nms_ms=nms_ms[-1],
               nms_first_ms=nms_ms[0], cpu_nms_s=cpu_nms_s,
               candidates=int(boxes.shape[1]), counts=counts)
    print(f"vision (c): YOLOv3-DarkNet53 (80 classes) {cfg['batch']} x {s} "
          f"x {s} bf16: {step_ms:.1f} ms a train step, peak "
          f"{peak / 2 ** 30:.2f} GiB, losses {losses[0]:.2f} -> "
          f"{losses[-1]:.2f}; eval heads {heads_ms:.1f} ms, yolo_box "
          f"{decode_ms:.1f} ms, multiclass_nms over {boxes.shape[1]} "
          f"candidates x 80 classes {nms_ms[-1]:.1f} ms (first "
          f"{nms_ms[0]:.1f}); rows, indices and counts equal to the CPU's",
          flush=True)
    del step, yolo, opt, outs
    torch.cuda.empty_cache()
    return res


def _vision_boxes(torch, gen, n, hw, lo, hi):
    """``n`` xyxy boxes of sides in [lo, hi) inside an image ``hw``."""
    h, w = hw
    wh = torch.rand(n, 2, generator=gen) * (hi - lo) + lo
    x0 = torch.rand(n, generator=gen) * (w - wh[:, 0])
    y0 = torch.rand(n, generator=gen) * (h - wh[:, 1])
    return torch.stack([x0, y0, x0 + wh[:, 0], y0 + wh[:, 1]], 1)


def _vision_op_cases(torch, T):
    """``[(name, make(gen) -> inputs, call(ops, *xs) -> outputs, grad,
    n_terms)]``: each row's CPU inputs, call and the terms behind one of
    its outputs (gradients: behind one gradient element)."""
    V = T.vision
    R = VISION_ROI

    def roi_inputs(gen):
        x = torch.randn(*R["feat"], generator=gen)
        b = torch.cat([_vision_boxes(torch, gen, R["rois"], R["image"], 16,
                                     256) for _ in range(R["feat"][0])])
        return [x, b, torch.full((R["feat"][0],), R["rois"],
                                 dtype=torch.int32)]

    def deform_inputs(gen):
        n, c, h, w = VISION_DEFORM
        return [torch.randn(n, c, h, w, generator=gen),
                torch.randn(n, 18, h, w, generator=gen) * 2.0,
                torch.randn(c, c, 3, 3, generator=gen) / math.sqrt(c * 9),
                torch.rand(n, 9, h, w, generator=gen),
                torch.randn(c, generator=gen) * 0.1]

    def nms_inputs(gen):
        return [_vision_boxes(torch, gen, 2000, R["image"], 16, 256),
                torch.rand(2000, generator=gen)]

    def rpn_inputs(gen):
        n, a, h, w = 2, 15, 50, 84
        cy, cx = torch.meshgrid(torch.arange(h) * 16.0 + 8,
                                torch.arange(w) * 16.0 + 8, indexing="ij")
        size = torch.tensor([32.0, 64, 128, 256, 512]).repeat(3)
        ratio = torch.tensor([0.5, 1.0, 2.0]).repeat_interleave(5)
        aw, ah = size * ratio.sqrt(), size / ratio.sqrt()
        anc = torch.stack([cx[..., None] - aw / 2, cy[..., None] - ah / 2,
                           cx[..., None] + aw / 2, cy[..., None] + ah / 2],
                          -1)
        return [torch.rand(n, a, h, w, generator=gen),
                torch.randn(n, 4 * a, h, w, generator=gen) * 0.2,
                torch.tensor([[800.0, 1344.0, 1.0]] * n), anc,
                torch.tensor([0.1, 0.1, 0.2, 0.2]).expand_as(anc)
                .contiguous()]

    def mc_inputs(gen):
        b = _vision_boxes(torch, gen, 4 * 2000, (1.0, 1.0), 0.02, 0.3)
        return [b.reshape(4, 2000, 4), torch.rand(4, 80, 2000,
                                                  generator=gen)]

    def yolo_inputs(gen):
        return [torch.randn(8, 255, 76, 76, generator=gen),
                torch.full((8, 2), 608, dtype=torch.int32)]

    def coder_inputs(gen):
        p = _vision_boxes(torch, gen, 20000, (1.0, 1.0), 0.02, 0.5)
        return [p, torch.rand(20000, 4, generator=gen) * 0.2 + 0.1,
                torch.randn(8, 20000, 4, generator=gen) * 0.5,
                _vision_boxes(torch, gen, 100, (1.0, 1.0), 0.05, 0.5)]

    def prior_inputs(gen):
        return [torch.randn(8, 512, 38, 38, generator=gen),
                torch.randn(8, 3, 300, 300, generator=gen)]

    o = V.ops
    return [
        ("roi_align", roi_inputs, lambda x, b, n: o.roi_align(
            x, b, n, R["out"], R["scale"], R["ratio"]), True, 4 * 64),
        ("roi_pool", roi_inputs, lambda x, b, n: o.roi_pool(
            x, b, n, R["out"], R["scale"]), True, 64),
        ("deform_conv2d", deform_inputs,
         lambda x, off, w, m, b: o.deform_conv2d(x, off, w, b, padding=1,
                                                 mask=m), True,
         VISION_DEFORM[0] * 56 * 56),
        ("nms", nms_inputs, lambda b, s: o.nms(b, 0.5, s), False, 1),
        ("generate_proposals", rpn_inputs,
         lambda s, d, im, a, v: V.detection.generate_proposals(
             s, d, im, a, v), False, 1),
        ("multiclass_nms", mc_inputs, lambda b, s: o.multiclass_nms(
            b, s, 0.05, 400, 100, 0.45, return_index=True), False, 1),
        ("matrix_nms", mc_inputs, lambda b, s: o.matrix_nms(
            b, s, 0.05, 0.05, 400, 100, return_index=True), False, 1),
        ("yolo_box", yolo_inputs, lambda x, im: o.yolo_box(
            x, im, [10, 13, 16, 30, 33, 23], 80, 0.01, 8), False, 1),
        ("box_coder", coder_inputs, lambda p, v, t, tb: [
            o.box_coder(p, v, t, code_type="decode_center_size"),
            o.box_coder(p, v, tb)], False, 1),
        ("prior_box", prior_inputs, lambda x, im: o.prior_box(
            x, im, [30.0], [60.0], [2.0], flip=True, clip=True), False, 1),
    ]


def _vision_run(torch, call, xs, grad, seed):
    """The flat outputs of ``call(*xs)`` and, with ``grad``, the gradients
    of the float inputs against a fixed random cotangent of each float
    output."""
    if grad:
        xs = [x.detach().requires_grad_(x.is_floating_point()) for x in xs]
    outs = call(*xs)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    if not grad:
        return [o.detach() for o in outs]
    fl = [o for o in outs if o.is_floating_point() and o.requires_grad]
    g = torch.Generator().manual_seed(seed)
    cots = [torch.randn(o.shape, generator=g).to(o.device) for o in fl]
    wrt = [x for x in xs if x.requires_grad]
    gs = torch.autograd.grad(fl, wrt, cots, allow_unused=True)
    return [o.detach() for o in outs] + [
        torch.zeros_like(x) if v is None else v for x, v in zip(wrt, gs)]


def vision_op_rows(torch, T, pool):
    """(d) Each row on the card against the port on the CPU (on
    ``pool``'s thread, beside the card): the worst TA_TOL excess, the
    card's ms (one synchronized call after a warm one) and its peak
    memory."""
    rows = []
    for i, (name, make, call, grad, n) in enumerate(
            _vision_op_cases(torch, T)):
        gen = torch.Generator().manual_seed(SEED + i)
        xs = make(gen)
        cpu = pool.submit(_vision_run, torch, call, xs, grad, i)
        card_xs = [x.to("cuda") for x in xs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got, _ = _vision_sync_ms(torch, lambda: _vision_run(
            torch, call, card_xs, grad, i))
        got, ms = _vision_sync_ms(torch, lambda: _vision_run(
            torch, call, card_xs, grad, i))
        peak = torch.cuda.max_memory_allocated()
        want = cpu.result()
        if len(got) != len(want):
            fail(f"phase 23 (d): {name} gives {len(got)} outputs on the "
                 f"card, {len(want)} on the CPU")
        worst = max(_ta_excess(torch, g, w, "reduce", "float32", n, "sum")
                    for g, w in zip(got, want))
        rows.append(dict(op=name, excess=worst, ms=ms, grad=grad,
                         peak_gib=peak / 2 ** 30))
        print(f"vision (d): {name}{' with gradients' if grad else ''}: "
              f"worst excess {worst:.3g}, {ms:.2f} ms on the card, peak "
              f"{peak / 2 ** 30:.2f} GiB", flush=True)
        if not worst <= 0:
            fail(f"phase 23 (d): {name} on the card beyond TA_TOL of the "
                 f"CPU's (excess {worst:.3g})")
        del got, want, card_xs
        torch.cuda.empty_cache()
    return rows


def vision_phase(torch):
    """Phase 23: ResNet-50 through Model.fit (a), ViT-B/16 on K3/K4 (b),
    YOLOv3-DarkNet53's steps and decode (c), the vision op table (d)."""
    import paddle_tpu_torch as T

    res = dict(resnet50=vision_resnet_check(torch, T),
               vit_b16=vision_vit_check(torch, T),
               yolov3=vision_yolo_check(torch, T))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        res["ops"] = vision_op_rows(torch, T, pool)
    print(f"vision (d): {len(res['ops'])} rows within TA_TOL "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    res["card"] = card_line()
    return res


# ---------------------------------------------------------------------------
# phase 24: quantization, 2:4 sparsity, the CRF tagger and the op long tail
# ---------------------------------------------------------------------------
# (a) ResNet-50 (1000 classes) at batch 64 x 3 x 224 x 224: QAT through
# ImperativeQuantAware with 3 f32 Momentum(0.01, 0.9) steps (each quantized
# layer's _act_scale checked against the EMA rule of its input's absmax,
# every weight's gradient finite and nonzero through the straight-through
# estimator); PTQ of a fresh ResNet-50 over 4 calibration batches of 64,
# then convert_to_int8: 53 integer convolutions and 1 integer linear a
# forward, all through torch._int_mm.  The stem's 7x7 and layer4[0]'s 3x3
# s32 accumulators are held bit-equal to an f64 convolution of the same
# int8 operands (exact: every partial sum is an integer below 2**53).
# Against the port on the CPU (same weights and scales), two images layer
# by layer: each of the 54 int8 layers, given the card's own input, gives
# the card's output bit for bit on the CPU; where the two forwards part,
# the first layer whose int8 input differs has its differing elements one
# level apart, and its float inputs within QS_EDGE_LEVELS levels of each
# other (float rounding of the float layers before it: BatchNorm, the
# pools, the residual adds), so the part is a rounding edge and not an
# error of the int8 route.  From there the moves cascade through the
# later layers; the two images' logits must lie within QS_INT8_CPU_TOL
# (relative norm) of the CPU's, and the whole batch's int8 logits within
# it of the fake-quant model's (the same rounding-edge mechanism).  Top-1
# of the int8 model must equal the fake-quant model's on every image whose
# fake-quant top-2 margin exceeds QS_TOP1_BAND times that image's logit
# spread (the standard deviation over the 1000 classes, about 1380 at
# this seed); at most QS_MAX_NEAR_TIES images may fall inside the band
QS_RESNET = dict(batch=64, image=224, qat_steps=3, calib=4, timed=5)
QS_INT8_CPU_TOL = 5e-2
QS_EDGE_LEVELS = 1e-3
QS_TOP1_BAND = 0.05
QS_MAX_NEAR_TIES = 8
QS_EMA_RTOL = 1e-6
# (b) GPT-2-small (bench.py's widths) pruned 2:4 by sparsity.prune_model
# (every parameter of two or more dimensions, embeddings included, as the
# JAX package), decorate(AdamW) with phase 17's recipe, QS_SPARSE_STEPS
# bf16 dygraph steps at 16 x 1024 (K3, K4's dkv and dq 12 a step each);
# after every step check_mask holds on every pruned parameter and its zeros
# are exactly its mask's; then QS_DENSE_STEPS steps of the unpruned model
# from the same weights for the ms a step beside it
QS_SPARSE_STEPS = 10
QS_DENSE_STEPS = 4
# (c) a BERT-base CRF tagger for Conll05's SRL tags: BertModel (bert-base
# widths), Linear(768, 67) emissions and linear_chain_crf over a [69, 67]
# transition, batch 32 x 128 from Conll05st(num_labels=67, seq_len=128)'s
# synthetic corpus through a DataLoader (rows packed, lengths beside them)
# and sequence_pad on the card, 3 bf16 AdamW steps; then crf_decoding on
# the card against the CPU over the same f32 emissions (paths equal), the
# IOB chunk counts of extract_chunk_spans over 33 chunk types for the
# decoded and the gold tags and ChunkEvaluator's precision, recall and F1
# equal; ms a step, and the CRF's forward+backward and the Viterbi decode
# apart (each a 128-step recursion of small launches)
QS_CRF = dict(batch=32, seq=128, labels=67, chunk_types=33, steps=3,
              samples=96)
# (d) the op table at realistic shapes (CTR batches of 512, 128-token
# sequences, detection-sized boxes): each card output (and gradient where
# the row takes one) against the port on the CPU within TA_TOL's f32
# "reduce" family (atol grown by sqrt(n) for a sum of n terms), integer
# outputs (indices, hash ids, paths, counts, masks) equal; the samplers
# checked by what a draw must satisfy; the distributions' moments over
# QS_DRAWS draws within QS_SIGMAS standard errors
QS_DRAWS = 10 ** 6
QS_SIGMAS = 6.0


def _qs_ms(torch, fn, reps=1):
    """``(result, median ms)`` of ``fn()`` over ``reps`` synchronized
    calls."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def _qs_images(torch, n, size, gen):
    return torch.randn(n, 3, size, size, generator=gen).to("cuda")


def _qs_quantized(T, model):
    Q = T.quantization
    return [(n, m) for n, m in model.named_sublayers()
            if isinstance(m, (Q.QuantizedLinear, Q.QuantizedConv2D))]


def _qs_qat(torch, T, cfg, gen):
    """(a) QAT: 3 f32 Momentum steps with the EMA rule and the
    straight-through gradients checked."""
    T.seed(SEED)
    net = T.vision.models.resnet50().to("cuda")
    T.quantization.ImperativeQuantAware().quantize(net)
    twins = _qs_quantized(T, net)
    opt = T.optimizer.Momentum(0.01, 0.9, parameters=net.parameters())
    seen = {}

    def hook(name):
        def pre(mod, args):
            seen[name] = (mod._act_scale.detach().clone(),
                          args[0].detach().abs().amax().float())
        return pre

    handles = [m.register_forward_pre_hook(hook(n)) for n, m in twins]
    net.train()
    losses, ema_err, times = [], 0.0, []
    for step in range(cfg["qat_steps"]):
        x = _qs_images(torch, cfg["batch"], cfg["image"], gen)
        y = torch.randint(0, 1000, (cfg["batch"],), generator=gen).to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = T.nn.functional.cross_entropy(net(x), y)
        loss.backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        for n, m in twins:
            s_old, cur = seen[n]
            want = torch.where(s_old > 0, 0.9 * s_old + (1 - 0.9) * cur, cur)
            ema_err = max(ema_err, float(((m._act_scale - want).abs()
                                          / want.abs()).max()))
        bad = [n for n, m in twins if m.weight.grad is None
               or not torch.isfinite(m.weight.grad).all()
               or float(m.weight.grad.abs().max()) == 0.0]
        if bad:
            fail(f"phase 24 (a): QAT step {step}: no finite, nonzero "
                 f"gradient (straight-through) for {bad[:5]}")
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    for h in handles:
        h.remove()
    if not all(math.isfinite(v) for v in losses) or \
            not ema_err <= QS_EMA_RTOL:
        fail(f"phase 24 (a): QAT losses {losses}, the act scales "
             f"{ema_err:.3g} off the EMA rule (relative), beyond "
             f"{QS_EMA_RTOL}")
    res = dict(losses=losses, ema_rel_err=ema_err, layers=len(twins),
               step_ms=statistics.median(times[1:] or times) * 1e3)
    del net, opt
    return res


def _qs_acc_check(torch, T, layer, x):
    """``layer``'s s32 accumulator on ``x`` against an f64 convolution of
    the same int8 operands (exact); returns the number of elements
    compared."""
    from paddle_tpu_torch.quantization import int8 as Q8

    acc = layer.accumulate(x)
    qx = Q8.quantize_act(x, layer.act_scale)
    stride, dil, pads = Q8._geometry(layer, qx.shape[2:])
    qx = torch.nn.functional.pad(qx, (pads[1][0], pads[1][1], pads[0][0],
                                      pads[0][1]))
    ref = torch.nn.functional.conv2d(
        qx.double(), layer.qweight.double(), stride=stride, dilation=dil,
        groups=layer._groups)
    if not torch.equal(acc.long(), ref.round().long()):
        fail(f"phase 24 (a): an int8 accumulator {tuple(acc.shape)} differs "
             f"from the f64 product of its int8 operands")
    return acc.numel()


def _qs_ptq_int8(torch, T, cfg, gen):
    """(a) PTQ, convert_to_int8, the int8 eval against the f32 and
    fake-quant evals, the accumulators, the CPU."""
    import copy

    from paddle_tpu_torch.quantization import int8 as Q8

    T.seed(SEED)
    net = T.vision.models.resnet50().to("cuda").eval()
    xe = _qs_images(torch, cfg["batch"], cfg["image"], gen)
    with torch.no_grad():
        f32_logits, f32_ms = _qs_ms(torch, lambda: net(xe), cfg["timed"])
    calib = [_qs_images(torch, cfg["batch"], cfg["image"], gen)
             for _ in range(cfg["calib"])]

    def calib_fn(m):
        with torch.no_grad():
            for b in calib:
                m(b)

    T.quantization.ImperativePTQ().quantize(net, calib_fn)
    net.eval()
    with torch.no_grad():
        fq_logits, fq_ms = _qs_ms(torch, lambda: net(xe), cfg["timed"])
    T.quantization.convert_to_int8(net)
    probe = {}
    stem, deep = net.conv1, net.layer4[0].conv2
    hs = [l.register_forward_pre_hook(
        lambda mod, a, k=k: probe.__setitem__(k, a[0].detach()))
        for k, l in (("stem", stem), ("layer4", deep))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        Q8.reset_counts()
        int8_logits = net(xe)
        per_forward = Q8.counts()
        _, int8_ms = _qs_ms(torch, lambda: net(xe), cfg["timed"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for h in hs:
        h.remove()
    want = {"linear": 1, "conv": 53, "cuda": 54}
    if per_forward != want:
        fail(f"phase 24 (a): the int8 ResNet-50's forward ran {per_forward} "
             f"integer products, want {want}")
    with torch.no_grad():
        n_acc = sum(_qs_acc_check(torch, T, l, probe[k])
                    for k, l in (("stem", stem), ("layer4", deep)))
        cpu = copy.deepcopy(net).to("cpu")
        cascade = _qs_cascade(torch, net, cpu, xe[:2])
    cpu_err = _rel_norm(torch, int8_logits[:2], cascade.pop("cpu_logits"))
    fq_err = _rel_norm(torch, int8_logits, fq_logits)
    diff = float((int8_logits - fq_logits).abs().max())
    top2 = fq_logits.topk(2, dim=1).values
    band = QS_TOP1_BAND * fq_logits.std(dim=1)
    clear = (top2[:, 0] - top2[:, 1]) > band
    agree = int8_logits.argmax(1) == fq_logits.argmax(1)
    near = int((~clear).sum())
    if not cpu_err <= QS_INT8_CPU_TOL or not fq_err <= QS_INT8_CPU_TOL:
        fail(f"phase 24 (a): the int8 logits {cpu_err:.3g} off the CPU's "
             f"and {fq_err:.3g} off the fake-quant model's (relative norm, "
             f"tolerance {QS_INT8_CPU_TOL})")
    if not bool(agree[clear].all()) or near > QS_MAX_NEAR_TIES:
        fail(f"phase 24 (a): int8 top-1 differs from fake-quant's on "
             f"{int((~agree & clear).sum())} clear images, {near} near-ties "
             f"(at most {QS_MAX_NEAR_TIES})")
    b = cfg["batch"]
    res = dict(int8_products_a_forward=per_forward,
               accumulators_checked=n_acc, cpu_rel_err=cpu_err,
               cascade=cascade, int8_vs_fake_quant_rel=fq_err,
               int8_vs_fake_quant_max_abs=diff,
               fake_quant_vs_f32_rel=_rel_norm(torch, fq_logits,
                                               f32_logits),
               top1_band_min=float(band.min()),
               top1_margin_min=float((top2[:, 0] - top2[:, 1]).min()),
               top1_agree=int(agree.sum()), near_ties=near,
               near_ties_agree=int(agree[~clear].sum()),
               f32_eval_ms=f32_ms, fake_quant_eval_ms=fq_ms,
               int8_eval_ms=int8_ms, f32_images_per_s=b * 1e3 / f32_ms,
               fake_quant_images_per_s=b * 1e3 / fq_ms,
               int8_images_per_s=b * 1e3 / int8_ms, int8_peak_gib=peak)
    del net, cpu
    return res


def _qs_cascade(torch, net, cpu, x):
    """The card's int8 ResNet-50 (``net``) against its copy on the CPU on
    the images ``x``, layer by layer.  Every int8 layer, given the card's
    own input, must give the card's output bit for bit on the CPU; at the
    first layer whose int8 input differs between the two forwards, the
    differing elements must be one level apart and the float inputs within
    QS_EDGE_LEVELS levels of each other.  Returns the readings, the CPU's
    logits under ``cpu_logits``."""
    from paddle_tpu_torch.quantization import int8 as Q8

    def tap(model, seen):
        return [m.register_forward_hook(
            lambda mod, a, out, n=n: seen.append((n, mod, a[0], out)))
            for n, m in model.named_sublayers()
            if isinstance(m, (Q8.Int8Linear, Q8.Int8Conv2D))]

    on_card, on_cpu = [], []
    hs = tap(net, on_card) + tap(cpu, on_cpu)
    net(x)
    cpu_logits = cpu(x.cpu())
    for h in hs:
        h.remove()
    if [r[0] for r in on_card] != [r[0] for r in on_cpu] or \
            len(on_card) != 54:
        fail(f"phase 24 (a): the int8 layers ran {len(on_card)} times on "
             f"the card, {len(on_cpu)} on the CPU, want 54 in one order")
    layers = []
    for (name, mod, xin, out), (_, cmod, cin, _) in zip(on_card, on_cpu):
        if not torch.equal(cmod(xin.cpu()), out.cpu()):
            fail(f"phase 24 (a): int8 layer {name} on the CPU differs from "
                 f"the card's on the card's own input")
        scale = cmod.act_scale
        va = xin.cpu() / scale * Q8.Q_MAX
        vb = cin / scale * Q8.Q_MAX
        qa = Q8.quantize_act(xin, mod.act_scale).cpu().int()
        qb = Q8.quantize_act(cin, scale).int()
        moved = qa != qb
        layers.append(dict(
            layer=name, elements=qa.numel(), moved=int(moved.sum()),
            max_levels=int((qa - qb).abs().max()),
            max_input_levels=float((va - vb).abs().max()),
            input_rel=_rel_norm(torch, xin.cpu(), cin)))
    first = next((r for r in layers if r["moved"]), None)
    if first is not None and (first["max_levels"] > 1 or
                              not first["max_input_levels"] <=
                              QS_EDGE_LEVELS):
        fail(f"phase 24 (a): the first int8 layer whose input differs from "
             f"the CPU's, {first['layer']}, moves "
             f"{first['max_levels']} levels on inputs "
             f"{first['max_input_levels']:.3g} levels apart (at most 1 on "
             f"{QS_EDGE_LEVELS})")
    return dict(layers_bit_equal=len(layers), first=first,
                layers_moved=sum(1 for r in layers if r["moved"]),
                per_layer=layers, cpu_logits=cpu_logits)


def quant_resnet_check(torch, T):
    """(a) ResNet-50: QAT, PTQ, convert_to_int8, the int8 eval."""
    cfg = QS_RESNET
    gen = torch.Generator().manual_seed(SEED)
    res = dict(qat=_qs_qat(torch, T, cfg, gen))
    res.update(_qs_ptq_int8(torch, T, cfg, gen))
    q, c = res["qat"], res["cascade"]
    f = c["first"]
    first = "none" if f is None else (
        f"{f['layer']} ({f['moved']} of {f['elements']} elements, "
        f"{f['max_levels']} level, inputs {f['max_input_levels']:.3g} "
        f"levels apart)")
    print(f"quant-seq (a): ResNet-50 QAT {len(q['losses'])} f32 Momentum "
          f"steps at batch {cfg['batch']}, losses {q['losses']}, "
          f"{q['step_ms']:.1f} ms forward+backward, EMA "
          f"{q['ema_rel_err']:.2g} off over {q['layers']} layers; int8 "
          f"eval {res['int8_eval_ms']:.1f} ms a batch "
          f"({res['int8_images_per_s']:.1f} images/s) against f32 "
          f"{res['f32_eval_ms']:.1f} ({res['f32_images_per_s']:.1f}) and "
          f"fake-quant {res['fake_quant_eval_ms']:.1f} "
          f"({res['fake_quant_images_per_s']:.1f}), peak "
          f"{res['int8_peak_gib']:.2f} GiB; {res['int8_products_a_forward']}"
          f" integer products a forward, {res['accumulators_checked']} s32 "
          f"sums bit-equal; top-1 {res['top1_agree']}/{cfg['batch']} as "
          f"fake-quant ({res['near_ties']} near-ties, band from "
          f"{res['top1_band_min']:.1f}, smallest margin "
          f"{res['top1_margin_min']:.1f}), int8 logits "
          f"{res['int8_vs_fake_quant_rel']:.2e} off fake-quant's; CPU int8 "
          f"logits {res['cpu_rel_err']:.2e} off, {c['layers_bit_equal']} "
          f"int8 layers bit-equal to the CPU's on the card's inputs, "
          f"{c['layers_moved']} with moved inputs, the first {first}",
          flush=True)
    _qs_free(torch)
    return res


def _qs_free(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def sparse_gpt_check(torch, T):
    """(b) GPT-2-small pruned 2:4, decorate(AdamW), the dygraph loop."""
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.tools import train_profile as tp

    S = T.sparsity
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tp.gpt2_small_config()
    tokens, labels = tp.train_batch(cfg, "cuda")
    model = GPT.random(cfg, seed=tp.SEED, device="cuda")
    dense_state = {k: v.detach().clone() for k, v in
                   model.state_dict().items()}
    t0 = time.perf_counter()
    pruned = len(S.prune_model(model))
    prune_s = time.perf_counter() - t0
    dev_masks = S.ASPHelper._masks[model]
    params = dict(model.named_parameters())
    sched, opt = eager_recipe(model)
    opt = S.decorate(opt, model)
    reset_counts()
    losses, times = [], []
    for step in range(QS_SPARSE_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(float(eager_step(torch, model, opt, sched, tokens,
                                       labels)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        for name, mask in dev_masks.items():
            p = params[name].detach()
            if not S.check_mask(p) or not torch.equal(p == 0, mask == 0):
                fail(f"phase 24 (b): after step {step} {name} breaks its "
                     f"2:4 mask")
    launches = read_counts()
    want = cfg.num_layers * QS_SPARSE_STEPS
    if any(launches[k] != want for k in FLASH_KERNELS):
        fail(f"phase 24 (b): the pruned GPT's steps launched {launches}, "
             f"want {want} each of K3 and K4's dkv and dq")
    if not all(math.isfinite(v) for v in losses):
        fail(f"phase 24 (b): losses {losses}")
    density = sum(float((params[n] != 0).sum()) for n in dev_masks) / sum(
        params[n].numel() for n in dev_masks)
    del model, opt, sched, params, dev_masks
    _qs_free(torch)
    dense = GPT.random(cfg, seed=tp.SEED, device="cuda")
    dense.set_state_dict(dense_state)
    del dense_state
    dsched, dopt = eager_recipe(dense)
    dtimes = []
    for _ in range(QS_DENSE_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eager_step(torch, dense, dopt, dsched, tokens, labels)
        torch.cuda.synchronize()
        dtimes.append(time.perf_counter() - t1)
    res = dict(losses=losses, launches=launches, pruned=pruned,
               density=density, prune_s=prune_s,
               step_ms=statistics.median(times[1:]) * 1e3,
               dense_step_ms=statistics.median(dtimes[1:]) * 1e3)
    print(f"quant-seq (b): GPT-2-small 2:4 ({pruned} parameters pruned "
          f"in {prune_s:.1f} s, density {density:.4f}): K3/K4 "
          f"{launches.get('fwd')}/{launches.get('dkv')}/"
          f"{launches.get('dq')} over {QS_SPARSE_STEPS} steps, masks held "
          f"after every step, {res['step_ms']:.1f} ms a step against "
          f"{res['dense_step_ms']:.1f} unpruned; losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}", flush=True)
    del dense, dopt, dsched
    _qs_free(torch)
    return res


def _crf_collate(samples):
    """Conll05st samples (words, 5 contexts, verb, mark, labels) packed:
    words and labels back to back, and the lengths."""
    import numpy as np

    words = np.concatenate([s[0] for s in samples])
    labels = np.concatenate([s[-1] for s in samples])
    lengths = np.array([len(s[0]) for s in samples], np.int64)
    return words, labels, lengths


def _chunk_counts(M, infer, gold, lengths, types):
    ni = nl = nc = 0
    for i, n in enumerate(lengths.tolist()):
        ci = set(M.extract_chunk_spans(infer[i, :n], "IOB", types))
        cl = set(M.extract_chunk_spans(gold[i, :n], "IOB", types))
        ni, nl, nc = ni + len(ci), nl + len(cl), nc + len(ci & cl)
    return ni, nl, nc


def crf_tagger_check(torch, T):
    """(c) The BERT-base CRF tagger: 3 bf16 AdamW steps, then the Viterbi
    decode against the CPU and the chunk metrics."""
    import numpy as np

    from paddle_tpu_torch.models import bert as B

    cfg = QS_CRF
    F = T.nn.functional
    T.seed(SEED)
    bcfg = B.BertConfig()

    class Tagger(T.nn.Layer):
        def __init__(self):
            super().__init__()
            self.bert = B.BertModel(bcfg, device="cuda")
            self.emit = T.nn.Linear(bcfg.hidden_size, cfg["labels"],
                                    device="cuda")
            self.transition = self.create_parameter(
                [cfg["labels"] + 2, cfg["labels"]], device="cuda",
                default_initializer=T.nn.initializer.Normal(0.0, 0.1))

        def forward(self, ids, mask):
            with T.amp.auto_cast(dtype="bfloat16"):
                seq, _ = self.bert(ids, attention_mask=mask)
                return self.emit(seq)

    model = Tagger().train()
    opt = T.optimizer.AdamW(5e-5, parameters=model.parameters(),
                            weight_decay=0.01)
    ds = T.text.Conll05st(num_labels=cfg["labels"], seq_len=cfg["seq"],
                          num_samples=cfg["samples"])
    loader = T.io.DataLoader(ds, batch_size=cfg["batch"], drop_last=True,
                             collate_fn=_crf_collate)
    batches = []
    for words, labels, lengths in loader:
        words, labels, lengths = (t.to("cuda") for t in (words, labels,
                                                         lengths))
        ids, _ = T.sequence_pad(words, lengths, 0, cfg["seq"])
        tags, _ = T.sequence_pad(labels, lengths, 0, cfg["seq"])
        mask = T.sequence_mask(lengths, cfg["seq"], "bool")
        batches.append((ids.long(), tags.long(), lengths, mask))
    if len(batches) < cfg["steps"] or batches[0][0].shape != (
            cfg["batch"], cfg["seq"]):
        fail(f"phase 24 (c): the loader gave {len(batches)} batches of "
             f"{tuple(batches[0][0].shape)}")
    reset_counts()
    losses, times = [], []
    for ids, tags, lengths, mask in batches[:cfg["steps"]]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        em = model(ids, mask)
        loss = T.linear_chain_crf(em, model.transition, tags,
                                  lengths).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
    launches = read_counts()
    if not all(math.isfinite(v) for v in losses):
        fail(f"phase 24 (c): losses {losses}")
    ids, tags, lengths, mask = batches[0]
    model.eval()
    with torch.no_grad():
        em = model(ids, mask).float()
    em_g = em.detach().requires_grad_()
    trans = model.transition.detach().clone().requires_grad_()

    def crf_fb():
        loss = T.linear_chain_crf(em_g, trans, tags, lengths).sum()
        loss.backward()
        return loss

    _, fb_ms = _qs_ms(torch, crf_fb, 3)
    path, vit_ms = _qs_ms(torch, lambda: T.crf_decoding(
        em, model.transition.detach(), length=lengths), 3)
    cpu_path = T.crf_decoding(em.cpu(), model.transition.detach().cpu(),
                              length=lengths.cpu())
    if not torch.equal(path.cpu(), cpu_path):
        fail(f"phase 24 (c): the card's Viterbi paths differ from the CPU's "
             f"at {int((path.cpu() != cpu_path).sum())} positions")
    M = T.metric
    gold = tags.cpu().numpy()
    ln = lengths.cpu().numpy()
    card_counts = _chunk_counts(M, path.cpu().numpy(), gold, ln,
                                cfg["chunk_types"])
    cpu_counts = _chunk_counts(M, cpu_path.numpy(), gold, ln,
                               cfg["chunk_types"])
    ev_card, ev_cpu = M.ChunkEvaluator(), M.ChunkEvaluator()
    ev_card.update(*card_counts)
    ev_cpu.update(*cpu_counts)
    if card_counts != cpu_counts or ev_card.accumulate() != \
            ev_cpu.accumulate():
        fail(f"phase 24 (c): chunk counts {card_counts} (card) against "
             f"{cpu_counts} (CPU)")
    p, r, f1 = ev_card.accumulate()
    res = dict(losses=losses, launches=launches,
               step_ms=statistics.median(times[1:]) * 1e3,
               crf_fwd_bwd_ms=fb_ms, viterbi_ms=vit_ms,
               chunk_counts=list(card_counts), precision=p, recall=r, f1=f1,
               batches=len(batches))
    print(f"quant-seq (c): BERT-base CRF tagger at {cfg['batch']} x "
          f"{cfg['seq']}, {cfg['labels']} tags: {res['step_ms']:.1f} ms a "
          f"bf16 step, losses {losses}; CRF forward+backward {fb_ms:.2f} ms, "
          f"Viterbi {vit_ms:.2f} ms; paths equal to the CPU's, chunks "
          f"{card_counts} (P {p:.4f} R {r:.4f} F1 {f1:.4f}) equal; K3/K4 "
          f"{launches.get('fwd')}/{launches.get('dkv')}/"
          f"{launches.get('dq')} (BERT's masked attention is composed)",
          flush=True)
    del model, opt
    _qs_free(torch)
    return res


def _qs_tree(torch, depth):
    """A complete binary tree of ``depth`` levels as ``tdm_child``'s
    ``tree_info`` (ids 1.., 0 the padding node; leaves are items) and
    ``tdm_sampler``'s travel paths and layer list."""
    n = 2 ** depth
    info = torch.zeros(n, 5, dtype=torch.int64)
    for node in range(1, n // 2):
        info[node, 3:5] = torch.tensor([2 * node, 2 * node + 1])
    for node in range(1, n):
        info[node, 1] = node.bit_length() - 1
    info[n // 2:, 0] = torch.arange(n // 2, n) + 1000
    leaves = torch.arange(n // 2, n)
    travel = torch.stack([leaves >> (depth - 1 - level)
                          for level in range(1, depth)], 1)
    layer = torch.arange(2, n)[:, None]
    offs = [0] + [2 ** (level + 1) - 2 for level in range(1, depth)]
    return info, travel, layer, offs


def _qs_op_cases(torch, T):
    """``[(name, make(gen) -> CPU inputs, call(*xs) -> outputs, grad,
    n_terms)]`` at realistic shapes."""
    M = T.metric
    D = T.distribution
    CF = T.ops.control_flow
    B, S, H = 32, 128, 768          # a 128-token batch of BERT-base width
    N = 512                          # a CTR batch

    def rn(gen, *shape):
        return torch.randn(*shape, generator=gen)

    def ri(gen, lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen)

    def lens(gen, n=B, t=S):
        ln = ri(gen, 1, t + 1, n)
        ln[0] = t
        return ln

    def seq(gen):
        return [rn(gen, B, S, H), lens(gen)]

    def packed(gen):
        ln = lens(gen)
        return [rn(gen, int(ln.sum()), H), ln]

    def crf(gen):
        return [rn(gen, B, S, 67), rn(gen, 69, 67) * 0.1, ri(gen, 0, 67, B, S),
                lens(gen)]

    def boxes(gen, n, size):
        xy = torch.rand(n, 2, generator=gen) * size * 0.7
        return torch.cat([xy, xy + torch.rand(n, 2, generator=gen) * size
                          * 0.3 + 1.0], 1)

    info, travel, layer, offs = _qs_tree(torch, 10)

    def ctr_rank(gen):
        ro = torch.zeros(N, 7, dtype=torch.int64)
        ro[:, 0] = ri(gen, 0, 4, N)
        ro[:, 1::2] = ri(gen, 0, 4, N, 3)
        ro[:, 2::2] = ri(gen, 0, N, N, 3)
        return [rn(gen, N, 64), ro, rn(gen, 9 * 64, 128) * 0.1]

    def tree(gen):
        b, n = 64, 32
        e = torch.zeros(b, n - 1, 2, dtype=torch.int64)
        par = [ri(gen, 1, i + 1, b) for i in range(1, n)]
        for i in range(1, n):
            e[:, i - 1, 0] = par[i - 1]
            e[:, i - 1, 1] = i + 1
        e[::3, n // 2:] = 0                      # smaller trees, padded
        return [rn(gen, b, n, 64), e, rn(gen, 64, 3, 4, 32) * 0.1]

    def dequant_table(gen):
        codes = ri(gen, 0, 256, 10000, 64).to(torch.uint8)
        mn = -torch.rand(10000, 1, generator=gen) - 1
        mx = torch.rand(10000, 1, generator=gen) + 1
        return [torch.cat([mn, mx, codes.view(torch.float32)], 1),
                ri(gen, 0, 10000, N, 26)]

    def seg(gen):
        # 512 segments, none empty
        s, _ = torch.sort(torch.cat([torch.arange(512),
                                     ri(gen, 0, 512, 4096 - 512)]))
        return [rn(gen, 4096, 64), s]

    def det(gen):
        gt = boxes(gen, 20, 600.0)
        pick = ri(gen, 0, 20, 100)
        return [gt[pick] + rn(gen, 100, 4) * 10, torch.rand(100,
                                                           generator=gen),
                ri(gen, 0, 21, 20)[pick], gt, ri(gen, 0, 21, 20)]

    def run_det(pb, ps, pl, gb, gl):
        m = M.DetectionMAP()
        for i in range(4):
            m.update(pb, ps, (pl + i) % 21, gb, gl)
        return torch.tensor([m.accumulate()])

    def run_auc(p, y):
        m = M.Auc()
        m.update(p, y)
        return torch.tensor([m.accumulate()])

    def dists(gen):
        return [rn(gen, N, 64), torch.rand(N, 64, generator=gen) + 0.5,
                rn(gen, N, 64), torch.rand(N, 64, generator=gen) + 0.5,
                rn(gen, N, 64)]

    def run_normal(m1, s1, m2, s2, v):
        a, b = D.Normal(m1, s1), D.Normal(m2, s2)
        return [a.log_prob(v), a.entropy(), a.kl_divergence(b), a.probs(v)]

    def run_uniform(lo, w, _, __, v):
        u = D.Uniform(lo, lo + w)
        return [u.log_prob(lo + w * torch.sigmoid(v)), u.entropy()]

    def run_categorical(l1, _, l2, __, v):
        a, b = D.Categorical(l1), D.Categorical(l2)
        ids = (v.abs() * 10).long() % l1.shape[-1]
        return [a.log_prob(ids[:, 0]), a.entropy(), a.kl_divergence(b)]

    G = True
    return [
        ("sequence_mask", lambda g: [lens(g)],
         lambda l: T.sequence_mask(l, S), False, 1),
        ("sequence_pad", packed, lambda x, l: T.sequence_pad(x, l, 0.0, S),
         G, 1),
        ("sequence_unpad", seq, lambda x, l: T.sequence_unpad(x, l), G, 1),
        *[(f"sequence_pool[{t}]", seq, lambda x, l, t=t: T.sequence_pool(
            x, l, t), t in ("sum", "max"), S)
          for t in ("sum", "average", "sqrt", "max", "last", "first")],
        ("sequence_first_step", seq, T.sequence_first_step, False, 1),
        ("sequence_last_step", seq, T.sequence_last_step, False, 1),
        ("sequence_reverse", seq, T.sequence_reverse, False, 1),
        ("sequence_softmax", lambda g: [rn(g, B, S), lens(g)],
         T.sequence_softmax, G, S),
        ("sequence_expand", lambda g: [rn(g, B, H)],
         lambda x: T.sequence_expand(x, list(range(B))), G, 1),
        ("sequence_concat", lambda g: [rn(g, B, 64, H), lens(g, B, 64),
                                       rn(g, B, 64, H), lens(g, B, 64)],
         lambda a, la, b, lb: T.sequence_concat([a, b], [la, lb]), G, 1),
        ("sequence_expand_as", lambda g: [rn(g, B, H), lens(g)],
         T.sequence_expand_as, G, S),
        ("sequence_enumerate", lambda g: [ri(g, 0, 30522, B, S), lens(g)],
         lambda x, l: T.sequence_enumerate(x, l, 3, 0), False, 1),
        ("sequence_erase", lambda g: [ri(g, 0, 50, B, S), lens(g)],
         lambda x, l: T.sequence_erase(x, l, [0, 3, 7]), False, 1),
        ("sequence_reshape", seq, lambda x, l: T.sequence_reshape(x, l, 384),
         False, 1),
        ("sequence_scatter", lambda g: [rn(g, B, 5000), ri(g, 0, 5000, B, S),
                                        rn(g, B, S), lens(g)],
         T.sequence_scatter, G, S),
        ("sequence_slice", lambda g: [rn(g, B, S, H), lens(g),
                                      ri(g, 0, 32, B), ri(g, 1, 64, B)],
         T.sequence_slice, False, 1),
        ("sequence_topk_avg_pooling", lambda g: [rn(g, B, 4, S, S), lens(g),
                                                 lens(g)],
         lambda x, rl, cl: T.sequence_topk_avg_pooling(x, rl, cl, [1, 3, 5]),
         False, 5),
        ("sequence_conv", lambda g: [rn(g, B, S, H), lens(g),
                                     rn(g, 3 * H, H) / 48, rn(g, H)],
         lambda x, l, w, b: T.sequence_conv(x, l, w, b, 3), G, 3 * H),
        ("linear_chain_crf", crf, lambda e, t, y, l: T.linear_chain_crf(
            e, t, y, l), G, S * 67),
        ("crf_decoding", crf, lambda e, t, y, l: T.crf_decoding(
            e, t, length=l), False, 1),
        ("crf_decoding[label]", crf, lambda e, t, y, l: T.crf_decoding(
            e, t, y, l), False, 1),
        ("cond", lambda g: [rn(g, N, 64)], lambda x: CF.cond(
            x.sum() > 0, lambda: x * 2.0, lambda: x - 1.0), False, 1),
        ("while_loop", lambda g: [torch.tensor(0), rn(g, N, 64)],
         lambda i, x: CF.while_loop(lambda i, s: i < 5,
                                    lambda i, s: [i + 1, s * 0.9 + 1.0],
                                    [i, x]), False, 1),
        ("case", lambda g: [torch.tensor(0.5), rn(g, N, 64)],
         lambda v, x: CF.case([(v < 0, lambda: x * 3.0),
                               (v < 1, lambda: x + 1.0)],
                              default=lambda: x), False, 1),
        ("switch_case", lambda g: [torch.tensor(1), rn(g, N, 64)],
         lambda i, x: CF.switch_case(i, [lambda: x * 2.0, lambda: x - 3.0]),
         False, 1),
        ("tdm_child", lambda g: [ri(g, 0, 512, N, 1), info],
         lambda x, t: T.tdm_child(x, t, 2), False, 1),
        ("rank_attention", ctr_rank, lambda x, ro, p: T.rank_attention(
            x, ro, p, 3), G, 3 * 64),
        ("match_matrix_tensor", lambda g: [rn(g, 64, 32, 128),
                                           rn(g, 64, 48, 128),
                                           rn(g, 128, 4, 128) * 0.1,
                                           lens(g, 64, 32), lens(g, 64, 48)],
         lambda x, y, w, xl, yl: T.match_matrix_tensor(x, y, w, xl, yl, 4),
         G, 128 * 128),
        ("var_conv_2d", lambda g: [rn(g, 64, 8, 32, 48),
                                   rn(g, 16, 8 * 9) * 0.1, lens(g, 64, 32),
                                   lens(g, 64, 48)],
         lambda x, w, rl, cl: T.var_conv_2d(x, w, rl, cl, 8, 16, 3, 3), G,
         72),
        ("filter_by_instag", lambda g: [rn(g, N, 64), ri(g, -1, 20, N, 4),
                                        ri(g, 0, 20, 8)],
         lambda x, t, f: T.filter_by_instag(x, t, f), False, 1),
        ("tree_conv", tree, lambda n, e, f: T.tree_conv(n, e, f, 3), G,
         32 * 64 * 3),
        ("pyramid_hash", lambda g: [ri(g, 0, 2 ** 30, N, 32),
                                    rn(g, 10016), lens(g, N, 32)],
         lambda x, w, l: T.pyramid_hash(x, w, l, 16, 10000, 3, 16), False,
         1),
        ("lstmp", lambda g: [rn(g, N, 32, 512), rn(g, 64, 512) * 0.1,
                             rn(g, 128, 64) * 0.1, rn(g, 896) * 0.1],
         lambda x, w, pw, b: T.lstmp(x, w, pw, b), G, 32 * 128),
        ("sample_logits[customized]",
         lambda g: [rn(g, N, 10000), ri(g, 0, 10000, N, 1),
                    ri(g, 0, 10000, 64), torch.rand(64, generator=g) * 0.01],
         lambda lg, lb, s, p: T.sample_logits(
             lg, lb, 64, use_customized_samples=True, customized_samples=s,
             customized_probabilities=p), False, 1),
        ("add_position_encoding", lambda g: [rn(g, B, S, H)],
         lambda x: T.add_position_encoding(x, 0.5, 1.0), False, 1),
        ("affine_channel", lambda g: [rn(g, 32, 256, 56, 56), rn(g, 256),
                                      rn(g, 256)], T.affine_channel, False,
         1),
        ("anchor_generator", lambda g: [rn(g, 1, 8, 50, 84)],
         lambda x: T.anchor_generator(x, [32.0, 64.0, 128.0, 256.0, 512.0],
                                      [0.5, 1.0, 2.0], [0.1, 0.1, 0.2, 0.2],
                                      [16.0, 16.0]), False, 1),
        ("bipartite_match", lambda g: [torch.rand(20, 2000, generator=g)],
         lambda d: T.bipartite_match(d, "per_prediction", 0.5), False, 1),
        ("bpr_loss", lambda g: [rn(g, N, 100), ri(g, 0, 100, N, 1)],
         T.bpr_loss, G, 100),
        ("center_loss", lambda g: [rn(g, N, 64), ri(g, 0, 100, N),
                                   rn(g, 100, 64)],
         lambda x, y, c: T.center_loss(x, y, c, 0.5), G, N),
        ("ctc_align", lambda g: [ri(g, 0, 6, B, S), lens(g)[:, None]],
         lambda x, l: T.ctc_align(x, 0, True, -1, l), False, 1),
        ("data_norm", lambda g: [rn(g, N, 64), rn(g, 64), rn(g, 64)],
         T.data_norm, False, 1),
        ("edit_distance", lambda g: [ri(g, 0, 30, B, 64), ri(g, 0, 30, B, 64),
                                     lens(g, B, 64), lens(g, B, 64)],
         lambda a, b, la, lb: T.edit_distance(a, b, True, la, lb), False, 1),
        ("gather_tree", lambda g: [ri(g, 0, 30522, S, B, 4),
                                   ri(g, 0, 4, S, B, 4)],
         T.gather_tree, False, 1),
        ("hinge_loss", lambda g: [rn(g, N, 1), ri(g, 0, 2, N, 1).float()],
         T.hinge_loss, False, 1),
        ("l1_norm", lambda g: [rn(g, N, H)], T.l1_norm, G, N * H),
        ("mean_iou", lambda g: [ri(g, 0, 21, 8, 512, 512),
                                ri(g, 0, 21, 8, 512, 512)],
         lambda p, y: T.mean_iou(p, y, 21), False, 1),
        ("modified_huber_loss", lambda g: [rn(g, N, 1) * 2,
                                           ri(g, 0, 2, N, 1).float()],
         T.modified_huber_loss, False, 1),
        ("rank_loss", lambda g: [ri(g, 0, 2, N, 1).float(), rn(g, N, 1),
                                 rn(g, N, 1)], T.rank_loss, False, 1),
        ("space_to_depth", lambda g: [rn(g, 8, 256, 76, 76)],
         lambda x: T.space_to_depth(x, 2), False, 1),
        ("squared_l2_distance", lambda g: [rn(g, N, H), rn(g, N, H)],
         T.squared_l2_distance, G, H),
        ("squared_l2_norm", lambda g: [rn(g, N, H)], T.squared_l2_norm, G,
         N * H),
        ("teacher_student_sigmoid_loss",
         lambda g: [rn(g, N), torch.rand(N, generator=g) * 4 - 2],
         T.teacher_student_sigmoid_loss, False, 1),
        ("row_conv", lambda g: [rn(g, B, S, H), rn(g, 3, H)], T.row_conv,
         False, 3),
        ("set_value", lambda g: [rn(g, N, 64), rn(g, 64)],
         lambda x, v: T.set_value(x, v, (slice(0, 128),)), G, 1),
        *[(op, seg, getattr(T, op), op in ("segment_sum", "segment_max"), 8)
          for op in ("segment_sum", "segment_mean", "segment_max",
                     "segment_min")],
        ("segment_pool", seg, lambda d, s: T.segment_pool(d, s, "mean"),
         False, 8),
        ("fsp_matrix", lambda g: [rn(g, 8, 256, 56, 56),
                                  rn(g, 8, 256, 56, 56)], T.fsp_matrix,
         False, 56 * 56),
        ("Assert", lambda g: [torch.rand(N, generator=g) + 0.1],
         lambda x: T.Assert(x > 0, [x]).long(), False, 1),
        ("conv_shift", lambda g: [rn(g, N, 128), rn(g, N, 9)], T.conv_shift,
         G, 9),
        ("cvm", lambda g: [torch.rand(N, 66, generator=g) * 9,
                           torch.rand(N, 2, generator=g)],
         lambda x, c: T.cvm(x, c, True), False, 1),
        ("hash_op", lambda g: [ri(g, 0, 2 ** 31 - 1, N, 8)],
         lambda x: T.hash_op(x, 4, 100000007), False, 1),
        ("batch_fc", lambda g: [rn(g, 16, N, 64), rn(g, 16, 64, 32),
                                rn(g, 16, 32)], T.batch_fc, G, 64),
        ("similarity_focus", lambda g: [rn(g, 8, 16, 32, 32)],
         lambda x: T.similarity_focus(x, 1, [0, 5, 9]), False, 1),
        ("lookup_table_dequant", dequant_table, T.lookup_table_dequant,
         False, 1),
        ("Auc", lambda g: [torch.rand(100000, 2, generator=g),
                           ri(g, 0, 2, 100000, 1)], run_auc, False, 1),
        ("DetectionMAP", det, run_det, False, 1),
        ("Normal", dists, run_normal, G, 1),
        ("Uniform", dists, run_uniform, False, 1),
        ("Categorical", dists, run_categorical, G, 64),
    ]


def quant_seq_op_rows(torch, T, pool):
    """(d) Each row on the card against the port on the CPU (on
    ``pool``'s thread, beside the card), the card's ms."""
    rows = []
    for i, (name, make, call, grad, n) in enumerate(_qs_op_cases(torch, T)):
        gen = torch.Generator().manual_seed(SEED + i)
        xs = make(gen)
        cpu = pool.submit(_vision_run, torch, call, xs, grad, i)
        card_xs = [x.to("cuda") for x in xs]
        got, _ = _qs_ms(torch, lambda: _vision_run(torch, call, card_xs,
                                                   grad, i))
        got, ms = _qs_ms(torch, lambda: _vision_run(torch, call, card_xs,
                                                    grad, i))
        want = cpu.result()
        if len(got) != len(want):
            fail(f"phase 24 (d): {name} gives {len(got)} outputs on the "
                 f"card, {len(want)} on the CPU")
        worst = max(_ta_excess(torch, g, w, "reduce", "float32", n, "sum")
                    for g, w in zip(got, want))
        rows.append(dict(op=name, excess=worst, ms=ms, grad=grad))
        if not worst <= 0:
            fail(f"phase 24 (d): {name} on the card beyond TA_TOL of the "
                 f"CPU's (excess {worst:.3g})")
    return rows


def quant_seq_samplers(torch, T):
    """(d) The draws: the distributions' moments over QS_DRAWS draws
    within QS_SIGMAS standard errors, tdm_sampler's negatives valid,
    sampling_id's ids within their rows, shuffle_batch a permutation."""
    D = T.distribution
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    loc, scale = torch.tensor([0.5, -2.0], device=dev), \
        torch.tensor([1.5, 0.2], device=dev)
    out = {}
    x, out["normal_ms"] = _qs_ms(torch, lambda: D.Normal(loc, scale).sample(
        (QS_DRAWS,), generator=gen))
    z = ((x.mean(0) - loc) / (scale / math.sqrt(QS_DRAWS))).abs().max()
    zv = ((x.var(0) / scale ** 2 - 1) / math.sqrt(2 / QS_DRAWS)).abs().max()
    lo, hi = torch.tensor([-1.0, 2.0], device=dev), \
        torch.tensor([1.0, 2.5], device=dev)
    u, out["uniform_ms"] = _qs_ms(torch, lambda: D.Uniform(lo, hi).sample(
        (QS_DRAWS,), generator=gen))
    zu = ((u.mean(0) - (lo + hi) / 2) / ((hi - lo) / math.sqrt(
        12 * QS_DRAWS))).abs().max()
    inside = bool(((u >= lo) & (u < hi)).all())
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0]], device=dev)
    c, out["categorical_ms"] = _qs_ms(torch, lambda: D.Categorical(
        logits).sample((QS_DRAWS,), generator=gen))
    p = torch.softmax(logits, -1)[0]
    freq = torch.bincount(c[:, 0], minlength=4).double() / QS_DRAWS
    zc = ((freq - p) / (p * (1 - p) / QS_DRAWS).sqrt()).abs().max()
    worst = float(max(z, zv, zu, zc))
    out.update(z_normal_mean=float(z), z_normal_var=float(zv),
               z_uniform_mean=float(zu), z_categorical=float(zc))
    if worst > QS_SIGMAS or not inside:
        fail(f"phase 24 (d): draws {worst:.2f} standard errors off (limit "
             f"{QS_SIGMAS}), uniform inside its bounds: {inside}")
    info, travel, layer, offs = _qs_tree(torch, 10)
    x = torch.randint(0, 512, (512, 1), generator=torch.Generator()
                      .manual_seed(SEED))
    negs = [1, 3, 4, 8, 16, 16, 16, 32, 32]
    (o, lab, msk), out["tdm_sampler_ms"] = _qs_ms(torch, lambda: T.tdm_sampler(
        x.to(dev), travel.to(dev), layer.to(dev), negs, offs, seed=3))
    o, lab, msk = o.cpu(), lab.cpu(), msk.cpu()
    col = 0
    for li, neg in enumerate(negs):
        pos = travel[x[:, 0], li]
        drawn = o[:, col + 1:col + 1 + neg]
        lo_id, hi_id = offs[li] + 2, offs[li + 1] + 2
        ok = (o[:, col] == pos).all() and (drawn != pos[:, None]).all() \
            and ((drawn >= lo_id) & (drawn < hi_id)).all() and all(
                len(set(r.tolist())) == neg for r in drawn[:16])
        if not ok or not (lab[:, col] == 1).all() or not (msk == 1).all():
            fail(f"phase 24 (d): tdm_sampler's layer {li} draws invalid")
        col += 1 + neg
    probs = torch.softmax(torch.randn(512, 100, generator=torch.Generator()
                                      .manual_seed(SEED)), -1).to(dev)
    ids = T.sampling_id(probs, seed=5)
    shuf, perm, _ = T.shuffle_batch(probs, seed=5)
    if not (ids >= 0).all() or not (ids < 100).all() or not torch.equal(
            perm.sort().values, torch.arange(512, device=dev)) or \
            not torch.equal(shuf, probs[perm]):
        fail("phase 24 (d): sampling_id or shuffle_batch gave invalid ids")
    return out


def quant_seq_phase(torch):
    """Phase 24: int8 ResNet-50 (a), 2:4 GPT-2-small (b), the BERT-base CRF
    tagger (c), the op table (d)."""
    import paddle_tpu_torch as T

    res = dict(resnet50=quant_resnet_check(torch, T),
               sparse_gpt2=sparse_gpt_check(torch, T),
               crf_tagger=crf_tagger_check(torch, T))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        res["ops"] = quant_seq_op_rows(torch, T, pool)
    res["samplers"] = quant_seq_samplers(torch, T)
    worst = max(res["ops"], key=lambda r: r["excess"])
    print(f"quant-seq (d): {len(res['ops'])} rows within TA_TOL (worst "
          f"{worst['op']} {worst['excess']:.3g}), draws within "
          f"{QS_SIGMAS} standard errors ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    for r in res["ops"]:
        print(f"quant-seq (d): {r['op']}{' with gradients' if r['grad'] else ''}"
              f": excess {r['excess']:.3g}, {r['ms']:.3f} ms", flush=True)
    res["card"] = card_line()
    return res



# ---------------------------------------------------------------------------
# phase 25: deployment — static programs, the exporter, jit.save and the
# Predictor
# ---------------------------------------------------------------------------
# f32 with TF32 off, random weights from SEED, every model served through
# `inference.create_predictor` on the card (one CUDA graph a feed
# signature, captured at the first run):
# (a) PaddleClas ResNet-50 (1000 classes) at [32, 3, 224, 224] exported by
#     `static.save_inference_model(layer=...)` through `fx_export` (a
#     reference ProgramDesc of core ops: no kernel launches); logits
#     against the eager model's on the card and top-1 equal on all 32
#     images; ms a batch captured and op by op (`switch_ir_optim(False)`),
#     images/s;
# (b) the same ResNet-50 at [1, 3, 224, 224] through `jit.save` (the
#     torch.export archive): logits against eager, latency captured and
#     eager;
# (c) ViT-B/16 at [8, 3, 224, 224] (197 tokens) through `jit.save`: K3
#     (the f32 SIMT kernel, head_dim 64) through its custom op, 12 launches
#     a run by its counter (the first run eager, later ones replays);
#     logits against eager;
# (d) BERT-base (bert-base-uncased's widths) at 16 x 128, input_ids and
#     token_type_ids int64, no mask, as a ProgramDesc: the sequence and
#     pooled outputs against eager.
# Each part prints its export and load seconds (load: parse and weights),
# its peak memory and its program's op count.  ST_TOL: the programs run
# the decomposed core-ATen form of the same f32 ops as the eager model
# (TF32 off), in another order than the eager code's, so their outputs
# differ by rounding; the ceiling 1e-4 (relative norm) is ten times under
# the 1e-3 any part may use.
ST_RESNET = dict(batch=32, timed=5)
ST_RESNET_LAT = dict(batch=1, timed=20)
ST_VIT = dict(batch=8, timed=5)
ST_BERT = dict(batch=16, seq=128, timed=5)
ST_TOL = 1e-4
ST_DIR = Path("build") / "chip_smoke_static"


def _st_ms(torch, fn, reps):
    """Median ms of ``fn()`` between synchronizes, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _st_predictor(T, prefix, ir_optim=True):
    """``(predictor, load seconds)`` on the card."""
    cfg = T.inference.Config(prefix + ".pdmodel")
    cfg.switch_ir_optim(ir_optim)
    t0 = time.perf_counter()
    pred = T.inference.create_predictor(cfg)
    return pred, time.perf_counter() - t0


def _st_program_ops(prefix):
    import paddle_tpu_torch as T

    prog, _, _ = T.static.load_inference_model(prefix)
    return sum(len(b["ops"]) for b in prog.desc["blocks"])


def _st_archive_ops(pred):
    return sum(1 for n in pred._layer.layer._exported.graph.nodes
               if n.op == "call_function")


def _st_device_call(torch, pred, inputs):
    """A call of the predictor's runner on device feeds (the host copies
    of `run` left out): ``fn()`` for `_st_ms`."""
    if pred._runner is not None:
        return lambda: pred._runner(*inputs)
    feeds = [t.cpu().numpy() for t in inputs]
    return lambda: pred._layer(feeds)


def static_resnet_check(torch, T):
    """(a) ResNet-50 as a ProgramDesc at batch 32, and (b) through
    jit.save at batch 1."""
    cfg = ST_RESNET
    T.seed(SEED)
    net = T.vision.models.resnet50().eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(cfg["batch"], 3, 224, 224, generator=gen, device="cuda")
    with torch.no_grad():
        want = net(x)
    prefix = str(ST_DIR / "resnet50")
    t0 = time.perf_counter()
    T.static.save_inference_model(prefix, layer=net, input_spec=[
        T.static.InputSpec([cfg["batch"], 3, 224, 224], "float32",
                           "image")])
    export_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pred, load_s = _st_predictor(T, prefix)
    reset_counts()
    (out,) = pred.run([x.cpu().numpy()])
    counts = read_counts()
    launched = {k: v for k, v in counts.items() if v}
    got = torch.from_numpy(out)
    err = _rel_norm(torch, got, want.cpu())
    top1 = int((got.argmax(1) == want.cpu().argmax(1)).sum())
    cap_ms = _st_ms(torch, _st_device_call(torch, pred, [x]), cfg["timed"])
    e2e_ms = _st_ms(torch, lambda: pred.run([x.cpu().numpy()]),
                    cfg["timed"])
    peak = torch.cuda.max_memory_allocated()
    graphs = pred.graph_count()
    eager_pred, _ = _st_predictor(T, prefix, ir_optim=False)
    eager_ms = _st_ms(torch, _st_device_call(torch, eager_pred, [x]),
                      cfg["timed"])
    n_ops = _st_program_ops(prefix)
    if launched or graphs != 1 or not err <= ST_TOL or \
            top1 != cfg["batch"]:
        fail(f"phase 25 (a): ResNet-50's program launched {launched} "
             f"(want none), {graphs} graphs (want 1), logits {err:.3g} off "
             f"the eager model's (relative norm, limit {ST_TOL}), top-1 "
             f"{top1}/{cfg['batch']}")
    a = dict(export_s=export_s, load_s=load_s, ops=n_ops, rel_err=err,
             k3_launches_a_run=counts["fwd"], launches=counts,
             top1_equal=top1, captured_ms=cap_ms, eager_ms=eager_ms,
             run_ms=e2e_ms, images_per_s=cfg["batch"] * 1e3 / cap_ms,
             peak_gib=peak / 2 ** 30, graphs=graphs)
    print(f"static (a): ResNet-50 ProgramDesc batch {cfg['batch']}: "
          f"export {export_s:.1f} s, load {load_s:.1f} s, {n_ops} ops; "
          f"logits {err:.2e} off eager, top-1 {top1}/{cfg['batch']}; "
          f"captured {cap_ms:.2f} ms a batch ({a['images_per_s']:.1f} "
          f"images/s), op by op {eager_ms:.2f} ms, Predictor.run with host "
          f"copies {e2e_ms:.2f} ms; peak {peak / 2 ** 30:.2f} GiB",
          flush=True)
    del pred, eager_pred
    torch.cuda.empty_cache()

    cfg = ST_RESNET_LAT
    x1 = x[:cfg["batch"]].contiguous()
    with torch.no_grad():
        want1 = net(x1)
    prefix = str(ST_DIR / "resnet50_jit")
    t0 = time.perf_counter()
    T.jit.save(net, prefix, input_spec=[T.static.InputSpec(
        [cfg["batch"], 3, 224, 224], "float32")])
    export_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pred, load_s = _st_predictor(T, prefix)
    (out,) = pred.run([x1.cpu().numpy()])
    err = _rel_norm(torch, torch.from_numpy(out), want1.cpu())
    cap_ms = _st_ms(torch, _st_device_call(torch, pred, [x1]),
                    cfg["timed"])
    peak = torch.cuda.max_memory_allocated()
    eager_pred, _ = _st_predictor(T, prefix, ir_optim=False)
    eager_ms = _st_ms(torch, _st_device_call(torch, eager_pred, [x1]),
                      cfg["timed"])
    if not err <= ST_TOL or pred.graph_count() != 1:
        fail(f"phase 25 (b): ResNet-50 via jit.save at batch 1: logits "
             f"{err:.3g} off eager (limit {ST_TOL}), "
             f"{pred.graph_count()} graphs (want 1)")
    b = dict(export_s=export_s, load_s=load_s, ops=_st_archive_ops(pred),
             rel_err=err, captured_ms=cap_ms, eager_ms=eager_ms,
             peak_gib=peak / 2 ** 30)
    print(f"static (b): ResNet-50 jit.save batch 1: export {export_s:.1f} "
          f"s, load {load_s:.1f} s, {b['ops']} graph ops; logits "
          f"{err:.2e} off eager; latency captured {cap_ms:.2f} ms, op by "
          f"op {eager_ms:.2f} ms; peak {peak / 2 ** 30:.2f} GiB",
          flush=True)
    del pred, eager_pred, net
    torch.cuda.empty_cache()
    return a, b


def static_vit_check(torch, T):
    """(c) ViT-B/16 through jit.save: K3 12 launches a run."""
    cfg = ST_VIT
    T.seed(SEED)
    vit = T.vision.models.vit_b_16().eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(cfg["batch"], 3, 224, 224, generator=gen, device="cuda")
    with torch.no_grad():
        want = vit(x)
    prefix = str(ST_DIR / "vit_b16")
    t0 = time.perf_counter()
    T.jit.save(vit, prefix, input_spec=[T.static.InputSpec(
        [cfg["batch"], 3, 224, 224], "float32")])
    export_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pred, load_s = _st_predictor(T, prefix)
    runs = []
    for _ in range(3):  # eager warm-up and capture, then two replays
        reset_counts()
        (out,) = pred.run([x.cpu().numpy()])
        torch.cuda.synchronize()
        runs.append(read_counts()["fwd"])
    err = _rel_norm(torch, torch.from_numpy(out), want.cpu())
    cap_ms = _st_ms(torch, _st_device_call(torch, pred, [x]), cfg["timed"])
    peak = torch.cuda.max_memory_allocated()
    k3_ops = sum(1 for n in pred._layer.layer._exported.graph.nodes
                 if "flash_attention_fwd" in str(n.target))
    if runs != [12, 12, 12] or k3_ops != 12 or not err <= ST_TOL or \
            pred.graph_count() != 1:
        fail(f"phase 25 (c): ViT-B/16 via jit.save: K3 launches {runs} "
             f"a run (want 12 each), {k3_ops} K3 ops in the graph (want "
             f"12), logits {err:.3g} off eager (limit {ST_TOL}), "
             f"{pred.graph_count()} graphs")
    res = dict(export_s=export_s, load_s=load_s, ops=_st_archive_ops(pred),
               k3_launches_a_run=runs[-1], k3_runs=runs, rel_err=err,
               captured_ms=cap_ms,
               images_per_s=cfg["batch"] * 1e3 / cap_ms,
               peak_gib=peak / 2 ** 30)
    print(f"static (c): ViT-B/16 jit.save batch {cfg['batch']}: export "
          f"{export_s:.1f} s, load {load_s:.1f} s, {res['ops']} graph ops "
          f"({k3_ops} K3 custom ops); K3 launches a run {runs}; logits "
          f"{err:.2e} off eager; captured {cap_ms:.2f} ms a batch; peak "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    del pred, vit
    torch.cuda.empty_cache()
    return res


def static_bert_check(torch, T):
    """(d) BERT-base as a ProgramDesc at 16 x 128."""
    import paddle_tpu_torch.models.bert as TB

    cfg = ST_BERT
    T.seed(SEED)
    bert = TB.BertModel(TB.BertConfig()).eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ids = torch.randint(1, 30522, (cfg["batch"], cfg["seq"]), generator=gen,
                        device="cuda")
    types = torch.randint(0, 2, (cfg["batch"], cfg["seq"]), generator=gen,
                          device="cuda")
    with torch.no_grad():
        want = bert(ids, types)
    prefix = str(ST_DIR / "bert_base")
    t0 = time.perf_counter()
    T.static.save_inference_model(prefix, layer=bert, input_spec=[
        T.static.InputSpec([cfg["batch"], cfg["seq"]], "int64", "input_ids"),
        T.static.InputSpec([cfg["batch"], cfg["seq"]], "int64",
                           "token_type_ids")])
    export_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pred, load_s = _st_predictor(T, prefix)
    reset_counts()
    outs = pred.run([ids.cpu().numpy(), types.cpu().numpy()])
    counts = read_counts()
    launched = {k: v for k, v in counts.items() if v}
    errs = [_rel_norm(torch, torch.from_numpy(o), w.cpu())
            for o, w in zip(outs, want)]
    cap_ms = _st_ms(torch, _st_device_call(torch, pred, [ids, types]),
                    cfg["timed"])
    peak = torch.cuda.max_memory_allocated()
    n_ops = _st_program_ops(prefix)
    if launched or len(outs) != 2 or not max(errs) <= ST_TOL or \
            pred.graph_count() != 1:
        fail(f"phase 25 (d): BERT-base's program launched {launched} "
             f"(want none), {len(outs)} outputs, sequence/pooled "
             f"{errs} off eager (limit {ST_TOL}), {pred.graph_count()} "
             f"graphs")
    res = dict(export_s=export_s, load_s=load_s, ops=n_ops,
               k3_launches_a_run=counts["fwd"], launches=counts,
               sequence_rel_err=errs[0], pooled_rel_err=errs[1],
               captured_ms=cap_ms,
               tokens_per_s=cfg["batch"] * cfg["seq"] * 1e3 / cap_ms,
               peak_gib=peak / 2 ** 30)
    print(f"static (d): BERT-base ProgramDesc {cfg['batch']} x "
          f"{cfg['seq']}: export {export_s:.1f} s, load {load_s:.1f} s, "
          f"{n_ops} ops; sequence {errs[0]:.2e}, pooled {errs[1]:.2e} off "
          f"eager; captured {cap_ms:.2f} ms a batch "
          f"({res['tokens_per_s']:.0f} tokens/s); peak "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    del pred, bert
    torch.cuda.empty_cache()
    return res


def static_phase(torch):
    """Phase 25: ResNet-50 as a ProgramDesc (a) and through jit.save (b),
    ViT-B/16 on K3 through jit.save (c), BERT-base as a ProgramDesc (d),
    each served by the Predictor."""
    import paddle_tpu_torch as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.core import place as TPL

    ST_DIR.mkdir(parents=True, exist_ok=True)
    prev = TPL._EXPECTED_DEVICE[0]
    T.set_device("gpu:0")
    try:
        a, b = static_resnet_check(torch, T)
        res = dict(resnet50_program=a, resnet50_jit=b,
                   vit_b16_jit=static_vit_check(torch, T),
                   bert_base_program=static_bert_check(torch, T))
    finally:
        TPL._EXPECTED_DEVICE[0] = prev
    res["card"] = card_line()
    return res

def main(argv) -> int:
    """No arguments: every phase.  ``--kernels``: the card, the build of
    K1/K2 and their kernel phase only, into chiprun_out/
    chip_smoke_kernels.json (a quick way to time K1/K2 of any checkout:
    copy this script into its root and run it there).  ``--mesh``,
    ``--fleet``, ``--eager``, ``--dist``, ``--hybrid``, ``--moe-ps``: the
    serve of 4 and phase 15, 16, 17, 18, 19 or 20, into chiprun_out/
    chip_smoke_<mode>.json; ``--tensor-api``: the build and phase 21 alone,
    into chiprun_out/chip_smoke_tensor_api.json; ``--nn``: the build of
    K3/K4 and phase 22 alone, into chiprun_out/chip_smoke_nn.json (with
    four cards, 22 (e) runs four ranks over NCCL); ``--vision``: the build
    of K3/K4 and phase 23 alone, into chiprun_out/chip_smoke_vision.json;
    ``--quant-seq``: the build of K3/K4 and phase 24 alone, into
    chiprun_out/chip_smoke_quant_seq.json; ``--static``: the build of
    K3/K4 and phase 25 alone, into chiprun_out/chip_smoke_static.json."""
    import torch

    kernels_only = argv == ["--kernels"]
    mesh_only = argv == ["--mesh"]
    fleet_only = argv == ["--fleet"]
    eager_only = argv == ["--eager"]
    dist_only = argv == ["--dist"]
    hybrid_only = argv == ["--hybrid"]
    moe_ps_only = argv == ["--moe-ps"]
    tensor_api_only = argv == ["--tensor-api"]
    nn_only = argv == ["--nn"]
    vision_only = argv == ["--vision"]
    quant_seq_only = argv == ["--quant-seq"]
    static_only = argv == ["--static"]
    child = argv[:1] == ["--durability-child"] and len(argv) == 3
    fleet_kid = argv[:1] == ["--fleet-child"] and len(argv) == 3
    acp_kid = argv[:1] == ["--acp-child"] and len(argv) == 4
    hybrid_kid = argv[:1] == ["--hybrid-child"] and len(argv) == 2
    if argv and not (kernels_only or mesh_only or fleet_only or eager_only
                     or dist_only or hybrid_only or moe_ps_only
                     or tensor_api_only or nn_only or vision_only
                     or quant_seq_only or static_only or child
                     or fleet_kid or acp_kid or hybrid_kid):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch not found beside this script "
              f"({e})", file=sys.stderr)
        return 1
    if child:
        return durability_child(argv[1:])
    if fleet_kid:
        return fleet_child(argv[1:])
    if acp_kid:
        return acp_child(argv[1:])
    if hybrid_kid:
        return hybrid_child(argv[1:])

    # 1. card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all(["paged_attention"]
                            if kernels_only or mesh_only or fleet_only
                            else ["layer_norm"] if tensor_api_only
                            else ["flash_attention"] if nn_only
                            or vision_only or quant_seq_only or static_only
                            else None)
    build_s = time.perf_counter() - t0
    print(f"build: {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'}"
          f" in {build_s:.1f} s", flush=True)
    if kernels_only:
        res = dict(card=card, K1=kernel_phase(torch),
                   K2=kernel_phase(torch, quant=True))
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_kernels.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    if mesh_only:
        res = dict(card=card, device_count=torch.cuda.device_count())
        res["serve"], _ = serve_phase(torch)
        res["serve_ragged"] = ragged_serve_phase(torch, res["serve"])
        res["serve_mesh"] = mesh_phase(torch, res["serve_ragged"])
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_mesh.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    if eager_only:
        res = dict(card=card)
        res["serve"], _ = serve_phase(torch)
        res["eager"] = eager_phase(torch, res["serve"])
        res["serve"]["tokens"] = None
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_eager.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    if dist_only:
        res = dict(card=card)
        res["serve"], _ = serve_phase(torch)
        res["dist"] = dist_phase(torch)
        res["serve"]["tokens"] = None
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_dist.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    if hybrid_only:
        res = dict(card=card)
        res["serve"], _ = serve_phase(torch)
        t0 = time.perf_counter()
        res["hybrid"] = hybrid_phase(torch)
        res["hybrid"]["phase_s"] = time.perf_counter() - t0
        print(f"phase 19 hybrid: {res['hybrid']['phase_s']:.1f} s",
              flush=True)
        res["serve"]["tokens"] = None
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_hybrid.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    if moe_ps_only:
        res = dict(card=card)
        res["serve"], _ = serve_phase(torch)
        t0 = time.perf_counter()
        res["moe_ps"] = moe_ps_phase(torch)
        res["moe_ps"]["phase_s"] = time.perf_counter() - t0
        print(f"phase 20 moe-ps: {res['moe_ps']['phase_s']:.1f} s",
              flush=True)
        res["serve"]["tokens"] = None
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_moe_ps.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    if tensor_api_only:
        t0 = time.perf_counter()
        res = dict(card=card, tensor_api=tensor_api_phase(torch))
        print(f"phase 21 tensor-api: {time.perf_counter() - t0:.1f} s",
              flush=True)
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_tensor_api.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    if nn_only:
        t0 = time.perf_counter()
        res = dict(card=card, nn=nn_phase(torch))
        res["nn"]["phase_s"] = time.perf_counter() - t0
        print(f"phase 22 nn: {res['nn']['phase_s']:.1f} s", flush=True)
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_nn.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    if vision_only:
        t0 = time.perf_counter()
        res = dict(card=card, vision=vision_phase(torch))
        res["vision"]["phase_s"] = time.perf_counter() - t0
        print(f"phase 23 vision: {res['vision']['phase_s']:.1f} s",
              flush=True)
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_vision.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    if quant_seq_only:
        t0 = time.perf_counter()
        res = dict(card=card, quant_seq=quant_seq_phase(torch))
        res["quant_seq"]["phase_s"] = time.perf_counter() - t0
        print(f"phase 24 quant-seq: {res['quant_seq']['phase_s']:.1f} s",
              flush=True)
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_quant_seq.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    if static_only:
        t0 = time.perf_counter()
        res = dict(card=card, static=static_phase(torch))
        res["static"]["phase_s"] = time.perf_counter() - t0
        print(f"phase 25 static: {res['static']['phase_s']:.1f} s",
              flush=True)
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_static.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    if fleet_only:
        res = dict(card=card)
        res["serve"], _ = serve_phase(torch)
        res["fleet"] = fleet_phase(torch, res["serve"])
        res["serve"]["tokens"] = None
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_fleet.json").write_text(
            json.dumps(res, indent=1))
        print(card, flush=True)
        return 0
    builds = flash_build_report(_build) + paged_build_report(_build)
    for r in builds:
        print(f"build: {r['kernel']:>15} {r['dtype']:>8} "
              f"D={r['head_dim']:<3}: {r['registers']} registers, "
              f"{r['local_bytes']} local bytes (stack and spills), shared "
              f"memory {r['static_smem_bytes']} static + "
              f"{r['dynamic_smem_bytes']} dynamic bytes", flush=True)
    spilled = [f"{r['kernel']} {r['dtype']}" for r in builds
               if r["head_dim"] == 64 and r["local_bytes"] > 0]
    if spilled:
        fail(f"kernels at head_dim 64 use local memory: {spilled}")

    # each phase's wall seconds, printed as it ends and kept in the result
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    # 3. K1 and K2 against their plain version
    cases, q_cases = timed("3 kernel", lambda: (
        kernel_phase(torch), kernel_phase(torch, quant=True)))

    # 4. serve
    serve, launches = timed("4 serve", serve_phase, torch)

    # 5. quantized serve
    serve_q, launches_q = timed("5 quant", serve_quant_phase, torch, serve)

    # 6. the serve through the unified ragged step, f32 and int8
    ragged = timed("6 ragged", ragged_serve_phase, torch, serve)

    # 7. speculative serves
    spec = timed("7 spec", spec_serve_phase, torch, serve)

    # 8. K3/K4 against their plain versions
    flash_cases = timed("8 flash", flash_phase, torch)

    # 9. train
    train = timed("9 train", train_phase, torch)

    # 10. K5 against its plain version
    ln_cases = timed("10 ln", ln_phase, torch)

    # 11. train with K5
    train_ln = timed("11 ln train", ln_train_phase, torch, train)

    # 12. the legacy one-shot prefill, f32 and int8
    legacy = timed("12 legacy", legacy_serve_phase, torch, serve)

    # 13. frontend, containment, recovery, durability, watchdog
    reliability = timed("13 reliability", reliability_phase, torch, serve,
                        serve_q["tokens"])

    # 14. the telemetry plane
    telemetry = timed("14 telemetry", telemetry_phase, torch, serve,
                      serve_q["tokens"], ragged["f32"]["tokens"])

    # 15. tensor-parallel serving
    mesh = timed("15 mesh", mesh_phase, torch, ragged)

    # 16. the fleet
    fleet = timed("16 fleet", fleet_phase, torch, serve)

    # 17. eager train and generate
    eager = timed("17 eager", eager_phase, torch, serve)

    # 18. data-parallel training, the optimizers, the profiler,
    # auto-checkpoint
    distp = timed("18 dist", dist_phase, torch)

    # 19. hybrid-parallel training: tensor, ZeRO, pipeline, sequence and
    # the 4-axis GPT step, in a child process (`HybridChild`) beside
    # 20. expert parallelism, the parameter server, the data feed
    t0 = time.perf_counter()
    kid = HybridChild()
    try:
        moe_ps = timed("20 moe-ps", moe_ps_phase, torch)
        hybrid = kid.result()
    finally:
        kid.stop()
    phase_s["19 hybrid"] = hybrid.pop("phase_s")
    phase_s["19+20 side by side"] = time.perf_counter() - t0
    print(f"phase 19 hybrid: {phase_s['19 hybrid']:.1f} s, in its child "
          f"process beside phase 20; the two took "
          f"{phase_s['19+20 side by side']:.1f} s", flush=True)

    # 21. the functional tensor API and nn's activations, losses and norms
    tensor_api = timed("21 tensor-api", tensor_api_phase, torch)

    # 22. the rest of nn: BERT-base, the ViT-width encoder, Transformer-base
    # with beam search, the LSTM and the conv/pool/sampling tables,
    # SyncBatchNorm
    nnp = timed("22 nn", nn_phase, torch)

    # 23. vision: ResNet-50 through Model.fit, ViT-B/16 on K3/K4, YOLOv3's
    # steps and decode, the vision op table
    vision = timed("23 vision", vision_phase, torch)

    # 24. quantization (QAT, PTQ, int8 ResNet-50), 2:4 GPT-2-small, the
    # BERT-base CRF tagger, the op long tail
    quant_seq = timed("24 quant-seq", quant_seq_phase, torch)

    # 25. deployment: ResNet-50, ViT-B/16 and BERT-base served by the
    # Predictor from a ProgramDesc and from jit.save
    static = timed("25 static", static_phase, torch)

    # 26. report
    kernels = []
    # each serving path's launches, counted from 0 over its own serve
    k1_paths = dict(serve=launches,
                    ragged_serve=ragged["f32"]["launches_of_path"],
                    legacy_serve=legacy["f32"]["launches_of_path"],
                    **{f"spec_serve_{k}": v["launches_of_path"]
                       for k, v in spec.items()},
                    **{f"mesh_serve_mp2_rank{r}": n["K1"] for r, n in
                       mesh["mp2_f32"]["launches_by_rank"].items()},
                    mesh_serve_mp1_nccl=mesh["mp1_nccl"]["launches"][
                        "paged_attention"],
                    **{f"fleet_replica_{n}": r["k1_launches"] for n, r in
                       fleet["replica_reports"].items()})
    k2_paths = dict(quantized_serve=launches_q,
                    quantized_ragged_serve=ragged["int8"][
                        "launches_of_path"],
                    quantized_legacy_serve=legacy["int8"][
                        "launches_of_path"],
                    **{f"quantized_mesh_serve_mp2_rank{r}": n["K2"]
                       for r, n in mesh["mp2_int8"][
                           "launches_by_rank"].items()})
    for name, replaces, kcases, n, paths, library in (
            ("paged_attention", K1_REPLACES, cases, launches, k1_paths,
             "scaled_dot_product_attention on K/V gathered ahead of time "
             "(gather excluded)"),
            ("paged_attention_q", K2_REPLACES, q_cases, launches_q,
             k2_paths,
             "scaled_dot_product_attention on K/V dequantized and gathered "
             "ahead of time (excluded)")):
        main_cases = [c for c in kcases if c["dtype"] == "float32"
                      and c["case"] in ("decode", "mixed")]
        head = next(c for c in main_cases if c["case"] == "decode")
        mixed = next(c for c in main_cases if c["case"] == "mixed")
        kernels.append(dict(
            name=name, route="cuda", source=K1_SOURCE, replaces=replaces,
            launches=n, launches_by_path=paths,
            max_abs_err=max(c["max_abs_err"] for c in main_cases),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            timed_case="decode float32 B=8 Q=1 Hq=Hkv=12 D=64 page=64",
            mixed_ms=mixed["ms"], mixed_bound_ms=mixed["bound_ms"],
            mixed_bound_by=mixed["bound_by"],
            mixed_bound_unit=mixed["bound_unit"],
            mixed_library_ms=mixed["library_ms"],
            mixed_case="mixed float32 B=8 Q=64 Hq=Hkv=12 D=64 page=64",
            library_call=library, cases=kcases))
    # K3/K4 at the train path's own shape and dtype (bf16 under AMP)
    train_case = next(c for c in flash_cases if c["case"] == "train"
                      and c["dtype"] == "bfloat16")
    gen = eager["generate"]
    for kern, (replaces, _, _) in FLASH_KERNELS.items():
        k = train_case["kernels"][kern]
        if kern == "fwd":  # every case of K3/K4, once
            k = dict(k, cases=flash_cases)
        paths = dict(train=train["launches"][kern],
                     eager_train=eager["eager_vs_train_step"]["launches"][
                         kern],
                     **{f"dist_train_rank{r}": n[kern] for r, n in
                        distp["data_parallel"]["launches_by_rank"].items()},
                     **hybrid_launches(hybrid, kern),
                     **moe_ps_launches(moe_ps, kern),
                     nn_bert=nnp["bert"]["launches"][kern],
                     nn_vit_encoder=nnp["vit"]["launches"][kern],
                     nn_transformer_train=nnp["transformer"][
                         "train_launches"][kern],
                     vision_vit_b16=vision["vit_b16"]["launches"][kern],
                     quant_seq_sparse_gpt2=quant_seq["sparse_gpt2"][
                         "launches"][kern],
                     quant_seq_bert_crf_tagger=quant_seq["crf_tagger"][
                         "launches"][kern])
        if kern == "fwd":
            paths.update(generate_concat=gen["concat"]["calls"]
                         * gen["concat"]["k3_launches_per_call"],
                         generate_prealloc=0,
                         nn_transformer_beam_decode=nnp["transformer"][
                             "decode_launches"],
                         static_vit_b16_predictor_run=static[
                             "vit_b16_jit"]["k3_launches_a_run"],
                         static_resnet50_program_run=static[
                             "resnet50_program"]["k3_launches_a_run"],
                         static_bert_base_program_run=static[
                             "bert_base_program"]["k3_launches_a_run"])
        kernels.append(dict(
            name=f"flash_attention_{'bwd_' if kern != 'fwd' else ''}{kern}",
            route="cuda", source=FLASH_SOURCE, replaces=replaces,
            launches=train["launches"][kern], launches_by_path=paths, **k,
            timed_case="train bfloat16 B=16 H=12 S=1024 D=64 causal",
            plain_call=("_composed_attention" if kern == "fwd" else
                        "flash_attention_bwd_reference (dq, dk and dv "
                        "together)"),
            library_call=("scaled_dot_product_attention forward"
                          if kern == "fwd" else
                          "scaled_dot_product_attention backward (dq, dk "
                          "and dv together): forward+backward - forward")))
    # K5 at the train path's shape, in the dtype the path fed it
    path_dtype = train_ln["k5_inputs"][0][1]
    ln_head = next(c for c in ln_cases if c["case"] == "train"
                   and c["dtype"] == path_dtype)
    kernels.append(dict(
        name="layer_norm", route="cuda", source=LN_SOURCE,
        replaces=LN_REPLACES, launches=train_ln["launches"]["layer_norm"],
        launches_by_path=dict(
            train_layer_norm=train_ln["launches"]["layer_norm"],
            eager_step_layer_norm=eager["eager_vs_train_step"][
                "k5_step_launches"]["layer_norm"],
            tensor_api_nn_layer_norm=tensor_api["layer_norm"]["launches"]),
        **{k: ln_head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
        timed_case=f"train {path_dtype} [16384, 768]",
        plain_call="ops.layer_norm.layer_norm",
        library_call="torch.nn.functional.layer_norm", cases=ln_cases))
    result = dict(card=card, build_s=build_s, phase_s=phase_s,
                  kernel_build=builds,
                  kernels=kernels, serve=serve,
                  serve_quant=serve_q, serve_ragged=ragged, serve_spec=spec,
                  serve_legacy=legacy, serve_reliability=reliability,
                  telemetry=telemetry, serve_mesh=mesh, fleet=fleet,
                  train=train, train_layer_norm=train_ln, eager=eager,
                  dist=distp, hybrid=hybrid, moe_ps=moe_ps,
                  tensor_api=tensor_api, nn=nnp, vision=vision,
                  quant_seq=quant_seq, static=static)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    # the per-case rows stay in chip_smoke.json: the line keeps one row a
    # kernel, short enough for the end of the output
    print(json.dumps({"kernels": [{k: v for k, v in row.items()
                                   if k != "cases"} for row in kernels]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
