#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py             # from the repository root
    python3 chip_smoke.py --kernels   # phases 1-3 of K1/K2 only
    python3 chip_smoke.py --mesh      # phases 1-2, 4, 6 and 15 only
    python3 chip_smoke.py --fleet     # phases 1-2, 4 and 16 only
    python3 chip_smoke.py --eager     # phases 1-2, 4 and 17 only
    python3 chip_smoke.py --dist      # phases 1-2, 4 and 18 only
    python3 chip_smoke.py --hybrid    # phases 1-2, 4 and 19 only

(``--durability-child`` is phase 13's own child process,
``--fleet-child`` phase 16's replica, ``--acp-child`` phase 18's
auto-checkpoint job.)

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
19. hybrid — GPT-2-small at full width, bench.py's bf16 recipe, ranks
   from ``paddle.distributed.spawn`` (gloo on one card, NCCL with a card
   a rank): (a) ``fleet`` with ``mp_degree=2``: the model's parallel
   layers (6 heads a rank), 3 dygraph steps through
   ``distributed_model`` (`TensorParallel`) and 3 ``build_train_step``
   steps on the 8 x 1024 half of the train batch, the vocab-parallel
   cross entropy; step 1's loss against one process on the same batch
   (`DIST_LOSS_TOL`), K3/K4 launched num_layers x steps a rank; (b)
   ``strategy.sharding`` at stages 1, 2, 3 and 1 with offload, dp = 2, 3
   steps each on the batch-16 train batch against phase 18's
   one-process steps (`DIST_LOSS_TOL`), peak memory a rank against the
   data-parallel run's; (c) a `gpt_pipeline_layer` GPT at pp = 2,
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
20. report — one JSON line of kernels, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

The whole result also goes to chiprun_out/chip_smoke.json.  The script
imports nothing of JAX.
"""
from __future__ import annotations

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
    after `KILL_STEP` steps, restored by another process, f32 and int8:
    the restored tokens against the uninterrupted serve's (``clean``,
    by mode), every streamed token exactly once across the two lives, at
    least one sidecar page installed bit-equal to the dead process's
    bytes; then the journal's cost in this process."""
    import shutil
    import signal

    out = {}
    shutil.rmtree(JOURNAL_ROOT, ignore_errors=True)
    for mode in ("f32", "int8"):
        d = JOURNAL_ROOT / mode
        d.mkdir(parents=True)
        me = [sys.executable, str(Path(__file__).resolve()),
              "--durability-child"]
        t0 = time.perf_counter()
        serve = subprocess.run(me + ["serve", mode], capture_output=True,
                               text=True, timeout=300)
        if serve.returncode != -signal.SIGKILL:
            fail(f"durability {mode}: the journaled serve exited "
                 f"{serve.returncode}, not by SIGKILL:\n{serve.stderr[-2000:]}")
        restore = subprocess.run(me + ["restore", mode],
                                 capture_output=True, text=True,
                                 timeout=300)
        if restore.returncode != 0:
            fail(f"durability {mode}: the restore exited "
                 f"{restore.returncode}:\n{restore.stderr[-2000:]}")
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
        res["two_lives_s"] = time.perf_counter() - t0
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
DIST_STEPS = 3
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
OPT_STEPS = 3
ACP_EPOCHS = 4
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
            ran["epochs"] != [2, 3] or not equal or \
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
HYBRID_STEPS = 3
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
    # one process: step 1 on the 8 x 1024 half, three steps on batch 16
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


def main(argv) -> int:
    """No arguments: every phase.  ``--kernels``: the card, the build of
    K1/K2 and their kernel phase only, into chiprun_out/
    chip_smoke_kernels.json (a quick way to time K1/K2 of any checkout:
    copy this script into its root and run it there).  ``--mesh``,
    ``--fleet``, ``--eager``, ``--dist``, ``--hybrid``: the serve of 4
    and phase 15, 16, 17, 18 or 19, into chiprun_out/
    chip_smoke_<mode>.json."""
    import torch

    kernels_only = argv == ["--kernels"]
    mesh_only = argv == ["--mesh"]
    fleet_only = argv == ["--fleet"]
    eager_only = argv == ["--eager"]
    dist_only = argv == ["--dist"]
    hybrid_only = argv == ["--hybrid"]
    child = argv[:1] == ["--durability-child"] and len(argv) == 3
    fleet_kid = argv[:1] == ["--fleet-child"] and len(argv) == 3
    acp_kid = argv[:1] == ["--acp-child"] and len(argv) == 4
    if argv and not (kernels_only or mesh_only or fleet_only or eager_only
                     or dist_only or hybrid_only or child or fleet_kid
                     or acp_kid):
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

    # 1. card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all(["paged_attention"]
                            if kernels_only or mesh_only or fleet_only
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
        res["hybrid"] = hybrid_phase(torch)
        res["serve"]["tokens"] = None
        out_dir = Path("chiprun_out")
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_hybrid.json").write_text(
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

    # 3. K1 and K2 against their plain version
    cases = kernel_phase(torch)
    q_cases = kernel_phase(torch, quant=True)

    # 4. serve
    serve, launches = serve_phase(torch)

    # 5. quantized serve
    serve_q, launches_q = serve_quant_phase(torch, serve)

    # 6. the serve through the unified ragged step, f32 and int8
    ragged = ragged_serve_phase(torch, serve)

    # 7. speculative serves
    spec = spec_serve_phase(torch, serve)

    # 8. K3/K4 against their plain versions
    flash_cases = flash_phase(torch)

    # 9. train
    train = train_phase(torch)

    # 10. K5 against its plain version
    ln_cases = ln_phase(torch)

    # 11. train with K5
    train_ln = ln_train_phase(torch, train)

    # 12. the legacy one-shot prefill, f32 and int8
    legacy = legacy_serve_phase(torch, serve)

    # 13. frontend, containment, recovery, durability, watchdog
    reliability = reliability_phase(torch, serve, serve_q["tokens"])

    # 14. the telemetry plane
    telemetry = telemetry_phase(torch, serve, serve_q["tokens"],
                                ragged["f32"]["tokens"])

    # 15. tensor-parallel serving
    mesh = mesh_phase(torch, ragged)

    # 16. the fleet
    fleet = fleet_phase(torch, serve)

    # 17. eager train and generate
    eager = eager_phase(torch, serve)

    # 18. data-parallel training, the optimizers, the profiler,
    # auto-checkpoint
    distp = dist_phase(torch)

    # 19. hybrid-parallel training: tensor, ZeRO, pipeline, sequence and
    # the 4-axis GPT step
    hybrid = hybrid_phase(torch)

    # 20. report
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
                     **hybrid_launches(hybrid, kern))
        if kern == "fwd":
            paths.update(generate_concat=gen["concat"]["calls"]
                         * gen["concat"]["k3_launches_per_call"],
                         generate_prealloc=0)
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
                "k5_step_launches"]["layer_norm"]),
        **{k: ln_head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
        timed_case=f"train {path_dtype} [16384, 768]",
        plain_call="ops.layer_norm.layer_norm",
        library_call="torch.nn.functional.layer_norm", cases=ln_cases))
    result = dict(card=card, build_s=build_s, kernel_build=builds,
                  kernels=kernels, serve=serve,
                  serve_quant=serve_q, serve_ragged=ragged, serve_spec=spec,
                  serve_legacy=legacy, serve_reliability=reliability,
                  telemetry=telemetry, serve_mesh=mesh, fleet=fleet,
                  train=train, train_layer_norm=train_ln, eager=eager,
                  dist=distp, hybrid=hybrid)
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
