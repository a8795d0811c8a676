"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels to
their plain versions.

    python3 chip_smoke.py                 # every phase (one card)
    python3 chip_smoke.py --kernels-only  # build + kernel phases only
    python3 chip_smoke.py --profile       # also torch.profiler breakdowns
    python3 chip_smoke.py --rl-only       # the RL phases (12, 13) alone, on their cluster
    python3 chip_smoke.py --vit-only      # the ViT-B/16 phase (14) alone
    python3 chip_smoke.py --tune-only     # the Tune and Job phase (15), on its cluster
    python3 chip_smoke.py --cli-only      # the CLI and launcher phase (16)
    python3 chip_smoke.py --parallel-only # the mesh-parallel phase (17)
    python3 chip_smoke.py --mpmd-only     # the MPMD phase (18)
    python3 chip_smoke.py --wide-only     # build, phase 4, the wide-head and hd-72 flagships (7)

Phases, in order; any failure raises and the process exits non-zero:
  1. the card (the nvidia-smi name and power limit on a line of their
     own), torch and CUDA versions;
  2. build every kernel library in ``ray_tpu_torch/ops/csrc`` (one nvcc
     per source, all started together), with ptxas's registers, shared
     memory and spills, and each library's count of wgmma (``HGMMA``),
     TMA-load (``UTMALDG``) and ``mma.sync`` (``HMMA``) instructions: every
     Hopper kernel (``HOPPER_KERNELS``, the wide ones included) must have
     the first two and none of the third (the fp32 route's
     ``flash_fwd_fp32``, ``flash_bwd_dq_fp32`` and ``flash_bwd_dkv_fp32``
     among them;
     ``flash_general`` is SIMT: its counts are printed only);
  3. kernel phase: each Hopper kernel's wrapper on the card against its
     plain PyTorch version at the shapes the main paths give it (and the
     CPU test shapes, and the edges of the kernels' tiles), with times, the
     bound and a library yardstick; the dQ kernel's delta against
     rowsum(dO * O) in torch; dQ and dK/dV run again must agree bitwise
     (no atomics); inputs no kernel takes (head dim 264, a non-contiguous
     dO, a bf16 lse) raise;
  4. general-kernel phase: the three kernels of ``csrc/flash_general.cu``
     against their plain versions at ``GENERAL_SHAPES``, with times,
     bounds, plain and SDPA times: the general route's own inputs (fp16
     head dim 72 at scale < 0) and, as the "earlier" times of the TMA
     kernels, the fp32 shapes the fp32 route takes (fp32 GQA [2, 8/2,
     1024, 64], the fp32 model's [4, 8/4, 512, 64], [1, 16/16, 2048, 128],
     all causal) and the bf16/fp16 shapes the Hopper and wide routes take
     (head dim 256 causal, a GQA at 256, 144 ragged cross-length, the
     wide-head flagship's [12, 9, 2048, 256]; off the 16 grid: fp16 72
     cross-length, SigLIP's [32, 16, 729, 72], DiT's [8, 16, 1024, 72]
     beside 64 and 128, SD 1.5's [2, 8, 4096, 40], the hd-72 flagship's
     [12, 32, 2048, 72], 136 causal and a GQA at 100, staged to 104; and
     b*H = 65,600). At each shape of a TMA route its forward and backward
     (dQ, then dK/dV: ``csrc/flash_fwd.cu``, ``flash_bwd.cu``,
     ``flash_bwd_dkv.cu`` or the wide ``flash_fwd_wide.cu``,
     ``flash_bwd_wide.cu``, ``flash_bwd_dkv_wide.cu``) against the plain
     versions too (``O_TOL``, ``LSE_TOL``, ``GRAD_REL_TOL``; the dQ
     kernel's delta against rowsum(dO * O) in torch within
     ``DELTA_REL_TOL``), timed beside the general kernels, dQ and dK/dV
     each run twice bitwise equal; a head dim off the 8 grid on zero-padded
     copies, the ops' staged outputs bit-equal to them, each op counting one
     ``stage_head_dim`` use; at each fp32 shape the fp32 route's forward,
     dQ and dK/dV (``csrc/flash_fwd_fp32.cu``, ``flash_bwd_dq_fp32.cu``,
     ``flash_bwd_dkv_fp32.cu``) against the plain versions (o and lse
     within 2e-4, dQ, dK and dV within ``FP32_DKV_REL_TOL`` of the largest
     value, the dQ kernel's delta within ``DELTA_REL_TOL`` of rowsum(dO *
     O) in torch, dQ and dK/dV each run twice bitwise equal), timed beside
     the general kernels and SDPA with TF32 off, bound at the split's rate;
     then the TMA kernels at ``WIDE_EDGE_SHAPES``, ``OFF_GRID_EDGE_SHAPES``
     and the fp32 kernels at ``FP32_EDGE_SHAPES`` (the edges of their tiles
     and widths; the fp32 dQ timed there too);
  5. training phase: ``make_train_step`` on the 750M flagship config of
     ``bench.py`` (full width, full depth, remat, batch 12 x 2048, random
     weights and tokens from seeds) under each remat policy ("full",
     "dots", "attn") for 2 warm-up and 8 timed steps from the same
     weights; every step launches flash_fwd 20 times under "full" and
     "dots" (forward + recompute) and 10 under "attn", each backward
     kernel 10 times and no general kernel; the loss falls, and each
     policy's losses match "full"'s;
  6. fp32 training: a 2-layer fp32 model (heads of 64) trains a few steps
     through the fp32 route (its forward, dQ and dK/dV kernels, no other
     kernel), and the same model with heads of 256 through
     the general kernels; each one's loss and gradients match the same
     model through plain attention;
  7. full-width gradient check: loss and every gradient of the 750M model
     through the kernels against the same model through plain attention;
     then the wide-head flagship (``wide_training_phase``): the 750M
     config with 9 q and 9 kv heads of 256 ("full" remat, batch 12 x 2048)
     trains 5 steps, each launching 20 wide forwards, 10 wide dQ and
     10 wide dK/dV kernels and nothing else, the loss falling; and its
     loss and every gradient on one 1 x 2048 batch against plain
     attention, held to the same bounds; then the hd-72 flagship
     (``off_grid_training_phase``): the same config with 32 q and 32 kv
     heads of 72, 5 steps launching 20 Hopper forwards, 10 dQ and 10
     dK/dV and nothing else (no staged copy), and its gradient check;
  8. serving phase: ``LLMEngine`` serving llama7b (bf16, full width, random
     weights from a seed) through the paged engine, then a shared-prefix
     pass and a chunked-prefill pass; the forward kernel's launch counter
     must equal 32 x the full-prompt prefills (no general kernel runs),
     and full-width prefill
     logits through the kernel must match the same forward through the
     plain version;
  9. runtime phase: ``ray_tpu_torch.init`` starts a cluster whose ``GPU``
     resource (1) was detected, one node agent joins it, and an actor with
     ``num_gpus=1`` (``CUDA_VISIBLE_DEVICES=0``, or the first card of the
     driver's own mask, and no ``ray_tpu`` or ``jax``
     in its ``sys.modules``) builds llama7b from the serving phase's seed,
     runs the contiguous ``generate`` twice on four prompts (16 greedy
     tokens each; the first run pays the fresh process's CUDA set-up and
     must import no ``torch._dynamo``),
     then serves the serving phase's prompt mix through ``LLMEngine``; its
     tokens come back through the object store and must equal the
     driver's own ``generate`` on the same seed and prompts, its launch
     counts must show the forward kernel (and no general kernel), the
     state API must show its device row (the card's name, nonzero bytes
     in use), neither the controller nor the agent may hold a CUDA context
     (absent from ``nvidia-smi --query-compute-apps``, no ``libcuda``
     mapped), and the ``GPU`` resource must come back when the actor is
     killed;
 10. serve phase, on the runtime phase's cluster: ``ray_tpu_torch.serve``
     runs the deployment ``llm`` (``ServeLLM``: llama7b at full width and
     depth behind one ``LLMEngine`` with the serving phase's settings) as a
     ``num_gpus=1`` replica behind the HTTP proxy; start to ready and the
     fresh replica's first request are timed (it must import no
     ``torch._dynamo``); the runtime phase's four prompts, sent one at a
     time as ndjson, must come back token for token as this process's own
     ``LLMEngine`` gives them; the serving phase's mix from 10 concurrent
     HTTP clients must give each 32 tokens, with client-side TTFT/TPOT
     printed beside the replica engine's and the serving phase's; the
     replica launches the forward kernel 32 times a full-prompt prefill and
     no other attention kernel; the serve histograms, ``serve_state`` and
     ``summarize_serve`` must show the requests at the control plane; the
     replica holds the card it was handed and no ``ray_tpu`` or ``jax``;
     the serve controller, the proxy, the cluster controller and the node
     agent map no ``libcuda``; the ``GPU`` comes back after
     ``serve.shutdown()``;
 11. train-on-the-runtime phase, on the same cluster: a ``CudaTrainer``
     (``ScalingConfig(num_workers=1, use_gpu=True,
     use_torch_distributed=True)``) runs ``train_worker_loop`` in one
     ``num_gpus=1`` worker, which must hold the card it was handed, load no
     ``ray_tpu`` or ``jax``, sit in an NCCL process group (world size 1)
     whose ``device_allreduce`` gives a CUDA tensor back, and train the
     750M flagship of the training phase ("full", batch 12 x 2048, its
     seeds) with ``make_train_step(..., group=)`` for 2 warm-up and 4 timed
     steps, fed by its dataset shard (``ray_tpu_torch.data.from_numpy`` of
     the training phase's token batch, once per step) through
     ``iter_device_batches`` (every batch on the card, from pinned memory,
     at most 2 ahead); it reports every step and, after step 3, saves the
     train state with ``dist_checkpoint`` into the report's checkpoint.
     Its losses must equal the training phase's, each step must launch
     20/10/10 Hopper kernels and no general one, ``Result.checkpoint`` must
     be complete, and a second ``fit()`` resumed from it must give the
     uninterrupted run's losses for steps 4-6; the controller and the
     agent map no ``libcuda``; the ``GPU`` comes back after each
     ``fit()``, and the checkpoint directory is removed.
 12. RL phase, on the same cluster (``rl_phase``), at the shape of
     ``bench.py``'s ``_bench_rl_ppo_cpu`` (4 CPU runner actors x 2 envs,
     fragment 256, batch 2048, minibatch 256, 4 epochs, lr 1e-3, KL
     early-stop off, seed 0) on CartPole-v1 (gymnasium's when it imports,
     else ``NumpyCartPole``, defined here and shipped to the runners):
     (a) synchronous PPO with the local learner on the card, one warm-up
     and 6 timed iterations: env-steps/s, the runners' spawn, the learner's
     ms per minibatch, and the last iteration's 32 minibatches replayed
     from one state by a learner on the card and one on the CPU in this
     process (their first losses must agree); (b) the same on the podracer
     (4 async runners, queue 16) with runner 0 killed at iteration 3: a
     restart must show within 15 s; (c) IMPALA on the podracer, one
     warm-up and 3 timed iterations, and its V-trace builder on the card against the same
     builder on the CPU from the same weights (1e-5); (d) a
     ``num_gpus=1`` learner actor's weights after 3 updates equal a local
     learner's on the card to 1e-6, and the GPU comes back after
     ``shutdown()``. No runner initializes CUDA or maps ``libcuda`` beyond
     what importing torch alone maps, every weight the learners return is
     on the CPU, every loss is finite and every
     ``episode_return_mean`` a number.
 13. off-policy RL phase, on the same cluster (``rl_offpolicy_phase``),
     the learners on the card, the runners CPU actors on ``NumpyCartPole``
     (or gymnasium's CartPole-v1): (a) DQN with prioritized replay at the
     reference's learning config (2 runner actors x 2 envs, fragment 32,
     batch 64, buffer 20,000, learning_starts 1,000, 32 updates an
     iteration, a target sync every 100, epsilon over 5,000 steps, lr 1e-3),
     one warm-up and then iterations until two target syncs: env-steps/s,
     spawn, per update the ms of ``buffer.sample``, ``update_from_batch``
     on the card and ``update_priorities``, replay sampling's share, the
     ``_sync_target`` ms, and the last iteration's minibatches replayed
     from one state on the card and on the CPU (first losses within
     1e-5); epsilon decayed, priorities finite and moved, the target equal
     to the Q net bit for bit (not aliased) right after each sync; (b) SAC
     at the reference's smoke config from one runner actor x 2 envs, 6
     iterations: alpha and mean Q finite, updates ran, the first update
     against a CPU learner's (1e-5); (c) CQL, BC and MARWIL offline from 20
     episodes of the scripted expert (CQL's with every third episode
     random, as its reference test's data), at their reference tests'
     configs: 64 CQL updates with a finite, non-negative penalty; BC and
     MARWIL each return >= 60 greedily; updates/s; each first update
     against a CPU learner's (1e-5). Every weight and Adam moment comes
     back on the CPU and no runner initializes CUDA;
 14. ViT phase (``vit_phase``, before the runtime phases): ViT-B/16 at full
     width (86M params from a seeded generator, bf16 compute, fp32 params
     and Adam): the card's bf16 logits of 2 images against the CPU's fp32
     forward (``VIT_LOGITS_REL_TOL``), then 2 warm-up and 10 timed steps at
     batch 64 of the reference's quadrant task at 224 pixels (the loss
     finite and falling; step ms, images/s, peak memory, MFU), and the same
     steps from the same weights with ``remat=True`` (losses equal to
     ``VIT_REMAT_LOSS_REL_TOL``);
 15. Tune and Job phase, on the runtime phase's cluster after the RL
     phases (``tune_phase``): a ``Tuner`` over ``lr`` in ``TUNE_LRS`` with
     ``resources_per_trial`` ``{"num_cpus": 1, "num_gpus": 1}`` (no cap on
     concurrent trials: the tuner starts both runners and the one ``GPU``
     runs them one after the other) runs ``tune_trial_loop``: the 750M
     flagship of the training phase ("full", batch 12 x 2048, its seeds),
     4 steps a trial, then a forward-only eval loss and the params saved
     with ``torch.save`` into the trial's checkpoint directory. Both trials
     must end ``TERMINATED`` on the node's card, their loops must not
     overlap, every step must launch 20/10/10 Hopper kernels and no
     general one, the lr 3e-4 trial's losses must equal the training
     phase's first four bit for bit (the lr 1e-4 trial's first one too),
     ``get_best_result()`` must be the trial with the lower last loss, its
     checkpoint reloaded here must give its eval loss (to
     ``TUNE_RELOAD_REL_TOL``), the ``GPU`` must come back and no trial
     process may be left. Then a job submitted through
     ``JobSubmissionClient`` (the gateway's ``/api/jobs`` route), working
     dir the repo root, runs ``job_main``: a ``num_gpus=1`` actor
     (``JobFlashActor``) launches flash_fwd once at ``JOB_SHAPE`` against
     its plain version (``O_TOL``, ``LSE_TOL``); the job must succeed, its
     logs must hold the result line, and its own driver must initialize
     no CUDA.
 16. CLI and launcher phase (``cli_phase``), after the runtime phases'
     cluster has shut down, under a ``RAY_TPU_TORCH_TMPDIR`` and ``HOME`` of
     its own: (a) ``python -m ray_tpu_torch.scripts.cli start --head
     --num-cpus 4`` with no ``--num-gpus`` must advertise the card
     (``status``: ``GPU: 1/1``); ``submit -- python3 chip_smoke.py
     --cli-job`` runs ``cli_job_main``, whose ``num_gpus=1`` actor
     (``CliTrainActor``) trains the 750M flagship ("full", batch 12 x 2048,
     the training phase's seeds) for ``CLI_JOB_STEPS`` steps: the job must
     succeed, its losses must equal the training phase's first ones bit
     for bit, it must launch 20/10/10 Hopper kernels a step and no general
     one, its driver must initialize no CUDA, and ``status`` must show the
     ``GPU`` free again; ``profile device`` while a ``num_gpus=1`` actor
     (``CliLoopActor``, which runs no profiler session of its own first)
     loops flash_fwd at ``JOB_SHAPE`` must capture a trace naming the
     forward kernel, and every worker's capture must start; ``microbenchmark``'s four numbers
     must be positive; after ``stop`` no process of the cluster may be
     left, and the head controller must map no ``libcuda``. (b)
     ``autoscaler.commands.create_or_update_cluster`` of
     ``LAUNCHER_CLUSTER`` (the fake provider, a head with no GPU, node
     type ``gpu_node`` with one ``GPU``, ``idle_timeout_s`` 15) and
     ``exec_on_cluster`` of ``autoscale_driver_main``: its ``num_gpus=1``
     actor (``JobFlashActor``) makes the monitor launch ``gpu_node``, must
     land there and not on the head, and its flash_fwd must agree with the
     plain version (``O_TOL``, ``LSE_TOL``); once the actor is killed the
     node must be reaped within ``idle_timeout_s`` plus
     ``LAUNCHER_REAP_MARGIN_S``; the monitor and the head map no
     ``libcuda``; ``teardown_cluster`` must leave no head, monitor or
     agent and no cluster record.
 17. parallel phase (``parallel_phase``, after the training phases): the
     750M flagship at full width ("full", bf16 compute, fp32 params and
     AdamW) cut to ``PARALLEL_LAYERS`` layers, at a global batch of
     ``PARALLEL_BATCH`` x 2048 under each of ``PARALLEL_PLANS`` (fsdp2,
     tp2, sp2 ring, sp2 Ulysses, pp2 with 2 microbatches, ep2 on its MoE
     form with ``PARALLEL_EXPERTS`` experts, top-2, at full width, and
     fsdp2·tp2 on 4 ranks), its ranks
     spawned processes sharing cuda:0 over gloo, one spawn for every plan
     of a world size, plan after plan (``build_mesh``; the backend, the
     bytes staged through the host, and the bytes of CUDA tensors handed
     to gloo printed). First the bare single-process step on the
     same seeds and batch, dense and MoE, 3 steps each, then freed; then
     the three Hopper kernels at the plans' local shapes against their
     plain versions; then each plan for 3 steps, every rank's shards drawn
     straight from the bare step's seeds: every rank's losses and grad
     norms within the plan's ``PARALLEL_REL_TOL`` of the bare step's, 2L/L/L Hopper launches a step on every rank (L = ``PARALLEL_LAYERS``; none
     under the ring, whose blocks are einsums) and no general one, and
     each rank's step ms (ranks sharing one card: no multi-card speed) and
     peak memory printed.
 18. MPMD phase (``mpmd_phase``, after the parallel phase, held to its bare
     dense step): the same flagship and batch over ``MPMD_STAGES`` stages of
     ``PARALLEL_LAYERS / MPMD_STAGES`` layers and ``MPMD_MICROBATCHES``
     microbatches, 3 steps: (a) the
     single-process ``MpmdPipeline`` on cuda:0 in ``full_head`` and in
     ``per_microbatch``; (b) ``MpmdGangPipeline`` on 2 spawned gloo ranks
     sharing cuda:0, a stage each (the bridge's backend and the bytes
     staged through the host printed); each run's losses and grad norms
     within ``MPMD_REL_TOL`` of the bare step's, and 6/2/2 Hopper
     launches a stage a step (each layer's forward in the wavefront, in the
     stage's recompute and in remat's, one dQ and one dK/dV per
     microbatch) and no general one; (c) a ``HopDeviceChannel`` round trip
     of a bf16 ``MPMD_HOP_SHAPE`` activation from rank 0 to rank 1 and back
     by a reverse hop, bit for bit; the Hopper kernels at a stage's local
     shape ``[2, 18, 2048, 128]`` against their plain versions.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a
card the script fails before printing any result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

_IMPORT_BEGAN = time.time()  # wall clock: a serve replica reports its import of this module
import torch  # noqa: E402

_TORCH_IMPORTED = time.time()

# Published dense peaks (NVIDIA data sheets): bf16/fp16 tensor-core FLOP/s,
# device-memory bytes/s and fp32 (non-tensor) FLOP/s, by the name torch
# reports.
_PEAKS = (
    ("H100 PCIe", 756e12, 2.0e12, 51e12),
    ("H100 NVL", 835e12, 3.9e12, 60e12),
    ("H200", 989e12, 4.8e12, 67e12),
    ("H100", 989e12, 3.35e12, 67e12),
)

# Kernel tolerances, kernel (bf16 in, bf16 out, P rounded to bf16 for the
# P V product) against the plain version computed in fp32 from the same
# bf16 inputs: o carries one bf16 rounding of values |o| < 4 (half an ulp
# <= 2^-8) plus the rounding of P; lse is fp32 on both sides and differs
# only in summation order.
O_TOL = 2e-2
LSE_TOL = 2e-3
# Full-width (32-layer, bf16) prefill logits, kernel vs plain attention:
# the per-layer difference above is carried through 32 bf16 layers.
LOGITS_REL_TOL = 5e-2
LOGITS_TOP1_MIN = 0.9
# Backward kernels (bf16 in and out; P and dS rounded to bf16 as the A
# operand of their products) against the plain backward in fp32 on the
# same bf16 inputs, o and lse: max |d - plain| / max |plain| per output.
# An emulation of those roundings in fp32 on the CPU gave <= 0.5% at
# [1, 2, S, 128] for S up to 2048, mostly the final bf16 rounding of
# values up to ~5 (the card gives <= 0.5% too); 2e-2 leaves a 4x margin.
GRAD_REL_TOL = 2e-2
# Full-width (10-layer, bf16) training loss and gradients, kernels vs plain
# attention: the per-layer differences above pass through 10 bf16 layers
# and their remat recompute. Loss relative, global grad norm relative,
# and every parameter's gradient by cosine. Both routes read the same to
# the digit run after run on the H100: loss within 1.7e-5 and every cosine
# >= 0.99974 (18 heads of 128 and 9 of 256).
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_GNORM_REL_TOL = 2e-2
TRAIN_GRAD_COS_MIN = 0.9997

TRAIN_SHAPE_LABEL = "train [12, 18, 2048, 128]"
GQA_SHAPE_LABEL = "gqa 32q/8kv S=2048"
# The edges of the forward's 128-row q and 128-key tiles, of the dK/dV
# kernel's 128-key blocks and of the dQ kernel's pairs of 128-row q tiles
# and 64-key tiles: (label, b, H, KV, q_len, k_len, hd, causal, dtype,
# timed), as in the phases below.
EDGE_SHAPES = [
    ("causal 129 hd128", 1, 2, 2, 129, 129, 128, True, torch.bfloat16, False),
    ("gqa 4:1 noncausal ragged 200x328 hd128", 1, 4, 1, 200, 328, 128, False, torch.bfloat16,
     False),
    ("causal 255 hd64", 1, 2, 2, 255, 255, 64, True, torch.bfloat16, False),
    # head_dim 80: the second 64-column box is mostly past hd (zero-filled).
    ("hd80 gqa 2:1 causal 130", 1, 4, 2, 130, 130, 80, True, torch.bfloat16, False),
    # A pair of 128-row q tiles plus a single; one key past a 64-key tile.
    ("causal 257 hd128", 1, 2, 2, 257, 257, 128, True, torch.bfloat16, False),
    ("noncausal 65x65 hd128", 1, 2, 2, 65, 65, 128, False, torch.bfloat16, False),
]
# Every kernel is built around TMA and wgmma: its SASS must hold both, and
# no mma.sync (the fp32 route's too: wgmma, not mma.sync, is the way to the
# tensor cores' full rate on Hopper, and its split needs that rate).
HOPPER_KERNELS = ("flash_fwd", "flash_bwd", "flash_bwd_dkv", "flash_fwd_wide",
                  "flash_bwd_wide", "flash_bwd_dkv_wide", "flash_fwd_fp32", "flash_bwd_dq_fp32",
                  "flash_bwd_dkv_fp32")
# The dQ kernels' delta against rowsum(dO * O) in torch: fp32 sums of hd
# products in another order, relative to the largest |delta|.
DELTA_REL_TOL = 1e-4
# The serving phase's prompt mix (prompt lengths; 32 new tokens each), and
# the runtime phase's contiguous-generate prompts (16 greedy tokens each).
SERVE_PROMPT_LENS = (16, 40, 100, 200, 333, 500, 650, 700, 24, 300)
SERVE_NEW_TOKENS = 32
RUNTIME_GEN_LENS = (16, 128, 333, 700)
RUNTIME_GEN_NEW_TOKENS = 16
# The serve phase: the cold replica's first request (one 16-token prompt,
# 16 new tokens), then the runtime phase's four prompts one at a time,
# then the serving phase's mix from concurrent HTTP clients.
SERVE_COLD_LEN = 16
SERVE_MIN_FINISHED = len(RUNTIME_GEN_LENS) + len(SERVE_PROMPT_LENS)  # the cold ones on top


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_phase(fn):
    """``fn`` logging its seconds and the seconds since this module was
    imported, so a run shows where its time limit goes."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f} s "
                f"({time.time() - _IMPORT_BEGAN:.1f} s since the start)")

    return run


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def sass_counts(path: str) -> dict:
    """``HGMMA`` (wgmma), ``UTMALDG`` (TMA load) and ``HMMA`` (mma.sync)
    instructions in a built library's SASS, read with the toolkit's
    ``cuobjdump``."""
    from ray_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "HMMA")}


# The fp32 route's kernels compute each fp32 product as six bf16 tensor-core
# products of a three-way split (ray_tpu_torch/ops/csrc/flash_fp32.cuh).
FP32_SPLIT_PRODUCTS = 6


def peaks(name: str, fp32: bool = False, split: bool = False):
    """(FLOP/s, bytes/s): the tensor-core bf16/fp16 rate, with ``fp32`` the
    fp32 FMA rate, with ``split`` the rate of fp32 products through the
    fp32 route's split (the bf16 rate over ``FP32_SPLIT_PRODUCTS``:
    ~165 TFLOP/s on an H100 SXM)."""
    for key, flops, bw, flops32 in _PEAKS:
        if key in name:
            if split:
                return flops / FP32_SPLIT_PRODUCTS, bw
            return (flops32 if fp32 else flops), bw
    raise RuntimeError(f"no published peaks for card {name!r}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call. The calls are enqueued behind a GPU spin
    (~50 ms) so the events bracket back-to-back device work, not the
    host's launch rate (which bounds small shapes otherwise, and SDPA's
    fp32 GQA backward, a dozen eager ops, behind a shorter spin)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Per attention kernel: FLOPs per kept (query, key) pair per head_dim
# element, q-side and kv-side 16-bit tensors read or written once, and
# fp32 rows ([b*H, q_len]) read or written once.
_ATTN_WORK = {
    "fwd": (4, 2, 2, 1),  # S, P V; q, o; k, v; lse
    "dq": (6, 4, 2, 2),   # S, dP, dQ; q, o, do, dq; k, v; lse, delta
    "dkv": (8, 2, 4, 2),  # S, dP, dV, dK; q, do; k, v, dk, dv; lse, delta
}


def attention_bound_ms(b, H, KV, q_len, k_len, hd, causal, elem_bytes, card, kind="fwd",
                       split: bool = False):
    """Least time for the work: max(bytes / memory rate, FLOPs / peak), the
    peak of the inputs' type (fp32 FMAs for 4-byte elements, the tensor
    cores for bf16/fp16; with ``split``, fp32 through the fp32 route's
    split, ``peaks(split=True)``). FLOPs: the kernel's products, 2*hd each,
    per (query, key) pair this causal mask keeps; bytes: each input and
    output once (``_ATTN_WORK``)."""
    flops_peak, bw = peaks(card, fp32=elem_bytes == 4, split=split)
    per_pair, n_q, n_kv, n_rows = _ATTN_WORK[kind]
    if causal:
        pairs = sum(min(i + 1, k_len) for i in range(q_len))
    else:
        pairs = q_len * k_len
    flops = per_pair * hd * pairs * b * H
    nbytes = (elem_bytes * hd * (n_q * b * H * q_len + n_kv * b * KV * k_len)
              + 4 * n_rows * b * H * q_len)
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@timed_phase
def thread_launch_check() -> dict:
    """flash_fwd at ``JOB_SHAPE`` launched from a fresh host thread (one
    that made no CUDA call) must give this thread's output bit for bit
    (ROADMAP C5: it failed with cudaErrorInvalidValue)."""
    import threading

    from ray_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(*JOB_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    scale = JOB_SHAPE[-1] ** -0.5
    o, lse = att.flash_forward_cuda(q, k, v, True, scale)
    got = {}

    def launch():
        try:
            got["out"] = att.flash_forward_cuda(q, k, v, True, scale)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — raised below, in the caller's thread
            got["error"] = repr(e)

    t = threading.Thread(target=launch, name="fresh-thread-launch")
    t.start()
    t.join()
    if "error" in got or not (torch.equal(got["out"][0], o) and torch.equal(got["out"][1], lse)):
        raise AssertionError(f"flash_fwd from a fresh host thread: {got.get('error', 'differs')}")
    log(f"[kernel] flash_fwd from a fresh host thread at {list(JOB_SHAPE)}: bit-equal")
    return {"fresh_thread_bit_equal": True}


@timed_phase
def kernel_phase(card: str) -> dict:
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # (label, b, H, KV, q_len, k_len, hd, causal, dtype, timed)
    slice_shapes = [
        (f"slice S={s}", 1, 32, 32, s, s, 128, True, torch.bfloat16, True)
        for s in (16, 32, 64, 128, 256, 512, 1024)
    ]
    other_shapes = [
        (TRAIN_SHAPE_LABEL, 12, 18, 18, 2048, 2048, 128, True, torch.bfloat16, True),
        (GQA_SHAPE_LABEL, 2, 32, 8, 2048, 2048, 128, True, torch.bfloat16, True),
        ("causal 128 hd64", 2, 4, 4, 128, 128, 64, True, torch.bfloat16, False),
        ("noncausal ragged 96x160 hd64", 1, 4, 2, 96, 160, 64, False, torch.bfloat16, False),
        ("gqa 8:2 causal hd64", 2, 8, 2, 128, 128, 64, True, torch.bfloat16, False),
        ("gqa 8:2 noncausal hd64", 2, 8, 2, 128, 128, 64, False, torch.bfloat16, False),
        ("ragged causal 192 hd32", 1, 2, 2, 192, 192, 32, True, torch.bfloat16, False),
        ("cross-length causal 320x128 hd32", 1, 2, 2, 320, 128, 32, True, torch.bfloat16, False),
        ("cross-length causal 320x96 hd32", 1, 2, 2, 320, 96, 32, True, torch.bfloat16, False),
        ("hd16 causal 48", 1, 2, 1, 48, 48, 16, True, torch.bfloat16, False),
        ("hd48 noncausal 70x33", 1, 3, 1, 70, 33, 48, False, torch.bfloat16, False),
        ("fp16 causal 256 hd128", 1, 8, 8, 256, 256, 128, True, torch.float16, False),
    ] + EDGE_SHAPES
    rows = []
    max_err = 0.0
    for label, b, H, KV, ql, kl, hd, causal, dtype, timed in slice_shapes + other_shapes:
        q = rand(b, H, ql, hd, dtype=dtype)
        k = rand(b, KV, kl, hd, dtype=dtype)
        v = rand(b, KV, kl, hd, dtype=dtype)
        scale = hd**-0.5
        o, lse = att.flash_forward_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = att.flash_attention_plain(q.float(), k.float(), v.float(), causal, scale)
        err_o = (o.float() - o_ref).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
        ok = finite and err_o <= O_TOL and err_lse <= LSE_TOL
        row = {"shape": label, "o_err": err_o, "lse_err": err_lse, "o_tol": O_TOL,
               "lse_tol": LSE_TOL, "launches": att.flash_attention.launches}
        if timed:
            row["ms"] = time_ms(lambda: att.flash_forward_cuda(q, k, v, causal, scale))
            row["plain_ms"] = time_ms(lambda: att.flash_attention_plain(q, k, v, causal, scale), iters=5)
            row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale, enable_gqa=H != KV))
            row["bound_ms"], row["bound_by"] = attention_bound_ms(
                b, H, KV, ql, kl, hd, causal, q.element_size(), card)
        log(f"[kernel] flash_fwd {label}: " + json.dumps(row))
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain version at {label}: {row}")
        max_err = max(max_err, err_o)
        rows.append(row)
    # Future keys must not leak into earlier rows: exact equality.
    q, k, v = rand(2, 4, 128, 64), rand(2, 4, 128, 64), rand(2, 4, 128, 64)
    o1, _ = att.flash_forward_cuda(q, k, v, True, 0.125)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:] += 1.0
    v2[:, :, 100:] += 1.0
    o2, _ = att.flash_forward_cuda(q, k2, v2, True, 0.125)
    if not torch.equal(o1[:, :, :100], o2[:, :, :100]):
        raise AssertionError("flash_fwd: future keys changed earlier rows")
    log("[kernel] flash_fwd causal no-leak check: exact")
    # A CUDA input no kernel takes raises; it never falls back. (fp32 and
    # scale <= 0 take the general route; bf16/fp16 head dims off the 16 grid
    # the Hopper and wide ones, those off the 8 grid through a staged copy.)
    for bad in (lambda: att.flash_attention(*(rand(1, 2, 8, 264) for _ in range(3))),
                lambda: att.flash_forward_cuda(q, k, v, True, -0.125)):
        try:
            bad()
        except (TypeError, ValueError) as e:
            log(f"[kernel] rejected as expected: {e}")
        else:
            raise AssertionError("flash_attention accepted an input the kernel cannot take")
    head = next(r for r in rows if r["shape"] == "slice S=1024")
    train = next(r for r in rows if r["shape"] == TRAIN_SHAPE_LABEL)
    return {"rows": rows, "max_err": max_err, "head": head, "train": train}


def sdpa_backward_ms(q, k, v, do, causal, scale):
    """Library yardstick for the backward: SDPA's backward alone,
    ``torch.autograd.grad`` on one retained SDPA graph, timed as any
    kernel (a difference of two timings swings several-fold at small
    shapes, where the host's launches dominate)."""
    import torch.nn.functional as F

    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal, scale=scale,
                                       enable_gqa=q.shape[1] != k.shape[1])
    return time_ms(lambda: torch.autograd.grad(o, (qr, kr, vr), do, retain_graph=True))


@timed_phase
def bwd_kernel_phase(card: str) -> dict:
    """dQ and dK/dV kernels against ``flash_attention_bwd_plain`` (fp32 on
    the same bf16 inputs, o and lse from the forward kernel)."""
    from ray_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # (label, b, H, KV, q_len, k_len, hd, causal, dtype, timed)
    shapes = [
        (f"slice S={s}", 1, 18, 18, s, s, 128, True, torch.bfloat16, False)
        for s in (128, 512, 2048)
    ] + [
        (TRAIN_SHAPE_LABEL, 12, 18, 18, 2048, 2048, 128, True, torch.bfloat16, True),
        ("causal 128 hd64", 2, 4, 4, 128, 128, 64, True, torch.bfloat16, False),
        ("noncausal ragged 96x160 hd64", 2, 2, 2, 96, 160, 64, False, torch.bfloat16, False),
        ("gqa 8:2 causal hd64", 2, 8, 2, 128, 128, 64, True, torch.bfloat16, False),
        ("gqa 4:2 noncausal ragged 96x160 hd64", 1, 4, 2, 96, 160, 64, False, torch.bfloat16,
         False),
        ("bq>bk ragged causal 192 hd32", 1, 2, 2, 192, 192, 32, True, torch.bfloat16, False),
        ("cross-length causal 320x128 hd32", 1, 2, 2, 320, 128, 32, True, torch.bfloat16, False),
        ("cross-length causal 320x96 hd32", 1, 2, 2, 320, 96, 32, True, torch.bfloat16, False),
        ("cross-length causal 64x200 hd32", 1, 2, 2, 64, 200, 32, True, torch.bfloat16, False),
        ("hd16 gqa 2:1 causal 48", 1, 2, 1, 48, 48, 16, True, torch.bfloat16, False),
        ("hd48 noncausal 70x33", 1, 3, 1, 70, 33, 48, False, torch.bfloat16, False),
        ("fp16 causal 256 hd128", 1, 8, 8, 256, 256, 128, True, torch.float16, False),
        (GQA_SHAPE_LABEL, 2, 32, 8, 2048, 2048, 128, True, torch.bfloat16, True),
    ] + EDGE_SHAPES
    rows = []
    max_abs = {"dq": 0.0, "dkv": 0.0, "delta": 0.0}
    for label, b, H, KV, ql, kl, hd, causal, dtype, timed in shapes:
        q, do = rand(b, H, ql, hd, dtype=dtype), rand(b, H, ql, hd, dtype=dtype)
        k, v = rand(b, KV, kl, hd, dtype=dtype), rand(b, KV, kl, hd, dtype=dtype)
        scale = hd**-0.5
        o, lse = att.flash_forward_cuda(q, k, v, causal, scale)
        dq, dk, dv = att.flash_backward_cuda(q, k, v, o, lse, do, causal, scale)
        # dQ run again (twice at the timed shapes) for its delta: dQ sums in
        # a fixed order (no atomics), so every run is bitwise the same.
        dq_runs = [att.flash_bwd_dq_cuda(q, k, v, o, lse, do, causal, scale)
                   for _ in range(2 if timed else 1)]
        torch.cuda.synchronize()
        ref = att.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                            do.float(), causal, scale)
        delta = dq_runs[0][1]
        delta_ref = (do.float() * o.float()).sum(-1)
        delta_err = (delta - delta_ref).abs().max().item()
        delta_rel = delta_err / max(delta_ref.abs().max().item(), 1e-30)
        row = {"shape": label, "rel_tol": GRAD_REL_TOL, "delta_abs_err": delta_err,
               "delta_rel_err": delta_rel, "delta_rel_tol": DELTA_REL_TOL,
               "dq_bitwise_repeatable": all(torch.equal(r[0], dq) and torch.equal(r[1], delta)
                                            for r in dq_runs)}
        ok = row["dq_bitwise_repeatable"] and delta_rel <= DELTA_REL_TOL
        max_abs["delta"] = max(max_abs["delta"], delta_err)
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            err = (got.float() - want).abs().max().item()
            rel = err / max(want.abs().max().item(), 1e-30)
            row[f"{name}_abs_err"], row[f"{name}_rel_err"] = err, rel
            ok = ok and bool(torch.isfinite(got).all()) and got.shape == want.shape and (
                rel <= GRAD_REL_TOL)
            key = "dq" if name == "dq" else "dkv"
            max_abs[key] = max(max_abs[key], err)
        if timed:
            dkv_args = (q, k, v, do, lse, delta)
            # dK/dV sums in a fixed order (no atomics): bitwise repeatable.
            runs = [att.flash_bwd_dkv_cuda(*dkv_args, causal, scale) for _ in range(2)]
            row["dkv_bitwise_repeatable"] = all(
                torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
            ok = ok and row["dkv_bitwise_repeatable"] and all(
                torch.equal(a, b) for a, b in zip(runs[0], (dk, dv)))
            row["dq_ms"] = time_ms(lambda: att.flash_bwd_dq_cuda(q, k, v, o, lse, do, causal,
                                                                 scale))
            row["dkv_ms"] = time_ms(lambda: att.flash_bwd_dkv_cuda(*dkv_args, causal, scale))
            # What the dQ kernel's delta replaced: the torch expression.
            row["delta_torch_ms"] = time_ms(lambda: (do.float() * o.float()).sum(-1))
            row["plain_ms"] = time_ms(lambda: att.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal, scale), iters=3, warmup=1)
            row["library_ms"] = sdpa_backward_ms(q, k, v, do, causal, scale)
            for kind in ("dq", "dkv"):
                row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = attention_bound_ms(
                    b, H, KV, ql, kl, hd, causal, q.element_size(), card, kind)
        log(f"[kernel] flash_bwd {label}: " + json.dumps(row))
        if not ok:
            raise AssertionError(f"flash_bwd disagrees with its plain version at {label}: {row}")
        rows.append(row)
    # Keys that no query reaches (causal, k_len > q_len) get exactly zero.
    q, k, v, do = rand(1, 2, 64, 32), rand(1, 2, 200, 32), rand(1, 2, 200, 32), rand(1, 2, 64, 32)
    o, lse = att.flash_forward_cuda(q, k, v, True, 0.125)
    _, dk, dv = att.flash_backward_cuda(q, k, v, o, lse, do, True, 0.125)
    if not (torch.equal(dk[:, :, 64:], torch.zeros_like(dk[:, :, 64:]))
            and torch.equal(dv[:, :, 64:], torch.zeros_like(dv[:, :, 64:]))):
        raise AssertionError("flash_bwd: keys past every query got a gradient")
    log("[kernel] flash_bwd unreached keys: exactly zero")
    # A CUDA input no kernel takes raises, through the routed backward op;
    # it never falls back.
    q, k, v = rand(1, 2, 64, 32), rand(1, 2, 64, 32), rand(1, 2, 64, 32)
    o, lse = att.flash_forward_cuda(q, k, v, True, 0.125)
    bad_inputs = (
        ("non-contiguous do", lambda: att.flash_bwd(
            q, k, v, o, lse, torch.empty_like(o).transpose(2, 3).contiguous().transpose(2, 3),
            True, 0.125)),
        ("bf16 lse", lambda: att.flash_bwd(q, k, v, o, lse.bfloat16(), o, True, 0.125)),
        ("head_dim 264", lambda: att.flash_bwd(
            *(rand(1, 2, 8, 264) for _ in range(4)), torch.zeros(1, 2, 8, device=dev),
            rand(1, 2, 8, 264), True, 0.125)),
    )
    for what, bad in bad_inputs:
        try:
            bad()
        except (TypeError, ValueError) as e:
            log(f"[kernel] flash_bwd rejected {what} as expected: {e}")
        else:
            raise AssertionError(f"flash_bwd accepted {what}")
    train = next(r for r in rows if r["shape"] == TRAIN_SHAPE_LABEL)
    gqa = next(r for r in rows if r["shape"] == GQA_SHAPE_LABEL)
    return {"rows": rows, "max_abs": max_abs, "train": train, "gqa": gqa}


# The general kernels against their plain versions on the same inputs: both
# sides compute in fp32 and round the output once, so o differs by half an
# ulp of its type plus fp32 summation noise. fp32: 2e-4 absolute on o and
# lse; bf16/fp16: o within 1e-2 of max(1, |o|) (half a bf16 ulp is 2^-9 of
# |o|), lse (fp32) within 2e-4; gradients within 2% of the largest value.
GENERAL_O_TOL_FP32 = 2e-4
GENERAL_O_TOL_16 = 1e-2
GENERAL_LSE_TOL = 2e-4
# The fp32 route's dQ, dK and dV against the plain backward in fp32, relative
# to the largest value. Its products are fp32-accurate splits (each term's
# error below 2^-24 of the product) summed in the tensor cores' fp32
# accumulators, a few hundred adds a sum: an fp32 emulation of the split on
# the CPU reads <= 1e-6 (tests/test_torch_attention_fp32.py), the card
# 1e-5 to 2e-5 at head dim 128 and 2048 keys. One TF32 or bf16 rounding of
# the operands reads 3e-3 to 1e-2 there, so 1e-4 tells the two apart (the
# 16-bit routes' 2% would not).
FP32_DKV_REL_TOL = 1e-4
GENERAL_FP32_LABEL = "fp32 gqa [2, 8/2, 1024, 64] causal"
FP32_MODEL_LABEL = "fp32 model [4, 8/4, 512, 64] causal"
GENERAL_HEAD_LABEL = "bf16 [1, 16/16, 2048, 256] causal"
WIDE_TRAIN_LABEL = "wide train [12, 9, 2048, 256] causal"
# (label, b, H, KV, q_len, k_len, hd, causal, dtype, route). The general
# kernels run at every shape (the "earlier" times of the TMA kernels); each
# shape's route runs there too and is checked and timed beside them. The
# general route keeps fp32 and scale <= 0: its 16-bit rows run at -hd^-0.5,
# every other row at hd^-0.5. The wide route's headline is the head shape of
# Gemma-7B's public config; the wide-head flagship's training shape has 864
# forward blocks in several waves. Head dims off the 16 grid (on the TMA
# kernels since they take multiples of 8): SigLIP-so400m/14 at 384 px
# (1152 / 16 = 72, 729 patches, 32 images), DiT-XL/2 at 512 px (1152 / 16,
# 1024 tokens), Stable Diffusion 1.5's UNet level 1 at 512 px (320 / 8 = 40,
# 4096 positions), the hd-72 flagship's own shape, 136 (the gap between the
# routes, at D = 192) and 100 (staged to 104); the same DiT shape at head
# dims 64 and 128 beside 72 gives the padding's cost. At b*H = 65,600 the
# Hopper grid is one-dimensional.
GENERAL_SHAPES = [
    (GENERAL_FP32_LABEL, 2, 8, 2, 1024, 1024, 64, True, torch.float32, "hopper_fp32"),
    (FP32_MODEL_LABEL, 4, 8, 4, 512, 512, 64, True, torch.float32, "hopper_fp32"),
    ("fp32 [1, 16/16, 2048, 128] causal", 1, 16, 16, 2048, 2048, 128, True, torch.float32,
     "hopper_fp32"),
    ("fp16 [1, 4/2, 300, 72] x k_len 500 noncausal scale < 0", 1, 4, 2, 300, 500, 72, False,
     torch.float16, "general"),
    (GENERAL_HEAD_LABEL, 1, 16, 16, 2048, 2048, 256, True, torch.bfloat16, "hopper_wide"),
    ("bf16 gqa [2, 8/2, 1024, 256] causal", 2, 8, 2, 1024, 1024, 256, True, torch.bfloat16,
     "hopper_wide"),
    ("bf16 [1, 4/2, 300, 144] x k_len 500 noncausal", 1, 4, 2, 300, 500, 144, False,
     torch.bfloat16, "hopper_wide"),
    (WIDE_TRAIN_LABEL, 12, 9, 9, 2048, 2048, 256, True, torch.bfloat16, "hopper_wide"),
    ("fp16 [1, 4/2, 300, 72] x k_len 500 noncausal", 1, 4, 2, 300, 500, 72, False,
     torch.float16, "hopper"),
    ("siglip bf16 [32, 16/16, 729, 72] noncausal", 32, 16, 16, 729, 729, 72, False,
     torch.bfloat16, "hopper"),
    ("dit bf16 [8, 16/16, 1024, 72] noncausal", 8, 16, 16, 1024, 1024, 72, False,
     torch.bfloat16, "hopper"),
    ("sd15 bf16 [2, 8/8, 4096, 40] noncausal", 2, 8, 8, 4096, 4096, 40, False, torch.bfloat16,
     "hopper"),
    ("hd72 train [12, 32, 2048, 72] causal", 12, 32, 32, 2048, 2048, 72, True, torch.bfloat16,
     "hopper"),
    ("gap bf16 [1, 16/16, 2048, 136] causal", 1, 16, 16, 2048, 2048, 136, True, torch.bfloat16,
     "hopper_wide"),
    ("staged bf16 gqa [2, 8/2, 1024, 100] causal", 2, 8, 2, 1024, 1024, 100, True,
     torch.bfloat16, "hopper"),
    ("dit bf16 [8, 16/16, 1024, 64] noncausal", 8, 16, 16, 1024, 1024, 64, False,
     torch.bfloat16, "hopper"),
    ("dit bf16 [8, 16/16, 1024, 128] noncausal", 8, 16, 16, 1024, 1024, 128, False,
     torch.bfloat16, "hopper"),
    ("bf16 [4100, 16/16, 16, 64] causal (b*H 65600)", 4100, 16, 16, 16, 16, 64, True,
     torch.bfloat16, "hopper"),
]
# The edges of the wide kernels' tiles (the forward's 128-row q tiles of two
# 64-row consumers and 64-key tiles, the dQ kernel's pairs of 64-row q
# tiles and 64-key tiles, the dK/dV kernel's 64-key tiles and 64-query
# steps) and of their two widths (D = 192 holds head dims 136-192, D = 256
# 200-256): (label, b, H, KV, q_len, k_len, hd, causal, dtype).
WIDE_EDGE_SHAPES = [
    ("causal 130 hd256", 1, 2, 2, 130, 130, 256, True, torch.bfloat16),
    ("fp16 gqa 2:1 causal 257 hd192", 1, 2, 1, 257, 257, 192, True, torch.float16),
    ("cross-length causal 320x96 hd208", 1, 2, 2, 320, 96, 208, True, torch.bfloat16),
    # Keys past every query (causal, k_len > q_len) get exactly zero.
    ("cross-length causal 64x200 hd160", 1, 2, 2, 64, 200, 160, True, torch.bfloat16),
    ("noncausal 65x65 hd240", 1, 2, 2, 65, 65, 240, False, torch.bfloat16),
    # One row past a 64-row q tile (65) or three (193): a pair of the dQ
    # kernel's q tiles, with and without a single beside it; GQA, and
    # ragged cross lengths, at both widths.
    ("gqa 2:1 causal 65 hd256", 1, 4, 2, 65, 65, 256, True, torch.bfloat16),
    ("gqa 2:1 causal 193 hd192", 1, 4, 2, 193, 193, 192, True, torch.bfloat16),
    ("gqa 4:1 noncausal ragged 193x77 hd256", 1, 4, 1, 193, 77, 256, False, torch.bfloat16),
    ("fp16 cross-length causal 65x190 hd176", 1, 2, 2, 65, 190, 176, True, torch.float16),
]
# Head dims off the 16 grid at the edges of both TMA routes' tiles: a
# second 64-column box mostly past hd (72, 136, 248), one 64-column box
# (40), and head dims off the 8 grid through stage_head_dim (100, 129, 7):
# (label, b, H, KV, q_len, k_len, hd, causal, dtype, route).
OFF_GRID_EDGE_SHAPES = [
    ("causal 129 hd72", 1, 2, 2, 129, 129, 72, True, torch.bfloat16, "hopper"),
    ("gqa 4:1 noncausal ragged 193x77 hd40", 1, 4, 1, 193, 77, 40, False, torch.bfloat16,
     "hopper"),
    ("cross-length causal 320x96 hd136", 1, 2, 2, 320, 96, 136, True, torch.bfloat16,
     "hopper_wide"),
    ("causal 65 hd248", 1, 2, 2, 65, 65, 248, True, torch.bfloat16, "hopper_wide"),
    ("staged gqa 2:1 causal 257 hd100", 1, 4, 2, 257, 257, 100, True, torch.bfloat16, "hopper"),
    ("staged fp16 cross-length causal 65x190 hd129", 1, 2, 2, 65, 190, 129, True,
     torch.float16, "hopper_wide"),
    ("staged noncausal 70x33 hd7", 1, 2, 1, 70, 33, 7, False, torch.bfloat16, "hopper"),
]
# The edges of the fp32 route's tiles (the forward's 128-row q tiles and
# 64-key tiles, 32 at D = 128; the dK/dV kernel's 128-key blocks of
# 64-query steps, 64 keys of 32-query steps at D = 128) and widths (D = 32
# holds head dims 4-32): (label, b, H, KV, q_len, k_len, hd, causal).
FP32_EDGE_SHAPES = [
    ("fp32 gqa 4:1 noncausal ragged 193x77 hd128", 1, 4, 1, 193, 77, 128, False),
    ("fp32 causal 65 hd4", 1, 2, 2, 65, 65, 4, True),
    # Keys past every query (causal, k_len > q_len) get exactly zero.
    ("fp32 cross-length causal 64x200 hd64", 1, 2, 2, 64, 200, 64, True),
    ("fp32 gqa 2:1 causal 257 hd100", 1, 4, 2, 257, 257, 100, True),
]
# The plain versions are timed where one fp32 score tensor takes at most this
# many bytes (the backward holds several); their reference values are
# computed a few batch rows at a time.
PLAIN_TIMED_SCORE_BYTES = 2e9
PLAIN_CHUNK_SCORE_BYTES = 2**30


def library_ms(fn):
    """A library call's time, or None where the library refuses the input."""
    try:
        return fn()
    except RuntimeError as e:
        log(f"[kernel] library yardstick refused: {str(e).splitlines()[0][:160]}")
        return None


def _fwd_errors(o, lse, o_ref, lse_ref):
    """(o error as the tolerance reads it, o max abs error, lse max abs error)."""
    diff = (o.float() - o_ref).abs()
    o_err = diff if o.dtype == torch.float32 else diff / o_ref.abs().clamp_min(1.0)
    return o_err.max().item(), diff.max().item(), (lse - lse_ref).abs().max().item()


def _plain_by_batch(fn, *ts, causal, scale):
    """``fn`` (a plain version) in fp32 on the fp32 upcast of ``ts``, a few
    batch rows at a time (the function is row-independent); outputs
    concatenated along the batch."""
    b, H, ql = ts[0].shape[:3]
    rows = max(1, int(PLAIN_CHUNK_SCORE_BYTES // (H * ql * ts[1].shape[2] * 4)))
    parts = [fn(*(t[i:i + rows].float() if t.dtype != torch.float32 else t[i:i + rows]
                  for t in ts), causal, scale) for i in range(0, b, rows)]
    return tuple(torch.cat(p) for p in zip(*parts))


@timed_phase
def general_kernel_phase(card: str) -> dict:
    """The general forward, dQ and dK/dV kernels against
    ``flash_attention_plain`` / ``flash_attention_bwd_plain`` at
    ``GENERAL_SHAPES``, with times, bounds (fp32 FMA peak for fp32 inputs,
    tensor-core peak for bf16/fp16), plain and SDPA times (SDPA with TF32
    off); the route each
    shape takes, whose TMA kernels (``_tma_check``) or fp32 kernels
    (``_fp32_check``, bound at the split's rate beside the FMA bound) are
    checked and timed there too; then the TMA kernels at
    ``WIDE_EDGE_SHAPES`` and ``OFF_GRID_EDGE_SHAPES`` and the fp32 kernels
    at ``FP32_EDGE_SHAPES``."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    rows = []
    max_abs = {f"{route}_{key}": 0.0 for route in ("general", "hopper", "hopper_wide")
               for key in ("fwd", "dq", "dkv", "delta")}
    max_abs.update(hopper_fp32_fwd=0.0, hopper_fp32_dq=0.0, hopper_fp32_dkv=0.0,
                   hopper_fp32_delta=0.0)
    fp32_s = 0.0  # the seconds of the fp32 route's rows, general kernels beside them included
    for label, b, H, KV, ql, kl, hd, causal, dtype, route in GENERAL_SHAPES:
        t_row = time.perf_counter()
        q, do = rand(b, H, ql, hd, dtype=dtype), rand(b, H, ql, hd, dtype=dtype)
        k, v = rand(b, KV, kl, hd, dtype=dtype), rand(b, KV, kl, hd, dtype=dtype)
        scale = -hd**-0.5 if route == "general" and dtype != torch.float32 else hd**-0.5
        got_route = att._kernel_route(q, k, scale)
        o, lse = att.flash_general_forward_cuda(q, k, v, causal, scale)
        grads = att.flash_general_backward_cuda(q, k, v, o, lse, do, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = _plain_by_batch(att.flash_attention_plain, q, k, v, causal=causal,
                                         scale=scale)
        ref = _plain_by_batch(att.flash_attention_bwd_plain, q, k, v, o, lse, do, causal=causal,
                              scale=scale)
        o_tol = GENERAL_O_TOL_FP32 if dtype == torch.float32 else GENERAL_O_TOL_16
        o_err, o_abs, lse_err = _fwd_errors(o, lse, o_ref, lse_ref)
        row = {"shape": label, "dtype": str(dtype).split(".")[-1], "scale": scale,
               "route": got_route, "o_err": o_err, "o_abs_err": o_abs, "o_tol": o_tol,
               "lse_err": lse_err, "lse_tol": GENERAL_LSE_TOL, "grad_rel_tol": GRAD_REL_TOL}
        ok = (got_route == route and bool(torch.isfinite(o).all())
              and bool(torch.isfinite(lse).all()) and o_err <= o_tol
              and lse_err <= GENERAL_LSE_TOL)
        max_abs["general_fwd"] = max(max_abs["general_fwd"], o_abs)
        for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
            err = (got.float() - want).abs().max().item()
            row[f"{name}_abs_err"] = err
            row[f"{name}_rel_err"] = err / max(want.abs().max().item(), 1e-30)
            ok = ok and bool(torch.isfinite(got).all()) and got.shape == want.shape and (
                row[f"{name}_rel_err"] <= GRAD_REL_TOL)
            key = "general_dq" if name == "dq" else "general_dkv"
            max_abs[key] = max(max_abs[key], err)
        delta = att.flash_general_dq_cuda(q, k, v, o, lse, do, causal, scale)[1]
        row["fwd_ms"] = time_ms(lambda: att.flash_general_forward_cuda(q, k, v, causal, scale))
        row["dq_ms"] = time_ms(lambda: att.flash_general_dq_cuda(q, k, v, o, lse, do, causal,
                                                                 scale))
        row["dkv_ms"] = time_ms(lambda: att.flash_general_dkv_cuda(q, k, v, do, lse, delta,
                                                                   causal, scale))
        row["plain_fwd_ms"] = row["plain_bwd_ms"] = None
        if b * H * ql * kl * 4 <= PLAIN_TIMED_SCORE_BYTES:
            row["plain_fwd_ms"] = time_ms(lambda: att.flash_attention_plain(q, k, v, causal,
                                                                            scale),
                                          iters=3, warmup=1)
            row["plain_bwd_ms"] = time_ms(lambda: att.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal, scale), iters=3, warmup=1)
        row["library_fwd_ms"] = library_ms(lambda: time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale, enable_gqa=H != KV)))
        row["library_bwd_ms"] = library_ms(lambda: sdpa_backward_ms(q, k, v, do, causal, scale))
        for kind in ("fwd", "dq", "dkv"):
            row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = attention_bound_ms(
                b, H, KV, ql, kl, hd, causal, q.element_size(), card, kind)
        del o, lse, grads, ref, delta
        if route in ("hopper", "hopper_wide"):
            row["tma"] = _tma_check(route, q, k, v, do, causal, scale, o_ref, lse_ref, timed=True)
            for kind in ("fwd", "dq", "dkv"):
                row["tma"][f"{kind}_bound_ms"] = row[f"{kind}_bound_ms"]
            log(f"[kernel] flash_{'wide' if route == 'hopper_wide' else 'hopper'} {label}: "
                + json.dumps(row["tma"]))
            ok = ok and row["tma"]["ok"]
            for key in ("fwd", "dq", "dkv", "delta"):
                max_abs[f"{route}_{key}"] = max(max_abs[f"{route}_{key}"],
                                                row["tma"][f"{key}_abs_err"])
        elif route == "hopper_fp32":
            row["fp32"] = _fp32_check(q, k, v, do, causal, scale, o_ref, lse_ref, timed=True)
            for kind in ("fwd", "dq", "dkv"):
                row["fp32"][f"{kind}_bound_ms"], row["fp32"][f"{kind}_bound_by"] = (
                    attention_bound_ms(b, H, KV, ql, kl, hd, causal, 4, card, kind, split=True))
                row["fp32"][f"{kind}_fma_bound_ms"] = row[f"{kind}_bound_ms"]
            log(f"[kernel] flash_fp32 {label}: " + json.dumps(row["fp32"]))
            ok = ok and row["fp32"]["ok"]
            for key in ("fwd", "dq", "dkv", "delta"):
                max_abs[f"hopper_fp32_{key}"] = max(max_abs[f"hopper_fp32_{key}"],
                                                    row["fp32"][f"{key}_abs_err"])
        log(f"[kernel] flash_general {label} on {card}: " + json.dumps(row))
        if not ok:
            raise AssertionError(f"flash_general or the {route} kernels disagree with their "
                                 f"plain versions at {label}: {row}")
        rows.append(row)
        del q, k, v, do, o_ref, lse_ref
        torch.cuda.empty_cache()
        if route == "hopper_fp32":
            fp32_s += time.perf_counter() - t_row
    edges = [(*shape, "hopper_wide") for shape in WIDE_EDGE_SHAPES] + OFF_GRID_EDGE_SHAPES
    for label, b, H, KV, ql, kl, hd, causal, dtype, route in edges:
        q, do = rand(b, H, ql, hd, dtype=dtype), rand(b, H, ql, hd, dtype=dtype)
        k, v = rand(b, KV, kl, hd, dtype=dtype), rand(b, KV, kl, hd, dtype=dtype)
        scale = hd**-0.5
        o_ref, lse_ref = att.flash_attention_plain(q.float(), k.float(), v.float(), causal, scale)
        row = {"shape": label, "route": att._kernel_route(q, k, scale),
               **_tma_check(route, q, k, v, do, causal, scale, o_ref, lse_ref, timed=False)}
        log(f"[kernel] {route} edge {label}: " + json.dumps(row))
        if not (row["ok"] and row["route"] == route):
            raise AssertionError(f"{route} kernels disagree with their plain versions at {label}: "
                                 f"{row}")
        for key in ("fwd", "dq", "dkv", "delta"):
            max_abs[f"{route}_{key}"] = max(max_abs[f"{route}_{key}"], row[f"{key}_abs_err"])
    t_edges = time.perf_counter()
    fp32_edges = []
    for label, b, H, KV, ql, kl, hd, causal in FP32_EDGE_SHAPES:
        q, do = rand(b, H, ql, hd, dtype=torch.float32), rand(b, H, ql, hd, dtype=torch.float32)
        k, v = rand(b, KV, kl, hd, dtype=torch.float32), rand(b, KV, kl, hd, dtype=torch.float32)
        scale = hd**-0.5
        o_ref, lse_ref = att.flash_attention_plain(q, k, v, causal, scale)
        row = {"shape": label, "route": att._kernel_route(q, k, scale),
               **_fp32_check(q, k, v, do, causal, scale, o_ref, lse_ref, timed=False)}
        row["dq_bound_ms"], row["dq_bound_by"] = attention_bound_ms(
            b, H, KV, ql, kl, hd, causal, 4, card, "dq", split=True)
        row["dq_fma_bound_ms"] = attention_bound_ms(b, H, KV, ql, kl, hd, causal, 4, card,
                                                    "dq")[0]
        row["library_bwd_ms"] = library_ms(lambda: sdpa_backward_ms(q, k, v, do, causal,
                                                                    scale))
        log(f"[kernel] hopper_fp32 edge {label}: " + json.dumps(row))
        if not (row["ok"] and row["route"] == "hopper_fp32"):
            raise AssertionError(f"fp32 kernels disagree with their plain versions at {label}: "
                                 f"{row}")
        for key in ("fwd", "dq", "dkv", "delta"):
            max_abs[f"hopper_fp32_{key}"] = max(max_abs[f"hopper_fp32_{key}"],
                                                row[f"{key}_abs_err"])
        fp32_edges.append({key: row[key] for key in ("shape", "dq_ms", "dq_bound_ms",
                                                     "dq_fma_bound_ms", "library_bwd_ms")})
    log(f"[time] general_kernel_phase's hopper_fp32 rows: {fp32_s:.1f} s, its fp32 edges: "
        f"{time.perf_counter() - t_edges:.1f} s")
    # Keys past every query get exactly zero; inputs the wide kernels do
    # not take raise (head dims up to 128 are the Hopper kernels', those
    # off the 8 grid are staged by the ops first).
    q, k, v, do = (rand(1, 2, n, 160, dtype=torch.bfloat16) for n in (64, 200, 200, 64))
    o, lse = att.flash_forward_wide_cuda(q, k, v, True, 0.08)
    _, dk, dv = att.flash_backward_wide_cuda(q, k, v, o, lse, do, True, 0.08)
    if dk[:, :, 64:].count_nonzero() or dv[:, :, 64:].count_nonzero():
        raise AssertionError("wide dK/dV: keys past every query got a gradient")
    x128, x204, x100 = (rand(1, 2, 8, hd, dtype=torch.bfloat16) for hd in (128, 204, 100))
    for what, bad in (("head_dim 128", lambda: att.flash_forward_wide_cuda(x128, x128, x128,
                                                                           True, 0.08)),
                      ("head_dim 204", lambda: att.flash_forward_wide_cuda(x204, x204, x204,
                                                                           True, 0.08)),
                      ("head_dim 100", lambda: att.flash_forward_cuda(x100, x100, x100,
                                                                      True, 0.1)),
                      ("scale <= 0", lambda: att.flash_forward_wide_cuda(q, k, v, True, -0.08))):
        try:
            bad()
        except ValueError as e:
            log(f"[kernel] TMA kernel rejected {what} as expected: {e}")
        else:
            raise AssertionError(f"a TMA kernel's wrapper accepted {what}")
    x4, x6, x132 = (rand(1, 2, 8, hd, dtype=torch.float32) for hd in (4, 6, 132))
    for what, bad in (("fp32 head_dim 6", lambda: att.flash_forward_fp32_cuda(x6, x6, x6, True,
                                                                               0.4)),
                      ("fp32 head_dim 132", lambda: att.flash_forward_fp32_cuda(
                          x132, x132, x132, True, 0.087)),
                      ("fp32 scale <= 0", lambda: att.flash_forward_fp32_cuda(x4, x4, x4, True,
                                                                              -0.5))):
        try:
            bad()
        except ValueError as e:
            log(f"[kernel] fp32 kernel rejected {what} as expected: {e}")
        else:
            raise AssertionError(f"the fp32 forward's wrapper accepted {what}")
    head = next(r for r in rows if r["shape"] == GENERAL_HEAD_LABEL)
    general_head = next(r for r in rows if r["shape"] == GENERAL_FP32_LABEL)
    return {"rows": rows, "max_abs": max_abs, "head": head, "general_head": general_head,
            "fp32_edges": fp32_edges}


def _fp32_check(q, k, v, do, causal, scale, o_ref, lse_ref, timed: bool) -> dict:
    """The fp32 route's forward, dQ and dK/dV kernels against the plain
    versions on the same fp32 inputs (TF32 off): o and lse within 2e-4, dQ,
    dK and dV within ``FP32_DKV_REL_TOL`` of the largest value, the dQ
    kernel's delta within ``DELTA_REL_TOL`` of rowsum(dO * O) in torch (the
    dK/dV kernel reads that delta, as the route runs it); dQ and dK/dV each
    run twice must agree bitwise (no atomics); keys past every query get
    exactly zero. The dQ kernel is timed at every shape (the edges too);
    ``timed`` adds the forward's and dK/dV's times."""
    from ray_tpu_torch.ops import attention as att

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 references must run in fp32 (TF32 is on)")
    o, lse = att.flash_forward_fp32_cuda(q, k, v, causal, scale)
    dq_runs = [att.flash_bwd_dq_fp32_cuda(q, k, v, o, lse, do, causal, scale)
               for _ in range(2)]
    dq, delta = dq_runs[0]
    runs = [att.flash_bwd_dkv_fp32_cuda(q, k, v, do, lse, delta, causal, scale)
            for _ in range(2)]
    torch.cuda.synchronize()
    dq_ref, dk_ref, dv_ref = _plain_by_batch(att.flash_attention_bwd_plain, q, k, v, o, lse,
                                             do, causal=causal, scale=scale)
    delta_ref = (do * o).sum(-1)
    _, o_abs, lse_err = _fwd_errors(o, lse, o_ref, lse_ref)
    row = {"route": "hopper_fp32", "head_dim": q.shape[-1], "fwd_abs_err": o_abs,
           "o_tol": GENERAL_O_TOL_FP32, "lse_err": lse_err, "lse_tol": GENERAL_LSE_TOL,
           "dkv_rel_tol": FP32_DKV_REL_TOL,
           "delta_abs_err": (delta - delta_ref).abs().max().item(),
           "delta_rel_tol": DELTA_REL_TOL,
           "dkv_plan": att.fp32_dkv_plan(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                                         q.shape[-1], bool(causal),
                                         torch.cuda.get_device_properties(q.device)
                                         .multi_processor_count),
           "dq_bitwise_repeatable": all(torch.equal(a, b) for a, b in zip(*dq_runs)),
           "dkv_bitwise_repeatable": all(torch.equal(a, b) for a, b in zip(*runs))}
    row["delta_rel_err"] = row["delta_abs_err"] / max(delta_ref.abs().max().item(), 1e-30)
    ok = (bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
          and o_abs <= GENERAL_O_TOL_FP32 and lse_err <= GENERAL_LSE_TOL
          and row["dq_bitwise_repeatable"] and row["dkv_bitwise_repeatable"]
          and row["delta_rel_err"] <= DELTA_REL_TOL)
    dkv_abs = 0.0
    for name, got, want in zip(("dq", "dk", "dv"), (dq, *runs[0]), (dq_ref, dk_ref, dv_ref)):
        err = (got - want).abs().max().item()
        row[f"{name}_abs_err"] = err
        row[f"{name}_rel_err"] = err / max(want.abs().max().item(), 1e-30)
        ok = ok and bool(torch.isfinite(got).all()) and got.shape == want.shape and (
            row[f"{name}_rel_err"] <= FP32_DKV_REL_TOL)
        if name != "dq":
            dkv_abs = max(dkv_abs, err)
    row["dkv_abs_err"] = dkv_abs
    if causal and k.shape[2] > q.shape[2]:
        row["zero_past_queries"] = not any(t[:, :, q.shape[2]:].count_nonzero().item()
                                           for t in runs[0])
        ok = ok and row["zero_past_queries"]
    row["dq_ms"] = time_ms(lambda: att.flash_bwd_dq_fp32_cuda(q, k, v, o, lse, do, causal,
                                                              scale))
    if timed:
        row["fwd_ms"] = time_ms(lambda: att.flash_forward_fp32_cuda(q, k, v, causal, scale))
        row["dkv_ms"] = time_ms(lambda: att.flash_bwd_dkv_fp32_cuda(q, k, v, do, lse, delta,
                                                                    causal, scale))
    row["ok"] = ok
    return row


# Each TMA route's forward, dQ and dK/dV launch wrappers.
_TMA_WRAPPERS = {
    "hopper": ("flash_forward_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda"),
    "hopper_wide": ("flash_forward_wide_cuda", "flash_bwd_dq_wide_cuda",
                    "flash_bwd_dkv_wide_cuda"),
}


def _tma_check(route, q, k, v, do, causal, scale, o_ref, lse_ref, timed: bool) -> dict:
    """The ``route``'s forward and backward kernels (its dQ, then its
    dK/dV) against the plain versions on the same inputs (``O_TOL``
    absolute, ``LSE_TOL``, dQ/dK/dV within ``GRAD_REL_TOL`` of the largest
    value, the dQ kernel's delta within ``DELTA_REL_TOL`` of rowsum(dO * O)
    in torch); dQ and dK/dV each run twice must agree bitwise (no atomics).
    A head dim off the 8 grid runs the kernels on q, k, v, o and do
    zero-padded to the next multiple of 8 and holds what comes back sliced;
    the ops (``_flash_fwd_cuda``, ``_flash_bwd_cuda``) must then give those
    outputs bit for bit, each counting one ``stage_head_dim`` use.
    ``timed`` adds the kernels' times (at the padded width) and the staged
    ops' (the copies included)."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as att

    fwd, dq_fn, dkv_fn = (getattr(att, name) for name in _TMA_WRAPPERS[route])
    hd = q.shape[-1]
    width = att.tma_head_dim(hd)
    staged = width != hd

    def pad(t):
        return F.pad(t, (0, width - hd)) if staged else t

    qp, kp, vp, dop = (pad(t) for t in (q, k, v, do))
    o_p, lse = fwd(qp, kp, vp, causal, scale)
    dq_runs = [dq_fn(qp, kp, vp, o_p, lse, dop, causal, scale) for _ in range(2)]
    delta = dq_runs[0][1]
    runs = [dkv_fn(qp, kp, vp, dop, lse, delta, causal, scale) for _ in range(2)]
    torch.cuda.synchronize()
    o, dq, dk, dv = (t[..., :hd].contiguous() for t in (o_p, dq_runs[0][0], *runs[0]))
    ref = _plain_by_batch(att.flash_attention_bwd_plain, q, k, v, o, lse, do, causal=causal,
                          scale=scale)
    delta_ref = (do.float() * o.float()).sum(-1)
    _, o_abs, lse_err = _fwd_errors(o, lse, o_ref, lse_ref)
    row = {"route": route, "head_dim": hd, "kernel_head_dim": width,
           "fwd_abs_err": o_abs, "o_tol": O_TOL, "lse_err": lse_err, "lse_tol": LSE_TOL,
           "grad_rel_tol": GRAD_REL_TOL,
           "delta_abs_err": (delta - delta_ref).abs().max().item(),
           "delta_rel_tol": DELTA_REL_TOL,
           "dq_bitwise_repeatable": all(torch.equal(a, b) for a, b in zip(*dq_runs)),
           "dkv_bitwise_repeatable": all(torch.equal(a, b) for a, b in zip(*runs))}
    row["delta_rel_err"] = row["delta_abs_err"] / max(delta_ref.abs().max().item(), 1e-30)
    ok = (bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all()) and o_abs <= O_TOL
          and lse_err <= LSE_TOL and row["dq_bitwise_repeatable"]
          and row["dkv_bitwise_repeatable"] and row["delta_rel_err"] <= DELTA_REL_TOL)
    dkv_abs = 0.0
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        err = (got.float() - want).abs().max().item()
        row[f"{name}_abs_err"] = err
        row[f"{name}_rel_err"] = err / max(want.abs().max().item(), 1e-30)
        ok = ok and bool(torch.isfinite(got).all()) and got.shape == want.shape and (
            row[f"{name}_rel_err"] <= GRAD_REL_TOL)
        if name != "dq":
            dkv_abs = max(dkv_abs, err)
    row["dkv_abs_err"] = dkv_abs
    del ref
    if staged:
        uses = att.stage_head_dim.uses
        so, slse = att._flash_fwd_cuda(q, k, v, causal, scale)
        sgrads = att._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)
        torch.cuda.synchronize()
        row["staged_uses"] = att.stage_head_dim.uses - uses
        row["staged_ops_bit_equal"] = (torch.equal(so, o) and torch.equal(slse, lse) and all(
            torch.equal(a, b) for a, b in zip(sgrads, (dq, dk, dv))))
        ok = ok and row["staged_uses"] == 2 and row["staged_ops_bit_equal"]
        del so, slse, sgrads
    if timed:
        row["fwd_ms"] = time_ms(lambda: fwd(qp, kp, vp, causal, scale))
        row["dq_ms"] = time_ms(lambda: dq_fn(qp, kp, vp, o_p, lse, dop, causal, scale))
        row["dkv_ms"] = time_ms(lambda: dkv_fn(qp, kp, vp, dop, lse, delta, causal, scale))
        if staged:
            row["staged_fwd_ms"] = time_ms(lambda: att._flash_fwd_cuda(q, k, v, causal, scale))
            row["staged_bwd_ms"] = time_ms(lambda: att._flash_bwd_cuda(q, k, v, o, lse, do,
                                                                       causal, scale))
    row["ok"] = ok
    return row


def profile_pass(eng, prompts, n_new, label: str, card: str) -> dict:
    """One ``generate_batch`` profiled (see ``profile_step``)."""
    return profile_step(lambda: eng.generate_batch(prompts, n_new), label, card)


def train_config(remat_policy: str = "full", n_heads: int = 18):
    """The 750M flagship config of ``bench.py:67-77``: full width, full depth;
    ``n_heads`` q and kv heads (18 of 128 there; 9 of 256 take the wide
    route; 32 of 72, off the 16 grid, the Hopper route)."""
    from ray_tpu_torch.models import transformer as tf

    return tf.TransformerConfig(vocab_size=32000, d_model=2304, n_layers=10, n_heads=n_heads,
                                n_kv_heads=n_heads, d_ff=5760, max_seq_len=2048,
                                dtype=torch.bfloat16, remat=True, remat_policy=remat_policy)


def _counted():
    """Every kernel wrapper's launch counter, by the key the phases use."""
    from ray_tpu_torch.ops import attention as att

    return {"fwd": att.flash_attention, "dq": att.flash_bwd_dq_cuda,
            "dkv": att.flash_bwd_dkv_cuda, "general_fwd": att.flash_general_forward_cuda,
            "general_dq": att.flash_general_dq_cuda, "general_dkv": att.flash_general_dkv_cuda,
            "wide_fwd": att.flash_forward_wide_cuda, "wide_dq": att.flash_bwd_dq_wide_cuda,
            "wide_dkv": att.flash_bwd_dkv_wide_cuda, "fp32_fwd": att.flash_forward_fp32_cuda,
            "fp32_dq": att.flash_bwd_dq_fp32_cuda, "fp32_dkv": att.flash_bwd_dkv_fp32_cuda}


def launch_counts():
    """Every kernel's launches, and (``staged``) the ops' calls through
    ``stage_head_dim``'s zero-padded copy."""
    from ray_tpu_torch.ops import attention as att

    return {**{key: fn.launches for key, fn in _counted().items()},
            "staged": att.stage_head_dim.uses}


def reset_launch_counts():
    from ray_tpu_torch.ops import attention as att

    for fn in _counted().values():
        fn.launches = 0
    att.stage_head_dim.uses = 0


def no_general(per_step: dict) -> dict:
    """``per_step`` Hopper launches and no general, wide or fp32 ones, and
    no staged copy."""
    return {**per_step, "general_fwd": 0, "general_dq": 0, "general_dkv": 0, "wide_fwd": 0,
            "wide_dq": 0, "wide_dkv": 0, "fp32_fwd": 0, "fp32_dq": 0, "fp32_dkv": 0,
            "staged": 0}


def train_launches_per_step(cfg, policy: str) -> dict:
    """The kernels one train step launches: each layer's forward twice
    under "full" and "dots" (forward and recompute), once under "attn",
    one dQ and one dK/dV; on the Hopper route up to head dim 128 (18 heads
    of 128, 32 of 72), else on the wide route (9 of 256); no staged copy
    (every head dim here is a multiple of 8)."""
    L = cfg.n_layers
    fwd = (1 if policy == "attn" else 2) * L
    if cfg.head_dim <= 128:
        return no_general({"fwd": fwd, "dq": L, "dkv": L})
    return {**no_general({"fwd": 0, "dq": 0, "dkv": 0}), "wide_fwd": fwd, "wide_dq": L,
            "wide_dkv": L}


def profile_step(fn, label: str, card: str) -> dict:
    """``fn`` timed on the host clock with the profiler off, then again
    under torch.profiler for the device-busy time (sum of kernel self
    device time; one stream) and the top kernels. The idle share is
    1 - busy / unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device events only; user annotations (Optimizer.step, ...) span
    # kernels already counted and would count their time twice.
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    out = {
        "pass": label, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                         "share": e.self_device_time_total / max(busy_us, 1e-9),
                         "count": e.count} for e in top],
        # The port's own kernels (Hopper, wide and general), wherever they rank.
        "flash_kernels": {name: {
            "ms": e.self_device_time_total / 1e3, "count": e.count,
            "share": e.self_device_time_total / max(busy_us, 1e-9)}
            for e in events
            if (name := e.key.split("<")[0].split("::")[-1]).startswith(("flash_", "general_"))},
    }
    log(f"[profile] {label} on {card}: " + json.dumps(out))
    return out


# Each selective policy's losses against "full"'s, step by step, relative:
# the policies compute the same numbers (a saved product is the one the
# recompute would give), so only a change in summation order could move them.
POLICY_LOSS_REL_TOL = 1e-3


@timed_phase
def training_phase(card: str, smi: str, policy: str = "full", profile: bool = False,
                   n_heads: int = 18, warmup: int = 2, steps: int = 8) -> dict:
    """``make_train_step`` on the 750M config with ``n_heads`` heads under
    remat ``policy``, batch 12 x 2048, ``warmup`` warm-up and ``steps``
    timed steps, with the exact launch counts of every step
    (``train_launches_per_step``: at 18 heads 20/10/10 Hopper launches
    under "full" and "dots", 10/10/10 under "attn", no general launch)."""
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.parallel import make_optimizer, make_train_state, make_train_step
    from ray_tpu_torch.parallel.train_step import param_leaves

    dev = torch.device("cuda")
    cfg = train_config(policy, n_heads)
    batch_size, seq = 12, 2048
    torch.cuda.empty_cache()
    opt = make_optimizer(lr=3e-4, warmup=10)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                         device=dev, optimizer=opt)
    n_params = sum(p.numel() for p in param_leaves(params))
    if n_params != tf.num_params(cfg):
        raise AssertionError(f"params {n_params} != num_params {tf.num_params(cfg)}")
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq + 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": tokens}
    step = make_train_step(cfg, opt)
    per_step = train_launches_per_step(cfg, policy)
    losses, gnorms, step_s = [], [], []
    reset_launch_counts()
    for i in range(warmup + steps):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # both wait for the step
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(gnorm)
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        if got != per_step:
            raise AssertionError(f"step {i}: launches {got} != {per_step}")
        log(f"[train] {policy} {cfg.n_heads}x{cfg.head_dim} step {i}: loss {loss:.6f} "
            f"grad_norm {gnorm:.6f} {step_s[-1] * 1e3:.1f} ms launches {got}")
    launches = launch_counts()
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    timed = step_s[warmup:]
    mean_s = sum(timed) / len(timed)
    flops_peak, _ = peaks(card)
    tokens_per_step = batch_size * seq
    result = {
        "config": "750M flagship (bench.py): vocab 32000, d_model 2304, 10 layers, "
                  f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv heads of {cfg.head_dim}, d_ff 5760, "
                  f"bf16 compute, fp32 params + AdamW, remat {policy}",
        "remat_policy": policy,
        "params": n_params, "batch": batch_size, "seq": seq, "steps_timed": steps,
        "step_ms_mean": mean_s * 1e3, "step_ms_min": min(timed) * 1e3,
        "step_ms_max": max(timed) * 1e3,
        "tokens_per_s": tokens_per_step / mean_s,
        "mfu": tf.flops_per_token(cfg, seq) * tokens_per_step / mean_s / flops_peak,
        "flops_per_token": tf.flops_per_token(cfg, seq),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "grad_norms": gnorms, "launches": launches,
        "launches_per_step": per_step, "card": smi,
    }
    log(f"[train] {policy} {cfg.n_heads}x{cfg.head_dim} on {card}: " + json.dumps(result))
    if profile:
        result["profile"] = profile_step(lambda: step(params, opt_state, batch),
                                         f"train step ({policy})", card)
    del params, opt_state, batch, step
    torch.cuda.empty_cache()
    return result


@timed_phase
def grad_check_phase(card: str, n_heads: int = 18) -> dict:
    """Loss and every gradient of the 750M model (``n_heads`` heads) on one
    1 x 2048 batch, through the kernels and through plain attention under
    autograd; the kernels' run launches one dQ a layer and nothing off its
    route (``train_launches_per_step``)."""
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.parallel.train_step import global_norm, param_leaves

    dev = torch.device("cuda")
    cfg = train_config(n_heads=n_heads)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(2), device=dev)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2049), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))

    def plain_attn(q, k, v):
        return att.flash_attention_plain(q, k, v, True, q.shape[-1] ** -0.5)[0]

    plain_attn.supports_gqa = True

    def loss_and_grads(attn_fn):
        loss = tf.loss_fn(params, {"tokens": tokens}, cfg, attn_fn)
        grads = torch.autograd.grad(loss, leaves)
        return loss.item(), grads

    reset_launch_counts()
    lk, gk = loss_and_grads(None)
    counts = launch_counts()
    lp, gp = loss_and_grads(plain_attn)
    route = train_launches_per_step(cfg, "full")
    dq_key = "dq" if route["dq"] else "wide_dq"
    if launch_counts() != counts or counts[dq_key] != cfg.n_layers or any(
            counts[key] for key, n in route.items() if n == 0):
        raise AssertionError(f"kernel launches {counts}, then {launch_counts()} under plain")

    nk, np_ = global_norm(gk).item(), global_norm(gp).item()
    cos = [torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
           for a, b in zip(gk, gp)]
    finite = all(bool(torch.isfinite(g).all()) for g in gk) and math.isfinite(lk)
    result = {"loss_kernel": lk, "loss_plain": lp, "loss_rel_err": abs(lk - lp) / abs(lp),
              "grad_norm_kernel": nk, "grad_norm_plain": np_,
              "grad_norm_rel_err": abs(nk - np_) / np_, "grad_cos_min": min(cos),
              "loss_rel_tol": TRAIN_LOSS_REL_TOL, "grad_norm_rel_tol": TRAIN_GNORM_REL_TOL,
              "grad_cos_min_allowed": TRAIN_GRAD_COS_MIN, "launches": counts}
    log(f"[gradcheck] 750M ({cfg.n_heads} heads of {cfg.head_dim}), 1 x 2048, kernels vs "
        f"plain attention on {card}: " + json.dumps(result))
    if not (finite and result["loss_rel_err"] <= TRAIN_LOSS_REL_TOL
            and result["grad_norm_rel_err"] <= TRAIN_GNORM_REL_TOL
            and result["grad_cos_min"] >= TRAIN_GRAD_COS_MIN):
        raise AssertionError(f"full-width gradients disagree: {result}")
    del params, leaves, gk, gp
    torch.cuda.empty_cache()
    return result


# The wide-head flagship: 9 q and 9 kv heads of 256 (d_model 2304 / 9); the
# hd-72 flagship: 32 q and 32 kv heads of 72 (d_model 2304 / 32, off the 16
# grid); each 1 warm-up and 4 timed steps.
WIDE_HEADS = 9
OFF_GRID_HEADS = 32


@timed_phase
def wide_training_phase(card: str, smi: str, profile: bool = False) -> dict:
    """The wide-head flagship trains through the wide route: 5 steps of
    ``training_phase`` (the loss falls; 20 wide forwards, 10 wide dQ and
    10 wide dK/dV launches a step and nothing else; ``profile`` adds a
    profiled step), then its gradient check against plain attention."""
    run = training_phase(card, smi, "full", profile=profile, n_heads=WIDE_HEADS, warmup=1,
                         steps=4)
    grads = grad_check_phase(card, n_heads=WIDE_HEADS)
    return {"train": run, "grad_check": grads}


@timed_phase
def off_grid_training_phase(card: str, smi: str, profile: bool = False) -> dict:
    """The hd-72 flagship trains through the Hopper kernels at a head dim
    off the 16 grid: 5 steps of ``training_phase`` (the loss falls; 20
    Hopper forwards, 10 dQ and 10 dK/dV launches a step, no general or
    wide launch and no staged copy; ``profile`` adds a profiled step), then
    its gradient check against plain attention."""
    run = training_phase(card, smi, "full", profile=profile, n_heads=OFF_GRID_HEADS, warmup=1,
                         steps=4)
    grads = grad_check_phase(card, n_heads=OFF_GRID_HEADS)
    return {"train": run, "grad_check": grads}


# fp32 model, kernels (the fp32 route at heads of 64, the general route at
# 256) vs plain attention: fp32 on both sides (TF32 off), sums in another
# order through 2 layers; relative errors of ~1e-6 are expected, so 1e-5 on
# the loss and 1e-3 of each gradient's largest value.
FP32_LOSS_REL_TOL = 1e-5
FP32_GRAD_REL_TOL = 1e-3


# The fp32 training phase's model: (label, q heads, kv heads); d_model 512
# gives heads of 64 (the fp32 route) and of 256 (the general route).
FP32_TRAIN_MODELS = (("fp32 route", 8, 4), ("general route", 2, 2))


@timed_phase
def fp32_training_phase(card: str) -> dict:
    """A 2-layer fp32 model (d_model 512, remat "full") trains 3 steps
    through ``make_train_step`` at ``FP32_TRAIN_MODELS``' heads: with 8 q /
    4 kv heads of 64 every step launches the fp32 route's forward 2 x 2,
    its dQ 2 and its dK/dV 2, and no other kernel; with 2 / 2
    heads of 256 the general forward 2 x 2, dQ 2 and dK/dV 2. Then each
    one's loss and every gradient through the kernels against the same
    model through plain attention, TF32 off."""
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.parallel import make_optimizer, make_train_state, make_train_step
    from ray_tpu_torch.parallel.train_step import param_leaves

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 matmuls must run in fp32 (TF32 is on)")
    dev = torch.device("cuda")
    L, steps = 2, 3
    zero = {key: 0 for key in _counted()}
    wants = {"fp32 route": {**zero, "fp32_fwd": 2 * L * steps, "fp32_dq": L * steps,
                            "fp32_dkv": L * steps, "staged": 0},
             "general route": {**zero, "general_fwd": 2 * L * steps, "general_dq": L * steps,
                               "general_dkv": L * steps, "staged": 0}}
    results = {}
    for label, n_heads, n_kv_heads in FP32_TRAIN_MODELS:
        cfg = tf.TransformerConfig(vocab_size=32000, d_model=512, n_layers=L, n_heads=n_heads,
                                   n_kv_heads=n_kv_heads, d_ff=1536, max_seq_len=512,
                                   dtype=torch.float32, remat=True)
        opt = make_optimizer(lr=3e-4, warmup=2)
        params, opt_state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(10),
                                             device=dev, optimizer=opt)
        tokens = torch.randint(0, cfg.vocab_size, (4, 513), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(11))
        step = make_train_step(cfg, opt)
        reset_launch_counts()
        losses = []
        for _ in range(steps):
            params, opt_state, m = step(params, opt_state, {"tokens": tokens})
            losses.append(float(m["loss"]))
        launches = launch_counts()
        if launches != wants[label]:
            raise AssertionError(f"fp32 training ({label}) launches {launches} != "
                                 f"{wants[label]}")

        def plain_attn(q, k, v):
            return att.flash_attention_plain(q, k, v, True, q.shape[-1] ** -0.5)[0]

        plain_attn.supports_gqa = True
        leaves = param_leaves(params)

        def loss_and_grads(attn_fn):
            loss = tf.loss_fn(params, {"tokens": tokens}, cfg, attn_fn)
            return loss.item(), torch.autograd.grad(loss, leaves)

        lk, gk = loss_and_grads(None)
        lp, gp = loss_and_grads(plain_attn)
        rel = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
               for a, b in zip(gk, gp)]
        result = {"config": f"fp32, vocab 32000, d_model 512, 2 layers, {n_heads} q / "
                            f"{n_kv_heads} kv heads (head dim {cfg.head_dim}), d_ff 1536, "
                            "batch 4 x 512, remat full",
                  "losses": losses, "launches": launches, "loss_kernel": lk, "loss_plain": lp,
                  "loss_rel_err": abs(lk - lp) / abs(lp), "grad_rel_err_max": max(rel),
                  "loss_rel_tol": FP32_LOSS_REL_TOL, "grad_rel_tol": FP32_GRAD_REL_TOL}
        log(f"[train fp32] {label} on {card}: " + json.dumps(result))
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                and result["loss_rel_err"] <= FP32_LOSS_REL_TOL
                and max(rel) <= FP32_GRAD_REL_TOL):
            raise AssertionError(f"fp32 training through the {label}'s kernels: {result}")
        results[label] = result
        del params, opt_state, leaves, gk, gp
        torch.cuda.empty_cache()
    return {**results["fp32 route"], "general": results["general route"]}


@timed_phase
def slice_phase(card: str, profile: bool = False) -> dict:
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.models.paged import PagedConfig
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, params = serving_params()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params["layers"].values()) + sum(
        params[n].numel() for n in ("embed", "final_norm", "lm_head"))
    log(f"[slice] llama7b params: {n_params / 1e9:.3f} B bf16 on {card} "
        f"({time.perf_counter() - t0:.2f} s)")
    pcfg = PagedConfig(block_size=16, num_blocks=513, max_batch=16, max_blocks_per_seq=64)
    rng = torch.Generator().manual_seed(1)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    def check_outputs(outs, n_new):
        for o in outs:
            if len(o) != n_new or not all(0 <= t < cfg.vocab_size for t in o):
                raise AssertionError(f"bad output: len {len(o)}, ids {o[:8]}...")

    result = {}
    # --- main pass: full-prompt prefills through the kernel -------------
    n_new = SERVE_NEW_TOKENS
    lens = list(SERVE_PROMPT_LENS)
    prompts = [prompt(n) for n in lens]
    eng = LLMEngine(params, cfg, pcfg, device=dev, decode_window=4, overlap=True)
    eng.generate_batch([prompt(16)], 2)  # first-call set-up (kernel build, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = dict(eng.stats)
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["fwd"]
    full = eng.stats["full_prefills"] - base["full_prefills"]
    check_outputs(outs, n_new)
    if full < len(prompts) or counts != no_general({"fwd": cfg.n_layers * full, "dq": 0,
                                                    "dkv": 0}):
        raise AssertionError(f"launches {counts}: expected {cfg.n_layers} x {full} full "
                             "prefills and no general launch")
    lat = eng.recorder.latency_summary()
    result["main"] = {
        "requests": len(prompts), "new_tokens": n_new, "prompt_lens": lens,
        "seconds": dt, "tok_s": sum(len(o) for o in outs) / dt,
        "ttft_ms_p50": lat["ttft_ms"]["p50"], "ttft_ms_p99": lat["ttft_ms"]["p99"],
        "tpot_ms_p50": lat["tpot_ms"]["p50"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "full_prefills": full, "flash_fwd_launches": launches,
        "preemptions": eng.stats["preemptions"] - base["preemptions"],
    }
    log(f"[slice] main pass on {card}: " + json.dumps(result["main"]))
    ref_outs = dict(zip(map(tuple, prompts), outs))
    if profile:
        # Prefill only (one new token each finishes at the prefill flush),
        # then decode-heavy (short prompts, 32 new tokens, 10 slots).
        result["profile"] = [
            profile_pass(eng, prompts, 1, "prefill", card),
            profile_pass(eng, [prompt(16) for _ in range(10)], n_new, "decode", card),
        ]
    del eng
    torch.cuda.empty_cache()

    # --- shared-prefix pass: hits run the chunk program -----------------
    shared = prompt(256)
    pre_prompts = [shared + prompt(32) for _ in range(8)]
    eng = LLMEngine(params, cfg, pcfg, device=dev, enable_prefix_cache=True)
    att.flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = [eng.generate_batch([pre_prompts[0]], n_new)[0]]
    outs += eng.generate_batch(pre_prompts[1:], n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_outputs(outs, n_new)
    full = eng.stats["full_prefills"]
    if eng.stats["prefix_hit_tokens"] <= 0 or att.flash_attention.launches != cfg.n_layers * full:
        raise AssertionError(f"prefix pass: stats {eng.stats}, launches {att.flash_attention.launches}")
    result["prefix"] = {"requests": len(pre_prompts), "seconds": dt,
                        "tok_s": sum(len(o) for o in outs) / dt,
                        "prefix_hit_tokens": eng.stats["prefix_hit_tokens"],
                        "full_prefills": full, "flash_fwd_launches": att.flash_attention.launches}
    log(f"[slice] prefix pass on {card}: " + json.dumps(result["prefix"]))
    del eng
    torch.cuda.empty_cache()

    # --- chunked-prefill pass -------------------------------------------
    chunk_prompts = [prompts[7], prompts[6], prompts[0]]  # 700, 650, 16 tokens
    eng = LLMEngine(params, cfg, pcfg, device=dev, prefill_chunk=128)
    att.flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate_batch(chunk_prompts, n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_outputs(outs, n_new)
    full = eng.stats["full_prefills"]
    if eng.stats["prefill_chunks"] <= 0 or att.flash_attention.launches != cfg.n_layers * full:
        raise AssertionError(f"chunk pass: stats {eng.stats}, launches {att.flash_attention.launches}")
    # bf16 through two attention paths (kernel vs fp32 einsum chunks):
    # report token agreement with the full-prefill run, do not demand it.
    agree = [sum(a == b for a, b in zip(o, ref_outs[tuple(p)])) / n_new
             for o, p in zip(outs, chunk_prompts)]
    result["chunk"] = {"requests": len(chunk_prompts), "seconds": dt,
                       "prefill_chunks": eng.stats["prefill_chunks"], "full_prefills": full,
                       "flash_fwd_launches": att.flash_attention.launches,
                       "token_agreement_with_full_prefill": agree}
    log(f"[slice] chunk pass on {card}: " + json.dumps(result["chunk"]))
    del eng
    torch.cuda.empty_cache()

    # --- full-width prefill logits: kernel vs plain attention -----------
    toks = torch.tensor([prompts[4][:256]], device=dev)

    def plain_attn(q, k, v):
        return att.flash_attention_plain(q, k, v, True, q.shape[-1] ** -0.5)[0]

    plain_attn.supports_gqa = True
    with torch.no_grad():
        lk = tf.forward(params, toks, cfg)
        lp = tf.forward(params, toks, cfg, attn_fn=plain_attn)
    if not (torch.isfinite(lk).all() and lk.shape == (1, 256, cfg.vocab_size)):
        raise AssertionError("kernel prefill logits are not finite / of the expected shape")
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    top1 = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    result["logits"] = {"rel_max_err": rel, "rel_tol": LOGITS_REL_TOL, "top1_agree": top1,
                        "top1_min": LOGITS_TOP1_MIN}
    log(f"[slice] prefill logits kernel vs plain: " + json.dumps(result["logits"]))
    if rel > LOGITS_REL_TOL or top1 < LOGITS_TOP1_MIN:
        raise AssertionError(f"full-width prefill logits disagree: {result['logits']}")
    return result


def serving_params():
    """The serving phases' model: llama7b in bf16 on the card, random
    weights from seed 0."""
    from ray_tpu_torch.models import transformer as tf

    dev = torch.device("cuda")
    cfg = tf.TransformerConfig.llama7b(max_seq_len=2048, dtype=torch.bfloat16, remat=False)
    return cfg, tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                               dtype=torch.bfloat16)


def greedy_generate(params, cfg, prompts, n_new: int) -> list:
    """The port's contiguous ``generate`` on the card, one prompt at a
    time: greedy tokens as CPU tensors."""
    from ray_tpu_torch.models.generate import generate

    return [generate(params, cfg, torch.tensor([p], device="cuda"), n_new)[0].cpu()
            for p in prompts]


class RuntimeServeActor:
    """The runtime phase's GPU actor. ``runtime_phase`` creates it through
    ``ray_tpu_torch`` with ``num_gpus=1``; its worker imports this class
    from this module (the repo root is on the worker's PYTHONPATH)."""

    def identity(self) -> dict:
        return {"pid": os.getpid(),
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "foreign_modules": sorted(m for m in sys.modules
                                          if m.split(".")[0] in ("ray_tpu", "jax", "jaxlib"))}

    def serve(self, gen_prompts, gen_new: int, mix_prompts, warm_prompt, mix_new: int) -> dict:
        """Build the model, run ``greedy_generate`` on ``gen_prompts`` twice
        (the first call in this fresh process pays its one-time CUDA set-up;
        both must give the same tokens), then serve ``mix_prompts`` through
        ``LLMEngine``; the launch counts cover all of it (set to 0 just
        before, read just after). The weights stay resident, so the device
        telemetry shows them."""
        from ray_tpu_torch.models.paged import PagedConfig
        from ray_tpu_torch.serve.llm_engine import LLMEngine

        t0 = time.perf_counter()
        cfg, self.params = serving_params()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        before = set(sys.modules)
        t0 = time.perf_counter()
        first = greedy_generate(self.params, cfg, gen_prompts, gen_new)
        first_generate_s = time.perf_counter() - t0
        first_imports = set(sys.modules) - before
        t0 = time.perf_counter()
        tokens = greedy_generate(self.params, cfg, gen_prompts, gen_new)
        generate_s = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(first, tokens)):
            raise AssertionError("two greedy generate runs in the actor disagree")
        pcfg = PagedConfig(block_size=16, num_blocks=513, max_batch=16, max_blocks_per_seq=64)
        eng = LLMEngine(self.params, cfg, pcfg, device=torch.device("cuda"), decode_window=4,
                        overlap=True)
        eng.generate_batch([warm_prompt], 2)
        t0 = time.perf_counter()
        outs = eng.generate_batch(mix_prompts, mix_new)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        counts = launch_counts()
        lat = eng.recorder.latency_summary()
        return {
            "tokens": tokens, "launches": counts, "n_layers": cfg.n_layers,
            "engine_full_prefills": eng.stats["full_prefills"],
            "model_build_s": build_s, "first_generate_s": first_generate_s,
            # modules the first call imported (torch._dynamo must not be
            # among them: the flash ops are torch.library.Library ops)
            "first_generate_imported_modules": len(first_imports),
            "first_generate_imported_dynamo": "torch._dynamo" in first_imports,
            "generate_s": generate_s, "serve_s": serve_s,
            "serve_tok_s": sum(len(o) for o in outs) / serve_s,
            "ttft_ms_p50": lat["ttft_ms"]["p50"], "tpot_ms_p50": lat["tpot_ms"]["p50"],
            "serve_outputs_ok": all(len(o) == mix_new and all(0 <= x < cfg.vocab_size for x in o)
                                    for o in outs),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }


def _compute_app_pids() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    apps = {}
    for line in out.stdout.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = mem.strip()
    return apps


def _maps_libcuda(pid: int) -> bool:
    """Whether process ``pid`` has the CUDA driver library mapped, which
    every process with a CUDA context has (``nvidia-smi`` inside a
    container may list host pids, or none)."""
    with open(f"/proc/{pid}/maps") as f:
        return any("libcuda.so" in line for line in f)


def _wait_for(pred, what: str, timeout: float):
    deadline = time.time() + timeout
    while True:
        got = pred()
        if got:
            return got
        if time.time() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.2)


@contextlib.contextmanager
def port_cluster():
    """A cluster of the port's runtime for the runtime and serve phases:
    ``ray_tpu_torch.init`` on this node, whose one ``GPU`` (the card) it
    must detect, and one node agent (CPU only) joined, as a node of a
    larger cluster would. Yields ``{"init_s", "agent", "session_dir"}``; stops the agent
    and the cluster on the way out."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.node_agent import child_env
    from ray_tpu_torch.util import state

    t0 = time.perf_counter()
    info = rt.init(num_cpus=4)
    agent = None
    try:
        init_s = time.perf_counter() - t0
        resources = rt.cluster_resources()
        if resources.get("GPU") != 1:
            raise AssertionError(f"expected 1 detected GPU, got cluster resources {resources}")
        log_path = os.path.join(info["session_dir"], "logs", "agent-smoke.log")
        with open(log_path, "ab") as agent_log:
            agent = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.core.node_agent",
                 "--controller", info["address"], "--session-dir", info["session_dir"],
                 "--resources", json.dumps({"CPU": 1})],
                env=child_env(needs_tpu=False), stdout=agent_log, stderr=subprocess.STDOUT)
        _wait_for(lambda: len([n for n in state.list_nodes() if n["state"] == "ALIVE"]) == 2,
                  "the node agent to register", 60)
        yield {"init_s": init_s, "agent": agent, "session_dir": info["session_dir"]}
    finally:
        if agent is not None:
            agent.terminate()
            try:
                agent.wait(timeout=10)
            except subprocess.TimeoutExpired:
                agent.kill()
        rt.shutdown()


def _card_id() -> str:
    """The one card detected: "0", or the first entry of this process's
    CUDA_VISIBLE_DEVICES where the machine sets one."""
    from ray_tpu_torch.accelerators.nvidia_gpu import NvidiaGPUAcceleratorManager

    return NvidiaGPUAcceleratorManager.get_node_accelerator_ids(1)[0]


@timed_phase
def runtime_phase(card: str, smi: str, cluster: dict) -> dict:
    """Serve llama7b from a GPU actor of the port's runtime (``cluster``,
    from ``port_cluster()``) and hold its tokens to this process's own
    ``generate``."""
    import chip_smoke as this  # the module the actor's worker imports the class from
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api
    from ray_tpu_torch.util import state

    rng = torch.Generator().manual_seed(1)  # the serving phase's prompts

    def prompt(n):
        return torch.randint(0, 32000, (n,), generator=rng).tolist()  # llama7b's vocabulary

    mix_prompts = [prompt(n) for n in SERVE_PROMPT_LENS]
    warm_prompt = prompt(16)
    rng.manual_seed(2)
    gen_prompts = [prompt(n) for n in RUNTIME_GEN_LENS]

    result = {"init_s": cluster["init_s"]}
    agent = cluster["agent"]
    t0 = time.perf_counter()
    actor = rt.remote(num_gpus=1)(this.RuntimeServeActor).remote()
    ident = rt.get(actor.identity.remote(), timeout=300)
    result["actor_spawn_s"] = time.perf_counter() - t0
    result["actor"] = ident
    if ident["cuda_visible_devices"] != _card_id() or ident["foreign_modules"]:
        raise AssertionError(f"GPU actor: {ident}")
    if rt.available_resources().get("GPU", 0) != 0:
        raise AssertionError(f"the actor's GPU is not held: {rt.available_resources()}")

    t0 = time.perf_counter()
    out = rt.get(actor.serve.remote(gen_prompts, RUNTIME_GEN_NEW_TOKENS, mix_prompts,
                                    warm_prompt, SERVE_NEW_TOKENS), timeout=900)
    result["actor_serve_call_s"] = time.perf_counter() - t0
    expected = no_general({"fwd": out["n_layers"] * (2 * len(gen_prompts)
                                                      + out["engine_full_prefills"]),
                           "dq": 0, "dkv": 0})
    if out["launches"] != expected or not out["serve_outputs_ok"] \
            or out["first_generate_imported_dynamo"]:
        raise AssertionError(f"actor launches {out['launches']} (expected {expected}), "
                             f"outputs ok {out['serve_outputs_ok']}, first generate imported "
                             f"torch._dynamo {out['first_generate_imported_dynamo']}")
    for key in ("launches", "model_build_s", "first_generate_s",
                "first_generate_imported_modules", "first_generate_imported_dynamo",
                "generate_s", "serve_s", "serve_tok_s",
                "ttft_ms_p50", "tpot_ms_p50", "peak_mem_gb", "engine_full_prefills"):
        result[key] = out[key]

    # The same generate, same seed and prompts, in this process.
    cfg, params = serving_params()
    t0 = time.perf_counter()
    mine = greedy_generate(params, cfg, gen_prompts, RUNTIME_GEN_NEW_TOKENS)
    torch.cuda.synchronize()
    result["driver_generate_s"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    same = [torch.equal(a, b) for a, b in zip(out["tokens"], mine)]
    result["tokens_equal"] = same
    if not all(same) or len(mine) != len(out["tokens"]):
        raise AssertionError("the actor's greedy tokens differ from the driver's: "
                             f"{[a.tolist() for a in out['tokens']]} vs "
                             f"{[b.tolist() for b in mine]}")

    # The actor's device row, through the state API.
    def actor_rows():
        nodes = state.summarize_resources()["nodes"].values()
        return [d for n in nodes for d in n["devices"] if d.get("pid") == ident["pid"]]

    rows = _wait_for(actor_rows, "the actor's device telemetry row", 30)
    result["actor_device_rows"] = rows
    if not any(r["kind"] == card and r["platform"] == "gpu" and r["bytes_in_use"] > 0
               for r in rows):
        raise AssertionError(f"the actor's device rows do not name {card}: {rows}")

    # No CUDA context in the control plane: not among nvidia-smi's
    # compute apps, and no CUDA driver library mapped (the actor, which
    # has a context, shows that the second check can see one).
    apps = _compute_app_pids()
    control = {"controller": api._controller_proc.pid, "agent": agent.pid}
    result["compute_apps"] = apps
    result["control_plane_pids"] = control
    result["actor_among_compute_apps"] = ident["pid"] in apps
    libcuda = {name: _maps_libcuda(pid) for name, pid in
               dict(control, actor=ident["pid"], driver=os.getpid()).items()}
    result["libcuda_mapped"] = libcuda
    if any(pid in apps for pid in control.values()) or libcuda["controller"] \
            or libcuda["agent"] or not libcuda["actor"]:
        raise AssertionError(f"CUDA in the control plane: pids {control}, compute apps "
                             f"{apps}, libcuda mapped {libcuda}")

    rt.kill(actor)
    _wait_for(lambda: rt.available_resources().get("GPU", 0) == 1,
              "the GPU resource to come back", 60)
    result["gpu_back_after_kill"] = True
    log(f"[runtime] GPU actor serving llama7b on {smi}: " + json.dumps(result, default=str))
    return result


class ServeLLM:
    """The serve phase's deployment ``llm``: llama7b (bf16, full width and
    depth, ``serving_params()``'s seed) behind one ``LLMEngine`` with the
    serving phase's settings, pumped in the replica. ``serve_phase`` deploys
    it through ``ray_tpu_torch.serve`` with ``num_gpus=1``; its replica's
    worker imports this class from this module (the repo root is on the
    worker's PYTHONPATH). A request is ``{"prompt": [ids], "max_new_tokens":
    n}``; the reply streams ``{"tok": id}`` per token."""

    def __init__(self):
        from ray_tpu_torch.models.paged import PagedConfig
        from ray_tpu_torch.serve.llm_engine import LLMEngine

        self.init_started = time.time()  # wall clock: the driver compares it with its own
        self.arrivals = []  # (prompt length, wall time __call__ began)
        t0 = time.perf_counter()
        if not torch.cuda.is_available():
            raise RuntimeError("a num_gpus=1 replica sees no CUDA device")
        self.cfg, params = serving_params()
        pcfg = PagedConfig(block_size=16, num_blocks=513, max_batch=16, max_blocks_per_seq=64)
        self.engine = LLMEngine(params, self.cfg, pcfg, device=torch.device("cuda"),
                                decode_window=4, overlap=True)
        self.engine.start()
        torch.cuda.synchronize()
        self.init_s = time.perf_counter() - t0

    def __call__(self, request):
        self.arrivals.append((len(request["prompt"]), time.time()))
        req = self.engine.add_request(request["prompt"], request["max_new_tokens"])
        for tok in req.tokens(timeout=600):
            yield {"tok": int(tok)}

    def identity(self) -> dict:
        with open("/proc/self/stat") as f:  # the process's start, in clock ticks since boot
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            age_s = float(f.read().split()[0]) - started
        return {"pid": os.getpid(), "init_s": self.init_s, "process_age_s": age_s,
                "init_started": self.init_started, "module_import_began": _IMPORT_BEGAN,
                "torch_import_s": _TORCH_IMPORTED - _IMPORT_BEGAN,
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "n_modules": len(sys.modules), "dynamo_imported": "torch._dynamo" in sys.modules,
                "foreign_modules": sorted(m for m in sys.modules
                                          if m.split(".")[0] in ("ray_tpu", "jax", "jaxlib"))}

    def reset_counts(self) -> dict:
        """Launch counts to 0 and the peak-memory mark reset; returns the
        engine's stats at that point."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        return dict(self.engine.stats)

    def report(self) -> dict:
        torch.cuda.synchronize()
        return {"launches": launch_counts(), "n_layers": self.cfg.n_layers,
                "stats": dict(self.engine.stats),
                "latency_ms": self.engine.recorder.latency_summary(),
                "recent_requests": list(self.engine.recorder.requests),
                "arrivals": list(self.arrivals),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def http_stream(port: int, prompt, n_new: int) -> dict:
    """POST one request to the serve proxy as ndjson and read the tokens
    as they stream: {"tokens", "sent", "ttft_ms", "tpot_ms", "e2e_ms"}, the
    durations on this client's clock and ``sent`` on the wall clock."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/llm",
        data=json.dumps({"prompt": prompt, "max_new_tokens": n_new}).encode(),
        headers={"Accept": "application/x-ndjson", "Content-Type": "application/json"},
        method="POST")
    sent, t0 = time.time(), time.perf_counter()
    toks, stamps = [], []
    with urllib.request.urlopen(req, timeout=600) as resp:
        for line in resp:
            if line.strip():
                item = json.loads(line)
                if "tok" not in item:
                    raise AssertionError(f"the proxy streamed {item}")
                toks.append(item["tok"])
                stamps.append(time.perf_counter())
    if not toks:
        raise AssertionError("the proxy streamed no token")
    return {"tokens": toks, "sent": sent, "ttft_ms": (stamps[0] - t0) * 1e3,
            "tpot_ms": (stamps[-1] - stamps[0]) * 1e3 / max(1, len(toks) - 1),
            "e2e_ms": (stamps[-1] - t0) * 1e3}


def _counts_match_prefills(launches: dict, n_layers: int, prefills: int, what: str):
    expected = no_general({"fwd": n_layers * prefills, "dq": 0, "dkv": 0})
    if prefills <= 0 or launches != expected:
        raise AssertionError(f"{what}: replica launches {launches}, expected {expected} "
                             f"({n_layers} x {prefills} full-prompt prefills, nothing else)")


@timed_phase
def serve_phase(card: str, smi: str, cluster: dict, direct: dict) -> dict:
    """Serve llama7b through ``ray_tpu_torch.serve``: a ``num_gpus=1``
    replica of ``ServeLLM`` behind the HTTP proxy, on the runtime phase's
    cluster. Cold start, lone requests held token for token to this
    process's own engine, the serving phase's mix from concurrent clients
    (``direct``: the serving phase's numbers of the same mix), telemetry at
    the control plane, and no CUDA in the control plane."""
    import threading

    import chip_smoke as this  # the module the replica's worker imports the class from
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import api
    from ray_tpu_torch.models.paged import PagedConfig
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.metrics import percentile
    from ray_tpu_torch.util import state

    rng = torch.Generator().manual_seed(1)  # the serving and runtime phases' prompts

    def prompt(n):
        return torch.randint(0, 32000, (n,), generator=rng).tolist()  # llama7b's vocabulary

    mix_prompts = [prompt(n) for n in SERVE_PROMPT_LENS]
    rng.manual_seed(2)
    lone_prompts = [prompt(n) for n in RUNTIME_GEN_LENS]
    rng.manual_seed(3)
    cold_prompt = prompt(SERVE_COLD_LEN)

    result = {}
    dep = serve.deployment(name="llm", num_gpus=1, max_ongoing_requests=16)(this.ServeLLM)
    wall0, t0 = time.time(), time.perf_counter()
    handle = serve.run(dep.bind(), http_port=0)
    result["serve_run_s"] = time.perf_counter() - t0  # returns once the replica is placed
    ident = handle.identity.remote().result(timeout=600)  # queued behind __init__
    result["start_to_ready_s"] = time.perf_counter() - t0
    result["replica_module_import_began_s"] = ident["module_import_began"] - wall0
    result["replica_torch_import_s"] = ident["torch_import_s"]
    result["replica_init_began_s"] = ident["init_started"] - wall0
    result["replica_init_s"] = ident["init_s"]
    result["replica_process_age_at_ready_s"] = ident["process_age_s"]
    result["replica"] = {k: ident[k] for k in ("pid", "cuda_visible_devices", "foreign_modules")}
    if ident["cuda_visible_devices"] != _card_id() or ident["foreign_modules"]:
        raise AssertionError(f"serve replica: {ident}")
    if rt.available_resources().get("GPU", 0) != 0:
        raise AssertionError(f"the replica's GPU is not held: {rt.available_resources()}")
    port = serve.api.get_proxy_port()
    base = handle.reset_counts.remote().result(timeout=60)

    # --- cold start: the fresh replica's first request ------------------
    t0 = time.perf_counter()
    cold = http_stream(port, cold_prompt, RUNTIME_GEN_NEW_TOKENS)
    result["first_request_s"] = time.perf_counter() - t0
    after = handle.identity.remote().result(timeout=60)
    result["first_request_imported_modules"] = after["n_modules"] - ident["n_modules"]
    result["first_request_imported_dynamo"] = after["dynamo_imported"]
    if ident["dynamo_imported"] or after["dynamo_imported"]:
        raise AssertionError(f"the replica imported torch._dynamo: before the first request "
                             f"{ident['dynamo_imported']}, after {after['dynamo_imported']}")
    t0 = time.perf_counter()
    http_stream(port, cold_prompt, RUNTIME_GEN_NEW_TOKENS)
    result["second_request_s"] = time.perf_counter() - t0

    # --- exactness: lone requests, one at a time ------------------------
    lone = [http_stream(port, p, RUNTIME_GEN_NEW_TOKENS) for p in lone_prompts]
    rep = handle.report.remote().result(timeout=60)
    _counts_match_prefills(rep["launches"], rep["n_layers"],
                           rep["stats"]["full_prefills"] - base["full_prefills"],
                           "cold and lone requests")
    result["lone_launches"] = rep["launches"]["fwd"]

    # --- the mix: concurrent HTTP clients (ndjson) ----------------------
    base = handle.reset_counts.remote().result(timeout=60)
    outs = [None] * len(mix_prompts)
    errors = []

    def client(i):
        try:
            outs[i] = http_stream(port, mix_prompts[i], SERVE_NEW_TOKENS)
        except Exception as e:  # noqa: BLE001 — raised below, in this thread
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(mix_prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    mix_s = time.perf_counter() - t0
    if errors or any(o is None for o in outs):
        raise AssertionError(f"mix clients failed: {errors}")
    for o in outs:
        if len(o["tokens"]) != SERVE_NEW_TOKENS or not all(0 <= x < 32000 for x in o["tokens"]):
            raise AssertionError(f"a mix client got {len(o['tokens'])} tokens: {o['tokens'][:8]}")
    rep = handle.report.remote().result(timeout=60)
    mix_prefills = rep["stats"]["full_prefills"] - base["full_prefills"]
    _counts_match_prefills(rep["launches"], rep["n_layers"], mix_prefills, "the mix")
    if mix_prefills < len(mix_prompts):
        raise AssertionError(f"the mix ran {mix_prefills} full-prompt prefills")
    ttft = sorted(o["ttft_ms"] for o in outs)
    tpot = sorted(o["tpot_ms"] for o in outs)
    recent = rep["recent_requests"][-len(mix_prompts):]
    eng_ttft = sorted(r["ttft_ms"] for r in recent)
    eng_tpot = sorted(r["tpot_ms"] for r in recent)
    # A client's TTFT in three parts, matched by prompt length (the mix's
    # lengths are distinct): in (client send -> the replica's __call__,
    # through the proxy and the handle), the engine's own TTFT, and out
    # (the first token's way back to the client).
    arrived = dict(rep["arrivals"][-len(mix_prompts):])
    eng_by_len = {r["prompt_tokens"]: r["ttft_ms"] for r in recent}
    hop_in = sorted((arrived[len(p)] - o["sent"]) * 1e3 for p, o in zip(mix_prompts, outs))
    hop_out = sorted(o["ttft_ms"] - (arrived[len(p)] - o["sent"]) * 1e3 - eng_by_len[len(p)]
                     for p, o in zip(mix_prompts, outs))
    result["mix"] = {
        "clients": len(mix_prompts), "new_tokens": SERVE_NEW_TOKENS, "seconds": mix_s,
        "tok_s": sum(len(o["tokens"]) for o in outs) / mix_s,
        "client_ttft_ms_p50": percentile(ttft, 0.5),
        "client_ttft_ms_p99": percentile(ttft, 0.99),
        "client_tpot_ms_p50": percentile(tpot, 0.5),
        "engine_ttft_ms_p50": percentile(eng_ttft, 0.5),
        "engine_ttft_ms_p99": percentile(eng_ttft, 0.99),
        "engine_tpot_ms_p50": percentile(eng_tpot, 0.5),
        "ttft_in_ms_p50": percentile(hop_in, 0.5), "ttft_in_ms_max": hop_in[-1],
        "ttft_out_ms_p50": percentile(hop_out, 0.5), "ttft_out_ms_max": hop_out[-1],
        "peak_mem_gb": rep["peak_mem_gb"], "full_prefills": mix_prefills,
        "flash_fwd_launches": rep["launches"]["fwd"],
        "preemptions": rep["stats"]["preemptions"] - base["preemptions"]}
    result["direct_engine"] = {k: direct[k] for k in ("tok_s", "ttft_ms_p50", "ttft_ms_p99",
                                                       "tpot_ms_p50", "peak_mem_gb")}

    # --- telemetry at the control plane ---------------------------------
    hists = ("serve_ttft_ms", "serve_tpot_ms", "serve_e2e_ms", "serve_request_queue_ms")

    def llm_counts():
        snap = state.metrics_snapshot()
        counts = {}
        for name in hists:
            for tags, st in (snap.get(name) or {}).get("series", ()):
                if dict(map(tuple, tags)).get("deployment") == "llm":
                    counts[name] = counts.get(name, 0) + st["state"][-1]
        # Every streamed request lands in each histogram (queue and e2e
        # also count the method calls of this phase).
        return counts if all(counts.get(n, 0) >= n_streamed for n in hists) else None

    n_streamed = 2 + len(lone_prompts) + len(mix_prompts)
    result["metric_counts"] = _wait_for(llm_counts, "the serve histograms of llm", 30)
    n_mix_tokens = len(mix_prompts) * SERVE_NEW_TOKENS

    def llm_engine():
        engines = [s for k, s in state.serve_state().items() if k.startswith("llm/")]
        return [s for s in engines if s.get("stats", {}).get("tokens", 0) >= n_mix_tokens]

    esnap = _wait_for(llm_engine, "an llm engine in serve_state", 30)[0]
    result["serve_state_tokens"] = esnap["stats"]["tokens"]
    def llm_summary():
        summary = state.summarize_serve().get("llm", {})
        return summary if summary.get("finished_requests", 0) >= SERVE_MIN_FINISHED else None

    result["summarize_serve_finished"] = _wait_for(
        llm_summary, "summarize_serve to count the llm requests", 30)["finished_requests"]

    # --- the driver's own engine on the lone prompts ---------------------
    cfg, params = serving_params()
    eng = LLMEngine(params, cfg,
                    PagedConfig(block_size=16, num_blocks=513, max_batch=16, max_blocks_per_seq=64),
                    device=torch.device("cuda"), decode_window=4, overlap=True)
    mine = [eng.generate_batch([p], RUNTIME_GEN_NEW_TOKENS)[0] for p in lone_prompts]
    del eng, params
    torch.cuda.empty_cache()
    same = [o["tokens"] == m for o, m in zip(lone, mine)]
    result["lone_tokens_equal"] = same
    if not all(same):
        raise AssertionError("the replica's tokens differ from the driver's engine: "
                             f"{[o['tokens'] for o in lone]} vs {mine}")
    result["lone_client_ttft_ms"] = [o["ttft_ms"] for o in lone]

    # --- no CUDA in the control plane ------------------------------------
    names = {a["actor_id"]: a["name"] for a in state.list_actors() if a["state"] == "ALIVE"}
    pids = {names.get(w.get("actor_id")): w["pid"] for w in state.list_workers()}
    control = {"controller": api._controller_proc.pid, "agent": cluster["agent"].pid,
               "serve_controller": pids["__serve_controller__"],
               "proxy": pids["__serve_proxy__"]}
    libcuda = {name: _maps_libcuda(pid) for name, pid in
               dict(control, replica=ident["pid"]).items()}
    result["libcuda_mapped"] = libcuda
    if any(libcuda[name] for name in control) or not libcuda["replica"]:
        raise AssertionError(f"CUDA in the control plane: pids {control}, libcuda {libcuda}")

    serve.shutdown()
    _wait_for(lambda: rt.available_resources().get("GPU", 0) == 1,
              "the GPU resource to come back after serve.shutdown()", 60)
    result["gpu_back_after_shutdown"] = True
    log(f"[serve] llama7b from a num_gpus=1 replica through the HTTP proxy on {smi}: "
        + json.dumps(result, default=str))
    return result


# The train-on-the-runtime phase: the training phase's "full" run, from a
# CudaTrainer worker: 2 warm-up and 4 timed steps, a checkpoint after step
# CKPT_STEP, then a second fit() resumed from it for the steps after it.
RT_TRAIN_WARMUP, RT_TRAIN_TIMED, RT_TRAIN_CKPT_STEP = 2, 4, 3
RT_TRAIN_BATCH, RT_TRAIN_SEQ = 12, 2048


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def train_worker_loop(config):
    """The train-on-the-runtime phase's loop, run by a ``num_gpus=1``
    ``CudaTrainer`` worker (it imports this function from this module). It
    builds the 750M flagship from the training phase's seeds, steps it with
    ``make_train_step(..., group=)`` on the gang's NCCL group, fed by
    ``iter_device_batches`` from its dataset shard, and reports every step;
    after step ``checkpoint_at`` it saves the train state with
    ``dist_checkpoint`` and hands the directory to ``train.report``. Given a
    checkpoint (``resume_from_checkpoint``), it restores from it first."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.collective import nccl_group
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.parallel import make_optimizer, make_train_state, make_train_step
    from ray_tpu_torch.train import dist_checkpoint
    from ray_tpu_torch.train.torch import get_device

    entered = time.time()
    dev = get_device()
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise AssertionError(f"the train worker holds no card: get_device() {dev}")
    card = torch.cuda.get_device_name(0)
    group = nccl_group.group_for()
    backend = dist.get_backend(group)
    x = torch.arange(1024, dtype=torch.float32, device=dev)
    allreduce_ok = torch.equal(nccl_group.device_allreduce(x.clone(), group), x)
    if backend != "nccl" or not allreduce_ok:
        raise AssertionError(f"process group {backend}, device_allreduce gave the tensor back "
                             f"{allreduce_ok}")
    ident = {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
             "foreign_modules": sorted(m for m in sys.modules
                                       if m.split(".")[0] in ("ray_tpu", "jax", "jaxlib")),
             "backend": backend, "world_size": dist.get_world_size(group),
             "device_allreduce_ok": allreduce_ok, "loop_entered": entered}

    cfg = train_config("full")
    opt = make_optimizer(lr=3e-4, warmup=10)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                         device=dev, optimizer=opt)
    done, restore_s = 0, None
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        t0 = time.perf_counter()
        _, _, done = dist_checkpoint.restore_train_state(
            os.path.join(ckpt.path, "state"), params, opt_state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    step = make_train_step(cfg, opt, group=group)
    per_step = no_general({"fwd": 2 * cfg.n_layers, "dq": cfg.n_layers, "dkv": cfg.n_layers})
    it = train.get_dataset_shard("train")
    batches = it.iter_device_batches(batch_size=config["batch"], prefetch_to_device=2)
    flops_peak, _ = peaks(card)
    persist_s = None
    reset_launch_counts()
    for batch in batches:
        tokens = batch["tokens"]
        if not tokens.is_cuda or tuple(tokens.shape) != (config["batch"], config["seq"] + 1):
            raise AssertionError(f"batch {tuple(tokens.shape)} on {tokens.device}")
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # both wait for the step
        step_s = time.perf_counter() - t0
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after}
        if got != per_step:
            raise AssertionError(f"worker step {done + 1}: launches {got} != {per_step}")
        done += 1
        tokens_per_step = config["batch"] * config["seq"]
        metrics = {"step": done, "loss": loss, "grad_norm": gnorm, "step_ms": step_s * 1e3,
                   "tokens_per_s": tokens_per_step / step_s,
                   "mfu": tf.flops_per_token(cfg, config["seq"]) * tokens_per_step / step_s
                   / flops_peak,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "launches": got, "launches_total": launch_counts(),
                   "device_stats": dict(it.device_stats), "restore_s": restore_s,
                   "identity": ident}
        if persist_s is not None:  # the previous step's report copied its checkpoint
            metrics["report_with_checkpoint_s"], persist_s = persist_s, None
        staging = None
        if done == config["checkpoint_at"]:
            staging = tempfile.mkdtemp(prefix="ckpt_stage_", dir=config["staging_root"])
            metrics["free_bytes_before_save"] = shutil.disk_usage(staging).free
            t0 = time.perf_counter()
            dist_checkpoint.save_train_state(os.path.join(staging, "state"), params, opt_state,
                                             step=done)
            metrics["save_s"] = time.perf_counter() - t0
            metrics["checkpoint_bytes"] = _dir_bytes(staging)
        t0 = time.perf_counter()
        train.report(metrics, checkpoint=train.Checkpoint.from_directory(staging)
                     if staging else None)
        if staging:
            persist_s = time.perf_counter() - t0
            shutil.rmtree(staging)


@timed_phase
def train_runtime_phase(card: str, smi: str, cluster: dict, direct: dict) -> dict:
    """Train the 750M flagship from a ``num_gpus=1`` ``CudaTrainer`` worker
    on the runtime phase's cluster (``train_worker_loop``), fed by its
    dataset shard; hold its losses to the bare training phase's (``direct``:
    its "full" run), resume from its checkpoint and hold the resumed losses
    to the uninterrupted run's."""
    import shutil

    import numpy as np

    import chip_smoke as this  # the module the worker imports the loop from
    import ray_tpu_torch as rt
    from ray_tpu_torch import data
    from ray_tpu_torch.core import api
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.train import CudaTrainer, RunConfig, ScalingConfig

    dev = torch.device("cuda")
    cfg = train_config("full")
    tokens = torch.randint(0, cfg.vocab_size, (RT_TRAIN_BATCH, RT_TRAIN_SEQ + 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1)).cpu().numpy()
    steps = RT_TRAIN_WARMUP + RT_TRAIN_TIMED
    storage = os.path.join(cluster["session_dir"], "train")
    os.makedirs(storage, exist_ok=True)
    config = {"batch": RT_TRAIN_BATCH, "seq": RT_TRAIN_SEQ,
              "checkpoint_at": RT_TRAIN_CKPT_STEP, "staging_root": storage}
    scaling = ScalingConfig(num_workers=1, use_gpu=True, use_torch_distributed=True)

    def fit(name, n_steps, resume=None):
        ds = data.from_numpy({"tokens": np.tile(tokens, (n_steps, 1))}, parallelism=n_steps)
        trainer = CudaTrainer(this.train_worker_loop, train_loop_config=config,
                              scaling_config=scaling, datasets={"train": ds},
                              run_config=RunConfig(name=name, storage_path=storage),
                              resume_from_checkpoint=resume)
        began = time.time()
        t0 = time.perf_counter()
        res = trainer.fit()
        fit_s = time.perf_counter() - t0
        if res.error is not None:
            raise AssertionError(f"fit {name}: {res.error!r}")
        hist = res.metrics_history
        if [h["step"] for h in hist] != list(range(steps - n_steps + 1, steps + 1)):
            raise AssertionError(f"fit {name}: steps {[h['step'] for h in hist]}")
        _wait_for(lambda: rt.available_resources().get("GPU", 0) == 1,
                  f"the GPU resource to come back after fit {name}", 60)
        return res, hist, fit_s, hist[0]["identity"]["loop_entered"] - began

    result = {"config": f"750M flagship, remat full, batch {RT_TRAIN_BATCH} x {RT_TRAIN_SEQ}, "
                        "one num_gpus=1 CudaTrainer worker, NCCL group of 1",
              "storage": storage, "card": smi}
    first, hist, result["fit_s"], result["worker_spawn_s"] = fit("flagship", steps)
    ident = hist[0]["identity"]
    result["worker"] = {k: ident[k] for k in ("pid", "cuda_visible_devices", "foreign_modules",
                                              "backend", "world_size", "device_allreduce_ok")}
    if ident["cuda_visible_devices"] != _card_id() or ident["foreign_modules"]:
        raise AssertionError(f"train worker: {ident}")
    losses = [h["loss"] for h in hist]
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(losses, direct["losses"]))
    result["losses"] = losses
    result["loss_max_rel_diff_vs_training_phase"] = loss_diff
    if loss_diff > POLICY_LOSS_REL_TOL:
        raise AssertionError(f"the worker's losses {losses} differ from the training phase's "
                             f"{direct['losses'][:steps]} by {loss_diff} > {POLICY_LOSS_REL_TOL}")
    stats = hist[-1]["device_stats"]
    result["device_batches"] = stats
    if stats["batches"] != steps or stats["pinned"] != steps or stats["max_ahead"] > 2:
        raise AssertionError(f"iter_device_batches: {stats} (expected {steps} batches, all "
                             "staged in pinned memory, at most 2 ahead)")
    timed = hist[RT_TRAIN_WARMUP:]
    mean_ms = sum(h["step_ms"] for h in timed) / len(timed)
    flops_peak, _ = peaks(card)
    tokens_per_step = RT_TRAIN_BATCH * RT_TRAIN_SEQ
    result.update({
        "step_ms_mean": mean_ms, "step_ms_min": min(h["step_ms"] for h in timed),
        "step_ms_max": max(h["step_ms"] for h in timed),
        "tokens_per_s": tokens_per_step / (mean_ms / 1e3),
        "mfu": tf.flops_per_token(cfg, RT_TRAIN_SEQ) * tokens_per_step / (mean_ms / 1e3)
        / flops_peak,
        "peak_mem_gb": hist[-1]["peak_mem_gb"],
        "training_phase": {k: direct[k] for k in ("step_ms_mean", "step_ms_min", "step_ms_max",
                                                  "tokens_per_s", "mfu", "peak_mem_gb")},
        "launches_per_step": hist[0]["launches"], "launches": hist[-1]["launches_total"],
    })
    saved = hist[RT_TRAIN_CKPT_STEP - 1]
    result.update({k: saved[k] for k in ("free_bytes_before_save", "save_s", "checkpoint_bytes")})
    # train.report copies the saved directory into the run's storage.
    result["report_with_checkpoint_s"] = hist[RT_TRAIN_CKPT_STEP]["report_with_checkpoint_s"]
    ckpt = first.checkpoint
    if ckpt is None or not os.path.exists(os.path.join(ckpt.path, ".complete")):
        raise AssertionError(f"Result.checkpoint {ckpt} is not a complete checkpoint")
    result["checkpoint"] = ckpt.path
    result["checkpoint_bytes_persisted"] = _dir_bytes(ckpt.path)

    # --- resume: a second fit() from the step-3 checkpoint ---------------
    n_resume = steps - RT_TRAIN_CKPT_STEP
    _, rhist, result["resume_fit_s"], result["resume_worker_spawn_s"] = fit(
        "flagship_resumed", n_resume, resume=ckpt)
    result["restore_s"] = rhist[0]["restore_s"]
    resumed = [h["loss"] for h in rhist]
    resume_diff = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[RT_TRAIN_CKPT_STEP:]))
    result["resumed_losses"] = resumed
    result["resumed_loss_max_rel_diff"] = resume_diff
    if resume_diff > POLICY_LOSS_REL_TOL:
        raise AssertionError(f"resumed losses {resumed} differ from the uninterrupted run's "
                             f"{losses[RT_TRAIN_CKPT_STEP:]} by {resume_diff}")
    result["resume_launches"] = rhist[-1]["launches_total"]

    # --- no CUDA in the control plane; clean up --------------------------
    control = {"controller": api._controller_proc.pid, "agent": cluster["agent"].pid}
    libcuda = {name: _maps_libcuda(pid) for name, pid in control.items()}
    result["libcuda_mapped"] = libcuda
    if any(libcuda.values()):
        raise AssertionError(f"CUDA in the control plane: pids {control}, libcuda {libcuda}")
    shutil.rmtree(storage)
    result["checkpoint_removed"] = not os.path.exists(storage)
    result["gpu_back_after_fit"] = True
    log(f"[train-runtime] 750M from a num_gpus=1 CudaTrainer worker on {smi}: "
        + json.dumps(result, default=str))
    return result


# --- phase 15: Tune and Job on the runtime -----------------------------------
# Two num_gpus=1 trials of the 750M flagship ("full", batch 12 x 2048, the
# training phase's seeds), one per learning rate, 4 steps each; the one card
# makes them run one after the other. Then a submitted job whose num_gpus=1
# actor launches flash_fwd once at the serving shape.
TUNE_LRS = (3e-4, 1e-4)
TUNE_STEPS = 4
TUNE_BATCH, TUNE_SEQ = 12, 2048
# The best trial's eval loss, reloaded from its checkpoint in this process,
# against the one the trial reported: the same forward on the same card.
TUNE_RELOAD_REL_TOL = 1e-6
JOB_SHAPE = (1, 32, 1024, 128)  # the serving shape (slice S=1024), bf16, causal


def tune_eval_loss(params, cfg, batch) -> float:
    """The forward-only loss of ``params`` on ``batch`` (no gradient)."""
    from ray_tpu_torch.models import transformer as tf

    with torch.no_grad():
        return float(tf.loss_fn(params, batch, cfg))


def _tune_batch(cfg, dev) -> dict:
    return {"tokens": torch.randint(0, cfg.vocab_size, (TUNE_BATCH, TUNE_SEQ + 1), device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(1))}


def tune_trial_loop(config):
    """The Tune phase's trainable, run by a ``num_gpus=1`` trial actor (it
    imports this function from this module): the 750M flagship from the
    training phase's seeds, ``make_optimizer(lr=config["lr"], warmup=10)``,
    ``TUNE_STEPS`` steps of ``make_train_step``, each reported with its
    loss, time and launch counts; after the last step, a forward-only eval
    loss and the params saved with ``torch.save`` into
    ``tune.make_checkpoint_dir()``, reported with the last step."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.parallel import make_optimizer, make_train_state, make_train_step

    entered = time.time()
    if not torch.cuda.is_available():
        raise AssertionError("the trial actor holds no card")
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    ident = {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
             "foreign_modules": sorted(m for m in sys.modules
                                       if m.split(".")[0] in ("ray_tpu", "jax", "jaxlib")),
             "loop_entered": entered}
    cfg = train_config("full")
    opt = make_optimizer(lr=config["lr"], warmup=10)
    params, opt_state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                         device=dev, optimizer=opt)
    batch = _tune_batch(cfg, dev)
    step = make_train_step(cfg, opt)
    flops_peak, _ = peaks(card)
    tokens_per_step = TUNE_BATCH * TUNE_SEQ
    reset_launch_counts()
    for i in range(1, TUNE_STEPS + 1):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # both wait for the step
        step_s = time.perf_counter() - t0
        after = launch_counts()
        metrics = {"step": i, "loss": loss, "grad_norm": gnorm, "step_ms": step_s * 1e3,
                   "tokens_per_s": tokens_per_step / step_s,
                   "mfu": tf.flops_per_token(cfg, TUNE_SEQ) * tokens_per_step / step_s
                   / flops_peak,
                   "launches": {k: after[k] - before[k] for k in after}, "identity": ident}
        if i < TUNE_STEPS:
            tune.report(metrics)
    metrics["loop_left"] = time.time()
    before = launch_counts()
    metrics["eval_loss"] = tune_eval_loss(params, cfg, batch)
    after = launch_counts()
    metrics["eval_launches"] = {k: after[k] - before[k] for k in after}
    metrics["launches_total"] = after
    ckpt = tune.make_checkpoint_dir()
    t0 = time.perf_counter()
    torch.save({"params": params}, os.path.join(ckpt, "params.pt"))
    metrics["save_s"] = time.perf_counter() - t0
    metrics["checkpoint_bytes"] = _dir_bytes(ckpt)
    metrics["reported_at"] = time.time()
    tune.report(metrics, checkpoint_dir=ckpt)


def _process_alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie waiting to be reaped does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError):
        return False


class JobFlashActor:
    """The submitted job's ``num_gpus=1`` actor (its worker imports this
    class from this module)."""

    def run(self) -> dict:
        from ray_tpu_torch.ops import attention as att

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(*JOB_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        scale = JOB_SHAPE[-1] ** -0.5
        reset_launch_counts()
        o, lse = att.flash_forward_cuda(q, k, v, True, scale)
        torch.cuda.synchronize()
        launches = launch_counts()
        o_ref, lse_ref = att.flash_attention_plain(q.float(), k.float(), v.float(), True, scale)
        from ray_tpu_torch import runtime_context

        return {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "node_id": runtime_context.get_runtime_context().get_node_id(),
                "launches": launches, "o_err": (o.float() - o_ref).abs().max().item(),
                "lse_err": (lse - lse_ref).abs().max().item(),
                "finite": bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())}


def job_main():
    """The submitted job's driver (``python3 -c "import chip_smoke;
    chip_smoke.job_main()"`` from the repo root): joins the cluster, runs
    ``JobFlashActor`` with ``num_gpus=1`` and prints one ``JOB_RESULT`` JSON
    line, with whether torch initialized CUDA in this process."""
    import ray_tpu_torch as rt

    rt.init(address="auto")
    actor = rt.remote(num_gpus=1)(JobFlashActor).remote()
    out = rt.get(actor.run.remote(), timeout=600)
    rt.kill(actor)
    out["driver"] = {"pid": os.getpid(), "cuda_initialized": torch.cuda.is_initialized(),
                     "job_id": os.environ.get("RAY_TPU_TORCH_JOB_ID")}
    print("JOB_RESULT " + json.dumps(out), flush=True)
    rt.shutdown()


@timed_phase
def tune_phase(card: str, smi: str, cluster: dict, direct: dict) -> dict:
    """Two ``num_gpus=1`` Tune trials of the 750M flagship on the runtime
    phase's cluster (``tune_trial_loop``, one per lr of ``TUNE_LRS``): held
    to the bare training phase's losses (``direct``: its "full" run), run
    one after the other on the one card, the best trial's checkpoint
    reloaded here; then a job submitted through the REST route whose
    ``num_gpus=1`` actor launches flash_fwd once."""
    import shutil

    import chip_smoke as this  # the module the trial actors import the loop from
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    dev = torch.device("cuda")
    cfg = train_config("full")
    exp_dir = os.path.join(cluster["session_dir"], "tune", "flagship_lr")
    per_step = no_general({"fwd": 2 * cfg.n_layers, "dq": cfg.n_layers, "dkv": cfg.n_layers})
    result = {"config": f"750M flagship, remat full, batch {TUNE_BATCH} x {TUNE_SEQ}, "
                        f"{TUNE_STEPS} steps a trial, lr grid {list(TUNE_LRS)}, "
                        "resources_per_trial num_cpus 1 num_gpus 1",
              "experiment_dir": exp_dir, "card": smi}
    began = time.time()
    t0 = time.perf_counter()
    grid = tune.Tuner(
        this.tune_trial_loop, param_space={"lr": tune.grid_search(list(TUNE_LRS))},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    resources_per_trial={"num_cpus": 1, "num_gpus": 1}),
        _experiment_dir=exp_dir).fit()
    result["fit_s"] = time.perf_counter() - t0
    _wait_for(lambda: rt.available_resources().get("GPU", 0) == 1,
              "the GPU resource to come back after the tuner's fit()", 60)
    result["gpu_back_after_fit"] = True
    trials = sorted(grid.trials, key=lambda t: -t.config["lr"])
    bad = [(t.trial_id, t.status, t.error) for t in trials if t.status != "TERMINATED"]
    if bad or len(trials) != len(TUNE_LRS):
        raise AssertionError(f"tune trials: {bad or len(trials)}")
    pids = [t.results[0]["identity"]["pid"] for t in trials]
    _wait_for(lambda: not any(_process_alive(p) for p in pids),
              f"the trial processes {pids} to exit", 30)
    bare = direct["losses"][:TUNE_STEPS]
    rows, windows = [], []
    for t in trials:
        hist, last = t.results, t.results[-1]
        ident = hist[0]["identity"]
        if ident["cuda_visible_devices"] != _card_id() or ident["foreign_modules"]:
            raise AssertionError(f"trial {t.config}: {ident}")
        if [h["step"] for h in hist] != list(range(1, TUNE_STEPS + 1)):
            raise AssertionError(f"trial {t.config}: steps {[h['step'] for h in hist]}")
        for h in hist:
            if h["launches"] != per_step:
                raise AssertionError(f"trial {t.config} step {h['step']}: launches "
                                     f"{h['launches']} != {per_step}")
        eval_launches = no_general({"fwd": cfg.n_layers, "dq": 0, "dkv": 0})
        if last["eval_launches"] != eval_launches:
            raise AssertionError(f"trial {t.config} eval: launches {last['eval_launches']} != "
                                 f"{eval_launches}")
        losses = [h["loss"] for h in hist]
        want = bare if t.config["lr"] == TUNE_LRS[0] else bare[:1]
        if losses[:len(want)] != want:
            raise AssertionError(f"trial {t.config}: losses {losses} are not the bare training "
                                 f"phase's {want} to the bit")
        windows.append((ident["loop_entered"], last["loop_left"]))
        rows.append({
            "lr": t.config["lr"], "trial_id": t.trial_id, "pid": ident["pid"],
            "cuda_visible_devices": ident["cuda_visible_devices"], "losses": losses,
            "equal_to_bare_steps": len(want),
            "step_ms": [h["step_ms"] for h in hist],
            "tokens_per_s": [h["tokens_per_s"] for h in hist],
            "mfu": [h["mfu"] for h in hist],
            "eval_loss": last["eval_loss"], "save_s": last["save_s"],
            "checkpoint_bytes": last["checkpoint_bytes"],
            "checkpoint": t.checkpoint_dir, "launches_per_step": hist[0]["launches"],
            "eval_launches": last["eval_launches"], "launches_total": last["launches_total"],
            "loop_entered": ident["loop_entered"], "loop_left": last["loop_left"],
            "reported_at": last["reported_at"]})
    order = sorted(range(len(rows)), key=lambda i: windows[i][0])
    for a, b in zip(order, order[1:]):
        if windows[b][0] < windows[a][1]:
            raise AssertionError(f"trial loops overlap on one card: {windows}")
    first, second = rows[order[0]], rows[order[1]]
    result["first_trial_spawn_s"] = first["loop_entered"] - began
    # From the first trial's last report to the second's loop: the tuner
    # kills the first runner, the GPU frees, the second runner starts.
    result["second_trial_handoff_s"] = second["loop_entered"] - first["reported_at"]
    result["trials"] = rows
    result["bare_training_phase"] = {k: direct[k] for k in ("step_ms_mean", "step_ms_min",
                                                            "tokens_per_s", "mfu")}
    result["bare_losses"] = bare

    best = grid.get_best_result()
    lowest = min(rows, key=lambda r: r["losses"][-1])
    if best.metrics["config"]["lr"] != lowest["lr"]:
        raise AssertionError(f"best result lr {best.metrics['config']['lr']}, but the lowest last "
                             f"loss is lr {lowest['lr']}'s")
    if best.checkpoint is None:
        raise AssertionError("the best result has no checkpoint")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = torch.load(os.path.join(best.checkpoint.path, "params.pt"), map_location=dev,
                        weights_only=True)["params"]
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reloaded = tune_eval_loss(params, cfg, _tune_batch(cfg, dev))
    del params
    torch.cuda.empty_cache()
    reload_diff = abs(reloaded - lowest["eval_loss"]) / abs(lowest["eval_loss"])
    result["best"] = {"lr": lowest["lr"], "reported_eval_loss": lowest["eval_loss"],
                      "reloaded_eval_loss": reloaded, "reload_exact": reloaded == lowest["eval_loss"],
                      "reload_rel_diff": reload_diff, "load_s": load_s,
                      "checkpoint": best.checkpoint.path}
    if reload_diff > TUNE_RELOAD_REL_TOL:
        raise AssertionError(f"the best checkpoint reloads to eval loss {reloaded}, the trial "
                             f"reported {lowest['eval_loss']} (rel {reload_diff})")
    result["tune_trial_launches"] = {k: sum(r["launches_total"][k] for r in rows)
                                     for k in rows[0]["launches_total"]}
    shutil.rmtree(os.path.dirname(exp_dir))
    for r in rows:
        log(f"[tune] trial lr {r['lr']} on {smi}: step ms {r['step_ms']}, tokens/s "
            f"{r['tokens_per_s']}, MFU {r['mfu']} (bare full step: "
            f"{direct['step_ms_mean']} ms mean, {direct['tokens_per_s']} tokens/s, MFU "
            f"{direct['mfu']}); checkpoint {r['checkpoint_bytes']} bytes saved in "
            f"{r['save_s']} s")
    log(f"[tune] first trial spawn {result['first_trial_spawn_s']} s, second trial handoff "
        f"{result['second_trial_handoff_s']} s, fit {result['fit_s']} s on {smi}")

    # --- a job through the REST route -------------------------------------
    client = JobSubmissionClient()
    entry = f"{sys.executable} -c 'import chip_smoke; chip_smoke.job_main()'"
    t0 = time.perf_counter()
    job_id = client.submit_job(entrypoint=entry,
                               runtime_env={"working_dir": os.path.dirname(
                                   os.path.abspath(this.__file__))})
    status = client.wait_until_finished(job_id, timeout=600)
    job_s = time.perf_counter() - t0
    logs = client.get_job_logs(job_id)
    if status != JobStatus.SUCCEEDED:
        raise AssertionError(f"job {job_id}: {status} {client.get_job_info(job_id)}\n{logs}")
    lines = [l for l in logs.splitlines() if l.startswith("JOB_RESULT ")]
    if len(lines) != 1:
        raise AssertionError(f"job {job_id}: no JOB_RESULT line in its logs:\n{logs}")
    job = json.loads(lines[0][len("JOB_RESULT "):])
    job.update({"job_id": job_id, "submit_to_succeeded_s": job_s, "status": status})
    result["job"] = job
    if job["launches"] != no_general({"fwd": 1, "dq": 0, "dkv": 0}):
        raise AssertionError(f"job actor launches {job['launches']}: one fwd launch expected")
    if not job["finite"] or job["o_err"] > O_TOL or job["lse_err"] > LSE_TOL:
        raise AssertionError(f"job actor's flash_fwd disagrees with its plain version: {job}")
    if job["cuda_visible_devices"] != _card_id() or job["driver"]["cuda_initialized"]:
        raise AssertionError(f"job: the actor's card or CUDA in the job's driver: {job}")
    if job["driver"]["job_id"] != job_id:
        raise AssertionError(f"job driver saw job id {job['driver']['job_id']}, not {job_id}")
    _wait_for(lambda: rt.available_resources().get("GPU", 0) == 1,
              "the GPU resource to come back after the job", 60)
    log(f"[job] {job_id} submit to SUCCEEDED {job_s} s on {smi}: " + json.dumps(job))
    log(f"[tune] Tune and Job on {smi}: " + json.dumps(result, default=str))
    return result


# --- phase 16: the CLI and the launcher ---------------------------------------
# (a) the CLI on one node: ``start --head`` with no --num-gpus advertises the
# card; a job submitted through ``submit`` trains the 750M flagship ("full",
# batch 12 x 2048, the training phase's seeds) for CLI_JOB_STEPS steps from a
# num_gpus=1 actor; ``profile device`` captures a num_gpus=1 actor that loops
# the serving-shape forward; ``microbenchmark``; ``stop``. (b) ``up`` of a
# fake-provider cluster whose head has no GPU: a num_gpus=1 actor makes the
# monitor launch ``gpu_node``, which is reaped once idle; ``down``.
CLI_JOB_STEPS = 3
CLI_PROFILE_S = 3
CLI_LOOP_YIELD_S = 1e-3
LAUNCHER_IDLE_TIMEOUT_S = 15
# Beyond idle_timeout_s: the autoscaler's 1 s ticks, the agent's exit and the
# controller marking the node gone.
LAUNCHER_REAP_MARGIN_S = 30
LAUNCHER_CLUSTER = {
    "cluster_name": "cli-smoke",
    "provider": {"type": "fake"},
    "head_resources": {"CPU": 4},
    "idle_timeout_s": LAUNCHER_IDLE_TIMEOUT_S,
    "available_node_types": {
        "gpu_node": {"resources": {"CPU": 2, "GPU": 1}, "min_workers": 0, "max_workers": 1},
    },
}


class CliTrainActor:
    """The CLI job's ``num_gpus=1`` actor (its worker imports this class
    from this module): the training phase's "full" run, first steps."""

    def run(self, steps: int) -> dict:
        from ray_tpu_torch.parallel import make_optimizer, make_train_state, make_train_step

        dev = torch.device("cuda")
        cfg = train_config("full")
        opt = make_optimizer(lr=3e-4, warmup=10)
        params, opt_state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                             device=dev, optimizer=opt)
        batch = _tune_batch(cfg, dev)
        step = make_train_step(cfg, opt)
        losses, step_ms = [], []
        reset_launch_counts()
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            losses.append(float(m["loss"]))  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "foreign_modules": sorted(m for m in sys.modules
                                          if m.split(".")[0] in ("ray_tpu", "jax", "jaxlib")),
                "losses": losses, "step_ms": step_ms,
                "tokens_per_s": [TUNE_BATCH * TUNE_SEQ / (ms / 1e3) for ms in step_ms],
                "launches": launch_counts()}


def cli_job_main():
    """The job that ``ray-tpu-torch submit -- python3 chip_smoke.py
    --cli-job`` runs: joins the cluster, trains from ``CliTrainActor`` with
    ``num_gpus=1`` and prints one ``CLI_JOB_RESULT`` JSON line."""
    import ray_tpu_torch as rt

    rt.init(address="auto")
    actor = rt.remote(num_gpus=1)(CliTrainActor).remote()
    out = rt.get(actor.run.remote(CLI_JOB_STEPS), timeout=900)
    rt.kill(actor)
    out["driver"] = {"pid": os.getpid(), "cuda_initialized": torch.cuda.is_initialized(),
                     "job_id": os.environ.get("RAY_TPU_TORCH_JOB_ID")}
    print("CLI_JOB_RESULT " + json.dumps(out), flush=True)
    rt.shutdown()


class CliLoopActor:
    """A ``num_gpus=1`` actor that loops flash_fwd at ``JOB_SHAPE`` in a
    method for ``profile device`` to capture."""

    def start(self) -> dict:
        from ray_tpu_torch.ops import attention as att

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        self._qkv = [torch.randn(*JOB_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(3)]
        att.flash_forward_cuda(*self._qkv, True, JOB_SHAPE[-1] ** -0.5)  # built before a capture
        torch.cuda.synchronize()
        # No profiler session here: the capture's start is this worker's
        # first, and sets CUPTI up within the controller's START_TIMEOUT_S.
        return {"pid": os.getpid(), "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}

    def loop(self, seconds: float, stop_file: str) -> dict:
        """Loop until ``stop_file`` exists, at most ``seconds``."""
        from ray_tpu_torch.ops import attention as att

        iterations, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds and not os.path.exists(stop_file):
            att.flash_forward_cuda(*self._qkv, True, JOB_SHAPE[-1] ** -0.5)
            torch.cuda.synchronize()
            iterations += 1
            # Yield: a capture's start competes with the loop for the
            # worker (ROADMAP C4).
            time.sleep(CLI_LOOP_YIELD_S)
        return {"iterations": iterations, "loop_s": time.perf_counter() - t0}


def autoscale_driver_main():
    """The driver that ``exec_on_cluster`` runs on the launched cluster:
    asks for a ``num_gpus=1`` actor (``JobFlashActor``), which only a node
    the monitor launches can hold, times demand to node ALIVE to actor
    ready, kills the actor and waits for the idle node to be reaped; prints
    one ``LAUNCHER_RESULT`` JSON line."""
    import ray_tpu_torch as rt

    rt.init(address="auto")
    head = [n["node_id"] for n in rt.nodes() if n["is_head"] and n["state"] == "ALIVE"]

    def gpu_node():
        alive = [n for n in rt.nodes() if n["state"] == "ALIVE" and not n["is_head"]
                 and n["resources"]["total"].get("GPU") == 1]
        return alive[0] if alive else None

    if gpu_node() is not None:
        raise AssertionError(f"a GPU node is up before any demand: {rt.nodes()}")
    t_demand = time.perf_counter()
    actor = rt.remote(num_gpus=1)(JobFlashActor).remote()
    node = _wait_for(gpu_node, "the monitor to launch gpu_node", 120)
    t_alive = time.perf_counter()
    rt.wait_actor_ready(actor, timeout=120)
    t_ready = time.perf_counter()
    out = rt.get(actor.run.remote(), timeout=300)
    rt.kill(actor)
    t_idle = time.perf_counter()
    _wait_for(lambda: not any(n["node_id"] == node["node_id"] and n["state"] == "ALIVE"
                              for n in rt.nodes()),
              "the idle gpu_node to be reaped", LAUNCHER_IDLE_TIMEOUT_S + LAUNCHER_REAP_MARGIN_S)
    t_reaped = time.perf_counter()
    out.update({"head_node_ids": head, "gpu_node_id": node["node_id"],
                "gpu_node_resources": node["resources"]["total"],
                "demand_to_alive_s": t_alive - t_demand, "alive_to_ready_s": t_ready - t_alive,
                "idle_to_reaped_s": t_reaped - t_idle,
                "driver_cuda_initialized": torch.cuda.is_initialized()})
    print("LAUNCHER_RESULT " + json.dumps(out), flush=True)
    rt.shutdown()


def _procs_naming(text: str) -> list:
    """``pid cmd`` of every process whose command line holds ``text``."""
    out = subprocess.run(["ps", "-eo", "pid,args"], capture_output=True, text=True, check=True)
    return [l.strip() for l in out.stdout.splitlines()[1:]
            if text in l and str(os.getpid()) != l.split()[0] and "ps -eo" not in l]


def _kill_procs_naming(text: str):
    import signal

    for line in _procs_naming(text):
        try:
            os.kill(int(line.split()[0]), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def _controller_pid(text: str) -> int:
    rows = [l for l in _procs_naming(text) if "ray_tpu_torch.core.controller" in l]
    if len(rows) != 1:
        raise AssertionError(f"expected one controller naming {text}: {rows}")
    return int(rows[0].split()[0])


def _cli(args, cwd: str, timeout: float = 300):
    """``python -m ray_tpu_torch.scripts.cli ARGS`` and its seconds; fails
    on a nonzero exit."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args], cwd=cwd,
                       env=dict(os.environ), capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"ray-tpu-torch {' '.join(args)}: exit {r.returncode}\n"
                             f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return r.stdout, seconds


def _gpu_status(stdout: str) -> list:
    return [l.strip() for l in stdout.splitlines() if l.strip().startswith("GPU:")]


def _cli_one_node(smi: str, root: str, tmp: str, direct: dict) -> dict:
    """Part (a) of the CLI phase: one node started by the CLI."""
    import glob

    import chip_smoke as this  # the module the actors' workers import
    import ray_tpu_torch as rt

    cfg = train_config("full")
    res = {}
    out, res["start_s"] = _cli(["start", "--head", "--num-cpus", "4"], root)
    if "started head at" not in out:
        raise AssertionError(f"start --head: {out}")
    status, res["status_s"] = _cli(["status"], root)
    res["start_to_status_s"] = res["start_s"] + res["status_s"]
    if _gpu_status(status) != ["GPU: 1/1 available"]:
        raise AssertionError(f"start --head without --num-gpus must advertise the card:\n{status}")

    # (a)2: a job through `submit` trains the flagship from a num_gpus=1 actor
    entry = [sys.executable, "chip_smoke.py", "--cli-job"]
    out, res["submit_to_succeeded_s"] = _cli(["submit", "--timeout", "900", "--", *entry], root,
                                             timeout=960)
    lines = [l for l in out.splitlines() if l.startswith("CLI_JOB_RESULT ")]
    done = [l for l in out.splitlines() if l.startswith("job ") and l.endswith(": SUCCEEDED")]
    if len(lines) != 1 or len(done) != 1:
        raise AssertionError(f"submit: no SUCCEEDED job with one CLI_JOB_RESULT line:\n{out}")
    job = json.loads(lines[0][len("CLI_JOB_RESULT "):])
    res["job"] = job
    bare = direct["losses"][:CLI_JOB_STEPS]
    if job["losses"] != bare:
        raise AssertionError(f"CLI job losses {job['losses']} are not the bare training phase's "
                             f"{bare} to the bit")
    want = no_general({"fwd": 2 * cfg.n_layers * CLI_JOB_STEPS, "dq": cfg.n_layers * CLI_JOB_STEPS,
                       "dkv": cfg.n_layers * CLI_JOB_STEPS})
    if job["launches"] != want:
        raise AssertionError(f"CLI job launches {job['launches']} != {want}")
    if (job["cuda_visible_devices"] != _card_id() or job["foreign_modules"]
            or job["driver"]["cuda_initialized"]):
        raise AssertionError(f"CLI job: the actor's card, foreign modules or CUDA in the job's "
                             f"driver: {job}")
    def gpu_free():
        out = _cli(["status"], root)[0]
        return out if _gpu_status(out) == ["GPU: 1/1 available"] else None

    status = _wait_for(gpu_free, "`status` to show the GPU free after the job", 60)
    res["gpu_free_after_job"] = _gpu_status(status)
    controller = _controller_pid(tmp)
    if _maps_libcuda(controller):
        raise AssertionError("the CLI's head controller maps libcuda")
    log(f"[cli] job on {smi}: steps {job['step_ms']} ms, tokens/s {job['tokens_per_s']} (bare "
        f"full step: {direct['step_ms_mean']} ms mean, {direct['tokens_per_s']} tokens/s); "
        f"losses {job['losses']} equal the bare run's; launches {job['launches']}")

    # (a)3: `profile device` while a num_gpus=1 actor loops the forward
    rt.init(address="auto")
    try:
        looper = rt.remote(num_gpus=1)(this.CliLoopActor).remote()
        started = rt.get(looper.start.remote(), timeout=300)
        # The loop runs until the CLI has returned: past its start (a fresh
        # process), each worker's start of its capture (the profiler's
        # set-up, up to START_TIMEOUT_S), the capture and its stop.
        stop_file = os.path.join(tmp, "stop-loop")
        looping = looper.loop.remote(CLI_PROFILE_S + 150, stop_file)
        time.sleep(1)
        out, res["profile_s"] = _cli(["profile", "device", "--duration", str(CLI_PROFILE_S)],
                                     root, timeout=240)
        open(stop_file, "w").close()
        stopped = rt.get(looping, timeout=120)
        rt.kill(looper)
    finally:
        rt.shutdown()
    dirs = [l.split(": ", 1)[1].strip() for l in out.splitlines()
            if l.startswith("  worker:") and ": FAILED" not in l]
    kernels = {}
    for path in (p for d in dirs for p in glob.glob(os.path.join(d, "*.trace.json"))):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        for e in events:
            if e.get("cat") == "kernel" and "flash_fwd" in e.get("name", ""):
                kernels[e["name"][:80]] = kernels.get(e["name"][:80], 0) + 1
    res["profile"] = {"captures": len(dirs), "flash_fwd_kernel_events": kernels,
                      "failed": [l.strip() for l in out.splitlines() if ": FAILED" in l],
                      "loop": {**started, **stopped}}
    if not kernels or not stopped["iterations"]:
        raise AssertionError(f"profile device: no flash_fwd kernel in the captures {dirs}: "
                             f"{res['profile']}\n{out}")
    if res["profile"]["failed"]:
        raise AssertionError(f"profile device: a worker's capture did not start (ROADMAP C4): "
                             f"{res['profile']}\n{out}")
    if _maps_libcuda(controller):
        raise AssertionError("the CLI's head controller maps libcuda after the capture")
    log(f"[cli] profile device --duration {CLI_PROFILE_S}: {res['profile_s']} s, "
        f"{len(dirs)} capture(s), flash_fwd kernel events {kernels}, failed "
        f"{res['profile']['failed']}, loop {res['profile']['loop']} on {smi}")

    # (a)4: microbenchmark; (a)5: stop
    out, res["microbenchmark_s"] = _cli(["microbenchmark"], root, timeout=300)
    bench = json.loads(out[out.index("{"):])
    res["microbenchmark"] = bench
    if sorted(bench) != ["async_actor_calls_per_s", "put_get_GiB_per_s", "sync_actor_calls_per_s",
                         "tasks_per_s"] or not all(v > 0 for v in bench.values()):
        raise AssertionError(f"microbenchmark: {bench}")
    out, res["stop_s"] = _cli(["stop"], root)
    if "cluster stopped" not in out:
        raise AssertionError(f"stop: {out}")
    _wait_for(lambda: not _procs_naming(tmp), "every process of the CLI's cluster to exit", 30)
    log(f"[cli] microbenchmark on {smi}: {json.dumps(bench)}")
    return res


def _launcher(smi: str, tmp: str) -> dict:
    """Part (b) of the CLI phase: ``up`` / ``exec`` / ``down`` with the
    autoscaler on the fake provider."""
    from ray_tpu_torch.autoscaler import commands

    res = {}
    t0 = time.perf_counter()
    state = commands.create_or_update_cluster(dict(LAUNCHER_CLUSTER))
    res["up_s"] = time.perf_counter() - t0
    try:
        code = "import chip_smoke; chip_smoke.autoscale_driver_main()"
        r = commands.exec_on_cluster(LAUNCHER_CLUSTER["cluster_name"],
                                     [sys.executable, "-c", code], capture=True)
        lines = [l for l in r.stdout.splitlines() if l.startswith("LAUNCHER_RESULT ")]
        if r.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"the autoscaling driver: exit {r.returncode}\n"
                                 f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
        got = json.loads(lines[0][len("LAUNCHER_RESULT "):])
        res["driver"] = got
        if got["gpu_node_id"] in got["head_node_ids"] or got["node_id"] != got["gpu_node_id"]:
            raise AssertionError(f"the actor did not land on the launched gpu_node: {got}")
        if got["launches"] != no_general({"fwd": 1, "dq": 0, "dkv": 0}):
            raise AssertionError(f"autoscaled node launches {got['launches']}: one fwd expected")
        if not got["finite"] or got["o_err"] > O_TOL or got["lse_err"] > LSE_TOL:
            raise AssertionError(f"the autoscaled node's flash_fwd disagrees with its plain "
                                 f"version: {got}")
        if got["cuda_visible_devices"] != _card_id() or got["driver_cuda_initialized"]:
            raise AssertionError(f"the autoscaled actor's card, or CUDA in its driver: {got}")
        for what, pid in (("monitor", state["monitor_pid"]), ("head", state["head_pid"])):
            if not _process_alive(pid) or _maps_libcuda(pid):
                raise AssertionError(f"the launcher's {what} (pid {pid}) is gone or maps libcuda")
    finally:
        t0 = time.perf_counter()
        down = commands.teardown_cluster(LAUNCHER_CLUSTER["cluster_name"])
        res["down_s"] = time.perf_counter() - t0
    _wait_for(lambda: not _procs_naming(state["session_dir"]),
              "the launcher's head, monitor and agents to exit", 30)
    if down.get("teardown_incomplete") or os.path.exists(
            commands.cluster_state_path(LAUNCHER_CLUSTER["cluster_name"])):
        raise AssertionError(f"down left the cluster's record: {down}")
    log(f"[launcher] up {res['up_s']} s; demand to gpu_node ALIVE {got['demand_to_alive_s']} s, "
        f"ALIVE to actor ready {got['alive_to_ready_s']} s, idle to reaped "
        f"{got['idle_to_reaped_s']} s (idle_timeout_s {LAUNCHER_IDLE_TIMEOUT_S}); down "
        f"{res['down_s']} s; flash_fwd o_err {got['o_err']} lse_err {got['lse_err']} on {smi}")
    return res


@timed_phase
def cli_phase(card: str, smi: str, direct: dict) -> dict:
    """The CLI and launcher phase, after ``port_cluster()`` has shut down,
    under a ``RAY_TPU_TORCH_TMPDIR`` and ``HOME`` of its own (the CLI's
    address file and ``~/.ray_tpu_torch/clusters`` clash with nothing);
    ``direct`` is the bare training phase's "full" run the CLI job is held
    to."""
    import shutil
    import tempfile

    import chip_smoke as this
    from ray_tpu_torch import config as rt_config

    root = os.path.dirname(os.path.abspath(this.__file__))
    tmp = tempfile.mkdtemp(prefix="rt_cli_")
    saved_env = {k: os.environ.get(k) for k in ("RAY_TPU_TORCH_TMPDIR", "HOME", "PYTHONPATH")}
    saved_cfg = rt_config.get_config()
    os.environ["RAY_TPU_TORCH_TMPDIR"] = os.path.join(tmp, "rt")
    os.environ["HOME"] = os.path.join(tmp, "home")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (root, saved_env["PYTHONPATH"]) if p)
    os.makedirs(os.environ["HOME"])
    rt_config.set_config(rt_config.Config.from_env())
    result = {"card": smi}
    try:
        result["cli"] = _cli_one_node(smi, root, tmp, direct)
        result["launcher"] = _launcher(smi, tmp)
    finally:
        _kill_procs_naming(tmp)  # only after a failure does anything remain
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        rt_config.set_config(saved_cfg)
        shutil.rmtree(tmp, ignore_errors=True)
    job = result["cli"]["job"]
    result["bare_training_phase"] = {k: direct[k] for k in ("step_ms_mean", "tokens_per_s")}
    result["job_launches"] = {k: job["launches"][k] for k in ("fwd", "dq", "dkv")}
    result["autoscaled_node_launches"] = {k: result["launcher"]["driver"]["launches"][k]
                                          for k in ("fwd", "dq", "dkv")}
    log(f"[cli] CLI and launcher on {smi}: " + json.dumps(result, default=str))
    return result


# --- phase 12: RLlib on the runtime ------------------------------------------
# The shape of bench.py's _bench_rl_ppo_cpu: 4 CPU runners x 2 envs,
# fragment 256, batch 2048 in minibatches of 256 for 4 epochs, lr 1e-3, the
# KL early-stop off (kl_target 10), seed 0; one warm-up and 6 timed
# iterations, one podracer runner killed at iteration 3.
RL_RUNNERS, RL_ENVS_PER_RUNNER, RL_FRAGMENT = 4, 2, 256
RL_BATCH, RL_MINIBATCH, RL_EPOCHS, RL_LR, RL_SEED = 2048, 256, 4, 1e-3, 0
RL_ITERS, RL_KILL_AT, RL_IMPALA_ITERS, RL_RESTART_WAIT_S = 6, 3, 3, 15
RL_VTRACE_TOL = 1e-5  # the builder on the card against the CPU, fp32 (atol and rtol)
RL_WEIGHT_TOL = 1e-6  # the num_gpus=1 learner actor against the local learner


class NumpyCartPole:
    """CartPole-v1 in numpy, for a machine without gymnasium: gymnasium
    1.2.2's constants and arithmetic (gravity 9.8, cart 1.0, pole 0.1,
    half-length 0.5, force 10, tau 0.02, Euler integration), termination
    past 12 degrees or 2.4, truncation at 500 steps (gym.make's TimeLimit),
    and resets drawn from ``np.random.default_rng(seed)`` as gymnasium's
    ``np_random`` draws them. ``tests/test_torch_rllib_runner.py`` holds it
    to ``gym.make("CartPole-v1")`` step for step."""

    gravity, masscart, masspole, length, force_mag, tau = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
    total_mass = masspole + masscart
    polemass_length = masspole * length
    theta_threshold_radians = 12 * 2 * math.pi / 360
    x_threshold = 2.4
    max_episode_steps = 500

    def __init__(self):
        from types import SimpleNamespace

        self.observation_space = SimpleNamespace(shape=(4,))
        self.action_space = SimpleNamespace(n=2)
        self._rng = None
        self.state = None
        self._steps = 0
        self._steps_beyond_terminated = None

    def reset(self, *, seed=None, options=None):
        import numpy as np

        if seed is not None or self._rng is None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(low=-0.05, high=0.05, size=(4,))
        self._steps = 0
        self._steps_beyond_terminated = None
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        import numpy as np

        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot) * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold_radians
                          or theta > self.theta_threshold_radians)
        if not terminated:
            reward = 1.0
        elif self._steps_beyond_terminated is None:
            self._steps_beyond_terminated = 0
            reward = 1.0
        else:
            self._steps_beyond_terminated += 1
            reward = 0.0
        self._steps += 1
        truncated = self._steps >= self.max_episode_steps
        return np.array(self.state, dtype=np.float32), reward, terminated, truncated, {}

    def close(self):
        pass


def rl_env():
    """("CartPole-v1", label) when gymnasium imports (nothing is
    installed), else (NumpyCartPole, label)."""
    try:
        import gymnasium
    except ImportError:
        return NumpyCartPole, "NumpyCartPole of chip_smoke.py (no gymnasium on this machine)"
    return "CartPole-v1", f"gymnasium {gymnasium.__version__} CartPole-v1"


def _torch_alone_maps_libcuda() -> bool:
    """Whether a fresh interpreter that only imports torch maps libcuda on
    this machine (a CUDA build may load the driver library at import)."""
    code = "import torch\nwith open('/proc/self/maps') as f:\n    print(any('libcuda.so' in l for l in f))"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=120).stdout.strip()
    return out == "True"


def _runner_cuda_state(runner) -> dict:
    """Run on a runner actor (``_call_fn``): its pid and whether torch has
    initialized CUDA there."""
    return {"pid": os.getpid(), "cuda_initialized": torch.cuda.is_initialized()}


def _no_cuda_in_runners(handles, what: str, torch_maps: bool) -> list:
    """Every runner process: no CUDA initialized by torch, and no libcuda
    mapped (read from ``/proc/<pid>/maps``) beyond what importing torch
    alone maps on this machine (``torch_maps``)."""
    import ray_tpu_torch as rt

    rows = rt.get([h._call_fn(_runner_cuda_state) for h in handles], timeout=60)
    for row in rows:
        row["libcuda_mapped"] = _maps_libcuda(row["pid"])
    assert not any(r["cuda_initialized"] for r in rows), f"{what}: CUDA in a runner: {rows}"
    assert torch_maps or not any(r["libcuda_mapped"] for r in rows), (
        f"{what}: a runner maps libcuda, which importing torch alone does not: {rows}")
    return rows


def _weights_on_cpu(algo, what: str):
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    state = algo.learner_group.get_state()
    tensors = tree_leaves(algo.learner_group.get_weights()) + tree_leaves(state["params"])
    tensors += [v for s in state["opt_state"]["state"].values() for v in s.values()
                if isinstance(v, torch.Tensor)]
    devices = {t.device.type for t in tensors}
    assert devices == {"cpu"}, f"{what}: returned weights on {devices}"


def _check_result(r: dict, what: str):
    assert math.isfinite(r["learner/loss"]), f"{what}: loss {r['learner/loss']}"
    ret = r["episode_return_mean"]
    assert isinstance(ret, float) and math.isfinite(ret), f"{what}: return {ret!r}"


def _time_calls(obj, names, acc: dict):
    """Wrap ``obj.<name>`` for each name so each call's wall seconds are
    appended to ``acc[name]`` (where an iteration's time goes)."""
    for name in names:
        def wrapped(*a, _fn=getattr(obj, name), _name=name, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                acc.setdefault(_name, []).append(time.perf_counter() - t)
        setattr(obj, name, wrapped)


def _record_fragments(pr, seen: list):
    """Note (runner, sampled-at, env steps) of every fragment the learner
    pulls from the podracer's queue."""
    get_batch = pr._queue.get_batch

    def wrapped(*a, **kw):
        records, info = get_batch(*a, **kw)
        seen.extend((r["runner_index"], r["ts_sampled"], r["env_steps"]) for r in records)
        return records, info

    pr._queue.get_batch = wrapped


def _podracer_breakdown(algo, acc: dict, wall_s: float, fragments: list) -> dict:
    """Seconds in the learner loop's parts, the pipeline's counters, and the
    median time between two fragments of one runner."""
    import statistics

    stats = algo._podracer.stats
    gaps = []
    for runner in {f[0] for f in fragments}:
        ts = sorted(f[1] for f in fragments if f[0] == runner)
        gaps += [b - a for a, b in zip(ts, ts[1:])]
    return {"wall_s": wall_s, **{f"{k}_s": sum(v) for k, v in acc.items()},
            "fragments_pulled": len(fragments),
            "fragment_env_steps_mean": sum(f[2] for f in fragments) / max(1, len(fragments)),
            "runner_fragment_gap_s_median": statistics.median(gaps) if gaps else None,
            **{k: stats[k] for k in ("fragments_lost", "fragments_dropped_stale",
                                     "max_policy_lag_seen", "runner_restarts")}}


def _timed_iterations(algo, n: int, kill_at=None):
    """Env steps per second over ``n`` iterations (after the caller's
    warm-up); with ``kill_at``, podracer runner 0 is killed before that
    iteration."""
    import ray_tpu_torch as rt

    steps, results = 0, []
    t0 = time.perf_counter()
    for i in range(n):
        if kill_at is not None and i == kill_at:
            rt.kill(algo._podracer.manager.actors[0])
        r = algo.train()
        _check_result(r, f"iteration {i}")
        steps += r["env_steps_this_iter"]
        results.append(r)
    return steps / (time.perf_counter() - t0), results


@timed_phase
def rl_phase(card: str, smi: str) -> dict:
    """PPO (synchronous, then the podracer with a runner killed mid-run) and
    IMPALA (podracer) train CartPole from CPU runner actors with the learner
    on the card; then a ``num_gpus=1`` learner actor against the local
    learner. Gates: no runner initializes CUDA or maps libcuda beyond what
    importing torch alone maps, every returned weight is on the CPU, losses
    are finite, ``episode_return_mean`` is a number."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig
    from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
    from ray_tpu_torch.rllib.podracer import VtraceBatchBuilder
    from ray_tpu_torch.rllib.ppo import ppo_loss
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    assert not torch.backends.cuda.matmul.allow_tf32, "fp32 matmuls must run in fp32"
    env, env_label = rl_env()
    log(f"[rl] env: {env_label}")
    shape = (f"{RL_RUNNERS} runners x {RL_ENVS_PER_RUNNER} envs, fragment {RL_FRAGMENT}, "
             f"batch {RL_BATCH}, minibatch {RL_MINIBATCH}, {RL_EPOCHS} epochs, MLP 64x64")
    torch_maps = _torch_alone_maps_libcuda()
    result = {"env": env_label, "shape": shape, "card": smi,
              "import_torch_alone_maps_libcuda": torch_maps}
    log(f"[rl] a fresh interpreter that imports torch maps libcuda: {torch_maps}")

    def ppo_config():
        return (PPOConfig().environment(env)
                .training(train_batch_size=RL_BATCH, minibatch_size=RL_MINIBATCH,
                          num_epochs=RL_EPOCHS, lr=RL_LR, kl_target=10.0)
                .debugging(seed=RL_SEED))

    # --- (a) synchronous PPO, the learner on the card ----------------------
    t_arm = time.perf_counter()
    cfg = ppo_config().env_runners(num_env_runners=RL_RUNNERS,
                                   num_envs_per_env_runner=RL_ENVS_PER_RUNNER,
                                   rollout_fragment_length=RL_FRAGMENT)
    t0 = time.perf_counter()
    algo = cfg.build()  # returns once every runner took the first weights
    spawn_s = time.perf_counter() - t0
    runners = list(algo.env_runner_group._manager.actors.values())
    try:
        assert rt.get([a.ping.remote() for a in runners], timeout=60) == ["pong"] * RL_RUNNERS
        assert algo.env_runner_group.num_restarts == 0, "a runner failed to build its env"
        learner = algo.learner_group._local
        assert learner.device.type == "cuda", learner.device
        update, timings, seen = learner.update_from_batch, [], []

        def timed_update(batch):
            t = time.perf_counter()
            out = update(batch)
            timings.append((time.perf_counter() - t) * 1e3)
            seen.append(batch)
            return out

        learner.update_from_batch = timed_update
        _check_result(algo.train(), "warm-up")
        n_warm = len(timings)
        rate, results = _timed_iterations(algo, RL_ITERS)
        result["runners_sync"] = _no_cuda_in_runners(runners, "sync runners", torch_maps)
        _weights_on_cpu(algo, "sync PPO")
        per_iter = RL_EPOCHS * -(-RL_BATCH // RL_MINIBATCH)  # the KL early-stop is off
        assert len(timings) - n_warm == RL_ITERS * per_iter, (len(timings), n_warm)
        card_ms = timings[n_warm:]  # the timed iterations' minibatches
        # The same minibatches of the last iteration, replayed from one state
        # on the card and on the CPU, in this process.
        replay = seen[-per_iter:]
        state0 = algo.learner_group.get_state()
        twins = {}
        for dev in ("cuda", "cpu"):
            twin = Learner(algo.module_spec, ppo_loss, algo._loss_cfg(), lr=RL_LR,
                           grad_clip=cfg.grad_clip, seed=RL_SEED, device=dev)
            twin.set_state(state0)
            twin.update_from_batch(replay[0])  # warm-up (allocator, kernels)
            twin.set_state(state0)
            ms, losses = [], []
            for b in replay:
                t = time.perf_counter()
                losses.append(twin.update_from_batch(b)["loss"])
                ms.append((time.perf_counter() - t) * 1e3)
            twins[dev] = {"mean_ms": sum(ms) / len(ms), "min_ms": min(ms), "losses": losses}
        first_diff = abs(twins["cuda"]["losses"][0] - twins["cpu"]["losses"][0]) / abs(
            twins["cpu"]["losses"][0])
        assert first_diff < 1e-4, f"card and CPU learners disagree on one update: {first_diff}"
        result["sync"] = {
            "env_steps_per_s": rate, "runner_spawn_s": spawn_s,
            "learner_minibatch_ms_mean": sum(card_ms) / len(card_ms),
            "learner_minibatch_ms_min": min(card_ms), "minibatches": len(card_ms),
            "replay_minibatches": len(replay),
            "replay_card_ms_mean": twins["cuda"]["mean_ms"],
            "replay_card_ms_min": twins["cuda"]["min_ms"],
            "replay_cpu_ms_mean": twins["cpu"]["mean_ms"],
            "replay_cpu_ms_min": twins["cpu"]["min_ms"],
            "cpu_threads": torch.get_num_threads(),
            "replay_first_loss_rel_diff": first_diff,
            "episode_return_mean": results[-1]["episode_return_mean"],
            "losses": [r["learner/loss"] for r in results],
        }
    finally:
        algo.stop()
        for a in runners:  # Algorithm.stop leaves the sync runners alive
            rt.kill(a)
    result["sync"]["arm_s"] = time.perf_counter() - t_arm
    log(f"[rl] (a) sync PPO on {smi}: " + json.dumps(result["sync"]))
    t_arm = time.perf_counter()

    # --- (b) podracer PPO, runner 0 killed at iteration 3 ------------------
    cfg = ppo_config().env_runners(num_envs_per_env_runner=RL_ENVS_PER_RUNNER,
                                   rollout_fragment_length=RL_FRAGMENT).podracer(
        num_async_runners=RL_RUNNERS, sample_queue_size=16)
    t0 = time.perf_counter()
    algo = cfg.build()
    build_s = time.perf_counter() - t0
    try:
        pr = algo._podracer
        _check_result(algo.train(), "warm-up")
        acc, fragments = {}, []
        _record_fragments(pr, fragments)
        _time_calls(pr, ("pull_min", "publish"), acc)
        _time_calls(algo._batch_builder(), ("build",), acc)
        _time_calls(algo.learner_group._local, ("update_from_batch",), acc)
        t0 = time.perf_counter()
        rate, results = _timed_iterations(algo, RL_ITERS, kill_at=RL_KILL_AT)
        breakdown = _podracer_breakdown(algo, acc, time.perf_counter() - t0, fragments)
        deadline = time.time() + RL_RESTART_WAIT_S
        while pr.num_restarts == 0 and time.time() < deadline:
            pr.check_runners()
            time.sleep(0.25)
        assert pr.num_restarts >= 1, f"no runner restart within {RL_RESTART_WAIT_S} s"
        live = list(pr.manager.actors.values())
        result["runners_podracer"] = _no_cuda_in_runners(live, "podracer runners", torch_maps)
        _weights_on_cpu(algo, "podracer PPO")
        result["podracer"] = {
            "env_steps_per_s": rate, "speedup_over_sync": rate / result["sync"]["env_steps_per_s"],
            "runner_restarts": pr.num_restarts, "build_s": build_s,
            "episode_return_mean": results[-1]["episode_return_mean"],
            "weights_version": results[-1]["podracer/weights_version"],
            "time": breakdown,
        }
    finally:
        algo.stop()
    result["podracer"]["arm_s"] = time.perf_counter() - t_arm
    log(f"[rl] (b) podracer PPO on {smi}: " + json.dumps(result["podracer"]))
    t_arm = time.perf_counter()

    # --- (c) IMPALA through the podracer; its V-trace builder on the card --
    cfg = (IMPALAConfig().environment(env)
           .env_runners(num_envs_per_env_runner=RL_ENVS_PER_RUNNER,
                        rollout_fragment_length=RL_FRAGMENT)
           .training(train_batch_size=RL_BATCH, lr=RL_LR)
           .podracer(num_async_runners=RL_RUNNERS, sample_queue_size=16)
           .debugging(seed=RL_SEED))
    algo = cfg.build()
    try:
        _check_result(algo.train(), "IMPALA warm-up")  # the runners' spawn ends in it
        acc, fragments = {}, []
        _record_fragments(algo._podracer, fragments)
        _time_calls(algo._podracer, ("pull_min", "publish"), acc)
        _time_calls(algo._batch_builder(), ("build",), acc)
        _time_calls(algo.learner_group._local, ("update_from_batch",), acc)
        t0 = time.perf_counter()
        steps = 0
        for i in range(RL_IMPALA_ITERS):
            r = algo.train()
            _check_result(r, f"IMPALA iteration {i}")
            steps += r["env_steps_this_iter"]
        rate = steps / (time.perf_counter() - t0)
        breakdown = _podracer_breakdown(algo, acc, time.perf_counter() - t0, fragments)
        result["runners_impala"] = _no_cuda_in_runners(
            list(algo._podracer.manager.actors.values()), "IMPALA runners", torch_maps)
        _weights_on_cpu(algo, "IMPALA")
        builder = algo._batch_builder()
        assert builder.device.type == "cuda", builder.device
        episodes = algo.env_runner_group.local_runner.sample(RL_BATCH)
        weights = algo.learner_group.get_weights()
        kw = algo._podracer_builder_kwargs()
        cpu_builder = VtraceBatchBuilder(builder._module, device="cpu")
        built = {}
        for name, b in (("card", builder), ("cpu", cpu_builder)):
            b.build(weights, episodes, **kw)  # warm-up
            t = time.perf_counter()
            built[name] = b.build(weights, episodes, **kw)
            built[name + "_ms"] = (time.perf_counter() - t) * 1e3
        errs = {}
        for k, want in built["cpu"].items():
            got = built["card"][k]
            np.testing.assert_allclose(got, want, atol=RL_VTRACE_TOL, rtol=RL_VTRACE_TOL,
                                       err_msg=f"V-trace builder field {k}")
            errs[k] = float(np.abs(got - want).max())
        result["impala"] = {
            "env_steps_per_s": rate, "iterations": RL_IMPALA_ITERS,
            "weights_version": r["podracer/weights_version"],
            "vtrace_rows": len(built["cpu"]["obs"]), "vtrace_max_abs_diff": errs,
            "vtrace_build_card_ms": built["card_ms"], "vtrace_build_cpu_ms": built["cpu_ms"],
            "loss": r["learner/loss"], "time": breakdown,
        }
    finally:
        algo.stop()
    result["impala"]["arm_s"] = time.perf_counter() - t_arm
    log(f"[rl] (c) IMPALA podracer on {smi}: " + json.dumps(result["impala"]))
    t_arm = time.perf_counter()

    # --- (d) a num_gpus=1 learner actor against the local learner ----------
    spec = algo.module_spec
    rng = np.random.default_rng(RL_SEED)
    batch = {
        "obs": rng.normal(size=(RL_MINIBATCH, spec.observation_dim)).astype(np.float32),
        "actions": rng.integers(0, spec.action_dim, RL_MINIBATCH).astype(np.int32),
        "logp_old": np.full(RL_MINIBATCH, -0.69, np.float32),
        "advantages": rng.normal(size=RL_MINIBATCH).astype(np.float32),
        "returns": rng.normal(size=RL_MINIBATCH).astype(np.float32),
        "values_old": np.zeros(RL_MINIBATCH, np.float32),
    }
    local = LearnerGroup(spec, ppo_loss, lr=RL_LR, seed=RL_SEED, learner_device="cuda")
    t0 = time.perf_counter()
    remote = LearnerGroup(spec, ppo_loss, num_learners=1, lr=RL_LR, seed=RL_SEED,
                          num_gpus_per_learner=1)
    actor_spawn_s = time.perf_counter() - t0
    try:
        _wait_for(lambda: rt.available_resources().get("GPU", 0) == 0,
                  "the learner actor to hold the GPU", 10)
        for _ in range(3):
            local.update_from_batch(batch)
            mr = remote.update_from_batch(batch)
            assert math.isfinite(mr["loss"]), mr
        wl, wr = tree_leaves(local.get_weights()), tree_leaves(remote.get_weights())
        assert {t.device.type for t in wl + wr} == {"cpu"}
        diff = max(float((a - b).abs().max()) for a, b in zip(wl, wr))
        assert diff <= RL_WEIGHT_TOL, f"learner actor vs local learner: {diff} > {RL_WEIGHT_TOL}"
    finally:
        remote.shutdown()
    _wait_for(lambda: rt.available_resources().get("GPU", 0) == 1,
              "the GPU resource to come back after the learner actor's shutdown", 60)
    result["learner_actor"] = {"max_abs_weight_diff": diff, "spawn_s": actor_spawn_s,
                               "loss": mr["loss"], "gpu_back_after_shutdown": True,
                               "arm_s": time.perf_counter() - t_arm}
    log(f"[rl] (d) num_gpus=1 learner actor on {smi}: " + json.dumps(result["learner_actor"]))
    return result


# --- phase 13: RLlib's off-policy and offline stack on the runtime ----------
# DQN at the reference's own learning config (tests/test_rllib.py:300-315):
# 4 envs (here 2 CPU runner actors x 2), fragment 32, batch 64, buffer
# 20,000, learning_starts 1,000, 32 updates an iteration, a target sync
# every 100 updates, epsilon decayed over 5,000 env steps, lr 1e-3,
# prioritized replay, 64x64 heads, seed 0. SAC at the reference's smoke
# config (tests/test_rllib.py:327-345), from one runner actor with 2 envs.
# CQL (tests/test_rllib_appo_cql.py:100-118) and BC/MARWIL
# (tests/test_rllib.py:376-389) at their tests' configs, from 20 episodes of
# the scripted expert (tests/test_rllib.py:350) on NumpyCartPole.
OFF_RUNNERS, OFF_ENVS_PER_RUNNER, OFF_FRAGMENT = 2, 2, 32
OFF_TARGET_SYNCS = 2  # timed iterations run until at least this many target syncs
SAC_ITERS, CQL_ITERS, BC_ITERS, BC_MIN_RETURN = 6, 4, 8, 60
OFF_EXPERT_EPISODES = 20
OFF_CARD_CPU_REL_TOL = 1e-5  # one update's loss, the card's against a CPU learner's (fp32)


def expert_episodes(n: int, random_every: int = 0) -> list:
    """``n`` episodes of the scripted CartPole expert (act = obs[2] + 0.5 *
    obs[3] > 0, tests/test_rllib.py:350) on ``NumpyCartPole``, reset with
    seeds 0..n-1; with ``random_every``, every such episode acts at random
    instead (from a seeded numpy generator), as the reference's CQL test
    mixes its data (tests/test_rllib_appo_cql.py:71)."""
    import numpy as np

    from ray_tpu_torch.rllib import SingleAgentEpisode

    env, rng = NumpyCartPole(), np.random.default_rng(0)
    episodes = []
    for e in range(n):
        obs, _ = env.reset(seed=e)
        ep = SingleAgentEpisode(observations=[obs])
        done = False
        while not done:
            if random_every and e % random_every == 0:
                act = int(rng.integers(2))
            else:
                act = int(obs[2] + 0.5 * obs[3] > 0)
            obs, rew, term, trunc, _ = env.step(act)
            ep.actions.append(act)
            ep.rewards.append(float(rew))
            ep.logps.append(0.0)
            ep.values.append(0.0)
            ep.observations.append(obs)
            done = term or trunc
        ep.terminated = term
        episodes.append(ep)
    return episodes


def _mean_ms(seconds: list):
    return sum(seconds) / len(seconds) * 1e3 if seconds else None


def _first_update_against_cpu(algo, loss_fn, what: str) -> dict:
    """Record the card learner's first update (its state before it, its
    minibatch and its metrics), then run that update from that state on a
    CPU learner in this process: the losses must agree to
    ``OFF_CARD_CPU_REL_TOL``."""
    from ray_tpu_torch.rllib.learner import Learner

    group = algo.learner_group
    first = {}
    update = group.update_from_batch

    def recorded(batch):
        if not first:
            first["state"] = group.get_state()
            first["batch"] = {k: v.copy() for k, v in batch.items()}
            out = update(batch)
            first["metrics"] = dict(out)
            return out
        return update(batch)

    group.update_from_batch = recorded

    def check() -> dict:
        assert first, f"{what}: no learner update ran"
        cpu = Learner(algo.module_spec, loss_fn, algo._loss_cfg(), lr=algo.config.lr,
                      grad_clip=algo.config.grad_clip, seed=algo.config.seed, device="cpu")
        cpu.set_state(first["state"])
        mc = cpu.update_from_batch(first["batch"])
        card_loss = first["metrics"]["loss"]
        diff = abs(card_loss - mc["loss"]) / max(abs(mc["loss"]), 1e-12)
        assert diff <= OFF_CARD_CPU_REL_TOL, (
            f"{what}: the card's first update's loss {card_loss} vs the CPU's {mc['loss']}: "
            f"{diff} > {OFF_CARD_CPU_REL_TOL}")
        return {"first_loss_card": card_loss, "first_loss_cpu": mc["loss"],
                "first_loss_rel_diff": diff}

    return check


@timed_phase
def rl_offpolicy_phase(card: str, smi: str) -> dict:
    """DQN with prioritized replay and SAC train CartPole from CPU runner
    actors with the learner on the card; CQL, BC and MARWIL train offline
    on the card from the scripted expert's episodes. Gates: finite losses,
    every returned weight and Adam moment on the CPU, no runner with CUDA,
    each card learner's update against a CPU learner's, DQN's ε decayed,
    its priorities moved and its target equal to its Q net right after
    each sync, SAC's temperature and Q finite, CQL's penalty >= 0, BC's
    and MARWIL's greedy return >= 60."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import BCConfig, CQLConfig, DQNConfig, MARWILConfig, SACConfig
    from ray_tpu_torch.rllib.cql import cql_loss
    from ray_tpu_torch.rllib.dqn import dqn_loss
    from ray_tpu_torch.rllib.learner import Learner
    from ray_tpu_torch.rllib.offline import marwil_loss
    from ray_tpu_torch.rllib.sac import sac_loss

    assert not torch.backends.cuda.matmul.allow_tf32, "fp32 matmuls must run in fp32"
    env, env_label = rl_env()
    torch_maps = _torch_alone_maps_libcuda()
    result = {"env": env_label, "card": smi}
    t_arm = time.perf_counter()

    # --- (a) DQN, prioritized replay, the learner on the card ---------------
    cfg = (DQNConfig().environment(env)
           .env_runners(num_env_runners=OFF_RUNNERS, num_envs_per_env_runner=OFF_ENVS_PER_RUNNER,
                        rollout_fragment_length=OFF_FRAGMENT)
           .training(train_batch_size=64, lr=1e-3, buffer_size=20000, learning_starts=1000,
                     num_updates_per_iter=32, target_update_freq=100, epsilon_decay_steps=5000,
                     prioritized_replay=True)
           .debugging(seed=RL_SEED))
    t0 = time.perf_counter()
    algo = cfg.build()  # returns once every runner took the first weights
    spawn_s = time.perf_counter() - t0
    runners = list(algo.env_runner_group._manager.actors.values())
    try:
        assert rt.get([a.ping.remote() for a in runners], timeout=60) == ["pong"] * OFF_RUNNERS
        learner = algo.learner_group._local
        assert learner.device.type == "cuda", learner.device
        r = algo.train()  # warm-up: the buffer fills, no update yet
        assert r["num_learner_updates"] == 0 and r["epsilon"] < cfg.epsilon_initial, r
        calls = {}
        _time_calls(algo.buffer, ("sample", "update_priorities"), calls)
        _time_calls(algo.learner_group, ("update_from_batch",), calls)
        seen = []
        update = algo.learner_group.update_from_batch

        def recorded(batch):
            seen.append(batch)
            return update(batch)

        algo.learner_group.update_from_batch = recorded
        syncs = []
        sync = algo._sync_target

        def checked_sync():
            t = time.perf_counter()
            sync()
            ms = (time.perf_counter() - t) * 1e3
            p = learner.params
            syncs.append({"ms": ms, "equal": all(torch.equal(p["q"][k], p["target"][k])
                                                 for k in p["q"]),
                          "aliased": any(p["q"][k].data_ptr() == p["target"][k].data_ptr()
                                         for k in p["q"])})

        algo._sync_target = checked_sync
        results, iter_s = [], []
        t0 = time.perf_counter()
        while len(syncs) < OFF_TARGET_SYNCS:
            t = time.perf_counter()
            r = algo.train()
            iter_s.append(time.perf_counter() - t)
            if r["num_learner_updates"]:
                assert math.isfinite(r["learner/loss"]), r
            results.append(r)
            assert len(results) < 40, f"DQN: {len(syncs)} target syncs in {len(results)} iterations"
        rate = sum(r["env_steps_this_iter"] for r in results) / (time.perf_counter() - t0)
        learning = [(r["env_steps_this_iter"], s) for r, s in zip(results, iter_s)
                    if "learner/loss" in r]
        learning_rate = sum(n for n, _ in learning) / sum(s for _, s in learning)
        assert all(s["equal"] and not s["aliased"] for s in syncs), syncs
        last = results[-1]
        assert last["epsilon"] < cfg.epsilon_initial, last["epsilon"]
        prios = algo.buffer._prios[: len(algo.buffer)]
        assert np.isfinite(prios).all() and (prios != 1.0).any(), "priorities did not move"
        result["runners_dqn"] = _no_cuda_in_runners(runners, "DQN runners", torch_maps)
        _weights_on_cpu(algo, "DQN")
        n = len(calls["update_from_batch"])
        assert n == last["num_learner_updates"] == len(calls["sample"]), (
            n, last["num_learner_updates"], len(calls["sample"]))
        per = {k: _mean_ms(v) for k, v in calls.items()}
        per_update = per["sample"] + per["update_from_batch"] + per["update_priorities"]
        # The last iteration's minibatches replayed from one state on the card
        # and on the CPU, in this process.
        replay = seen[-cfg.num_updates_per_iter:]
        state0 = algo.learner_group.get_state()
        twins = {}
        for dev in ("cuda", "cpu"):
            twin = Learner(algo.module_spec, dqn_loss, algo._loss_cfg(), lr=cfg.lr,
                           grad_clip=cfg.grad_clip, seed=RL_SEED, device=dev)
            twin.set_state(state0)
            twin.update_from_batch(replay[0])  # warm-up (allocator, kernels)
            twin.set_state(state0)
            ms, losses = [], []
            for b in replay:
                t = time.perf_counter()
                losses.append(twin.update_from_batch(b)["loss"])
                ms.append((time.perf_counter() - t) * 1e3)
            twins[dev] = {"mean_ms": sum(ms) / len(ms), "min_ms": min(ms), "losses": losses}
        first_diff = abs(twins["cuda"]["losses"][0] - twins["cpu"]["losses"][0]) / abs(
            twins["cpu"]["losses"][0])
        assert first_diff <= OFF_CARD_CPU_REL_TOL, (
            f"DQN: card and CPU learners disagree on one update: {first_diff}")
        result["dqn"] = {
            "env_steps_per_s": rate, "env_steps_per_s_learning": learning_rate,
            "runner_spawn_s": spawn_s, "timed_iterations": len(results),
            "learning_iterations": len(learning), "updates": n, "target_syncs": len(syncs),
            "buffer_sample_ms": per["sample"], "update_from_batch_card_ms": per["update_from_batch"],
            "update_priorities_ms": per["update_priorities"],
            "sync_target_ms": sum(s["ms"] for s in syncs) / len(syncs),
            "replay_share_of_update": per["sample"] / per_update,
            "replay_minibatches": len(replay),
            "replay_card_ms_mean": twins["cuda"]["mean_ms"],
            "replay_card_ms_min": twins["cuda"]["min_ms"],
            "replay_cpu_ms_mean": twins["cpu"]["mean_ms"],
            "replay_cpu_ms_min": twins["cpu"]["min_ms"],
            "cpu_threads": torch.get_num_threads(),
            "replay_first_loss_rel_diff": first_diff,
            "epsilon": last["epsilon"], "loss": last["learner/loss"],
            "max_priority": float(algo.buffer._max_prio),
            "episode_return_mean": last["episode_return_mean"],
        }
    finally:
        algo.stop()
        for a in runners:  # Algorithm.stop leaves the sync runners alive
            rt.kill(a)
    result["dqn"]["arm_s"] = time.perf_counter() - t_arm
    log(f"[rl-off] (a) DQN (PER) on {smi}: " + json.dumps(result["dqn"]))
    t_arm = time.perf_counter()

    # --- (b) SAC, the learner on the card ------------------------------------
    cfg = (SACConfig().environment(env)
           .env_runners(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=16)
           .training(train_batch_size=64, learning_starts=100, num_updates_per_iter=8,
                     target_update_freq=20)
           .debugging(seed=RL_SEED))
    t0 = time.perf_counter()
    algo = cfg.build()
    spawn_s = time.perf_counter() - t0
    runners = list(algo.env_runner_group._manager.actors.values())
    try:
        assert algo.learner_group.device.type == "cuda"
        check_first = _first_update_against_cpu(algo, sac_loss, "SAC")
        calls = {}
        _time_calls(algo.learner_group, ("update_from_batch",), calls)
        for _ in range(SAC_ITERS):
            r = algo.train()
        assert r["num_learner_updates"] > 0, r
        for k in ("learner/alpha", "learner/mean_q", "learner/loss"):
            assert math.isfinite(r[k]), (k, r)
        result["runners_sac"] = _no_cuda_in_runners(runners, "SAC runners", torch_maps)
        _weights_on_cpu(algo, "SAC")
        result["sac"] = {"runner_spawn_s": spawn_s, "updates": r["num_learner_updates"],
                         "update_from_batch_card_ms": _mean_ms(calls["update_from_batch"][1:]),
                         "alpha": r["learner/alpha"], "mean_q": r["learner/mean_q"],
                         "loss": r["learner/loss"], **check_first()}
    finally:
        algo.stop()
        for a in runners:
            rt.kill(a)
    result["sac"]["arm_s"] = time.perf_counter() - t_arm
    log(f"[rl-off] (b) SAC on {smi}: " + json.dumps(result["sac"]))
    t_arm = time.perf_counter()

    # --- (c) offline: CQL, BC and MARWIL on the card -------------------------
    def offline(name, config, loss_fn, iters):
        algo = config.build()
        try:
            assert algo.learner_group.device.type == "cuda"
            check_first = _first_update_against_cpu(algo, loss_fn, name)
            t0 = time.perf_counter()
            for _ in range(iters):
                r = algo.train()
            wall = time.perf_counter() - t0
            _weights_on_cpu(algo, name)
            return algo, r, wall, check_first()
        except BaseException:
            algo.stop()
            raise

    cfg = (CQLConfig().environment(env)
           .training(train_batch_size=64, num_updates_per_iter=16, target_update_freq=32,
                     cql_alpha=1.0, lr=3e-4)
           .debugging(seed=RL_SEED)
           .offline_data(expert_episodes(OFF_EXPERT_EPISODES, random_every=3)))
    algo, r, wall, first = offline("CQL", cfg, cql_loss, CQL_ITERS)
    try:
        assert r["num_learner_updates"] == CQL_ITERS * 16, r
        assert math.isfinite(r["learner/cql_penalty"]) and math.isfinite(r["learner/critic_loss"])
        assert r["learner/cql_penalty"] >= 0.0, r["learner/cql_penalty"]
        result["cql"] = {"updates": r["num_learner_updates"],
                         "updates_per_s": r["num_learner_updates"] / wall,
                         "cql_penalty": r["learner/cql_penalty"],
                         "critic_loss": r["learner/critic_loss"], **first}
    finally:
        algo.stop()
    log(f"[rl-off] (c) CQL offline on {smi}: " + json.dumps(result["cql"]))
    episodes = expert_episodes(OFF_EXPERT_EPISODES)
    for name, cfg_cls in (("bc", BCConfig), ("marwil", MARWILConfig)):
        cfg = (cfg_cls().environment(env)
               .training(train_batch_size=256, num_updates_per_iter=32, lr=1e-2)
               .offline_data(episodes=episodes)
               .debugging(seed=RL_SEED))
        algo, r, wall, first = offline(name, cfg, marwil_loss, BC_ITERS)
        try:
            assert math.isfinite(r["learner/loss"]), r
            ret = algo.evaluate(num_episodes=3)
            assert ret >= BC_MIN_RETURN, f"{name} clone too weak: {ret}"
            result[name] = {"updates": BC_ITERS * cfg.num_updates_per_iter,
                            "updates_per_s": BC_ITERS * cfg.num_updates_per_iter / wall,
                            "loss": r["learner/loss"], "greedy_return": ret, **first}
        finally:
            algo.stop()
        log(f"[rl-off] (c) {name} offline on {smi}: " + json.dumps(result[name]))
    result["offline_arm_s"] = time.perf_counter() - t_arm
    return result


# --- phase 14: ViT-B/16 at full width ------------------------------------
# ViTConfig.base16: 224x224x3, patch 16 (196 patches), d_model 768, 12
# layers, 12 heads, d_ff 3072, 1,000 classes; bf16 compute, fp32 params and
# Adam (lr 1e-3, the reference's tests/test_models.py:436), batch 64 of the
# reference's quadrant task (tests/test_models.py:416-450: the class is
# which image quadrant is bright) at 224 pixels.
VIT_BATCH, VIT_WARMUP, VIT_STEPS, VIT_LR, VIT_SEED = 64, 2, 10, 1e-3, 0
# Card bf16 logits against the CPU's fp32 forward of the same weights, max
# |diff| / max |logit|: bf16 keeps 8 significant bits (a relative rounding
# step of 2^-8), each of the 12 layers rounds its matmul inputs and outputs
# to bf16 and adds its difference to the fp32 residual stream, so the
# differences may add up to 12 x 2^-8 = 4.7e-2 (a CPU bf16 forward of
# random ViT-B/16 weights came within 4.1e-3 of fp32).
VIT_LOGITS_REL_TOL = 12 * 2**-8
# remat recomputes each block's forward in the backward with the same
# kernels on the same inputs: the losses should match bit for bit; 1e-3
# relative over the 12 steps leaves room for a non-deterministic
# reduction order in a library kernel.
VIT_REMAT_LOSS_REL_TOL = 1e-3


def quadrant_batch(n: int, size: int, seed: int, device) -> dict:
    """The reference's quadrant task at ``size`` pixels: label q in 0..3 (a
    seeded generator), an NHWC image of zeros whose quadrant q is 1."""
    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, 4, (n,), generator=g)
    images = torch.zeros((n, size, size, 3))
    half = size // 2
    for q in range(4):
        r, c = divmod(q, 2)
        images[labels == q, r * half:(r + 1) * half, c * half:(c + 1) * half, :] = 1.0
    return {"images": images.to(device), "labels": labels.to(device)}


def vit_flops_per_image(cfg) -> float:
    """6 N per patch token (forward and backward over every parameter) plus
    the attention's 12 L d S per token, over S = num_patches tokens."""
    from ray_tpu_torch.models import vit

    S = cfg.num_patches
    return S * (6 * vit.num_params(cfg) + 12 * cfg.n_layers * cfg.d_model * S)


@timed_phase
def vit_phase(card: str, smi: str, profile: bool = False) -> dict:
    """ViT-B/16 at full width on the card: bf16 logits against the CPU's
    fp32 forward of the same weights, then 2 warm-up and 10 timed Adam
    steps at batch 64 (the loss finite and falling), and the same steps
    from the same weights with ``remat=True`` (equal losses). With
    ``profile``, one more step (without remat) under torch.profiler."""
    import dataclasses

    from ray_tpu_torch.models import ViTConfig, vit

    cfg = ViTConfig.base16()
    host = vit.init_params(torch.Generator().manual_seed(VIT_SEED), cfg, device="cpu")
    n_params = sum(t.numel() for t in _leaves(host))
    assert n_params == vit.num_params(cfg), (n_params, vit.num_params(cfg))
    result = {"config": "ViT-B/16 (ViTConfig.base16), bf16 compute, fp32 params and Adam",
              "params": n_params, "batch": VIT_BATCH, "card": smi}
    # Forward parity: 2 images, bf16 on the card against fp32 on the CPU.
    images = torch.randn((2, cfg.image_size, cfg.image_size, cfg.num_channels),
                         generator=torch.Generator().manual_seed(VIT_SEED + 1))
    with torch.inference_mode():
        ref = vit.forward(host, images, dataclasses.replace(cfg, dtype=torch.float32))
        got = vit.forward(vit.tree_to(host, "cuda"), images.cuda(), cfg).float().cpu()
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= VIT_LOGITS_REL_TOL, f"ViT logits card vs CPU: {rel} > {VIT_LOGITS_REL_TOL}"
    result["logits_rel_diff"] = rel
    result["logits_rel_tol"] = VIT_LOGITS_REL_TOL
    log(f"[vit] bf16 logits on the card vs fp32 on the CPU: max|diff|/max|logit| {rel:.3e} "
        f"(tolerance {VIT_LOGITS_REL_TOL:.3e}) on {smi}")
    batch = quadrant_batch(VIT_BATCH, cfg.image_size, VIT_SEED + 2, "cuda")
    flops = vit_flops_per_image(cfg) * VIT_BATCH
    peak_flops, _ = peaks(card)
    runs = {}
    for remat in (False, True):
        run_cfg = dataclasses.replace(cfg, remat=remat)
        params = vit.tree_to(host, "cuda")
        leaves = [t.requires_grad_(True) for t in _leaves(params)]
        opt = torch.optim.Adam(leaves, lr=VIT_LR, eps=1e-8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []

        def step():
            loss = vit.loss_fn(params, batch, run_cfg)
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            return float(loss.detach())  # waits for the step

        for _ in range(VIT_WARMUP + VIT_STEPS):
            t = time.perf_counter()
            losses.append(step())
            ms.append((time.perf_counter() - t) * 1e3)
        timed = ms[VIT_WARMUP:]
        step_ms = sum(timed) / len(timed)
        assert all(math.isfinite(x) for x in losses), losses
        runs[remat] = {"step_ms_mean": step_ms, "step_ms_min": min(timed),
                       "step_ms_max": max(timed), "images_per_s": VIT_BATCH / step_ms * 1e3,
                       "mfu": flops / (step_ms / 1e3) / peak_flops,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses}
        if profile and not remat:
            runs["profile"] = profile_step(step, "ViT-B/16 train step, batch 64", smi)
        del params, leaves, opt
        torch.cuda.empty_cache()
    base = runs[False]
    assert base["losses"][-1] < base["losses"][0], f"ViT loss did not fall: {base['losses']}"
    diff = max(abs(a - b) / abs(b) for a, b in zip(runs[True]["losses"], base["losses"]))
    assert diff <= VIT_REMAT_LOSS_REL_TOL, (
        f"remat losses {runs[True]['losses']} vs {base['losses']}: {diff}")
    result.update({"train": base, "remat": runs[True], "remat_loss_max_rel_diff": diff,
                   "profile": runs.get("profile"),
                   "flops_per_image": flops / VIT_BATCH,
                   "peak_flops": peak_flops})
    log(f"[vit] ViT-B/16 train at batch {VIT_BATCH} on {smi}: " + json.dumps(result))
    return result


# The parallel phase: the 750M flagship under each MeshPlan, ranks sharing
# the card over gloo. (name, plan, model, microbatches); the model is the
# dense flagship or its MoE form (PARALLEL_EXPERTS experts, top-2).
PARALLEL_PLANS = (
    ("fsdp2", {"fsdp": 2}, "dense", 4),
    ("tp2", {"tp": 2}, "dense", 4),
    ("sp2_ring", {"sp": 2}, "dense", 4),
    ("sp2_ulysses", {"sp": 2, "sp_mode": "ulysses"}, "dense", 4),
    ("pp2", {"pp": 2}, "dense", 2),
    ("ep2", {"ep": 2}, "moe", 4),
    ("fsdp2tp2", {"fsdp": 2, "tp": 2}, "dense", 4),
)
PARALLEL_EXPERTS = 4
# A global batch of 4 x 2048 (the training phase's 12 x 2048 cut to 4:
# two to four ranks and their fp32 states share the card's 80 GB), 3 steps,
# at full width and PARALLEL_LAYERS of the flagship's 10 layers. The phase
# holds each plan to the bare step (parity, not speed), and its ranks share
# cuda:0 over gloo, so its time tracks the bytes of the model's state
# through the host: 2 layers (1 a pipeline stage) keep every plan's
# collectives and the pipelines' hand-offs and cut those bytes (the
# embeddings, 147M of the 750M parameters, stay whole).
PARALLEL_BATCH, PARALLEL_SEQ, PARALLEL_STEPS, PARALLEL_LAYERS = 4, 2048, 3, 2
# Each plan against the bare single-process step on the same weights and
# batch, step by step, relative: name -> (loss, grad norm). A plan changes
# only where bf16 values are rounded: a GEMM over half the rows (fsdp) or
# half the heads or d_ff (tp) may take another cuBLAS kernel; a row-split
# product's two partials are each rounded to bf16 before their sum (tp,
# and ep's expert sum); fsdp sums its ranks' bf16 weight gradients in fp32
# after one rounding each; the ring computes attention in fp32 einsums
# where the kernels round P to bf16; Ulysses runs the kernels over 9 heads
# of the whole sequence. On the H100 the dense plans read at most 3.23e-5
# (loss) and 3.39e-5 (grad norm) in three runs, the same to the digit; the
# bounds are three times that: 1e-4. Local RoPE positions under sp (a
# sequence piece counting from 0) read 2.1e-5 and 2.3e-5 in the loss,
# which bf16 cannot tell from sound rounding, but 2.2e-4 and 1.95e-4 in
# the grad norm, which these bounds catch. ep2 reads 1.61e-4 and 6.30e-4:
# a rounding change can flip a token's second expert (near-tied router
# logits) where the bare step's top-2 keeps it; its bounds are 5e-4 and
# 2e-3. Parity to 3e-5 at fp32 is the CPU tests' (tests/test_torch_parallel*.py).
PARALLEL_DENSE_REL_TOL = (1e-4, 1e-4)
PARALLEL_REL_TOL = {name: PARALLEL_DENSE_REL_TOL for name, _, model, _ in PARALLEL_PLANS
                    if model == "dense"}
PARALLEL_REL_TOL["ep2"] = (5e-4, 2e-3)


def parallel_config(model: str):
    """The training phase's flagship ("full" remat) at PARALLEL_LAYERS
    layers, or its MoE form."""
    import dataclasses

    cfg = dataclasses.replace(train_config("full"), n_layers=PARALLEL_LAYERS)
    if model == "moe":
        cfg = dataclasses.replace(cfg, num_experts=PARALLEL_EXPERTS, experts_per_token=2)
    return cfg


def parallel_batch(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)
    return {"tokens": torch.randint(0, train_config().vocab_size,
                                    (PARALLEL_BATCH, PARALLEL_SEQ + 1), device=dev,
                                    generator=gen)}


def parallel_steps(step, params, state, batch, steps: int, launches: bool) -> dict:
    """``steps`` steps: losses, grad norms, host-clock ms and, with
    ``launches``, every step's Hopper and general launches."""
    out = {"losses": [], "grad_norms": [], "step_ms": [], "launches": []}
    for _ in range(steps):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if launches:
            out["launches"].append(launch_counts())
    return out


def parallel_rank(rank: int, world: int, port: int, plans: list, results):
    """One rank of each of ``plans`` (all of one world size) on cuda:0, plan
    after plan in one process (``results`` a queue; one answer a plan): the
    plan's mesh over gloo, its shards drawn straight from the bare step's
    seeds, PARALLEL_STEPS steps on its rows; then everything of the plan is
    freed before the next. One spawn for every plan of a world size spares
    each plan a process start (an import of torch, CUDA and gloo set-up)."""
    import datetime
    import faulthandler
    import gc

    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshPlan, build_mesh, make_optimizer
    from ray_tpu_torch.parallel import make_train_state, make_train_step
    from ray_tpu_torch.parallel import mesh as mesh_lib

    faulthandler.enable()  # a rank that dies in native code still says where
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        for name, plan_kw, model, microbatches in plans:
            t0 = time.perf_counter()
            mesh = build_mesh(MeshPlan(**plan_kw), device=dev)
            cfg = parallel_config(model)
            opt = make_optimizer(lr=3e-4, warmup=10)
            torch.cuda.reset_peak_memory_stats()
            params, state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                             device=dev, optimizer=opt, mesh=mesh)
            batch = mesh_lib.shard_batch(parallel_batch(dev), mesh)
            step = make_train_step(cfg, opt, mesh=mesh, num_microbatches=microbatches)
            out = parallel_steps(step, params, state, batch, PARALLEL_STEPS, launches=True)
            out.update(plan=name, rank=rank, coords=mesh.coords, backend=mesh.backend,
                       staged_bytes=mesh.staging.bytes,
                       gloo_device_bytes=mesh.staging.device_bytes,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       local_batch=list(batch["tokens"].shape),
                       seconds=time.perf_counter() - t0)
            results.put(out)
            del mesh, params, state, batch, step
            gc.collect()
            torch.cuda.empty_cache()
        dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 — reported to the parent, which fails
        import traceback

        results.put({"rank": rank, "error": f"{type(e).__name__}: {e}\n"
                                            f"{traceback.format_exc()}"})


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(label: str, target, world: int, *args, timeout_s: float = 300,
              answers: int = 1) -> list:
    """Spawn ``world`` processes of ``target(rank, world, port, *args,
    results)`` and wait for every one's ``answers`` results; the results by
    rank, each rank's in the order it gave them."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, *args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = []
    try:
        deadline = time.monotonic() + timeout_s
        # Every rank's answer, or its exit (a rank that dies in native code
        # answers nothing: its peers' errors then only say it went away).
        while len(out) < world * answers and time.monotonic() < deadline:
            try:
                out.append(results.get(timeout=2.0))
            except Exception:  # noqa: BLE001 — queue.Empty: look at the processes
                if any(p.exitcode not in (None, 0) for p in procs) and all(
                        p.exitcode is not None for p in procs):
                    break
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = [r for r in out if "error" in r]
    if errors or len(out) < world * answers:
        raise AssertionError(
            f"{label}: exit codes {[p.exitcode for p in procs]}, "
            f"{len(out)} of {world * answers} answers; errors:\n"
            + "\n".join(f"rank {r['rank']}: {r['error']}" for r in errors))
    return sorted(out, key=lambda r: r["rank"])


def run_plan_ranks(plans: list) -> dict:
    """Spawn the ranks of ``plans`` (all of one world size) once, wait for
    every plan's answers; plan name -> its results by rank."""
    from ray_tpu_torch.parallel import MeshPlan

    world = MeshPlan(**plans[0][1]).num_devices
    out = run_ranks(f"[parallel] {[p[0] for p in plans]}", parallel_rank, world, plans,
                    timeout_s=300 * len(plans), answers=len(plans))
    return {name: [r for r in out if r["plan"] == name] for name, *_ in plans}


def local_shape_kernel_check(shapes) -> list:
    """The Hopper kernels at the plans' local shapes against their plain
    versions (O_TOL, LSE_TOL, GRAD_REL_TOL). Not counted as launches of
    any run."""
    from ray_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for b, H in shapes:
        q, k, v, do = (torch.randn(b, H, PARALLEL_SEQ, 128, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        scale = 128**-0.5
        o, lse = att.flash_forward_cuda(q, k, v, True, scale)
        dq, dk, dv = att.flash_backward_cuda(q, k, v, o, lse, do, True, scale)
        o_ref, lse_ref = att.flash_attention_plain(q.float(), k.float(), v.float(), True, scale)
        ref = att.flash_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                            do.float(), True, scale)
        row = {"shape": [b, H, PARALLEL_SEQ, 128],
               "o_err": (o.float() - o_ref).abs().max().item(),
               "lse_err": (lse - lse_ref).abs().max().item()}
        for key, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            row[f"{key}_rel"] = ((got.float() - want).abs().max() / want.abs().max()).item()
        rows.append(row)
        if (row["o_err"] > O_TOL or row["lse_err"] > LSE_TOL
                or max(row[f"{k}_rel"] for k in ("dq", "dk", "dv")) > GRAD_REL_TOL):
            raise AssertionError(f"[parallel] kernels at a local shape disagree: {row}")
        del q, k, v, do, o, lse, dq, dk, dv, o_ref, lse_ref, ref
    torch.cuda.empty_cache()
    return rows


@timed_phase
def parallel_phase(card: str, smi: str) -> dict:
    """The 750M flagship under each PARALLEL_PLANS plan, its ranks spawned
    processes on cuda:0 over gloo, held to the bare single-process step on
    the same weights and batch (run first here, then freed)."""
    from ray_tpu_torch.parallel import make_optimizer, make_train_state, make_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    bare = {}
    for model in ("dense", "moe"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = parallel_config(model)
        opt = make_optimizer(lr=3e-4, warmup=10)
        params, state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                         device=dev, optimizer=opt)
        bare[model] = parallel_steps(make_train_step(cfg, opt), params, state,
                                     parallel_batch(dev), PARALLEL_STEPS, launches=False)
        bare[model]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[parallel] bare {model} step ({PARALLEL_BATCH} x {PARALLEL_SEQ}) on {smi}: "
            + json.dumps(bare[model]))
        del params, state
    torch.cuda.empty_cache()
    local = local_shape_kernel_check([(2, 18), (4, 9), (2, 9), (4, 18)])
    log("[parallel] Hopper kernels at the plans' local shapes: " + json.dumps(local))
    dense = parallel_config("dense")
    per_step = no_general({"fwd": 2 * dense.n_layers, "dq": dense.n_layers,
                           "dkv": dense.n_layers})
    from ray_tpu_torch.parallel import MeshPlan

    by_world = {}
    for plan in PARALLEL_PLANS:
        by_world.setdefault(MeshPlan(**plan[1]).num_devices, []).append(plan)
    ranks_of = {}
    for group in by_world.values():
        ranks_of.update(run_plan_ranks(group))
    plans = {}
    for name, plan_kw, model, mb in PARALLEL_PLANS:
        ranks = ranks_of[name]
        ref = bare[model]
        want = no_general({"fwd": 0, "dq": 0, "dkv": 0}) if name == "sp2_ring" else per_step
        loss_tol, gnorm_tol = PARALLEL_REL_TOL[name]
        worst_loss = max(abs(a - b) / abs(b) for r in ranks
                         for a, b in zip(r["losses"], ref["losses"]))
        worst_gnorm = max(abs(a - b) / abs(b) for r in ranks
                          for a, b in zip(r["grad_norms"], ref["grad_norms"]))
        row = {
            "plan": plan_kw, "model": model, "microbatches": mb, "ranks": len(ranks),
            "backend": sorted({r["backend"] for r in ranks}),
            "losses": [r["losses"] for r in ranks], "grad_norms": [r["grad_norms"] for r in ranks],
            "bare_losses": ref["losses"], "bare_grad_norms": ref["grad_norms"],
            "loss_max_rel_diff": worst_loss, "gnorm_max_rel_diff": worst_gnorm,
            "loss_rel_tol": loss_tol, "gnorm_rel_tol": gnorm_tol,
            "launches_per_rank_per_step": [r["launches"] for r in ranks],
            "shared_card_step_ms_per_rank": [r["step_ms"] for r in ranks],
            "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in ranks],
            "staged_bytes_per_rank": [r["staged_bytes"] for r in ranks],
            "gloo_device_bytes_per_rank": [r["gloo_device_bytes"] for r in ranks],
            "local_batch": ranks[0]["local_batch"],
            "seconds": max(r["seconds"] for r in ranks),  # in the ranks, their start apart
        }
        plans[name] = row
        log(f"[parallel] {name} on {smi} (step ms are of ranks sharing one card: no "
            "multi-card speed): " + json.dumps(row))
        if row["backend"] != ["gloo"]:
            raise AssertionError(f"[parallel] {name}: ranks sharing a card ran {row['backend']}")
        bad = [(r["rank"], i, got) for r in ranks for i, got in enumerate(r["launches"])
               if got != want]
        if bad:
            raise AssertionError(f"[parallel] {name}: launches (rank, step, got) {bad} != {want}")
        if not all(math.isfinite(x) for r in ranks for x in r["losses"] + r["grad_norms"]):
            raise AssertionError(f"[parallel] {name}: non-finite loss or grad norm")
        assert worst_loss <= loss_tol and worst_gnorm <= gnorm_tol, (
            f"[parallel] {name}: loss off by {worst_loss} (tol {loss_tol}), grad norm by "
            f"{worst_gnorm} (tol {gnorm_tol}) against the bare step")
    seconds = time.perf_counter() - t_phase
    result = {"config": "750M flagship (bench.py:240-241) at full width and "
                        f"{PARALLEL_LAYERS} layers, bf16 compute, fp32 params and AdamW, remat "
                        f"full, batch {PARALLEL_BATCH} x {PARALLEL_SEQ}; ep2 with "
                        f"{PARALLEL_EXPERTS} experts top-2 at full width",
              "bare": bare, "local_shape_kernels": local, "plans": plans,
              "phase_seconds": seconds, "card": smi}
    log(f"[parallel] {len(plans)} plans in {seconds:.1f} s on {smi}")
    return result


# The MPMD phase: the parallel phase's flagship (PARALLEL_LAYERS layers)
# over MPMD_STAGES stages, MPMD_MICROBATCHES microbatches of its 4 x 2048
# batch (cut from 12: the stages and their fp32 states share the card), 3
# steps.
MPMD_STAGES, MPMD_MICROBATCHES, MPMD_STEPS = 2, 2, 3
# The hop round trip's activation: a bf16 [4, 2048, 2304] (the batch's
# hidden states at the flagship's width).
MPMD_HOP_SHAPE = (PARALLEL_BATCH, PARALLEL_SEQ, 2304)
# Each run against the bare single-process step on the same weights and
# batch, step by step, relative: run -> (loss, grad norm). The pipeline
# changes only where bf16 values round: a GEMM over a microbatch's rows may
# take another cuBLAS kernel, and a stage's gradients are summed over the
# microbatches in fp32 after one bf16 rounding each; the gang runs the
# single-process full_head's kernels at its shapes (the same losses to the
# bit). On the H100 the first run read full_head 2.253e-5 (loss) and
# 2.332e-5 (grad norm), per_microbatch 1.136e-5 and 2.807e-5, the gang
# full_head's; the bounds are three times those.
MPMD_REL_TOL = {"full_head": (6.8e-5, 7.0e-5), "per_microbatch": (3.5e-5, 8.5e-5),
                "gang": (6.8e-5, 7.0e-5)}


def mpmd_launches_per_stage(cfg, microbatches: int) -> dict:
    """Hopper launches a stage makes in a step: each layer's forward in the
    wavefront (no graph kept), again in the backward's recompute of the
    stage, and again in remat's recompute of the layer ("full"), then
    one dQ and one dK/dV, for every microbatch; no general launch."""
    layers = cfg.n_layers // MPMD_STAGES
    return no_general({"fwd": 3 * layers * microbatches, "dq": layers * microbatches,
                       "dkv": layers * microbatches})


def mpmd_steps(step, split, states, batch, steps: int, *args) -> dict:
    """``steps`` MPMD steps: losses, grad norms, host-clock ms and every
    step's launches."""
    out = {"losses": [], "grad_norms": [], "step_ms": [], "launches": []}
    for _ in range(steps):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        split, states, m = step(split, states, batch, *args)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(launch_counts())
    return out


def mpmd_rank(rank: int, world: int, port: int, results):
    """One rank of the MPMD gang on cuda:0 (a process of its own;
    ``results`` a queue): stage ``rank`` of the flagship over gloo, its
    partitions split from the bare step's seeded weights, MPMD_STEPS steps;
    then the hop round trip of a bf16 MPMD_HOP_SHAPE activation."""
    import datetime
    import faulthandler

    import torch.distributed as dist

    from ray_tpu_torch.channel.device_channel import HopDeviceChannel
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.parallel import make_optimizer
    from ray_tpu_torch.parallel.mpmd_gang import mpmd_gang_train_step_fns

    faulthandler.enable()  # a rank that dies in native code still says where
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=300))
        cfg = parallel_config("dense")
        torch.cuda.reset_peak_memory_stats()
        pipe, init_fn, step_fn = mpmd_gang_train_step_fns(
            cfg, MPMD_STAGES, optimizer=make_optimizer(lr=3e-4, warmup=10),
            num_microbatches=MPMD_MICROBATCHES, device=dev)
        full = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        split, states = init_fn(full)
        del full
        torch.cuda.empty_cache()
        out = mpmd_steps(step_fn, split, states, parallel_batch(dev), MPMD_STEPS)
        out.update(rank=rank, stages=[s.index for s in pipe.stages if s.local],
                   backends=[b.backend for b in pipe.bridges],
                   staged_bytes=sum(b.staging.bytes for b in pipe.bridges),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del split, states, pipe, step_fn
        torch.cuda.empty_cache()
        # The hop round trip: rank 0 -> rank 1, then back by a reverse hop.
        value = torch.randn(MPMD_HOP_SHAPE, generator=torch.Generator(device=dev).manual_seed(3),
                            device=dev).to(torch.bfloat16)
        chan = HopDeviceChannel.for_processes(0, 1, MPMD_HOP_SHAPE, torch.bfloat16, device=dev)
        bridge = chan._bridge
        staged0 = bridge.staging.bytes
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        if rank == 0:
            chan.write(value)
            back = bridge.transfer(None, MPMD_HOP_SHAPE, torch.bfloat16, reverse=True)
            torch.cuda.synchronize()
            out["hop_round_trip_ms"] = (time.perf_counter() - t0) * 1e3
            out["hop_back_equal"] = bool(torch.equal(back, value))
        else:
            got = chan.read()
            out["hop_forward_equal"] = bool(torch.equal(got, value))
            bridge.transfer(got, MPMD_HOP_SHAPE, torch.bfloat16, reverse=True)
        out["hop_backend"] = bridge.backend
        out["hop_staged_bytes"] = bridge.staging.bytes - staged0
        dist.destroy_process_group()
        results.put(out)
    except BaseException as e:  # noqa: BLE001 — reported to the parent, which fails
        import traceback

        results.put({"rank": rank, "error": f"{type(e).__name__}: {e}\n"
                                            f"{traceback.format_exc()}"})


@timed_phase
def mpmd_phase(card: str, smi: str, bare=None, profile: bool = False) -> dict:
    """The 750M flagship over MPMD_STAGES stages: the single-process
    ``MpmdPipeline`` on cuda:0 in ``full_head`` and ``per_microbatch``,
    then ``MpmdGangPipeline`` on 2 gloo ranks sharing the card (and the hop
    round trip), each held to the bare single-process step on the same
    seeds (``bare``: the parallel phase's dense run, else run here). With
    ``profile``, a ``full_head`` step after the timed ones (and the bare
    step, when run here) under torch.profiler."""
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.parallel import make_optimizer, make_train_state, make_train_step
    from ray_tpu_torch.parallel.mpmd import mpmd_train_step_fns

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = parallel_config("dense")
    opt = make_optimizer(lr=3e-4, warmup=10)
    if bare is None:
        params, state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                         device=dev, optimizer=opt)
        step = make_train_step(cfg, opt)
        bare = parallel_steps(step, params, state, parallel_batch(dev), PARALLEL_STEPS,
                              launches=False)
        if profile:
            batch = parallel_batch(dev)
            bare["profile"] = profile_step(lambda: step(params, state, batch),
                                           f"bare step {PARALLEL_BATCH} x {PARALLEL_SEQ}", smi)
        del params, state, step
        torch.cuda.empty_cache()
    local = local_shape_kernel_check([(PARALLEL_BATCH // MPMD_MICROBATCHES, cfg.n_heads)])
    log(f"[mpmd] Hopper kernels at a stage's local shape on {smi}: " + json.dumps(local))
    per_stage = mpmd_launches_per_stage(cfg, MPMD_MICROBATCHES)
    runs = {}
    for mode in ("full_head", "per_microbatch"):
        torch.cuda.reset_peak_memory_stats()
        _, init_fn, step_fn = mpmd_train_step_fns(cfg, MPMD_STAGES, devices=[dev],
                                                  optimizer=opt,
                                                  num_microbatches=MPMD_MICROBATCHES)
        split, states = init_fn(tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                               device=dev))
        run = mpmd_steps(step_fn, split, states, parallel_batch(dev), MPMD_STEPS, mode)
        run["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if profile and mode == "full_head":
            batch = parallel_batch(dev)
            run["profile"] = profile_step(lambda: step_fn(split, states, batch, mode),
                                          f"mpmd {mode} step", smi)
        runs[mode] = run
        del split, states, step_fn, init_fn
        torch.cuda.empty_cache()
        want = {k: MPMD_STAGES * v for k, v in per_stage.items()}
        bad = [(i, got) for i, got in enumerate(run["launches"]) if got != want]
        if bad:
            raise AssertionError(f"[mpmd] {mode}: launches (step, got) {bad} != {want}")
    t0 = time.perf_counter()
    ranks = run_ranks("mpmd gang", mpmd_rank, 2)
    gang_s = time.perf_counter() - t0
    runs["gang"] = {"losses": [r["losses"] for r in ranks],
                    "grad_norms": [r["grad_norms"] for r in ranks],
                    "step_ms_per_rank": [r["step_ms"] for r in ranks],
                    "launches_per_rank": [r["launches"] for r in ranks],
                    "stages_per_rank": [r["stages"] for r in ranks],
                    "bridge_backends": ranks[0]["backends"],
                    "staged_bytes_per_rank": [r["staged_bytes"] for r in ranks],
                    "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in ranks],
                    "seconds": gang_s}
    hop = {"shape": list(MPMD_HOP_SHAPE), "dtype": "bfloat16",
           "forward_bit_exact": ranks[1]["hop_forward_equal"],
           "reverse_bit_exact": ranks[0]["hop_back_equal"],
           "round_trip_ms": ranks[0]["hop_round_trip_ms"], "backend": ranks[0]["hop_backend"],
           "staged_bytes_per_rank": [r["hop_staged_bytes"] for r in ranks]}
    result = {"config": f"750M flagship (bench.py:59-82) at full width and {cfg.n_layers} "
                        f"layers, bf16 compute, fp32 params and AdamW, remat full, batch "
                        f"{PARALLEL_BATCH} x {PARALLEL_SEQ}, {MPMD_STAGES} "
                        f"stages of {cfg.n_layers // MPMD_STAGES} layers, "
                        f"{MPMD_MICROBATCHES} microbatches",
              "bare": {k: bare[k] for k in ("losses", "grad_norms", "step_ms", "profile") if k in bare},
              "local_shape_kernels": local, "launches_per_stage_per_step": per_stage,
              "runs": runs, "hop": hop, "card": smi}
    for name, run in runs.items():
        # the gang's losses and grad norms are one list per rank
        losses = run["losses"] if name == "gang" else [run["losses"]]
        gnorms = run["grad_norms"] if name == "gang" else [run["grad_norms"]]
        run["loss_max_rel_diff"] = max(abs(a - b) / abs(b) for row in losses
                                       for a, b in zip(row, bare["losses"]))
        run["gnorm_max_rel_diff"] = max(abs(a - b) / abs(b) for row in gnorms
                                        for a, b in zip(row, bare["grad_norms"]))
        run["finite"] = all(math.isfinite(x) for row in losses + gnorms for x in row)
    for key in ("losses", "grad_norms"):
        runs["gang"][f"{key}_max_abs_diff_vs_full_head"] = max(
            abs(a - b) for row in runs["gang"][key] for a, b in zip(row, runs["full_head"][key]))
    result["phase_seconds"] = time.perf_counter() - t_phase
    log(f"[mpmd] on {smi} (the gang's ranks share one card: its step ms are no multi-card "
        "speed): " + json.dumps(result))
    if not (hop["forward_bit_exact"] and hop["reverse_bit_exact"]):
        raise AssertionError(f"[mpmd] the hop round trip is not bit-exact: {hop}")
    if runs["gang"]["bridge_backends"] != ["gloo"] or hop["backend"] != "gloo":
        raise AssertionError(f"[mpmd] ranks sharing a card ran {runs['gang']['bridge_backends']}")
    if runs["gang"]["stages_per_rank"] != [[0], [1]]:
        raise AssertionError(f"[mpmd] gang stages {runs['gang']['stages_per_rank']}")
    bad = [(r, i, got) for r, per_rank in enumerate(runs["gang"]["launches_per_rank"])
           for i, got in enumerate(per_rank) if got != per_stage]
    if bad:
        raise AssertionError(f"[mpmd] gang launches (rank, step, got) {bad} != {per_stage}")
    # The gang runs full_head's schedule and math over the hop bridge: its
    # losses and grad norms are full_head's to the bit.
    off = {k: runs["gang"][f"{k}_max_abs_diff_vs_full_head"] for k in ("losses", "grad_norms")}
    if any(off.values()):
        raise AssertionError(f"[mpmd] the gang is not full_head to the bit: max abs diff {off}")
    for name, (loss_tol, gnorm_tol) in MPMD_REL_TOL.items():
        run = runs[name]
        if not run["finite"]:
            raise AssertionError(f"[mpmd] {name}: non-finite loss or grad norm")
        assert run["loss_max_rel_diff"] <= loss_tol and run["gnorm_max_rel_diff"] <= gnorm_tol, (
            f"[mpmd] {name}: loss off by {run['loss_max_rel_diff']} (tol {loss_tol}), grad norm "
            f"by {run['gnorm_max_rel_diff']} (tol {gnorm_tol}) against the bare step")
    log(f"[mpmd] phase {result['phase_seconds']:.1f} s on {smi}")
    return result


def _leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def kernel_row(name, source, replaces, launches, max_abs_err, ms, plain_ms, bound, library_ms,
               shape, smi, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
            "shape": shape, "card": smi, **extra}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true", help="build + kernel phases only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a training step (18, 9 and 32 heads), a prefill, a "
                         "decode pass and a ViT step")
    ap.add_argument("--rl-only", action="store_true",
                    help="only the RL phases (12, 13), on their own port cluster (no kernel build)")
    ap.add_argument("--vit-only", action="store_true",
                    help="only the ViT-B/16 phase (14; no kernel build)")
    ap.add_argument("--tune-only", action="store_true",
                    help="only the Tune and Job phase (15) and the bare 'full' training run it "
                         "is held to, on their own port cluster (no kernel build up front)")
    ap.add_argument("--cli-only", action="store_true",
                    help="only the CLI and launcher phase (16) and the bare 'full' training run "
                         "it is held to (no kernel build up front)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="only the kernel build and the parallel phase (17): the 750M "
                         "flagship under each MeshPlan, ranks sharing the card")
    ap.add_argument("--mpmd-only", action="store_true",
                    help="only the kernel build and the MPMD phase (18): the 750M flagship "
                         "over 2 stages, in one process and as a 2-rank gang sharing the card")
    ap.add_argument("--wide-only", action="store_true",
                    help="only the kernel build, the general-kernel phase (4, with the "
                         "Hopper and wide kernels beside it) and the wide-head and hd-72 "
                         "flagships (7)")
    ap.add_argument("--cli-job", action="store_true",
                    help="run as the CLI phase's submitted job (cli_job_main), not as the smoke")
    args = ap.parse_args()
    if args.cli_job:
        import chip_smoke as this  # the actor's worker imports the class from this module

        this.cli_job_main()
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on the card",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _build

    card = torch.cuda.get_device_name(0)
    smi = card_line()
    print(smi, flush=True)
    log(f"[versions] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    if args.rl_only:
        with port_cluster():
            rl_phase(card, smi)
            rl_offpolicy_phase(card, smi)
        return 0
    if args.vit_only:
        vit_phase(card, smi, profile=args.profile)
        return 0
    if args.tune_only:
        full = training_phase(card, smi, "full")
        torch.cuda.empty_cache()
        with port_cluster() as cluster:
            tune_phase(card, smi, cluster, full)
        return 0
    if args.parallel_only:
        _build.build_all()
        parallel_phase(card, smi)
        return 0
    if args.mpmd_only:
        _build.build_all()
        mpmd_phase(card, smi, profile=args.profile)
        return 0
    if args.wide_only:
        _build.build_all()
        general_kernel_phase(card)
        wide_training_phase(card, smi, profile=args.profile)
        off_grid_training_phase(card, smi, profile=args.profile)
        return 0
    if args.cli_only:
        thread_launch_check()
        full = training_phase(card, smi, "full")
        torch.cuda.empty_cache()
        cli_phase(card, smi, full)
        return 0
    t0 = time.perf_counter()
    built = _build.build_all()
    # One cuobjdump a library, all at once (one after another they took
    # ~40 s of the build's wall time).
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(built)) as pool:
        sass = dict(zip(built, pool.map(sass_counts, (info["path"] for info in built.values()))))
    for name, info in built.items():
        log(f"[build] {name}.cu: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling", "warning",
                                        "setmaxnreg", "wgmma")):
                log(f"[build]   {line.strip()}")
        log(f"[build]   SASS of {name}: " + json.dumps(sass[name]))
    log(f"[build] all kernel libraries: {time.perf_counter() - t0:.2f} s wall")
    for name in HOPPER_KERNELS:
        if not (sass[name]["HGMMA"] and sass[name]["UTMALDG"]) or sass[name]["HMMA"]:
            raise AssertionError(f"{name}: wgmma and TMA loads but no mma.sync expected in its "
                                 f"SASS: {sass[name]}")
    kern = kernel_phase(card)
    thread_launch_check()
    bwd = bwd_kernel_phase(card)
    gen = general_kernel_phase(card)
    torch.cuda.empty_cache()
    launches = {key: None for key in _counted()}
    serving_launches = general_launches = runtime_launches = serve_launches = None
    worker_launches = {key: None for key in _counted()}
    tune_launches = {key: None for key in _counted()}
    job_launches = None
    parallel_launches = {key: None for key in _counted()}
    mpmd_launches = {key: None for key in _counted()}
    cli_launches = autoscaled_launches = {key: None for key in ("fwd", "dq", "dkv")}
    wide_launches = {key: None for key in _counted()}
    off_grid_launches = {key: None for key in _counted()}
    by_policy = {}
    if not args.kernels_only:
        runs = {policy: training_phase(card, smi, policy, profile=args.profile)
                for policy in ("full", "dots", "attn")}
        full_losses = runs["full"]["losses"]
        for policy, run in runs.items():
            diff = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], full_losses))
            by_policy[policy] = {
                key: run[key] for key in ("step_ms_mean", "step_ms_min", "step_ms_max",
                                          "tokens_per_s", "mfu", "peak_mem_gb",
                                          "launches_per_step")}
            by_policy[policy]["loss_max_rel_diff_vs_full"] = diff
            if diff > POLICY_LOSS_REL_TOL:
                raise AssertionError(f"{policy} losses {run['losses']} differ from full's "
                                     f"{full_losses} by {diff} > {POLICY_LOSS_REL_TOL}")
        log(f"[train] remat policies on {smi}: " + json.dumps(by_policy))
        launches = runs["full"]["launches"]
        torch.cuda.empty_cache()
        par = parallel_phase(card, smi)
        parallel_launches = {
            key: {name: [sum(step[key] for step in per_rank)
                         for per_rank in row["launches_per_rank_per_step"]]
                  for name, row in par["plans"].items()} for key in _counted()}
        torch.cuda.empty_cache()
        runs_mpmd = mpmd_phase(card, smi, par["bare"]["dense"], profile=args.profile)["runs"]
        mpmd_launches = {
            key: {"single_process_full_head": [st[key] for st in runs_mpmd["full_head"]["launches"]],
                  "single_process_per_microbatch": [
                      st[key] for st in runs_mpmd["per_microbatch"]["launches"]],
                  "gang_per_rank": [[st[key] for st in per_rank]
                                    for per_rank in runs_mpmd["gang"]["launches_per_rank"]]}
            for key in _counted()}
        general_launches = fp32_training_phase(card)
        grad_check_phase(card)
        wide = wide_training_phase(card, smi, profile=args.profile)
        wide_launches = wide["train"]["launches"]
        off_grid_launches = off_grid_training_phase(card, smi,
                                                    profile=args.profile)["train"]["launches"]
        sl = slice_phase(card, profile=args.profile)
        serving_launches = sl["main"]["flash_fwd_launches"]
        torch.cuda.empty_cache()
        vit_phase(card, smi, profile=args.profile)
        torch.cuda.empty_cache()
        with port_cluster() as cluster:
            runtime_launches = runtime_phase(card, smi, cluster)["launches"]["fwd"]
            served = serve_phase(card, smi, cluster, sl["main"])
            worker_launches = train_runtime_phase(card, smi, cluster, runs["full"])["launches"]
            rl_phase(card, smi)
            rl_offpolicy_phase(card, smi)
            tuned = tune_phase(card, smi, cluster, runs["full"])
        torch.cuda.empty_cache()
        cli = cli_phase(card, smi, runs["full"])
        cli_launches, autoscaled_launches = cli["job_launches"], cli["autoscaled_node_launches"]
        serve_launches = served["mix"]["flash_fwd_launches"]
        tune_launches = tuned["tune_trial_launches"]
        job_launches = tuned["job"]["launches"]["fwd"]
    head, ftrain, btrain, bgqa = kern["head"], kern["train"], bwd["train"], bwd["gqa"]
    ghead, whead = gen["general_head"], gen["head"]

    def plain(row, kind):
        return row["plain_fwd_ms" if kind == "fwd" else "plain_bwd_ms"]

    def library(row, kind):
        return row["library_fwd_ms" if kind == "fwd" else "library_bwd_ms"]

    def route_shapes(route, kind):
        """The TMA kernel of ``kind`` on ``route`` at the general phase's
        shapes: its time, bound, the general kernel's time there (earlier)
        and the library's; staged rows with the ops' times."""
        return [{"shape": r["shape"], "ms": r["tma"][f"{kind}_ms"],
                 "bound_ms": r[f"{kind}_bound_ms"], "earlier_ms": r[f"{kind}_ms"],
                 "library_ms": library(r, kind),
                 **({"staged_ms": r["tma"]["staged_fwd_ms" if kind == "fwd" else "staged_bwd_ms"]}
                    if "staged_fwd_ms" in r["tma"] else {})}
                for r in gen["rows"] if r.get("tma", {}).get("route") == route]

    general_note = ("launches: the fp32 training run at heads of 256 (the general route's "
                    "main path: fp32 at head dims 129-256 or off the 4 grid, and scale <= 0); "
                    "fp32_route_launches: the fp32 run at heads of 64 (the fp32 route's, which "
                    "runs no general kernel); plain_ms and library_ms of dq and dkv cover the "
                    "whole backward")
    general_rows = [
        kernel_row(f"flash_general_{kind}", "ray_tpu_torch/ops/csrc/flash_general.cu",
                   f"ray_tpu/ops/attention.py:{line}",
                   None if general_launches is None else
                   general_launches["general"]["launches"][f"general_{kind}"],
                   gen["max_abs"][f"general_{kind}"], ghead[f"{kind}_ms"], plain(ghead, kind),
                   (ghead[f"{kind}_bound_ms"], ghead[f"{kind}_bound_by"]), library(ghead, kind),
                   ghead["shape"], smi, sass=sass["flash_general"], note=general_note,
                   fp32_route_launches=None if general_launches is None else
                   general_launches["launches"][f"general_{kind}"],
                   parallel_launches=parallel_launches[f"general_{kind}"],
                   mpmd_launches=mpmd_launches[f"general_{kind}"],
                   wide_training_launches=wide_launches[f"general_{kind}"],
                   off_grid_training_launches=off_grid_launches[f"general_{kind}"],
                   shapes=[{"shape": r["shape"], "route": r["route"], "ms": r[f"{kind}_ms"],
                            "bound_ms": r[f"{kind}_bound_ms"], "plain_ms": plain(r, kind),
                            "library_ms": library(r, kind)} for r in gen["rows"]])
        for kind, line in (("fwd", 56), ("dq", 201), ("dkv", 262))]
    wide_dq_checks = {"bitwise_repeatable": all(
        r["tma"]["dq_bitwise_repeatable"] for r in gen["rows"]
        if r.get("tma", {}).get("route") == "hopper_wide"),
                      "delta_max_abs_err": gen["max_abs"]["hopper_wide_delta"]}
    wide_rows = [
        kernel_row(f"flash_{name}", f"ray_tpu_torch/ops/csrc/flash_{name}.cu",
                   f"ray_tpu/ops/attention.py:{line}", wide_launches[f"wide_{kind}"],
                   gen["max_abs"][f"hopper_wide_{kind}"], whead["tma"][f"{kind}_ms"],
                   plain(whead, kind), (whead[f"{kind}_bound_ms"], whead[f"{kind}_bound_by"]),
                   library(whead, kind), whead["shape"], smi, sass=sass[f"flash_{name}"],
                   earlier_ms=whead[f"{kind}_ms"],
                   note="launches: the wide-head flagship's 5 training steps; earlier_ms: the "
                        "general kernel at the same shape"
                        + ("" if kind == "fwd" else "; plain_ms and library_ms cover the whole "
                                                    "backward")
                        + ("; the kernel also computes delta" if kind == "dq" else ""),
                   **(wide_dq_checks if kind == "dq" else {}),
                   parallel_launches=parallel_launches[f"wide_{kind}"],
                   mpmd_launches=mpmd_launches[f"wide_{kind}"],
                   off_grid_training_launches=off_grid_launches[f"wide_{kind}"],
                   shapes=route_shapes("hopper_wide", kind))
        for name, kind, line in (("fwd_wide", "fwd", 56), ("bwd_wide", "dq", 201),
                                 ("bwd_dkv_wide", "dkv", 262))]
    fp32_rows = [
        kernel_row(f"flash_{name}", f"ray_tpu_torch/ops/csrc/flash_{name}.cu",
                   f"ray_tpu/ops/attention.py:{line}",
                   None if general_launches is None else
                   general_launches["launches"][f"fp32_{kind}"],
                   gen["max_abs"][f"hopper_fp32_{kind}"], ghead["fp32"][f"{kind}_ms"],
                   plain(ghead, kind), (ghead["fp32"][f"{kind}_bound_ms"],
                                        ghead["fp32"][f"{kind}_bound_by"]),
                   library(ghead, kind), ghead["shape"], smi, sass=sass[f"flash_{name}"],
                   earlier_ms=ghead[f"{kind}_ms"],
                   fma_bound_ms=ghead["fp32"][f"{kind}_fma_bound_ms"],
                   note="launches: the fp32 training run (heads of 64); earlier_ms: the general "
                        "kernel at the same shape; bound_ms at the split's rate (989 / 6 "
                        "TFLOP/s), fma_bound_ms at the fp32 FMA peak; library_ms: SDPA with TF32 "
                        "off" + ("" if kind == "fwd" else "; plain_ms and library_ms cover the "
                                                          "whole backward")
                        + ("; the kernel also computes delta; edge_shapes: FP32_EDGE_SHAPES"
                           if kind == "dq" else ""),
                   **({"bitwise_repeatable": all(r["fp32"]["dkv_bitwise_repeatable"]
                                                 for r in gen["rows"] if "fp32" in r),
                       "plan": ghead["fp32"]["dkv_plan"]} if kind == "dkv" else {}),
                   **({"bitwise_repeatable": all(r["fp32"]["dq_bitwise_repeatable"]
                                                 for r in gen["rows"] if "fp32" in r),
                       "delta_max_abs_err": gen["max_abs"]["hopper_fp32_delta"],
                       "edge_shapes": gen["fp32_edges"]} if kind == "dq" else {}),
                   parallel_launches=parallel_launches[f"fp32_{kind}"],
                   mpmd_launches=mpmd_launches[f"fp32_{kind}"],
                   wide_training_launches=wide_launches[f"fp32_{kind}"],
                   off_grid_training_launches=off_grid_launches[f"fp32_{kind}"],
                   shapes=[{"shape": r["shape"], "ms": r["fp32"][f"{kind}_ms"],
                            "bound_ms": r["fp32"][f"{kind}_bound_ms"],
                            "fma_bound_ms": r["fp32"][f"{kind}_fma_bound_ms"],
                            "earlier_ms": r[f"{kind}_ms"], "plain_ms": plain(r, kind),
                            "library_ms": library(r, kind)} for r in gen["rows"] if "fp32" in r])
        for name, kind, line in (("fwd_fp32", "fwd", 56), ("bwd_dq_fp32", "dq", 201),
                                 ("bwd_dkv_fp32", "dkv", 262))]
    by_policy_launches = {policy: row["launches_per_step"] for policy, row in by_policy.items()}
    kernels = [
        kernel_row("flash_fwd", "ray_tpu_torch/ops/csrc/flash_fwd.cu",
                   "ray_tpu/ops/attention.py:56", launches["fwd"], kern["max_err"],
                   ftrain["ms"], ftrain["plain_ms"], (ftrain["bound_ms"], ftrain["bound_by"]),
                   ftrain["library_ms"], ftrain["shape"], smi,
                   serving_launches=serving_launches, runtime_actor_launches=runtime_launches,
                   serve_replica_mix_launches=serve_launches,
                   train_worker_launches=worker_launches["fwd"],
                   tune_trial_launches=tune_launches["fwd"], job_actor_launches=job_launches,
                   cli_job_launches=cli_launches["fwd"],
                   autoscaled_node_launches=autoscaled_launches["fwd"],
                   parallel_launches=parallel_launches["fwd"],
                   mpmd_launches=mpmd_launches["fwd"],
                   serving_shape=head["shape"],
                   serving_ms=head["ms"], serving_plain_ms=head["plain_ms"],
                   serving_bound_ms=head["bound_ms"], serving_library_ms=head["library_ms"],
                   launches_per_step_by_policy=by_policy_launches, sass=sass["flash_fwd"],
                   off_grid_training_launches=off_grid_launches["fwd"],
                   off_grid_shapes=route_shapes("hopper", "fwd"),
                   off_grid_max_abs_err=gen["max_abs"]["hopper_fwd"]),
        kernel_row("flash_bwd_dq", "ray_tpu_torch/ops/csrc/flash_bwd.cu",
                   "ray_tpu/ops/attention.py:201", launches["dq"], bwd["max_abs"]["dq"],
                   btrain["dq_ms"], btrain["plain_ms"],
                   (btrain["dq_bound_ms"], btrain["dq_bound_by"]), btrain["library_ms"],
                   btrain["shape"], smi, sass=sass["flash_bwd"],
                   train_worker_launches=worker_launches["dq"],
                   tune_trial_launches=tune_launches["dq"],
                   cli_job_launches=cli_launches["dq"],
                   autoscaled_node_launches=autoscaled_launches["dq"],
                   parallel_launches=parallel_launches["dq"],
                   mpmd_launches=mpmd_launches["dq"],
                   bitwise_repeatable=btrain["dq_bitwise_repeatable"]
                   and bgqa["dq_bitwise_repeatable"],
                   delta_max_abs_err=bwd["max_abs"]["delta"],
                   delta_torch_ms=btrain["delta_torch_ms"],
                   gqa_shape=bgqa["shape"], gqa_ms=bgqa["dq_ms"],
                   gqa_bound_ms=bgqa["dq_bound_ms"], gqa_plain_ms=bgqa["plain_ms"],
                   gqa_library_ms=bgqa["library_ms"],
                   off_grid_training_launches=off_grid_launches["dq"],
                   off_grid_shapes=route_shapes("hopper", "dq"),
                   off_grid_max_abs_err=gen["max_abs"]["hopper_dq"],
                   note="plain_ms and library_ms cover the whole backward (dq, dk, dv); "
                        "the kernel also computes delta, which delta_torch_ms timed in torch; "
                        "off_grid_shapes: head dims off the 16 grid, earlier_ms the general "
                        "kernel there, staged_ms the staged op's whole backward"),
        kernel_row("flash_bwd_dkv", "ray_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
                   "ray_tpu/ops/attention.py:262", launches["dkv"], bwd["max_abs"]["dkv"],
                   btrain["dkv_ms"], btrain["plain_ms"],
                   (btrain["dkv_bound_ms"], btrain["dkv_bound_by"]), btrain["library_ms"],
                   btrain["shape"], smi, sass=sass["flash_bwd_dkv"],
                   train_worker_launches=worker_launches["dkv"],
                   tune_trial_launches=tune_launches["dkv"],
                   cli_job_launches=cli_launches["dkv"],
                   autoscaled_node_launches=autoscaled_launches["dkv"],
                   parallel_launches=parallel_launches["dkv"],
                   mpmd_launches=mpmd_launches["dkv"],
                   bitwise_repeatable=btrain["dkv_bitwise_repeatable"]
                   and bgqa["dkv_bitwise_repeatable"],
                   gqa_shape=bgqa["shape"], gqa_ms=bgqa["dkv_ms"],
                   gqa_bound_ms=bgqa["dkv_bound_ms"], gqa_plain_ms=bgqa["plain_ms"],
                   gqa_library_ms=bgqa["library_ms"],
                   off_grid_training_launches=off_grid_launches["dkv"],
                   off_grid_shapes=route_shapes("hopper", "dkv"),
                   off_grid_max_abs_err=gen["max_abs"]["hopper_dkv"],
                   note="plain_ms and library_ms cover the whole backward (dq, dk, dv)"),
    ] + general_rows + wide_rows + fp32_rows
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
