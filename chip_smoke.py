#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. build the CUDA kernels from ``daft_exprt_tpu_torch/csrc`` with nvcc;
   print the card's name and power limit;
2. hold the fused FFT block kernel (K1) against its plain PyTorch version
   at the shapes the flagship and wide serving paths and the flagship and
   wide evaluation forwards launch it with (E=128 and E=512; the flagship
   one is validation's and fine-tuning's) and at edge shapes
   (partial tiles, E=256, a zero-length row): float32 on its CUDA-core
   instance (max abs), bf16 on its tensor-core instance (max abs and
   relative L2, beside a control -- the CUDA-core instance with its
   rounding off -- that must fail the limit; kernel and plain against
   exact sums at the frame decoder's shape at E=128 and 512 and at the
   wide eval's frame shape; every bf16 call counted on the
   tensor-core instance; two runs bit-identical; padded rows exactly
   zero); its plan's shared memory against the built kernels' at every
   width; time every bf16 shape (CUDA events, median of 25 after warm-up;
   profiler device time, summed over the kernels and as the union of
   their intervals, and by kernel at the flagship serving shapes and the
   wide frame decoder; the plain version; the CUDA-core instance with
   bf16 rounding; the block staged from library calls), failing unless
   the tensor-core instance beats the CUDA-core one at the frame decoder;
   time the tensor-core products' partial-sum depths (``k1_sums``);
3. serve requests through ``collate_inference_batch`` ->
   ``InferenceEngine.run`` at the flagship width (config defaults, 11
   speakers, bf16) with seeded weights, both pitch transforms and both
   bucket policies, one speculation that undershoots and re-runs at the
   full budget, with the kernels' launch counters read around it (at the
   wrappers, the first call of each graph, plus the replays' launches
   derived from their captures; every K1 launch on the tensor-core
   instance), then a third round under the profiler whose K1 launches,
   counted in the trace, must equal 12 a pass and the derived count;
   profile one request (device time by kernel, idle share; K1's all in
   its tensor-core kernels, 12 counted on the device); then
   hold a small float32 request on the card against the same model on
   the CPU (plain versions), and time the durations' blocked cumsum on
   the card;
4. hold the fused MRF vocoder kernel (K5) against its plain version at
   the three V1 stage shapes of a B=8, bucket-512 vocode pass (and one
   unit of each), with a control (plain without its bf16 rounding) that
   must fail the relative-L2 limit, and against exact (float64) sums at
   each V1 stage (no further from them than plain); check its plan
   (``plan_mrf``: the tensor-core instance, tile and shared memory)
   against the built kernel's ``mrf_smem_bytes`` at every V1 and V3
   stage, its tensor-core counter on every call at C >= 32, and
   bit-identical output over two runs; time it (CUDA events, profiler
   device time) beside the plain version and the same fan as staged
   cuDNN convs, failing unless the V1 pass is faster than that fan; check
   edge shapes (N not a multiple of the tile, N under the halo, v3's
   ResBlock2 fan, C=16, C=8: the CUDA-core instance); serve 5
   text-to-waveform requests through
   ``run_cached_to_audio`` at flagship width with a seeded V1 generator
   (a cold style, the same keys, a padding row, half new styles, an
   undershooting speculation that re-runs at 2048), with the K1/K5 launch
   counters (every K1 and K5 launch on its tensor-core instance) and the
   prosody-encoder batch counter read around each, then the five again
   under the profiler, their launches counted on the device; check that
   the audio
   equals ``run_cached`` -> crop -> ``vocode_mels``; profile one request
   (K5's device time all in its tensor-core kernel);
   stream one utterance through ``StreamingVocoder`` against
   ``vocode_mels``, every window a replay of the generator's window graph
   (chunks bit-equal to the same stream run eagerly, K5 3 a window
   counted on the device and none at the wrapper, first chunk and one
   window replayed against eager); hold a small float32 audio request on
   the card against the CPU (TF32 off);
   then the engine's compiled passes (``engine_graphs``: a CUDA graph per
   engine graph and argument signature, ``inference/graphs.py``): a B=8
   mel request under each bucket policy and an audio request, each
   replayed on the inputs it was captured on and on another draw of the
   same shapes (other styles: the FiLM graph replayed), bit-equal to the
   same passes run eagerly (``eager_run``, ``eager_audio``,
   ``inference_film``); K1 12 a mel pass, 8 an audio pass and 4 a FiLM
   batch, K5 3, counted on the device in the replays' profiles and equal
   to what their captures recorded; host ms of replay against eager in
   alternating rounds and device busy under the profiler;
   ``update_params`` to other seeded weights equal to a fresh engine's
   and, on other inputs, to the eager passes, with a control (weights
   loaded in place around the engine, which its graphs do not see) that
   must differ;
   ``warmup`` at B = 1, 2, 4, 8, both transforms and every bucket
   capturing 36 graphs, 68 with the vocoder (seconds, ms a capture, the
   pool's bytes). Every serving phase runs through replays: a capture
   that fails raises;
   then the wide ablation's inference and evaluation (``serve_wide``:
   E=512, 4 heads of 128, C=512, bf16, depth not cut): two mel requests
   (B=8, L=64, reference T=512, bucket 512, both pitch transforms), one
   profiled, an audio request with the V1 generator and an eval step at
   B=16, L=128, T=768, profiled, each with K1's counters (12 a pass or
   batch, all tensor-core); and a small float32 wide request and eval
   step (E=256, 2 heads of 128, C=256) on the card against the CPU;
5. hold the training attention kernels (K2, forward and backward) against
   their plain versions at the flagship and wide training shapes (E=128
   and E=512, D=16, 64 and 128), f32 and bf16, at dropout rates 0 and
   0.1 (bit-equal masks; bf16 with rounding takes the tensor-core
   instance, wgmma and TMA, checked by its launch counters and its
   shared-memory plan against the built kernel's; two bf16 backward runs
   bit-identical; its o', the forward's sum of pd v over the unrounded pd,
   against the plain forward at float32 dots, ``out`` the control), and
   time every training shape at bf16 beside
   ``scaled_dot_product_attention`` (``--ab-k2`` below times them against
   another checkout's); hold float32 q/k/v with bf16 dots (the CUDA-core
   instance, which rounds k and q before the dq and dk products) to the
   plain version; the same for the training conv-FF
   kernels (K3; bf16 on the tensor-core instance that K4 shares, its
   plan's shared memory checked against the built kernel's, its
   counters on every bf16 call; the CUDA-core instance's plan against its
   kernel's ``conv_ff_train_smem_bytes``), with a check that two backward runs
   give bit-identical weight gradients, and the frame- and symbol-rate
   shapes timed like K4's in 7 (failing past 0.4 / 1.2 ms forward /
   backward at frame rate). At bf16 a control runs the same kernels with
   their internal rounding off (the CUDA-core instance) and must fail the
   relative-L2 limit;
6. take training steps at the flagship width (bf16, dropout 0.1, batch
   16, accumulation 3, L=128 symbols, T=768 frames) through
   ``make_train_step``, every step after the first a CUDA graph replay
   (``train``): 4 replayed steps against the same 4 run eagerly on the
   card, twice (metrics and parameters bit-equal, or within the eager
   runs' own spread; a frozen-seed control must differ); the K2 and K3
   launch counters (the eager first step 12 x 3 each, as many recorded by
   its capture, none at a replay; every K2 and K3 launch on its
   tensor-core instance, K1 and K4 none) and 12 x 3 each counted on the
   device in a profiled replayed step; K2's tensor maps encoded at the
   eager step and the capture alone; step ms replayed against eager in
   alternating rounds, each profiled once (K2's and K3's device time all
   in their tensor-core kernels); then hold a
   small float32 step (K2 on its CUDA-core instance) on the
   card against the same step on the CPU (loss, gradient norm,
   gradients);
7. the wide-head ablation (``wide_head_hparams``: E=512, 4 heads of
   D=128, conv channels 512; K2 at E=512 is held in phase 5): hold the
   C-blocked conv-FF kernels (K4) against their plain versions at the
   wide step's shapes and the port plan's C block (f32 max abs on the
   CUDA-core instance; bf16 on the tensor-core instance, checked by its
   launch counters and its shared-memory plan against the built kernel's,
   relative L2 against a control -- the CUDA-core instance with rounding
   off -- that must fail; bit-identical weight gradients over two
   backward runs; edge shapes: a partial tile with a short row, E=256,
   one C block) and time them at bf16 (CUDA events, profiler device time,
   the plain version, and the same GEMMs as staged bf16 cuBLAS matmuls on
   shifted operands), failing past 1.0 / 3.0 ms forward / backward at the
   wide frame-rate shape; take the wide steps as in 6 (K2 and K4 12 x 3
   per step each, every K4 launch on its tensor-core instance, K3 and K1
   none; K4's device time all in its tensor-core kernels); hold a small
   float32 wide step (E=256, 2 heads of 128,
   C=256) on the card against the CPU;
8. text serving at flagship width through the port's own entry points
   (``text_serving``): a seed-0 flagship checkpoint written as a reference
   ``.pt`` and a seed-0 V1 generator as a torch ``g_*`` file; the repo's
   five style wavs extracted on the card (mel/energy timed) and held
   against the CPU (pitch equal, log-mel and energy within the CPU
   tests' bounds), then again in three fresh processes (each within the
   same bounds); ``daft_exprt_tpu_torch.cli.synthesize`` in this
   process on four plain-text lines (a tiny pronunciation dictionary,
   Griffin-Lim previews) and on four pre-phonemized lines (``--vocoder``,
   ``--control``), the plain-text run once more as its own process (as
   a user runs it, timed); Griffin-Lim (its NNLS and phase loops graph
   replays) timed for one utterance and four, the one also through the
   host between its two stages, the four also with the loops' entries run
   eagerly (the same wavs); then
   ``SynthesisService`` with the generator, ``max_batch=8``, warmed up
   (timed) and served on 127.0.0.1: /health, /styles, three /synthesize
   (one a three-sentence paragraph), /stream, /stats, a served wav
   against ``run_cached_to_audio`` on the same inputs, and four
   concurrent requests through a batcher-enabled service (warmed as
   ``serve`` warms one), with K1's and K5's counters around the requests
   (at the wrappers plus the replays' derived launches; every launch on
   the tensor-core instances; K1 8 per pass + 4 per prosody-encoder
   batch, K5 3 per pass; the profiled request's counted on the device),
   the graphs the warm-up captured (an audio and a mel graph a batch
   size, symbol bucket, transform and output bucket, a FiLM graph a batch
   size and reference bucket of the bank; the generator's own graph of
   the streamer's window), their ms a capture and the pool's bytes, and
   no capture after the warm-up; and a ``SynthesisService`` without a
   vocoder (``griffin_lim_server``): its warm-up also captures
   Griffin-Lim's loops at every padded batch size and output bucket,
   then ``PREVIEW_STREAM`` twice (mixed batch sizes and lengths, host ms
   a request) captures nothing in the engine's cache or the process's
   Griffin-Lim cache;
9. preprocessing as users run it (``preprocessing``): a raw two-speaker
   corpus (2 x 32 utterances of 2-10 s, wavs, transcripts and MFA-style
   TextGrids, one with an ``<unk>`` word) written here with numpy;
   ``cli.training pre_process`` as its own process on the card with
   ``--device_pitch``, again with the host F0 tracker, and again in this
   process (timed): the markers equal between the runs, the rejected file
   absent, batched log-mel against per-file log-mel on the card
   (``LOUD_LOG_MEL_ABS_TOL``, which three planted faults must break),
   device F0 against host F0 (``F0_EQUAL_SHARE_MIN``'s bound), stats and
   config;
   mel/energy and F0 timed on the card at bench.py's shape (B=32, 512
   hops), the Viterbi recurrence a graph replay against its entry run
   eagerly (the F0 byte-equal, the loop's launches at the host and ms
   beside), the F0 there against the CPU's and the top-5 order on exact
   ties against a stable sort; then ``cli.training train`` for 2 flagship
   iterations from the experiment under an NCCL group of one, with the
   K2/K3 counters around it (12 x 3 a step each, all tensor-core);
10. training as users run it at flagship width (``training_runtime``), on
   a synthetic two-speaker corpus written here: ``cli.training train`` to
   6 under an NCCL process group of one (validation, checkpoints and the
   benchmark hook at 3 and 6; K1-K3 counters around the run; the hook's
   mels and previews checked, its seconds and the graphs its engine
   captures anew after each ``update_params``), its first 3 steps (two
   captures and a replay: two graphs a step around the all-reduce)
   against the same without a group (the same two graphs, no
   collective), bit-equal, resume from 3 against the uninterrupted 6,
   SIGTERM to the CLI as its own process, the loop timed and profiled
   with the default loader beside ``make_train_step`` alone from 6 (every
   step and validation batch a graph replay after its signature's
   first), the counters around one replayed step and one replayed
   validation pass and both profiled (12 x 3 K2 and K3 a step, 12 K1 a
   validation batch, on the device), validation ms a batch; a profile
   window of 3 steps (``Trainer(profile_steps=3)``, as ``--profile``
   opens it) after the step cache evicted graphs (its bound lowered until
   iteration 6), its written trace read by ``aggregate_device_trace`` and
   ``graph_launch_census``: every graph launch with its kernels, K2 and
   the conv-FF 3 x 36 a direction on the device; the learning
   check
   (the validation mel L1 must halve), ``cli.synthesize`` and
   ``cli.training fine_tune`` on the trained checkpoint (a batch
   signature's first forward eager and captured, the others replays); the
   fine-tuning forward once more through a graph cache of the smoke's,
   every batch a replay bit-equal to the same batch run eagerly, K1 12 a
   batch on the device, and a user's pass (a new cache) timed in turns
   with the eager pass;
11. vocoder training as users run it (``vocoder_training``), on the
   fine-tuning dataset that phase 10's ``fine_tune`` wrote (112
   utterances): ``cli.train_vocoder`` as its own process from the seed-0
   V1 ``g_*`` with fresh full MPD/MSD at batch 16 x 8192, 6 steps with
   checkpoints at 3 and 6 under ``--deterministic``, and again resumed
   from 3 (``g_``/``do_00000006`` bit-equal); the trained ``g_00000006``
   through ``load_generator``, vocoding a dataset mel and serving flagship
   audio requests at float32 and bf16 vocoder dtype in turns (K5 3 a
   pass, tensor-core; the bf16 audio's relative L2 to the float32);
   ``GAN_REPLAY_STEPS`` full-width GAN steps (three graph replays each)
   bit-equal to as many eager ones under deterministic algorithms, in a
   process of their own, and the generator they trained serving (its
   stale graphs dropped, K5 3 a pass, its wav equal to its exported
   weights'); the full-width GAN step replayed against eager, timed in
   turns and profiled with TF32 convs (PyTorch's default, as the CLI
   runs) and without (step ms, device busy and idle share, peak memory,
   top device ops, graphs, capture seconds, pool bytes; no K1 or K5
   launch); a small GAN step card vs
   CPU with TF32 off and on (losses, gradients, ``VOC_CPU_TOL``); the
   learning check from scratch (``cli.train_vocoder --from_audio
   --deterministic`` at seed 1234, TF32 convs, on
   ``tools/vocoder_train_soak.py``'s corpus, full V1 + MPD/MSD, 200
   steps: the mean mel_l1 of steps 181-200 > 15% under the mean of steps
   20-39, the window that starts at the soak's own baseline, step 20);
   the phase's wall seconds;
12. data-parallel synthesis at flagship width (``data_parallel``: bf16,
   seed-0 weights, B=8, L=64, reference T=512, the full frame budget):
   an ``InferenceEngine`` on ``make_mesh()`` (every visible card) bit-equal
   to the single engine whose one bucket is the full budget; two replicas
   on ``[cuda:0, cuda:0]`` at B=8 and at B=5 (padded to 6, cropped to 5),
   each shard bit-equal to the single engine on its rows, durations equal
   and the B=8 mels within ``DP_MEL_REL_TOL`` (relative L2; rows out of
   order must fail it) of the single engine's, K1 12 launches
   a replica pass (all tensor-core; each replica pass a graph replay of
   the replica's cache, bit-equal to the same replicas run eagerly, K1
   counted on the device); one engine, the replicas' replays from one
   thread (the engine's) and the same replays from a worker thread each
   timed in alternating rounds;
   ``cli.synthesize --data_parallel`` against the command without it;
   ``graft_entry.entry()`` (finite outputs) and
   ``graft_entry.dryrun_multichip(1)`` under an NCCL group of one; after
   them, the single engine's request profiled (``traced_request``: K1 12
   on the device, ``utils.aggregate_device_trace`` on the exported trace
   against the profiler's device time (5%), ``graph_launch_census``: every
   graph launch with its kernels) and replayed unprofiled, bit-equal to
   its first run; the phase's seconds;
13. print the script's wall seconds, ``{"kernels": [...]}``, the
   nvidia-smi line, and last ``{"ok": true, "device": {...}}``. K1's and
   K5's ``launches`` are their wrappers' counts over the serving phases'
   main paths: the first call of each graph, whose eager run launches and
   whose capture records (``launches_captured``); a replay runs no
   wrapper, so beside them stand the replays' launches derived from the
   captures (``launches_replayed_derived``) and those counted in the
   profiler's trace of the main path's profiled round
   (``launches_on_device``).

    python3 chip_smoke.py --extraction-processes N

runs the CPU half of the style extraction's magnitude (``re^2 + im^2 +
1e-9``, its square root) on ``angry_ref.wav`` in N fresh processes that
hold a CUDA context, alternating a process that calls the square root
first (as a process did before ``ops/mel.py`` ran its vector math on one
element) with one that goes through ``mel.cpu_vector_math_ready`` first:
each op's output against the same op run again on one thread, one
``extraction process`` line each and an ``extraction processes``
summary; exits 1 if a process that ran the warm-up moved.

    python3 chip_smoke.py --ab-train PARENT_DIR

runs only the flagship and the wide training step, in a checkout of
another commit (``PARENT_DIR``, whose ``chip_smoke.py`` has ``train``)
against this one, alternating parent, this, this, parent twice, each in
its own process: one ``AB`` line of step ms, device-busy ms and K2's
tensor-map encoding (where ``train`` reports it) per run.

    python3 chip_smoke.py --ab-k1 PARENT_DIR
    python3 chip_smoke.py --ab-serve PARENT_DIR

do the same for K1's wrapper at every ``K1_SHAPES`` shape at bf16
(CUDA-event ms, device ms summed by kernel and as the union of the
kernels' device intervals, on the same seeded inputs in both checkouts),
one replayed flagship mel request and one replayed audio request (host
ms of 20, profiled device busy, K1's and K5's device ms), and for one
flagship mel request alone (host ms of 20 requests, profiled device
busy).

    python3 chip_smoke.py --ab-conv-ff PARENT_DIR

times K3's and K4's forward and backward wrappers (rate 0.1, bf16, the
tensor-core instance) at every ``CONV_FF_TIMED`` shape (CUDA-event ms,
device ms summed by kernel and as the union of the kernels' intervals,
the kernels' ms) and a replayed flagship and wide training step (host
ms, device busy as a union, the conv-FF kernels' device ms), on the same
seeded inputs in both checkouts, parent, this, this, parent twice.

    python3 chip_smoke.py --ab-k2 PARENT_DIR

times K2's forward and backward wrappers as ``check_k2`` does
(CUDA-event and device ms), at every ``K2_TIMED`` shape at bf16, rates 0
and 0.1, on the same seeded inputs in both checkouts, alternating
parent, this, this, parent twice: one ``AB`` line a run.

    python3 chip_smoke.py --ab-k5 PARENT_DIR

times K5's wrapper at the three V1 stage shapes of a B=8, bucket-512
vocode pass (CUDA-event and device ms, on the same seeded inputs in both
checkouts), one replayed audio request at flagship width with a seeded
V1 generator (host ms of 20, profiled device busy and K5's device ms)
and one replayed stream window (host ms of 20), alternating parent,
this, this, parent twice: one ``AB`` line a run.

    python3 chip_smoke.py --ab-text PARENT_DIR

runs the text-serving phase (``text_serving``) the same way: a fresh
server's warm-up seconds, each request's host ms (the first of its
shape), /stream's first audio and the concurrent requests' median. A run
that fails is reported and the others still run.

    python3 chip_smoke.py --ab-preview PARENT_DIR

does the same for previews as a user meets them: a fresh server without
a vocoder (warm-up s, ``PREVIEW_STREAM`` twice, host ms a request),
``cli.synthesize`` with Griffin-Lim previews twice (s each) and
``fine_tuning_dataset`` over the training-runtime corpus three times (s
a call, each a first pass).

    python3 chip_smoke.py --repeat-checks N

runs the data-parallel phase and the small GAN step card vs CPU (float32
and TF32) twice in each of N fresh processes under faulthandler: one
line a process with its checks and exit code (its output's end when it
failed), then the counts; exits 1 if a process failed.

    python3 chip_smoke.py --profiled-churn N [VARIANT[:COUNT] ...]

reproduces a profiled replay's fault after graph churn (ROADMAP fault 8):
``churn_round`` twice in each of N fresh processes a variant, five on the
card at a time, each under faulthandler with ``csrc/segv_backtrace.cu``'s
handler printing the native stack first. VARIANT is "full" or
"no_<step>" (``CHURN_STEPS``), optionally "+<setting>"
(``CHURN_SETTINGS``: "template_dropped" restores torch's default of
destroying a captured graph once instantiated, the port's before it kept
them; "teardown_off" sets Kineto's ``TEARDOWN_CUPTI`` to 0). One
line a process (exit code, rounds; a fault's native stack), one
``profiled churn`` line a variant with its faults, other failures and
incomplete traces.

    python3 chip_smoke.py --profiled-films N [template_dropped]

profiles the engine-graphs phase's audio request with new styles N times
in one process (another engine's graph made and dropped before each):
for each trace the K1/K5 kernels on the device, the host's
``cudaGraphLaunch`` calls, ``graph_launch_census`` and what each capture
recorded, side by side (run 7's missing FiLM batch).

    python3 chip_smoke.py --loop-timing

times the flagship ``Trainer`` loop on the training-runtime phase's
corpus with each way of assembling its steps (``LOOP_VARIANTS``: the
prefetch thread or the loop's own thread over ``TrainLoader`` or worker
processes, and the workers forked anew every epoch), in two rounds of
opposite order, and the loop's steps alone (with the batch
on the host and on the card, and while a thread assembles steps): one
``loop timing`` line.

    python3 chip_smoke.py --graph-gaps

profiles one replayed GAN step (16 x 8192, TF32 convs) and one replayed
flagship train step with the host's activity: the device's idle gaps
between kernels, each with the host operations that overlap it (one
``graph gaps`` line a step).

    python3 chip_smoke.py --vocoder-learning

runs only the vocoder-training phase's learning check: the gate's run
(deterministic, through the CLI) twice, with whether the two curves are
equal, then once for each (TF32 convs, seed) of ``VOC_LEARNING_RUNS``
without deterministic algorithms: one ``vocoder learning`` line each
(``learning_readings``, the gate's among them, and the mel_l1 of every
step). ``--vocoder-learning more`` runs the 20 further pairs of
``VOC_LEARNING_MORE_RUNS`` the same way, without the gate's runs.

Needs CUDA: it exits with an error when ``torch.cuda.is_available()`` is
false. It imports nothing of JAX and nothing of ``daft_exprt_tpu``.
"""

from __future__ import annotations

import contextlib
import faulthandler
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

from daft_exprt_tpu_torch.config import HyperParams
from daft_exprt_tpu_torch.inference.engine import InferenceEngine
from daft_exprt_tpu_torch.inference.graphs import GraphCache
from daft_exprt_tpu_torch.inference.inputs import collate_inference_batch
from daft_exprt_tpu_torch.models.daft_exprt import DaftExprt
from daft_exprt_tpu_torch.models.modules import FFTBlock, init_parameters
from daft_exprt_tpu_torch.ops import _build
from daft_exprt_tpu_torch.ops.attention_train import (attention_core,
                                                      tc_map_stats)
from daft_exprt_tpu_torch.ops.conv_ff_train import (conv_ff_train,
                                                    conv_ff_train_blocked)
from daft_exprt_tpu_torch.ops.fft_block import (KERNEL_MAX_CHANNELS,
                                                fft_block_plain,
                                                fused_fft_block, unpacked)
from daft_exprt_tpu_torch.ops.mrf_vocoder import fused_mrf
from daft_exprt_tpu_torch.symbols import SYMBOLS_ENGLISH
from daft_exprt_tpu_torch.training.step import (TRAIN_CAPTURED,
                                                make_train_step)
from daft_exprt_tpu_torch.training.trainer import Trainer
from daft_exprt_tpu_torch.utils import GRAPH_LAUNCH, prefetch_iterator
from daft_exprt_tpu_torch.vocoder.hifigan import V1_CONFIG, HiFiGanGenerator

ROOT = Path(__file__).resolve().parent
# H100 SXM published peaks (dense): bf16 tensor cores, float32 CUDA cores,
# HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# K1 kernel vs plain, max abs: f32 as tests/test_fft_block.py; bf16 7.5x
# tighter than that file's bf16 bound (0.15), leaving room for summation-
# order flips of single bf16 roundings; bf16 is held by relative L2 too
# (K1_REL_TOL)
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
E, C = 128, 1024
# the wide ablation's FFT blocks (wide_head_hparams)
WIDE_E, WIDE_H, WIDE_C = 512, 4, 512
# (name, B, T, E, heads, C, FiLM): the K1 launches of flagship mel and
# audio serving (prosody encoder, phoneme encoder, frame decoder at bucket
# 512 and at the full budget), of wide serving at the same batch, of the
# wide evaluation step (B=16, T=768 frames and L=128 symbols), and of the
# flagship evaluation forward that validation, the validation sample and
# fine_tune run (B=16, T up to 768 frames, L up to 128 symbols)
K1_SHAPES = [("prosody_encoder", 8, 512, E, 8, C, False),
             ("phoneme_encoder", 8, 64, E, 2, C, True),
             ("frame_decoder", 8, 512, E, 2, C, True),
             ("frame_decoder_full_budget", 8, 2048, E, 2, C, True),
             ("wide_prosody_encoder", 8, 512, WIDE_E, WIDE_H, WIDE_C, False),
             ("wide_phoneme_encoder", 8, 64, WIDE_E, WIDE_H, WIDE_C, True),
             ("wide_frame_decoder", 8, 512, WIDE_E, WIDE_H, WIDE_C, True),
             ("wide_frame_decoder_full_budget", 8, 2048, WIDE_E, WIDE_H,
              WIDE_C, True),
             ("wide_eval_frames", 16, 768, WIDE_E, WIDE_H, WIDE_C, True),
             ("wide_eval_symbols", 16, 128, WIDE_E, WIDE_H, WIDE_C, True),
             ("eval_prosody", 16, 768, E, 8, C, False),
             ("eval_symbols", 16, 128, E, 2, C, True),
             ("eval_frames", 16, 768, E, 2, C, True)]
# (name, T, E, heads, C, FiLM, lengths): tiles cut by T, a row of length 0
# (every duration zero), checked but not timed; E=256 is two heads of 128.
# The last two have a hidden past what a cluster of 8 holds (the
# tensor-core instance's conv launch runs in two chunks) and past the
# CUDA-core instance's conv tile: bf16 only, with no control.
K1_EDGE_CASES = [("edge_T48", 48, E, 2, C, True, [48, 17, 0]),
                 ("edge_T16_H8", 16, E, 8, C, False, [16, 5]),
                 ("edge_T1536", 1536, E, 2, C, True, [1536, 700]),
                 ("edge_E256_T200", 200, 256, 2, 256, True, [200, 77, 0]),
                 ("edge_E256_T1", 1, 256, 2, 256, False, [1, 0]),
                 ("edge_E512_T48", 48, WIDE_E, WIDE_H, WIDE_C, True,
                  [48, 17, 0]),
                 ("edge_E512_T300", 300, WIDE_E, WIDE_H, WIDE_C, False,
                  [300, 129]),
                 ("edge_C4224_chunks", 48, E, 8, 4224, True, [48, 17, 0]),
                 ("edge_E512_C6272_chunks", 130, WIDE_E, WIDE_H, 6272, False,
                  [130, 61])]
# K1 kernel vs plain at bf16, relative L2 of the whole output. Both round
# at the same points; float32 sums in another order flip a bf16 rounding
# by one ulp only now and then, while the control (the CUDA-core instance
# with its rounding off, on the same bf16-rounded weights) is off by up to
# half an ulp at every rounding point. The limit sits near the geometric
# mean of the kernel's largest reading and the control's smallest over the
# checked shapes on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): ~4.1e-4
# (E=512, where plain itself is ~4e-4 from exact sums, k1_exact) and
# 1.22e-3 (E=128).
K1_REL_TOL = 7e-4
# the shapes whose K1 device time is printed by kernel: the three flagship
# serving shapes and the wide frame decoder
K1_BREAKDOWN = ("prosody_encoder", "phoneme_encoder", "frame_decoder",
                "wide_frame_decoder")
# the shapes at which kernel and plain are each held to exact sums (the
# largest of each width, where the distances are steady)
K1_EXACT_SHAPES = ("frame_decoder", "wide_frame_decoder", "wide_eval_frames")
# per-symbol duration stats far below the pinned 0.12 s per phone: the
# speculated bucket undershoots and the engine re-runs at the full budget
LOW_DURATION_STATS = {"symbols": {s: {"dur_mean": 0.03, "dur_std": 0.005}
                                  for s in SYMBOLS_ENGLISH}}
FLAGSHIP_SPEAKERS = ["LJ"] + [f"esd_{i:04d}" for i in range(11, 21)]


def flagship_hparams(**overrides):
    """Config defaults (4+4+4 FFT blocks, E=128, C=1024, heads 8/2/2,
    bf16 compute) with LJ + 10 ESD speakers."""
    return HyperParams(verbose=False, training_files="unused",
                       validation_files="unused",
                       output_directory=str(ROOT / "build"),
                       language="english", speakers=FLAGSHIP_SPEAKERS,
                       **overrides)


def wide_head_hparams(**overrides):
    """The wide-head ablation (``tools/train_profile.py``
    ``_wide_head_hparams``): E=512 with 4 heads of 128 and conv channels
    512 in every FFT block, the local prosody predictor at 1024 channels,
    on the flagship's other settings. Module dicts in ``overrides``
    replace these."""
    wide = dict(hidden_embed_dim=512, attn_nb_heads=4, attn_dropout=0.1,
                conv_kernel=3, conv_channels=512, conv_dropout=0.1)
    modules = dict(
        prosody_encoder=dict(wide, nb_blocks=4),
        phoneme_encoder=dict(wide, nb_blocks=4),
        local_prosody_predictor={"nb_blocks": 1, "conv_kernel": 3,
                                 "conv_channels": 1024,
                                 "conv_dropout": 0.1},
        frame_decoder=dict(wide, nb_blocks=4))
    return flagship_hparams(**{**modules, **overrides})


def cuda_ms(fn, reps=25, warmup=3):
    """Median milliseconds of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps=10, breakdown=False):
    """Device milliseconds of all the kernels one call of ``fn`` runs
    (torch.profiler over ``reps`` calls after one warm-up), without the
    host's time between launches that ``cuda_ms`` counts when the device
    waits for it; None where the profiler records no device time (it
    missed one window on an H100: such a window is taken again once).
    With ``breakdown``: (that, [{kernel, ms, count} per call])."""
    fn()
    for _ in range(2):
        report = profile_kernels(lambda: [fn() for _ in range(reps)], {})
        if report is not None:
            ms = report["device_busy_ms"] / reps
            if not breakdown:
                return ms
            return ms, [{"kernel": t["kernel"], "ms": t["ms"] / reps,
                         "count": t["count"] / reps} for t in report["top"]]
    return (None, None) if breakdown else None


def device_union_ms(fn, reps=10):
    """Device milliseconds of one call of ``fn``: the union of its kernels'
    device intervals under the profiler (``reps`` calls after one warm-up),
    where ``device_ms`` sums their durations; kernels that overlap (a
    launch that starts before the one it depends on has ended) count once.
    None where the profiler records no device time."""
    fn()
    prof, _ = profiled(lambda: [fn() for _ in range(reps)])
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / 1e3 / reps if spans else None


def k1_cluster(B, T, E_, C_, H):
    """Launch 3's cluster size of K1's tensor-core instance for a call."""
    import ctypes
    fn = _build.load_library("fft_block_tc").fft_block_tc_cluster_size
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    return fn(B, T, E_, C_, H)


def graph_edges(cache, kind):
    """(edges, programmatic edges) of the first captured graph of ``cache``
    whose key starts with ``kind`` (``fft_block_tc_graph_edges``), or None
    where torch gives no handle to the captured graph."""
    import ctypes
    for (key, _), entry in cache.entries.items():
        if key[0] != kind or entry.graph is None:
            continue
        raw = getattr(entry.graph, "raw_cuda_graph", None)
        if raw is None:
            return None
        fn = _build.load_library("fft_block_tc").fft_block_tc_graph_edges
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_longlong * 2)()
        err = fn(raw(), ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"graph edges: CUDA error {err}")
        return int(out[0]), int(out[1])
    return None


def k1_bound(lengths, B, T, dot_dtype, E=E, C=C):
    """Least time for one K1 call on these inputs: the larger of its
    FLOPs at the card's peak for the dot type (rows past a length need
    no work) and its compulsory bytes (x and out once in float32, the dot
    weights once at the dot type's width, FiLM rows and lengths once)."""
    lens = np.asarray(lengths, np.float64)
    flops = float(np.sum(2 * lens * (4 * E * E + 6 * E * C)
                         + 4 * lens * lens * E))
    weight_bytes = torch.finfo(dot_dtype).bits // 8
    nbytes = 2 * B * T * E * 4 + (4 * E * E + 6 * E * C) * weight_bytes \
        + B * 2 * E * 4 + B * 4
    t_ops = flops / PEAK_FLOPS[dot_dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def staged_block(block, H):
    """The same block staged from library calls at bf16 operands (cuBLAS
    linears, ``scaled_dot_product_attention`` with the key mask, cuDNN
    convs, ``F.layer_norm``), on the block's bf16-rounded weights: the
    yardstick of what K1 fuses, timed only and used nowhere in the port.
    Returns fn(x, film, lengths)."""
    import torch.nn.functional as F

    bf = torch.bfloat16
    a, f = block.attention, block.feed_forward
    mha = a.multi_head_attention
    w_in, w_out = mha.in_proj_weight.detach().to(bf), \
        mha.out_proj.weight.detach().to(bf)
    b_in, b_out = mha.in_proj_bias.detach().to(bf), \
        mha.out_proj.bias.detach().float()
    c1, c2 = f.convs["0"].conv, f.convs["2"].conv
    w1, b1 = c1.weight.detach().to(bf), c1.bias.detach().to(bf)
    w2, b2 = c2.weight.detach().to(bf), c2.bias.detach().float()
    ln1, ln2 = a.layer_norm, f.layer_norm

    def run(x, film, lengths):
        B, T, E_ = x.shape
        D = E_ // H
        valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
        q, k, v = (t.view(B, T, H, D).transpose(1, 2) for t in
                   F.linear(x.to(bf), w_in, b_in).split(E_, dim=-1))
        ctx = F.scaled_dot_product_attention(
            q, k, v, attn_mask=valid[:, None, None, :])
        ctx = ctx.transpose(1, 2).reshape(B, T, E_)
        y = F.linear(ctx, w_out).float() + b_out + x
        y = F.layer_norm(y, (E_,), ln1.weight, ln1.bias)
        y = torch.where(valid[..., None], y, 0.0)
        h = F.relu(F.conv1d(y.to(bf).transpose(1, 2), w1, b1, padding=1))
        z = F.conv1d(h, w2, padding=1).transpose(1, 2).float() + b2 + y
        z = F.layer_norm(z, (E_,), ln2.weight, ln2.bias)
        if film is not None:
            z = film[:, None, :E_] * z + film[:, None, E_:]
        return torch.where(valid[..., None], z, 0.0)
    return run


def k1_exact(x, w, film, lengths, H):
    """K1's function with exact sums: the operands rounded to bf16 where
    K1 rounds them, products and sums in float64 (the exponentials and
    LayerNorms too)."""
    import torch.nn.functional as F

    def rnd(t):
        return t.to(torch.bfloat16).double()

    w = unpacked(w)
    w = w._replace(**{n: getattr(w, n).double() for n in w._fields
                      if n != "images"})
    x = x.double()
    B, T, E_ = x.shape
    D = E_ // H
    valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    q, k, v = (t.reshape(B, T, H, D).transpose(1, 2) for t in
               rnd(rnd(x) @ w.wqkv + w.bqkv).split(E_, dim=-1))
    s = (q @ k.transpose(-1, -2)) / np.sqrt(D)
    s = s.masked_fill(~valid[:, None, None, :], -np.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = rnd(p / p.sum(-1, keepdim=True))
    ctx = rnd((p @ v).transpose(1, 2).reshape(B, T, E_))

    def ln(y, scale, bias):
        return F.layer_norm(y, (E_,), scale, bias, eps=1e-5)

    def conv(a, wk):  # SAME k=3 over rows; wk (3, in, out)
        a = F.pad(a, (0, 0, 1, 1))
        return a[:, :-2] @ wk[0] + a[:, 1:-1] @ wk[1] + a[:, 2:] @ wk[2]

    a = torch.where(valid[..., None], ln(ctx @ w.wo + w.bo + x, w.ln1_s,
                                         w.ln1_b), 0.0)
    h = rnd(torch.relu(conv(rnd(a), w.w1) + w.b1))
    y = ln(conv(h, w.w2) + w.b2 + a, w.ln2_s, w.ln2_b)
    if film is not None:
        y = film.double()[:, None, :E_] * y + film.double()[:, None, E_:]
    return torch.where(valid[..., None], y, 0.0)


# the depths of the tensor-core products' partial sums (k-columns a
# partial, added in float32; 0: every product of a sum chained inside the
# tensor cores); the instance's is 64
K1_SUMS = (64, 32, 16, 0)


def k1_sums(gen, rng):
    """K1's partial sums timed against the other depths they could take,
    at the frame decoder's shape at both widths (every product of the
    three launches; the shipped library's k64, ``fft_block_tc_sums``'s
    others): each depth's CUDA-event and device ms and relative L2
    distance from the exact sums (k1_exact), beside plain's. Timed only:
    no path runs another depth than 64."""
    import ctypes

    from daft_exprt_tpu_torch.ops.fft_block import (_TC_ARGTYPES,
                                                    _tc_kernels,
                                                    _tc_workspace_bytes,
                                                    tc_kernel_weights)

    sums = _build.load_library("fft_block_tc_sums").fft_block_tc_forward_sums
    sums.argtypes = _TC_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
    sums.restype = ctypes.c_int
    shipped = _tc_kernels()[1]
    rows = []
    for name, B, T, E_, H, C_ in (("frame_decoder", 8, 512, E, 2, C),
                                  ("wide_frame_decoder", 8, 512, WIDE_E,
                                   WIDE_H, WIDE_C)):
        block = FFTBlock(E_, H, C_, 3)
        init_parameters(block, gen)
        block = block.cuda()
        w = block.kernel_weights(torch.bfloat16)
        x = _cuda(rng.standard_normal((B, T, E_)).astype(np.float32))
        film = _cuda(np.concatenate([1 + 0.1 * rng.standard_normal((B, E_)),
                                     0.1 * rng.standard_normal((B, E_))],
                                    1).astype(np.float32))
        lens = rng.integers(T // 4, T, size=B)
        lens[0] = T
        lengths = _cuda(lens.astype(np.int32))
        ws = torch.empty(_tc_workspace_bytes(B, T, E_, C_, H),
                         dtype=torch.uint8, device="cuda")

        def run(sum_k):
            out = torch.empty_like(x)
            args = (x.data_ptr(), lengths.data_ptr(), *tc_kernel_weights(w),
                    film.data_ptr(), film.stride(0), ws.data_ptr(),
                    out.data_ptr(), B, T, E_, C_, H)
            stream = torch.cuda.current_stream().cuda_stream
            err = shipped(*args, stream) if sum_k == 64 \
                else sums(*args, sum_k, stream)
            if err != 0:
                raise RuntimeError(f"K1 sums {sum_k}: CUDA error {err}")
            return out

        exact = k1_exact(x, w, film, lengths, H)
        plain = fft_block_plain(x, w, film, lengths, num_heads=H,
                                dot_dtype=torch.bfloat16)
        row = {"shape": name, "B": B, "T": T, "E": E_, "C": C_,
               "plain_exact_rel_l2": _rel_l2(plain, exact)}
        for sum_k in K1_SUMS:
            row[f"k{sum_k}" if sum_k else "chained"] = {
                "ms": cuda_ms(lambda: run(sum_k)),
                "device_ms": device_ms(lambda: run(sum_k)),
                "exact_rel_l2": _rel_l2(run(sum_k), exact),
                "plain_rel_l2": _rel_l2(run(sum_k), plain)}
        print("K1 sums", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def check_k1_plan(cases):
    """The wrapper's plan at each checked (E, H, C) equals the built
    kernels' own shared-memory count, for both instances: bf16 on the
    tensor-core instance, float32 on the CUDA-core one."""
    from daft_exprt_tpu_torch.ops.fft_block import (kernel_smem_bytes,
                                                    plan_fft_block)

    plan = {}
    for E_, H, C_ in sorted({(c[3], c[4], c[5]) for c in cases}):
        for dtype, instance in ((torch.bfloat16, "tensor_core"),
                                (torch.float32, "cuda_core")):
            if instance == "cuda_core" and C_ > KERNEL_MAX_CHANNELS:
                continue  # past its conv tile: no CUDA-core instance
            mirror = plan_fft_block(768, E_, H, C_, dtype)
            built = kernel_smem_bytes(E_, H, C_, instance)
            if mirror.instance != instance or mirror.smem_bytes != built:
                raise AssertionError(f"K1 plan at E={E_}, H={H}, C={C_} "
                                     f"{dtype}: {mirror}, kernel {built}")
            plan[f"E{E_}_H{H}_C{C_}_{instance}"] = built
    print("K1 shared memory per instance", json.dumps(plan), flush=True)
    return plan


def check_k1(gen):
    """Phase 2: K1 against its plain version at the serving and wide
    evaluation shapes (timed) and at edge shapes (partial tiles, E=256, a
    zero-length row): float32 on the CUDA-core instance (max abs), bf16 on
    the tensor-core instance (max abs and relative L2, beside a control --
    the CUDA-core instance with its rounding off -- that must fail the
    limit; every bf16 call counted as a tensor-core launch; two runs
    bit-identical; padded rows exactly zero). Timed at bf16: CUDA events,
    the profiler's device time, the plain version, the CUDA-core instance
    with bf16 rounding and the block staged from library calls; fails if
    the tensor-core instance is slower than the CUDA-core one at the frame
    decoder's shape."""
    from daft_exprt_tpu_torch.ops.fft_block import as_float32, fft_block_cuda

    rng = np.random.default_rng(0)
    cases = []
    for name, B, T, E_, H, C_, with_film in K1_SHAPES:
        lens = rng.integers(T // 4, T, size=B)
        lens[0], lens[-1] = T, 3  # one full row, one short row
        cases.append((name, B, T, E_, H, C_, with_film, lens, True))
    cases += [(name, len(lens), T, E_, H, C_, film, np.array(lens), False)
              for name, T, E_, H, C_, film, lens in K1_EDGE_CASES]
    plan = check_k1_plan(cases)
    results, failures = [], []
    for name, B, T, E_, H, C_, with_film, lens, timed in cases:
        block = FFTBlock(E_, H, C_, 3)
        init_parameters(block, gen)
        with torch.no_grad():  # non-trivial biases and LN affine terms
            for p in block.parameters():
                if p.dim() == 1:
                    p.add_(0.1 * torch.randn(p.shape, generator=gen))
        block = block.cuda()
        x = _cuda(rng.standard_normal((B, T, E_)).astype(np.float32))
        film = None
        if with_film:
            film = _cuda(np.concatenate(
                [1 + 0.1 * rng.standard_normal((B, E_)),
                 0.1 * rng.standard_normal((B, E_))], 1).astype(np.float32))
        lengths = _cuda(lens.astype(np.int32))
        valid = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
        has_cuda_core = C_ <= KERNEL_MAX_CHANNELS
        for dot_dtype in ((torch.float32, torch.bfloat16) if has_cuda_core
                          else (torch.bfloat16,)):
            bf16 = dot_dtype == torch.bfloat16
            w = block.kernel_weights(dot_dtype)
            wp = unpacked(w)  # plain's (K, N) dot weights, made once

            def kernel():
                return fused_fft_block(x, w, film, lengths, num_heads=H,
                                       dot_dtype=dot_dtype)

            def plain():
                return fft_block_plain(x, wp, film, lengths, num_heads=H,
                                       dot_dtype=dot_dtype)

            tc_before = fused_fft_block.tc_launches
            out, again = kernel(), kernel()
            torch.cuda.synchronize()
            tc = fused_fft_block.tc_launches - tc_before
            ref = plain()
            err = (out - ref).abs().max().item()
            row = {"shape": name, "B": B, "T": T, "E": E_, "H": H, "C": C_,
                   "dtype": dtype_name(dot_dtype),
                   "instance": "tensor_core" if bf16 else "cuda_core",
                   "lengths": lens.tolist(), "max_abs_err": err,
                   "tol": TOL[dot_dtype],
                   "bit_identical": bool(torch.equal(out, again))}
            bad = []
            if not torch.isfinite(out).all():
                bad.append("non-finite")
            if (out[~valid] != 0).any():
                bad.append("padded rows not exactly zero")
            if not err <= TOL[dot_dtype]:
                bad.append(f"max abs err {err} > {TOL[dot_dtype]}")
            if not row["bit_identical"]:
                bad.append("two runs differ")
            if tc != (2 if bf16 else 0):
                bad.append(f"{tc} of 2 launches on the tensor-core instance")
            if bf16 and not has_cuda_core:
                row.update(rel_l2=_rel_l2(out, ref), rel_l2_limit=K1_REL_TOL)
                if not row["rel_l2"] <= K1_REL_TOL:
                    bad.append("relative L2")
            elif bf16:
                w32 = as_float32(w)
                control = fft_block_cuda(x, w32, film, lengths, num_heads=H,
                                         dot_dtype=torch.float32)
                row.update(rel_l2=_rel_l2(out, ref),
                           control_rel_l2=_rel_l2(control, ref),
                           rel_l2_limit=K1_REL_TOL)
                if not row["rel_l2"] <= K1_REL_TOL < row["control_rel_l2"]:
                    bad.append("relative L2 or its control")
                if name in K1_EXACT_SHAPES:
                    # kernel and plain sum in float32 in other orders: each
                    # should be about as far from the exact sums
                    exact = k1_exact(x, w, film, lengths, H)
                    row["exact_rel_l2"] = {"kernel": _rel_l2(out, exact),
                                           "plain": _rel_l2(ref, exact)}
                    if not row["exact_rel_l2"]["kernel"] \
                            <= 1.5 * row["exact_rel_l2"]["plain"]:
                        bad.append("further from the exact sums than plain")
            if timed and bf16:
                def cuda_core():
                    return fft_block_cuda(x, w32, film, lengths,
                                          num_heads=H, dot_dtype=dot_dtype,
                                          instance="cuda_core")

                staged = staged_block(block, H)
                row["ms"] = cuda_ms(kernel)
                if name in K1_BREAKDOWN:
                    row["device_ms"], row["kernels"] = device_ms(
                        kernel, breakdown=True)
                else:
                    row["device_ms"] = device_ms(kernel)
                # launches chained by programmatic dependent launch overlap:
                # the union of their device intervals, beside their sum
                row["device_union_ms"] = device_union_ms(kernel)
                row["cluster"] = k1_cluster(B, T, E_, C_, H)
                row["host_ms"] = None if row["device_ms"] is None \
                    else row["ms"] - row["device_ms"]
                row["plain_ms"] = cuda_ms(plain, reps=5)
                row["cuda_core_ms"] = cuda_ms(cuda_core)
                row["cuda_core_device_ms"] = device_ms(cuda_core)
                row["staged_ms"] = cuda_ms(lambda: staged(x, film, lengths))
                row["staged_device_ms"] = device_ms(
                    lambda: staged(x, film, lengths))
                row["bound_ms"], row["bound_by"] = k1_bound(
                    lens, B, T, dot_dtype, E=E_, C=C_)
                results.append(row)
            elif timed:  # float32: the CUDA-core instance, events only
                row["ms"] = cuda_ms(kernel)
                results.append(row)
            print("K1", json.dumps(row), flush=True)
            if bad:
                failures.append((name, dtype_name(dot_dtype), bad))
    if failures:
        raise AssertionError(f"K1: {failures}")
    head = next(r for r in results if r["shape"] == "frame_decoder"
                and r["dtype"] == "bfloat16")
    if not head["ms"] < head["cuda_core_ms"]:
        raise AssertionError(f"K1's tensor-core instance is not faster than "
                             f"its CUDA-core one at the frame decoder: {head}")
    return results, plan


def _cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def _err(got, ref, tol):
    """(max abs error, whether it is within ``tol`` times the larger of 1
    and the reference's largest magnitude). The scale matters for sums:
    a weight gradient adds B*T = 12288 rows here, 48 times the rows of
    the JAX tests whose tolerances these are, and its float32 rounding
    noise grows with the tensor's scale, not with each element."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    return err, bool(torch.isfinite(got).all()) and err <= tol * scale


def dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def k2_bound(lens, B, T, H, dot_dtype, backward, E=E):
    """Least time for one K2 call: FLOPs of the valid (query, key) pairs
    (all T query rows against each row's valid keys; 4E per pair forward,
    10E backward, as the Pallas CostEstimates count them) at the card's
    peak for the dot type, against the bytes once: q/k/v (and dq/dk/dv)
    at the dot type's width, out (or g) in float32, the (B, H, T) row
    stats, lengths and seeds."""
    lens = np.where(np.asarray(lens) <= 0, T, np.minimum(lens, T))
    pairs = float(np.sum(T * lens.astype(np.float64)))
    flops = (10 if backward else 4) * E * pairs
    w = torch.finfo(dot_dtype).bits // 8
    nbytes = (6 if backward else 3) * B * T * E * w + B * T * E * 4 \
        + 2 * B * H * T * 4 + 2 * B * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dot_dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def k3_bound(B, T, dot_dtype, backward, E=E, C=C):
    """Least time for one K3 call: 12 E C FLOPs per row forward (two k=3
    convs), 36 E C backward, as the Pallas CostEstimates count them, at
    the card's peak for the dot type, against x (and g, dx) in float32,
    the conv weights once at the dot type's width (and their float32
    gradients), the vectors and FiLM once."""
    flops = (36 if backward else 12) * B * T * E * C
    w = torch.finfo(dot_dtype).bits // 8
    nbytes = (4 if backward else 2) * B * T * E * 4 + 6 * E * C * w \
        + (6 * E * C + C + 3 * E) * 4 * backward \
        + (C + 5 * E) * 4 + B * 2 * E * 4 * (2 if backward else 1) + B * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dot_dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def sdpa_ms(q, k, v, g, lengths, H):
    """The library yardstick for K2 at rate 0: scaled_dot_product_attention
    with the boolean key mask (forward), and autograd through it
    (backward), on the same bf16 inputs; (forward, backward) times by CUDA
    events, then on the device alone. Used nowhere in the port."""
    import torch.nn.functional as F

    B, T, width = q.shape
    D = width // H

    def heads(t):
        return t.view(B, T, H, D).transpose(1, 2).detach().requires_grad_()

    q4, k4, v4 = heads(q), heads(k), heads(v)
    g4 = g.to(q.dtype).view(B, T, H, D).transpose(1, 2)
    mask = (torch.arange(T, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    out = fwd()

    def bwd():
        return torch.autograd.grad(out, (q4, k4, v4), g4, retain_graph=True)
    return cuda_ms(fwd), cuda_ms(bwd), device_ms(fwd), device_ms(bwd)


# (name, B, T, heads, lengths, E): the flagship and wide training steps'
# K2 launches (batch 16; the wide ablation has 4 heads of D=128 at
# E=512); edge shapes (untimed): T=48 has TQ=16, so the dropout salts
# cross query tiles, with a zero-length row; T=37 has no power-of-two
# divisor, so TQ = T, and odd rows; T=2048 is the largest frame bucket
K2_SHAPES = [("prosody_encoder", 16, 768, 8, None, E),
             ("phoneme_encoder", 16, 128, 2, None, E),
             ("frame_decoder", 16, 768, 2, None, E),
             ("edge_T48", 3, 48, 8, [48, 17, 0], E),
             ("edge_T37", 2, 37, 2, [37, 11], E),
             ("edge_T2048", 2, 2048, 2, [2048, 1500], E),
             ("wide_frame_rate", 16, 768, 4, None, 512),
             ("wide_symbol_rate", 16, 128, 4, None, 512),
             ("wide_edge_T48", 3, 48, 4, [48, 17, 0], 512)]
# every shape the training steps launch K2 at, timed at bf16; the kernels
# line reads frame_decoder first
K2_TIMED = ("prosody_encoder", "phoneme_encoder", "frame_decoder",
            "wide_frame_rate", "wide_symbol_rate")
# K2 kernel vs plain (see _err): f32 as tests/test_attention_train.py
# (1e-5 forward, 2e-4 gradients); bf16 max abs 2e-2 of max(1, |ref|) as a
# coarse bound, and the bf16 relative L2 error below (see _rel_l2)
K2_TOL = {torch.float32: (1e-5, 2e-4), torch.bfloat16: (2e-2, 2e-2)}
RATES = (0.0, 0.1)
# bf16 relative L2 error of kernel vs plain. Both round at the same
# points; a different float32 summation order moves a value across a bf16
# rounding boundary only rarely (one ulp, 2^-8 relative, in a small share
# of the elements), while a kernel that skips its internal roundings
# (the control: the same kernels with rounding off on the same bf16
# inputs) is off by up to half an ulp in every rounded value. Each limit
# sits near the geometric mean of the two readings over all checked
# shapes on an H100 (largest error, smallest control; PERF.md): K2
# forward 9.2e-5 and 1.6e-3, backward 2.3e-4 and 3.1e-3; K3 on its
# tensor-core instance forward 2.4e-5 and 1.2e-3, backward 2.3e-4 (W1 at
# T=2048) and 2.8e-3; K4 forward 5.8e-5 and 1.45e-3, backward 4.6e-4 (W1
# at the short edge shape, B x T = 80 rows) and 2.8e-3 (NVIDIA H100 80GB
# HBM3, 700 W).
BF16_REL_TOL = {("K2", "fwd"): 4e-4, ("K2", "bwd"): 8e-4,
                ("K3", "fwd"): 1.7e-4, ("K3", "bwd"): 8e-4,
                ("K4", "fwd"): 2.9e-4, ("K4", "bwd"): 1.1e-3}
# the tensors each kernel's internal bf16 roundings feed; the control
# must exceed the limit on every one of them
K2_ROUNDED = ("out", "q", "k", "v")
# K2's o' (tensor-core forward) against the plain forward at float32 dots,
# relative L2: its pd is split into a bf16 part and a bf16 remainder, which
# leaves ~2^-18 of each pd (2.4e-6 to 3.2e-6 read on an H100);
# out, whose pd is rounded once (~1.6e-3 on the CPU), must exceed it
K2_OPRIME_REL_TOL = 1e-5


def _rel_l2(got, ref):
    """||got - ref|| / ||ref|| in float64."""
    got, ref = got.double(), ref.double()
    return ((got - ref).norm() / ref.norm().clamp_min(1e-300)).item()


def _bf16_limit(kernel, tensor):
    """The bf16 relative L2 limit of a forward ("out") or gradient tensor."""
    return BF16_REL_TOL[kernel, "fwd" if tensor == "out" else "bwd"]


def _bf16_verdict(kernel, errs, control):
    """Raise unless every bf16 relative error is within its limit and the
    control exceeds the limit on every tensor a rounding feeds."""
    bad = {n: e for n, e in errs.items() if not e <= _bf16_limit(kernel, n)}
    caught = {n: e for n, e in control.items()
              if e > _bf16_limit(kernel, n)}
    if bad or len(caught) != len(control):
        raise AssertionError(
            f"{kernel} bf16 relative L2 (limits {BF16_REL_TOL}): errors "
            f"{errs}, control with rounding off {control}")


def check_k2_plan():
    """The wrapper's shared-memory plan of the tensor-core instance equals
    the built kernel's own count at every head dim it takes."""
    from daft_exprt_tpu_torch.ops.attention_train import (plan_attention,
                                                          tc_smem_bytes)

    plan = {}
    for d in (16, 64, 128):
        width, heads = (128, 128 // d) if d < 128 else (512, 4)
        mirror = plan_attention(768, width, heads, torch.bfloat16,
                                torch.bfloat16)
        built = tc_smem_bytes(d)
        if mirror.instance != "tensor_core" or mirror.smem_bytes != built:
            raise AssertionError(f"K2 plan at D={d}: {mirror}, kernel {built}")
        plan[d] = built
    print("K2 tensor-core shared memory per head dim", json.dumps(plan),
          flush=True)
    return plan


def check_k2():
    """K2 (training attention) forward and backward against their plain
    versions at the flagship and wide training shapes, f32 and bf16, rates
    0 and 0.1; bf16 with rounding runs the tensor-core instance (its
    counters move, the control's do not) and gives bit-identical gradients
    over two backward runs; at bf16 the control with rounding off must
    fail; every training shape timed at bf16 with the kernel, the plain
    version and SDPA."""
    from daft_exprt_tpu_torch.ops.attention_train import (
        attention_backward_cuda, attention_core, attention_forward_cuda,
        attention_plain, attention_plain_backward)

    def tc_launches():
        return attention_core.tc_fwd_launches, attention_core.tc_bwd_launches

    rng = np.random.default_rng(3)
    rows = []
    for name, B, T, H, lens, width in K2_SHAPES:
        if lens is None:
            lens = rng.integers(T // 2, T, size=B)
            lens[0] = T  # one full row
        lens = np.asarray(lens)
        lengths = _cuda(lens.astype(np.int32))
        seeds = _cuda(rng.integers(-2 ** 31, 2 ** 31, size=B).astype(
            np.int32))
        q, k, v, g = (_cuda(rng.standard_normal((B, T, width)).astype(
            np.float32)) for _ in range(4))
        for dot_dtype in (torch.float32, torch.bfloat16):
            bf16 = dot_dtype == torch.bfloat16
            qd, kd, vd = (t.to(dot_dtype) for t in (q, k, v))
            for rate in RATES:
                args = (lengths, seeds, H, rate, dot_dtype)
                qg, kg, vg = (t.clone().requires_grad_() for t in (qd, kd, vd))
                before = tc_launches()
                out = attention_core(qg, kg, vg, *args)
                grads = torch.autograd.grad(out, (qg, kg, vg), g,
                                            retain_graph=True)
                again = torch.autograd.grad(out, (qg, kg, vg), g)
                torch.cuda.synchronize()
                tc = [a - b for a, b in zip(tc_launches(), before)]
                if tc != ([1, 2] if bf16 else [0, 0]):
                    raise AssertionError(f"K2 {name} {dot_dtype}: tensor-core "
                                         f"launches {tc}")
                identical = all(torch.equal(a, b)
                                for a, b in zip(grads, again))
                if bf16 and not identical:
                    raise AssertionError(f"K2 {name} rate {rate}: two "
                                         "backward runs differ")
                ref = attention_plain(qd, kd, vd, *args)
                ref_grads = [t.to(dot_dtype) for t in attention_plain_backward(
                    qd, kd, vd, g, *args)]
                tol_f, tol_g = K2_TOL[dot_dtype]
                err_f, ok_f = _err(out, ref, tol_f)
                errs = [_err(a, b, tol_g) for a, b in
                        zip(grads, ref_grads)]
                err_b = max(e for e, _ in errs)
                row = {"shape": name, "B": B, "T": T, "E": width, "H": H,
                       "dtype": dtype_name(dot_dtype), "rate": rate,
                       "fwd_err": err_f, "bwd_err": err_b,
                       "tol": [tol_f, tol_g],
                       "bwd_bit_identical": identical}
                if bf16:
                    # the control: the same kernels, rounding off (the
                    # CUDA-core instance)
                    c_args = (lengths, seeds, H, rate, torch.float32)
                    before = tc_launches()
                    c_out, c_stats = attention_forward_cuda(qd, kd, vd,
                                                            *c_args)
                    c_grads = attention_backward_cuda(
                        qd, kd, vd, g, lengths, seeds, c_stats, H, rate,
                        torch.float32)
                    if tc_launches() != before:
                        raise AssertionError("K2 control ran on tensor cores")
                    row["rel_l2"] = {n: _rel_l2(a, b) for n, a, b in zip(
                        K2_ROUNDED, (out, *grads), (ref, *ref_grads))}
                    row["control_rel_l2"] = {
                        n: _rel_l2(a, b) for n, a, b in zip(
                            K2_ROUNDED, (c_out, *c_grads), (ref, *ref_grads))}
                    # o' (the forward's sum of pd v over the unrounded pd,
                    # the backward's delta) against the plain forward at
                    # float32 dots; out, whose pd is rounded, the control
                    o_ref = attention_plain(qd, kd, vd, lengths, seeds, H,
                                            rate, torch.float32)
                    oprime = attention_forward_cuda(qd, kd, vd, *args)[1][1]
                    row["oprime_rel_l2"] = _rel_l2(oprime, o_ref)
                    row["oprime_control_rel_l2"] = _rel_l2(out, o_ref)
                print("K2", json.dumps(row), flush=True)
                if not (ok_f and all(ok for _, ok in errs)):
                    raise AssertionError(f"K2 disagrees with plain: {row}")
                if bf16:
                    _bf16_verdict("K2", row["rel_l2"], row["control_rel_l2"])
                    if not (row["oprime_rel_l2"] <= K2_OPRIME_REL_TOL
                            < row["oprime_control_rel_l2"]):
                        raise AssertionError(f"K2 o' (limit "
                                             f"{K2_OPRIME_REL_TOL}): {row}")
                if name in K2_TIMED and bf16:
                    _, stats = attention_forward_cuda(qd, kd, vd, *args)

                    def fwd():
                        return attention_forward_cuda(qd, kd, vd, *args)

                    def bwd():
                        return attention_backward_cuda(
                            qd, kd, vd, g, lengths, seeds, stats, H, rate,
                            dot_dtype)
                    row["fwd_ms"], row["bwd_ms"] = cuda_ms(fwd), cuda_ms(bwd)
                    row["fwd_device_ms"] = device_ms(fwd)
                    row["bwd_device_ms"] = device_ms(bwd)
                    row["fwd_plain_ms"] = cuda_ms(lambda: attention_plain(
                        qd, kd, vd, *args), reps=5)
                    row["bwd_plain_ms"] = cuda_ms(
                        lambda: attention_plain_backward(qd, kd, vd, g, *args),
                        reps=5)
                    row["fwd_bound_ms"], row["fwd_bound_by"] = k2_bound(
                        lens, B, T, H, dot_dtype, False, E=width)
                    row["bwd_bound_ms"], row["bwd_bound_by"] = k2_bound(
                        lens, B, T, H, dot_dtype, True, E=width)
                    if rate == 0.0:
                        (row["fwd_library_ms"], row["bwd_library_ms"],
                         row["fwd_library_device_ms"],
                         row["bwd_library_device_ms"]) = sdpa_ms(
                            qd, kd, vd, g, lengths, H)
                    print("K2 timed", json.dumps(row), flush=True)
                rows.append(row)
        # float32 q/k/v with bf16 dots (the CUDA-core instance) rounds k and
        # q before the dq and dk products, as the plain version and the
        # Pallas kernel do (without those two roundings dq and dk are
        # ~1.7e-3 off on the CPU against JAX, past the bf16 limits)
        for rate in RATES:
            args = (lengths, seeds, H, rate, torch.bfloat16)
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            before = tc_launches()
            out = attention_core(qg, kg, vg, *args)
            grads = torch.autograd.grad(out, (qg, kg, vg), g)
            if tc_launches() != before:
                raise AssertionError("K2 float32 inputs ran on tensor cores")
            errs = {n: _rel_l2(a, b) for n, a, b in zip(
                K2_ROUNDED, (out, *grads), (attention_plain(q, k, v, *args),
                                            *attention_plain_backward(
                                                q, k, v, g, *args)))}
            print("K2 float32 inputs, bf16 dots", json.dumps(
                {"shape": name, "rate": rate, "rel_l2": errs}), flush=True)
            if not all(e <= _bf16_limit("K2", n) for n, e in errs.items()):
                raise AssertionError(f"K2 {name} float32 inputs with bf16 "
                                     f"dots: relative L2 {errs}")
    return rows


# (name, B, T, E, C, C block, lengths): the training steps' conv-FF
# launches (frame rate T=768, symbol rate L=128, batch 16). K3: the
# flagship (E=128, C=1024); edges (untimed): a partial last tile, the
# largest frame bucket. K4: the wide ablation (E=512, C=512) at the
# port plan's block (None); edges (untimed): T not a multiple of the
# tile with a row whose frames past 13 are zero (as the block's row mask
# leaves them; its cotangent is zero there too), E=256, E=384 (a cluster
# of 3 column tiles on the tensor-core instance), and one C block.
K3_SHAPES = [("frame_rate", 16, 768, E, C, None, None),
             ("symbol_rate", 16, 128, E, C, None, None),
             ("edge_T40", 2, 40, E, C, None, None),
             ("edge_T2048", 2, 2048, E, C, None, None)]
K4_SHAPES = [("wide_frame_rate", 16, 768, 512, 512, None, None),
             ("wide_symbol_rate", 16, 128, 512, 512, None, None),
             ("edge_T40_short_row", 2, 40, 512, 512, None, [40, 13]),
             ("edge_E256", 2, 64, 256, 256, None, None),
             ("edge_E384", 2, 100, 384, 384, None, None),
             ("edge_single_block", 2, 64, 512, 128, 128, None)]
CONV_FF_TIMED = ("frame_rate", "symbol_rate", "wide_frame_rate",
                 "wide_symbol_rate")
# the tensor-core instance at the frame-rate shape (K3: flagship, K4: wide),
# bf16, CUDA-event ms of one call (forward, backward): a fall back onto the
# CUDA-core instances (K3 0.91 / 3.20, K4 2.9 / 9.1 ms on an H100) fails
# these
MS_LIMIT = {"frame_rate": {"fwd": 0.4, "bwd": 1.2},
            "wide_frame_rate": {"fwd": 1.0, "bwd": 3.0}}
# K3/K4 kernel vs plain (see _err): f32 as tests/test_conv_ff_train.py
# (2e-4 output, 3e-4 gradients); bf16 max abs 2e-2 of max(1, |ref|) as a
# coarse bound, and the bf16 relative L2 error (BF16_REL_TOL)
K3_TOL = {torch.float32: (2e-4, 3e-4), torch.bfloat16: (2e-2, 2e-2)}
# K4: 2e-4 at f32 for the output and every gradient (of max(1, |ref|))
CONV_FF_TOL = {"K3": K3_TOL,
               "K4": {torch.float32: (2e-4, 2e-4),
                      torch.bfloat16: K3_TOL[torch.bfloat16]}}
K3_GRADS = ("x", "w1", "b1", "w2", "b2", "ln_s", "ln_b", "film")
# the tensors the kernels' internal bf16 roundings (x, h, da2, da1) feed
K3_ROUNDED = ("out", "x", "w1", "b1", "w2")
# |conv1 pre-activation| under which kernel and plain may take different
# ReLU branches at bf16: both add the same 3E + 1 exact bf16 products and
# the bias in float32 in other orders, ~1e-6 apart at E=128; the bound
# grows with E
RELU_TIE = 3e-5


def relu_tie_rows(x, w1, b1, dot_dtype):
    """(B, T) bool: rows with a conv1 pre-activation (on x and W1 rounded
    to the dot type, exact in float64) within RELU_TIE * E / 128 of
    zero."""
    from daft_exprt_tpu_torch.ops.conv_ff_train import _conv3

    a1 = _conv3(x.to(dot_dtype).double(),
                w1.to(dot_dtype).double().permute(2, 1, 0)) + b1.double()
    return (a1.abs() < RELU_TIE * x.shape[-1] / 128).any(-1)


def conv_ff_params(gen, rng, E_, C_):
    """Ordinary weights (seeded init, biases and LN affine terms moved off
    their init) and dyadic ones (conv1 and b1 on a grid whose sums are
    exact in float32), on the card."""
    block = FFTBlock(E_, 2, C_, 3)
    init_parameters(block, gen)
    ff = block.feed_forward
    with torch.no_grad():  # non-trivial biases and LN affine terms
        ordinary = [p.detach().cuda() + (0.1 * torch.randn(
            p.shape, generator=gen).cuda() if p.dim() == 1 else 0.0)
            for p in (ff.convs["0"].conv.weight, ff.convs["0"].conv.bias,
                      ff.convs["2"].conv.weight, ff.convs["2"].conv.bias,
                      ff.layer_norm.weight, ff.layer_norm.bias)]
    dyadic = [_cuda((rng.integers(-64, 65, size=(C_, E_, 3)) / 1024).astype(
        np.float32)), _cuda((rng.integers(-512, 513, size=C_) / 8192).astype(
            np.float32))] + ordinary[2:]
    return ordinary, dyadic


def check_tc_plan(kernel, shapes):
    """The wrapper's plan of the tensor-core instance of K3 and K4 equals
    the built kernel's own at every shape of ``shapes``: its launches
    (``tc_launch_plan`` against ``tc_built_plan``: row tiles, padded rows,
    conv_e's splits and cluster, wgrad's cluster, conv_c's blocks and each
    launch's shared memory), its workspace in both directions, and the
    largest shared memory ``plan_conv_ff_train`` and
    ``plan_conv_ff_blocked`` name, within one block's 227 KB."""
    from daft_exprt_tpu_torch.ops.conv_ff_train import (
        _tc_workspace_bytes, tc_built_plan, tc_launch_plan, tc_smem_bytes,
        tc_workspace_bytes)

    plans = {}
    for name, B, T, E_, C_, _, _ in shapes:
        mirror, built = tc_launch_plan(B, T, E_, C_), tc_built_plan(B, T, E_,
                                                                    C_)
        ws = [(tc_workspace_bytes(B, T, E_, C_, bw),
               _tc_workspace_bytes(B, T, E_, C_, bw)) for bw in (False, True)]
        smem = max(built.smem_conv_c, built.smem_conv_e, built.smem_wgrad)
        if (mirror != built or any(a != b for a, b in ws)
                or smem != tc_smem_bytes(E_) or smem > 232448):
            raise AssertionError(f"{kernel} tensor-core plan at {name}: "
                                 f"{mirror}, kernel {built}, workspace {ws}")
        plans[name] = {**built._asdict(), "workspace_fwd": ws[0][1],
                       "workspace_bwd": ws[1][1]}
    print(f"{kernel} tensor-core plans", json.dumps(plans), flush=True)
    return plans


def check_k4_plan():
    """K4's plan names the tensor-core instance at bf16 with the built
    kernel's shared memory at every width it takes, and its launch plan at
    every K4 shape (``check_tc_plan``)."""
    from daft_exprt_tpu_torch.ops.conv_ff_train import (plan_conv_ff_blocked,
                                                        tc_smem_bytes)

    plan = {}
    for width in (128, 256, 384, 512):
        mirror = plan_conv_ff_blocked(768, width, 512, 128, torch.bfloat16)
        built = tc_smem_bytes(width)
        if mirror.instance != "tensor_core" or mirror.smem_bytes != built:
            raise AssertionError(f"K4 plan at E={width}: {mirror}, kernel "
                                 f"{built}")
        plan[width] = built
    print("K4 tensor-core shared memory per width", json.dumps(plan),
          flush=True)
    return {"smem_bytes_by_width": plan,
            "launches": check_tc_plan("K4", K4_SHAPES)}


def check_k3_plan():
    """K3's plan names the tensor-core instance at bf16 and the CUDA-core
    one at f32 at every K3 shape, each with its built kernel's own
    shared-memory count, and the tensor-core launch plan at every K3 shape
    (``check_tc_plan``)."""
    from daft_exprt_tpu_torch.ops.conv_ff_train import (cuda_core_smem_bytes,
                                                        plan_conv_ff_train,
                                                        tc_smem_bytes)

    built = {}
    for name, _, T, E_, C_, _, _ in K3_SHAPES:
        for dtype, instance, count in (
                (torch.bfloat16, "tensor_core", tc_smem_bytes(E_)),
                (torch.float32, "cuda_core", cuda_core_smem_bytes(C_))):
            mirror = plan_conv_ff_train(T, E_, C_, dtype)
            if mirror.instance != instance or mirror.smem_bytes != count:
                raise AssertionError(f"K3 plan at {name} {dtype}: {mirror}, "
                                     f"kernel {count}")
            built[instance] = count
    print("K3 shared memory per instance", json.dumps(built), flush=True)
    return {"smem_bytes_by_instance": built,
            "launches": check_tc_plan("K3", K3_SHAPES)}


def staged_cublas_ms(x, w1k, w2k):
    """K4's GEMMs as bf16 ``torch.matmul`` on shifted operands ([row t-1 |
    t | t+1] concatenated, zero outside the utterance, built before the
    timing): conv1, conv2, their data gradients dh and dx, and the weight
    gradients dW1, dW2, each one cuBLAS call on the same shapes as the
    kernel's (random bf16 h, da2, da1). The yardstick of the products
    alone: no epilogues, row work or roundings. Timed only; used nowhere
    in the port. Returns (forward ms: conv1 + conv2, backward ms: all six,
    which the backward's recompute includes, {product: ms})."""
    B, T, E_ = x.shape
    C_ = w1k.shape[-1]
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(0)

    def shifted(a):
        z = torch.zeros_like(a[:, :1])
        return torch.cat([torch.cat([z, a[:, :-1]], 1), a,
                          torch.cat([a[:, 1:], z], 1)], -1).reshape(B * T, -1)

    def rand(width):
        return torch.randn((B, T, width), generator=gen).to(bf).cuda()

    h, da2, da1 = rand(C_), rand(E_), rand(C_)
    x3, h3, da2_3, da1_3 = (shifted(a) for a in (x.to(bf), h, da2, da1))
    w1s, w2s = w1k.to(bf).reshape(3 * E_, C_), w2k.to(bf).reshape(3 * C_, E_)
    w2rs = w2k.flip(0).transpose(1, 2).to(bf).reshape(3 * E_, C_)
    w1rs = w1k.flip(0).transpose(1, 2).to(bf).reshape(3 * C_, E_)
    products = {"conv1": lambda: x3 @ w1s, "conv2": lambda: h3 @ w2s,
                "dh": lambda: da2_3 @ w2rs, "dx": lambda: da1_3 @ w1rs,
                "dw1": lambda: x3.t() @ da1.reshape(B * T, C_),
                "dw2": lambda: h3.t() @ da2.reshape(B * T, E_)}
    ms = {k: cuda_ms(f) for k, f in products.items()}
    return ms["conv1"] + ms["conv2"], sum(ms.values()), ms


def check_conv_ff(kernel, shapes, gen, seed):
    """K3 or K4 (training conv-FF) forward and backward against their
    plain versions, f32 and bf16, rates 0 and 0.1; at bf16 the control
    with rounding off must fail; weight gradients bit-identical over two
    backward runs. At bf16 both run their tensor-core instance (their
    counters move, the control's do not); the timed shapes (CONV_FF_TIMED)
    are timed at bf16 by CUDA events, on the device alone by kernel, beside
    the plain version and staged cuBLAS matmuls, and the frame-rate shape
    is held to MS_LIMIT.

    f32 feeds conv1 dyadic values (x in k/8, |x| <= 2; W1 in k/1024,
    |W1| <= 1/16; b1 in k/8192): every conv1 sum is then exact in float32
    in any order, so kernel and plain take the same ReLU branch
    everywhere (a pre-activation within rounding of zero can take the
    other branch, and the backward's ReLU mask is discontinuous there).
    bf16 feeds ordinary values, so that the rounding of x and W1 is
    checked, and zeroes the cotangent on the three rows around each row
    with a pre-activation near zero (relu_tie_rows): da1 is then zero on
    that row on both sides, whichever branch they take."""
    from daft_exprt_tpu_torch.ops.conv_ff_train import (
        conv_ff_backward_cuda, conv_ff_blocked_plain,
        conv_ff_blocked_plain_backward, conv_ff_forward_cuda,
        conv_ff_train, conv_ff_train_blocked, kernel_weights, plan_conv_ff,
        tc_weights)

    counted = conv_ff_train if kernel == "K3" else conv_ff_train_blocked

    def tc_launches():
        return [counted.tc_fwd_launches, counted.tc_bwd_launches]

    rng = np.random.default_rng(seed)
    params = {}
    rows = []
    for name, B, T, E_, C_, cb, lens in shapes:
        if kernel == "K4":
            cb = cb or plan_conv_ff(T, E_, C_, 3)
        if (E_, C_) not in params:
            params[E_, C_] = conv_ff_params(gen, rng, E_, C_)
        ordinary, dyadic = params[E_, C_]
        valid = torch.ones((B, T, 1), device="cuda")
        if lens is not None:
            valid = (torch.arange(T, device="cuda")[None, :] < _cuda(
                np.asarray(lens))[:, None])[..., None].float()
        x_dyadic = _cuda((rng.integers(-16, 17, size=(B, T, E_)) / 8).astype(
            np.float32)) * valid
        x_ordinary = _cuda(rng.standard_normal((B, T, E_)).astype(
            np.float32)) * valid
        g_all = _cuda(rng.standard_normal((B, T, E_)).astype(
            np.float32)) * valid
        film = _cuda(np.concatenate(
            [1 + 0.1 * rng.standard_normal((B, E_)),
             0.1 * rng.standard_normal((B, E_))], 1).astype(np.float32))
        seeds = _cuda(rng.integers(-2 ** 31, 2 ** 31, size=B).astype(
            np.int32))
        for dot_dtype in (torch.float32, torch.bfloat16):
            bf16 = dot_dtype == torch.bfloat16
            x, prm = (x_ordinary, ordinary) if bf16 else (x_dyadic, dyadic)
            g, tied = g_all, 0.0
            if bf16:
                tie = relu_tie_rows(x, prm[0], prm[1], dot_dtype)
                near = tie.clone()
                near[:, 1:] |= tie[:, :-1]
                near[:, :-1] |= tie[:, 1:]
                g = g_all * (~near)[..., None]
                tied = tie.float().mean().item()
            for rate in RATES:
                leaves = [t.clone().requires_grad_()
                          for t in [x] + prm + [film]]
                w1, b1, w2, b2, ls, lb = leaves[1:7]
                before = tc_launches()
                if cb is None:
                    out = conv_ff_train(*leaves, seeds, rate, dot_dtype)
                else:
                    out = conv_ff_train_blocked(*leaves, seeds, rate, cb,
                                                dot_dtype)
                grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
                again = torch.autograd.grad(out, leaves, g)
                torch.cuda.synchronize()
                tc = [a - b for a, b in zip(tc_launches(), before)]
                if tc != ([1, 2] if bf16 else [0, 0]):
                    raise AssertionError(f"{kernel} {name} {dot_dtype}: "
                                         f"tensor-core launches {tc}")
                if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                    raise AssertionError(f"{kernel} {name}: two backward runs "
                                         "differ")
                plain_args = (x, *prm, film, seeds)
                c_plain = cb or C_

                def plain():
                    return conv_ff_blocked_plain(*plain_args, rate, c_plain,
                                                 dot_dtype)

                def plain_bwd():
                    return conv_ff_blocked_plain_backward(
                        *plain_args, g, rate, c_plain, dot_dtype)

                ref, ref_grads = plain(), plain_bwd()
                tol_f, tol_g = CONV_FF_TOL[kernel][dot_dtype]
                err_f, ok_f = _err(out, ref, tol_f)
                errs = {n: _err(a, b, tol_g) for n, a, b in
                        zip(K3_GRADS, grads, ref_grads)}
                row = {"shape": name, "B": B, "T": T, "E": E_, "C": C_,
                       "c_block": cb, "dtype": dtype_name(dot_dtype),
                       "rate": rate, "fwd_err": err_f,
                       "bwd_err": max(e for e, _ in errs.values()),
                       "bwd_errs": {n: e for n, (e, _) in errs.items()},
                       "tol": [tol_f, tol_g]}
                w1k, w2k = kernel_weights(w1, w2, dot_dtype)
                vec = [t.detach() for t in (b1, b2, ls, lb)]
                kargs = (x, w1k, vec[0], w2k, vec[1], vec[2], vec[3],
                         film, seeds)
                if bf16:
                    # the control: the same kernels on the same rounded
                    # weights, rounding off (the CUDA-core instance)
                    before = tc_launches()
                    c_out = conv_ff_forward_cuda(*kargs, rate, torch.float32,
                                                 cb)
                    c = conv_ff_backward_cuda(*kargs, g, rate, torch.float32,
                                              cb)
                    if tc_launches() != before:
                        raise AssertionError(f"{kernel} control ran on "
                                             "tensor cores")
                    c_grads = (c[0], c[1].permute(2, 1, 0), c[2],
                               c[3].permute(2, 1, 0))
                    named = dict(zip(K3_GRADS, grads))
                    ref_named = dict(zip(K3_GRADS, ref_grads))
                    row["relu_tie_rows"] = tied
                    row["rel_l2"] = {"out": _rel_l2(out, ref), **{
                        n: _rel_l2(named[n], ref_named[n])
                        for n in K3_GRADS}}
                    row["control_rel_l2"] = {
                        n: _rel_l2(a, ref_named.get(n, ref))
                        for n, a in zip(K3_ROUNDED, (c_out, *c_grads))}
                print(kernel, json.dumps(row), flush=True)
                if not (ok_f and all(ok for _, ok in errs.values())):
                    raise AssertionError(f"{kernel} disagrees with plain: "
                                         f"{row}")
                if bf16:
                    _bf16_verdict(kernel, row["rel_l2"],
                                  row["control_rel_l2"])
                if name in CONV_FF_TIMED and bf16:
                    # the tensor-core instance on its bf16 weights, made
                    # once as a training step makes them for its
                    # micro-batches
                    tw = tc_weights(w1, w2)
                    tkargs = (x, tw.w1, vec[0], tw.w2, *kargs[4:])

                    def fwd():
                        return conv_ff_forward_cuda(*tkargs, rate, dot_dtype,
                                                    cb)

                    def bwd():
                        return conv_ff_backward_cuda(*tkargs, g, rate,
                                                     dot_dtype, cb,
                                                     (tw.w1r, tw.w2r))
                    row["fwd_ms"], row["bwd_ms"] = cuda_ms(fwd), cuda_ms(bwd)
                    (row["fwd_device_ms"],
                     row["fwd_device_kernels"]) = device_ms(
                        fwd, breakdown=True)
                    (row["bwd_device_ms"],
                     row["bwd_device_kernels"]) = device_ms(
                        bwd, breakdown=True)
                    if rate == 0.0:
                        (row["fwd_staged_ms"], row["bwd_staged_ms"],
                         row["staged_ms_by_product"]) = staged_cublas_ms(
                            x, w1k, w2k)
                    limit = MS_LIMIT.get(name, {})
                    slow = {d: row[f"{d}_ms"] for d in limit
                            if not row[f"{d}_ms"] <= limit[d]}
                    if slow:
                        raise AssertionError(
                            f"{kernel} {name} rate {rate}: ms {slow} past "
                            f"the limits {limit}")
                    row["fwd_plain_ms"] = cuda_ms(plain, reps=5)
                    row["bwd_plain_ms"] = cuda_ms(plain_bwd, reps=5)
                    row["fwd_bound_ms"], row["fwd_bound_by"] = k3_bound(
                        B, T, dot_dtype, False, E=E_, C=C_)
                    row["bwd_bound_ms"], row["bwd_bound_by"] = k3_bound(
                        B, T, dot_dtype, True, E=E_, C=C_)
                    print(f"{kernel} timed", json.dumps(row), flush=True)
                rows.append(row)
    return rows


# the tensor-core conv-FF's partial-sum depths (k16 columns a fresh f32
# partial of a conv GEMM spans; 0: every product chained inside the tensor
# cores; the weight gradients' partials span a 64-row chunk unless 0), the
# shapes they are held at (E = 128 and 512), the products held to exact
# sums, and how far past plain's distance the instance's depth may be
CONV_FF_SUMS = (64, 192, 0)
CONV_FF_SUMS_SHAPES = ("frame_rate", "wide_frame_rate")
CONV_FF_SUMS_PRODUCTS = ("out", "dx", "dw1", "db1", "dw2")
CONV_FF_SUMS_FACTOR = 1.5


def conv_ff_exact(x, w1, b1, w2, b2, ls, lb, film, g):
    """K3/K4's function at rate 0 with exact sums: the operands rounded to
    bf16 where the kernels round them (x, the weights, h, da2, da1),
    products, sums and LayerNorm in float64: (out, dx, dw1 (3, E, C), db1,
    dw2 (3, C, E))."""
    from daft_exprt_tpu_torch.ops.conv_ff_train import (_conv3, _conv3_t,
                                                        _shifts)

    def rnd(t):
        return t.to(torch.bfloat16).double()

    E_ = x.shape[-1]
    w1k, w2k = rnd(w1.permute(2, 1, 0)), rnd(w2.permute(2, 1, 0))
    xc = rnd(x)
    a1 = _conv3(xc, w1k) + b1.double()
    h = rnd(torch.relu(a1))
    r = _conv3(h, w2k) + b2.double() + x.double()
    mean = r.mean(-1, keepdim=True)
    inv = torch.rsqrt((r - mean).square().mean(-1, keepdim=True) + 1e-5)
    n = (r - mean) * inv
    fd, gd = film.double(), g.double()
    out = fd[:, None, :E_] * (n * ls.double() + lb.double()) + fd[:, None, E_:]
    dn = gd * fd[:, None, :E_] * ls.double()
    dr = (dn - dn.mean(-1, keepdim=True)
          - n * (dn * n).mean(-1, keepdim=True)) * inv
    da2c = rnd(dr)
    da1 = torch.where(a1 > 0, _conv3_t(da2c, w2k), 0.0)
    da1c = rnd(da1)
    dx = dr + _conv3_t(da1c, w1k)
    dw1 = torch.stack([torch.einsum("bte,btc->ec", s, da1c)
                       for s in _shifts(xc)])
    dw2 = torch.stack([torch.einsum("btc,bte->ce", s, da2c)
                       for s in _shifts(h)])
    return out, dx, dw1, da1.sum((0, 1)), dw2


def conv_ff_sums(gen, rng):
    """The tensor-core conv-FF's partial-sum depths against exact sums
    (conv_ff_exact) at E = 128 (K3's frame rate) and 512 (K4's), rate 0:
    each depth's relative L2 distance of every product's output from the
    exact one beside plain's (bf16 dots, float32 sums in torch.matmul's
    order), and its device ms (forward + backward, profiler). Fails unless
    the instance's depth (TC_SUM_K) is within CONV_FF_SUMS_FACTOR of
    plain's distance for every product. The other depths are timed only:
    no path runs them. As in check_conv_ff, the cotangent is zero on the
    three rows around each row with a conv1 pre-activation near zero
    (relu_tie_rows): there any sum order may take the other ReLU branch
    than the exact sums, which moves da1 by a whole value (one such row
    put the shipped depth at 5.7x plain's distance in dx and 28x in db1
    on an H100, where another draw of weights put it at 0.9x)."""
    from daft_exprt_tpu_torch.ops.conv_ff_train import (
        TC_SUM_K, conv_ff_backward_cuda, conv_ff_blocked_plain,
        conv_ff_blocked_plain_backward, conv_ff_forward_cuda, plan_conv_ff,
        tc_weights)

    bf = torch.bfloat16
    rows = []
    for name, B, T, E_, C_, _, _ in K3_SHAPES + K4_SHAPES:
        if name not in CONV_FF_SUMS_SHAPES:
            continue
        cb = plan_conv_ff(T, E_, C_, 3)
        kcb = None if cb == C_ else cb
        (w1, b1, w2, b2, ls, lb), _ = conv_ff_params(gen, rng, E_, C_)
        x = _cuda(rng.standard_normal((B, T, E_)).astype(np.float32))
        g = _cuda(rng.standard_normal((B, T, E_)).astype(np.float32))
        film = _cuda(np.concatenate([1 + 0.1 * rng.standard_normal((B, E_)),
                                     0.1 * rng.standard_normal((B, E_))],
                                    1).astype(np.float32))
        seeds = _cuda(np.zeros(B, np.int32))
        tie = relu_tie_rows(x, w1, b1, bf)
        near = tie.clone()
        near[:, 1:] |= tie[:, :-1]
        near[:, :-1] |= tie[:, 1:]
        g = g * (~near)[..., None]
        tw = tc_weights(w1, w2)
        args = (x, tw.w1, b1, tw.w2, b2, ls, lb, film, seeds)

        def run(sum_k):
            out = conv_ff_forward_cuda(*args, 0.0, bf, kcb, sum_k=sum_k)
            d = conv_ff_backward_cuda(*args, g, 0.0, bf, kcb,
                                      (tw.w1r, tw.w2r), sum_k=sum_k)
            return (out, d[0], d[1], d[2], d[3])

        def distances(got):
            return {n: _rel_l2(a, b) for n, a, b in
                    zip(CONV_FF_SUMS_PRODUCTS, got, exact)}

        exact = conv_ff_exact(x, w1, b1, w2, b2, ls, lb, film, g)
        pargs = (x, w1, b1, w2, b2, ls, lb, film, seeds)
        pout = conv_ff_blocked_plain(*pargs, 0.0, cb, bf)
        pg = conv_ff_blocked_plain_backward(*pargs, g, 0.0, cb, bf)
        row = {"shape": name, "B": B, "T": T, "E": E_, "C": C_,
               "relu_tie_rows": tie.float().mean().item(),
               "plain": distances((pout, pg[0], pg[1].permute(2, 1, 0),
                                   pg[2], pg[3].permute(2, 1, 0)))}
        for sum_k in CONV_FF_SUMS:
            row[f"k{sum_k}" if sum_k else "chained"] = {
                "exact_rel_l2": distances(run(sum_k)),
                "device_ms": device_ms(lambda: run(sum_k))}
        shipped = row[f"k{TC_SUM_K}"]["exact_rel_l2"]
        row["shipped_over_plain"] = {
            n: shipped[n] / row["plain"][n] for n in CONV_FF_SUMS_PRODUCTS}
        print("conv_ff sums", json.dumps(row), flush=True)
        rows.append(row)
        if max(row["shipped_over_plain"].values()) > CONV_FF_SUMS_FACTOR:
            raise AssertionError(
                f"conv_ff sums at {name}: k{TC_SUM_K} past "
                f"{CONV_FF_SUMS_FACTOR}x plain's distance from exact sums: "
                f"{row['shipped_over_plain']}")
    return rows


# K5 kernel vs plain, relative L2 at bf16 operands. Both round at the same
# points, but float32 sums in another order move a value across a bf16
# rounding boundary in a small share of the elements, and down a fan of 18
# convs with gain ~1 the flips spread to every sample: at the V1 stage-1
# shape, kernel and plain (cuDNN, TF32 off) are each about as far from the
# exact sums of the rounded operands (mrf_exact) as from each other. One
# unit (conv1, conv2 and the carry: every rounding point once) lets few
# flips travel. Each limit sits near the geometric mean of the largest
# kernel reading and the smallest control reading (plain without rounding,
# what a kernel that skipped its roundings computes) over the shapes
# checked with the tensor-core instance on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md): fan 3.60e-4 and 1.37e-3, unit 1.25e-5 and 1.35e-3.
K5_REL_TOL = {"fan": 7e-4, "unit": 1.3e-4}
V3_CONFIG = {"upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
             "upsample_initial_channel": 256, "resblock": "2",
             "resblock_kernel_sizes": [3, 5, 7],
             "resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]]}
SERVE_BUCKET = 512  # decoder frames of the timed audio requests


def k5_bound(B, N, program):
    """Least time for one K5 call: 2 C^2 FLOPs per output sample for each
    tap of the fan at the bf16 peak, against x read and out written once
    in float32, the bf16 taps and the float32 biases once."""
    taps, C = program.w_taps.shape[0], program.biases.shape[1]
    flops = 2.0 * B * N * C * C * taps
    nbytes = 2 * B * N * C * 4 + taps * C * C * 2 + program.biases.numel() * 4
    t_ops = flops / PEAK_FLOPS[torch.bfloat16]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def k5_work_factor(program, C):
    """Products K5 computes per product the fan needs, on paper from the
    tap program and the plan's tile: each conv computes the rows its later
    convs of the chain read (the tile plus what is left of the chain's
    halo). On the tensor-core instance, the busiest warpgroup's share: a
    conv's rows are whole m64 tiles, split between the two warpgroups at C
    = 64 and 32 (plan_mrf's kernel), so a conv costs ceil(tiles / split) x
    split x 64 rows."""
    from daft_exprt_tpu_torch.ops.mrf_vocoder import plan_mrf, tc_tile_split

    plan = plan_mrf(C, program.halo)
    tn, rg = plan.tile_rows, tc_tile_split(C)
    done = need = left = 0
    for k, d, _, flags, reach in program.desc.tolist():
        if flags & 1:  # a chain starts: its halo is the chain's reach
            left = reach
        left -= (k - 1) * d // 2
        rows = tn + 2 * left
        if plan.instance == "tensor_core":
            rows = -(-(-(-rows // 64)) // rg) * rg * 64
        done += rows * k
        need += tn * k
    return done / need


def staged_fan(gen, stage):
    """The same fan as separate cuDNN convs at bf16 (the generator's staged
    resblocks), on (B, N, C) like K5: the yardstick of what K5 fuses."""
    blocks = gen.stage_resblocks(stage)

    def run(x):
        xt = x.transpose(1, 2)
        acc = None
        for rb in blocks:
            y = rb(xt, torch.bfloat16)
            acc = y if acc is None else acc + y
        return acc / len(blocks)
    return run


def mrf_exact(x, program):
    """K5's function with exact sums: the operands rounded where K5 rounds
    them, products and sums in float64, each conv output and carry
    rounded to float32 where K5 stores it."""
    import torch.nn.functional as F

    from daft_exprt_tpu_torch.ops.mrf_vocoder import LRELU_SLOPE

    xt = x.double().transpose(1, 2)
    acc = None
    for chain in program.chains:
        cur = xt
        for unit in chain:
            t = cur
            for w, b, d in unit:
                a = F.leaky_relu(t.float(), LRELU_SLOPE).to(
                    torch.bfloat16).double()
                t = F.conv1d(a, w.to(torch.bfloat16).double(), dilation=d,
                             padding=(w.shape[-1] - 1) * d // 2)
                t = (t + b.double()[:, None]).float().double()
            cur = (cur.float() + t.float()).double()
        acc = cur.float() if acc is None else acc + cur.float()
    return (acc * (1.0 / len(program.chains))).transpose(1, 2)


def check_k5_plan(generators):
    """The wrapper's plan of K5's tensor-core instance (tile and shared
    memory) equals the built kernel's own count at every V1 and V3 stage
    it takes; every V1 stage takes it."""
    from daft_exprt_tpu_torch.ops.mrf_vocoder import (kernel_smem_bytes,
                                                      plan_mrf)

    plan = {}
    for name, gen in generators.items():
        for stage, program in gen.mrf_programs().items():
            C = program.biases.shape[1]
            mirror = plan_mrf(C, program.halo)
            if mirror.instance != "tensor_core":
                if name == "v1":
                    raise AssertionError(f"K5 plan V1 stage {stage}: {mirror}")
                continue
            built = kernel_smem_bytes(C, program.halo)
            if mirror.smem_bytes != built:
                raise AssertionError(f"K5 plan {name} stage {stage}: "
                                     f"{mirror}, kernel {built}")
            plan[f"{name}_stage{stage}"] = {
                "C": C, "halo": program.halo, "tile_rows": mirror.tile_rows,
                "smem_bytes": built, "blocks_per_sm": 232448 // built}
    print("K5 tensor-core plan", json.dumps(plan), flush=True)
    return plan


def check_k5():
    """K5 against its plain version at the V1 stage shapes of the serving
    batch (B=8, bucket 512; timed beside the staged cuDNN fan, with the
    profiler's device time), one unit of each V1 stage's first resblock at
    the same shapes, and edge shapes (untimed): N not a multiple of the
    tile, N under the halo, v3's ResBlock2 fan, C=16 and C=8. Each must be
    within its K5_REL_TOL of plain while the control (plain without
    rounding) exceeds it, give bit-identical output over two runs, and
    launch the tensor-core instance at C >= 32 (the CUDA-core one at C = 8
    and 16). At each timed V1 stage the kernel must be no further from the
    exact sums of its rounded operands (mrf_exact, the first 4,096 samples
    of one row) than plain is. The V1 pass (the three timed stages) must
    be faster than the staged bf16 cuDNN fan."""
    from daft_exprt_tpu_torch.ops.mrf_vocoder import (build_mrf_program,
                                                      mrf_plain)

    v1 = HiFiGanGenerator(seed=0)
    v3 = HiFiGanGenerator(V3_CONFIG, seed=1)
    narrow = HiFiGanGenerator({"upsample_initial_channel": 64}, seed=2)
    plan = check_k5_plan({"v1": v1, "v3": v3})
    rng = np.random.default_rng(8)
    rates = v1.cfg["upsample_rates"]
    cases = []  # (name, program, B, N, limit, generator and stage if timed)
    for stage in (1, 2, 3):
        N = SERVE_BUCKET * int(np.prod(rates[:stage + 1]))
        cases.append((f"v1_stage{stage}", v1.mrf_programs()[stage], 8, N,
                      "fan", (v1, stage)))
        unit = v1.stage_resblocks(stage)[0].units()[0]
        cases.append((f"v1_stage{stage}_unit", build_mrf_program(
            [[[(p.weight, p.bias, d) for p, d in unit]]]), 8, N, "unit",
            None))
    cases += [
        ("edge_ragged_C128", v1.mrf_programs()[1], 2, 1000, "fan", None),
        ("edge_under_halo_C64", v1.mrf_programs()[2], 3, 37, "fan", None),
        ("edge_v3_resblock2_C32", v3.mrf_programs()[2], 2, 5000, "fan",
         None),
        ("edge_C16", narrow.mrf_programs()[1], 2, 3001, "fan", None),
        ("edge_C8", narrow.mrf_programs()[2], 1, 2500, "fan", None)]
    rows = []
    for name, program, B, N, kind, timed in cases:
        C = program.biases.shape[1]
        x = _cuda((0.5 * rng.standard_normal((B, N, C))).astype(np.float32))
        before = fused_mrf.tc_launches
        out = fused_mrf(x, program)
        again = fused_mrf(x, program)
        torch.cuda.synchronize()
        tc = fused_mrf.tc_launches - before
        if tc != (2 if C >= 32 else 0):
            raise AssertionError(f"K5 {name}: {tc} of 2 launches on the "
                                 "tensor-core instance")
        if not torch.equal(out, again):
            raise AssertionError(f"K5 {name}: two runs differ")
        ref = mrf_plain(x, program)
        control = mrf_plain(x, program, dot_dtype=torch.float32)
        limit = K5_REL_TOL[kind]
        row = {"shape": name, "B": B, "N": N, "C": C,
               "instance": "tensor_core" if C >= 32 else "cuda_core",
               "taps": program.w_taps.shape[0], "halo": program.halo,
               "max_abs_err": (out - ref).abs().max().item(),
               "rel_l2": _rel_l2(out, ref),
               "control_rel_l2": _rel_l2(control, ref), "limit": limit}
        print("K5", json.dumps(row), flush=True)
        if not (bool(torch.isfinite(out).all())
                and row["rel_l2"] <= limit < row["control_rel_l2"]):
            raise AssertionError(f"K5 disagrees with plain: {row}")
        if timed:
            # kernel and plain sum in float32 in other orders: the kernel's
            # partial sums (64 input channels of a tap at C = 128 and 64, a
            # tap at 32), added with rounded float32 adds, must leave it no
            # further from the exact sums
            xs = x[:1, :4096]
            exact = mrf_exact(xs, program)
            row["exact_rel_l2"] = {
                "kernel": _rel_l2(fused_mrf(xs, program), exact),
                "plain": _rel_l2(mrf_plain(xs, program), exact)}
            print(f"K5 {name} vs exact sums",
                  json.dumps(row["exact_rel_l2"]), flush=True)
            if not row["exact_rel_l2"]["kernel"] \
                    <= row["exact_rel_l2"]["plain"]:
                raise AssertionError(f"K5 further from the exact sums than "
                                     f"plain: {row}")
            staged = staged_fan(*timed)
            row["ms"] = cuda_ms(lambda: fused_mrf(x, program))
            row["device_ms"] = device_ms(lambda: fused_mrf(x, program),
                                         reps=5)
            row["plain_ms"] = cuda_ms(lambda: mrf_plain(x, program), reps=5)
            row["staged_cudnn_ms"] = cuda_ms(lambda: staged(x))
            row["bound_ms"], row["bound_by"] = k5_bound(B, N, program)
            row["work_factor"] = k5_work_factor(program, C)
            row["plan"] = plan[f"v1_stage{timed[1]}"]
            print("K5 timed", json.dumps(row), flush=True)
        rows.append(row)
    timed = [r for r in rows if "ms" in r]
    ms = sum(r["ms"] for r in timed)
    staged = sum(r["staged_cudnn_ms"] for r in timed)
    print(f"K5 V1 pass: {ms} ms, staged bf16 cuDNN fan {staged} ms",
          flush=True)
    if not ms < staged:
        raise AssertionError(f"K5's V1 pass ({ms} ms) is not faster than the "
                             f"staged bf16 cuDNN fan ({staged} ms)")
    exact = [{"shape": r["shape"], "C": r["C"], **r["exact_rel_l2"]}
             for r in timed]
    return rows, plan, exact


def make_request(hp, rng, B, L, T_ref, dur_scale, pitch_transform):
    """One synthetic request batch: row 0 has L symbols and a T_ref-frame
    reference, the others are shorter."""
    sentences, refs, durs, pitch = [], [], [], []
    for b in range(B):
        n = L if b == 0 else int(rng.integers(L // 2 + 1, L + 1))
        sentences.append([hp.symbols[i]
                          for i in rng.integers(1, hp.n_symbols, size=n)])
        t = T_ref if b == 0 else int(rng.integers(T_ref // 2, T_ref + 1))
        refs.append({"energy": np.abs(rng.standard_normal(t)) + 1.0,
                     "pitch": rng.standard_normal(t),
                     "mel_spec": rng.standard_normal((hp.n_mel_channels, t))})
        durs.append(np.full(n, dur_scale, np.float32))
        pitch.append((rng.uniform(-20, 20, size=n) if pitch_transform == "add"
                      else rng.uniform(0.8, 1.2, size=n)).astype(np.float32))
    speakers = rng.integers(0, len(hp.speakers), size=B)
    inputs, _ = collate_inference_batch(sentences, durs, None, pitch,
                                        pitch_transform, refs, speakers, hp)
    return inputs


def pin_durations(model):
    """Duration head -> 0.12 s per phone: random weights predict ~0 s
    (empty outputs); checkpoints predict tens of frames per sentence."""
    proj = model.prosody_predictor.projection.linear_layer
    with torch.no_grad():
        proj.weight[0].zero_()
        proj.bias[0].fill_(0.12)


def check_outputs(out, engine, B):
    enc, (mel, out_lens, overflow), _ = out
    T = mel.shape[-1]
    if T not in engine.out_frame_buckets or mel.shape[:2] != (B, 80):
        raise AssertionError(f"mel shape {mel.shape} not a bucket shape")
    if not np.isfinite(mel).all():
        raise AssertionError("non-finite mel")
    if (out_lens > T).any() or (out_lens < 1).any():
        raise AssertionError(f"output lengths {out_lens} outside (0, {T}]")
    for b in range(B):
        if (mel[b, :, out_lens[b]:] != 0).any():
            raise AssertionError("mel not zero past its length")
    if (np.minimum(enc[1].sum(1), T) != out_lens).any() \
            or ((enc[1].sum(1) > T) != overflow).any():
        raise AssertionError("output lengths disagree with durations")
    return T, int(out_lens.sum())


def serve(hp):
    """Phase 3: requests through the engine at flagship width."""
    model = DaftExprt(hp, seed=0)
    pin_durations(model)
    engines = {p: InferenceEngine(model, None, hp, bucket_policy=p)
               for p in ("speculate", "measure")}
    engines["speculate_rerun"] = InferenceEngine(
        model, None, flagship_hparams(stats=LOW_DURATION_STATS),
        bucket_policy="speculate")
    rng = np.random.default_rng(1)
    # (engine, pitch transform, duration factor); L=64 symbols and 512
    # reference frames, B=8. Speculation from the default per-symbol stats
    # picks the full 2048 budget at factor 1 and 512 at 0.25; measure
    # picks 512 from the predicted frames at 0.6 and 0.55; speculation
    # from the low stats picks 512 for ~660 predicted frames, overflows
    # and re-runs at 2048.
    plan = [("speculate", "add", 1.0), ("speculate", "multiply", 0.25),
            ("measure", "add", 0.6), ("measure", "multiply", 0.55),
            ("speculate_rerun", "add", 1.0)]
    requests = [(p, pt, make_request(hp, rng, 8, 64, 512, d, pt))
                for p, pt, d in plan]
    for eng in engines.values():
        eng.passes = 0
    # the main path: counters from zero, two rounds, then a third under
    # the profiler (every pass a graph replay, K1 counted on the device)
    fused_fft_block.launches = fused_fft_block.tc_launches = 0
    fused_fft_block.captured = fused_fft_block.tc_captured = 0
    rows = []
    for rnd in range(2):  # round 0 warms up; round 1 is timed
        for name, pt, inputs in requests:
            engine = engines[name]
            passes = engine.passes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.run(inputs, pt, want_weights=False)
            latency = time.perf_counter() - t0
            T, frames = check_outputs(out, engine, 8)
            if rnd == 1:
                row = {"engine": name, "policy": engine.bucket_policy,
                       "pitch_transform": pt, "bucket": T,
                       "passes": engine.passes - passes, "frames": frames,
                       "latency_ms": latency * 1e3,
                       "frames_per_s": frames / latency}
                rows.append(row)
                print("request", json.dumps(row), flush=True)
    served = _launches(None, *engines.values())
    passes = sum(e.passes for e in engines.values())
    before = _counts(*engines.values())
    prof = profile_kernels(lambda: [
        engines[name].run(inputs, pt, want_weights=False)
        for name, pt, inputs in requests], K1_GROUPS)
    metered = {"passes": sum(e.passes for e in engines.values()) - passes,
               **_launches(before, *engines.values()),
               "on_device": (prof or {}).get("on_device")}
    n_blocks = fft_blocks(hp)
    print(f"serving: {passes} inference passes, K1 launches "
          f"{json.dumps(served)} (expected {n_blocks} x {passes} in all); "
          f"a third round of {metered['passes']} passes, K1 counted on "
          f"the device {json.dumps(metered)}", flush=True)
    if served["k1_total"] != n_blocks * passes or served["k1"] == 0 \
            or served["k1_tensor_core_total"] != served["k1_total"] \
            or served["k1_tensor_core"] != served["k1"] \
            or fused_fft_block.captured != served["k1"]:
        # every launch at the wrappers was a first call's eager run, and
        # its capture recorded as many
        raise AssertionError(f"K1 launches {served} (captured "
                             f"{fused_fft_block.captured}) != {n_blocks} x "
                             f"{passes} passes")
    check_on_device(prof, {"k1": n_blocks * metered["passes"], "k5": 0},
                    "the third serving round")
    if metered["k1"] != 0 or metered["k1_replayed"] \
            != metered["on_device"]["k1"]:
        raise AssertionError(f"the third serving round's replays: "
                             f"{metered}")
    rerun = next(r for r in rows if r["engine"] == "speculate_rerun")
    if rerun["passes"] != 2 or rerun["bucket"] != hp.max_frames:
        raise AssertionError(f"undershooting speculation: {rerun}, expected "
                             f"a re-run at {hp.max_frames} frames")
    # the main path's launches: at the wrappers (first calls: an eager run,
    # then a capture), derived from replays, and counted on the device
    return rows, {"all": fused_fft_block.launches,
                  "tensor_core": fused_fft_block.tc_launches,
                  "captured": fused_fft_block.captured,
                  "replayed": served["k1_replayed"] + metered["k1_replayed"],
                  "on_device": metered["on_device"]["k1"],
                  "on_device_passes": metered["passes"]}, engines, requests


def fft_blocks(hp):
    """FFT blocks of one inference pass (K1 launches)."""
    return sum(hp.__dict__[m]["nb_blocks"] for m in
               ("prosody_encoder", "phoneme_encoder", "frame_decoder"))


# K1's kernels by instance (csrc/fft_block_tc.cu, csrc/fft_block.cu)
K1_TC_KERNELS = ("qkv_wgmma_kernel", "attn_wgmma_kernel", "conv_wgmma_kernel")
K1_KERNELS = ("qkv_kernel", "attention_kernel", "outproj_ln_kernel",
              "conv_ff_kernel") + K1_TC_KERNELS
K1_GROUPS = {"k1_ms": K1_KERNELS, "k1_tensor_core_ms": K1_TC_KERNELS}


def k1_all_tensor_core(report, what):
    """Raise unless K1's device time in a profiled run is all in its
    tensor-core kernels."""
    if report is not None \
            and not 0 < report["k1_tensor_core_ms"] == report["k1_ms"]:
        raise AssertionError(f"K1's device time in {what} is not all on "
                             f"its tensor-core kernels: {report}")


def profile_kernels(run, groups):
    """Device time by kernel for one call of ``run`` (torch.profiler),
    the device's idle share of its wall time under the profiler, and the
    device ms of each named group of kernels."""
    return kernel_report(*profiled(run), groups)


def profiled(run, cuda=True):
    """One call of ``run`` under ``torch.profiler`` (the host's activity
    and, with ``cuda``, the device's): (the finished profiler, the call's
    host milliseconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def range_launches(prof, name):
    """Device operations (kernels, copies, sets) launched inside the
    ``torch.profiler.record_function`` range ``name`` of a finished
    profiler run: those attached to the CPU ops that ran within the range
    on its thread. None when the trace holds no such range."""
    cpu = torch.autograd.DeviceType.CPU
    events = [e for e in prof.events() if e.device_type == cpu]
    spans = [e for e in events if e.name == name]
    if not spans:
        return None
    return sum(len(e.kernels) for span in spans for e in events
               if e is not span and e.thread == span.thread
               and span.time_range.start <= e.time_range.start
               and e.time_range.end <= span.time_range.end)


# the kernel that each wrapper call launches once: K1's first (qkv), K5's
# only; its instances on the tensor cores
ON_DEVICE = {"k1": r"(?<!\w)qkv_(wgmma_)?kernel<",
             "k1_tensor_core": r"(?<!\w)qkv_wgmma_kernel<",
             "k5": r"(?<!\w)mrf_(wgmma_)?kernel<",
             "k5_tensor_core": r"(?<!\w)mrf_wgmma_kernel<"}


def kernel_report(prof, wall_ms, groups):
    """``profile_kernels``'s report from a finished ``torch.profiler``
    run of ``wall_ms`` host milliseconds; None without device time.
    ``on_device``: K1's and K5's launches counted in the trace (a kernel
    of a graph replay is traced like any other); ``graph_launches``: the
    host's ``cudaGraphLaunch`` calls in it."""
    kernels = {}
    graph_launches = sum(
        e.name.startswith(GRAPH_LAUNCH) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU)
    for ev in prof.key_averages():
        # a record_function range also leaves a device-side span
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False):
            continue
        ms, n = kernels.get(ev.key, (0.0, 0))
        kernels[ev.key] = (ms + ev.self_device_time_total / 1e3,
                           n + ev.count)
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0.0:
        print("profile: the profiler recorded no device time", flush=True)
        return None
    report = {"wall_ms": wall_ms, "device_busy_ms": busy,
              "idle_share": 1.0 - busy / wall_ms,
              "launches": sum(n for _, n in kernels.values()),
              "graph_launches": graph_launches,
              "on_device": {k: sum(n for name, (_, n) in kernels.items()
                                   if re.search(pattern, name))
                            for k, pattern in ON_DEVICE.items()}}
    for group, names in groups.items():
        report[group] = sum(ms for name, (ms, _) in kernels.items()
                            if any(k in name for k in names))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:14]
    report["top"] = [{"kernel": name[:90], "ms": ms, "count": n}
                     for name, (ms, n) in top]
    return report


def check_on_device(report, want, what):
    """Raise unless a profiled run's K1 and K5 launches counted on the
    device are ``want`` ({"k1": n, "k5": m}), every one on the
    tensor-core instances."""
    got = (report or {}).get("on_device")
    if got is None or not all(got[k] == n == got[f"{k}_tensor_core"]
                              for k, n in want.items()):
        raise AssertionError(
            f"{what}: launches on the device {got}, expected {want}, all "
            f"on the tensor cores; the trace's cudaGraphLaunch calls "
            f"{(report or {}).get('graph_launches')}")


def profile_request(engine, inputs, pitch_transform):
    """Device time by kernel for one request, after one unprofiled run;
    K1's launches counted on the device, 12 a pass."""
    engine.run(inputs, pitch_transform, want_weights=False)
    passes = engine.passes
    report = profile_kernels(
        lambda: engine.run(inputs, pitch_transform, want_weights=False),
        K1_GROUPS)
    print("profile", json.dumps(report), flush=True)
    k1_all_tensor_core(report, "the mel request")
    check_on_device(report, {"k1": fft_blocks(engine.hp)
                             * (engine.passes - passes), "k5": 0},
                    "the profiled mel request")
    return report


def check_against_cpu(make_hp=flagship_hparams):
    """A small float32 request of the configuration ``make_hp`` gives on
    the card against the same model on the CPU (plain versions
    everywhere)."""
    hp = make_hp(compute_dtype="float32")
    rng = np.random.default_rng(2)
    inputs = make_request(hp, rng, 2, 16, 64, 1.0, "add")
    outs = []
    for device in ("cuda", "cpu"):
        model = DaftExprt(hp, device=device, seed=0)
        pin_durations(model)
        eng = InferenceEngine(model, None, hp, device=device,
                              bucket_policy="measure")
        outs.append(eng.run(inputs, "add", want_weights=False))
    (g_enc, g_dec, _), (c_enc, c_dec, _) = outs
    if not (np.array_equal(g_enc[1], c_enc[1])
            and np.array_equal(g_dec[1], c_dec[1])):
        raise AssertionError("card and CPU disagree on durations")
    err = float(np.abs(g_dec[0] - c_dec[0]).max())
    print(f"f32 card vs CPU: mel max abs err {err} (tol 1e-3), "
          f"frames {c_dec[1].tolist()}", flush=True)
    if not err <= 1e-3:
        raise AssertionError(f"card vs CPU mel max abs err {err} > 1e-3")
    return err


def time_duration_cumsum(hp):
    """Host wall time per call (synchronized, median of 50) of the
    durations' blocked cumsum on the card against one ``torch.cumsum``,
    and of the whole ``durations_to_int_frames``, at B=8 and the serving
    symbol counts; the blocked cumsum must be bit-equal to the CPU's."""
    from daft_exprt_tpu_torch.ops.durations import (blocked_cumsum,
                                                    durations_to_int_frames)

    def wall_us(fn, reps=50):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e6

    rng = np.random.default_rng(7)
    report = {}
    for L in (64, 256):
        d_cpu = torch.from_numpy(rng.uniform(0.02, 0.2, size=(8, L)).astype(
            np.float32))
        d = d_cpu.cuda()
        if not torch.equal(blocked_cumsum(d).cpu(), blocked_cumsum(d_cpu)):
            raise AssertionError(f"blocked cumsum: card and CPU differ, L={L}")
        report[f"L{L}"] = {
            "blocked_cumsum_us": wall_us(lambda: blocked_cumsum(d)),
            "torch_cumsum_us": wall_us(lambda: torch.cumsum(d, -1)),
            "durations_to_int_frames_us": wall_us(
                lambda: durations_to_int_frames(d, hp.sampling_rate,
                                                hp.filter_length,
                                                hp.hop_length))}
    print("durations cumsum", json.dumps(report), flush=True)
    return report


K5_TC_KERNELS = ("mrf_wgmma_kernel",)
K5_KERNELS = ("mrf_kernel",) + K5_TC_KERNELS
# cuDNN's conv and transposed-conv kernels: names vary with the algorithm
CUDNN_KERNELS = ("xmma", "cudnn", "implicit", "convolve", "dgrad", "fprop",
                 "winograd", "fft")
SAMPLE_RATE = 22050
HOP = 256


def _np_rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def check_wavs(wavs, out_lens, overflow, keys):
    """Each keyed row: out_lens * 256 samples, finite, within [-1, 1]
    (tanh); no row left truncated. :return: samples of the keyed rows."""
    if overflow.any():
        raise AssertionError(f"rows still truncated: {overflow}")
    samples = 0
    for b, key in enumerate(keys):
        if key is None:  # padding row: its output is the caller's to crop
            continue
        wav = wavs[b]
        if wav.shape != (int(out_lens[b]) * HOP,) or out_lens[b] < 1:
            raise AssertionError(f"row {b}: {wav.shape} samples for "
                                 f"{out_lens[b]} frames")
        if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0):
            raise AssertionError(f"row {b}: non-finite or |x| > 1")
        samples += wav.size
    return samples


def serve_audio(model, gen):
    """Text -> waveform at flagship width: a V1 generator attached to the
    flagship engine, 5 requests through ``run_cached_to_audio`` (B=8, L=64,
    reference T=512): a cold style, the same keys again, a padding row,
    half the rows on new styles, and a speculation from low duration stats
    that undershoots 512 and re-runs at 2048. Counters around each
    request (at the wrappers plus, derived, the graph replays'): K5 3 per
    pass; K1 8 per pass (phoneme encoder and decoder) plus 4 per
    prosody-encoder batch of the FiLM cache; then the five again from a
    cleared FiLM cache under the profiler, every pass a replay, with the
    same counts on the device."""
    engines = {"audio": InferenceEngine(model, None, flagship_hparams()),
               "audio_rerun": InferenceEngine(model, None, flagship_hparams(
                   stats=LOW_DURATION_STATS))}
    for engine in engines.values():
        engine.attach_vocoder(gen)
    hp = engines["audio"].hp
    rng = np.random.default_rng(11)
    keys = [(f"style_{i}", i) for i in range(8)]
    new = keys[:4] + [(f"style_{i}", i - 8) for i in range(8, 12)]
    # (request, engine, pitch transform, duration factor, keys, prosody-
    # encoder batches): factor 0.25 speculates bucket 512 at the default
    # stats; the low stats speculate 512 for ~660 frames and re-run at 2048
    plan = [("cold_style", "audio", "add", 0.25, keys, 1),
            ("cached_style", "audio", "multiply", 0.25, keys, 0),
            ("padding_row", "audio", "add", 0.25, keys[:7] + [None], 0),
            ("half_new_styles", "audio", "multiply", 0.25, new, 1),
            ("overflow_rerun", "audio_rerun", "add", 1.0, keys, 1)]
    requests = [(label, engines[name], pt,
                 make_request(hp, rng, 8, 64, 512, d, pt), k, fb)
                for label, name, pt, d, k, fb in plan]
    # the main path: counters from zero, a warm-up pass of each request's
    # shape (first calls: an eager run and a capture), the requests, then
    # the same again under the profiler (every pass a replay, counted on
    # the device)
    fused_fft_block.launches = fused_fft_block.tc_launches = 0
    fused_mrf.launches = fused_mrf.tc_launches = 0
    fused_mrf.captured = fused_mrf.tc_captured = 0
    both = list(engines.values())
    start = _counts(*both)
    warm = [("warm-up", i) for i in range(8)]
    for _, engine, pt, inputs, _, _ in requests:
        engine.run_cached_to_audio(inputs, pt, warm)
    for engine in engines.values():
        engine.films.clear()
    torch.cuda.synchronize()
    rows = []
    for label, engine, pt, inputs, k, want_fb in requests:
        before = _counts(engine)
        passes, fb = engine.passes, engine.film_batches
        t0 = time.perf_counter()
        wavs, out_lens, overflow = engine.run_cached_to_audio(inputs, pt, k)
        latency = time.perf_counter() - t0
        got = _launches(before, engine)
        passes, fb = engine.passes - passes, engine.film_batches - fb
        samples = check_wavs(wavs, out_lens, overflow, k)
        row = {"request": label, "pitch_transform": pt,
               "speculated_bucket": engine._buckets.speculate(inputs),
               "passes": passes, "prosody_encoder_batches": fb,
               "launches": got,
               "frames": int(sum(out_lens[b] for b, key in enumerate(k)
                                 if key is not None)),
               "latency_ms": latency * 1e3,
               "samples_per_s": samples / latency,
               "x_realtime": samples / SAMPLE_RATE / latency}
        print("audio request", json.dumps(row), flush=True)
        if fb != want_fb or got["k5_total"] != 3 * passes \
                or got["k5_tensor_core_total"] != got["k5_total"] \
                or got["k1_total"] != 8 * passes + 4 * fb \
                or got["k1_tensor_core_total"] != got["k1_total"]:
            raise AssertionError(f"audio request launches: {row}")
        rows.append(row)
    for engine in both:
        engine.films.clear()
    before = _counts(*both)
    passes = [sum(e.passes for e in both), sum(e.film_batches for e in both)]
    prof = profile_kernels(lambda: [
        engine.run_cached_to_audio(inputs, pt, k)
        for _, engine, pt, inputs, k, _ in requests],
        {"k5_ms": K5_KERNELS})
    passes = [sum(e.passes for e in both) - passes[0],
              sum(e.film_batches for e in both) - passes[1]]
    metered = {"passes": passes[0], "prosody_encoder_batches": passes[1],
               **_launches(before, *both),
               "on_device": (prof or {}).get("on_device")}
    print("audio requests again, counted on the device",
          json.dumps(metered), flush=True)
    check_on_device(prof, {"k1": 8 * passes[0] + 4 * passes[1],
                           "k5": 3 * passes[0]},
                    "the audio requests under the profiler")
    if metered["k5"] or metered["k1"] \
            or metered["k5_replayed"] != metered["on_device"]["k5"] \
            or metered["k1_replayed"] != metered["on_device"]["k1"]:
        raise AssertionError(f"the audio requests' replays: {metered}")
    served = _launches(start, *both)
    if fused_mrf.captured != fused_mrf.launches:
        raise AssertionError(f"K5: {fused_mrf.launches} eager launches, "
                             f"{fused_mrf.captured} captured")
    # the main path's launches: at the wrappers (first calls), derived from
    # replays, and counted on the device in the profiled round
    launches = {"all": fused_mrf.launches,
                "tensor_core": fused_mrf.tc_launches,
                "captured": fused_mrf.captured,
                "replayed": served["k5_replayed"],
                "on_device": metered["on_device"]["k5"],
                "k1": fused_fft_block.launches,
                "k1_tensor_core": fused_fft_block.tc_launches,
                "k1_replayed": served["k1_replayed"],
                "k1_on_device": metered["on_device"]["k1"]}
    rerun = rows[-1]
    if rerun["passes"] != 2 or rerun["speculated_bucket"] >= hp.max_frames:
        raise AssertionError(f"undershooting speculation: {rerun}")
    if any(r["passes"] != 1 or r["speculated_bucket"] != SERVE_BUCKET
           for r in rows[:-1]):
        raise AssertionError(f"expected one pass at {SERVE_BUCKET}: {rows}")
    return rows, launches, engines, requests


def audio_equals_two_step(engine, gen, request):
    """The fused path equals run_cached -> crop -> vocode_mels on the same
    batch, row for row (keyed rows; every key is cached by now)."""
    from daft_exprt_tpu_torch.vocoder.hifigan import vocode_mels

    _, _, pt, inputs, keys, _ = request
    wavs, out_lens, _ = engine.run_cached_to_audio(inputs, pt, keys)
    _, (mel, lens, _), _ = engine.run_cached(inputs, pt, keys,
                                             want_weights=False)
    if not np.array_equal(lens, out_lens):
        raise AssertionError("two-step lengths differ")
    ref = vocode_mels(gen, [mel[b, :, :lens[b]] for b in range(len(keys))],
                      bucket=mel.shape[-1], max_batch=len(keys))
    err = max(float(np.abs(wavs[b] - ref[b]).max())
              for b, k in enumerate(keys) if k is not None)
    print(f"audio vs run_cached -> vocode_mels: max abs err {err}",
          flush=True)
    if err != 0.0:
        raise AssertionError(f"fused audio differs from the two-step path "
                             f"by {err}")
    return err


def profile_audio(engine, request):
    """Device time by kernel group for one audio request, after one
    unprofiled run (every key cached)."""
    _, _, pt, inputs, keys, _ = request
    engine.run_cached_to_audio(inputs, pt, keys)
    passes = engine.passes
    report = profile_kernels(
        lambda: engine.run_cached_to_audio(inputs, pt, keys),
        {**K1_GROUPS, "k5_ms": K5_KERNELS,
         "k5_tensor_core_ms": K5_TC_KERNELS, "cudnn_conv_ms": CUDNN_KERNELS})
    k1_all_tensor_core(report, "the audio request")
    passes = engine.passes - passes
    check_on_device(report, {"k1": 8 * passes, "k5": 3 * passes},
                    "the profiled audio request")
    if report is not None:
        if not 0 < report["k5_tensor_core_ms"] == report["k5_ms"]:
            raise AssertionError("K5's device time in the audio request is "
                                 "not all on its tensor-core kernel")
        report["rest_ms"] = report["device_busy_ms"] - report["k1_ms"] \
            - report["k5_ms"] - report["cudnn_conv_ms"]
        report["k5_share"] = report["k5_ms"] / report["device_busy_ms"]
    print("audio profile", json.dumps(report), flush=True)
    return report


# stream vs vocode_mels (float32 staged convs, TF32 off): every kept sample
# sees the same inputs, but cuDNN may pick another algorithm at the
# window's shape than at the utterance's, and a float32 difference can flip
# a bf16 rounding inside K5 that then travels down the fans (relative L2
# 1.3e-3 on an NVIDIA H100 80GB HBM3 at 700 W). The control, a stream
# whose windows keep 1 frame of context, must exceed the limit.
STREAM_REL_TOL = 1e-2


def eager_cache(device):
    """A graph cache whose entries run eagerly on the card (the CPU's
    bookkeeping): the eager side of a replay's comparison."""
    cache = GraphCache(device)
    cache.cuda = False
    return cache


@contextlib.contextmanager
def eager_vocoder(gen, cache):
    """``gen.replayed`` through ``cache`` (``eager_cache``), the
    generator's own cache put back after."""
    gen.graphs()  # current, made if missing
    saved = gen._graphs
    gen._graphs = (saved[0], cache)
    try:
        yield
    finally:
        gen._graphs = saved


STREAM_ROUNDS = 5  # one window eager, replayed, replayed, eager a round


def vocode_replay(gen, mel, bucket):
    """``vocode_mels`` on a second mel (``mel`` reversed in time) of a
    bucket whose graph is captured: a replay, with no capture and no K5
    launch at the wrappers, bit-equal to the same call with the
    generator's graphs run eagerly, and K5's 3 launches of the bucket
    counted on the device in a profiled replay."""
    from daft_exprt_tpu_torch.vocoder.hifigan import vocode_mels

    other = np.ascontiguousarray(mel[:, ::-1])
    vg = vocoder_graphs(gen)
    captures, replays = vg.graphs.captures, vg.graphs.replays
    before = _counts(vg)
    got = vocode_mels(gen, [other], bucket=bucket)[0]
    launches = _launches(before, vg)
    with eager_vocoder(gen, eager_cache(gen.device)):
        want = vocode_mels(gen, [other], bucket=bucket)[0]
    prof = profile_kernels(lambda: vocode_mels(gen, [other], bucket=bucket),
                           {"k5_ms": K5_KERNELS})
    report = {"bucket": bucket, "samples": int(got.size),
              "bit_equal": bool(np.array_equal(got, want)),
              "captures": vg.graphs.captures - captures,
              "replays": vg.graphs.replays - replays,
              "launches": launches,
              "on_device": prof and prof["on_device"]}
    print("vocode_mels replayed", json.dumps(report), flush=True)
    if not report["bit_equal"] or report["captures"] \
            or report["replays"] != 2 or launches["k5"] != 0 \
            or launches["k5_replayed"] != 3 or not np.isfinite(got).all():
        raise AssertionError(f"vocode_mels replayed against eager: {report}")
    check_on_device(prof, {"k5": 3, "k1": 0},
                    "a replayed vocode_mels bucket")
    return report


def stream_utterance(engine, gen, request):
    """One long utterance (the longest row of the overflow request's mel)
    through StreamingVocoder, every window a replay of the generator's
    window graph: its chunks bit-equal to the same stream with every
    window run eagerly, and within ``STREAM_REL_TOL`` of vocode_mels of
    the same mel padded by the halo (a halo of 1 the control); K5's
    launches of a replayed stream none at the wrappers and 3 a window on
    the device (profiled); time to the first chunk and total, after one
    warm-up stream, replayed and eager; one window's dispatch and copy
    replayed against eager in alternating rounds."""
    from daft_exprt_tpu_torch.vocoder.hifigan import vocode_mels
    from daft_exprt_tpu_torch.vocoder.streaming import StreamingVocoder

    _, _, pt, inputs, keys, _ = request
    _, (mel, lens, _), _ = engine.run_cached(inputs, pt, keys,
                                             want_weights=False)
    b = int(np.argmax(lens))
    T = int(lens[b])
    mel = mel[b, :, :T]
    sv = StreamingVocoder(gen)
    ref = vocode_mels(gen, [mel], bucket=T + sv.halo)[0]
    sv.vocode(mel)  # the window's eager pass and capture

    def timed_stream():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks, first = [], None
        for chunk in sv.stream(mel):
            if first is None:
                first = time.perf_counter() - t0
            chunks.append(chunk)
        return chunks, first, time.perf_counter() - t0

    vg = vocoder_graphs(gen)
    captures = vg.graphs.captures
    before = _counts(vg)
    chunks, first, total = timed_stream()
    launches = _launches(before, vg)
    eager = eager_cache(gen.device)
    with eager_vocoder(gen, eager):
        sv.vocode(mel)  # the eager entry's static input made
        eager_chunks, eager_first, eager_total = timed_stream()
    bit_equal = len(chunks) == len(eager_chunks) and all(
        np.array_equal(a, b) for a, b in zip(chunks, eager_chunks))
    got = np.concatenate(chunks)
    if got.shape != ref.shape:
        raise AssertionError(f"stream {got.shape} vs {ref.shape}")
    prof = profile_kernels(lambda: list(sv.stream(mel)),
                           {"k5_ms": K5_KERNELS,
                            "k5_tensor_core_ms": K5_TC_KERNELS})
    # one window: dispatch, copy and wait, replayed against eager
    window = np.full((mel.shape[0], sv.window), np.log(1e-5), np.float32)
    window[:, :min(T, sv.window)] = mel[:, :sv.window]
    buffers = sv._buffers()

    def one_window():
        sv._dispatch(window, slice(0, sv.chunk * sv.up), *buffers[0])()

    def in_eager():
        with eager_vocoder(gen, eager):
            one_window()
    window_ms = alternating_ms({"eager": in_eager, "replayed": one_window},
                               rounds=STREAM_ROUNDS)
    recaptured = vg.graphs.captures - captures
    buckets = vocode_replay(gen, mel, T + sv.halo)
    control = StreamingVocoder(gen, halo_frames=1).vocode(mel)
    report = {"frames": T, "chunk_frames": sv.chunk, "halo_frames": sv.halo,
              "windows": len(chunks), "first_chunk_ms": first * 1e3,
              "total_ms": total * 1e3,
              "eager_first_chunk_ms": eager_first * 1e3,
              "eager_total_ms": eager_total * 1e3,
              "window_ms": window_ms,
              "x_realtime": got.size / SAMPLE_RATE / total,
              "replays_equal_eager": bit_equal,
              "captures_after_warm_up": recaptured,
              "vocode_mels_replay": buckets,
              "launches": launches,
              "graphs": graph_report(vg),
              "profile": prof,
              "max_abs_err": float(np.abs(got - ref).max()),
              "rel_l2": _np_rel_l2(got, ref),
              "control_rel_l2": _np_rel_l2(control, ref),
              "limit": STREAM_REL_TOL}
    print("stream", json.dumps(report), flush=True)
    if not report["rel_l2"] <= STREAM_REL_TOL < report["control_rel_l2"]:
        raise AssertionError(f"stream differs from vocode_mels: {report}")
    if not bit_equal or recaptured or launches["k5"] != 0 \
            or launches["k5_replayed"] != 3 * len(chunks):
        raise AssertionError(f"replayed stream: {report}")
    check_on_device(prof, {"k5": 3 * len(chunks), "k1": 0},
                    "the replayed stream")
    return report


# card vs CPU, float32 model and staged convs (TF32 off), K5 at bf16
# operands on both sides (the kernel, its plain version). At the default
# init's gain of ~1 per conv, a bf16 rounding that float32 noise moves
# travels down the 54 convs of the three fans and grows to about the size
# of the rounding noise itself, so this check scales the generator's
# resblock weights by 0.5, which keeps each fan contractive (card vs CPU
# 1.4e-4 in relative L2 on an NVIDIA H100 80GB HBM3 at 700 W). K5's own
# phase holds its rounding.
AUDIO_CPU_REL_TOL = 5e-4
RESBLOCK_SCALE = 0.5


def audio_against_cpu():
    """A small float32 audio request (B=2, L=16, reference T=64) on the
    card against the same models on the CPU (plain versions)."""
    hp = flagship_hparams(compute_dtype="float32")
    inputs = make_request(hp, np.random.default_rng(12), 2, 16, 64, 0.5,
                          "add")
    keys = [("a", 0), ("b", 1)]
    outs = {}
    for device in ("cuda", "cpu"):
        model = DaftExprt(hp, device=device, seed=0)
        pin_durations(model)
        gen = HiFiGanGenerator(device=device, seed=0)
        with torch.no_grad():
            for p in gen.resblocks.parameters():
                p.mul_(RESBLOCK_SCALE)
        eng = InferenceEngine(model, None, hp, device=device)
        eng.attach_vocoder(gen)
        outs[device] = eng.run_cached_to_audio(inputs, "add", keys)
    (g_wavs, g_lens, _), (c_wavs, c_lens, _) = outs["cuda"], outs["cpu"]
    if not np.array_equal(g_lens, c_lens):
        raise AssertionError(f"card and CPU frames differ: {g_lens} "
                             f"{c_lens}")
    check_wavs(g_wavs, g_lens, np.zeros(2, bool), keys)
    got, ref = np.concatenate(g_wavs), np.concatenate(c_wavs)
    report = {"frames": c_lens.tolist(),
              "max_abs_err": float(np.abs(got - ref).max()),
              "rel_l2": _np_rel_l2(got, ref), "limit": AUDIO_CPU_REL_TOL}
    print("f32 audio card vs CPU", json.dumps(report), flush=True)
    if not report["rel_l2"] <= AUDIO_CPU_REL_TOL:
        raise AssertionError(f"audio card vs CPU: {report}")
    return report


GRAPH_ROUNDS = 5  # eager, graph, graph, eager a round; medians
WARMUP_BATCH_SIZES = (1, 2, 4, 8)


def eager_run(engine, inputs, pt):
    """``engine.run``'s work as the engine did it before its graphs: each
    pass op by op from Python on fresh device tensors, then one host copy
    of each output. :return: (encoder_preds, decoder_preds) as numpy"""
    model = engine.model
    dev = [torch.as_tensor(np.asarray(x), device=engine.device)
           for x in inputs]
    stats = (engine.pitch_means, engine.pitch_stds)
    if engine.bucket_policy == "measure":
        enc, film, preds = model.inference_prosody(dev, pt, *stats)
        T = engine._buckets.choose(inputs, preds)
        dec, _ = model.inference_decode(enc, film, preds, max_frames=T)
    else:
        T = engine._buckets.speculate(inputs)
        preds, dec, _ = model.inference(dev, pt, *stats, max_frames=T)
        if T < engine.max_out_frames and bool(dec[2].any()):
            preds, dec, _ = model.inference(dev, pt, *stats,
                                            max_frames=engine.max_out_frames)
    return [t.cpu().numpy() for t in preds], [t.cpu().numpy() for t in dec]


def eager_audio(engine, inputs, pt, keys):
    """``run_cached_to_audio``'s pass as the engine ran it before its
    graphs (every key cached, the speculated bucket holding every row):
    (audio (B, samples), out_lens, overflow) as numpy."""
    from daft_exprt_tpu_torch.inference.film_cache import slim_inputs
    from daft_exprt_tpu_torch.vocoder.hifigan import MEL_FLOOR

    if any(k not in engine.films.entries for k in keys if k is not None):
        raise AssertionError("eager_audio: a key not cached")
    films = engine.films.resolve(None, inputs, keys)
    slim = [torch.as_tensor(np.asarray(x), device=engine.device)
            for x in slim_inputs(inputs, engine.hp.n_mel_channels)]
    T = engine._buckets.speculate(inputs)
    _, (mel, lens, over), _ = engine.model.inference(
        slim, pt, engine.pitch_means, engine.pitch_stds, max_frames=T,
        films=films)
    valid = torch.arange(T, device=engine.device)[None, :] < lens[:, None]
    mel = torch.where(valid[:, None, :], mel, MEL_FLOOR)
    audio = engine.vocoder(mel, engine.vocoder_dtype)
    return audio.cpu().numpy(), lens.cpu().numpy(), over.cpu().numpy()


def _max_abs(got, want):
    return max(float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())
               for a, b in zip(got, want))


def alternating_ms(runs, rounds=GRAPH_ROUNDS):
    """Host ms of each named call, synchronized, in rounds of a, b, b, a
    (the first name first): {name: (median, every reading)}."""
    (a, run_a), (b, run_b) = runs.items()
    times = {a: [], b: []}
    for _ in range(rounds):
        for name, run in ((a, run_a), (b, run_b), (b, run_b), (a, run_a)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: (float(np.median(v)), v) for name, v in times.items()}


def _timing_summary(row):
    """Host ms and the profiles' device busy, idle share and launches."""
    out = {k: row[k] for k in ("eager_ms", "replay_ms", "eager_ms_all",
                               "replay_ms_all")}
    for name in ("eager", "replay"):
        prof = row[f"{name}_profile"] or {}
        out[name] = {k: prof.get(k) for k in (
            "wall_ms", "device_busy_ms", "idle_share", "launches")}
    return out


def graph_report(engine):
    g = engine.graphs
    return {"graphs": len(g), "captures": g.captures,
            "capture_ms": g.capture_seconds * 1e3 / max(g.captures, 1),
            "capture_s": g.capture_seconds, "pool_bytes": g.pool_bytes()}


def replayed_request(engine, run, what, want):
    """One call of ``run`` whose passes all replay graphs captured before,
    under the profiler. K1's and K5's launches counted on the device must
    be ``want(passes, prosody-encoder batches)`` ({"k1": n, "k5": m}, all
    on the tensor cores), none counted at the wrappers, and as many as the
    replays' captures recorded; no graph is captured. :return: the
    profile, with the passes and the launches"""
    before = _counts(engine)
    passes, films = engine.passes, engine.film_batches
    captures = engine.graphs.captures
    prof = profile_kernels(run, {**K1_GROUPS, "k5_ms": K5_KERNELS,
                                 "k5_tensor_core_ms": K5_TC_KERNELS,
                                 "cudnn_conv_ms": CUDNN_KERNELS})
    passes, films = engine.passes - passes, engine.film_batches - films
    got = _launches(before, engine)
    check_on_device(prof, want(passes, films), what)
    dev = prof["on_device"]
    if engine.graphs.captures != captures or got["k1"] or got["k5"] \
            or got["k1_replayed"] != dev["k1"] \
            or got["k5_replayed"] != dev["k5"]:
        raise AssertionError(f"{what}: {got}, on the device {dev}, "
                             f"{engine.graphs.captures - captures} "
                             "captures")
    prof.update(passes=passes, prosody_encoder_batches=films, launches=got)
    return prof


def films_err(engine, inputs, keys):
    """Max abs difference of the FiLM cache's rows for ``keys`` from
    ``inference_film`` run eagerly on the same references."""
    refs = [torch.as_tensor(np.asarray(x), device=engine.device)
            for x in inputs[5:10]]
    want = engine.model.inference_film(*refs)
    return max(float((engine.films.entries[k][i] - want[i][b]).abs().max())
               for b, k in enumerate(keys) if k is not None
               for i in range(len(want)))


def engine_graphs(vocoder, smi):
    """The engine's compiled passes at flagship width (bf16, seed-0
    weights, durations pinned; B=8, L=64, reference T=512, bucket 512):
    after each capture, a replay on the inputs it was captured on and one
    on another draw of the same shapes (and, for audio, other styles:
    the FiLM graph replayed), each bit-equal to the same passes run
    eagerly (``eager_run``, ``eager_audio``, ``inference_film``) under
    both bucket policies; replays profiled, their K1 (12 a mel pass, 8 an
    audio pass and 4 a FiLM batch) and K5 (3 an audio pass) launches
    counted on the device and held against what the captures recorded;
    host ms of replay against eager in alternating rounds and device busy
    under the profiler, for a mel and an audio request;
    ``update_params`` to other seeded weights equal to a fresh engine's
    and, on other inputs, to the eager passes (the control, weights
    loaded in place around the engine, must differ); ``warmup``
    capturing the count of graphs expected, its seconds, ms a capture
    and the pool's bytes."""
    hp = flagship_hparams()
    model = DaftExprt(hp, seed=0)
    pin_durations(model)
    n_blocks = fft_blocks(hp)
    rng = np.random.default_rng(15)
    report = {"card": smi}

    def mel_errs(engine, pt, *requests):
        """Max abs error of each request's replay from the eager passes."""
        errs = []
        for x in requests:
            enc, dec, _ = engine.run(x, pt, want_weights=False)
            want_enc, want_dec = eager_run(engine, x, pt)
            errs.append(_max_abs(enc + dec, want_enc + want_dec))
        return errs, int(dec[0].shape[-1])

    # mel requests, both policies: capture, then replays against eager
    mel = {}
    for policy, pt in (("speculate", "add"), ("measure", "multiply")):
        engine = InferenceEngine(model, None, hp, bucket_policy=policy)
        inputs, other = (make_request(hp, rng, 8, 64, 512, 0.25, pt)
                         for _ in range(2))
        engine.run(inputs, pt, want_weights=False)  # eager + capture
        errs, bucket = mel_errs(engine, pt, inputs, other)
        prof = replayed_request(
            engine, lambda: engine.run(other, pt, want_weights=False),
            f"the replayed {policy} mel request",
            lambda passes, _: {"k1": n_blocks * passes, "k5": 0})
        row = {"policy": policy, "bucket": bucket,
               "passes": prof["passes"], "on_device": prof["on_device"],
               "graphs": len(engine.graphs),
               "captures": engine.graphs.captures,
               "max_abs_err_captured_inputs": errs[0],
               "max_abs_err_other_inputs": errs[1]}
        print("graph mel request", json.dumps(row), flush=True)
        if any(e != 0.0 for e in errs) or bucket != SERVE_BUCKET \
                or row["graphs"] != (1 if policy == "speculate" else 2) \
                or row["captures"] != row["graphs"]:
            raise AssertionError(f"graph mel request: {row}")
        row["replay_profile"] = prof
        # K1's launches depend programmatically inside the graph: an
        # edge from each block's QKV to its attention and from that to its
        # conv launch, 2 a block at least
        edges = graph_edges(engine.graphs, "fused")
        row["edges"], row["programmatic_edges"] = edges or (None, None)
        print("graph mel edges", json.dumps(
            {"policy": policy, "edges": row["edges"],
             "programmatic_edges": row["programmatic_edges"],
             "k1_blocks": n_blocks}), flush=True)
        if edges is not None and edges[1] < 2 * n_blocks:
            raise AssertionError(f"graph mel request: {edges[1]} "
                                 f"programmatic edges, fewer than 2 x "
                                 f"{n_blocks} K1 blocks: {row}")
        mel[policy] = (engine, inputs, other, pt, row)
    engine, inputs, _, pt, row = mel["speculate"]
    timed = alternating_ms({
        "eager": lambda: eager_run(engine, inputs, pt),
        "replay": lambda: engine.run(inputs, pt, want_weights=False)})
    row.update({f"{k}_ms": v[0] for k, v in timed.items()},
               **{f"{k}_ms_all": v[1] for k, v in timed.items()})
    row["eager_profile"] = profile_kernels(
        lambda: eager_run(engine, inputs, pt), K1_GROUPS)
    k1_all_tensor_core(row["replay_profile"], "the replayed mel request")
    report["mel"] = [r for *_, r in mel.values()]
    print("graph mel timing", json.dumps(_timing_summary(row)),
          f"-- {smi}", flush=True)

    # an audio request: captured, replayed on its inputs and on another
    # draw with other styles (the FiLM graph replayed on other references)
    aeng = InferenceEngine(model, None, hp)
    aeng.attach_vocoder(vocoder)
    inputs, other = (make_request(hp, rng, 8, 64, 512, 0.25, "add")
                     for _ in range(2))
    keys = [(f"graph_{i}", i) for i in range(8)]
    other_keys = [(f"graph_other_{i}", i) for i in range(8)]
    aeng.run_cached_to_audio(inputs, "add", keys)  # eager + capture
    arow = {"bucket": aeng._buckets.speculate(inputs)}
    for name, x, k in (("captured_inputs", inputs, keys),
                       ("other_inputs", other, other_keys)):
        wavs, lens, overflow = aeng.run_cached_to_audio(x, "add", k)
        audio, want_lens, want_over = eager_audio(aeng, x, "add", k)
        arow[f"max_abs_err_{name}"] = max(
            float(np.abs(wavs[b] - audio[b, :int(lens[b]) * HOP]).max())
            for b in range(8))
        arow[f"film_max_abs_err_{name}"] = films_err(aeng, x, k)
        arow[f"lens_equal_{name}"] = bool(
            np.array_equal(lens, want_lens)
            and np.array_equal(overflow, want_over))
    new_styles = replayed_request(
        aeng, lambda: aeng.run_cached_to_audio(
            other, "add", [(f"graph_new_{i}", i) for i in range(8)]),
        "the replayed audio request with new styles",
        lambda passes, films: {"k1": 8 * passes + 4 * films,
                               "k5": 3 * passes})
    prof = replayed_request(
        aeng, lambda: aeng.run_cached_to_audio(inputs, "add", keys),
        "the replayed audio request",
        lambda passes, films: {"k1": 8 * passes + 4 * films,
                               "k5": 3 * passes})
    arow.update(graphs=len(aeng.graphs), captures=aeng.graphs.captures,
                on_device=prof["on_device"],
                on_device_new_styles=new_styles["on_device"])
    print("graph audio request", json.dumps(arow), flush=True)
    if any(arow[f"{k}_{name}"] != 0.0 for k in ("max_abs_err",
                                                 "film_max_abs_err")
           for name in ("captured_inputs", "other_inputs")) \
            or not arow["lens_equal_captured_inputs"] \
            or not arow["lens_equal_other_inputs"] \
            or arow["graphs"] != 2 or arow["captures"] != 2 \
            or new_styles["prosody_encoder_batches"] != 1 \
            or prof["prosody_encoder_batches"] != 0:
        raise AssertionError(f"graph audio request: {arow}")
    timed = alternating_ms({
        "eager": lambda: eager_audio(aeng, inputs, "add", keys),
        "replay": lambda: aeng.run_cached_to_audio(inputs, "add", keys)})
    arow.update({f"{k}_ms": v[0] for k, v in timed.items()},
                **{f"{k}_ms_all": v[1] for k, v in timed.items()})
    arow["replay_profile"] = prof
    arow["eager_profile"] = profile_kernels(
        lambda: eager_audio(aeng, inputs, "add", keys),
        {**K1_GROUPS, "k5_ms": K5_KERNELS,
         "k5_tensor_core_ms": K5_TC_KERNELS, "cudnn_conv_ms": CUDNN_KERNELS})
    report["audio"] = arow
    print("graph audio timing", json.dumps(_timing_summary(arow)),
          f"-- {smi}", flush=True)
    del aeng

    # update_params: every graph dropped, then a fresh engine's answer on
    # the captured inputs and the eager passes' on other inputs
    engine, inputs, other, pt, _ = mel["speculate"]
    states = []
    for seed in (1, 2):
        other_model = DaftExprt(hp, seed=seed)
        pin_durations(other_model)
        states.append({k: v.clone()
                       for k, v in other_model.state_dict().items()})
        del other_model

    def fresh(state):
        eng = InferenceEngine(DaftExprt(hp, seed=3), state, hp)
        return eng.run(inputs, pt, want_weights=False)

    engine.update_params(states[0])
    dropped = len(engine.graphs)
    engine.run(inputs, pt, want_weights=False)  # eager + capture
    got = engine.run(inputs, pt, want_weights=False)  # replay
    want = fresh(states[0])
    captures = engine.graphs.captures
    upd = {"graphs_after_update": dropped,
           "max_abs_err": _max_abs(got[0] + got[1], want[0] + want[1]),
           "other_inputs_max_abs_err": mel_errs(engine, pt, other)[0][0],
           "other_inputs_captured": engine.graphs.captures - captures}
    # the control: weights loaded into the model around the engine leave
    # the captured graphs reading K1's old packed weights
    engine.model.load_state_dict(states[1])
    stale = engine.run(inputs, pt, want_weights=False)
    want = fresh(states[1])
    upd["control_max_abs_err"] = _max_abs(stale[1][:1], want[1][:1])
    engine.update_params(states[1])
    got = engine.run(inputs, pt, want_weights=False)
    upd["after_second_update_max_abs_err"] = _max_abs(got[0] + got[1],
                                                      want[0] + want[1])
    report["update_params"] = upd
    print("graph update_params", json.dumps(upd), flush=True)
    if dropped != 0 or upd["max_abs_err"] != 0.0 \
            or upd["other_inputs_max_abs_err"] != 0.0 \
            or upd["other_inputs_captured"] != 0 \
            or upd["after_second_update_max_abs_err"] != 0.0 \
            or not upd["control_max_abs_err"] > 0.0:
        raise AssertionError(f"update_params and graphs: {upd}")
    del mel, engine
    report["warmup"] = graph_warmup(model, vocoder, smi)
    return report


def graph_warmup(model, vocoder, smi):
    """``InferenceEngine.warmup`` at ``WARMUP_BATCH_SIZES``, both pitch
    transforms and every bucket, without and then with the vocoder: the
    graphs it captures against the count expected, seconds, ms a capture
    and the pool's bytes."""
    weng = InferenceEngine(model, None, model.hp)
    ladder = len(weng.out_frame_buckets)
    warm = {}
    for label in ("mel", "audio"):
        if label == "audio":
            weng.attach_vocoder(vocoder)
        t0 = time.perf_counter()
        weng.warmup(("add", "multiply"), batch_sizes=WARMUP_BATCH_SIZES)
        torch.cuda.synchronize()
        warm[label] = {"seconds": time.perf_counter() - t0,
                       **graph_report(weng)}
    n_b = len(WARMUP_BATCH_SIZES)
    # a film graph a B, a fused (then an audio) graph a (B, transform,
    # bucket); the audio warm-up reuses the film graphs
    warm["expected_graphs"] = {"mel": n_b * (1 + 2 * ladder),
                               "audio": n_b * (1 + 2 * ladder) + 2 * n_b
                               * ladder}
    print("graph warmup", json.dumps(warm), f"-- {smi}", flush=True)
    for label in ("mel", "audio"):
        w = warm[label]
        if w["graphs"] != warm["expected_graphs"][label] \
                or w["captures"] != w["graphs"] or not w["pool_bytes"] > 0:
            raise AssertionError(f"warmup graphs: {warm}")
    return warm


def vocoder_graphs(gen):
    """``gen``'s graph cache (``HiFiGanGenerator.replayed``: the
    streamer's window, ``vocode_mels``' buckets) where ``_counts`` reads
    an engine's."""
    return types.SimpleNamespace(graphs=gen.graphs())


def counted(fn, *engines):
    """fn's result and the K1 launches it made, (all, tensor-core): at the
    wrappers plus, derived, those of the ``engines``' graph replays (see
    ``_counts``)."""
    before = _counts(*engines)
    out = fn()
    torch.cuda.synchronize()
    got = _launches(before, *engines)
    return out, (got["k1_total"], got["k1_tensor_core_total"])


def serve_wide(vocoder):
    """The wide ablation's inference and evaluation on the card
    (``wide_head_hparams``: every FFT block at E=512, 4 heads of 128, C=512;
    bf16, seed-0 weights, 11 speakers, depth not cut): two mel requests
    through ``InferenceEngine.run`` (B=8, L=64, reference T=512, bucket
    512, both pitch transforms) with one profiled, one audio request
    through ``run_cached_to_audio`` with the seed-0 V1 generator, and
    ``make_eval_step`` on bench's row shape (B=16, L=128, T=768), profiled.
    K1 launches (at the wrappers plus the graph replays', derived): 12 a
    pass (8 a cached audio pass + 4 a prosody-encoder batch), 12 an eval
    batch, every one on the tensor-core instance; the profiled mel
    request's counted on the device."""
    from daft_exprt_tpu_torch.training.step import make_eval_step

    hp = wide_head_hparams()
    model = DaftExprt(hp, seed=0)
    pin_durations(model)
    engine = InferenceEngine(model, None, hp)
    n_blocks = fft_blocks(hp)
    rng = np.random.default_rng(13)
    requests = [(pt, make_request(hp, rng, 8, 64, 512, 0.25, pt))
                for pt in ("add", "multiply")]
    for pt, inputs in requests:  # warm-up
        engine.run(inputs, pt, want_weights=False)
    report = {"mel": []}
    for pt, inputs in requests:
        passes = engine.passes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, (k1, k1_tc) = counted(
            lambda: engine.run(inputs, pt, want_weights=False), engine)
        latency = time.perf_counter() - t0
        T, frames = check_outputs(out, engine, 8)
        row = {"pitch_transform": pt, "bucket": T,
               "passes": engine.passes - passes, "frames": frames,
               "k1_launches": k1, "k1_tensor_core_launches": k1_tc,
               "latency_ms": latency * 1e3,
               "frames_per_s": frames / latency}
        print("wide request", json.dumps(row), flush=True)
        if k1 != n_blocks * row["passes"] or k1_tc != k1 \
                or T != SERVE_BUCKET:
            raise AssertionError(f"wide request: {row}")
        report["mel"].append(row)
    report["mel_profile"] = profile_request(engine, *requests[0][::-1])

    engine.attach_vocoder(vocoder)
    inputs = make_request(hp, rng, 8, 64, 512, 0.25, "add")
    engine.run_cached_to_audio(inputs, "add", [("warm-up", i)
                                               for i in range(8)])
    engine.films.clear()
    keys = [(f"wide_{i}", i) for i in range(8)]
    passes, batches = engine.passes, engine.film_batches
    t0 = time.perf_counter()
    (wavs, out_lens, overflow), (k1, k1_tc) = counted(
        lambda: engine.run_cached_to_audio(inputs, "add", keys), engine)
    latency = time.perf_counter() - t0
    samples = check_wavs(wavs, out_lens, overflow, keys)
    passes, batches = engine.passes - passes, engine.film_batches - batches
    report["audio"] = {"passes": passes, "prosody_encoder_batches": batches,
                       "k1_launches": k1, "k1_tensor_core_launches": k1_tc,
                       "latency_ms": latency * 1e3,
                       "samples_per_s": samples / latency}
    print("wide audio request", json.dumps(report["audio"]), flush=True)
    if k1 != 8 * passes + 4 * batches or k1_tc != k1 or batches != 1:
        raise AssertionError(f"wide audio request: {report['audio']}")

    step = make_eval_step(model, hp)
    batch = {k: v[0] for k, v in train_batch(
        wide_head_hparams(batch_size=16, accumulation_steps=1), rng, 128,
        768).items()}
    mask = torch.ones(16, device="cuda")
    eager_step = make_eval_step(model, hp)
    eager_step.graphs.cuda = False  # its entries run eagerly on the card
    eager = eager_step(batch, mask)
    step(batch, mask)  # warm-up: an eager pass, then the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, (k1, k1_tc) = counted(lambda: step(batch, mask), step)
    seconds = time.perf_counter() - t0
    bit_equal = all(torch.equal(metrics[k], eager[k]) for k in eager)
    metrics = {k: float(v) for k, v in metrics.items()}
    prof = profile_kernels(lambda: step(batch, mask), K1_GROUPS)
    report["eval"] = {"B": 16, "L": 128, "T": 768, "step_ms": seconds * 1e3,
                      "k1_launches": k1, "k1_tensor_core_launches": k1_tc,
                      "replay_equals_eager": bit_equal,
                      "graphs": graph_report(step),
                      "metrics": metrics, "profile": prof}
    print("wide eval step", json.dumps(report["eval"]), flush=True)
    if k1 != n_blocks or k1_tc != k1 or metrics["count"] != 16 \
            or not bit_equal or step.graphs.replays < 2 \
            or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"wide eval step: {report['eval']}")
    k1_all_tensor_core(prof, "the wide eval step")
    check_on_device(prof, {"k1": n_blocks, "k5": 0},
                    "the replayed wide eval step")
    return report


# wide eval metrics card vs CPU, float32: sums over the batch in other
# orders (the training step's loss tolerance), relative to max(1, |CPU|)
EVAL_CPU_TOL = 1e-5


def eval_against_cpu(make_hp):
    """A small float32 evaluation step (B=2, L=16, T=64) of the
    configuration ``make_hp`` gives on the card against the same step on
    the CPU."""
    from daft_exprt_tpu_torch.training.step import make_eval_step

    hp = make_hp(compute_dtype="float32", batch_size=2, accumulation_steps=1)
    out = {}
    for device in ("cuda", "cpu"):
        model = DaftExprt(hp, device=device, seed=0)
        batch = {k: v[0] for k, v in train_batch(
            hp, np.random.default_rng(6), 16, 64, device).items()}
        metrics = make_eval_step(model, hp)(batch, torch.ones(2,
                                                               device=device))
        out[device] = {k: float(v) for k, v in metrics.items()}
    errs = {k: abs(out["cuda"][k] - v) / max(1.0, abs(v))
            for k, v in out["cpu"].items()}
    report = {"card": out["cuda"], "cpu": out["cpu"], "errs": errs,
              "tol": EVAL_CPU_TOL}
    print("f32 eval step card vs CPU", json.dumps(report), flush=True)
    if not all(e <= EVAL_CPU_TOL for e in errs.values()):
        raise AssertionError(f"eval step card vs CPU: {report}")
    return report


# K2's tensor-core instance (csrc/attention_wgmma.cuh)
K2_TC_KERNELS = ("attn_fwd_wgmma_kernel", "attn_bwd_dq_wgmma_kernel",
                 "attn_bwd_dkdv_wgmma_kernel")
K2_KERNELS = ("attn_fwd_kernel", "attn_bwd_dq_kernel",
              "attn_bwd_dkdv_kernel") + K2_TC_KERNELS
# the tensor-core instance of K3 and K4 (csrc/conv_ff_blocked_tc.cu)
CONV_FF_TC_KERNELS = ("cff_pack_x_kernel", "conv_c_wgmma_kernel",
                      "conv_e_wgmma_kernel", "wgrad_wgmma_kernel",
                      "cff_finish_kernel")
K3_KERNELS = ("cff_rows_kernel", "cff_hidden_kernel",
              "wgrad_kernel") + CONV_FF_TC_KERNELS
K4_KERNELS = ("cffb_rows_kernel", "cffb_hidden_kernel",
              "wgrad_kernel") + CONV_FF_TC_KERNELS
TRAIN_COUNTERS = {
    "attention_train_forward": (attention_core, "fwd_launches"),
    "attention_train_backward": (attention_core, "bwd_launches"),
    "attention_train_forward_tensor_core": (attention_core,
                                            "tc_fwd_launches"),
    "attention_train_backward_tensor_core": (attention_core,
                                             "tc_bwd_launches"),
    "conv_ff_train_forward": (conv_ff_train, "fwd_launches"),
    "conv_ff_train_backward": (conv_ff_train, "bwd_launches"),
    "conv_ff_train_forward_tensor_core": (conv_ff_train, "tc_fwd_launches"),
    "conv_ff_train_backward_tensor_core": (conv_ff_train, "tc_bwd_launches"),
    "conv_ff_train_blocked_forward": (conv_ff_train_blocked, "fwd_launches"),
    "conv_ff_train_blocked_backward": (conv_ff_train_blocked,
                                       "bwd_launches"),
    "conv_ff_train_blocked_forward_tensor_core": (conv_ff_train_blocked,
                                                  "tc_fwd_launches"),
    "conv_ff_train_blocked_backward_tensor_core": (conv_ff_train_blocked,
                                                   "tc_bwd_launches"),
}


def _train_replayed(*caches):
    """Derived, by ``TRAIN_COUNTERS`` name: the launches the ``caches``'
    replays ran, each replay adding what its capture recorded (a replay
    runs no wrapper)."""
    replayed = {}
    for c in caches:
        for key, v in zip(c.counters, c.replayed):
            replayed[key] = replayed.get(key, 0) + v
    return {name: replayed.get((fn, attr.replace("launches", "captured")),
                               0)
            for name, (fn, attr) in TRAIN_COUNTERS.items()}


def expected_launches(conv_ff, n, tensor_core):
    """The training counters when K2 and the conv-FF kernel ``conv_ff``
    launched n times in each direction, the other conv-FF kernel never,
    and K2 and the conv-FF kernel all on their tensor-core instances (bf16
    steps) or none (f32)."""
    ran = {"attention_train_forward", "attention_train_backward",
           f"{conv_ff}_forward", f"{conv_ff}_backward"}
    if tensor_core:
        ran |= {"attention_train_forward_tensor_core",
                "attention_train_backward_tensor_core",
                f"{conv_ff}_forward_tensor_core",
                f"{conv_ff}_backward_tensor_core"}
    return {name: n if name in ran else 0 for name in TRAIN_COUNTERS}


def train_batch(hp, rng, L, T, device="cuda"):
    """The synthetic training batch of ``bench.py``'s train-step rate:
    (accumulation, B) rows of L symbols and T frames, T // L frames per
    symbol, on ``device``."""
    accum, B = hp.accumulation_steps, hp.batch_size
    frame_dur = hp.hop_length / hp.sampling_rate
    durs = np.full((accum, B, L), T // L, np.int32)
    batch = {
        "symbols": rng.integers(1, hp.n_symbols, size=(accum, B, L)),
        "input_lengths": np.full((accum, B), L),
        "output_lengths": np.full((accum, B), T),
        "speaker_ids": rng.integers(0, len(hp.speakers), size=(accum, B)),
        "frames_energy": np.abs(rng.standard_normal((accum, B, T))),
        "frames_pitch": rng.standard_normal((accum, B, T)),
        "mel_specs": rng.standard_normal((accum, B, hp.n_mel_channels, T)),
        "symbols_energy": rng.standard_normal((accum, B, L)),
        "symbols_pitch": rng.standard_normal((accum, B, L)),
        "durations_int": durs,
        "durations_float": durs * frame_dur,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v).astype(
        np.int32 if v.dtype.kind in "iu" else np.float32)).to(device)
        for k, v in batch.items()}


# one kernel a wrapper call of the training kernels' tensor-core
# instances: K2's forward and dq launches, the conv-FF's conv2 with the
# LayerNorm rows (conv_e_wgmma_kernel<OUT_FWD = 0 or OUT_BWD = 1, ...>; K3
# and K4 share the kernels; the wrappers' counters tell them apart)
TRAIN_ON_DEVICE = {"attention_train_forward": r"(?<!\w)attn_fwd_wgmma_kernel<",
                   "attention_train_backward":
                       r"(?<!\w)attn_bwd_dq_wgmma_kernel<",
                   "conv_ff_forward": r"(?<!\w)conv_e_wgmma_kernel<0,",
                   "conv_ff_backward": r"(?<!\w)conv_e_wgmma_kernel<1,"}
STEP_CHECKS = 4   # steps of each run that holds replays against eager steps
STEP_ROUNDS = 3   # timing rounds: eager steps, then replayed steps


def train_on_device(prof):
    """The training kernels' launches counted in a profiled run's trace
    (``TRAIN_ON_DEVICE``), replays included."""
    counts = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, pattern in TRAIN_ON_DEVICE.items():
            if re.search(pattern, ev.key):
                counts[name] = counts.get(name, 0) + ev.count
    return {name: counts.get(name, 0) for name in TRAIN_ON_DEVICE}


def _step_run(hp, batch, seeds, eager=False, frozen=False):
    """``len(seeds)`` steps of a fresh seed-0 model through
    ``make_train_step``, step i's generator seeded with ``seeds[i]`` (with
    ``frozen`` the first seed every step): through its graphs, or with
    ``eager`` through the same entries run eagerly (the cache's CPU
    bookkeeping, on the card). :return: (metric rows (steps,
    len(TRAIN_METRICS)) on the host, parameters after, the model, the
    step, its generator)"""
    from daft_exprt_tpu_torch.training.step import TRAIN_METRICS

    model = DaftExprt(hp, seed=0)
    step = make_train_step(model, hp)
    step.graphs.cuda = not eager
    gen = torch.Generator(device="cuda")
    rows = []
    for i, seed in enumerate(seeds):
        gen.manual_seed(seeds[0] if frozen else seed)
        m = step(batch, gen, i + 1)
        rows.append(torch.stack([m[k] for k in TRAIN_METRICS]))
    torch.cuda.synchronize()
    return (torch.stack(rows).cpu(), [p.detach().clone() for p in
                                      model.parameters()], model, step, gen)


def _max_diff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def train(hp, conv_ff, warmup=2, steps=5):
    """Optimizer steps at full width through make_train_step, every step
    after a batch signature's first one CUDA graph replay:

    - ``STEP_CHECKS`` steps through the graphs against the same steps run
      eagerly on the card, twice, from the seed-0 weights and the
      generator seeds of iterations 1.. (``dropout_seed``): metrics and
      parameters bit-equal to the eager run's, or within the two eager
      runs' own difference where they differ; a control whose generator
      is reseeded with step 1's seed every step (frozen draws) must
      differ from the eager run;
    - the training kernels' launches of the graph run: at the wrappers
      the first (eager) step's alone, K2 and the conv-FF kernel
      ``conv_ff`` (``"conv_ff_train"``, K3, or ``"conv_ff_train_blocked"``,
      K4) once per FFT block and micro-batch in each direction, as many
      recorded by its capture, none at a replay (derived: as many a
      replay), the other conv-FF kernel and K1 never; on the device,
      counted in the trace of a profiled replayed step, as many a step;
    - K2's tensor maps: encoded at the eager step and at the capture, none
      at a replay;
    - ``STEP_ROUNDS`` rounds of ``steps`` eager then ``steps`` replayed
      steps after ``warmup`` of each (host clock, medians), and one
      profiled step of each (device busy, idle share).
    """
    from daft_exprt_tpu_torch.training.step import dropout_seed

    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(5)
    L, T = 128, 768
    batch = train_batch(hp, rng, L, T)
    seeds = [dropout_seed(hp, i + 1) for i in range(STEP_CHECKS)]
    n = fft_blocks(hp) * hp.accumulation_steps
    # the graph run: counters from zero around it
    for fn, attr in TRAIN_COUNTERS.values():
        setattr(fn, attr, 0)
    for fn, attr in TRAIN_CAPTURED:
        setattr(fn, attr, 0)
    fused_fft_block.launches = 0
    maps_before = tc_map_stats()
    graph_rows, graph_params, model, step, gen = _step_run(hp, batch, seeds)
    maps, _ = (a - b for a, b in zip(tc_map_stats(), maps_before))
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in TRAIN_COUNTERS.items()}
    captured = dict(zip(TRAIN_COUNTERS, (
        getattr(fn, attr.replace("launches", "captured"))
        for fn, attr in TRAIN_COUNTERS.values())))
    replayed = _train_replayed(step.graphs)
    want = expected_launches(conv_ff, n, tensor_core=True)
    want_replayed = expected_launches(conv_ff, n * (STEP_CHECKS - 1),
                                      tensor_core=True)
    print(f"training: launches at the wrappers {json.dumps(launches)}, "
          f"captured {json.dumps(captured)}, replayed (derived) "
          f"{json.dumps(replayed)} (expected {json.dumps(want)}, "
          f"{json.dumps(want)}, {json.dumps(want_replayed)}), K1 "
          f"{fused_fft_block.launches} (expected 0), graphs "
          f"{len(step.graphs)}, captures {step.graphs.captures}",
          flush=True)
    if launches != want or captured != want or replayed != want_replayed \
            or fused_fft_block.launches != 0 or step.graphs.captures != 2:
        raise AssertionError(f"training launches {launches}, captured "
                             f"{captured}, replayed {replayed}")
    # K2's tensor-core launches encode their maps anew: q/k/v forward, and
    # q/k/v, the rounded g and the terms backward; the eager step's and
    # the capture's, none at a replay
    k2_maps = 2 * (3 * launches["attention_train_forward_tensor_core"]
                   + 5 * launches["attention_train_backward_tensor_core"])
    if maps != k2_maps:
        raise AssertionError(f"K2 encoded {maps} tensor maps, expected "
                             f"{k2_maps}")

    # a second eager run measures the eager steps' own spread, needed only
    # where the replays differ from the first
    eager = [_step_run(hp, batch, seeds, eager=True)]
    diff = {"metrics": _max_diff([graph_rows], [eager[0][0]]),
            "params": _max_diff(graph_params, eager[0][1])}
    spread = {"metrics": 0.0, "params": 0.0}
    if diff["metrics"] or diff["params"]:
        eager.append(_step_run(hp, batch, seeds, eager=True))
        spread = {"metrics": _max_diff([eager[0][0]], [eager[1][0]]),
                  "params": _max_diff(eager[0][1], eager[1][1])}
    control_rows = _step_run(hp, batch, seeds, frozen=True)[0]
    control = _max_diff([control_rows[1:]], [eager[0][0][1:]])
    equality = {"steps": STEP_CHECKS, "replays": STEP_CHECKS - 1,
                "graphs_vs_eager_max_abs": diff,
                "eager_runs": len(eager),
                "eager_vs_eager_max_abs": spread if len(eager) > 1 else None,
                "bit_equal": diff["metrics"] == diff["params"] == 0.0,
                "frozen_seed_control_max_abs": control,
                "loss_graphs": graph_rows[:, 0].tolist(),
                "loss_eager": eager[0][0][:, 0].tolist(),
                "loss_frozen_seed": control_rows[:, 0].tolist()}
    print("training: replays against eager steps", json.dumps(equality),
          flush=True)
    if not all(diff[k] <= spread[k] for k in diff) or not control > 0.0 \
            or not torch.isfinite(graph_rows).all():
        raise AssertionError(f"replayed steps against eager: {equality}")
    # eager steps (the first eager run's step, its entries run eagerly)
    # against replays, timed in alternating rounds on one seeded batch
    eager_model, eager_step, eager_gen = eager[0][2:]
    del eager

    def run_steps(st, g, k, it0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(k):
            g.manual_seed(dropout_seed(hp, it0 + i))
            st(batch, g, it0 + i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k * 1e3

    it = STEP_CHECKS + 1
    run_steps(eager_step, eager_gen, warmup, it)
    run_steps(step, gen, warmup, it)
    eager_ms, graph_ms = [], []
    maps_before = tc_map_stats()
    for _ in range(STEP_ROUNDS):
        eager_ms.append(run_steps(eager_step, eager_gen, steps, it))
        graph_ms.append(run_steps(step, gen, steps, it))
    # an eager bf16 step encodes 3 maps a K2 forward and 5 a backward;
    # what is left is the replays'
    maps_replays = tc_map_stats()[0] - maps_before[0] \
        - (3 * n + 5 * n) * STEP_ROUNDS * steps
    groups = {"k2_ms": K2_KERNELS, "k2_tensor_core_ms": K2_TC_KERNELS}
    ff = "k3" if conv_ff == "conv_ff_train" else "k4"
    groups.update({f"{ff}_ms": K3_KERNELS if ff == "k3" else K4_KERNELS,
                   f"{ff}_tensor_core_ms": CONV_FF_TC_KERNELS})
    profiles = {}
    for label, st, g in (("replayed", step, gen),
                         ("eager", eager_step, eager_gen)):
        g.manual_seed(dropout_seed(hp, it))
        prof, wall_ms = profiled(lambda: st(batch, g, it))
        profiles[label] = kernel_report(prof, wall_ms, groups)
        if profiles[label] is not None:
            profiles[label]["train_on_device"] = train_on_device(prof)
            profiles[label]["k2_share"] = profiles[label]["k2_ms"] \
                / profiles[label]["device_busy_ms"]
    prof = profiles["replayed"]
    print("training profile", json.dumps(profiles), flush=True)
    on_device = prof and prof["train_on_device"]
    want_device = {name: n for name in TRAIN_ON_DEVICE}
    if prof is not None and on_device != want_device:
        raise AssertionError(f"a replayed step's training kernels on the "
                             f"device: {on_device}, expected {want_device}")
    if maps_replays != 0:
        raise AssertionError(f"replayed steps encoded {maps_replays} K2 "
                             "tensor maps")
    for p in profiles.values():
        if p is not None and not 0 < p["k2_tensor_core_ms"] == p["k2_ms"]:
            raise AssertionError("K2's device time in the training step is "
                                 "not all on its tensor-core kernels")
        if p is not None \
                and not 0 < p[f"{ff}_tensor_core_ms"] == p[f"{ff}_ms"]:
            raise AssertionError(f"{ff.upper()}'s device time in the "
                                 "training step is not all on its "
                                 "tensor-core kernels")
    frames = int(batch["output_lengths"].sum())  # over accumulation x B
    step_ms = float(np.median(graph_ms))
    g = step.graphs
    report = {"steps": steps, "rounds": STEP_ROUNDS,
              "step_ms": step_ms, "eager_step_ms": float(np.median(eager_ms)),
              "step_ms_rounds": graph_ms, "eager_step_ms_rounds": eager_ms,
              "steps_per_s": 1e3 / step_ms,
              "mel_frames_per_s": frames * 1e3 / step_ms,
              "frames_per_step": frames, "launches": launches,
              "launches_captured": captured,
              "launches_replayed_derived": replayed,
              "launches_on_device_per_step": on_device,
              "graphs": {"graphs": len(g), "captures": g.captures,
                         "capture_s": g.capture_seconds,
                         "pool_bytes": g.pool_bytes()},
              "replays_against_eager": equality,
              "loss": graph_rows[:, 0].tolist(),
              "grad_norm": graph_rows[:, -2].tolist(),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
              # K2's TMA tensor maps: encoded on the host at the eager
              # step and at the capture, none at a replay
              "k2_tensor_maps": {"graph_run": maps,
                                 "per_replayed_step": maps_replays
                                 / (STEP_ROUNDS * steps)},
              "profile": prof, "eager_profile": profiles["eager"]}
    print("training", json.dumps({k: v for k, v in report.items()
                                  if "profile" not in k}), flush=True)
    def device_count(name):
        if on_device is None:
            return None
        if name.startswith("attention"):
            return on_device[name]
        ran = name.rsplit("_", 1)[0] == conv_ff
        return on_device["conv_ff_" + name.rsplit("_", 1)[1]] if ran else 0

    all_launches = {**launches,
                    **{f"{k}_captured": v for k, v in captured.items()},
                    **{f"{k}_replayed": v for k, v in replayed.items()},
                    **{f"{k}_on_device": device_count(k) for k in launches
                       if not k.endswith("tensor_core")}}
    del model, eager_model
    return report, all_launches


FPS = 22050.0 / 256.0  # mel frames a second


def corpus_lengths(n=16600, seed=0):
    """(n_symbols, n_frames) of an LJ+ESD-like corpus (the JAX repo's
    ``tools/padding_report.py`` corpus model, copied: LJSpeech clips
    ~N(6.5 s, 2.2 s) in [1.1, 10.1] s, ESD ~N(2.9 s, 1.0 s) in [1.0, 7.0]
    s, 13.1k + 3.5k utterances, ~12.5 phones a second jittered)."""
    rng = np.random.default_rng(seed)

    def trunc_normal(mean, std, lo, hi, k):
        out = np.empty(k)
        filled = 0
        while filled < k:
            draw = rng.normal(mean, std, size=k - filled)
            draw = draw[(draw >= lo) & (draw <= hi)]
            out[filled:filled + len(draw)] = draw
            filled += len(draw)
        return out

    lengths = []
    n_lj = int(n * 13100 / (13100 + 3500))
    for k, args in ((n_lj, (6.5, 2.2, 1.1, 10.1)),
                    (n - n_lj, (2.9, 1.0, 1.0, 7.0))):
        secs = trunc_normal(*args, k)
        frames = np.maximum((secs * FPS).astype(int), 8)
        rate = rng.normal(12.5, 1.5, size=k).clip(8.0, 18.0)
        symbols = np.maximum((secs * rate).astype(int), 2)
        lengths += list(zip(symbols.tolist(), frames.tolist()))
    return lengths


SIGNATURE_EPOCHS = 3


def step_signatures():
    """``--step-signatures``: the train step's batch signatures over
    ``SIGNATURE_EPOCHS`` epochs of the bucketed loader's plan on an
    LJ+ESD-like corpus (``corpus_lengths``) at the flagship's defaults
    (16 x 3 rows a step), then one flagship step on the card at each, in
    the order they first appear: the step cache's graphs, captures,
    evictions and pool bytes after each new signature, and the capture
    seconds."""
    from daft_exprt_tpu_torch.data.loader import plan_steps
    from daft_exprt_tpu_torch.training.step import dropout_seed

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hp = flagship_hparams()
    lengths = corpus_lengths()
    order, per_epoch = [], []
    for epoch in range(SIGNATURE_EPOCHS):
        shapes = [(L, T) for _, L, T in plan_steps(lengths, hp,
                                                   hp.seed + epoch)]
        per_epoch.append({"steps": len(shapes),
                          "signatures": len(set(shapes))})
        order += [sh for sh in dict.fromkeys(shapes) if sh not in order]
    model = DaftExprt(hp, seed=0)
    step = make_train_step(model, hp)
    gen = torch.Generator(device="cuda")
    rng = np.random.default_rng(5)
    rows = []
    for i, (L, T) in enumerate(order):
        batch = train_batch(hp, rng, L, T)
        gen.manual_seed(dropout_seed(hp, i + 1))
        metrics = step(batch, gen, i + 1)
        torch.cuda.synchronize()
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"step at (L, T) = ({L}, {T}): loss "
                                 f"{float(metrics['loss'])}")
        g = step.graphs
        rows.append({"L": L, "T": T, "graphs": len(g),
                     "captures": g.captures, "evictions": g.evictions,
                     "pool_bytes": g.pool_bytes()})
    pools = [r["pool_bytes"] for r in rows]
    growth = np.diff(pools)
    report = {"card": smi, "corpus": "LJ+ESD-like, 16600 utterances",
              "epochs": per_epoch, "signatures": len(order),
              "max_graphs": step.graphs.max_entries,
              "graphs": len(step.graphs), "evictions": step.graphs.evictions,
              "captures": step.graphs.captures,
              "capture_s": step.graphs.capture_seconds,
              "pool_bytes_first": pools[0], "pool_bytes_last": pools[-1],
              "pool_growth_median_bytes": float(np.median(growth)),
              "pool_growth_max_bytes": int(growth.max()),
              "memory_allocated_bytes": torch.cuda.memory_allocated(),
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "steps": rows}
    print("step signatures", json.dumps(report), flush=True)
    return 0


def small_wide_hparams(**overrides):
    """The wide ablation cut to size for the card-vs-CPU step: E=256, 2
    heads of D=128, conv channels 256, one FFT block per module (K2's
    D=128 instance and K4 at two C blocks)."""
    base = wide_head_hparams()
    small = dict(hidden_embed_dim=256, attn_nb_heads=2, conv_channels=256,
                 nb_blocks=1)
    modules = {m: {**getattr(base, m), **small} for m in
               ("prosody_encoder", "phoneme_encoder", "frame_decoder")}
    return wide_head_hparams(**{**modules, **overrides})


def train_against_cpu(make_hp, conv_ff):
    """One float32 step (B=2, L=16, T=64, accumulation 1, dropout 0) of
    the configuration ``make_hp`` gives, on the card and on the CPU from
    the same seed; on the card K2 and the conv-FF kernel ``conv_ff`` run
    once per FFT block in each direction."""
    def no_drop(cfg):
        return {**cfg, **{k: 0.0 for k in ("attn_dropout", "conv_dropout")
                          if k in cfg}}

    base = make_hp()
    hp = make_hp(
        compute_dtype="float32", batch_size=2, accumulation_steps=1,
        prosody_encoder=no_drop(base.prosody_encoder),
        phoneme_encoder=no_drop(base.phoneme_encoder),
        local_prosody_predictor=no_drop(base.local_prosody_predictor),
        frame_decoder=no_drop(base.frame_decoder))
    out = {}
    for fn, attr in TRAIN_COUNTERS.values():
        setattr(fn, attr, 0)
    for device in ("cuda", "cpu"):
        model = DaftExprt(hp, device=device, seed=0)
        batch = train_batch(hp, np.random.default_rng(6), 16, 64, device)
        metrics = make_train_step(model, hp)(batch, None, 1)
        out[device] = ({k: float(v) for k, v in metrics.items()},
                       {n: p.grad.cpu() for n, p in model.named_parameters()})
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in TRAIN_COUNTERS.items()}
    n_blocks = fft_blocks(hp)
    want = expected_launches(conv_ff, n_blocks, tensor_core=False)
    if launches != want:
        raise AssertionError(f"card step launches {launches}, expected "
                             f"{want}")
    (gm, gg), (cm, cg) = out["cuda"], out["cpu"]
    loss_err = abs(gm["loss"] - cm["loss"]) / abs(cm["loss"])
    norm_err = abs(gm["grad_norm"] - cm["grad_norm"]) / cm["grad_norm"]
    grad_errs = {n: ((gg[n] - cg[n]).norm() / cg[n].norm().clamp_min(
        1e-30)).item() for n in cg}
    worst = max(grad_errs, key=grad_errs.get)
    report = {"loss": [gm["loss"], cm["loss"]], "loss_rel_err": loss_err,
              "grad_norm": [gm["grad_norm"], cm["grad_norm"]],
              "grad_norm_rel_err": norm_err,
              "worst_param_grad_rel_l2_err": grad_errs[worst],
              "worst_param": worst, "tol": TRAIN_CPU_TOL,
              "launches": launches}
    grad_err = grad_errs[worst]
    print(f"f32 training card vs CPU ({conv_ff})", json.dumps(report),
          flush=True)
    if not (loss_err <= TRAIN_CPU_TOL["loss"]
            and norm_err <= TRAIN_CPU_TOL["grad_norm"]
            and grad_err <= TRAIN_CPU_TOL["grad"]):
        raise AssertionError(f"training card vs CPU: {report}")
    return report


# card vs CPU, float32, relative: the loss and gradient norm are sums
# over the batch computed in other orders (1e-5, 1e-4); each parameter's
# gradient in L2 relative to its norm, 1e-2: beyond rounding noise of
# ~40 layers, a ReLU whose pre-activation lies within float32 rounding of
# zero can take the other branch on one side, which moves one row's term
# of a conv weight's gradient (a few tenths of a percent of its norm at
# this size)
TRAIN_CPU_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grad": 1e-2}


def _timing(rows, direction, library):
    """Times of one timed shape's rows at rate 0 (the rate at which the
    library call computes the same function), and the kernel at 0.1."""
    head = next(r for r in rows if r["rate"] == 0.0)
    drop = next(r for r in rows if r["rate"] > 0.0)
    out = {
        "ms": head[f"{direction}_ms"],
        "plain_ms": head[f"{direction}_plain_ms"],
        "bound_ms": head[f"{direction}_bound_ms"],
        "bound_by": head[f"{direction}_bound_by"],
        "library_ms": head.get(f"{direction}_library_ms") if library
        else None,
        "ms_at_rate_0.1": drop[f"{direction}_ms"],
        "at": f"{head['shape']} B={head['B']} T={head['T']} "
              f"E={head.get('E', E)} bf16",
    }
    if f"{direction}_device_ms" in head:  # K2-K4: device time alone
        out.update({
            "device_ms": head[f"{direction}_device_ms"],
            "library_device_ms": head.get(f"{direction}_library_device_ms"),
            "device_ms_at_rate_0.1": drop[f"{direction}_device_ms"]})
    if f"{direction}_staged_ms" in head:  # K3, K4: GEMMs in cuBLAS
        out.update(staged_ms=head[f"{direction}_staged_ms"],
                   staged_ms_by_product=head["staged_ms_by_product"],
                   device_kernels=head[f"{direction}_device_kernels"])
    return out


def kernel_entry(name, kernel, source, replaces, launches, rows, direction,
                 library, primary=None, **extra):
    """One ``kernels`` entry of a training kernel from its check rows:
    errors over every checked shape (the bf16 relative L2 errors of this
    direction's tensors beside the control's smallest), times at the
    ``primary`` timed shape (default: the first), and at the others under
    ``also_timed``."""
    timed = [r for r in rows if f"{direction}_ms" in r]
    shapes = list(dict.fromkeys(r["shape"] for r in timed))
    if primary is not None:
        shapes.remove(primary)
        shapes.insert(0, primary)
    timings = [_timing([r for r in timed if r["shape"] == sh], direction,
                       library) for sh in shapes]
    bf16 = [r for r in rows if "rel_l2" in r]

    def ours(n):
        return (n == "out") == (direction == "fwd")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(r[f"{direction}_err"] for r in rows
                           if r["dtype"] == "bfloat16"),
        "max_abs_err_f32": max(r[f"{direction}_err"] for r in rows
                               if r["dtype"] == "float32"),
        "bf16_rel_l2": max(e for r in bf16 for n, e in r["rel_l2"].items()
                           if ours(n)),
        "bf16_control_rel_l2": min(
            e for r in bf16 for n, e in r["control_rel_l2"].items()
            if ours(n)),
        "bf16_rel_l2_limit": BF16_REL_TOL[kernel, direction],
        **timings[0], "also_timed": timings[1:], **extra,
    }


def graph_launches(launches):
    """A kernel entry's launches beyond those at its wrapper (``launches``,
    the main path's first calls): recorded into CUDA graphs under
    capture, derived from the replays (what their captures recorded), and
    counted on the device in the main path's profiled round."""
    return {"launches_captured": launches["captured"],
            "launches_replayed_derived": launches["replayed"],
            "launches_on_device": launches["on_device"],
            "launches_on_device_in": "the main path's profiled round"}


def k5_entry(rows, plan, exact, launches, audio, two_step_err, profile,
             stream, audio_cpu):
    """The ``kernels`` entry of K5: errors over every checked shape (fans
    and single units beside their controls), times summed over the three
    launches of one V1 vocode pass at B=8, bucket 512."""
    timed = [r for r in rows if "ms" in r]
    fans = [r for r in rows if r["limit"] == K5_REL_TOL["fan"]]
    units = [r for r in rows if r["limit"] == K5_REL_TOL["unit"]]
    return {
        "name": "fused_mrf", "route": "cuda",
        "source": "daft_exprt_tpu_torch/csrc/mrf_vocoder_tc.cu",
        "replaces": "daft_exprt_tpu/ops/mrf_vocoder.py:127",
        "launches": launches["all"],
        "instance": "tensor_core",
        "launches_tensor_core": launches["tensor_core"],
        **graph_launches(launches),
        "cuda_core_source": "daft_exprt_tpu_torch/csrc/mrf_vocoder.cu "
                            "(C = 8, 16)",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "rel_l2": max(r["rel_l2"] for r in fans),
        "control_rel_l2": min(r["control_rel_l2"] for r in fans),
        "rel_l2_limit": K5_REL_TOL["fan"],
        "unit_rel_l2": max(r["rel_l2"] for r in units),
        "unit_control_rel_l2": min(r["control_rel_l2"] for r in units),
        "unit_rel_l2_limit": K5_REL_TOL["unit"],
        "ms": sum(r["ms"] for r in timed),
        # None where the profiler missed a stage's window
        "device_ms": None if any(r["device_ms"] is None for r in timed)
        else sum(r["device_ms"] for r in timed),
        "ms_by_stage": [r["ms"] for r in timed],
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in timed) else "bytes",
        "library_ms": None,  # no single PyTorch call computes the fan
        "staged_cudnn_ms": sum(r["staged_cudnn_ms"] for r in timed),
        "work_factor_by_stage": [r["work_factor"] for r in timed],
        "plan": plan,
        "exact_rel_l2_by_stage": exact,
        "at": "one V1 vocode pass: stages 1-3 (C=128/64/32, N=32768/65536/"
              "131072), B=8, bucket 512, bf16 operands",
        "shapes": [{k: r[k] for k in r if k not in ("taps", "halo")}
                   for r in rows],
        "serving": audio, "two_step_max_abs_err": two_step_err,
        "profile": profile, "stream": stream, "card_vs_cpu_f32": audio_cpu,
    }


# ----------------------------------------------------------------------
# Text serving through the port's entry points: text front end, style
# extraction, Griffin-Lim, the synthesize CLI and the HTTP server
# ----------------------------------------------------------------------
STYLE_BANK = ROOT / "scripts" / "style_bank" / "english"
# tests/test_torch_reference_features.py's bounds, card vs CPU: the log-mel
# (rtol = atol) where the linear mel is >= LOUD_MEL, the linear mel
# (absolute) below it, the frame energy (relative)
LOG_MEL_TOL, LOUD_MEL, QUIET_MEL_ABS_TOL, ENERGY_REL_TOL = \
    2e-4, 1e-3, 2e-6, 1e-5
TTS_DICTIONARY = {"hello": "HH AH0 L OW1", "world": "W ER1 L D",
                  "this": "DH IH1 S", "is": "IH1 Z", "a": "AH0",
                  "sweet": "S W IY1 T", "good": "G UH1 D", "day": "D EY1",
                  "test": "T EH1 S T", "warm": "W AO1 R M",
                  "morning": "M AO1 R N IH0 NG",
                  "sentence": "S EH1 N T AH0 N S"}
TTS_PLAIN = ["Hello world, this is a test.", "Good morning, sweet world!",
             "Is this a warm day?", "A good sentence is a sweet test."]
TTS_BRACES = ["{HH AH0 L OW1} {W ER1 L D}.",
              "{G UH1 D} {M AO1 R N IH0 NG} , {S W IY1 T} {W ER1 L D}!",
              "{IH1 Z} {DH IH1 S} {AH0} {W AO1 R M} {D EY1}?",
              "{AH0} {G UH1 D} {S EH1 N T AH0 N S} {IH1 Z} {AH0} "
              "{S W IY1 T} {T EH1 S T}."]
TTS_SENTENCE = "{DH IH1 S} {IH1 Z} {AH0} {G UH1 D} {T EH1 S T}."
TTS_PARAGRAPH = ("{HH AH0 L OW1} {W ER1 L D}. {G UH1 D} {M AO1 R N IH0 NG}"
                 "! {IH1 Z} {DH IH1 S} {AH0} {W AO1 R M} {D EY1}?")


LAUNCH_NAMES = ("k1", "k1_tensor_core", "k5", "k5_tensor_core")


def _counts(*engines):
    """The wrappers' launch counters (K1, K1 on the tensor cores, K5, K5
    on the tensor cores), then the same four derived from the
    ``engines``' graph replays. A replay runs no wrapper: each adds the
    launches its capture recorded (``GraphCache.replayed``), a number
    that only the device's trace confirms (``kernel_report``'s
    ``on_device``)."""
    replayed = [sum(e.graphs.replayed[i] for e in engines)
                for i in range(len(LAUNCH_NAMES))]
    return (fused_fft_block.launches, fused_fft_block.tc_launches,
            fused_mrf.launches, fused_mrf.tc_launches, *replayed)


def _launches(before, *engines):
    """Launches since ``before`` (``_counts(*engines)``, or None for
    zero): "k1" and the like counted at the wrappers, "k1_replayed" and
    the like derived from the engines' replays, "k1_total" and the like
    their sums."""
    now = _counts(*engines)
    d = [a - b for a, b in zip(now, before or (0,) * len(now))]
    n = len(LAUNCH_NAMES)
    out = dict(zip(LAUNCH_NAMES, d[:n]))
    out.update({f"{k}_replayed": v for k, v in zip(LAUNCH_NAMES, d[n:])})
    out.update({f"{k}_total": a + b
                for k, a, b in zip(LAUNCH_NAMES, d[:n], d[n:])})
    return out


def _http(port, method, path, body=None):
    """(status, headers, body bytes, seconds to the whole response)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request(method, path, body=json.dumps(body) if body else None,
                 headers={"Content-Type": "application/json"} if body
                 else {})
    resp = conn.getresponse()
    data = resp.read()
    seconds = time.perf_counter() - t0
    conn.close()
    return resp.status, {k.lower(): v for k, v in resp.getheaders()}, \
        data, seconds


def _pcm(data):
    """The samples of a served 22050 Hz mono PCM16 wav."""
    import io
    import wave

    with wave.open(io.BytesIO(data)) as w:
        if (w.getframerate(), w.getnchannels(), w.getsampwidth()) \
                != (SAMPLE_RATE, 1, 2):
            raise AssertionError("served wav is not 22050 Hz mono PCM16")
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def extract_style_bank(hp, tmp, smi):
    """The repo's five style wavs through ``extract_reference_parameters``
    on the card (mel and energy on the card, pitch on the host), each held
    against the same extraction on the CPU; the mel/energy device time per
    wav (CUDA events, median of 25 after warm-up)."""
    from daft_exprt_tpu_torch.audio.io import load_wav
    from daft_exprt_tpu_torch.inference.inputs import \
        extract_reference_parameters
    from daft_exprt_tpu_torch.ops.mel import mel_and_energy_batch, mel_kwargs

    bank = tmp / "bank"
    bank.mkdir()
    rows = []
    for src in sorted(STYLE_BANK.glob("*.wav")):
        wav_path = bank / src.name
        wav_path.write_bytes(src.read_bytes())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = extract_reference_parameters(str(wav_path), str(bank), hp,
                                            "cuda")
        extract_s = time.perf_counter() - t0
        cpu = extract_reference_parameters(str(wav_path), str(tmp / "cpu"),
                                           hp, "cpu")
        wav, _ = load_wav(str(wav_path), target_sr=hp.sampling_rate)
        dev = torch.as_tensor(wav, device="cuda")[None]
        mel_ms = cuda_ms(lambda: mel_and_energy_batch(dev, **mel_kwargs(hp)))
        with np.load(card) as a, np.load(cpu) as b:
            if sorted(a.files) != ["energy", "mel_spec", "pitch"]:
                raise AssertionError(f"{card}: keys {a.files}")
            err = np.abs(a["mel_spec"] - b["mel_spec"])
            quiet = np.exp(b["mel_spec"].astype(np.float64)) < LOUD_MEL
            lin_err = np.abs(np.exp(a["mel_spec"].astype(np.float64))
                             - np.exp(b["mel_spec"].astype(np.float64)))
            row = {"wav": src.name, "frames": int(a["mel_spec"].shape[1]),
                   "audio_s": len(wav) / hp.sampling_rate,
                   "pitch_equal": bool(np.array_equal(a["pitch"],
                                                      b["pitch"])),
                   "loud_log_mel_max_abs_err": float(err[~quiet].max()),
                   "loud_log_mel_over_tol": int(np.sum(
                       (err > LOG_MEL_TOL * (1 + np.abs(b["mel_spec"])))
                       & ~quiet)),
                   "quiet_mel_max_abs_err": float(
                       lin_err[quiet].max(initial=0.0)),
                   "energy_max_rel_err": float(np.max(np.abs(
                       a["energy"] - b["energy"]) / b["energy"])),
                   "mel_energy_ms": mel_ms,
                   "extract_ms": extract_s * 1e3, "card": smi}
        print("style extraction", json.dumps(row), flush=True)
        if not (row["pitch_equal"] and row["loud_log_mel_over_tol"] == 0
                and row["quiet_mel_max_abs_err"] <= QUIET_MEL_ABS_TOL
                and row["energy_max_rel_err"] <= ENERGY_REL_TOL):
            raise AssertionError(f"extraction card vs CPU: {row}")
        rows.append(row)
    return bank, rows


EXTRACTION_PROCESSES = 3
EXTRACTION_SCRIPT = """
import json, shutil, tempfile
from pathlib import Path
import chip_smoke as cs
tmp = Path(tempfile.mkdtemp(prefix="extraction_"))
try:
    _, rows = cs.extract_style_bank(cs.flagship_hparams(), tmp, "")
finally:
    shutil.rmtree(tmp, ignore_errors=True)
print("EXTRACTION", json.dumps(max(r["energy_max_rel_err"] for r in rows)))
"""


def extraction_processes(n=EXTRACTION_PROCESSES):
    """``extract_style_bank`` (card against CPU, frame energy within
    ``ENERGY_REL_TOL``) again in ``n`` fresh processes, all started
    together, where it is the first card work: the largest energy error
    of each; fails if one fails."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", EXTRACTION_SCRIPT],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(n)]
    errs, failed = [], []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith("EXTRACTION ")]
        if proc.returncode != 0 or not lines:
            failed.append(f"{out[-2000:]} {err[-2000:]}")
            continue
        errs.append(json.loads(lines[-1].split(" ", 1)[1]))
    if failed:
        raise AssertionError(f"style extraction in a fresh process: "
                             f"{failed[0]}")
    report = {"processes": n, "energy_max_rel_err": errs,
              "limit": ENERGY_REL_TOL,
              "seconds": time.perf_counter() - t0}
    print("style extraction in fresh processes", json.dumps(report),
          flush=True)
    return report


def time_griffin_lim(hp, mels, smi):
    """Griffin-Lim previews on the card (NNLS + 30 iterations, host clock
    around calls that return host arrays): one utterance and a batch of
    four, median of 5 after one warm-up. The one-utterance path is timed
    in turn with the same work routed through the host between NNLS and
    the phase loop (public ``mel_to_linear`` then
    ``reconstruct_signal_griffin_lim``), which must give the same wav. The
    loops are graph replays; the batch again with their entries run
    eagerly must give the same wavs."""
    from daft_exprt_tpu_torch.audio.griffin_lim import (
        griffin_lim_reconstruction_batch,
        griffin_lim_reconstruction_from_mel_spec, mel_to_linear,
        reconstruct_signal_griffin_lim)
    from daft_exprt_tpu_torch.inference.graphs import process_cache

    def host_ms(*fns, reps=5):
        for fn in fns:
            fn()
        times = [[] for _ in fns]
        for _ in range(reps):
            for fn, ts in zip(fns, times):
                t0 = time.perf_counter()
                out = fn()
                ts.append((time.perf_counter() - t0) * 1e3)
        return [float(np.median(ts)) for ts in times], out

    def via_host(mel):
        log_mel = mel[:, :-2]
        t_eff = log_mel.shape[1]
        t_pad = -(-t_eff // hp.frame_bucket) * hp.frame_bucket
        log_mel = np.pad(log_mel, ((0, 0), (0, t_pad - t_eff)),
                         constant_values=float(np.log(hp.min_clipping)))
        linear = mel_to_linear(log_mel, hp, device="cuda")
        wav = reconstruct_signal_griffin_lim(linear, hp.hop_length,
                                             device="cuda")
        wav = wav[:(t_eff - 1) * hp.hop_length + hp.filter_length]
        return wav / np.max(np.abs(wav))

    (roundtrip_ms, one_ms), wav = host_ms(
        lambda: via_host(mels[0]),
        lambda: griffin_lim_reconstruction_from_mel_spec(
            mels[0], hp, device="cuda"))
    roundtrip_err = float(np.abs(via_host(mels[0]) - wav).max())
    if roundtrip_err > 1e-6:
        raise AssertionError(f"Griffin-Lim on the card vs through the host: "
                             f"max abs {roundtrip_err}")
    (batch_ms,), wavs = host_ms(lambda: griffin_lim_reconstruction_batch(
        mels[:4], hp, device="cuda"))
    # the loops' entries run eagerly on the card: the same wavs
    cache = process_cache("griffin_lim", torch.device("cuda"))
    cache.cuda = False
    try:
        (eager_batch_ms,), eager_wavs = host_ms(
            lambda: griffin_lim_reconstruction_batch(mels[:4], hp,
                                                     device="cuda"))
    finally:
        cache.cuda = True
    replayed_equal = all(np.array_equal(a, b)
                         for a, b in zip(wavs, eager_wavs))
    if not replayed_equal:
        raise AssertionError("Griffin-Lim replayed against eager: the wavs "
                             "differ")
    for w, m in zip([wav] + wavs, mels[:1] + mels[:4]):
        want = (m.shape[1] - 3) * hp.hop_length + hp.filter_length
        if w.shape != (want,) or not np.isfinite(w).all() \
                or abs(np.abs(w).max() - 1.0) > 1e-6:
            raise AssertionError(f"Griffin-Lim preview {w.shape}, want "
                                 f"({want},) peak-normalized")
    row = {"frames": [int(m.shape[1]) for m in mels[:4]],
           "one_utterance_ms": one_ms, "batch_of_4_ms": batch_ms,
           "one_utterance_through_host_ms": roundtrip_ms,
           "through_host_max_abs_diff": roundtrip_err,
           "batch_of_4_eager_ms": eager_batch_ms,
           "replayed_equals_eager": replayed_equal,
           "graphs": len(cache), "replays": cache.replays,
           "iterations": 30, "card": smi}
    print("griffin-lim", json.dumps(row), flush=True)
    return row


# a server's previews: (sentences, duration factor) of each request, so
# that the stream meets every padded batch size (1, 2, 4, 8) and several
# output buckets
PREVIEW_STREAM = ((1, 1.0), (2, 1.0), (3, 1.6), (5, 1.0), (8, 2.2),
                  (1, 2.2), (4, 1.0), (2, 3.0))


def preview_stream(service, stream):
    """The requests of ``stream`` through ``service.run_jobs`` (a server
    without a vocoder: Griffin-Lim previews), host ms each; every wav its
    utterance's length and finite."""
    style = sorted(service.styles)[0]
    ms = []
    for n, factor in stream:
        jobs = [service.prepare_job(TTS_BRACES[i % len(TTS_BRACES)],
                                    speaker_id=i % 2, style=style,
                                    dur_factor=factor) for i in range(n)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = service.run_jobs(jobs, "add")
        ms.append((time.perf_counter() - t0) * 1e3)
        for wav, frames, _, _ in results:
            if wav.shape != ((frames - 3) * HOP + 1024,) \
                    or not np.isfinite(wav).all():
                raise AssertionError(f"preview of {frames} frames: "
                                     f"{wav.shape}")
    return ms


def griffin_lim_server(ckpt, bank, smi):
    """A server without a vocoder at flagship width: warm-up s and what it
    captured (the engine's passes; NNLS and the phase loop at every padded
    batch size and output bucket, in the process's Griffin-Lim cache),
    then ``PREVIEW_STREAM`` twice (each request of the first round the
    first of its shape), host ms; no graph of either cache is captured
    after warm-up."""
    from daft_exprt_tpu_torch.cli import serve as srv
    from daft_exprt_tpu_torch.inference.graphs import process_cache

    t0 = time.perf_counter()
    service = srv.SynthesisService(str(ckpt), str(bank), max_batch=8,
                                   device="cuda")
    service.warmup()
    warmup_s = time.perf_counter() - t0
    engine = service.engine
    gl = process_cache("griffin_lim", torch.device("cuda"))
    warm = (engine.graphs.captures, gl.captures)
    first = preview_stream(service, PREVIEW_STREAM)
    again = preview_stream(service, PREVIEW_STREAM)
    row = {"warmup_s": warmup_s, "engine_graphs": len(engine.graphs),
           "griffin_lim_graphs": len(gl),
           "griffin_lim_bound": gl.max_entries,
           "griffin_lim_pool_bytes": gl.pool_bytes(),
           "stream": PREVIEW_STREAM, "first_ms": first, "again_ms": again,
           "captures_after_warmup": engine.graphs.captures - warm[0]
           + gl.captures - warm[1], "card": smi}
    print("griffin-lim server", json.dumps(row), flush=True)
    shapes = 2 * 4 * len(engine.out_frame_buckets)  # NNLS and phase loop
    if row["captures_after_warmup"] or len(gl) < shapes:
        raise AssertionError(f"griffin-lim server: {row}, expected "
                             f"{shapes} loop graphs from warm-up alone")
    return row


def run_cli(argv):
    """``python -m daft_exprt_tpu_torch.cli.synthesize`` in this process;
    (seconds, K1/K5 launches at the wrappers: each graph's first call, as
    the CLI's engine replays the rest)."""
    from daft_exprt_tpu_torch.cli import synthesize

    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    synthesize.main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, _launches(before)


def run_cli_process(argv, home):
    """``python -m daft_exprt_tpu_torch.cli.synthesize`` as a user runs it,
    in a process of its own (interpreter start, imports, CUDA start-up and
    loading the built kernels included); wall seconds."""
    env = dict(os.environ, HOME=str(home))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "daft_exprt_tpu_torch.cli.synthesize",
         *argv], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"synthesize CLI process exited "
                             f"{run.returncode}: {run.stderr[-2000:]}")
    return seconds


def check_cli_outputs(out, bank, lines, hop, vocoder):
    """4 mels (.npz), 4 wavs, the pairs and sentence files."""
    from scipy.io import wavfile

    npz = sorted(out.glob("*.npz"))
    pairs = (out / "ref_generated_pairs.txt").read_text().splitlines()
    sents = (out / "sentences_to_generate.txt").read_text().splitlines()
    if len(npz) != len(lines) or len(pairs) != len(lines) \
            or len(sents) != len(lines):
        raise AssertionError(f"CLI outputs in {out}: {len(npz)} mels, "
                             f"{len(pairs)} pairs, {len(sents)} sentences")
    frames = []
    for path in npz:
        with np.load(path) as z:
            mel = z["mel_spec"]
        if mel.shape[0] != 80 or mel.shape[1] < 4 \
                or not np.isfinite(mel).all():
            raise AssertionError(f"{path.name}: mel {mel.shape}")
        rate, wav = wavfile.read(str(path.with_suffix(".wav")))
        want = mel.shape[1] * hop if vocoder \
            else (mel.shape[1] - 3) * hop + 1024
        if rate != SAMPLE_RATE or wav.shape != (want,) \
                or not np.abs(wav).max() > 0:
            raise AssertionError(f"{path.name}: wav {wav.shape} at {rate}, "
                                 f"want ({want},)")
        frames.append(int(mel.shape[1]))
    for line in pairs:
        ref_wav, gen_wav = line.split("|")
        if Path(ref_wav).parent != bank or not Path(ref_wav).is_file() \
                or not Path(gen_wav).is_file():
            raise AssertionError(f"pairs line {line}")
    return frames


def text_serving(smi):
    """The text-serving phase at flagship width (config defaults, bf16,
    seed-0 weights with the duration head pinned, written as a reference
    .pt; a seed-0 V1 generator as a torch g_* file)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer

    from daft_exprt_tpu_torch.checkpoint import save_reference_checkpoint
    from daft_exprt_tpu_torch.cli import serve as srv

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tts_"))
    home = os.environ.get("HOME")
    servers = []
    try:
        hp = flagship_hparams()
        model = DaftExprt(hp, seed=0)
        pin_durations(model)
        ckpt = tmp / "DaftExprt_seed0.pt"
        save_reference_checkpoint(str(ckpt), model, hp)
        del model
        voc, voc_cfg = write_seed0_vocoder(tmp)
        report = {"card": smi}

        bank, report["extraction"] = extract_style_bank(hp, tmp, smi)
        report["extraction_fresh_processes"] = extraction_processes()

        # the CLI, in this process: plain text through a tiny dictionary
        # (HyperParams finds it under $HOME/Documents/MFA) with
        # Griffin-Lim previews; pre-phonemized lines with --vocoder
        mfa = tmp / "home" / "Documents" / "MFA" / "pretrained_models" \
            / "dictionary"
        mfa.mkdir(parents=True)
        (mfa / "english.dict").write_text("".join(
            f"{w}\t{p}\n" for w, p in TTS_DICTIONARY.items()))
        os.environ["HOME"] = str(tmp / "home")
        report["cli"] = []
        for label, lines, extra in (
                ("plain_text_griffin_lim", TTS_PLAIN, []),
                ("braces_vocoder_control", TTS_BRACES,
                 ["--vocoder", str(voc), "--vocoder_config", str(voc_cfg),
                  "--control"])):
            text = tmp / f"{label}.txt"
            text.write_text("\n".join(lines) + "\n")
            out = tmp / f"out_{label}"
            seconds, launches = run_cli(
                ["--checkpoint", str(ckpt), "--text_file", str(text),
                 "--style_bank", str(bank), "--output_dir", str(out),
                 "--batch_size", "4", *extra])
            frames = check_cli_outputs(out, bank, lines, HOP,
                                       vocoder=bool(extra))
            row = {"run": label, "seconds": seconds, "frames": frames,
                   "launches": launches, "card": smi}
            print("synthesize CLI", json.dumps(row), flush=True)
            if launches["k1"] == 0 or launches["k1_tensor_core"] \
                    != launches["k1"] or (launches["k5"] == 0) == bool(extra):
                raise AssertionError(f"CLI launches: {row}")
            report["cli"].append(row)
        # the Griffin-Lim run again, as a user runs it
        text = tmp / "plain_text_griffin_lim.txt"
        out = tmp / "out_plain_text_process"
        seconds = run_cli_process(
            ["--checkpoint", str(ckpt), "--text_file", str(text),
             "--style_bank", str(bank), "--output_dir", str(out),
             "--batch_size", "4"], tmp / "home")
        frames = check_cli_outputs(out, bank, TTS_PLAIN, HOP, vocoder=False)
        row = {"run": "plain_text_griffin_lim_process", "seconds": seconds,
               "frames": frames, "card": smi}
        print("synthesize CLI", json.dumps(row), flush=True)
        report["cli"].append(row)
        mels = []
        for path in sorted((tmp / "out_plain_text_griffin_lim").glob("*.npz")):
            with np.load(path) as z:
                mels.append(z["mel_spec"])
        report["griffin_lim"] = time_griffin_lim(hp, mels, smi)

        # the server: warm-up, then requests over HTTP
        service = srv.SynthesisService(str(ckpt), str(bank), vocoder=str(voc),
                                       vocoder_config=str(voc_cfg),
                                       max_batch=8, device="cuda")
        t0 = time.perf_counter()
        httpd = srv.serve(service, "127.0.0.1", 0)
        report["warmup_s"] = time.perf_counter() - t0
        report["warmup_graphs"] = graph_report(service.engine)
        servers.append(httpd)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        print(f"server warm-up: {report['warmup_s']:.3f} s (pitch "
              f"transforms add and multiply, output buckets "
              f"{service.engine.out_frame_buckets}, symbol buckets 16 and "
              f"32, batch sizes 1, 2, 4, 8), graphs "
              f"{json.dumps(report['warmup_graphs'])} -- {smi}", flush=True)
        # an audio and a fused graph a (B, L, transform, bucket): 4 x 2 x 2
        # x 4 of each, and a FiLM graph a (B, reference bucket of the
        # bank); the warm-up request and stream replay them
        from daft_exprt_tpu_torch.data.loader import bucket_size

        engine = service.engine
        ref_buckets = {bucket_size(st["mel_spec"].shape[1], hp.frame_bucket,
                                   hp.max_frames)
                       for st in service.styles.values()}
        report["warmup_graphs"]["expected"] = 4 * 2 * 2 * len(
            engine.out_frame_buckets) * 2 + 4 * len(ref_buckets)
        if report["warmup_graphs"]["graphs"] \
                != report["warmup_graphs"]["expected"] \
                or engine.graphs.captures != len(engine.graphs):
            raise AssertionError(f"server warm-up captured "
                                 f"{report['warmup_graphs']}")
        # the streamer's window: one graph of the generator's own, captured
        # by the warm-up's stream
        vg = vocoder_graphs(service.streamer.gen)
        report["warmup_graphs"]["vocoder"] = graph_report(vg)
        if len(vg.graphs) != 1 or vg.graphs.captures != 1:
            raise AssertionError(f"server warm-up captured "
                                 f"{report['warmup_graphs']['vocoder']} "
                                 "vocoder graphs, expected the window's")
        warm_captures = engine.graphs.captures + vg.graphs.captures
        # K1 launches: the phoneme encoder's and decoder's blocks a pass,
        # the prosody encoder's a FiLM batch
        per_pass = hp.phoneme_encoder["nb_blocks"] \
            + hp.frame_decoder["nb_blocks"]
        per_film = hp.prosody_encoder["nb_blocks"]
        fused_fft_block.launches = fused_fft_block.tc_launches = 0
        fused_mrf.launches = fused_mrf.tc_launches = 0
        start = _counts(engine, vg)
        status, _, data, _ = _http(port, "GET", "/health")
        health = json.loads(data)
        status2, _, data, _ = _http(port, "GET", "/styles")
        styles = json.loads(data)
        if status != 200 or status2 != 200 or health["styles"] != 5 \
                or not health["vocoder"] or len(styles["styles"]) != 5 \
                or len(styles["speakers"]) != len(FLAGSHIP_SPEAKERS):
            raise AssertionError(f"/health {health} /styles {styles}")
        requests = [("sentence_new_style", {
                        "text": TTS_SENTENCE, "speaker_id": 3,
                        "style": "happy_ref"}),
                    ("sentence_cached_style_controls", {
                        "text": TTS_SENTENCE, "speaker_id": 3,
                        "style": "happy_ref", "dur_factor": 1.25,
                        "pitch_factor": 1.1, "pitch_transform": "multiply"}),
                    ("paragraph_3_sentences", {
                        "text": TTS_PARAGRAPH, "speaker_id": 7,
                        "style": "sad_ref", "gap_ms": 100})]
        rows = []
        for label, body in requests:
            before = _counts(engine)
            passes, films = engine.passes, engine.film_batches
            status, headers, data, seconds = _http(port, "POST",
                                                   "/synthesize", body)
            pcm = _pcm(data)
            frames = int(headers["x-mel-frames"])
            gap = 2 * int(0.1 * SAMPLE_RATE) if "gap_ms" in body else 0
            row = {"request": label, "status": status, "frames": frames,
                   "samples": int(pcm.size), "latency_ms": seconds * 1e3,
                   "synthesis_ms": float(headers["x-synthesis-seconds"])
                   * 1e3, "passes": engine.passes - passes,
                   "prosody_encoder_batches": engine.film_batches - films,
                   **_launches(before, engine), "card": smi}
            print("served request", json.dumps(row), flush=True)
            if status != 200 or pcm.size != frames * HOP + gap \
                    or headers["x-truncated"] != "false" \
                    or not np.abs(pcm).max() > 0 \
                    or row["k1_total"] != per_pass * row["passes"] \
                    + per_film * row["prosody_encoder_batches"] \
                    or row["k5_total"] != 3 * row["passes"]:
                raise AssertionError(f"/synthesize {label}: {row}")
            rows.append(row)
        # /stream: the acoustic pass, then HiFi-GAN window by window; time
        # to first audio on the server's clock (/stats)
        before = _counts(engine, vg)
        status, headers, data, seconds = _http(port, "POST", "/stream", {
            "text": TTS_PARAGRAPH, "speaker_id": 1, "style": "angry_ref"})
        stream = {"request": "stream_paragraph", "status": status,
                  "frames": int(headers["x-mel-frames"]),
                  "samples": int(_pcm(data).size),
                  "latency_ms": seconds * 1e3,
                  **_launches(before, engine, vg), "card": smi}
        _, _, data, _ = _http(port, "GET", "/stats")
        stats = json.loads(data)
        stream["ttfa_ms"] = stats["p50_ttfa_ms"]
        print("served stream", json.dumps(stream), flush=True)
        if status != 200 or stream["samples"] != stream["frames"] * HOP \
                or stats["stream_requests"] != 1 \
                or stats["requests"] != len(rows) + 1 \
                or stream["k5_total"] == 0 or stream["k5_total"] % 3 \
                or stream["k5"] != 0:
            raise AssertionError(f"/stream {stream} /stats {stats}")
        serving = _launches(start, engine, vg)
        # a fresh server's first requests of every kind are replays
        report["captures_after_warmup"] = engine.graphs.captures \
            + vg.graphs.captures - warm_captures
        if report["captures_after_warmup"]:
            raise AssertionError(f"{report['captures_after_warmup']} "
                                 "graphs captured after the warm-up")

        # the served wav equals run_cached_to_audio on the same inputs
        job = service.prepare_job(TTS_SENTENCE, speaker_id=3,
                                  style="happy_ref")
        inputs, keys = service._collate_jobs([job], "add")
        with service.lock, torch.no_grad():
            wavs, lens, _ = engine.run_cached_to_audio(inputs, "add", keys)
        _, _, data, _ = _http(port, "POST", "/synthesize", requests[0][1])
        report["served_wav_equals_engine"] = \
            _pcm(data).tobytes() == srv.pcm16_bytes(wavs[0])
        print("served wav == run_cached_to_audio on the same inputs: "
              f"{report['served_wav_equals_engine']}", flush=True)
        if not report["served_wav_equals_engine"] \
                or int(lens[0]) != rows[0]["frames"]:
            raise AssertionError("the served wav differs from "
                                 "run_cached_to_audio on the same inputs")
        # one cached-style sentence through SynthesisService.synthesize
        # (the HTTP handler's call), profiled after one unprofiled run
        service.synthesize(TTS_SENTENCE, speaker_id=3, style="happy_ref")
        report["profile"] = replayed_request(
            engine, lambda: service.synthesize(TTS_SENTENCE, speaker_id=3,
                                               style="happy_ref"),
            "the profiled served request",
            lambda passes, films: {"k1": per_pass * passes
                                   + per_film * films, "k5": 3 * passes})
        print("served request profile", json.dumps(report["profile"]),
              f"-- {smi}", flush=True)
        k1_all_tensor_core(report["profile"], "the served request")

        # four concurrent requests through a batcher-enabled service
        batched = srv.SynthesisService(str(ckpt), str(bank), vocoder=str(voc),
                                       vocoder_config=str(voc_cfg),
                                       max_batch=8, batch_window_ms=200.0,
                                       device="cuda")
        seen = []
        run_jobs = batched.run_jobs

        def spy(jobs, pt):
            seen.append(len(jobs))
            return run_jobs(jobs, pt)

        batched.run_jobs = spy
        batched.warmup()  # as srv.serve warms a server
        seen.clear()
        warm_captures = batched.engine.graphs.captures
        httpd2 = ThreadingHTTPServer(("127.0.0.1", 0),
                                     srv.make_handler(batched))
        servers.append(httpd2)
        threading.Thread(target=httpd2.serve_forever, daemon=True).start()
        bodies = [{"text": TTS_BRACES[i], "speaker_id": i,
                   "style": "neutral_ref"} for i in range(4)]
        before = _counts(batched.engine)
        with ThreadPoolExecutor(4) as ex:
            results = list(ex.map(lambda b: _http(
                httpd2.server_address[1], "POST", "/synthesize", b), bodies))
        concurrent = {"request": "4_concurrent", "batch_sizes": seen,
                      "latency_ms": [r[3] * 1e3 for r in results],
                      **_launches(before, batched.engine),
                      "captures": batched.engine.graphs.captures
                      - warm_captures, "card": smi}
        print("concurrent requests", json.dumps(concurrent), flush=True)
        if any(r[0] != 200 for r in results) or max(seen) < 2 \
                or concurrent["captures"]:
            raise AssertionError(f"batcher: {concurrent}")
        launches = {k: serving[k] + concurrent[k] for k in serving}
        report["griffin_lim_server"] = griffin_lim_server(ckpt, bank, smi)
        for row in rows + [stream, concurrent]:
            if row["k1_total"] == 0 \
                    or row["k1_total"] != row["k1_tensor_core_total"] \
                    or row["k5_total"] != row["k5_tensor_core_total"]:
                raise AssertionError(f"launches off the tensor-core "
                                     f"instances: {row}")
        if launches["k5_total"] == 0:
            raise AssertionError(f"text serving launched no K5: {launches}")
        report.update(requests=rows, stream=stream, concurrent=concurrent,
                      stats=stats, launches=launches)
        print("text serving", json.dumps(report), flush=True)
        return report
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Training runtime: a synthetic corpus on disk, trained through the
# port's Trainer and cli.training
# ----------------------------------------------------------------------
CORPUS_SPEAKERS = ("spk_a", "spk_b")
ALIGN_OFFSET_S = 0.25  # leading silence of the synthetic wavs


def write_corpus(root, n_utts=64, symbols=(64, 128), frames_per_symbol=(4, 8),
                 n_val=4, seed=0, audio=True, hop=256, rate=22050):
    """A synthetic two-speaker feature corpus in ``FeatureDataset``'s
    on-disk format, made with numpy from ``seed``: per utterance ``.npy``
    (80, T) log-mel, ``.markers``, ``.symbols_nrg``, ``.symbols_f0``,
    ``.frames_nrg``, ``.frames_f0``; ``train.txt`` / ``val.txt`` (the last
    ``n_val`` utterances of each speaker validate) and per-speaker stats of
    the training utterances. Mel, durations, energy and pitch are functions
    of the symbol and the speaker plus small noise, so a model can learn
    them. With ``audio``: a tone wav per utterance under
    ``dataset/<spk>/wavs`` with ``ALIGN_OFFSET_S`` of leading silence, and
    ``dataset/<spk>/align/<name>.markers`` at the wav's absolute times.

    :return: {"features_dir", "dataset_dir", "train", "val", "stats"}
    """
    from daft_exprt_tpu_torch.audio.io import save_wav

    root = Path(root)
    rng = np.random.default_rng(seed)
    phones = [p for p in SYMBOLS_ENGLISH if p.isalnum()]  # ARPAbet
    n_sym = len(phones)
    # per-symbol spectral template (smooth over the 80 bins), duration,
    # energy and pitch offset; per-speaker spectral tilt and base pitch
    bins = np.linspace(0.0, 1.0, 80)
    centers = rng.uniform(0.0, 1.0, n_sym)
    widths = rng.uniform(0.05, 0.3, n_sym)
    template = -7.0 + 5.0 * np.exp(-((bins[None] - centers[:, None])
                                     / widths[:, None]) ** 2)
    base_dur = rng.integers(frames_per_symbol[0], frames_per_symbol[1] + 1,
                            n_sym)
    pitch_off = rng.uniform(-0.15, 0.15, n_sym)
    unvoiced = rng.random(n_sym) < 0.2
    tilt = {spk: rng.uniform(-0.5, 0.5) * (bins - 0.5)
            for spk in CORPUS_SPEAKERS}
    base_hz = {spk: hz for spk, hz in zip(CORPUS_SPEAKERS, (120.0, 210.0))}
    features_dir, dataset_dir = root / "features", root / "dataset"
    lists = {"train": [], "val": []}
    sym_values = {spk: {"energy": [], "pitch": []} for spk in CORPUS_SPEAKERS}
    sym_durs = {}
    for spk_id, spk in enumerate(CORPUS_SPEAKERS):
        fdir = features_dir / spk
        fdir.mkdir(parents=True, exist_ok=True)
        for u in range(n_utts):
            name = f"{spk}_{u:04d}"
            L = int(rng.integers(symbols[0], symbols[1] + 1))
            ids = rng.integers(0, n_sym, L)
            durs = np.maximum(base_dur[ids] + rng.integers(-1, 2, L), 1)
            frame_ids = np.repeat(ids, durs)
            T = int(durs.sum())
            mel = (template[frame_ids].T + tilt[spk][:, None]
                   + 0.1 * rng.standard_normal((80, T))).astype(np.float32)
            frames_nrg = (np.exp(mel).sum(0) + 0.01).astype(np.float32)
            f0 = np.log(base_hz[spk] * (1.0 + pitch_off[frame_ids])) \
                + 0.01 * rng.standard_normal(T)
            frames_f0 = np.where(unvoiced[frame_ids], 0.0, f0) \
                .astype(np.float32)
            edges = np.concatenate([[0], np.cumsum(durs)])
            sym_nrg = np.array([frames_nrg[a:b].mean()
                                for a, b in zip(edges[:-1], edges[1:])])
            sym_f0 = np.array([0.0 if unvoiced[i] else
                               frames_f0[a:b].mean() for i, a, b in
                               zip(ids, edges[:-1], edges[1:])])
            base = fdir / name
            np.save(f"{base}.npy", mel)

            def markers(offset):
                return "".join(
                    f"{offset + int(a) * hop / rate!r}\t"
                    f"{offset + int(b) * hop / rate!r}"
                    f"\t{int(b - a)}\t{phones[i]}\tw{k // 4}\t{k // 4}\n"
                    for k, (i, a, b) in enumerate(zip(ids, edges[:-1],
                                                       edges[1:])))

            Path(f"{base}.markers").write_text(markers(0.0))
            for ext, col in ((".symbols_nrg", sym_nrg),
                             (".symbols_f0", sym_f0),
                             (".frames_nrg", frames_nrg),
                             (".frames_f0", frames_f0)):
                Path(f"{base}{ext}").write_text(
                    "".join(f"{float(v)!r}\n" for v in col))
            val = u >= n_utts - n_val
            lists["val" if val else "train"].append(f"{fdir}|{name}|{spk_id}")
            if not val:
                sym_values[spk]["energy"] += [v for v in sym_nrg if v]
                sym_values[spk]["pitch"] += [v for v in sym_f0 if v]
                for i, d in zip(ids, durs):
                    sym_durs.setdefault(phones[i], []).append(
                        int(d) * hop / rate)
            if audio:
                align = dataset_dir / spk / "align"
                wavs = dataset_dir / spk / "wavs"
                align.mkdir(parents=True, exist_ok=True)
                wavs.mkdir(parents=True, exist_ok=True)
                (align / f"{name}.markers").write_text(
                    markers(ALIGN_OFFSET_S))
                pad = int(ALIGN_OFFSET_S * rate)
                hz = np.repeat(np.exp(np.where(frames_f0 > 0, frames_f0,
                                               np.log(base_hz[spk]))), hop)
                tone = 0.3 * np.sin(2 * np.pi * np.cumsum(hz) / rate)
                save_wav(str(wavs / f"{name}.wav"), np.concatenate(
                    [np.zeros(pad), tone, np.zeros(pad)]).astype(np.float32),
                    rate)
    for split, lines in lists.items():
        (root / f"{split}.txt").write_text("\n".join(lines) + "\n")

    def summary(values):
        v = np.asarray(values, np.float64)
        return {"mean": float(v.mean()), "std": float(v.std()),
                "min": float(v.min()), "max": float(v.max())}

    stats = {f"spk {i}": {k: summary(v) for k, v in
                          sym_values[spk].items()}
             for i, spk in enumerate(CORPUS_SPEAKERS)}
    stats["symbols"] = {s: {"dur_mean": float(np.mean(d)),
                            "dur_std": float(np.std(d)),
                            "dur_min": float(np.min(d)),
                            "dur_max": float(np.max(d))}
                        for s, d in sym_durs.items()}
    return {"features_dir": str(features_dir), "dataset_dir": str(dataset_dir),
            "train": str(root / "train.txt"), "val": str(root / "val.txt"),
            "stats": stats}


def write_experiment(experiments_dir, name, corpus, **overrides):
    """``<experiments_dir>/<name>/config.json`` for ``cli.training`` over
    ``corpus`` (``HyperParams.save_hyper_params``); returns the
    HyperParams."""
    out = Path(experiments_dir) / name
    hp = HyperParams(verbose=False, training_files=corpus["train"],
                     validation_files=corpus["val"],
                     output_directory=str(out), language="english",
                     speakers=list(CORPUS_SPEAKERS), stats=corpus["stats"],
                     **overrides)
    hp.save_hyper_params(str(out / "config.json"))
    return hp


# flagship training-runtime phase: which iterations validate, checkpoint
# and fire the hook; the learning check's length (<= 3 min on the card)
RUNTIME_EVERY = 3          # validation, checkpoint and hook at 3 and 6
RUNTIME_ITERATIONS = 6
TIMED_ITERATIONS = 12      # the timed loop: validation and saves at 5, 10
PREEMPT_AFTER = 10         # SIGTERM after the first logged iteration
SOAK_ITERATIONS = 300      # the learning check, validated every 75
LEARNING_RATIO = 0.5       # the validation mel L1 must at least halve
# the resumed run against the uninterrupted one at iteration 6 (the same
# batches, dropout seeds and optimizer state), and the NCCL world-of-one
# first step against the no-group one (the all-reduce of one rank is a
# copy, x / 1 exact): weights and Adam moments bit-equal, as every run of
# this phase on an NVIDIA H100 80GB HBM3 at 700 W read them (PERF.md); a
# moment reset or a lost all-reduce would move them by ~lr
RESUME_PARAM_TOL = RESUME_MOMENT_REL_TOL = FIRST_STEP_TOL = 0.0
FIRST_STEPS = 3  # NCCL against no group: two captures, then a replay


def soak_overrides():
    """``tools/learning_soak.py``'s model: 2+2+1+2 FFT blocks, E=128,
    C=1024, bf16, dropout 0.1, batch 2, no accumulation, max lr 1e-3."""
    block = dict(nb_blocks=2, hidden_embed_dim=128, attn_dropout=0.1,
                 conv_kernel=3, conv_channels=1024, conv_dropout=0.1)
    return dict(
        prosody_encoder=dict(block, attn_nb_heads=8),
        phoneme_encoder=dict(block, attn_nb_heads=2),
        local_prosody_predictor={"nb_blocks": 1, "conv_kernel": 3,
                                 "conv_channels": 256, "conv_dropout": 0.1},
        frame_decoder={k: v for k, v in block.items()
                       if k != "hidden_embed_dim"} | {"attn_nb_heads": 2},
        batch_size=2, accumulation_steps=1, max_learning_rate=1e-3,
        iters_check_for_model_improvement=SOAK_ITERATIONS // 4,
        iters_per_checkpoint=10 * SOAK_ITERATIONS)


def benchmark_dictionary(path):
    """A pronunciation for every word of the benchmark sentences (one
    phone a letter), so the hook's phonemizer needs no g2p model."""
    from daft_exprt_tpu_torch.data.features import split_sentence_words
    from daft_exprt_tpu_torch.text import text_cleaner

    letters = dict(zip("abcdefghijklmnopqrstuvwxyz", (
        "AE1 B K D EH1 F G HH IH1 JH K L M N AA1 P K R S T AH1 V W K Y "
        "Z").split()))
    words = set()
    sentences = ROOT / "scripts" / "benchmarks" / "english" / "sentences.txt"
    for line in sentences.read_text().splitlines():
        cleaned = text_cleaner(line.strip(), "english").lower().strip()
        words |= set(split_sentence_words(cleaned, "english")[0])
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(
        f"{w}\t{' '.join(letters[c] for c in w if c in letters)}\n"
        for w in sorted(words)))
    return len(words)


def _train_counts(*caches):
    """The training kernels' and K1's launches: at the wrappers, plus
    those the ``caches``' replays ran (derived from their captures; the
    train and eval steps' graphs)."""
    replayed = _train_replayed(*caches)
    counts = {name: getattr(fn, attr) + replayed[name]
              for name, (fn, attr) in TRAIN_COUNTERS.items()}
    k1 = {}
    for c in caches:
        for (obj, attr), v in zip(c.counters, c.replayed):
            if obj is fused_fft_block:
                k1[attr] = k1.get(attr, 0) + v
    counts["k1"] = fused_fft_block.launches + k1.get("captured", 0)
    counts["k1_tensor_core"] = fused_fft_block.tc_launches \
        + k1.get("tc_captured", 0)
    return counts


def _counts_since(before, *caches):
    return {k: v - before[k] for k, v in _train_counts(*caches).items()}


def _zero_counts():
    for fn, attr in TRAIN_COUNTERS.values():
        setattr(fn, attr, 0)
    fused_fft_block.launches = fused_fft_block.tc_launches = 0
    fused_mrf.launches = fused_mrf.tc_launches = 0


def check_launches(what, ok, detail):
    """Fail the phase when a launch count is not as expected."""
    if not ok:
        raise AssertionError(f"{what}: launches {detail}")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _max_abs_diff(a, b):
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in b)


def _rel_l2_dict(a, b):
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return (num / max(den, 1e-300)) ** 0.5


def run_training_cli(argv):
    """``python -m daft_exprt_tpu_torch.cli.training`` in this process;
    (what its ``main`` returns, seconds)."""
    from daft_exprt_tpu_torch.cli import training

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = training.main(argv)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def preempt_process(exps, name, home, device="cuda"):
    """``cli.training train`` as its own process, SIGTERM after its first
    logged iteration: (exit code, iteration it stopped at, seconds)."""
    import queue
    import signal

    env = dict(os.environ, HOME=str(home))
    proc = subprocess.Popen(
        [sys.executable, "-m", "daft_exprt_tpu_torch.cli.training", "train",
         "--experiments_dir", str(exps), "--experiment_name", name,
         "--no_benchmark_synthesis", "--max_iterations",
         str(4 * PREEMPT_AFTER), "--device", device], cwd=ROOT, env=env,
        stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(x) for x in proc.stderr], daemon=True)
    reader.start()
    t0 = time.perf_counter()
    log, signalled = [], False
    try:
        while time.perf_counter() - t0 < 300:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            log.append(line)
            if not signalled and f"iter {PREEMPT_AFTER}:" in line:
                proc.send_signal(signal.SIGTERM)
                signalled = True
        code = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(10)
    seconds = time.perf_counter() - t0
    stop = [x for x in log if "stop requested at iteration" in x]
    if not signalled or not stop:
        raise AssertionError("preempted CLI: no SIGTERM or no stop line; "
                             f"log tail {''.join(log[-20:])}")
    reached = int(stop[-1].split("stop requested at iteration ")[1]
                  .split()[0])
    return code, reached, seconds


LOOP_GROUPS = {"k2_ms": K2_KERNELS, "k2_tensor_core_ms": K2_TC_KERNELS,
               "k3_ms": K3_KERNELS, "k3_tensor_core_ms": CONV_FF_TC_KERNELS}


class TimedTrainer(Trainer):
    """``Trainer`` keeping host-clock seconds in ``timings``: ``iteration``
    (from the loop's request for one step to its request for the next),
    ``data_wait`` (inside those requests), ``validation`` and
    ``save_block`` (the part of a checkpoint save the loop waits for).
    ``assembly`` "thread" is the ``Trainer``'s own (the prefetch thread
    over ``train_loader.steps``); "inline" assembles each step on the
    loop's thread when it is due; "thread_per_epoch" is the prefetch
    thread over one ``train_loader.epoch`` call an epoch (a worker loader
    forks its workers every epoch)."""

    def __init__(self, *args, assembly="thread", **kwargs):
        super().__init__(*args, **kwargs)
        self.assembly = assembly
        self.timings = {k: [] for k in ("iteration", "data_wait",
                                        "validation", "save_block")}

    def _batches(self, train_loader, steps_per_epoch):
        epoch, start = divmod(self.iteration, steps_per_epoch)
        if self.assembly == "inline":
            batches = train_loader.steps(epoch, start)
        elif self.assembly == "thread_per_epoch":
            batches = prefetch_iterator(_epochs(train_loader, epoch, start))
        else:
            batches = super()._batches(train_loader, steps_per_epoch)
        last = None
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(batches)
                self.timings["data_wait"].append(time.perf_counter() - t0)
                if last is not None:
                    self.timings["iteration"].append(t0 - last)
                last = t0
                yield batch
        finally:
            batches.close()

    def validate(self, val_loader):
        t0 = time.perf_counter()
        out = super().validate(val_loader)
        self.timings["validation"].append(time.perf_counter() - t0)
        return out

    def _save(self, *args, **kwargs):
        t0 = time.perf_counter()
        path = super()._save(*args, **kwargs)
        self.timings["save_block"].append(time.perf_counter() - t0)
        return path


class EvictingTrainer(TimedTrainer):
    """``TimedTrainer`` whose step cache keeps at most ``EVICTING_BOUND``
    entries (the update and one batch signature: with this corpus's two
    signatures in turn, every step evicts the other's graph) until
    iteration ``EVICTED_RELEASE``, then ``training.step.STEP_GRAPHS``; the
    training counters, the cache's replays and evictions read where its
    profile window opens and where it closes (``window``)."""

    def __init__(self, *args, **kwargs):
        from daft_exprt_tpu_torch.training import step as step_mod

        bound, step_mod.STEP_GRAPHS = step_mod.STEP_GRAPHS, EVICTING_BOUND
        try:
            super().__init__(*args, **kwargs)
        finally:
            step_mod.STEP_GRAPHS = bound
        self.release_bound = bound
        self.window = {}

    def _reading(self):
        g = self.train_step.graphs
        return {"counts": _train_counts(g), "replays": g.replays,
                "captures": g.captures, "evictions": g.evictions}

    def _profile_window(self, out_dir):
        if self.iteration == EVICTED_RELEASE:
            self.train_step.graphs.max_entries = self.release_bound
        opening = self.profile is None
        super()._profile_window(out_dir)
        if opening and self.profile is not None:
            self.window["open"] = {"iteration": self.iteration,
                                   **self._reading()}

    def _stop_profile(self, out_dir):
        self.window["close"] = {"iteration": self.iteration,
                                **self._reading()}
        super()._stop_profile(out_dir)


# the evicted window: the step cache's bound until EVICTED_RELEASE, the
# window's first iteration and length, the run's last iteration
EVICTING_BOUND = 2
EVICTED_RELEASE = 6
EVICTED_WINDOW = (8, 3)
EVICTED_ITERATIONS = 10


def evicted_profile_window(exps, corpus, start):
    """A ``Trainer`` profile window (``--profile``'s) of
    ``EVICTED_WINDOW[1]`` flagship steps, opened after the step cache
    evicted graphs (``EvictingTrainer``: every step until
    ``EVICTED_RELEASE`` evicts one), its steps replays: the trace the
    window wrote read back by ``aggregate_device_trace`` and
    ``graph_launch_census`` (every graph launch with its device
    operations), K2's and the conv-FF's launches on the device equal to
    the window's steps x 36 a direction, as the counters say (at the
    wrappers plus derived from the replays), and the device ms of the
    file against the profiler's own. :return: the readings"""
    from daft_exprt_tpu_torch.utils import (aggregate_device_trace,
                                            graph_launch_census)

    hp = write_experiment(exps, "evicted_window", corpus,
                          iters_check_for_model_improvement=100,
                          iters_per_checkpoint=100, checkpoint=str(start))
    first, steps = EVICTED_WINDOW
    t = EvictingTrainer(hp, profile_steps=steps, profile_start=first)
    t.train(max_iterations=EVICTED_ITERATIONS)
    opened, closed = t.window["open"], t.window["close"]
    trace_dir = Path(hp.output_directory) / "logs" / "profile"
    census = graph_launch_census(str(trace_dir), TRAIN_ON_DEVICE)
    _, ops_ms = aggregate_device_trace(str(trace_dir))
    report = kernel_report(t.profile, 1e3 * t.profile_wall_s, LOOP_GROUPS)
    counted = {k: closed["counts"][k] - opened["counts"][k]
               for k in TRAIN_COUNTERS}
    n = steps * fft_blocks(hp) * hp.accumulation_steps
    want = expected_launches("conv_ff_train", n, tensor_core=True)
    out = {"window": [opened["iteration"], closed["iteration"]],
           "evictions_before": opened["evictions"],
           "replays_in_window": closed["replays"] - opened["replays"],
           "captures_in_window": closed["captures"] - opened["captures"],
           "launches": counted,
           "on_device": train_on_device(t.profile),
           "census": {k: census[k] for k in (
               "graph_launches", "empty_launches", "complete", "counts")},
           "trace_ops_ms": ops_ms,
           "profiler_device_ms": report and report["device_busy_ms"]}
    print("training runtime: evicted profile window", json.dumps(out),
          flush=True)
    if not out["evictions_before"] or out["captures_in_window"] \
            or out["replays_in_window"] != 2 * steps \
            or counted != want or not census["complete"] \
            or out["on_device"] != {k: n for k in TRAIN_ON_DEVICE} \
            or census["counts"] != out["on_device"] or report is None \
            or not abs(ops_ms - report["device_busy_ms"]) \
            <= DP_TRACE_REL_TOL * report["device_busy_ms"]:
        raise AssertionError(f"the profile window after evictions: {out}, "
                             f"expected {n} launches a kernel and "
                             f"direction")
    return out


def _epochs(train_loader, epoch, start):
    """The planned steps through one ``train_loader.epoch`` call an
    epoch."""
    while True:
        yield from train_loader.epoch(epoch, start)
        epoch, start = epoch + 1, 0


def timed_loop(exps, corpus, start, name, loader="native",
               assembly="thread", profile=True):
    """``TIMED_ITERATIONS`` flagship iterations of ``Trainer.train`` from
    ``start``, the steps assembled by ``loader`` ("native": ``TrainLoader``;
    "grain": two worker processes) as ``assembly`` says (``TimedTrainer``),
    validation and saves at 5 and 10, one profiled iteration (8) if
    ``profile``: (readings, the trainer)."""
    hp = write_experiment(exps, name, corpus,
                          iters_check_for_model_improvement=5,
                          iters_per_checkpoint=5, data_loader=loader,
                          data_workers=2, checkpoint=str(start))
    t = TimedTrainer(hp, profile_steps=int(profile), profile_start=8,
                     assembly=assembly)
    t.train(max_iterations=TIMED_ITERATIONS)
    # iteration i's time is the i-th; not the first, the validating and
    # saving (5, 10), the profiled (8) or the one that writes the trace (9)
    quiet = [1e3 * x for i, x in enumerate(t.timings["iteration"], 1)
             if i not in (1, 5, 8, 9, 10)]
    prof = None
    if profile:
        prof = kernel_report(t.profile, 1e3 * t.profile_wall_s, LOOP_GROUPS)
        if prof is not None and not (
                0 < prof["k2_tensor_core_ms"] == prof["k2_ms"]
                and 0 < prof["k3_tensor_core_ms"] == prof["k3_ms"]):
            raise AssertionError(f"the loop's K2/K3 time is not all on the "
                                 f"tensor-core kernels: {prof}")
    return {
        "loader": loader, "assembly": assembly,
        "iteration_ms_median": float(np.median(quiet)),
        "quiet_iteration_ms": quiet,
        "iteration_ms": [1e3 * x for x in t.timings["iteration"]],
        "data_wait_ms_median": float(np.median(
            [1e3 * x for x in t.timings["data_wait"][1:]])),
        "data_wait_ms": [1e3 * x for x in t.timings["data_wait"]],
        "validation_ms": [1e3 * x for x in t.timings["validation"]],
        "save_block_ms": [1e3 * x for x in t.timings["save_block"]],
        "profile": prof}, t


def steps_alone(t, train_loader, gen):
    """The loop's first ``TIMED_ITERATIONS`` planned steps through
    ``t.train_step`` alone, assembled beforehand, host clock to a
    synchronize each, in turns: a numpy batch (the host-to-device copy in
    the step, as in the loop) and the same batch on the card already (as
    ``train`` times ``make_train_step``); then the card batches again
    while a thread assembles steps without pause (the prefetch thread's
    work); the assembly of each of those steps timed as it is made."""
    from daft_exprt_tpu_torch.training.step import to_device

    stream = train_loader.steps(0)
    batches, assemble_ms = [], []
    for _ in range(TIMED_ITERATIONS):
        t0 = time.perf_counter()
        batches.append(next(stream))
        assemble_ms.append(1e3 * (time.perf_counter() - t0))
    stream.close()
    on_card = [to_device(b, t.device) for b in batches]

    def step_ms(b, it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train_step(b, gen, it)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    for i, c in enumerate(on_card):  # every shape once
        step_ms(c, 100 + i)
    host, card = [], []
    for i, (b, c) in enumerate(zip(batches, on_card)):
        host.append(step_ms(b, 100 + i))
        card.append(step_ms(c, 100 + i))
    stop = threading.Event()
    plan = train_loader.plan_epoch(1)
    assembled = []

    def assemble():
        while not stop.is_set():
            train_loader.assemble(plan[len(assembled) % len(plan)])
            assembled.append(1)

    worker = threading.Thread(target=assemble, daemon=True)
    worker.start()
    try:
        contended = [step_ms(c, 100 + i) for i, c in enumerate(on_card)]
    finally:
        stop.set()
        worker.join()
    return {"padded_T": [int(b["mel_specs"].shape[-1]) for b in batches],
            "host_batch_ms": host, "card_batch_ms": card,
            "host_batch_ms_median": float(np.median(host)),
            "card_batch_ms_median": float(np.median(card)),
            "with_assembling_thread_ms": contended,
            "with_assembling_thread_ms_median": float(np.median(contended)),
            "assembled_meanwhile": len(assembled),
            "assemble_ms": assemble_ms,
            "assemble_ms_median": float(np.median(assemble_ms))}


# (loader, assembly) of --loop-timing: TrainLoader through the prefetch
# thread and on the loop's thread; two worker processes through the
# thread, on the loop's thread, and forked anew every epoch
LOOP_VARIANTS = [("native", "thread"), ("native", "inline"),
                 ("grain", "thread"), ("grain", "inline"),
                 ("grain", "thread_per_epoch")]


def loop_timing(smi):
    """``--loop-timing``: the flagship loop (``timed_loop``, unprofiled) on
    the training-runtime phase's corpus and start weights with each of
    ``LOOP_VARIANTS``, in two rounds of opposite order, then the last
    loop's steps alone (``steps_alone``); per variant, the median of both
    rounds' quiet iterations."""
    import shutil
    import tempfile

    from daft_exprt_tpu_torch.checkpoint import save_reference_checkpoint

    tmp = Path(tempfile.mkdtemp(prefix="loop_timing_"))
    try:
        corpus = write_corpus(tmp / "corpus", n_utts=64, symbols=(64, 128),
                              frames_per_symbol=(4, 8), n_val=8, seed=0)
        exps = tmp / "exps"
        start = tmp / "start.pt"
        hp = write_experiment(exps, "start", corpus)
        model = DaftExprt(hp, seed=0)
        pin_durations(model)
        save_reference_checkpoint(str(start), model, hp)
        del model
        loops = []
        for r, order in enumerate((LOOP_VARIANTS, LOOP_VARIANTS[::-1])):
            for loader, assembly in order:
                reading, t = timed_loop(exps, corpus, start,
                                        f"{loader}_{assembly}_{r}", loader,
                                        assembly, profile=False)
                reading.pop("profile")
                loops.append(reading)
                print("loop timing: loop", json.dumps(reading), flush=True)
        train_loader, _ = t.make_loaders()
        gen = torch.Generator(device=t.device).manual_seed(0)
        alone = steps_alone(t, train_loader, gen)
        summary = {}
        for loader, assembly in LOOP_VARIANTS:
            mine = [x for x in loops
                    if (x["loader"], x["assembly"]) == (loader, assembly)]
            quiet = [ms for x in mine for ms in x["quiet_iteration_ms"]]
            summary[f"{loader}_{assembly}"] = {
                "iteration_ms_median": float(np.median(quiet)),
                "by_round": [x["iteration_ms_median"] for x in mine],
                "data_wait_ms_median": float(np.median(
                    [x["data_wait_ms_median"] for x in mine]))}
        report = {"card": smi, "loops": summary, "steps_alone": alone}
        print("loop timing", json.dumps(report), flush=True)
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def training_runtime(smi, train_report, keep_fine_tuning_dataset=None):
    """The training-runtime phase at flagship width through the port's own
    ``cli.training`` and ``Trainer`` on a synthetic corpus written here
    (two speakers x 64 utterances, L 64-128 symbols, T 384-768 frames):
    train to 6 with validation, checkpoints and the benchmark hook at 3
    and 6 under an NCCL process group of one, launch counters around the
    run; the first step under NCCL against one without a group; resume
    from 3 against the uninterrupted 6; SIGTERM to the CLI as its own
    process; the loop timed and profiled with the default loader, beside
    ``train_report`` (``train``'s reading of ``make_train_step`` alone),
    with the launch counters around one step and one validation pass; the
    learning check; ``cli.synthesize`` and ``cli.training fine_tune`` on
    the trained checkpoint, whose dataset is moved to
    ``keep_fine_tuning_dataset`` when given."""
    import shutil
    import tempfile

    from daft_exprt_tpu_torch.checkpoint import save_reference_checkpoint
    from daft_exprt_tpu_torch.inference import benchmark
    from daft_exprt_tpu_torch.training import step as step_mod
    from daft_exprt_tpu_torch.training.checkpoint import load_checkpoint

    tmp = Path(tempfile.mkdtemp(prefix="training_runtime_"))
    home = os.environ.get("HOME")
    tensorboard = sys.modules.get("tensorboardX", False)
    all_reduces = []
    all_reduce_mean = step_mod.all_reduce_mean

    def counted_all_reduce(tensors):
        all_reduces.append(len(tensors))
        return all_reduce_mean(tensors)

    hook_s, hook_graphs = [], []
    make_benchmark_hook = benchmark.make_benchmark_hook

    def timed_benchmark_hook(*args, **kwargs):
        hook = make_benchmark_hook(*args, **kwargs)

        def timed(*hook_args):
            t0 = time.perf_counter()
            hook(*hook_args)
            hook_s.append(time.perf_counter() - t0)
            # update_params drops the engine's graphs: each call captures
            # its passes anew (the engine's totals so far)
            engine = hook._state.get("engine")
            hook_graphs.append(engine and graph_report(engine))
        return timed

    report = {"card": smi}
    try:
        # the benchmark hook phonemizes plain text with a dictionary found
        # under $HOME; scalars go to logs/scalars.jsonl (JSON lines), read
        # back below
        os.environ["HOME"] = str(tmp / "home")
        report["dictionary_words"] = benchmark_dictionary(
            tmp / "home" / "Documents" / "MFA" / "pretrained_models"
            / "dictionary" / "english.dict")
        sys.modules["tensorboardX"] = None
        step_mod.all_reduce_mean = counted_all_reduce
        benchmark.make_benchmark_hook = timed_benchmark_hook
        t0 = time.perf_counter()
        corpus = write_corpus(tmp / "corpus", n_utts=64, symbols=(64, 128),
                              frames_per_symbol=(4, 8), n_val=8, seed=0)
        report["corpus_s"] = time.perf_counter() - t0
        exps = tmp / "exps"
        flagship = dict(iters_per_checkpoint=RUNTIME_EVERY,
                        iters_check_for_model_improvement=RUNTIME_EVERY)
        hp = write_experiment(exps, "flagship", corpus, **flagship)
        # seed-0 weights with the duration head pinned (0.12 s a phone), so
        # the hook's and the CLI's mels are not empty: the runs resume
        # from it (iteration 0, no optimizer state)
        start = tmp / "start.pt"
        model = DaftExprt(hp, seed=0)
        pin_durations(model)
        save_reference_checkpoint(str(start), model, hp)
        del model
        base = ["train", "--experiments_dir", str(exps), "--checkpoint",
                str(start)]

        # 1. the first steps under NCCL (world of one: the step's two
        # graphs around the all-reduce) and without a group (the same two
        # graphs, no collective): both batch signatures of an epoch
        # captured, then a replay
        first = {}
        for name, group in (("first_nccl", True), ("first_plain", False)):
            write_experiment(exps, name, corpus, **flagship)
            argv = base + ["--experiment_name", name, "--max_iterations",
                           str(FIRST_STEPS), "--no_benchmark_synthesis"]
            if group:
                argv += ["--coordinator", f"localhost:{_free_port()}",
                         "--num_processes", "1", "--process_id", "0"]
            del all_reduces[:]
            run_training_cli(argv)
            first[name] = (load_checkpoint(str(
                exps / name / "checkpoints" / "DaftExprt_last.pt"))[0],
                len(all_reduces))
        first_err = _max_abs_diff(first["first_nccl"][0],
                                  first["first_plain"][0])
        report["first_steps"] = {
            "iterations": FIRST_STEPS,
            "max_abs_diff": first_err, "limit": FIRST_STEP_TOL,
            "bit_equal": first_err == 0.0,
            "all_reduces": {k: v[1] for k, v in first.items()}}
        print("training runtime: first steps", json.dumps(
            report["first_steps"]), flush=True)
        if first_err > FIRST_STEP_TOL \
                or first["first_nccl"][1] != FIRST_STEPS \
                or first["first_plain"][1] != 0:
            raise AssertionError(f"first steps NCCL vs no group: "
                                 f"{report['first_steps']}")

        # 2. the main path: the CLI to 6 under NCCL, counters around it
        _zero_counts()
        del all_reduces[:]
        tr, seconds = run_training_cli(base + [
            "--experiment_name", "flagship", "--max_iterations",
            str(RUNTIME_ITERATIONS), "--coordinator",
            f"localhost:{_free_port()}", "--num_processes", "1",
            "--process_id", "0"])
        launches = _train_counts(tr.train_step.graphs, tr.eval_step.graphs)
        ckpt_dir = exps / "flagship" / "checkpoints"
        files = sorted(p.name for p in ckpt_dir.iterdir())
        steps = RUNTIME_ITERATIONS * fft_blocks(hp) * hp.accumulation_steps
        want = expected_launches("conv_ff_train", steps, tensor_core=True)
        main = {"seconds": seconds, "iterations": tr.iteration,
                "all_reduces": len(all_reduces), "files": files,
                "launches": launches, "hook_s": hook_s,
                "hook_graphs": hook_graphs}
        hooks = {}
        for it in range(RUNTIME_EVERY, RUNTIME_ITERATIONS + 1, RUNTIME_EVERY):
            out = exps / "flagship" / "benchmark" / f"iter_{it}"
            names = sorted(p.name for p in out.iterdir()) \
                if out.is_dir() else []
            hooks[it] = {"mels": [n for n in names if n.endswith(".npz")
                                  and not n.startswith("ref_")],
                         "wavs": [n for n in names if n.endswith(".wav")]}
        main["hook_outputs"] = {it: {k: len(v) for k, v in h.items()}
                                for it, h in hooks.items()}
        print("training runtime: main", json.dumps(main), flush=True)
        n_sentences = len((ROOT / "scripts" / "benchmarks" / "english"
                           / "sentences.txt").read_text().splitlines())
        for it, h in hooks.items():
            if len(h["mels"]) != n_sentences or len(h["wavs"]) != n_sentences:
                raise AssertionError(f"benchmark hook at {it}: {h}")
            for name in h["wavs"]:
                with np.load(exps / "flagship" / "benchmark" / f"iter_{it}"
                             / name.replace(".wav", ".npz")) as z:
                    mel = z["mel_spec"]
                if mel.shape[0] != 80 or mel.shape[1] < 4 \
                        or not np.isfinite(mel).all():
                    raise AssertionError(f"hook mel {name}: {mel.shape}")
        if tr.iteration != RUNTIME_ITERATIONS \
                or len(all_reduces) != RUNTIME_ITERATIONS \
                or not {"DaftExprt_3.pt", "DaftExprt_6.pt", "DaftExprt_best.pt",
                        "DaftExprt_last.pt"} <= set(files):
            raise AssertionError(f"training CLI run: {main}")
        check_launches(
            "the training CLI run",
            all(launches[k] == v for k, v in want.items())
            and 0 < launches["k1"] == launches["k1_tensor_core"],
            f"{launches}, expected {want} and K1 > 0, all tensor-core")
        report["main"] = main
        step_mod.all_reduce_mean = all_reduce_mean

        # 3. resume from 3 to 10 (logs at 10), against the uninterrupted 6
        uninterrupted = load_checkpoint(str(ckpt_dir / "DaftExprt_6.pt"))
        (exps / "flagship" / "logs" / "scalars.jsonl").unlink()
        resumed_tr, seconds = run_training_cli([
            "train", "--experiments_dir", str(exps), "--experiment_name",
            "flagship", "--checkpoint", str(ckpt_dir / "DaftExprt_3.pt"),
            "--max_iterations", str(PREEMPT_AFTER),
            "--no_benchmark_synthesis"])
        resumed = load_checkpoint(str(ckpt_dir / "DaftExprt_6.pt"))
        rows = [json.loads(x) for x in (exps / "flagship" / "logs"
                                        / "scalars.jsonl").open()]
        lr_rows = [r for r in rows
                   if r["tag"] == "DaftExprt.optimization/learning_rate"]
        moments = {k: _rel_l2_dict(resumed[1][k], uninterrupted[1][k])
                   for k in ("mu", "nu")}
        resume = {"seconds": seconds,
                  "param_max_abs_diff": _max_abs_diff(resumed[0],
                                                      uninterrupted[0]),
                  "param_limit": RESUME_PARAM_TOL,
                  "moment_rel_l2": moments,
                  "moment_limit": RESUME_MOMENT_REL_TOL,
                  "counts": [resumed[1]["count"], uninterrupted[1]["count"]],
                  "first_logged": lr_rows[0] if lr_rows else None,
                  "schedule": float(resumed_tr.schedule(PREEMPT_AFTER))}
        resume["bit_equal"] = resume["param_max_abs_diff"] == 0.0
        print("training runtime: resume", json.dumps(resume), flush=True)
        if resume["param_max_abs_diff"] > RESUME_PARAM_TOL \
                or max(moments.values()) > RESUME_MOMENT_REL_TOL \
                or resume["counts"] != [6, 6] or not lr_rows \
                or lr_rows[0]["step"] != PREEMPT_AFTER \
                or abs(lr_rows[0]["value"] - resume["schedule"]) \
                > 1e-6 * resume["schedule"] \
                or resumed_tr.optimizer.count != PREEMPT_AFTER:
            raise AssertionError(f"resume: {resume}")
        report["resume"] = resume

        # 4. SIGTERM to the CLI as its own process
        write_experiment(exps, "preempt", corpus,
                         iters_check_for_model_improvement=1000,
                         iters_per_checkpoint=1000)
        code, reached, seconds = preempt_process(exps, "preempt",
                                                 tmp / "home")
        last = load_checkpoint(str(exps / "preempt" / "checkpoints"
                                   / "DaftExprt_last.pt"))[2]
        report["preempt"] = {"exit_code": code, "stopped_at": reached,
                             "last_iteration": last["iteration"],
                             "seconds": seconds}
        print("training runtime: preempt", json.dumps(report["preempt"]),
              flush=True)
        if code != 0 or reached < PREEMPT_AFTER \
                or last["iteration"] != reached:
            raise AssertionError(f"preemption: {report['preempt']}")

        # 5. the timed loop with the default loader, then the counters
        # around one step and one validation pass
        timed, t = timed_loop(exps, corpus, start, "timed")
        train_loader, val_loader = t.make_loaders()
        gen = torch.Generator(device=t.device).manual_seed(0)
        batch = next(train_loader.epoch(0))
        caches = (t.train_step.graphs, t.eval_step.graphs)
        t.train_step(batch, gen, TIMED_ITERATIONS + 1)  # its graph, if new
        torch.cuda.synchronize()
        before = _train_counts(*caches)
        step_prof, step_wall = profiled(
            lambda: t.train_step(batch, gen, TIMED_ITERATIONS + 2))
        per_step = _counts_since(before, *caches)
        step_device = train_on_device(step_prof)
        n_val_batches = sum(1 for _ in val_loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.validate(val_loader)  # every signature captured in the loop
        validation_ms = (time.perf_counter() - t0) * 1e3
        before = _train_counts(*caches)
        captures = t.eval_step.graphs.captures
        val_prof, val_wall = profiled(lambda: t.validate(val_loader))
        per_validation = _counts_since(before, *caches)
        val_report = kernel_report(val_prof, val_wall, K1_GROUPS)
        val = t.validate(val_loader)
        one_step = expected_launches("conv_ff_train",
                                     fft_blocks(hp) * hp.accumulation_steps,
                                     tensor_core=True)
        timed.update(validation_batches=n_val_batches,
                     validation_ms=validation_ms,
                     validation_ms_per_batch=validation_ms / n_val_batches,
                     launches_per_step=per_step,
                     launches_per_step_on_device=step_device,
                     launches_per_validation=per_validation,
                     validation_profile=val_report,
                     eval_graphs=graph_report(t.eval_step),
                     train_graphs=graph_report(t.train_step),
                     val_mel_l1=val["mel_spec_l1_loss"],
                     make_train_step={k: train_report.get(k) for k in (
                         "step_ms", "eager_step_ms", "profile")})
        print("training runtime: timed loop", json.dumps(timed), flush=True)
        k1_want = fft_blocks(hp) * n_val_batches
        n = fft_blocks(hp) * hp.accumulation_steps
        check_launches(
            "one replayed step and one replayed validation pass",
            all(per_step[k] == v for k, v in one_step.items())
            and per_step["k1"] == 0
            and step_device == {k: n for k in TRAIN_ON_DEVICE}
            and not any(per_validation[k] for k in TRAIN_COUNTERS)
            and per_validation["k1"] == k1_want
            == per_validation["k1_tensor_core"]
            and t.eval_step.graphs.captures == captures
            and (val_report is None
                 or val_report["on_device"]["k1"] == k1_want
                 == val_report["on_device"]["k1_tensor_core"]),
            f"per step {per_step} (expected {one_step}), on the device "
            f"{step_device}; per validation {per_validation} (expected K1 "
            f"{k1_want}, all tensor-core), on the device "
            f"{val_report and val_report['on_device']}")
        report["timed"] = timed
        del t, train_loader, val_loader, batch

        # 5b. a profile window opened after the step cache evicted graphs
        report["evicted_window"] = evicted_profile_window(exps, corpus,
                                                          start)

        # 6. the learning check (forked worker processes assemble its steps)
        soak_hp = write_experiment(exps, "soak", corpus, data_loader="grain",
                                   data_workers=2, **soak_overrides())
        losses = {}

        class Probe(TimedTrainer):
            def validate(self, val_loader):
                out = super().validate(val_loader)
                losses[self.iteration] = out["mel_spec_l1_loss"]
                return out

        soak = Probe(soak_hp, log_every=SOAK_ITERATIONS // 4,
                     profile_steps=1, profile_start=SOAK_ITERATIONS // 2 + 1)
        soak.validate(soak.make_loaders()[1])  # the untrained baseline
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        soak.train(max_iterations=SOAK_ITERATIONS)
        torch.cuda.synchronize()
        learning = {"iterations": SOAK_ITERATIONS,
                    "seconds": time.perf_counter() - t0,
                    "val_mel_l1": losses,
                    "ratio": losses[SOAK_ITERATIONS] / losses[0],
                    "iteration_ms_median": 1e3 * float(np.median(
                        soak.timings["iteration"])),
                    "data_wait_ms_median": 1e3 * float(np.median(
                        soak.timings["data_wait"])),
                    "data_wait_ms_max": 1e3 * max(soak.timings["data_wait"]),
                    "profile": kernel_report(soak.profile,
                                             1e3 * soak.profile_wall_s,
                                             LOOP_GROUPS)}
        print("training runtime: learning", json.dumps(learning), flush=True)
        if not learning["ratio"] <= LEARNING_RATIO:
            raise AssertionError(f"the validation mel L1 did not halve: "
                                 f"{learning}")
        report["learning"] = learning
        del soak

        # 7. the trained flagship checkpoint served by cli.synthesize, and
        # the fine-tuning dataset written by cli.training fine_tune
        best = ckpt_dir / "DaftExprt_best.pt"
        bank = tmp / "bank"
        bank.mkdir()
        for src in sorted(STYLE_BANK.glob("*.wav")):
            (bank / src.name).write_bytes(src.read_bytes())
        lines = tmp / "braces.txt"
        lines.write_text("\n".join(TTS_BRACES) + "\n")
        out = tmp / "synth"
        seconds, syn_launches = run_cli([
            "--checkpoint", str(best), "--text_file", str(lines),
            "--style_bank", str(bank), "--output_dir", str(out)])
        frames = check_cli_outputs(out, bank, TTS_BRACES, HOP, vocoder=False)
        report["synthesize"] = {"seconds": seconds, "frames": frames,
                                "launches": syn_launches}
        _zero_counts()
        captured = (fused_fft_block.captured, fused_fft_block.tc_captured)
        n, seconds = run_training_cli([
            "fine_tune", "--experiments_dir", str(exps), "--experiment_name",
            "flagship", "--data_set_dir", corpus["dataset_dir"]])
        ft_launches = _train_counts()
        ft_launches.update(
            k1_captured=fused_fft_block.captured - captured[0],
            k1_tensor_core_captured=fused_fft_block.tc_captured - captured[1])
        report["fine_tune"] = check_fine_tuning_dataset(
            exps / "flagship" / "fine_tuning_dataset", corpus, n, hp)
        report["fine_tune"].update(seconds=seconds, launches={
            k: ft_launches[k] for k in ("k1", "k1_tensor_core", "k1_captured",
                                        "k1_tensor_core_captured")})
        n_batches = -(-n // hp.batch_size)
        print("training runtime: synthesize and fine_tune", json.dumps(
            {k: report[k] for k in ("synthesize", "fine_tune")}), flush=True)
        # a batch signature's first batch runs eagerly and is captured,
        # the others of its signature replay (no launch at the wrappers)
        blocks = fft_blocks(hp)
        check_launches(
            "fine_tune",
            0 < ft_launches["k1"] <= blocks * n_batches
            and ft_launches["k1"] % blocks == 0
            and ft_launches["k1"] == ft_launches["k1_tensor_core"]
            == ft_launches["k1_captured"]
            == ft_launches["k1_tensor_core_captured"],
            f"{ft_launches}, expected K1 {blocks} a batch signature eager "
            f"and as many captured (of {n_batches} batches), all "
            "tensor-core")
        report["fine_tune_replay"] = fine_tune_replay(
            hp, corpus["dataset_dir"], tmp / "fine_tune_replay")
        if keep_fine_tuning_dataset is not None:
            shutil.move(str(exps / "flagship" / "fine_tuning_dataset"),
                        str(keep_fine_tuning_dataset))
        print("training runtime", json.dumps(report), flush=True)
        return report
    finally:
        step_mod.all_reduce_mean = all_reduce_mean
        benchmark.make_benchmark_hook = make_benchmark_hook
        if tensorboard is False:
            sys.modules.pop("tensorboardX", None)
        else:
            sys.modules["tensorboardX"] = tensorboard
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
        shutil.rmtree(tmp, ignore_errors=True)


def fine_tune_replay(hp, dataset_dir, tmp):
    """``fine_tuning_dataset``'s forward through a graph cache: the whole
    dataset once to capture each batch signature, once more with every
    batch a replay (profiled: K1 counted on the device), and once with the
    cache's entries run eagerly on the card; the replayed run's ``.npy``
    files bit-equal to the eager run's. Then a user's pass (a new cache:
    each signature's first batch eager and captured) and the eager pass
    again, timed in turns with the first two. Seed-0 flagship weights with
    the duration head pinned."""
    from daft_exprt_tpu_torch.inference.fine_tune import fine_tuning_dataset
    from daft_exprt_tpu_torch.inference.graphs import GraphCache

    model = DaftExprt(hp, seed=0)
    pin_durations(model)
    graphs, eager = GraphCache("cuda"), GraphCache("cuda")
    eager.cuda = False  # its entries run eagerly on the card

    def timed(cache, out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fine_tuning_dataset(model, hp, dataset_dir, str(out), graphs=cache)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    first_pass_s = [timed(graphs, tmp / "capture")]
    before = (graphs.captures, graphs.replays, _counts(
        types.SimpleNamespace(graphs=graphs)))
    t0 = time.perf_counter()
    prof, wall_ms = profiled(lambda: fine_tuning_dataset(
        model, hp, dataset_dir, str(tmp / "replayed"), graphs=graphs))
    replayed_s = time.perf_counter() - t0
    launches = _launches(before[2], types.SimpleNamespace(graphs=graphs))
    eager_s = [timed(eager, tmp / "eager")]
    first_pass_s.append(timed(GraphCache("cuda"), tmp / "first_pass"))
    eager_s.append(timed(eager, tmp / "eager_again"))
    files = sorted(p.relative_to(tmp / "eager")
                   for p in (tmp / "eager").glob("*/*.npy"))
    n = len(files)  # one .npy an utterance written
    differ = [str(f) for f in files if not np.array_equal(
        np.load(tmp / "replayed" / f), np.load(tmp / "eager" / f))]
    batches = graphs.replays - before[1]
    report = kernel_report(prof, wall_ms, {})
    out = {"utterances": n, "files": len(files), "differ": differ,
           "signatures": len(graphs), "captures": graphs.captures,
           "capture_seconds": graphs.capture_seconds,
           "pool_bytes": graphs.pool_bytes(), "replayed_batches": batches,
           "new_captures": graphs.captures - before[0],
           "launches_at_wrappers": launches["k1"],
           "launches_replayed_derived": launches["k1_replayed"],
           "on_device": report and report["on_device"],
           "replayed_s": replayed_s, "eager_s": eager_s,
           "first_pass_s": first_pass_s}
    print("training runtime: fine-tuning forward replayed",
          json.dumps(out), flush=True)
    if differ or not files or out["new_captures"] or launches["k1"]:
        raise AssertionError(f"fine-tuning forward replays: {out}")
    check_launches("fine-tuning forward replays",
                   launches["k1_replayed"] == fft_blocks(hp) * batches > 0,
                   out)
    check_on_device(report, {"k1": fft_blocks(hp) * batches},
                    "fine-tuning forward replays")
    return out


def check_fine_tuning_dataset(out, corpus, n, hp):
    """One ``.npy`` + ``.wav`` pair per kept training utterance: the mel
    the ground truth's shape, the wav the aligned span of the tone."""
    from daft_exprt_tpu_torch.data.stats import read_training_lines
    from scipy.io import wavfile

    train = read_training_lines(corpus["train"])
    if n != len(train):
        raise AssertionError(f"fine_tune wrote {n} of {len(train)}")
    for features_dir, name, _ in train:
        spk = Path(features_dir).name
        mel = np.load(out / spk / f"{name}.npy")
        want = np.load(Path(features_dir) / f"{name}.npy").shape
        rate, wav = wavfile.read(str(out / spk / f"{name}.wav"))
        rows = (Path(corpus["dataset_dir"]) / spk / "align"
                / f"{name}.markers").read_text().splitlines()
        begin, end = float(rows[0].split("\t")[0]), \
            float(rows[-1].split("\t")[1])
        samples = int(end * rate) - int(begin * rate)
        if mel.shape != want or not np.isfinite(mel).all() \
                or rate != hp.sampling_rate or wav.shape != (samples,):
            raise AssertionError(f"fine_tune {name}: mel {mel.shape} "
                                 f"(want {want}), wav {wav.shape} at {rate} "
                                 f"(want {samples})")
    return {"utterances": n, "pairs_checked": len(train)}


# ----------------------------------------------------------------------
# Preprocessing: a raw corpus (wavs, transcripts, MFA-style TextGrids)
# through cli.training pre_process on the card, then training from it
# ----------------------------------------------------------------------
PRE_UTTS = 32              # utterances a speaker
PRE_SECONDS = (2.0, 10.0)  # LJSpeech's range of utterance lengths
PRE_PHONE_S = (0.06, 0.20)
PRE_REJECTED = "spk_b_0005"  # carries an <unk> word: MFA-rejected
PRE_WORDS = {
    "hello": "HH AH0 L OW1", "world": "W ER1 L D", "sweet": "S W IY1 T",
    "good": "G UH1 D", "morning": "M AO1 R N IH0 NG", "this": "DH IH1 S",
    "is": "IH1 Z", "a": "AH0", "test": "T EH1 S T",
    "speech": "S P IY1 CH", "voice": "V OY1 S", "data": "D EY1 T AH0",
    "time": "T AY1 M", "people": "P IY1 P AH0 L", "water": "W AO1 T ER0",
    "thank": "TH AE1 NG K", "you": "Y UW1", "she": "SH IY1"}
PRE_UNVOICED = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}
PRE_BASE_HZ = {"spk_a": 120.0, "spk_b": 210.0}
# bench.py's device-preprocessing shape: B=32 rows of 512 hops (5.9 s)
PRE_BENCH_B, PRE_BENCH_HOPS = 32, 512
PRE_TRAIN_ITERATIONS = 2
# Device F0 (float32 NCCF) against the host tracker's (float64), and the
# card's F0 against the CPU's: where the pitch sweeps across a half-integer
# lag, two adjacent lags' NCCF lie within float32 rounding of each other
# and either tracker may take the neighbouring lag (the JAX package's
# device tracker flips the same frames: on a 6-utterance CPU rehearsal of
# this corpus 2 of 2,046 mel frames, one lag apart, and the port's device
# F0 equals the JAX package's byte for byte). So: voicing equal on every
# frame, at least this share of frames equal, and every other frame
# within one lag of the other tracker's.
F0_EQUAL_SHARE_MIN = 0.995
# Batched against per-file log-mel on the card (``batched_mel_check``):
# equal on the CPU, but on the card the batched and the per-file STFT run
# cuFFT plans of other batch counts and mel GEMMs of other shapes, whose
# rounding the log magnifies near the mel's floor. Loud bins (linear mel
# >= LOUD_MEL) are held to this flat limit, which lies between the sound
# reading and those of three planted faults (PERF.md §6); quiet ones to
# QUIET_MEL_ABS_TOL on the linear mel.
LOUD_LOG_MEL_ABS_TOL = 1e-3


def _textgrid(tiers, xmax):
    """Long-format TextGrid text of [(name, [(xmin, xmax, text)])]."""
    out = ['File type = "ooTextFile"\nObject class = "TextGrid"\n\n'
           f"xmin = 0\nxmax = {xmax}\ntiers? <exists>\nsize = {len(tiers)}\n"
           "item []:\n"]
    for k, (name, rows) in enumerate(tiers, 1):
        out.append(f'    item [{k}]:\n        class = "IntervalTier"\n'
                   f'        name = "{name}"\n        xmin = 0\n'
                   f"        xmax = {xmax}\n"
                   f"        intervals: size = {len(rows)}\n")
        for i, (a, b, s) in enumerate(rows, 1):
            out.append(f"        intervals [{i}]:\n"
                       f"            xmin = {a}\n            xmax = {b}\n"
                       f'            text = "{s}"\n')
    return "".join(out)


def write_raw_corpus(root, n_utts=PRE_UTTS, seconds=PRE_SECONDS, seed=0,
                     rate=22050):
    """A two-speaker corpus as ``format_dataset`` leaves one and MFA aligns
    it, made with numpy from ``seed``: ``<spk>/wavs/*.wav``,
    ``<spk>/metadata.csv`` and ``<spk>/align/*.{TextGrid,lab}``. Each
    utterance is ``seconds`` long (uniform), words of ``PRE_WORDS`` with
    phones of ``PRE_PHONE_S``, leading and trailing silence, some pauses
    (with a comma in the text) between words; voiced phones are harmonic
    tones around the speaker's pitch, unvoiced ones noise. One utterance
    (``PRE_REJECTED``) holds an ``<unk>`` word, which marker extraction
    rejects. Returns the seconds of audio written."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    from daft_exprt_tpu_torch.audio.io import save_wav

    words = sorted(PRE_WORDS)
    total = 0.0
    for spk in CORPUS_SPEAKERS:
        wavs, align = root / spk / "wavs", root / spk / "align"
        wavs.mkdir(parents=True)
        align.mkdir(parents=True)
        meta = []
        for u in range(n_utts):
            name = f"{spk}_{u:04d}"
            target = rng.uniform(*seconds)
            t = lead = round(rng.uniform(0.15, 0.4), 3)
            word_rows, phone_rows = [(0.0, t, "")], [(0.0, t, "sil")]
            text = []
            while True:
                w = words[int(rng.integers(len(words)))]
                phones = PRE_WORDS[w].split()
                durs = np.round(rng.uniform(*PRE_PHONE_S, len(phones)), 3)
                # at least 1.2 s of speech: pre_process drops files under
                # minimum_wav_duration (1 s) after the silences are trimmed
                if text and t + durs.sum() + 0.4 > target \
                        and t - lead >= 1.2:
                    break
                if name == PRE_REJECTED and len(text) == 1:
                    w, phones, durs = "<unk>", ["spn"], [round(durs.sum(), 3)]
                start = t
                for p, d in zip(phones, durs):
                    phone_rows.append((t, round(t + d, 3), p))
                    t = round(t + d, 3)
                word_rows.append((start, t, w))
                text.append(w if w != "<unk>" else "blorp")
                if rng.random() < 0.15:  # a pause, written as a comma
                    d = round(rng.uniform(0.1, 0.3), 3)
                    word_rows.append((t, round(t + d, 3), ""))
                    phone_rows.append((t, round(t + d, 3), "sp"))
                    t = round(t + d, 3)
                    text[-1] += ","
            if word_rows[-1][2] == "":  # no pause right before the end
                word_rows.pop()
                phone_rows.pop()
                t = word_rows[-1][1]
                text[-1] = text[-1].rstrip(",")
            end = round(t + rng.uniform(0.15, 0.4), 3)
            word_rows.append((t, end, ""))
            phone_rows.append((t, end, ""))
            sentence = " ".join(text) + "."
            (align / f"{name}.TextGrid").write_text(_textgrid(
                [("words", word_rows), ("phones", phone_rows)], end))
            (align / f"{name}.lab").write_text(sentence)
            meta.append(f"{name}|{sentence}\n")
            # audio: one harmonic oscillator across the voiced phones
            n = int(end * rate)
            wav = 1e-3 * rng.standard_normal(n)
            phase = 0.0
            drift = rng.uniform(0, 2 * np.pi)
            for a, b, p in phone_rows:
                i0, i1 = int(a * rate), int(b * rate)
                if p in ("", "sil", "sp"):
                    continue
                if p.rstrip("012") in PRE_UNVOICED or p == "spn":
                    wav[i0:i1] += 0.05 * rng.standard_normal(i1 - i0)
                    continue
                tt = np.arange(i0, i1) / rate
                hz = PRE_BASE_HZ[spk] * (1 + 0.1 * np.sin(
                    2 * np.pi * 0.7 * tt + drift))
                ph = phase + 2 * np.pi * np.cumsum(hz) / rate
                phase = float(ph[-1])
                ramp = np.minimum(1.0, np.minimum(
                    np.arange(i1 - i0), np.arange(i1 - i0)[::-1]) / 64)
                wav[i0:i1] += ramp * (0.4 * np.sin(ph) + 0.2 * np.sin(2 * ph)
                                      + 0.1 * np.sin(3 * ph))
            save_wav(str(wavs / f"{name}.wav"), wav.astype(np.float32), rate)
            total += n / rate
        (root / spk / "metadata.csv").write_text("".join(meta))
    return total


def pre_process_argv(dataset, features, exps, name, device_pitch, device):
    argv = ["pre_process", "--experiments_dir", str(exps),
            "--experiment_name", name, "--data_set_dir", str(dataset),
            "--features_dir", str(features), "--nb_jobs",
            str(min(8, os.cpu_count() or 1))]
    if device_pitch:
        argv.append("--device_pitch")
    if device != "cuda":
        argv += ["--device", device]
    return argv


def run_pre_process(argv, process=False, home=None):
    """``cli.training pre_process`` in this process or, as a user runs it,
    in a process of its own; wall seconds."""
    from daft_exprt_tpu_torch.cli import training

    t0 = time.perf_counter()
    if process:
        env = dict(os.environ, HOME=str(home))
        run = subprocess.run(
            [sys.executable, "-m", "daft_exprt_tpu_torch.cli.training",
             *argv], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"pre_process process exited "
                                 f"{run.returncode}: {run.stderr[-3000:]}")
    else:
        training.main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def check_preprocessed(dataset, features, exps, device):
    """Hold the three ``pre_process`` runs (features dirs ``dev``,
    ``host``, ``dev2``; experiments of the same names) against each other
    and the repo's invariants; returns the agreement report."""
    report = {}
    names = {}
    for run in ("dev", "host", "dev2"):
        names[run] = sorted(
            p.name[:-len(".npy")] for spk in CORPUS_SPEAKERS
            for p in (features[run] / spk).glob("*.npy"))
    n_wavs = sum(1 for spk in CORPUS_SPEAKERS
                 for _ in (dataset / spk / "wavs").glob("*.wav"))
    report["utterances"] = {"wavs": n_wavs,
                            "features": len(names["dev"])}
    if not names["dev"] == names["host"] == names["dev2"] \
            or PRE_REJECTED in names["dev"] \
            or len(names["dev"]) != n_wavs - 1 \
            or (dataset / PRE_REJECTED.rsplit("_", 1)[0] / "align"
                / f"{PRE_REJECTED}.markers").exists():
        raise AssertionError(f"pre_process outputs: {report}, "
                             f"{ {k: len(v) for k, v in names.items()} }")

    def text(run, name, ext):
        spk = name.rsplit("_", 1)[0]
        return (features[run] / spk / f"{name}{ext}").read_text()

    for run in ("host", "dev2"):
        for name in names["dev"]:
            if text(run, name, ".markers") != text("dev", name, ".markers"):
                raise AssertionError(f"{run} {name}.markers differ")
    # device F0 (float32 NCCF) against the host tracker's (float64), to
    # F0_EQUAL_SHARE_MIN's bound
    dev, host = [], []
    for name in names["dev"]:
        dev.append(_floats(text("dev", name, ".frames_f0")))
        host.append(_floats(text("host", name, ".frames_f0")))
        if text("dev2", name, ".frames_f0") != text("dev", name,
                                                    ".frames_f0"):
            raise AssertionError(f"{name}: two device-pitch runs differ")
    hp = HyperParams.load(str(exps / "dev" / "config.json"))
    report["f0_device_vs_host"] = f0_agreement(
        np.concatenate(dev), np.concatenate(host), hp, log_f0=True)
    report["f0_device_vs_host"]["files_equal"] = sum(
        np.array_equal(a, b) for a, b in zip(dev, host))
    report["batched_vs_per_file_mel"] = batched_mel_check(
        dataset, features["dev"], names["dev"][::8], hp, device)
    # stats and config
    stats = json.loads((exps / "dev" / "stats.json").read_text())
    values = [v for k, s in stats.items() if k.startswith("spk ")
              for part in s.values() for v in part.values()] \
        + [v for s in stats["symbols"].values() for v in s.values()]
    report["stats"] = {"speakers": sorted(k for k in stats if k != "symbols"),
                       "symbols": len(stats["symbols"]),
                       "finite": bool(np.isfinite(values).all())}
    report["config"] = {"speakers": hp.speakers, "stats": hp.stats == stats}
    if report["stats"]["speakers"] != ["spk 0", "spk 1"] \
            or not report["stats"]["finite"] or not report["config"]["stats"] \
            or hp.speakers != list(CORPUS_SPEAKERS) \
            or not report["f0_device_vs_host"]["within_bound"]:
        raise AssertionError(f"pre_process results: {json.dumps(report)}")
    return report


def _mel_errs(got, ref):
    """Batched against per-file log-mel (n_mels, T): the largest log error
    over loud bins (linear mel >= LOUD_MEL) and the largest linear error
    over quiet ones."""
    err = np.abs(got.astype(np.float64) - ref)
    quiet = np.exp(ref) < LOUD_MEL
    lin = np.abs(np.exp(got.astype(np.float64)) - np.exp(ref))
    return (float(err[~quiet].max(initial=0.0)),
            float(lin[quiet].max(initial=0.0)))


def batched_mel_check(dataset, features_dir, names, hp, device):
    """``pre_process``'s batched log-mel of ``names`` (read from
    ``features_dir``) against ``extract_features_for_file``'s per-file one
    on ``device``: loud bins to LOUD_LOG_MEL_ABS_TOL, quiet bins to
    QUIET_MEL_ABS_TOL on the linear mel. Three planted faults must break
    the loud bound: the same files batched afresh with the reflect tail
    left at zero (``tail_at_zero``) or one sample off
    (``tail_one_sample_off``), and the crop one frame late
    (``crop_one_late``)."""
    import logging
    import tempfile
    from daft_exprt_tpu_torch.data import features as feats
    from daft_exprt_tpu_torch.ops.mel import mel_and_energy_batch, mel_kwargs

    out = {"files": len(names), "loud_log_mel_abs_tol": LOUD_LOG_MEL_ABS_TOL,
           "quiet_mel_abs_tol": QUIET_MEL_ABS_TOL}
    reads = {"sound": [], "tail_at_zero": [], "tail_one_sample_off": [],
             "crop_one_late": []}
    wavs, refs = [], []
    with tempfile.TemporaryDirectory() as single:
        for name in names:
            spk = name.rsplit("_", 1)[0]
            files = (str(dataset / spk / "align" / f"{name}.markers"),
                     str(dataset / spk / "wavs" / f"{name}.wav"))
            assert feats.extract_features_for_file(
                *files, single, hp, device=device) == name
            refs.append(np.load(Path(single) / f"{name}.npy").astype(
                np.float64))
            wavs.append(feats._prepare_one(
                files, hp, None, skip_pitch=True,
                logger=logging.getLogger("chip_smoke"))["wav"])
            got = np.load(features_dir / spk / f"{name}.npy")
            reads["sound"].append(_mel_errs(got, refs[-1]))
            reads["crop_one_late"].append(_mel_errs(got[:, 1:],
                                                    refs[-1][:, :-1]))
    # the batch _mel_energy_batched builds, its reflect tail left at zero
    # (rows i) or written from the last sample on (rows n + i: numpy's
    # 'symmetric' pad, one sample off 'reflect')
    pad = hp.filter_length // 2
    bucket = hp.hop_length * 128
    S = -(-(max(len(w) for w in wavs) + pad) // bucket) * bucket
    n = len(wavs)
    batch = np.zeros((2 * n, S), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = batch[n + i, :len(w)] = w
        batch[n + i, len(w):len(w) + pad] = w[::-1][:pad]
    log_mel, _ = mel_and_energy_batch(torch.from_numpy(batch).to(device),
                                      **mel_kwargs(hp))
    log_mel = log_mel.cpu().numpy()
    for i, ref in enumerate(refs):
        T = ref.shape[1]
        reads["tail_at_zero"].append(_mel_errs(log_mel[i, :, :T], ref))
        reads["tail_one_sample_off"].append(_mel_errs(log_mel[n + i, :, :T],
                                                      ref))
    for key, rows in reads.items():
        out[key] = {"loud_max_abs_err": max(r[0] for r in rows),
                    "quiet_mel_max_abs_err": max(r[1] for r in rows)}
    out["sound_within"] = \
        out["sound"]["loud_max_abs_err"] <= LOUD_LOG_MEL_ABS_TOL \
        and out["sound"]["quiet_mel_max_abs_err"] <= QUIET_MEL_ABS_TOL
    out["faults_caught"] = all(
        out[k]["loud_max_abs_err"] > LOUD_LOG_MEL_ABS_TOL
        for k in reads if k != "sound")
    if not out["sound_within"] or not out["faults_caught"]:
        raise AssertionError(f"batched against per-file log-mel: {out}")
    return out


def _floats(text):
    return np.array([float(x) for x in text.split()])


def f0_agreement(got, want, hp, log_f0=False):
    """Frames of two F0 tracks (Hz, or written log-F0 with ``log_f0``):
    the share equal, voicing flips, and whether F0_EQUAL_SHARE_MIN's bound
    holds (voicing equal, the share equal, every other frame within one
    lag: fs / L against fs / (L + 1), ~f0^2 / fs, plus for written log-F0
    the int16 Hz and 3-decimal rounding of both tracks)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if log_f0:
        got, want = (np.where(x > 0, np.exp(x), 0.0) for x in (got, want))
    voiced = (got > 0) & (want > 0)
    flips = int(((got > 0) != (want > 0)).sum())
    top = np.maximum(got, want)[voiced]
    one_lag = top * top / (hp.sampling_rate - top)
    one_lag += 1.0 + 1e-3 * top if log_f0 else 1e-3
    ratio = np.abs(got - want)[voiced] / one_lag
    out = {"frames": int(got.size),
           "equal_share": float(np.mean(got == want)),
           "voicing_flips": flips, "differing_frames": int(
               (got != want).sum()),
           "max_share_of_one_lag": float(ratio.max(initial=0.0)),
           "share_limit": F0_EQUAL_SHARE_MIN}
    out["within_bound"] = flips == 0 \
        and out["equal_share"] >= F0_EQUAL_SHARE_MIN \
        and out["max_share_of_one_lag"] <= 1.0
    return out


def bench_rows(dataset, B=PRE_BENCH_B, hops=PRE_BENCH_HOPS, hop=HOP):
    """(B, hops * hop) float32 rows cut from the corpus's wavs (wrapping
    round them), bench.py's device-preprocessing shape."""
    from daft_exprt_tpu_torch.audio.io import load_wav

    audio = np.concatenate([load_wav(str(p))[0] for spk in CORPUS_SPEAKERS
                            for p in sorted((dataset / spk / "wavs")
                                            .glob("*.wav"))])
    S = hops * hop
    idx = (np.arange(B)[:, None] * S + np.arange(S)[None]) % len(audio)
    return audio[idx].astype(np.float32)


def time_device_stages(rows, hp, smi):
    """Mel+energy and F0 on the card at ``rows``' shape: mel+energy by CUDA
    events, F0 by the host clock around calls that end in host arrays
    (its backtrack runs there), both by profiler device time; launches,
    those of the Viterbi loop counted under its profiler range (its graph
    replayed, and its entries run eagerly: the F0 byte-equal, the eager
    loop's launches and ms beside), peak memory, x real time; the F0
    against the CPU's on the same rows
    (F0_EQUAL_SHARE_MIN's bound), and the top-5 order on exact ties
    against a stable sort."""
    from daft_exprt_tpu_torch.audio import pitch_torch
    from daft_exprt_tpu_torch.inference.graphs import process_cache
    from daft_exprt_tpu_torch.ops.mel import mel_and_energy_batch, mel_kwargs

    B, S = rows.shape
    audio_s = B * S / hp.sampling_rate
    x = torch.from_numpy(rows).cuda()
    lens = np.full(B, S)
    kw = mel_kwargs(hp)

    def mel():
        return mel_and_energy_batch(x, **kw)

    def f0():
        return pitch_torch.track_pitch_batch(
            x, lens, hp.sampling_rate, frame_interval=hp.f0_interval,
            min_f0=hp.min_f0, max_f0=hp.max_f0, uv_weight=hp.uv_cost)

    out = {"B": B, "S": S, "audio_s": audio_s, "card": smi}
    mel_ms = cuda_ms(mel, reps=20)
    mel_dev, mel_top = device_ms(mel, reps=10, breakdown=True)
    f0()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f, starts = f0()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    prof, wall_ms = profiled(f0)
    report = kernel_report(prof, wall_ms, {})
    loop = range_launches(prof, "viterbi_loop")
    F = len(starts)
    # the same calls with the recurrence's entries run eagerly on the card
    cache = process_cache("viterbi", x.device)
    cache.cuda = False
    try:
        f_eager, _ = f0()
        eager_walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f0()
            torch.cuda.synchronize()
            eager_walls.append(1e3 * (time.perf_counter() - t0))
        eager_loop = range_launches(profiled(f0)[0], "viterbi_loop")
    finally:
        cache.cuda = True
    out.update(
        mel_ms=mel_ms, mel_device_ms=mel_dev, mel_top=mel_top,
        mel_x_real_time=audio_s / (mel_ms / 1e3),
        f0_ms=float(np.median(walls)), f0_ms_runs=walls,
        f0_x_real_time=audio_s / (np.median(walls) / 1e3),
        f0_frames=F, f0_peak_mem_gb=peak / 2 ** 30,
        viterbi_loop_launches=loop,
        viterbi_loop_launches_per_frame=loop and loop / max(F - 1, 1),
        f0_profile=report,
        viterbi_graphs=len(cache), viterbi_replays=cache.replays,
        f0_eager_ms=float(np.median(eager_walls)),
        f0_eager_ms_runs=eager_walls,
        viterbi_loop_launches_eager=eager_loop,
        f0_replayed_equals_eager=bool(np.array_equal(
            f.cpu().numpy(), f_eager.cpu().numpy())))
    # the card's F0 against the CPU's on the same rows (first 4)
    f_cpu, _ = pitch_torch.track_pitch_batch(
        x[:4].cpu(), lens[:4], hp.sampling_rate,
        frame_interval=hp.f0_interval, min_f0=hp.min_f0, max_f0=hp.max_f0,
        uv_weight=hp.uv_cost)
    out["f0_card_vs_cpu"] = f0_agreement(f[:4].cpu().numpy(),
                                         f_cpu.numpy(), hp)
    # exact ties on the card: the stable sort's order
    rng = np.random.default_rng(3)
    ties = (rng.integers(0, 6, (8, 64, 509)) / 5.0).astype(np.float32)
    _, order = pitch_torch.top_candidates(torch.from_numpy(ties).cuda())
    want = np.argsort(-ties, axis=-1, kind="stable")[..., :5]
    out["tie_order_equal"] = bool((order.cpu().numpy() == want).all())
    print("preprocessing: device stages", json.dumps(out), flush=True)
    if not out["tie_order_equal"] or not out["f0_card_vs_cpu"][
            "within_bound"] or not loop or report is None \
            or loop > report["launches"] \
            or not out["f0_replayed_equals_eager"] \
            or not eager_loop or loop >= eager_loop:
        raise AssertionError(f"device F0: {out}")
    return out


PRE_STAGES = (("data.mfa", "mfa"), ("data.features", "extract_features"),
              ("data.features", "launch_multi_process"),
              ("data.features", "_pitch_batched"),
              ("data.features", "_mel_energy_batched"),
              ("data.features", "_write_features"),
              ("data.sets", "create_sets"),
              ("data.stats", "extract_features_stats"))


def timed_stages(argv):
    """``run_pre_process(argv)`` with host-clock seconds summed for each of
    ``PRE_STAGES`` (MFA markers, feature extraction and, inside it, the
    worker pool, device F0, device mel/energy and the writes; sets;
    stats): (wall seconds, {stage: seconds})."""
    import importlib

    seconds = {}
    saved = []
    for module, name in PRE_STAGES:
        mod = importlib.import_module(f"daft_exprt_tpu_torch.{module}")
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def timed(*args, _fn=fn, _key=f"{module}.{name}", **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                seconds[_key] = seconds.get(_key, 0.0) \
                    + time.perf_counter() - t0
        setattr(mod, name, timed)
    try:
        wall = run_pre_process(argv)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return wall, seconds


def train_from_pre_process(exps, name, hp):
    """``cli.training train`` for PRE_TRAIN_ITERATIONS iterations from the
    experiment ``pre_process`` wrote, under an NCCL group of one, the
    K1-K5 counters zeroed before and read after (K2 and K3 12 x 3 a step
    each, all on their tensor-core instances); each step's loss read as it
    returns; fails unless the losses and the saved weights are finite."""
    from daft_exprt_tpu_torch.training import trainer as trainer_mod
    from daft_exprt_tpu_torch.training.checkpoint import load_checkpoint

    losses = []

    def recording(model, hp_):
        step = make_train_step(model, hp_)

        def run(*args):
            metrics = step(*args)
            losses.append(float(metrics["loss"]))
            return metrics
        run.optimizer = step.optimizer
        run.graphs = step.graphs
        return run

    trainer_mod.make_train_step = recording
    _zero_counts()
    try:
        tr, seconds = run_training_cli([
            "train", "--experiments_dir", str(exps), "--experiment_name",
            name, "--max_iterations", str(PRE_TRAIN_ITERATIONS),
            "--no_benchmark_synthesis", "--coordinator",
            f"localhost:{_free_port()}", "--num_processes", "1",
            "--process_id", "0"])
    finally:
        trainer_mod.make_train_step = make_train_step
    launches = _train_counts(tr.train_step.graphs)
    steps = PRE_TRAIN_ITERATIONS * fft_blocks(hp) * hp.accumulation_steps
    want = expected_launches("conv_ff_train", steps, tensor_core=True)
    state, _, meta = load_checkpoint(str(
        exps / name / "checkpoints" / "DaftExprt_last.pt"))
    train = {
        "seconds": seconds, "iterations": tr.iteration,
        "checkpoint_iteration": meta["iteration"], "launches": launches,
        "expected": want, "losses": losses,
        "params_finite": all(bool(torch.isfinite(v).all())
                             for v in state.values())}
    print("preprocessing: train", json.dumps(train), flush=True)
    if tr.iteration != PRE_TRAIN_ITERATIONS \
            or meta["iteration"] != PRE_TRAIN_ITERATIONS \
            or len(losses) != PRE_TRAIN_ITERATIONS \
            or not np.isfinite(losses).all() \
            or not train["params_finite"]:
        raise AssertionError(f"training from pre_process: {train}")
    check_launches(
        "training from pre_process",
        all(launches[k] == v for k, v in want.items()),
        f"{launches}, expected {want}")
    return train


def preprocessing(smi):
    """The preprocessing phase: a raw two-speaker corpus written here,
    ``cli.training pre_process`` run three ways (its own process with
    ``--device_pitch`` on the card, as a user runs it; in this process
    with the host tracker; in this process with ``--device_pitch``,
    timed) and held (``check_preprocessed``); the device stages timed at
    bench.py's shape (``time_device_stages``); then ``cli.training train``
    for 2 flagship iterations from the first run's experiment under an
    NCCL group of one, the K1-K5 counters zeroed before and read after."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="preprocessing_"))
    home = tmp / "home"
    home.mkdir()
    report = {"card": smi}
    try:
        t0 = time.perf_counter()
        dataset = tmp / "dataset"
        audio_s = write_raw_corpus(dataset)
        report["corpus"] = {"seconds_of_audio": audio_s,
                            "utterances": 2 * PRE_UTTS,
                            "write_s": time.perf_counter() - t0}
        exps = tmp / "exps"
        features = {run: tmp / f"features_{run}"
                    for run in ("dev", "host", "dev2")}
        _zero_counts()
        walls = {
            "process_device_pitch_s": run_pre_process(pre_process_argv(
                dataset, features["dev"], exps, "dev", True, "cuda"),
                process=True, home=home),
            "host_pitch_s": run_pre_process(pre_process_argv(
                dataset, features["host"], exps, "host", False, "cuda")),
        }
        walls["device_pitch_s"], walls["stages_s"] = timed_stages(
            pre_process_argv(dataset, features["dev2"], exps, "dev2", True,
                             "cuda"))
        launches = _train_counts()
        walls["seconds_per_hour_of_audio"] = \
            walls["device_pitch_s"] * 3600 / audio_s
        walls["host_pitch_seconds_per_hour_of_audio"] = \
            walls["host_pitch_s"] * 3600 / audio_s
        report["pre_process"] = walls
        report.update(check_preprocessed(dataset, features, exps, "cuda"))
        print("preprocessing: pre_process", json.dumps(report), flush=True)
        check_launches("pre_process", not any(launches.values()),
                       f"{launches}: it runs none of the kernels")
        hp = HyperParams.load(str(exps / "dev" / "config.json"))
        report["device_stages"] = time_device_stages(bench_rows(dataset), hp,
                                                     smi)

        report["train"] = train_from_pre_process(exps, "dev", hp)
        print("preprocessing", json.dumps(report), flush=True)
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Vocoder training: HiFi-GAN fine-tuning through cli.train_vocoder on the
# fine-tuning dataset, full V1 + MPD/MSD at batch 16 x 8192
# ----------------------------------------------------------------------
VOC_BATCH, VOC_SEGMENT = 16, 8192  # the JAX trainer's defaults
VOC_STEPS = 6              # the CLI run, checkpoints at 3 and 6
VOC_EVERY = 3
VOC_TIMED_STEPS = 5        # the timed GAN steps, after 2 warm-up steps
# tools/vocoder_train_soak.py's run and bound: mel_l1 down > 15% in 200
# steps from its first logged step, 20 (after the drop from the random
# init). One batch's mel_l1 swings with the discriminator's loss spikes
# (PERF.md), so the gate reads the mean of 20 steps at each end: steps
# 20-39 against steps 181-200
SOAK_VOC_STEPS = 200
SOAK_VOC_BASELINE = 20
SOAK_VOC_WINDOW = 20
SOAK_VOC_MIN_DROP = 0.15
# the small card-vs-CPU GAN step (tests/test_vocoder_train.py's shapes at
# batch 4 x 512 samples): float32 with TF32 off, and as users run it
# (cuDNN's default, TF32 convs). Losses relative, gradients relative L2
# per tensor (the worst); the TF32 bounds are 10-bit-mantissa products
VOC_SMALL_GEN = {"upsample_rates": [4, 2], "upsample_kernel_sizes": [8, 4],
                 "upsample_initial_channel": 16,
                 "resblock_kernel_sizes": [3],
                 "resblock_dilation_sizes": [[1, 3]], "num_mels": 8}
VOC_SMALL_D = {"mpd": {"periods": (2, 3), "channels": (4, 8, 8, 8)},
               "msd": {"layers": ((8, 15, 1, 1), (8, 41, 2, 4),
                                  (16, 21, 4, 4))}}
VOC_SMALL_MEL = {"sampling_rate": 800, "n_fft": 32, "hop_length": 8,
                 "n_mels": 8, "fmin": 0.0, "fmax": None}
VOC_CPU_TOL = {"f32": {"loss": 1e-5, "grad": 1e-4},
               "tf32": {"loss": 1e-2, "grad": 5e-2}}
VOC_MEL_CFG = {"sampling_rate": SAMPLE_RATE, "n_fft": 1024, "hop_length": HOP,
               "n_mels": 80, "fmin": 0.0, "fmax": None}
VOC_GROUPS = {"k5_ms": ("mrf_",),
              "cudnn_conv_ms": CUDNN_KERNELS,
              "fft_ms": ("fft", "FFT", "regular_fft", "vector_fft")}


def write_seed0_vocoder(folder):
    """The seed-0 V1 generator as a torch ``g_*`` file and its config:
    (g path, config path)."""
    voc, cfg = Path(folder) / "g_seed0", Path(folder) / "v1.json"
    torch.save({"generator": HiFiGanGenerator(
        seed=0, device="cpu").state_dict()}, voc)
    cfg.write_text(json.dumps(V1_CONFIG))
    return voc, cfg


def write_soak_corpus(root, n=8, seconds=2.0, sr=SAMPLE_RATE):
    """``tools/vocoder_train_soak.py``'s corpus: n amplitude-modulated
    sines of 80 + 40 i Hz with noise, ``seconds`` long."""
    from daft_exprt_tpu_torch.audio.io import save_wav

    rng = np.random.default_rng(0)
    spk = Path(root) / "spk1"
    spk.mkdir(parents=True)
    t = np.arange(int(sr * seconds)) / sr
    for i in range(n):
        wav = 0.3 * np.sin(2 * np.pi * (80.0 + 40.0 * i) * t) \
            * (1.0 + 0.3 * np.sin(2 * np.pi * 3.0 * t))
        save_wav(str(spk / f"utt{i}.wav"), (wav + 0.02 * rng.standard_normal(
            len(t))).astype(np.float32), sr)
    return str(root)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_train_vocoder_process(argv):
    """``python -m daft_exprt_tpu_torch.cli.train_vocoder`` in a process of
    its own, as a user runs it; wall seconds."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "daft_exprt_tpu_torch.cli.train_vocoder",
         *argv], cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"train_vocoder exited {run.returncode}: "
                             f"{run.stderr[-3000:]}")
    return seconds


def _equal_trees(a, b, path=""):
    """The paths at which two checkpoint blobs differ."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [path]
        return [p for k in a for p in _equal_trees(a[k], b[k],
                                                   f"{path}.{k}")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [path]
    return [] if a == b else [path]


def gan_setup(g_ckpt=None, gen_cfg=None, d_kwargs=None, device="cuda",
              seed=0):
    """A weight-normalized generator (from ``g_ckpt``, else drawn from
    ``seed``), MPD and MSD drawn from ``seed`` + 1, + 2, their optimizers."""
    from daft_exprt_tpu_torch.vocoder import train as vtrain
    from daft_exprt_tpu_torch.vocoder.discriminators import (
        MultiPeriodDiscriminator, MultiScaleDiscriminator)
    from daft_exprt_tpu_torch.vocoder.hifigan import load_torch_generator

    gen = load_torch_generator(str(g_ckpt), gen_cfg, device=device) \
        if g_ckpt else HiFiGanGenerator(gen_cfg, device=device, seed=seed)
    vtrain.wn_wrap(gen)
    d_kwargs = d_kwargs or {}
    mpd = MultiPeriodDiscriminator(**d_kwargs.get("mpd", {}), device=device,
                                   seed=seed + 1)
    msd = MultiScaleDiscriminator(**d_kwargs.get("msd", {}), device=device,
                                  seed=seed + 2)
    opt_g, opt_d = vtrain.make_optimizers(gen, mpd, msd)
    return gen, mpd, msd, opt_g, opt_d


def time_gan_step(g_ckpt, gen_cfg, dataset_dir, tf32, device="cuda"):
    """Full-width GAN steps at batch 16 x 8192 from the fine-tuning
    dataset, three CUDA graph replays a step: step ms (host clock to a
    synchronize) replayed against the same step's entries run eagerly
    (``graphs.cuda`` off), ``VOC_TIMED_STEPS`` steps each way in turns
    (eager, replayed, replayed, eager) after the capture; peak memory; K5
    and K1 launches inside the steps (none: the GAN step runs the staged
    convs); the waits for the card PyTorch reports in one replayed step
    (``syncs``, where); one profiled replayed step (device busy against
    that step's own wall and idle share); the graphs, their capture
    seconds and pool bytes."""
    from daft_exprt_tpu_torch.vocoder import train as vtrain

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        gen, mpd, msd, opt_g, opt_d = gan_setup(g_ckpt, gen_cfg,
                                                device=device)
        step = vtrain.make_vocoder_train_step(gen, mpd, msd, VOC_MEL_CFG,
                                              opt_g, opt_d)
        dataset = vtrain.VocoderDataset(str(dataset_dir), VOC_MEL_CFG,
                                        VOC_SEGMENT)
        rng = np.random.default_rng(0)
        batches = [{k: torch.from_numpy(v).to(device) for k, v in
                    dataset.sample_batch(rng, VOC_BATCH).items()}
                   for _ in range(VOC_TIMED_STEPS + 3)]
        cuda = torch.device(device).type == "cuda"
        t0 = time.perf_counter()
        step(batches[0])  # a warm-up, the captures, replays
        _sync(device)
        first_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        before = _counts()
        times = {"eager": [], "replayed": []}
        for mode in ("eager", "replayed", "replayed", "eager"):
            step.graphs.cuda = cuda and mode == "replayed"
            for b in batches[1:1 + VOC_TIMED_STEPS]:
                t0 = time.perf_counter()
                metrics = step(b)
                _sync(device)
                times[mode].append((time.perf_counter() - t0) * 1e3)
        step.graphs.cuda = cuda
        launches = _launches(before)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        sync_sites = None
        if cuda:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    step(batches[-2])
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            # the mode's own notice ("Synchronization debug mode is a
            # prototype ...") is no wait
            sync_sites = [f"{Path(w.filename).name}:{w.lineno}"
                          for w in caught
                          if "called a synchronizing" in str(w.message)]
            _sync(device)
        report = None
        if cuda:
            prof, wall_ms = profiled(lambda: step(batches[-1]))
            report = kernel_report(prof, wall_ms, VOC_GROUPS)
            # kernels of a replay overlap: the device's union beside busy
            report["timeline"] = idle_gaps(prof)
        params = {"generator": sum(p.numel() for p in gen.parameters()),
                  "mpd": sum(p.numel() for p in mpd.parameters()),
                  "msd": sum(p.numel() for p in msd.parameters())}
        graphs = step.graphs
        out = {"tf32_convs": tf32,
               "step_ms": float(np.median(times["replayed"])),
               "step_ms_eager": float(np.median(times["eager"])),
               "step_ms_all": times, "first_step_s": first_s,
               "syncs": None if sync_sites is None else len(sync_sites),
               "sync_sites": sync_sites, "peak_memory_gb": peak / 1e9,
               "params": params, "launches": launches,
               "metrics": {k: float(v) for k, v in metrics.items()},
               "graphs": len(graphs), "keys": sorted(
                   str(k if isinstance(k, str) else k[0])
                   for k in graphs.keys()),
               "captures": graphs.captures,
               "capture_seconds": graphs.capture_seconds,
               "replays": graphs.replays,
               "pool_gb": graphs.pool_bytes() / 1e9, "profile": report}
        if launches["k5"] or launches["k1"]:
            raise AssertionError(f"a GAN step launched a kernel: {launches}")
        if report is not None and report["k5_ms"]:
            raise AssertionError(f"K5 ran in a profiled GAN step: {report}")
        if cuda and (graphs.captures != 3 or len(graphs) != 3):
            raise AssertionError(f"GAN step graphs: {out}")
        return out
    finally:
        torch.backends.cudnn.allow_tf32 = prev


GAN_REPLAY_STEPS = 20  # replayed steps held against as many eager ones
GAN_REPLAY_SCRIPT = """
import json, sys
import chip_smoke as cs
print("GAN_REPLAY " + json.dumps(cs.gan_replay_check(*json.loads(
    sys.argv[1]))), flush=True)
"""


def gan_replays(g_ckpt, gen_cfg, dataset_dir):
    """``gan_replay_check`` in a process of its own, with deterministic
    algorithms as ``cli.train_vocoder --deterministic`` sets them (cuBLAS's
    workspace is fixed before its first call); its report, or a failure."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", GAN_REPLAY_SCRIPT,
         json.dumps([str(g_ckpt), str(gen_cfg), str(dataset_dir)])],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    lines = [x for x in run.stdout.splitlines()
             if x.startswith("GAN_REPLAY ")]
    if run.returncode != 0 or not lines:
        raise AssertionError(f"GAN replays against eager steps exited "
                             f"{run.returncode}: {run.stderr[-3000:]}")
    out = json.loads(lines[-1][len("GAN_REPLAY "):])
    out["process_s"] = time.perf_counter() - t0
    return out


def gan_replay_check(g_ckpt, gen_cfg, dataset_dir, device="cuda"):
    """``GAN_REPLAY_STEPS`` GAN steps at 16 x 8192 (TF32 convs, as users
    run them) under deterministic algorithms, from the same start and
    batches, through the step's graphs and with its entries run eagerly:
    the losses of every step, the parameters, the optimizers' moments and
    the spectral-norm vectors after the last, bit for bit. The trained
    generator then serves: its serving graphs (captured before the
    training) are dropped, a ``vocode_mels`` pass runs K5 3 times (eager,
    then captured and replayed), and its wav equals the same generator's
    weights exported and served, bit for bit."""
    from daft_exprt_tpu_torch.vocoder import train as vtrain
    from daft_exprt_tpu_torch.vocoder.hifigan import vocode_mels

    _build.build()
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.allow_tf32 = True
    dataset = vtrain.VocoderDataset(str(dataset_dir), VOC_MEL_CFG,
                                    VOC_SEGMENT)
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in
                dataset.sample_batch(rng, VOC_BATCH).items()}
               for _ in range(GAN_REPLAY_STEPS)]
    mel = np.load(sorted(Path(dataset_dir).glob("*/*.npy"))[0])
    runs, out = {}, {"steps": GAN_REPLAY_STEPS, "tf32_convs": True,
                     "deterministic": True}
    for mode in ("eager", "replayed"):
        gen, mpd, msd, opt_g, opt_d = gan_setup(g_ckpt, gen_cfg,
                                                device=device)
        step = vtrain.make_vocoder_train_step(gen, mpd, msd, VOC_MEL_CFG,
                                              opt_g, opt_d)
        step.graphs.cuda = mode == "replayed"
        if mode == "replayed":
            vocode_mels(gen, [mel])  # an eager pass, then the capture
            served = gen.graphs()
            wav_before, = vocode_mels(gen, [mel])
        t0 = time.perf_counter()
        losses = [torch.stack(list(step(b).values())) for b in batches]
        _sync(device)
        out[f"{mode}_s"] = time.perf_counter() - t0
        state = [t.detach().clone() for t in (
            *gen.parameters(), *mpd.parameters(), *msd.parameters(),
            *(b for c in msd.sn_convs() for b in (c.weight_u, c.weight_v)),
            *opt_g.moments()[0], *opt_g.moments()[1],
            *opt_d.moments()[0], *opt_d.moments()[1])]
        runs[mode] = (torch.stack(losses).cpu(), state)
    graphs = step.graphs
    out.update(
        losses_equal=torch.equal(runs["eager"][0], runs["replayed"][0]),
        state_equal=all(torch.equal(a, b) for a, b in zip(
            runs["eager"][1], runs["replayed"][1])),
        tensors=len(runs["eager"][1]),
        losses_last=runs["replayed"][0][-1].tolist(),
        captures=graphs.captures, replays=graphs.replays,
        capture_seconds=graphs.capture_seconds,
        pool_gb=graphs.pool_bytes() / 1e9)
    # the trained generator serves, its stale graphs dropped
    out["serving_graphs_dropped"] = gen.graphs() is not served
    before = _counts(vocoder_graphs(gen))
    wav, = vocode_mels(gen, [mel])
    wav_again, = vocode_mels(gen, [mel])
    out["served_launches"] = _launches(before, vocoder_graphs(gen))
    exported, = vocode_mels(vtrain.export_generator_params(gen), [mel])
    out.update(
        served_equals_exported=bool(np.array_equal(wav, exported)
                                    and np.array_equal(wav, wav_again)),
        served_moved=not np.array_equal(wav, wav_before),
        served_finite=bool(np.isfinite(wav).all()))
    return out


def gan_step_against_cpu(tf32, device="cuda"):
    """One small float32 GAN step on the card against the same step on the
    CPU: relative errors of the losses, the worst per-tensor relative L2 of
    the gradients of both networks and of the parameters after the step,
    with the bounds of ``VOC_CPU_TOL``."""
    from daft_exprt_tpu_torch.vocoder import train as vtrain

    rng = np.random.default_rng(21)
    t = np.arange(512) / 800
    audio = np.stack([0.3 * np.sin(2 * np.pi * (30 + 10 * i) * t)
                      + 0.01 * rng.standard_normal(512)
                      for i in range(4)]).astype(np.float32)
    sides = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for side in ("card", "cpu"):
            on = device if side == "card" else "cpu"
            gen, mpd, msd, opt_g, opt_d = gan_setup(
                None, VOC_SMALL_GEN, VOC_SMALL_D, device=on, seed=5)
            step = vtrain.make_vocoder_train_step(
                gen, mpd, msd, VOC_SMALL_MEL, opt_g, opt_d,
                input_mel_cfg=dict(VOC_SMALL_MEL, fmax=400.0))
            metrics = step({"audio": torch.from_numpy(audio).to(on)})
            named = [(f"{m}.{n}", p) for m, mod in (("g", gen), ("mpd", mpd),
                                                  ("msd", msd))
                     for n, p in mod.named_parameters()]
            sides[side] = ({k: float(v) for k, v in metrics.items()},
                             {n: p.grad.double().cpu() for n, p in named},
                             {n: p.detach().double().cpu() for n, p in named})
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    (m_gpu, g_gpu, p_gpu), (m_cpu, g_cpu, p_cpu) = sides["card"], sides["cpu"]

    def worst(a, b):
        return max(float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30))
                   for k in b)
    out = {"loss_rel": max(abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
                           for k in m_cpu),
           "grad_rel_l2_worst": worst(g_gpu, g_cpu),
           "param_max_abs_after_step": max(float((p_gpu[k] - p_cpu[k])
                                                 .abs().max())
                                           for k in p_cpu),
           "metrics_cpu": m_cpu, "metrics_card": m_gpu}
    tol = VOC_CPU_TOL["tf32" if tf32 else "f32"]
    out["bounds"] = tol
    if not (out["loss_rel"] <= tol["loss"]
            and out["grad_rel_l2_worst"] <= tol["grad"]):
        raise AssertionError(f"GAN step card vs CPU (tf32={tf32}): {out}")
    return out


def audio_requests_by_dtype(gen, smi, rounds=2, device="cuda"):
    """Text-to-waveform requests at flagship width (B=8, L=64, bucket 512)
    with ``gen`` attached at float32 and at bf16, in turns (f32, bf16,
    bf16, f32 a round): host ms of each request, K5's launches (3 a pass,
    tensor-core), and the relative L2 of the bf16 audio against the
    float32."""
    model = DaftExprt(flagship_hparams(), seed=0, device=device)
    pin_durations(model)
    # an engine a dtype: attaching again would drop the audio graphs
    engines = {dtype: InferenceEngine(model, None, flagship_hparams(),
                                      device=device)
               for dtype in (torch.float32, torch.bfloat16)}
    hp = engines[torch.float32].hp
    inputs = make_request(hp, np.random.default_rng(11), 8, 64, 512, 0.25,
                          "add")
    keys = [(f"style_{i}", i) for i in range(8)]
    wavs, times, launches = {}, {"float32": [], "bfloat16": []}, {}
    for dtype, engine in engines.items():  # warm-up
        engine.attach_vocoder(gen, dtype)
        engine.run_cached_to_audio(inputs, "add", keys)
    for _ in range(rounds):
        for dtype in (torch.float32, torch.bfloat16, torch.bfloat16,
                      torch.float32):
            name = dtype_name(dtype)
            engine = engines[dtype]
            _sync(device)
            before = _counts(engine)
            t0 = time.perf_counter()
            out, out_lens, overflow = engine.run_cached_to_audio(
                inputs, "add", keys)
            times[name].append((time.perf_counter() - t0) * 1e3)
            launches[name] = _launches(before, engine)
            wavs[name] = np.concatenate(out)
            check_launches(f"audio request ({name} vocoder)",
                           launches[name]["k5_total"] == 3
                           == launches[name]["k5_tensor_core_total"],
                           launches[name])
    rel = _np_rel_l2(wavs["bfloat16"], wavs["float32"])
    return {"card": smi, "request_ms": {k: float(np.median(v))
                                        for k, v in times.items()},
            "request_ms_all": times, "launches": launches,
            "samples": int(len(wavs["float32"])),
            "bf16_vs_f32_rel_l2": rel}


def vocoder_training(smi, dataset_dir, device="cuda"):
    """The vocoder-training phase: ``cli.train_vocoder`` as its own process
    on the fine-tuning dataset ``dataset_dir`` (112 utterances, written by
    the training-runtime phase's ``cli.training fine_tune``) from the
    seed-0 V1 ``g_*`` with fresh full MPD/MSD, batch 16 x 8192, 6 steps
    with checkpoints at 3 and 6 (``--deterministic``), and again resumed
    from 3 (the two g_/do_00000006 bit-equal); the trained g_00000006
    through ``load_generator`` serving audio requests and vocoding a
    dataset mel (K5 3 a pass, tensor-core); ``GAN_REPLAY_STEPS`` replayed
    GAN steps bit-equal to as many eager ones under deterministic
    algorithms, and the generator they trained serving (``gan_replays``);
    the GAN step (three graph replays) timed against its eager run and
    profiled in process as users run it (TF32 convs) and with TF32 off (no
    K5 launch in either); a small GAN step card vs CPU (f32 and TF32);
    the learning check from scratch (``cli.train_vocoder --from_audio
    --deterministic`` on the soak corpus, mel_l1 must drop > 15% in 200
    steps);
    audio requests with the trained generator at bf16 beside float32."""
    import shutil
    import tempfile

    from daft_exprt_tpu_torch.vocoder import train as vtrain
    from daft_exprt_tpu_torch.vocoder.hifigan import (load_generator,
                                                      vocode_mels)

    started = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="vocoder_training_"))
    report = {"card": smi}
    try:
        voc, voc_cfg = write_seed0_vocoder(tmp)
        n_items = len(list(Path(dataset_dir).glob("*/*.npy")))
        # (a) the CLI as users run it, resumed from 3 against 6 straight
        common = ["--dataset_dir", str(dataset_dir), "--generator_ckpt",
                  str(voc), "--vocoder_config", str(voc_cfg), "--steps",
                  str(VOC_STEPS), "--checkpoint_every", str(VOC_EVERY),
                  "--log_every", "1", "--batch_size", str(VOC_BATCH),
                  "--segment_size", str(VOC_SEGMENT), "--deterministic",
                  "--device", device]
        whole, part = tmp / "whole", tmp / "resumed"
        cli = {"utterances": n_items,
               "whole_s": run_train_vocoder_process(
                   common + ["--output_dir", str(whole)])}
        ckpts = whole / "vocoder_checkpoints"
        cli["resumed_s"] = run_train_vocoder_process(
            common + ["--output_dir", str(part), "--resume",
                      str(ckpts / f"do_{VOC_EVERY:08d}")])
        g_a, do_a = (torch.load(p, weights_only=True) for p in
                     vtrain.checkpoint_paths(str(ckpts), VOC_STEPS))
        g_b, do_b = (torch.load(p, weights_only=True) for p in
                     vtrain.checkpoint_paths(
                         str(part / "vocoder_checkpoints"), VOC_STEPS))
        cli["resume_differs_at"] = _equal_trees(g_a, g_b) \
            + _equal_trees(do_a, do_b)
        with open(whole / "vocoder_metrics.jsonl") as f:
            cli["metrics"] = [json.loads(x) for x in f]
        cli["epoch"], cli["epoch0"] = do_a["epoch"], do_a["epoch0"]
        print("vocoder training: CLI", json.dumps(cli), flush=True)
        if cli["resume_differs_at"] or len(cli["metrics"]) != VOC_STEPS \
                or not all(np.isfinite(m[k]) for m in cli["metrics"]
                           for k in ("loss_d", "loss_g", "mel_l1")):
            raise AssertionError(f"train_vocoder CLI: {cli}")
        del g_b, do_a, do_b
        report["cli"] = cli

        # (b) the trained generator served through K5
        gen = load_generator(str(ckpts / f"g_{VOC_STEPS:08d}"),
                             str(ckpts / "config.json"), device=device)
        trained = gen.state_dict()
        seed0 = HiFiGanGenerator(seed=0, device=device).state_dict()
        mel = np.load(sorted(Path(dataset_dir).glob("*/*.npy"))[0])
        vocode_mels(gen, [mel])  # an eager pass, then the capture
        _sync(device)
        before = _counts(vocoder_graphs(gen))
        wav, = vocode_mels(gen, [mel])
        served = {"mel_frames": int(mel.shape[1]),
                  "launches": _launches(before, vocoder_graphs(gen)),
                  "finite": bool(np.isfinite(wav).all()),
                  "weights_moved_from_seed0": any(
                      not torch.equal(trained[k], v)
                      for k, v in seed0.items())}
        print("vocoder training: served", json.dumps(served), flush=True)
        check_launches("vocoding with the trained generator",
                       served["launches"]["k5_total"] == 3
                       == served["launches"]["k5_tensor_core_total"]
                       == served["launches"]["k5_replayed"]
                       and served["finite"]
                       and served["weights_moved_from_seed0"], served)
        report["served"] = served
        report["audio_by_dtype"] = audio_requests_by_dtype(gen, smi,
                                                           device=device)
        print("vocoder training: audio by dtype",
              json.dumps(report["audio_by_dtype"]), flush=True)
        del gen, trained, seed0
        shutil.rmtree(whole, ignore_errors=True)
        shutil.rmtree(part, ignore_errors=True)

        # (b2) replayed GAN steps against eager ones, deterministic; the
        # generator they trained serves
        replays = report["replays"] = gan_replays(voc, voc_cfg, dataset_dir)
        print("vocoder training: replays", json.dumps(replays), flush=True)
        served = replays["served_launches"]
        if not all(replays[k] for k in (
                "losses_equal", "state_equal", "serving_graphs_dropped",
                "served_equals_exported", "served_moved", "served_finite")):
            raise AssertionError(f"GAN replays against eager steps: "
                                 f"{replays}")
        check_launches("the generator trained by replays, served",
                       served["k5"] == served["k5_replayed"] == 3
                       == served["k5_tensor_core"]
                       == served["k5_tensor_core_replayed"], served)

        # (c) the GAN step timed and profiled, as users run it and strict
        report["step"] = {
            "tf32": time_gan_step(voc, str(voc_cfg), dataset_dir, True,
                                  device),
            "f32": time_gan_step(voc, str(voc_cfg), dataset_dir, False,
                                 device)}
        print("vocoder training: GAN step", json.dumps(report["step"]),
              flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

        # (d) a small GAN step on the card against the CPU
        report["card_vs_cpu"] = {"f32": gan_step_against_cpu(False, device),
                                 "tf32": gan_step_against_cpu(True, device)}
        print("vocoder training: card vs CPU",
              json.dumps(report["card_vs_cpu"]), flush=True)

        # (e) learning from scratch on the soak corpus, through the CLI
        learning = learning_gate_run(write_soak_corpus(tmp / "soak"),
                                     tmp / "soak_out", device)
        print("vocoder training: learning", json.dumps(learning), flush=True)
        if not learning["drop"] > SOAK_VOC_MIN_DROP:
            raise AssertionError(
                f"mel_l1 dropped {learning['drop']:.1%} in {SOAK_VOC_STEPS} "
                f"steps (steps {learning['baseline_steps']} against "
                f"{learning['final_steps']}): {learning}")
        report["learning"] = learning
        report["seconds"] = time.perf_counter() - started
        print("vocoder training", json.dumps(report), flush=True)
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def learning_readings(lines):
    """The learning check's readings of a run's ``vocoder_metrics.jsonl``
    lines (one a step): ``drop``, the gate's (the mean mel_l1 of the last
    ``SOAK_VOC_WINDOW`` steps against the mean of the ``SOAK_VOC_WINDOW``
    steps from ``SOAK_VOC_BASELINE``), the soak's single steps
    (``SOAK_VOC_BASELINE`` against the last), mel_l1 and loss_d by 20-step
    window, and the mel_l1 of every step."""
    mel_l1 = np.array([m["mel_l1"] for m in lines])
    b, w = SOAK_VOC_BASELINE, SOAK_VOC_WINDOW
    return {
        "steps": len(lines),
        "sec_per_step_median": float(np.median(
            [m["sec_per_step"] for m in lines[5:]])),
        "baseline_steps": f"{b}-{b + w - 1}",
        "final_steps": f"{len(lines) - w + 1}-{len(lines)}",
        "drop": float(1.0 - mel_l1[-w:].mean()
                      / mel_l1[b - 1:b - 1 + w].mean()),
        "drop_single_steps": float(1.0 - mel_l1[-1] / mel_l1[b - 1]),
        "mel_l1_window_means": [float(x) for x in mel_l1.reshape(
            -1, 20).mean(1)],
        "loss_d_window_means": [float(x) for x in np.reshape(
            [m["loss_d"] for m in lines], (-1, 20)).mean(1)],
        "mel_l1": [float(x) for x in mel_l1]}


def _metrics_lines(out):
    with open(Path(out) / "vocoder_metrics.jsonl") as f:
        return [json.loads(x) for x in f]


# the gate's run: the CLI's default seed, cuDNN's default (TF32 convs), and
# deterministic algorithms, so that every run of the smoke reads one curve
VOC_GATE_SEED = 1234


def learning_gate_run(data, out, device="cuda"):
    """The learning gate's run: ``cli.train_vocoder --from_audio
    --deterministic`` as its own process on the corpus ``data``, from
    scratch at ``VOC_GATE_SEED``, ``SOAK_VOC_STEPS`` steps at batch 16 x
    8192 with TF32 convs (cuDNN's default, as users run it); its
    ``learning_readings`` and the process's seconds."""
    seconds = run_train_vocoder_process(
        ["--dataset_dir", str(data), "--output_dir", str(out),
         "--from_audio", "--steps", str(SOAK_VOC_STEPS),
         "--batch_size", str(VOC_BATCH), "--segment_size", str(VOC_SEGMENT),
         "--log_every", "1", "--checkpoint_every", str(SOAK_VOC_STEPS),
         "--seed", str(VOC_GATE_SEED), "--deterministic", "--device",
         device])
    return {"tf32_convs": True, "seed": VOC_GATE_SEED, "deterministic": True,
            "seconds": seconds, **learning_readings(_metrics_lines(out))}


def learning_check(data, out, tf32, seed, device="cuda"):
    """``fine_tune_vocoder`` from scratch (``--from_audio``) in this process,
    without deterministic algorithms, on the corpus ``data`` for
    ``SOAK_VOC_STEPS`` steps at batch 16 x 8192, with TF32 convs or not,
    from ``seed``; its ``learning_readings`` and seconds."""
    from daft_exprt_tpu_torch.vocoder import train as vtrain

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        t0 = time.perf_counter()
        vtrain.fine_tune_vocoder(
            data, str(out), from_audio=True, steps=SOAK_VOC_STEPS,
            batch_size=VOC_BATCH, segment_size=VOC_SEGMENT, log_every=1,
            checkpoint_every=SOAK_VOC_STEPS + 1, seed=seed, device=device)
        seconds = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return {"tf32_convs": tf32, "seed": seed, "deterministic": False,
            "seconds": seconds, **learning_readings(_metrics_lines(out))}


# 20 runs: 8 (TF32, seed) pairs, then more seeds with TF32 convs (as users
# run them) and two more without
VOC_LEARNING_RUNS = ((True, 1234), (False, 1234), (True, 0), (True, 7),
                     (True, 1), (True, 2), (True, 3), (False, 0),
                     *((True, seed) for seed in range(4, 14) if seed != 7),
                     (True, 14), (False, 1), (False, 7))
# 20 further runs in the same proportions (``--vocoder-learning more``)
VOC_LEARNING_MORE_RUNS = (*((True, seed) for seed in range(15, 31)),
                          *((False, seed) for seed in range(2, 6)))


def vocoder_learning(smi, runs=VOC_LEARNING_RUNS, gate=True):
    """With ``gate``, the learning gate's run twice, each in a process of
    its own (a ``gate runs equal`` line: whether the two mel_l1 curves are
    equal); then ``learning_check`` once for each (TF32 convs, seed) of
    ``runs``: one ``vocoder learning`` line for each run."""
    tmp = Path(tempfile.mkdtemp(prefix="vocoder_learning_"))
    try:
        data = write_soak_corpus(tmp / "soak")
        if gate:
            gates = [learning_gate_run(data, tmp / f"gate_{i}")
                     for i in range(2)]
            for r in gates:
                print("vocoder learning", json.dumps({"card": smi, **r}),
                      flush=True)
            print("vocoder learning: gate runs equal",
                  json.dumps(gates[0]["mel_l1"] == gates[1]["mel_l1"]),
                  flush=True)
        drops = []
        for tf32, seed in runs:
            r = learning_check(data, tmp / f"out_{tf32}_{seed}", tf32, seed)
            print("vocoder learning", json.dumps({"card": smi, **r}),
                  flush=True)
            drops.append(r["drop"])
            gc.collect()  # the run's graphs and their pool
            torch.cuda.empty_cache()
        print("vocoder learning: runs under the gate's drop",
              json.dumps({"under": sum(d <= SOAK_VOC_MIN_DROP for d in drops),
                          "runs": len(drops), "drops": drops}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


GAP_MIN_MS = 0.05  # the shortest idle stretch of the device listed
GAP_BINS_US = (2.0, 10.0, 50.0)  # idle stretches counted by length


def idle_gaps(prof):
    """The device's activity in a finished profiler run, from its first
    device operation to its last: the time some operation ran
    (``union_ms``: overlapping kernels counted once), the idle stretches
    between, counted and summed by length (``GAP_BINS_US``), each one past
    ``GAP_MIN_MS`` with the host operations that overlap it (the longest
    overlaps), and the host's CUDA runtime calls of 0.02 ms or more on the
    same clock (a graph's launch, a copy, a wait)."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == cuda
                 and not getattr(e, "is_user_annotation", False))
    host = [e for e in events if e.device_type == cpu]
    if not dev:
        return None
    first, (start0, end), gaps, union = dev[0][0], dev[0], [], 0.0
    for start, stop in dev[1:]:
        if start > end:
            union += end - start0
            gaps.append((end, start))
            start0 = start
        end = max(end, stop)
    union += end - start0
    bins = [0] * (len(GAP_BINS_US) + 1)
    sums = [0.0] * (len(GAP_BINS_US) + 1)
    listed = []
    for a, b in gaps:
        i = sum((b - a) >= edge for edge in GAP_BINS_US)
        bins[i] += 1
        sums[i] += (b - a) / 1e3
        if b - a < GAP_MIN_MS * 1e3:
            continue
        overlap = {}
        for e in host:
            lo, hi = max(a, e.time_range.start), min(b, e.time_range.end)
            if hi > lo:
                overlap[e.name] = overlap.get(e.name, 0.0) + (hi - lo)
        top = sorted(overlap.items(), key=lambda kv: -kv[1])[:6]
        listed.append({"at_ms": (a - first) / 1e3, "ms": (b - a) / 1e3,
                       "host": [{"op": n[:60], "ms": v / 1e3}
                                for n, v in top]})
    edges = ("0",) + tuple(f"{e:g}" for e in GAP_BINS_US) + ("inf",)
    runtime = sorted((e for e in host if e.name.startswith("cuda")
                      and e.time_range.elapsed_us() >= 20),
                     key=lambda e: e.time_range.start)
    return {"span_ms": (end - first) / 1e3, "union_ms": union / 1e3,
            "idle_ms": sum(sums),
            "gaps_by_us": {f"{lo}-{hi}": {"n": n, "ms": ms} for lo, hi, n, ms
                           in zip(edges, edges[1:], bins, sums)},
            "gaps": listed,
            "runtime_calls": [{"at_ms": (e.time_range.start - first) / 1e3,
                               "ms": e.time_range.elapsed_us() / 1e3,
                               "call": e.name} for e in runtime[:40]]}


def graph_gaps(smi):
    """One replayed GAN step (seed-0 V1 and discriminators, random 16 x
    8192 batches, TF32 convs) and one replayed flagship train step (3 x 16
    rows, L=128, T=768), each profiled with the host's activity after two
    steps: ``idle_gaps`` beside the step's wall and busy ms, one ``graph
    gaps`` line each."""
    from daft_exprt_tpu_torch.vocoder import train as vtrain

    rng = np.random.default_rng(0)
    torch.backends.cudnn.allow_tf32 = True
    gen, mpd, msd, opt_g, opt_d = gan_setup()
    gan = vtrain.make_vocoder_train_step(gen, mpd, msd, VOC_MEL_CFG, opt_g,
                                         opt_d)
    batch = {"mel": torch.from_numpy(rng.standard_normal(
        (VOC_BATCH, 80, VOC_SEGMENT // HOP)).astype(np.float32) - 5).cuda(),
        "audio": torch.from_numpy(0.3 * rng.standard_normal(
            (VOC_BATCH, VOC_SEGMENT)).astype(np.float32)).cuda()}
    hp = flagship_hparams(batch_size=16, accumulation_steps=3)
    step = make_train_step(DaftExprt(hp, seed=0), hp)
    train = train_batch(hp, rng, 128, 768)
    dropout = torch.Generator(device="cuda").manual_seed(0)
    runs = {"gan_step": lambda: gan(batch),
            "train_step": lambda: step(train, dropout, 1)}
    out = {}
    for name, run in runs.items():
        for _ in range(2):
            run()
        prof, wall_ms = profiled(run)
        report = kernel_report(prof, wall_ms, {})
        out[name] = {"card": smi, "wall_ms": wall_ms,
                     "device_busy_ms": report and report["device_busy_ms"],
                     **(idle_gaps(prof) or {})}
        print("graph gaps", name, json.dumps(out[name]), flush=True)
    return out


# data-parallel synthesis (``data_parallel``): timed rounds of each engine,
# alternating which goes first; the whole batch against the single engine
# by relative L2 at the audio-serving phase's bound for a whole bf16 path
# run at another shape (STREAM_REL_TOL): a shard's rows are not bit-equal
# across batch sizes (K1's conv2 splits over C by B, cuBLAS picks by M),
# and a float32 sum in another order flips bf16 roundings that travel down
# the 12 blocks and the decoder (3.8e-3 B=4 against B=8 on an NVIDIA H100
# 80GB HBM3 at 700 W); the control, the same rows one place out of order,
# must exceed it; the trace's device ops against the profiler's own device
# time
DP_ROUNDS = 10
DP_MEL_REL_TOL = STREAM_REL_TOL
DP_TRACE_REL_TOL = 0.05
DP_LINES = ["{HH AH0 L OW1} {W ER1 L D}.", "{G UH1 D} {M AO1 R N IH0 NG}.",
            "{S W IY1 T} {W ER1 L D}!",
            "{DH IH1 S} {IH1 Z} {AH0} {T EH1 S T}."]


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [np.asarray(tree)]


def _mel_agreement(got, want):
    return {"rel_l2": _np_rel_l2(got, want),
            "max_abs_err": float(np.abs(got - want).max()),
            "rel_l2_limit": DP_MEL_REL_TOL}


def _bit_equal(got, want, what):
    g, w = _leaves(got), _leaves(want)
    if len(g) != len(w) or not all(
            a.shape == b.shape and np.array_equal(a, b) for a, b in zip(g, w)):
        raise AssertionError(f"{what}: not bit-equal")


def _replica_caches(engine):
    """A mesh engine's replica caches where ``_counts`` reads an
    engine's."""
    return [types.SimpleNamespace(graphs=c) for c in engine.replica_graphs]


def _mesh_run(engine, inputs, what, hp):
    """engine.run with K1's counters around it (at the wrappers plus
    those derived from the replicas' replays): 12 launches a replica pass,
    all on the tensor-core instance."""
    passes = engine.passes
    out, (k1, k1_tc) = counted(
        lambda: engine.run(inputs, "add", want_weights=True),
        *_replica_caches(engine))
    n = engine.passes - passes
    if k1 != fft_blocks(hp) * n or k1_tc != k1 or n == 0:
        raise AssertionError(f"{what}: K1 {k1} ({k1_tc} tensor-core) for "
                             f"{n} replica passes")
    return out, {"replica_passes": n, "k1": k1, "k1_tensor_core": k1_tc}


def data_parallel(smi):
    """Phase 12: batched mel synthesis on a mesh at flagship width (config
    defaults, bf16, seed-0 weights with the duration head pinned, B=8,
    L=64, reference T=512): (a) a mesh of every visible card against the
    single engine at the full frame budget, bit for bit; (b) two replicas
    on cuda:0 at B=8 and at B=5 (padded to 6, cropped to 5), each shard
    bit-equal to the single engine on its rows, the whole batch within
    ``DP_MEL_REL_TOL`` of the single engine's, and both timed; (c)
    ``cli.synthesize --data_parallel`` against the same command without
    it; (d) ``graft_entry.entry()`` and ``dryrun_multichip(1)`` (an NCCL
    group of one); (e) after them, the single engine's request profiled
    (``traced_request``), then its replay bit-equal to its first run."""
    from concurrent.futures import ThreadPoolExecutor

    from daft_exprt_tpu_torch import graft_entry
    from daft_exprt_tpu_torch.inference.graphs import to_host
    from daft_exprt_tpu_torch.parallel.mesh import make_mesh, shard_rows

    t_phase = time.perf_counter()
    hp = flagship_hparams()
    model = DaftExprt(hp, seed=0)
    pin_durations(model)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    single = InferenceEngine(model, None, hp,
                             out_frame_buckets=[hp.max_frames])
    inputs = make_request(hp, np.random.default_rng(12), 8, 64, 512, 1.0,
                          "add")
    small = tuple(x[:5] for x in inputs)

    def mesh_engine(devices):
        return InferenceEngine(DaftExprt(hp, seed=1), state, hp,
                               mesh=make_mesh(devices=devices))

    every_card, two = mesh_engine(None), mesh_engine(["cuda:0", "cuda:0"])
    want = single.run(inputs, "add")
    check_outputs(want, single, 8)
    for engine in (every_card, two):  # warm-up: builds, cuDNN algorithms
        engine.run(inputs, "add")
    report = {"card": smi, "mesh": [str(d) for d in every_card.mesh],
              "frames": hp.max_frames}

    # the phase's main path: the mesh runs (each replica pass a graph
    # replay but B=5's first), counters from zero
    fused_fft_block.launches = fused_fft_block.tc_launches = 0
    got, report["every_card_launches"] = _mesh_run(every_card, inputs,
                                                   "mesh of every card", hp)
    _bit_equal(got, want, f"mesh of {len(every_card.mesh)} card(s)")
    got, report["two_replica_launches"] = _mesh_run(two, inputs,
                                                    "two replicas", hp)
    got5, report["two_replica_b5_launches"] = _mesh_run(
        two, small, "two replicas at B=5", hp)
    report["main_path_launches"] = {
        "k1": sum(report[k]["k1"] for k in (
            "every_card_launches", "two_replica_launches",
            "two_replica_b5_launches")),
        "k1_tensor_core": sum(report[k]["k1_tensor_core"] for k in (
            "every_card_launches", "two_replica_launches",
            "two_replica_b5_launches")),
        "k1_at_the_wrappers": fused_fft_block.launches}
    # the replicas' replays against the same replicas run eagerly, and
    # their K1 launches in the device's trace
    for cache in two.replica_graphs:
        cache.cuda = False
    try:
        eager = two.run(inputs, "add")
    finally:
        for cache in two.replica_graphs:
            cache.cuda = True
    _bit_equal(got, eager, "two replicas replayed against eager")
    replayed = kernel_report(*profiled(lambda: two.run(inputs, "add")),
                             K1_GROUPS)
    check_on_device(replayed, {"k1": 2 * fft_blocks(hp)},
                    "two replicas' replayed passes")
    report["replicas"] = {
        "graphs": [len(c) for c in two.replica_graphs],
        "captures": [c.captures for c in two.replica_graphs],
        "capture_seconds": [c.capture_seconds for c in two.replica_graphs],
        "pool_bytes": [c.pool_bytes() for c in two.replica_graphs],
        "replayed_equals_eager": True,
        "on_device": replayed["on_device"],
        "device_busy_ms": replayed["device_busy_ms"],
        "idle_share": replayed["idle_share"]}
    print("data parallel: replicas", json.dumps(report["replicas"]),
          flush=True)
    for batch, out, B in ((inputs, got, 8), (small, got5, 5)):
        if out[1][0].shape[0] != B:
            raise AssertionError(f"two replicas at B={B}: "
                                 f"{out[1][0].shape[0]} rows")
        shards = shard_rows(batch, 2)
        rows = shards[0][0].shape[0]
        for i, shard in enumerate(shards):
            lo, hi = i * rows, min((i + 1) * rows, B)
            ref = single.run(shard, "add")
            _bit_equal([x[lo:hi] for x in _leaves(out)],
                       [x[:hi - lo] for x in _leaves(ref)],
                       f"two replicas at B={B}, shard {i}")
    if not (np.array_equal(got[0][1], want[0][1])
            and np.array_equal(got[1][1], want[1][1])):
        raise AssertionError("two replicas and one engine disagree on "
                             "durations at B=8")
    agree = report["two_replica_vs_single"] = _mel_agreement(got[1][0],
                                                             want[1][0])
    agree["control_rel_l2"] = _np_rel_l2(np.roll(got[1][0], 1, axis=0),
                                         want[1][0])
    if not agree["rel_l2"] <= DP_MEL_REL_TOL < agree["control_rel_l2"]:
        raise AssertionError(f"two replicas vs one engine at B=8: {agree}")

    # wall ms of one B=8 request (host copies included), in alternating
    # rounds: one engine; two replicas' replays launched from this thread
    # (engine.run); timed only, the same replays launched from a worker
    # thread a replica (the engine's layout until its passes were graphs),
    # with the same copies to the host
    workers = ThreadPoolExecutor(2, thread_name_prefix="replica")

    def threads():
        shards = shard_rows(inputs, 2)
        launched = [f.result() for f in [
            workers.submit(two._replica_pass, i, shard, "add")
            for i, shard in enumerate(shards)]]
        host = []
        for stream, (enc, dec, _) in zip(two._streams, launched):
            with torch.cuda.stream(stream):
                host.append(to_host((enc, dec, None)))
        return host

    runs = {"single": lambda: single.run(inputs, "add", want_weights=False),
            "two_replicas": lambda: two.run(inputs, "add",
                                            want_weights=False),
            "two_replicas_threads": threads}
    times = {k: [] for k in runs}
    for r in range(DP_ROUNDS):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            times[name].append((time.perf_counter() - t0) * 1e3)
    workers.shutdown()
    report["wall_ms"] = {k: float(np.median(v)) for k, v in times.items()}
    report["wall_ms_rounds"] = times
    print(f"data parallel: B=8 request at {hp.max_frames} frames, median of "
          f"{DP_ROUNDS} alternating rounds: two replicas on cuda:0, "
          f"replays from one thread "
          f"{report['wall_ms']['two_replicas']:.3f} ms (the same replays "
          f"from a thread each {report['wall_ms']['two_replicas_threads']:.3f}"
          f" ms), one engine {report['wall_ms']['single']:.3f} ms -- {smi}",
          flush=True)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        # (c) the CLI with and without --data_parallel: its engines and
        # their graphs come and go
        mels = synthesize_twice(*synthesis_cli_inputs(tmp, model, hp), tmp)
        one, dp = mels["single"], mels["data_parallel"]
        if len(one) != len(DP_LINES) or list(one) != list(dp) or any(
                one[k].shape != dp[k].shape for k in one):
            raise AssertionError("synthesize --data_parallel wrote other "
                                 "files or frame counts than without it")
        report["cli"] = {"files": len(one),
                         "frames": [one[k].shape[1] for k in one],
                         **_mel_agreement(np.concatenate(
                             [dp[k] for k in one], 1), np.concatenate(
                             [one[k] for k in one], 1))}
        if not report["cli"]["rel_l2"] <= DP_MEL_REL_TOL:
            raise AssertionError(f"synthesize --data_parallel against the "
                                 f"run without it: {report['cli']}")

        # (d) graft_entry: the one-card check and the dry run
        fn, args = graft_entry.entry()
        enc, (mel, lens, overflow), weights = fn(*args)
        torch.cuda.synchronize()
        if mel.shape != (8, hp.n_mel_channels, 512) or not all(
                torch.isfinite(t).all() for t in (*enc, mel, weights)):
            raise AssertionError(f"graft_entry.entry(): mel {mel.shape}, "
                                 f"non-finite outputs")
        t0 = time.perf_counter()
        loss = graft_entry.dryrun_multichip(1)
        report["graft_entry"] = {"entry_mel_shape": list(mel.shape),
                                 "entry_frames": lens.tolist(),
                                 "dryrun_loss": loss,
                                 "dryrun_s": time.perf_counter() - t0}

        # (e) the device trace of one mel request, a replay after the
        # CLI's engines came and went and the dry run used the card
        report["trace"] = traced_request(single, inputs, tmp, hp)
        print("trace", json.dumps(report["trace"]), flush=True)

        # the same replay unprofiled
        _bit_equal(single.run(inputs, "add"), want, "one engine "
                   "replayed after the CLI, graft_entry and the dry run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t_phase
    print("data parallel", json.dumps({k: v for k, v in report.items()
                                       if k != "wall_ms_rounds"}),
          flush=True)
    return report


def synthesis_cli_inputs(tmp, model, hp):
    """``cli.synthesize``'s (checkpoint, style bank, text file) under
    ``tmp``: ``model``'s reference checkpoint, two of the repo's style
    wavs, ``DP_LINES``."""
    from daft_exprt_tpu_torch.checkpoint import save_reference_checkpoint

    ckpt = tmp / "DaftExprt_seed0.pt"
    save_reference_checkpoint(str(ckpt), model, hp)
    bank = tmp / "bank"
    bank.mkdir()
    for src in sorted(STYLE_BANK.glob("*.wav"))[:2]:
        shutil.copy(src, bank / src.name)
    text = tmp / "lines.txt"
    text.write_text("\n".join(DP_LINES) + "\n")
    return ckpt, bank, text


def synthesize_twice(ckpt, bank, text, tmp):
    """``cli.synthesize.main`` in this process without and with
    ``--data_parallel`` (each builds its engines and drops them, graphs
    and all): {"single" | "data_parallel": {file: mel}}."""
    from daft_exprt_tpu_torch.cli import synthesize

    mels = {}
    for label, extra in (("single", []), ("data_parallel",
                                          ["--data_parallel"])):
        out = tmp / label
        synthesize.main(["--checkpoint", str(ckpt), "--text_file",
                         str(text), "--style_bank", str(bank),
                         "--output_dir", str(out), "--batch_size", "4",
                         "--no_griffin_lim", *extra])
        mels[label] = {p.name: np.load(p)["mel_spec"]
                       for p in sorted(out.glob("*.npz"))}
    return mels


def traced_request(engine, inputs, tmp, hp, cuda=True, export=True,
                   strict=True):
    """One mel request of ``engine`` (its passes replays) under the
    profiler. With ``cuda`` (the device's activity recorded), K1's
    launches counted on the device, 12 a pass; with ``export`` too, the
    trace written as Chrome JSON under ``tmp`` and read back:
    ``aggregate_device_trace``'s device ms against the profiler's own
    (within ``DP_TRACE_REL_TOL``) and ``graph_launch_census`` (every
    graph launch with its device operations, K1's in them). Without
    ``strict`` an incomplete trace is reported (``complete``), not
    raised. :return: the readings"""
    from daft_exprt_tpu_torch.utils import (aggregate_device_trace,
                                            graph_launch_census)

    passes = engine.passes

    def request():
        with torch.profiler.record_function("mel_request"):
            engine.run(inputs, "add", want_weights=False)

    prof, wall_ms = profiled(request, cuda=cuda)
    out = {"wall_ms": wall_ms}
    if not cuda:
        return out
    own = kernel_report(prof, wall_ms, K1_GROUPS)
    want = {"k1": fft_blocks(hp) * (engine.passes - passes)}
    out.update(profiler_device_ms=own and own["device_busy_ms"],
               graph_launches=own and own["graph_launches"],
               k1_on_device=own and own["on_device"]["k1"], k1_want=want["k1"])
    out["complete"] = out["k1_on_device"] == want["k1"]
    if export:
        trace_dir = Path(tempfile.mkdtemp(prefix="trace_", dir=tmp))
        prof.export_chrome_trace(str(trace_dir / "request.json"))
        ops, total = aggregate_device_trace(str(trace_dir))
        _, mod_total = aggregate_device_trace(str(trace_dir),
                                              level="modules")
        _, excl_total = aggregate_device_trace(str(trace_dir),
                                               level="ops_exclusive")
        census = graph_launch_census(str(trace_dir), ON_DEVICE)
        out.update(ops_ms=total, ops_exclusive_ms=excl_total,
                   modules_ms=mod_total,
                   top5=[{"op": name[:90], "ms": ms}
                         for name, ms in ops.most_common(5)],
                   census={k: census[k] for k in (
                       "graph_launches", "empty_launches", "complete",
                       "counts", "launches")})
        out["complete"] &= census["complete"]
        if own is None or not abs(total - own["device_busy_ms"]) \
                <= DP_TRACE_REL_TOL * own["device_busy_ms"]:
            raise AssertionError(f"aggregate_device_trace ops {total} ms "
                                 f"against the profiler's {own}")
        if strict and not census["complete"]:
            raise AssertionError(f"the traced mel request: an incomplete "
                                 f"trace, {census}")
    if strict:
        check_on_device(own, want, "the traced mel request")
    return out


# ``--profiled-churn``: the sequence after which a profiled replay faulted
# in cudaGraphLaunch (ROADMAP fault 8), each step an ingredient a variant
# can leave out (``CHURN_VARIANTS``: "full", "no_<step>"); a process runs
# ``CHURN_ROUNDS`` rounds (the faults came in a process's second) with
# ``CHURN_PARALLEL`` processes on the card at a time
CHURN_STEPS = ("prior", "churn", "entry", "dryrun", "export",
               "cuda_activity")
CHURN_VARIANTS = {"full": CHURN_STEPS,
                  **{f"no_{step}": tuple(s for s in CHURN_STEPS if s != step)
                     for step in CHURN_STEPS}}
# settings a variant may add ("<variant>+<setting>"): Kineto's teardown of
# CUPTI at the end of each profiler session off (the process's
# environment), or every captured graph destroyed once instantiated
# (``drop_captured_graphs``: torch's default, the port's before it kept
# them)
CHURN_SETTINGS = {"teardown_off": {"TEARDOWN_CUPTI": "0"},
                  "template_dropped": {}}


def drop_captured_graphs():
    """In this process, every ``torch.cuda.CUDAGraph`` destroys its
    captured graph once instantiated (torch's default), whatever
    ``GraphCache`` asks: the control that reproduces the port before it
    kept them (``inference/graphs.py``)."""

    made = torch.cuda.CUDAGraph

    def dropped(keep_graph=False):
        graph = made(False)
        # capture_end instantiates it and destroys the captured graph
        graph.instantiate = lambda: None
        return graph

    torch.cuda.CUDAGraph = dropped
CHURN_ROUNDS = 2
CHURN_PARALLEL = 5


def churn_round(steps, smi):
    """One round of the sequence after which a profiled replay faulted
    (``steps``: the ingredients of ``CHURN_STEPS`` it runs): (1) a single
    engine at flagship width (bf16, seed-0 weights, durations pinned, B=8,
    L=64) captures its mel graph and, with "prior", a two-replica mesh
    engine's replays are profiled, as the data-parallel phase does; (2)
    "churn": ``cli.synthesize`` builds and drops its engines twice; (3)
    "entry": ``graft_entry.entry()``; (4) "dryrun":
    ``dryrun_multichip(1)``; (5) the single engine's request profiled
    (``traced_request``, with "cuda_activity" and "export"), then
    unprofiled, bit-equal to its first run. The round's engines are
    dropped with it. :return: its readings"""
    from daft_exprt_tpu_torch import graft_entry
    from daft_exprt_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    hp = flagship_hparams()
    model = DaftExprt(hp, seed=0)
    pin_durations(model)
    single = InferenceEngine(model, None, hp,
                             out_frame_buckets=[hp.max_frames])
    inputs = make_request(hp, np.random.default_rng(12), 8, 64, 512, 1.0,
                          "add")
    want = single.run(inputs, "add")
    _bit_equal(single.run(inputs, "add"), want, "the single engine's "
               "first replay")
    row = {"card": smi, "steps": list(steps)}
    if "prior" in steps:
        state = {k: v.clone() for k, v in model.state_dict().items()}
        two = InferenceEngine(DaftExprt(hp, seed=1), state, hp,
                              mesh=make_mesh(devices=["cuda:0", "cuda:0"]))
        two.run(inputs, "add")
        two.run(inputs, "add")
        report = kernel_report(*profiled(lambda: two.run(inputs, "add")),
                               K1_GROUPS)
        check_on_device(report, {"k1": 2 * fft_blocks(hp)},
                        "two replicas' replayed passes")
        del two, state
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_churn_"))
    try:
        if "churn" in steps:
            synthesize_twice(*synthesis_cli_inputs(tmp, model, hp), tmp)
        if "entry" in steps:
            fn, args = graft_entry.entry()
            fn(*args)
            torch.cuda.synchronize()
            del fn, args
        if "dryrun" in steps:
            graft_entry.dryrun_multichip(1)
        row["trace"] = traced_request(single, inputs, tmp, hp,
                                      cuda="cuda_activity" in steps,
                                      export="export" in steps,
                                      strict=False)
        _bit_equal(single.run(inputs, "add"), want, "the single engine "
                   "replayed after the profiled request")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["seconds"] = time.perf_counter() - t0
    return row


CHURN_SCRIPT = """
import faulthandler, json, sys, torch, chip_smoke as cs
faulthandler.enable()
# a native stack of a fault, printed before faulthandler's Python stacks
cs._build.load_library("segv_backtrace").install_segv_backtrace()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
steps, rounds, smi = cs.CHURN_VARIANTS[sys.argv[1]], int(sys.argv[2]), sys.argv[3]
if sys.argv[4] == "template_dropped":
    cs.drop_captured_graphs()
for i in range(rounds):
    row = cs.churn_round(steps, smi)
    print("CHURN", json.dumps({"round": i, **row}), flush=True)
"""


def _native_stack(stderr, frames=24):
    """The lines of ``segv_backtrace``'s report in a process's stderr (the
    fault's place, then ``frames`` frames by library)."""
    lines = stderr.splitlines()
    at = [i for i, ln in enumerate(lines)
          if ln.startswith("native stack: SIGSEGV")]
    if not at:
        return []
    out = lines[at[0]:at[0] + 2]
    if "native stack: frames by library" in lines:
        k = lines.index("native stack: frames by library")
        below = lines[k + 1:]
        n = next((i for i, ln in enumerate(below)
                  if not ln.startswith("  ")), len(below))
        out += [lines[k]] + below[:min(n, frames)]
    return out


def profiled_churn(n, specs=("full",), rounds=CHURN_ROUNDS,
                   parallel=CHURN_PARALLEL) -> int:
    """``--profiled-churn N [VARIANT[:COUNT] ...]``: ``churn_round``
    ``rounds`` times in each of N (or COUNT) fresh processes a variant
    (default "full"; "<variant>+<setting>" adds a setting of
    ``CHURN_SETTINGS``), ``parallel`` processes on the card at a time,
    the variants' processes interleaved, each under faulthandler with
    ``csrc/segv_backtrace.cu``'s handler before it. Prints each process's
    exit code and rounds (a fault: its native stack and the end of its
    Python stacks), then one ``profiled churn`` line a variant with the
    counts: processes, faults, other failures, rounds run, traces that
    lacked a replay's kernels. Exit code 1 if any process faulted or
    failed or any trace was incomplete."""
    from concurrent.futures import ThreadPoolExecutor

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    _build.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, gdb "
          f"{shutil.which('gdb')}, TEARDOWN_CUPTI "
          f"{os.environ.get('TEARDOWN_CUPTI')}", flush=True)
    variants = []
    for spec in specs:
        name, _, count = spec.partition(":")
        steps, _, setting = name.partition("+")
        if steps not in CHURN_VARIANTS \
                or (setting and setting not in CHURN_SETTINGS):
            raise ValueError(f"unknown variant {spec!r}: "
                             f"{sorted(CHURN_VARIANTS)} "
                             f"[+{sorted(CHURN_SETTINGS)}]")
        variants.append((name, steps, setting, int(count or n)))
    tasks = [(v, i) for i in range(max(v[3] for v in variants))
             for v in variants if i < v[3]]
    counts = {name: {"variant": name, "processes": 0, "faulted": 0,
                     "failed": 0, "rounds": 0, "incomplete_traces": 0,
                     "fault_rounds": [], "exit_codes": {}}
              for name, *_ in variants}
    lock = threading.Lock()

    def one(task):
        (name, steps, setting, _), i = task
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", CHURN_SCRIPT, steps, str(rounds), smi,
             setting or "-"], cwd=ROOT, capture_output=True, text=True,
            timeout=1200, env={**os.environ,
                               **CHURN_SETTINGS.get(setting, {})})
        rows = [json.loads(ln[6:]) for ln in run.stdout.splitlines()
                if ln.startswith("CHURN ")]
        faulted = run.returncode in (-11, 139)
        with lock:
            c = counts[name]
            c["processes"] += 1
            c["rounds"] += len(rows)
            c["incomplete_traces"] += sum(
                r["trace"].get("complete") is False for r in rows)
            code = str(run.returncode)
            c["exit_codes"][code] = c["exit_codes"].get(code, 0) + 1
            if faulted:
                c["faulted"] += 1
                c["fault_rounds"].append(len(rows))
            elif run.returncode:
                c["failed"] += 1
            print(f"churn process {name} {i}: exit code {run.returncode} "
                  f"in {time.perf_counter() - t0:.1f} s, rounds "
                  + json.dumps([{"round": r["round"],
                                 "seconds": r["seconds"],
                                 **{k: r["trace"].get(k) for k in (
                                     "graph_launches", "k1_on_device",
                                     "complete", "profiler_device_ms",
                                     "ops_ms")},
                                 "census": {k: r["trace"].get("census", {})
                                            .get(k) for k in (
                                     "graph_launches", "empty_launches",
                                     "counts")}} for r in rows]),
                  flush=True)
            if faulted:
                for ln in _native_stack(run.stderr):
                    print(f"  {ln}", flush=True)
                print(run.stderr[-2500:], flush=True)
            elif run.returncode:
                print(run.stdout[-2000:], run.stderr[-4000:], flush=True)

    with ThreadPoolExecutor(parallel) as pool:
        list(pool.map(one, tasks))
    bad = 0
    for c in counts.values():
        print("profiled churn", json.dumps({"card": smi, **c}), flush=True)
        bad += c["faulted"] + c["failed"] + c["incomplete_traces"]
    return 1 if bad else 0


def profiled_films(n, smi) -> int:
    """``--profiled-films N [template_dropped]``: the engine-graphs phase's
    audio request with new styles (B=8, L=64, reference T=512, bucket 512,
    a seeded V1 generator) profiled N times in this process, each request
    with styles never seen (so that the FiLM cache misses and runs its
    prosody-encoder batch), every pass a replay. As in the smoke, the
    audio engine captures its graphs after a profiler session, and before
    each request another engine captures a mel graph and is dropped with
    it. For each trace, side by side: K1's and
    K5's kernels on the device, the host's ``cudaGraphLaunch`` calls in the
    profiler's events, the exported trace's ``graph_launch_census`` (each
    launch with its device operations and K1/K5 kernels) and the launches
    each replayed capture recorded (``_Entry.recorded``: the FiLM batch's
    graph, the audio pass's). One ``profiled films`` line a request and
    the counts; exit code 1 if a trace lacks a launch's kernels."""
    from daft_exprt_tpu_torch.utils import graph_launch_census

    hp = flagship_hparams()
    model = DaftExprt(hp, seed=0)
    pin_durations(model)
    device = next(model.parameters()).device
    profiled(lambda: torch.ones(8, device=device).sum())
    aeng = InferenceEngine(model, None, hp)
    aeng.attach_vocoder(HiFiGanGenerator(seed=0))
    rng = np.random.default_rng(15)
    inputs, other = (make_request(hp, rng, 8, 64, 512, 0.25, "add")
                     for _ in range(2))
    aeng.run_cached_to_audio(inputs, "add", [(f"seen_{b}", b)
                                             for b in range(8)])
    recorded = {str(key): dict(zip(LAUNCH_NAMES, e.recorded))
                for (key, _), e in aeng.graphs.entries.items()}
    groups = {**K1_GROUPS, "k5_ms": K5_KERNELS}
    tally = {"requests": n, "film_batches": 0, "complete": 0,
             "k1_as_recorded": 0, "k5_as_recorded": 0}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_films_"))
    try:
        for i in range(n):
            churn = InferenceEngine(model, None, hp,
                                    out_frame_buckets=[hp.max_frames])
            churn.run(inputs, "add", want_weights=False)
            churn.run(inputs, "add", want_weights=False)
            del churn
            before = _counts(aeng)
            passes, films = aeng.passes, aeng.film_batches
            keys = [(f"films_{i}_{b}", b) for b in range(8)]
            prof, wall_ms = profiled(
                lambda: aeng.run_cached_to_audio(other, "add", keys))
            report = kernel_report(prof, wall_ms, groups)
            path = tmp / f"request_{i}.json"
            prof.export_chrome_trace(str(path))
            census = graph_launch_census(str(path), ON_DEVICE)
            path.unlink()
            got = _launches(before, aeng)
            passes, films = aeng.passes - passes, aeng.film_batches - films
            dev = (report or {}).get("on_device", {})
            row = {"request": i, "passes": passes, "film_batches": films,
                   "k1_on_device": dev.get("k1"),
                   "k5_on_device": dev.get("k5"),
                   "k1_replayed_recorded": got["k1_replayed"],
                   "k5_replayed_recorded": got["k5_replayed"],
                   "graph_launches_host": (report or {}).get(
                       "graph_launches"),
                   "census": {k: census[k] for k in (
                       "graph_launches", "empty_launches", "counts",
                       "launches")}}
            tally["film_batches"] += films
            tally["complete"] += census["complete"]
            tally["k1_as_recorded"] += dev.get("k1") == got["k1_replayed"]
            tally["k5_as_recorded"] += dev.get("k5") == got["k5_replayed"]
            print("profiled films", json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("profiled films: recorded by capture", json.dumps(recorded),
          flush=True)
    print("profiled films", json.dumps({"card": smi, **tally}), flush=True)
    return 0 if tally["complete"] == tally["k1_as_recorded"] \
        == tally["k5_as_recorded"] == n else 1


AB_TRAIN = """
import json, torch, chip_smoke as cs
cs._build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ab = {}
for name, hp, conv_ff in (
        ("", cs.flagship_hparams, "conv_ff_train"),
        ("wide_", cs.wide_head_hparams, "conv_ff_train_blocked")):
    r, _ = cs.train(hp(batch_size=16, accumulation_steps=3), conv_ff,
                    warmup=3, steps=10)
    ab.update({f"{name}step_ms": r["step_ms"],
               f"{name}device_busy_ms": r["profile"]
               and r["profile"]["device_busy_ms"],
               f"{name}k2_tensor_maps": r.get("k2_tensor_maps")})
print("AB", json.dumps(ab))
"""


# K1's wrapper at every K1_SHAPES shape (bf16; CUDA-event ms, device ms
# summed by kernel and as the union of the kernels' intervals), one
# replayed flagship mel request (host ms of 20, profiled device busy and
# K1's device ms) and one replayed audio request (the same, with K5's);
# written with only what the parent's chip_smoke.py has
AB_K1 = """
import json, time, numpy as np, torch, chip_smoke as cs
from daft_exprt_tpu_torch.ops.fft_block import fused_fft_block
cs._build.build([n for n in ("fft_block", "fft_block_tc", "mrf_vocoder",
                             "mrf_vocoder_tc")
                 if (cs._build.SRC_DIR / (n + ".cu")).exists()])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ab = {}


def union_ms(fn, reps=10):
    fn()
    prof, _ = cs.profiled(lambda: [fn() for _ in range(reps)])
    spans = sorted((e.time_range.start, e.time_range.end) for e in
                   prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / 1e3 / reps if spans else None


gen = torch.Generator().manual_seed(0)
rng = np.random.default_rng(0)
for name, B, T, E_, H, C_, with_film in cs.K1_SHAPES:
    lens = rng.integers(T // 4, T, size=B)
    lens[0], lens[-1] = T, 3
    block = cs.FFTBlock(E_, H, C_, 3)
    cs.init_parameters(block, gen)
    block = block.cuda()
    x = cs._cuda(rng.standard_normal((B, T, E_)).astype(np.float32))
    film = None
    if with_film:
        film = cs._cuda(np.concatenate(
            [1 + 0.1 * rng.standard_normal((B, E_)),
             0.1 * rng.standard_normal((B, E_))], 1).astype(np.float32))
    lengths = cs._cuda(lens.astype(np.int32))
    w = block.kernel_weights(torch.bfloat16)

    def call():
        return fused_fft_block(x, w, film, lengths, num_heads=H,
                               dot_dtype=torch.bfloat16)

    ab[name + "_ms"] = cs.cuda_ms(call)
    ab[name + "_device_ms"] = cs.device_ms(call)
    ab[name + "_device_union_ms"] = union_ms(call)
# None where the profiler missed a window (device_ms takes one again once)
parts = [ab[n + "_device_ms"] for n in ("prosody_encoder", "phoneme_encoder",
                                         "frame_decoder")]
ab["mel_pass_k1_device_ms"] = None if None in parts else 4 * sum(parts)


def timed(run, n=20):
    for _ in range(3):
        run()
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), min(ms)


hp = cs.flagship_hparams()
model = cs.DaftExprt(hp, seed=0)
cs.pin_durations(model)
engine = cs.InferenceEngine(model, None, hp, bucket_policy="measure")
inputs = cs.make_request(hp, np.random.default_rng(1), 8, 64, 512, 0.6, "add")


def mel():
    return engine.run(inputs, "add", want_weights=False)


ab["mel_request_ms_median"], ab["mel_request_ms_min"] = timed(mel)
prof = cs.profile_kernels(mel, cs.K1_GROUPS)
ab["mel_device_busy_ms"] = prof and prof["device_busy_ms"]
ab["mel_k1_device_ms"] = prof and prof["k1_ms"]
engine.attach_vocoder(cs.HiFiGanGenerator(seed=0))
inputs = cs.make_request(hp, np.random.default_rng(11), 8, 64, 512, 0.25,
                         "add")
keys = [(f"style_{i}", i) for i in range(8)]


def audio():
    return engine.run_cached_to_audio(inputs, "add", keys)


ab["audio_request_ms_median"], ab["audio_request_ms_min"] = timed(audio)
prof = cs.profile_kernels(audio, {"k1_ms": cs.K1_GROUPS["k1_ms"],
                                  "k5_ms": cs.K5_KERNELS})
ab["audio_device_busy_ms"] = prof and prof["device_busy_ms"]
ab["audio_k1_device_ms"] = prof and prof["k1_ms"]
ab["audio_k5_device_ms"] = prof and prof["k5_ms"]
print("AB", json.dumps(ab))
"""
AB_SERVE = """
import json, time, numpy as np, torch, chip_smoke as cs
cs._build.build([n for n in ("fft_block", "fft_block_tc")
                 if (cs._build.SRC_DIR / (n + ".cu")).exists()])
hp = cs.flagship_hparams()
model = cs.DaftExprt(hp, seed=0)
cs.pin_durations(model)
engine = cs.InferenceEngine(model, None, hp, bucket_policy="measure")
inputs = cs.make_request(hp, np.random.default_rng(1), 8, 64, 512, 0.6, "add")

def run():
    return engine.run(inputs, "add", want_weights=False)

for _ in range(3):
    run()
ms = []
for _ in range(20):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    ms.append((time.perf_counter() - t0) * 1e3)
prof = cs.profile_kernels(run, {})
print("AB", json.dumps({"request_ms_median": float(np.median(ms)),
                        "request_ms_min": min(ms),
                        "device_busy_ms": prof and prof["device_busy_ms"]}))
"""
# K2's forward and backward wrappers as check_k2 times them (bf16, the
# inputs of check_k2's timed shapes from one seed, rates 0 and 0.1; the
# backward takes what the forward returned): CUDA-event and device ms
AB_K2 = """
import json, numpy as np, torch, chip_smoke as cs
from daft_exprt_tpu_torch.ops.attention_train import (
    attention_backward_cuda, attention_forward_cuda)
cs._build.build(["attention_train"])
rng = np.random.default_rng(3)
rows = []
for name, B, T, H, lens, width in cs.K2_SHAPES:
    if name not in cs.K2_TIMED:
        continue
    lens = rng.integers(T // 2, T, size=B)
    lens[0] = T
    lengths = cs._cuda(lens.astype(np.int32))
    seeds = cs._cuda(rng.integers(-2 ** 31, 2 ** 31, size=B).astype(np.int32))
    q, k, v = (cs._cuda(rng.standard_normal((B, T, width)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    g = cs._cuda(rng.standard_normal((B, T, width)).astype(np.float32))
    for rate in cs.RATES:
        args = (lengths, seeds, H, rate, torch.bfloat16)
        saved = attention_forward_cuda(q, k, v, *args)[1]

        def fwd():
            return attention_forward_cuda(q, k, v, *args)

        def bwd():
            return attention_backward_cuda(q, k, v, g, lengths, seeds, saved,
                                           H, rate, torch.bfloat16)
        rows.append({"shape": name, "rate": rate, "fwd_ms": cs.cuda_ms(fwd),
                     "bwd_ms": cs.cuda_ms(bwd),
                     "fwd_device_ms": cs.device_ms(fwd),
                     "bwd_device_ms": cs.device_ms(bwd)})
print("AB", json.dumps(rows))
"""
# K5 as the serving path runs it: the wrapper at the three V1 stage shapes
# of a B=8, bucket-512 vocode pass (inputs 0.5 x a normal draw, seed 8,
# the same in both checkouts), then one replayed audio request at
# flagship width (B=8, L=64, reference T=512, bucket 512, the styles
# cached after the first pass) with a seeded V1 generator, and one
# replayed stream window
AB_K5 = """
import json, time, numpy as np, torch, chip_smoke as cs
from daft_exprt_tpu_torch.ops.mrf_vocoder import fused_mrf
from daft_exprt_tpu_torch.vocoder.streaming import StreamingVocoder
cs._build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
gen = cs.HiFiGanGenerator(seed=0)
rng = np.random.default_rng(8)
rates = gen.cfg["upsample_rates"]
ab = {}
for stage in (1, 2, 3):
    program = gen.mrf_programs()[stage]
    C = program.biases.shape[1]
    N = cs.SERVE_BUCKET * int(np.prod(rates[:stage + 1]))
    x = cs._cuda((0.5 * rng.standard_normal((8, N, C))).astype(np.float32))
    ab[f"C{C}_ms"] = cs.cuda_ms(lambda: fused_mrf(x, program))
    ab[f"C{C}_device_ms"] = cs.device_ms(lambda: fused_mrf(x, program), reps=5)
ab["pass_device_ms"] = sum(ab[f"C{C}_device_ms"] for C in (128, 64, 32))
hp = cs.flagship_hparams()
model = cs.DaftExprt(hp, seed=0)
cs.pin_durations(model)
engine = cs.InferenceEngine(model, None, hp)
engine.attach_vocoder(gen)
rng = np.random.default_rng(11)
inputs = cs.make_request(hp, rng, 8, 64, 512, 0.25, "add")
keys = [(f"style_{i}", i) for i in range(8)]

def request():
    return engine.run_cached_to_audio(inputs, "add", keys)

def timed(run, n=20):
    for _ in range(3):
        run()
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), min(ms)

ab["audio_request_ms_median"], ab["audio_request_ms_min"] = timed(request)
prof = cs.profile_kernels(request, {"k5_ms": cs.K5_KERNELS})
ab["audio_device_busy_ms"] = prof and prof["device_busy_ms"]
ab["audio_k5_device_ms"] = prof and prof["k5_ms"]
sv = StreamingVocoder(gen)
mel = np.random.default_rng(12).standard_normal(
    (gen.cfg["num_mels"], sv.window)).astype(np.float32) - 5.0
buffers = sv._buffers()

def window():
    return sv._dispatch(mel, slice(0, sv.chunk * sv.up), *buffers[0])()

ab["window_ms_median"], ab["window_ms_min"] = timed(window)
print("AB", json.dumps(ab))
"""
# the text-serving phase as a user meets a fresh server: warm-up s, each
# request's host ms (first of its shape), /stream's first audio, the four
# concurrent requests' median, and the profiled cached-style sentence
AB_TEXT = """
import json, subprocess, numpy as np, torch, chip_smoke as cs
cs._build.build()
torch.backends.cuda.matmul.allow_tf32 = False  # as main sets them
torch.backends.cudnn.allow_tf32 = False
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
r = cs.text_serving(smi)
prof = r["profile"] or {}
print("AB", json.dumps({
    "warmup_s": r["warmup_s"],
    **{q["request"] + "_ms": q["latency_ms"] for q in r["requests"]},
    "stream_ttfa_ms": r["stream"]["ttfa_ms"],
    "stream_ms": r["stream"]["latency_ms"],
    "concurrent_ms": float(np.median(r["concurrent"]["latency_ms"])),
    "profiled_sentence_wall_ms": prof.get("wall_ms"),
    "profiled_sentence_busy_ms": prof.get("device_busy_ms")}))
"""
EXTRACTION_OPS_SCRIPT = """
import json, sys
import numpy as np, torch
import chip_smoke as cs
from daft_exprt_tpu_torch.audio.io import load_wav
from daft_exprt_tpu_torch.ops import mel
torch.zeros(1, device="cuda")  # a CUDA context, as a server's process has
if sys.argv[1] == "warmed":
    mel.cpu_vector_math_ready()
wav, _ = load_wav(str(cs.STYLE_BANK / "angry_ref.wav"), target_sr=22050)
frames = mel.frame_signal(torch.as_tensor(wav)[None], 1024, 256) \\
    * mel.hann_window_on(torch.device("cpu"), 1024)
spec = torch.fft.rfft(frames, n=1024, dim=-1)

def chain():
    p, q = spec.real ** 2, spec.imag ** 2
    s = p + q + 1e-9
    return {"p": p, "q": q, "s": s, "sqrt": torch.sqrt(s)}

first = chain()
n = torch.get_num_threads()
torch.set_num_threads(1)
ref = chain()
torch.set_num_threads(n)
moved = {}
for k, v in first.items():
    d = (v - ref[k]).abs() / ref[k].abs().clamp_min(1e-30)
    if d.max() > 0:
        bad = torch.nonzero(d.reshape(-1) > 0)
        moved[k] = {"elements": int(bad.numel()), "of": d.numel(),
                    "max_rel_err": float(d.max())}
print("EXTRACTION_OPS", json.dumps({"threads": n, "moved": moved}))
"""


def extraction_ops(n: int) -> int:
    """``--extraction-processes``: the magnitude's CPU ops in ``n`` fresh
    processes, bare and after ``cpu_vector_math_ready`` in turns."""
    counts = {"bare": [0, 0], "warmed": [0, 0]}
    worst = {"bare": 0.0, "warmed": 0.0}
    for i in range(n):
        variant = ("bare", "warmed")[i % 2]
        run = subprocess.run([sys.executable, "-c", EXTRACTION_OPS_SCRIPT,
                              variant], cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("EXTRACTION_OPS ")]
        if run.returncode != 0 or not lines:
            print(f"extraction process {i} failed: {run.stderr[-2000:]}",
                  flush=True)
            return 1
        row = json.loads(lines[-1].split(" ", 1)[1])
        counts[variant][0] += 1
        counts[variant][1] += bool(row["moved"])
        worst[variant] = max([worst[variant]] + [
            m["max_rel_err"] for m in row["moved"].values()])
        print("extraction process", i, variant, json.dumps(row), flush=True)
    report = {v: {"processes": c[0], "moved": c[1],
                  "max_rel_err": worst[v]} for v, c in counts.items()}
    print("extraction processes", json.dumps(report), flush=True)
    return 1 if counts["warmed"][1] else 0


# the train step alone (flagship, then wide; 16 x 3 rows at L=128,
# T=768): 3 warm-up steps, 3 rounds of 10, one profiled step
AB_STEP = """
import json, time, numpy as np, torch, chip_smoke as cs
from daft_exprt_tpu_torch.training.step import dropout_seed, make_train_step
cs._build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ab = {}
for name, make_hp in (("", cs.flagship_hparams),
                      ("wide_", cs.wide_head_hparams)):
    hp = make_hp(batch_size=16, accumulation_steps=3)
    batch = cs.train_batch(hp, np.random.default_rng(5), 128, 768)
    model = cs.DaftExprt(hp, seed=0)
    step = make_train_step(model, hp)
    gen = torch.Generator(device="cuda")

    def run(k, it0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(k):
            gen.manual_seed(dropout_seed(hp, it0 + i))
            step(batch, gen, it0 + i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k * 1e3

    run(3, 1)
    ms = [run(10, 4 + 10 * r) for r in range(3)]
    prof = cs.profile_kernels(lambda: step(batch, gen, 40), {})
    ab.update({name + "step_ms": float(np.median(ms)),
               name + "step_ms_rounds": ms,
               name + "device_busy_ms": prof and prof["device_busy_ms"],
               name + "idle_share": prof and prof["idle_share"],
               name + "graphs": len(step.graphs)})
    del model, step
print("AB", json.dumps(ab))
"""
# cli.synthesize --vocoder in this process on the text-serving phase's
# four pre-phonemized lines, three times: each call loads the generator
# afresh (a one-shot run: vocode_mels' buckets run once each)
AB_SYNTH = """
import json, shutil, tempfile
from pathlib import Path
import torch, chip_smoke as cs
from daft_exprt_tpu_torch.checkpoint import save_reference_checkpoint
cs._build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
tmp = Path(tempfile.mkdtemp(prefix="ab_synth_"))
try:
    hp = cs.flagship_hparams()
    model = cs.DaftExprt(hp, seed=0)
    cs.pin_durations(model)
    ckpt = tmp / "DaftExprt_seed0.pt"
    save_reference_checkpoint(str(ckpt), model, hp)
    del model
    voc, voc_cfg = cs.write_seed0_vocoder(tmp)
    bank, _ = cs.extract_style_bank(hp, tmp, "")
    text = tmp / "lines.txt"
    text.write_text("\\n".join(cs.TTS_BRACES) + "\\n")
    seconds = [cs.run_cli(
        ["--checkpoint", str(ckpt), "--text_file", str(text),
         "--style_bank", str(bank), "--output_dir", str(tmp / f"out{i}"),
         "--batch_size", "4", "--vocoder", str(voc),
         "--vocoder_config", str(voc_cfg)])[0] for i in range(3)]
finally:
    shutil.rmtree(tmp, ignore_errors=True)
print("AB", json.dumps({"cli_first_s": seconds[0],
                        "cli_again_s": seconds[1:]}))
"""
# previews as a user meets them, in a fresh process: a server without a
# vocoder at flagship width (warm-up s, then ``PREVIEW_STREAM`` twice,
# host ms: the first round each request the first of its shape),
# ``cli.synthesize`` with Griffin-Lim previews on the four pre-phonemized
# lines twice in this process (s each), and
# ``fine_tuning_dataset`` over the training-runtime phase's corpus with
# seed-0 flagship weights, three calls, s each (each call a first pass: a
# new graph cache a call)
AB_PREVIEW = """
import json, shutil, tempfile, time
from pathlib import Path
import numpy as np, torch, chip_smoke as cs
from chip_smoke import HOP, TTS_BRACES
from daft_exprt_tpu_torch.checkpoint import save_reference_checkpoint
from daft_exprt_tpu_torch.cli import serve as srv
from daft_exprt_tpu_torch.inference.fine_tune import fine_tuning_dataset
cs._build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
@PREVIEW_STREAM@
tmp = Path(tempfile.mkdtemp(prefix="ab_preview_"))
try:
    hp = cs.flagship_hparams()
    model = cs.DaftExprt(hp, seed=0)
    cs.pin_durations(model)
    ckpt = tmp / "DaftExprt_seed0.pt"
    save_reference_checkpoint(str(ckpt), model, hp)
    del model
    bank, _ = cs.extract_style_bank(hp, tmp, "")
    t0 = time.perf_counter()
    service = srv.SynthesisService(str(ckpt), str(bank), max_batch=8,
                                   device="cuda")
    service.warmup()
    ab = {"warmup_s": time.perf_counter() - t0,
          "first_ms": preview_stream(service, @STREAM@),
          "again_ms": preview_stream(service, @STREAM@)}
    del service
    text = tmp / "lines.txt"
    text.write_text("\\n".join(TTS_BRACES) + "\\n")
    ab["cli_griffin_lim_s"] = [cs.run_cli(
        ["--checkpoint", str(ckpt), "--text_file", str(text),
         "--style_bank", str(bank), "--output_dir", str(tmp / f"cli{i}"),
         "--batch_size", "4"])[0] for i in range(2)]
    corpus = cs.write_corpus(tmp / "corpus", n_utts=64, symbols=(64, 128),
                             frames_per_symbol=(4, 8), n_val=8, seed=0)
    hp = cs.write_experiment(tmp / "exps", "ft", corpus)
    model = cs.DaftExprt(hp, seed=0)
    cs.pin_durations(model)
    ab["fine_tuning_dataset_s"] = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fine_tuning_dataset(model, hp, corpus["dataset_dir"],
                            str(tmp / f"ft{i}"))
        torch.cuda.synchronize()
        ab["fine_tuning_dataset_s"].append(time.perf_counter() - t0)
finally:
    shutil.rmtree(tmp, ignore_errors=True)
print("AB", json.dumps(ab))
"""


# K3's and K4's wrappers (rate 0.1, bf16, the tensor-core instance on
# weights made once) at every CONV_FF_TIMED shape: CUDA-event ms, device
# ms summed by kernel and as the union of the kernels' intervals, and the
# kernels' device ms; then the flagship and the wide training step
# replayed (16 x 3 rows at L=128, T=768; 3 warm-up steps, 3 rounds of 10):
# host ms, device busy (the union of the kernels' intervals) and the
# device ms of the conv-FF instance's kernels (each checkout's
# CONV_FF_TC_KERNELS) in one profiled step
AB_CONV_FF = """
import json, time, numpy as np, torch, chip_smoke as cs
from daft_exprt_tpu_torch.ops import conv_ff_train as cft
from daft_exprt_tpu_torch.training.step import dropout_seed, make_train_step
cs._build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ab = {}


def union(prof):
    spans = sorted((e.time_range.start, e.time_range.end) for e in
                   prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / 1e3


def group_ms(prof, names):
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(k in e.key for k in names)) / 1e3


gen = torch.Generator().manual_seed(0)
rng = np.random.default_rng(0)
bf = torch.bfloat16
for name, B, T, E_, C_, _, _ in cs.K3_SHAPES + cs.K4_SHAPES:
    if name not in ("frame_rate", "symbol_rate", "wide_frame_rate",
                    "wide_symbol_rate"):
        continue
    cb = cft.plan_conv_ff(T, E_, C_, 3)
    kcb = None if cb == C_ else cb
    (w1, b1, w2, b2, ls, lb), _ = cs.conv_ff_params(gen, rng, E_, C_)
    x, g = (cs._cuda(rng.standard_normal((B, T, E_)).astype(np.float32))
            for _ in range(2))
    film = cs._cuda(np.concatenate([1 + 0.1 * rng.standard_normal((B, E_)),
                                    0.1 * rng.standard_normal((B, E_))],
                                   1).astype(np.float32))
    seeds = cs._cuda(rng.integers(-2 ** 31, 2 ** 31, size=B).astype(np.int32))
    tw = cft.tc_weights(w1, w2)
    args = (x, tw.w1, b1, tw.w2, b2, ls, lb, film, seeds)

    def fwd():
        return cft.conv_ff_forward_cuda(*args, 0.1, bf, kcb)

    def bwd():
        return cft.conv_ff_backward_cuda(*args, g, 0.1, bf, kcb,
                                         (tw.w1r, tw.w2r))

    for d, fn in (("fwd", fwd), ("bwd", bwd)):
        ab[f"{name}_{d}_ms"] = cs.cuda_ms(fn)
        ab[f"{name}_{d}_device_ms"], ks = cs.device_ms(fn, breakdown=True)
        ab[f"{name}_{d}_kernels"] = ks and {k["kernel"]: k["ms"] for k in ks}
        fn()
        prof, _ = cs.profiled(lambda: [fn() for _ in range(10)])
        ab[f"{name}_{d}_device_union_ms"] = union(prof) / 10
for name, make_hp in (("flagship", cs.flagship_hparams),
                      ("wide", cs.wide_head_hparams)):
    hp = make_hp(batch_size=16, accumulation_steps=3)
    batch = cs.train_batch(hp, np.random.default_rng(5), 128, 768)
    model = cs.DaftExprt(hp, seed=0)
    step = make_train_step(model, hp)
    sgen = torch.Generator(device="cuda")

    def run(k, it0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(k):
            sgen.manual_seed(dropout_seed(hp, it0 + i))
            step(batch, sgen, it0 + i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k * 1e3

    run(3, 1)
    ms = [run(10, 4 + 10 * r) for r in range(3)]
    prof, _ = cs.profiled(lambda: step(batch, sgen, 40))
    ab.update({f"{name}_step_ms": float(np.median(ms)),
               f"{name}_step_ms_rounds": ms,
               f"{name}_step_device_busy_ms": union(prof),
               f"{name}_step_conv_ff_device_ms": group_ms(
                   prof, cs.CONV_FF_TC_KERNELS)})
    del model, step
print("AB", json.dumps(ab))
"""


def ab_preview() -> str:
    """AB_PREVIEW with this file's ``preview_stream`` and stream in it
    (the other checkout's chip_smoke may lack them)."""
    import inspect
    return AB_PREVIEW.replace("@PREVIEW_STREAM@", inspect.getsource(
        preview_stream)).replace("@STREAM@", repr(PREVIEW_STREAM))


AB_SCRIPTS = {"--ab-train": AB_TRAIN, "--ab-k1": AB_K1, "--ab-serve": AB_SERVE,
              "--ab-k2": AB_K2, "--ab-k5": AB_K5, "--ab-text": AB_TEXT,
              "--ab-step": AB_STEP, "--ab-conv-ff": AB_CONV_FF,
              "--ab-synth": AB_SYNTH, "--ab-preview": ab_preview()}


REPEAT_SCRIPT = """
import faulthandler, json, subprocess, sys, torch, chip_smoke as cs
faulthandler.enable()
cs._build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
for i in range(int(sys.argv[1])):
    dp = cs.data_parallel(smi)
    print("REPEAT", json.dumps({"check": "data_parallel", "seconds":
                                dp["seconds"], "wall_ms": dp["wall_ms"]}),
          flush=True)
    for tf32 in (False, True):
        r = cs.gan_step_against_cpu(tf32)
        print("REPEAT", json.dumps({"check": "gan_step_against_cpu",
                                    "tf32": tf32,
                                    "loss_rel": r["loss_rel"]}), flush=True)
"""


def repeat_checks(processes: int, runs: int = 2) -> int:
    """``--repeat-checks N``: in each of N fresh processes under
    faulthandler, ``runs`` times the data-parallel phase and the small GAN
    step card vs CPU (float32, then TF32). A process that faults shows its
    exit code and its Python stacks; prints each process's checks and exit
    code, then the counts."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    counts = {"processes": processes, "failed": 0, "data_parallel": 0,
              "gan_step_against_cpu": 0}
    for i in range(processes):
        run = subprocess.run([sys.executable, "-c", REPEAT_SCRIPT, str(runs)],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
        done = [json.loads(ln[7:]) for ln in run.stdout.splitlines()
                if ln.startswith("REPEAT ")]
        for row in done:
            counts[row["check"]] += 1
        print(f"repeat process {i}: exit code {run.returncode}, "
              f"{json.dumps(done)}", flush=True)
        if run.returncode:
            counts["failed"] += 1
            print(run.stdout[-3000:], run.stderr[-6000:], flush=True)
    print("repeat checks", json.dumps(counts), flush=True)
    return 1 if counts["failed"] else 0


def ab_train(parent: str, rounds: int = 2, script: str = AB_TRAIN) -> int:
    """The flagship and the wide training step (3 warm-up and 10 timed
    steps of ``train`` each, then one profiled), or with ``script``
    AB_CONV_FF K3's and K4's wrappers and the two steps replayed, or AB_K1
    K1's wrapper at every ``K1_SHAPES`` shape (CUDA-event and device ms)
    and a replayed mel and audio request (host ms, device busy, K1's and
    K5's device ms), or AB_SERVE one flagship mel request (measure/add, B=8, bucket
    512: median and least host ms of 20, profiled device busy), or AB_K2
    K2's forward and backward wrappers at every timed shape and rate
    (CUDA-event and device ms), or AB_K5 K5's wrapper at the V1 stage
    shapes (CUDA-event and device ms), a replayed audio request and a
    replayed stream window (host ms), or AB_TEXT the text-serving phase on a
    fresh server (warm-up s, each request's ms, /stream's first audio),
    in a checkout of another commit against
    this one, each in a process of its own on the same card, in the order
    parent, this, this, parent, ``rounds`` times: one line per run. A run
    that fails prints its output's end and the others still run; the
    exit code is then 1."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    here = str(Path(__file__).resolve().parent)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    failed = 0
    for name, cwd in [("parent", parent), ("this", here), ("this", here),
                      ("parent", parent)] * rounds:
        run = subprocess.run([sys.executable, "-c", script], cwd=cwd,
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("AB ")]
        if run.returncode != 0 or not lines:
            print(f"AB {name} failed, exit code {run.returncode}", flush=True)
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            failed += 1
            continue
        print(f"AB {name} {lines[-1][3:]}", flush=True)
    return 1 if failed else 0


def main(mode: str | None = None, count: int = 0) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    faulthandler.enable()  # a fault prints every thread's Python stack
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {json.dumps(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            # C7515: ptxas serialized a kernel's wgmma products
            if "registers" in line or "spill" in line or "C7515" in line:
                print(f"ptxas {log.stem}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {kind}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "--loop-timing":
        loop_timing(smi)
        return 0
    if mode == "--vocoder-learning":
        vocoder_learning(smi)
        return 0
    if mode == "--vocoder-learning more":
        vocoder_learning(smi, VOC_LEARNING_MORE_RUNS, gate=False)
        return 0
    if mode == "--graph-gaps":
        graph_gaps(smi)
        return 0
    if mode == "--profiled-films":
        return profiled_films(count, smi)

    # host seconds of each phase, from the end of the one before
    phases, last = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phases[name] = now - last[0]
        last[0] = now
        print(f"phase {name}: {phases[name]:.1f} s", flush=True)

    gen = torch.Generator().manual_seed(0)
    k1, k1_plan = check_k1(gen)
    k1_design = k1_sums(gen, np.random.default_rng(14))
    mark("k1")
    rows, launches, engines, requests = serve(flagship_hparams())
    name, pt, inputs = requests[2]  # measure, bucket 512
    profile = profile_request(engines[name], inputs, pt)
    mark("serve")
    cpu_err = check_against_cpu()
    cumsum = time_duration_cumsum(flagship_hparams())
    mark("cpu_and_cumsum")
    k5, k5_plan, k5_exact = check_k5()
    mark("k5")
    vocoder = HiFiGanGenerator(seed=0)
    audio, k5_launches, audio_engines, audio_requests = serve_audio(
        engines["speculate"].model, vocoder)
    two_step_err = audio_equals_two_step(audio_engines["audio"], vocoder,
                                         audio_requests[1])
    audio_profile = profile_audio(audio_engines["audio"], audio_requests[1])
    mark("serve_audio")
    stream = stream_utterance(audio_engines["audio_rerun"], vocoder,
                              audio_requests[-1])
    audio_cpu = audio_against_cpu()
    mark("stream_and_audio_cpu")
    del audio_engines, audio_requests
    graphs = engine_graphs(vocoder, smi)
    mark("engine_graphs")
    wide_serving = serve_wide(vocoder)
    wide_serving["card_vs_cpu_f32"] = {
        "mel_max_abs_err": check_against_cpu(small_wide_hparams),
        "eval": eval_against_cpu(small_wide_hparams)}
    mark("serve_wide")
    del vocoder
    k2_plan = check_k2_plan()
    k2 = check_k2()
    k3_plan = check_k3_plan()
    k3 = check_conv_ff("K3", K3_SHAPES, gen, 4)
    mark("k2_k3")
    training, train_launches = train(flagship_hparams(
        batch_size=16, accumulation_steps=3), "conv_ff_train")
    train_cpu = train_against_cpu(flagship_hparams, "conv_ff_train")
    mark("train")
    k4_plan = check_k4_plan()
    k4 = check_conv_ff("K4", K4_SHAPES, gen, 9)
    conv_ff_sums_rows = conv_ff_sums(gen, np.random.default_rng(21))
    mark("k4")
    wide, wide_launches = train(wide_head_hparams(
        batch_size=16, accumulation_steps=3), "conv_ff_train_blocked")
    wide_cpu = train_against_cpu(small_wide_hparams, "conv_ff_train_blocked")
    mark("train_wide")
    tts = text_serving(smi)
    mark("text_serving")
    pre = preprocessing(smi)
    mark("preprocessing")
    kept = Path(tempfile.mkdtemp(prefix="fine_tuning_dataset_"))
    try:
        runtime = training_runtime(smi, training,
                                   keep_fine_tuning_dataset=kept / "data")
        mark("training_runtime")
        vocoder_run = vocoder_training(smi, kept / "data")
    finally:
        shutil.rmtree(kept, ignore_errors=True)
    mark("vocoder_training")
    dp = data_parallel(smi)
    mark("data_parallel")

    timed = [r for r in k1 if r["dtype"] == "bfloat16"]
    head = next(r for r in timed if r["shape"] == "frame_decoder")
    bf16 = [r for r in k1 if "rel_l2" in r]
    entry = {
        "name": "fused_fft_block",
        "route": "cuda",
        "source": "daft_exprt_tpu_torch/csrc/fft_block_tc.cu",
        "replaces": "daft_exprt_tpu/ops/fft_block.py:97",
        "launches": launches["all"],
        "instance": "tensor_core",
        "launches_tensor_core": launches["tensor_core"],
        **graph_launches(launches),
        "cuda_core_source": "daft_exprt_tpu_torch/csrc/fft_block.cu "
                            "(float32 dots)",
        "max_abs_err": max(r["max_abs_err"] for r in bf16),
        "max_abs_err_f32": max(r["max_abs_err"] for r in k1
                               if r["dtype"] == "float32"),
        "rel_l2": max(r["rel_l2"] for r in bf16),
        "control_rel_l2": min(r["control_rel_l2"] for r in bf16),
        "rel_l2_limit": K1_REL_TOL,
        **{k: head[k] for k in ("ms", "device_ms", "host_ms", "plain_ms",
                                "bound_ms", "bound_by", "staged_ms",
                                "staged_device_ms", "cuda_core_ms",
                                "cuda_core_device_ms")},
        "library_ms": None,  # no single PyTorch call computes K1
        "staged": "the block staged at bf16: cuBLAS linears, "
                  "scaled_dot_product_attention, cuDNN conv1d, layer_norm",
        "at": "frame_decoder B=8 T=512 E=128 C=1024 bf16",
        "shapes": [{k: r.get(k) for k in (
            "shape", "B", "T", "E", "H", "C", "dtype", "instance",
            "max_abs_err", "rel_l2", "control_rel_l2", "ms", "device_ms",
            "device_union_ms", "host_ms", "plain_ms", "cuda_core_ms",
            "cuda_core_device_ms", "staged_ms", "staged_device_ms",
            "bound_ms", "bound_by", "cluster", "kernels")}
            for r in k1 if "ms" in r],
        "smem_bytes": k1_plan,
        "sums": k1_design,
        "serving": rows,
        "audio_launches": {"all": k5_launches["k1"],
                           "tensor_core": k5_launches["k1_tensor_core"],
                           "replayed_derived": k5_launches["k1_replayed"],
                           "on_device": k5_launches["k1_on_device"]},
        "wide": wide_serving,
        "card_vs_cpu_f32_mel_err": cpu_err,
        "durations_cumsum": cumsum,
        "profile": profile,
        "engine_graphs": graphs,
    }
    k2_src = ("daft_exprt_tpu_torch/csrc/attention_train.cu",
              "daft_exprt_tpu/ops/attention_train.py")
    k3_src = k4_src = ("daft_exprt_tpu_torch/csrc/conv_ff_blocked_tc.cu",
                       "daft_exprt_tpu/ops/conv_ff_train.py")
    entries = [entry]
    # launches: the flagship step's (K4: the wide step's); launches_wide:
    # the wide step's
    for name, kernel, (src, ref), line, direction, rows, library in (
            ("attention_train_forward", "K2", k2_src, 93, "fwd", k2, True),
            ("attention_train_backward", "K2", k2_src, 135, "bwd", k2, True),
            ("conv_ff_train_forward", "K3", k3_src, 111, "fwd", k3, False),
            ("conv_ff_train_backward", "K3", k3_src, 126, "bwd", k3,
             False),
            ("conv_ff_train_blocked_forward", "K4", k4_src, 373, "fwd", k4,
             False),
            ("conv_ff_train_blocked_backward", "K4", k4_src, 416, "bwd", k4,
             False)):
        main_run = wide_launches if kernel == "K4" else train_launches
        extra = {}
        tc = f"{name}_tensor_core"
        if kernel == "K2":  # bf16 training: the tensor-core instance
            extra = dict(primary="frame_decoder", instance="tensor_core",
                         launches_tensor_core=train_launches[tc],
                         launches_wide_tensor_core=wide_launches[tc],
                         smem_bytes_by_head_dim=k2_plan)
        if kernel == "K3":
            extra = dict(instance="tensor_core",
                         launches_tensor_core=train_launches[tc],
                         cuda_core_source="daft_exprt_tpu_torch/csrc/"
                                          "conv_ff_train.cu",
                         smem_bytes_by_instance=k3_plan[
                             "smem_bytes_by_instance"],
                         tensor_core_plans=k3_plan["launches"],
                         tensor_core_kernels=CONV_FF_TC_KERNELS,
                         tensor_core_source="daft_exprt_tpu_torch/csrc/"
                                            "conv_ff_wgmma.cuh (GEMM cores)",
                         sums=conv_ff_sums_rows)
        if kernel == "K4":
            extra = dict(instance="tensor_core",
                         launches_tensor_core=wide_launches[tc],
                         cuda_core_source="daft_exprt_tpu_torch/csrc/"
                                          "conv_ff_blocked.cu",
                         smem_bytes_by_width=k4_plan["smem_bytes_by_width"],
                         tensor_core_plans=k4_plan["launches"],
                         tensor_core_kernels=CONV_FF_TC_KERNELS,
                         tensor_core_source="daft_exprt_tpu_torch/csrc/"
                                            "conv_ff_wgmma.cuh (GEMM cores)",
                         sums=conv_ff_sums_rows)
        # the main run's first step is eager (its launches at the
        # wrappers), its capture records as many, the replays run them
        extra.update(
            launches_captured=main_run[f"{name}_captured"],
            launches_replayed_derived=main_run[f"{name}_replayed"],
            launches_on_device=main_run[f"{name}_on_device"],
            launches_on_device_in="one profiled replayed step",
            launches_wide_captured=wide_launches[f"{name}_captured"])
        entries.append(kernel_entry(name, kernel, src, f"{ref}:{line}",
                                    main_run[name], rows, direction, library,
                                    launches_wide=wide_launches[name],
                                    **extra))
    entries[1]["training"] = training
    entries[1]["training_card_vs_cpu_f32"] = train_cpu
    entries[5]["training"] = wide
    entries[5]["training_card_vs_cpu_f32"] = wide_cpu
    entries.append(k5_entry(k5, k5_plan, k5_exact, k5_launches, audio,
                            two_step_err, audio_profile, stream, audio_cpu))
    # the text-serving phase's launches (HTTP requests, after warm-up: every
    # pass a replay): at the wrappers, and derived from the replays
    per_request = tts["requests"] + [tts["stream"], tts["concurrent"]]
    for e, k in ((entries[0], "k1"), (entries[-1], "k5")):
        e["launches_text_serving"] = tts["launches"][k]
        e["launches_text_serving_tensor_core"] = \
            tts["launches"][f"{k}_tensor_core"]
        e["launches_text_serving_replayed_derived"] = \
            tts["launches"][f"{k}_replayed"]
        e["text_serving_launches_by_request"] = {
            r["request"]: r[f"{k}_total"] for r in per_request}
    # the training-runtime phase's launches: its main path (the training
    # CLI run), one loop step, one validation pass, fine_tune
    main_run, timed = runtime["main"]["launches"], runtime["timed"]
    entries[0].update(
        launches_training_runtime=main_run["k1"],
        launches_training_runtime_tensor_core=main_run["k1_tensor_core"],
        launches_per_validation=timed["launches_per_validation"]["k1"],
        launches_per_validation_tensor_core=timed[
            "launches_per_validation"]["k1_tensor_core"],
        launches_fine_tune=runtime["fine_tune"]["launches"])
    for e in entries[1:5]:
        e["launches_training_runtime"] = main_run[e["name"]]
        e["launches_training_runtime_tensor_core"] = main_run[
            f"{e['name']}_tensor_core"]
        e["launches_per_loop_step"] = timed["launches_per_step"][e["name"]]
    entries[1]["training_runtime"] = runtime
    # the preprocessing phase's main path: pre_process (no kernel), then
    # two training iterations from its experiment
    for e in entries[1:5]:
        e["launches_preprocessing"] = pre["train"]["launches"][e["name"]]
        e["launches_preprocessing_tensor_core"] = pre["train"]["launches"][
            f"{e['name']}_tensor_core"]
    entries[1]["preprocessing"] = pre
    # the vocoder-training phase: no kernel in the GAN step; K5 serves the
    # trained generator (one vocode_mels pass, four audio requests a dtype
    # in a round)
    entries[-1].update(
        launches_vocoder_training_gan_step=vocoder_run["step"]["tf32"][
            "launches"]["k5"],
        launches_vocoder_training_served=vocoder_run["served"]["launches"][
            "k5_total"],
        launches_vocoder_training_served_tensor_core=vocoder_run["served"][
            "launches"]["k5_tensor_core_total"],
        vocoder_training=vocoder_run)
    # the data-parallel phase's main path: the mesh engines' runs (K1 12 a
    # replica pass)
    entries[0].update(
        launches_data_parallel=dp["main_path_launches"]["k1"],
        launches_data_parallel_tensor_core=dp["main_path_launches"][
            "k1_tensor_core"],
        data_parallel=dp)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all, by phase "
          f"{json.dumps(phases)}", flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) in (3, 4) and sys.argv[1] in AB_SCRIPTS:
        sys.exit(ab_train(sys.argv[2], rounds=int((sys.argv[3:] or [2])[0]),
                          script=AB_SCRIPTS[sys.argv[1]]))
    if sys.argv[1:] == ["--step-signatures"]:
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available", file=sys.stderr)
            sys.exit(1)
        sys.exit(step_signatures())
    if len(sys.argv) == 3 and sys.argv[1] == "--repeat-checks":
        sys.exit(repeat_checks(int(sys.argv[2])))
    if len(sys.argv) >= 3 and sys.argv[1] == "--profiled-churn":
        sys.exit(profiled_churn(int(sys.argv[2]), sys.argv[3:] or ("full",)))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--profiled-films":
        if sys.argv[3:] == ["template_dropped"]:
            drop_captured_graphs()
        sys.exit(main("--profiled-films", int(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == "--extraction-processes":
        if not torch.cuda.is_available():
            print("chip_smoke: CUDA is not available", file=sys.stderr)
            sys.exit(1)
        sys.exit(extraction_ops(int(sys.argv[2])))
    sys.exit(main(" ".join(sys.argv[1:]) if sys.argv[1:] in (
        ["--loop-timing"], ["--vocoder-learning"],
        ["--vocoder-learning", "more"], ["--graph-gaps"]) else None))
