#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. build the CUDA kernels from ``daft_exprt_tpu_torch/csrc`` with nvcc;
   print the card's name and power limit;
2. hold the fused FFT block kernel (K1) against its plain PyTorch version
   at the shapes the serving path launches it with, in float32 and
   bfloat16, and time both (CUDA events, median of 25 after warm-up);
   check edge shapes too (partial tiles, a zero-length row);
3. serve requests through ``collate_inference_batch`` ->
   ``InferenceEngine.run`` at the flagship width (config defaults, 11
   speakers, bf16) with seeded weights, both pitch transforms and both
   bucket policies, one speculation that undershoots and re-runs at the
   full budget, with the kernels' launch counters read around it;
   profile one request (device time by kernel, idle share); then hold a
   small float32 request on the card against the same model on the CPU
   (plain versions), and time the durations' blocked cumsum on the card;
4. hold the fused MRF vocoder kernel (K5) against its plain version at
   the three V1 stage shapes of a B=8, bucket-512 vocode pass (and one
   unit of each), with a control (plain without its bf16 rounding) that
   must fail the relative-L2 limit, and against exact (float64) sums at
   one stage-1 tile; time it beside the plain version
   and the same fan as staged cuDNN convs; check edge shapes (N not a
   multiple of the tile, N under the halo, v3's ResBlock2 fan, C=16, C=8);
   serve 5 text-to-waveform requests through ``run_cached_to_audio`` at
   flagship width with a seeded V1 generator (a cold style, the same
   keys, a padding row, half new styles, an undershooting speculation
   that re-runs at 2048), with the K1/K5 launch counters and the
   prosody-encoder batch counter read around each; check that the audio
   equals ``run_cached`` -> crop -> ``vocode_mels``; profile one request;
   stream one utterance through ``StreamingVocoder`` against
   ``vocode_mels``; hold a small float32 audio request on the card against
   the CPU (TF32 off);
5. hold the training attention kernels (K2, forward and backward) against
   their plain versions at the flagship and wide training shapes (E=128
   and E=512, D=16, 64 and 128), f32 and bf16, at dropout rates 0 and
   0.1 (bit-equal masks; bf16 with rounding takes the tensor-core
   instance, checked by its launch counters and its shared-memory plan
   against the built kernel's; two bf16 backward runs bit-identical), and
   time every training shape at bf16 beside
   ``scaled_dot_product_attention``; hold float32 q/k/v with bf16 dots
   (the CUDA-core instance, which rounds k and q before the dq and dk
   products) to the plain version; the same for the training conv-FF
   kernels (K3), with a check that two backward runs give bit-identical
   weight gradients. At bf16 a control runs the same kernels with their
   internal rounding off and must fail the relative-L2 limit;
6. take training steps at the flagship width (bf16, dropout 0.1, batch
   16, accumulation 3, L=128 symbols, T=768 frames) through
   ``make_train_step``: 2 warm-up and 5 timed steps, the K2 and K3
   launch counters read around the timed ones (12 x 3 per step each, every
   K2 launch on the tensor-core instance, K1 and K4 none); profile one
   step (K2's device time all in its tensor-core kernels); then hold a
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
   wide frame-rate shape; take 2 + 5 wide steps as in 6 (K2 and K4 12 x 3
   per step each, every K4 launch on its tensor-core instance, K3 and K1
   none) and profile one (K4's device time all in its tensor-core
   kernels); hold a small float32 wide step (E=256, 2 heads of 128,
   C=256) on the card against the CPU;
8. print ``{"kernels": [...]}``, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Needs CUDA: it exits with an error when ``torch.cuda.is_available()`` is
false. It imports nothing of JAX and nothing of ``daft_exprt_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from daft_exprt_tpu_torch.config import HyperParams
from daft_exprt_tpu_torch.inference.engine import InferenceEngine
from daft_exprt_tpu_torch.inference.inputs import collate_inference_batch
from daft_exprt_tpu_torch.models.daft_exprt import DaftExprt
from daft_exprt_tpu_torch.models.modules import FFTBlock, init_parameters
from daft_exprt_tpu_torch.ops import _build
from daft_exprt_tpu_torch.ops.attention_train import attention_core
from daft_exprt_tpu_torch.ops.conv_ff_train import (conv_ff_train,
                                                    conv_ff_train_blocked)
from daft_exprt_tpu_torch.ops.fft_block import (fft_block_plain,
                                                fused_fft_block)
from daft_exprt_tpu_torch.ops.mrf_vocoder import fused_mrf
from daft_exprt_tpu_torch.symbols import SYMBOLS_ENGLISH
from daft_exprt_tpu_torch.training.step import make_train_step
from daft_exprt_tpu_torch.vocoder.hifigan import HiFiGanGenerator

ROOT = Path(__file__).resolve().parent
# H100 SXM published peaks (dense): bf16 tensor cores, float32 CUDA cores,
# HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
# kernel vs plain, max abs: f32 as tests/test_fft_block.py; bf16 7.5x
# tighter than that file's bf16 bound (0.15), leaving room for summation-
# order flips of single bf16 roundings
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
E, C = 128, 1024
# (name, B, T, heads, FiLM): the serving phase's K1 launches
K1_SHAPES = [("prosody_encoder", 8, 512, 8, False),
             ("phoneme_encoder", 8, 64, 2, True),
             ("frame_decoder", 8, 512, 2, True),
             ("frame_decoder_full_budget", 8, 2048, 2, True)]
# (name, T, heads, FiLM, lengths): tiles cut by T, a row of length 0
# (every duration zero), checked but not timed
K1_EDGE_CASES = [("edge_T48", 48, 2, True, [48, 17, 0]),
                 ("edge_T16_H8", 16, 8, False, [16, 5]),
                 ("edge_T1536", 1536, 2, True, [1536, 700])]
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


def k1_bound(lengths, B, T, dot_dtype):
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


def check_k1(gen):
    """Phase 2: K1 against its plain version at the serving shapes (timed)
    and at edge shapes (partial tiles, D=32, a zero-length row)."""
    rng = np.random.default_rng(0)
    cases = []
    for name, B, T, H, with_film in K1_SHAPES:
        lens = rng.integers(T // 4, T, size=B)
        lens[0], lens[-1] = T, 3  # one full row, one short row
        cases.append((name, B, T, H, with_film, lens, True))
    cases += [(name, len(lens), T, H, film, np.array(lens), False)
              for name, T, H, film, lens in K1_EDGE_CASES]
    results = []
    for name, B, T, H, with_film, lens, timed in cases:
        block = FFTBlock(E, H, C, 3)
        init_parameters(block, gen)
        with torch.no_grad():  # non-trivial biases and LN affine terms
            for p in block.parameters():
                if p.dim() == 1:
                    p.add_(0.1 * torch.randn(p.shape, generator=gen))
        block = block.cuda()
        x = torch.from_numpy(rng.standard_normal((B, T, E)).astype(
            np.float32)).cuda()
        film = None
        if with_film:
            film = torch.from_numpy(np.concatenate(
                [1 + 0.1 * rng.standard_normal((B, E)),
                 0.1 * rng.standard_normal((B, E))], 1).astype(
                np.float32)).cuda()
        lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
        valid = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
        for dot_dtype in (torch.float32, torch.bfloat16):
            w = block.kernel_weights(dot_dtype)

            def kernel():
                return fused_fft_block(x, w, film, lengths, num_heads=H,
                                       dot_dtype=dot_dtype)

            def plain():
                return fft_block_plain(x, w, film, lengths, num_heads=H,
                                       dot_dtype=dot_dtype)

            out = kernel()
            torch.cuda.synchronize()
            ref = plain()
            if not torch.isfinite(out).all():
                raise AssertionError(f"K1 {name} {dot_dtype}: non-finite")
            if (out[~valid] != 0).any():
                raise AssertionError(f"K1 {name} {dot_dtype}: padded rows "
                                     "not exactly zero")
            err = (out - ref).abs().max().item()
            if not err <= TOL[dot_dtype]:
                raise AssertionError(f"K1 {name} {dot_dtype}: max abs err "
                                     f"{err} > {TOL[dot_dtype]}")
            row = {"shape": name, "B": B, "T": T, "H": H,
                   "dtype": dtype_name(dot_dtype),
                   "lengths": lens.tolist(), "max_abs_err": err,
                   "tol": TOL[dot_dtype]}
            if timed:
                bound_ms, bound_by = k1_bound(lens, B, T, dot_dtype)
                row.update(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                           bound_ms=bound_ms, bound_by=bound_by)
                results.append(row)
            print("K1", json.dumps(row), flush=True)
    return results


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
# forward 9.2e-5 and 1.6e-3, backward 2.3e-4 and 3.1e-3; K3 forward
# 1.2e-5 and 1.2e-3, backward 1.5e-4 and 2.8e-3; K4 forward 5.8e-5 and
# 1.45e-3, backward 4.6e-4 (W1 at the short edge shape, B x T = 80 rows)
# and 2.8e-3 (NVIDIA H100 80GB HBM3, 700 W).
BF16_REL_TOL = {("K2", "fwd"): 4e-4, ("K2", "bwd"): 8e-4,
                ("K3", "fwd"): 1.2e-4, ("K3", "bwd"): 6.5e-4,
                ("K4", "fwd"): 2.9e-4, ("K4", "bwd"): 1.1e-3}
# the tensors each kernel's internal bf16 roundings feed; the control
# must exceed the limit on every one of them
K2_ROUNDED = ("out", "q", "k", "v")


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
                print("K2", json.dumps(row), flush=True)
                if not (ok_f and all(ok for _, ok in errs)):
                    raise AssertionError(f"K2 disagrees with plain: {row}")
                if bf16:
                    _bf16_verdict("K2", row["rel_l2"], row["control_rel_l2"])
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
# leaves them; its cotangent is zero there too), E=256, and one C block.
K3_SHAPES = [("frame_rate", 16, 768, E, C, None, None),
             ("symbol_rate", 16, 128, E, C, None, None),
             ("edge_T40", 2, 40, E, C, None, None),
             ("edge_T2048", 2, 2048, E, C, None, None)]
K4_SHAPES = [("wide_frame_rate", 16, 768, 512, 512, None, None),
             ("wide_symbol_rate", 16, 128, 512, 512, None, None),
             ("edge_T40_short_row", 2, 40, 512, 512, None, [40, 13]),
             ("edge_E256", 2, 64, 256, 256, None, None),
             ("edge_single_block", 2, 64, 512, 128, 128, None)]
CONV_FF_TIMED = ("frame_rate", "wide_frame_rate")
# K4's tensor-core instance at the wide frame-rate shape, bf16, CUDA-event
# ms of one call (forward, backward): a fall back onto the CUDA-core
# instance (2.9 / 9.1 ms on an H100) fails these
K4_MS_LIMIT = {"fwd": 1.0, "bwd": 3.0}
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


def check_k4_plan():
    """The wrapper's shared-memory plan of K4's tensor-core instance equals
    the built kernel's own count at every width it takes."""
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
    return plan


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
    backward runs; the frame-rate bf16 shape timed. K4 at bf16 runs its
    tensor-core instance (its counters move, the control's do not; the
    wide frame-rate shape is also timed on the device alone, beside staged
    cuBLAS matmuls, and held to K4_MS_LIMIT); K3 never does.

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
        conv_ff_train, conv_ff_train_blocked, kernel_weights, plan_conv_ff)

    def tc_launches():
        return [conv_ff_train_blocked.tc_fwd_launches,
                conv_ff_train_blocked.tc_bwd_launches]

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
                if tc != ([1, 2] if kernel == "K4" and bf16 else [0, 0]):
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
                    # weights, rounding off (K4: the CUDA-core instance)
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
                    def fwd():
                        return conv_ff_forward_cuda(*kargs, rate, dot_dtype,
                                                    cb)

                    def bwd():
                        return conv_ff_backward_cuda(*kargs, g, rate,
                                                     dot_dtype, cb)
                    row["fwd_ms"], row["bwd_ms"] = cuda_ms(fwd), cuda_ms(bwd)
                    if kernel == "K4":
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
                        slow = {d: row[f"{d}_ms"] for d in K4_MS_LIMIT
                                if not row[f"{d}_ms"] <= K4_MS_LIMIT[d]}
                        if slow:
                            raise AssertionError(
                                f"K4 {name} rate {rate}: ms {slow} past the "
                                f"limits {K4_MS_LIMIT}")
                    row["fwd_plain_ms"] = cuda_ms(plain, reps=5)
                    row["bwd_plain_ms"] = cuda_ms(plain_bwd, reps=5)
                    row["fwd_bound_ms"], row["fwd_bound_by"] = k3_bound(
                        B, T, dot_dtype, False, E=E_, C=C_)
                    row["bwd_bound_ms"], row["bwd_bound_by"] = k3_bound(
                        B, T, dot_dtype, True, E=E_, C=C_)
                    print(f"{kernel} timed", json.dumps(row), flush=True)
                rows.append(row)
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
# checked on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): fan 3.95e-4 and
# 1.37e-3, unit 1.33e-5 and 1.35e-3.
K5_REL_TOL = {"fan": 7e-4, "unit": 1.2e-4}
V3_CONFIG = {"upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
             "upsample_initial_channel": 256, "resblock": "2",
             "resblock_kernel_sizes": [3, 5, 7],
             "resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]]}
SERVE_BUCKET = 512  # decoder frames of the timed audio requests


def k5_bound(B, N, program):
    """Least time for one K5 call: 2 C^2 FLOPs per output sample for each
    tap of the fan at the bf16 peak, against x read and out written once
    in float32, the bf16 taps and the float32 biases once."""
    taps, C = program.w_taps.shape[0], program.w_taps.shape[1]
    flops = 2.0 * B * N * C * C * taps
    nbytes = 2 * B * N * C * 4 + taps * C * C * 2 + program.biases.numel() * 4
    t_ops = flops / PEAK_FLOPS[torch.bfloat16]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def k5_work_factor(program, C):
    """Products K5 computes per product the fan needs: each conv computes
    the rows its later convs of the chain read (the tile plus what is
    left of the chain's halo), on paper from the tap program."""
    from daft_exprt_tpu_torch.ops.mrf_vocoder import tile_rows

    tn = tile_rows(C)
    done = need = left = 0
    for k, d, _, flags, reach in program.desc.tolist():
        if flags & 1:  # a chain starts: its halo is the chain's reach
            left = reach
        left -= (k - 1) * d // 2
        done += (tn + 2 * left) * k
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


def check_k5():
    """K5 against its plain version at the V1 stage shapes of the serving
    batch (B=8, bucket 512; timed beside the staged cuDNN fan), one unit of
    each V1 stage's first resblock at the same shapes, and edge shapes
    (untimed): N not a multiple of the tile, N under the halo, v3's
    ResBlock2 fan, C=16 and C=8. Each must be within its K5_REL_TOL of
    plain while the control (plain without rounding) exceeds it."""
    from daft_exprt_tpu_torch.ops.mrf_vocoder import (build_mrf_program,
                                                      mrf_plain)

    v1 = HiFiGanGenerator(seed=0)
    v3 = HiFiGanGenerator(V3_CONFIG, seed=1)
    narrow = HiFiGanGenerator({"upsample_initial_channel": 64}, seed=2)
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
        C = program.w_taps.shape[1]
        x = _cuda((0.5 * rng.standard_normal((B, N, C))).astype(np.float32))
        out = fused_mrf(x, program)
        torch.cuda.synchronize()
        ref = mrf_plain(x, program)
        control = mrf_plain(x, program, dot_dtype=torch.float32)
        limit = K5_REL_TOL[kind]
        row = {"shape": name, "B": B, "N": N, "C": C,
               "taps": program.w_taps.shape[0], "halo": program.halo,
               "max_abs_err": (out - ref).abs().max().item(),
               "rel_l2": _rel_l2(out, ref),
               "control_rel_l2": _rel_l2(control, ref), "limit": limit}
        print("K5", json.dumps(row), flush=True)
        if not (bool(torch.isfinite(out).all())
                and row["rel_l2"] <= limit < row["control_rel_l2"]):
            raise AssertionError(f"K5 disagrees with plain: {row}")
        if name == "v1_stage1":
            # kernel and plain sum in float32 in other orders: each should
            # be as far from the exact sum as the other
            xs = x[:1, :4096]
            exact = mrf_exact(xs, program)
            row["exact_rel_l2"] = {
                "kernel": _rel_l2(fused_mrf(xs, program), exact),
                "plain": _rel_l2(mrf_plain(xs, program), exact)}
            print("K5 vs exact sums", json.dumps(row["exact_rel_l2"]),
                  flush=True)
            if not row["exact_rel_l2"]["kernel"] \
                    <= 1.5 * row["exact_rel_l2"]["plain"]:
                raise AssertionError(f"K5 further from the exact sums than "
                                     f"plain: {row}")
        if timed:
            staged = staged_fan(*timed)
            row["ms"] = cuda_ms(lambda: fused_mrf(x, program))
            row["plain_ms"] = cuda_ms(lambda: mrf_plain(x, program))
            row["staged_cudnn_ms"] = cuda_ms(lambda: staged(x))
            row["bound_ms"], row["bound_by"] = k5_bound(B, N, program)
            row["work_factor"] = k5_work_factor(program, C)
            print("K5 timed", json.dumps(row), flush=True)
        rows.append(row)
    return rows


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
    fused_fft_block.launches = 0
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
    launches = fused_fft_block.launches
    passes = sum(e.passes for e in engines.values())
    n_blocks = sum(hp.__dict__[m]["nb_blocks"] for m in
                   ("prosody_encoder", "phoneme_encoder", "frame_decoder"))
    print(f"serving: {passes} inference passes, K1 launches {launches} "
          f"(expected {n_blocks} x {passes})", flush=True)
    if launches != n_blocks * passes or launches == 0:
        raise AssertionError(f"K1 launches {launches} != "
                             f"{n_blocks} x {passes} passes")
    rerun = next(r for r in rows if r["engine"] == "speculate_rerun")
    if rerun["passes"] != 2 or rerun["bucket"] != hp.max_frames:
        raise AssertionError(f"undershooting speculation: {rerun}, expected "
                             f"a re-run at {hp.max_frames} frames")
    return rows, launches, engines, requests


K1_KERNELS = ("qkv_kernel", "attention_kernel", "outproj_ln_kernel",
              "conv_ff_kernel")


def profile_kernels(run, groups):
    """Device time by kernel for one call of ``run`` (torch.profiler),
    the device's idle share of its wall time under the profiler, and the
    device ms of each named group of kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = kernels.get(ev.key, (0.0, 0))
        kernels[ev.key] = (ms + ev.self_device_time_total / 1e3,
                           n + ev.count)
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0.0:
        print("profile: the profiler recorded no device time", flush=True)
        return None
    report = {"wall_ms": wall_ms, "device_busy_ms": busy,
              "idle_share": 1.0 - busy / wall_ms}
    for group, names in groups.items():
        report[group] = sum(ms for name, (ms, _) in kernels.items()
                            if any(k in name for k in names))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:14]
    report["top"] = [{"kernel": name[:90], "ms": ms, "count": n}
                     for name, (ms, n) in top]
    return report


def profile_request(engine, inputs, pitch_transform):
    """Device time by kernel for one request, after one unprofiled run."""
    engine.run(inputs, pitch_transform, want_weights=False)
    report = profile_kernels(
        lambda: engine.run(inputs, pitch_transform, want_weights=False),
        {"k1_ms": K1_KERNELS})
    print("profile", json.dumps(report), flush=True)
    return report


def check_against_cpu():
    """A small float32 request on the card against the same model on the
    CPU (plain versions everywhere)."""
    hp = flagship_hparams(compute_dtype="float32")
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


K5_KERNELS = ("mrf_kernel",)
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
    request: K5 3 per pass; K1 8 per pass (phoneme encoder and decoder)
    plus 4 per prosody-encoder batch of the FiLM cache."""
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
    warm = [("warm-up", i) for i in range(8)]
    for _, engine, pt, inputs, _, _ in requests:
        engine.run_cached_to_audio(inputs, pt, warm)
    for engine in engines.values():
        engine.films.clear()
    torch.cuda.synchronize()
    fused_fft_block.launches = fused_mrf.launches = 0
    rows = []
    for label, engine, pt, inputs, k, want_fb in requests:
        before = (engine.passes, engine.film_batches,
                  fused_fft_block.launches, fused_mrf.launches)
        t0 = time.perf_counter()
        wavs, out_lens, overflow = engine.run_cached_to_audio(inputs, pt, k)
        latency = time.perf_counter() - t0
        passes, fb, k1, k5 = (a - b for a, b in zip(
            (engine.passes, engine.film_batches, fused_fft_block.launches,
             fused_mrf.launches), before))
        samples = check_wavs(wavs, out_lens, overflow, k)
        row = {"request": label, "pitch_transform": pt,
               "speculated_bucket": engine._buckets.speculate(inputs),
               "passes": passes, "prosody_encoder_batches": fb,
               "k1_launches": k1, "k5_launches": k5,
               "frames": int(sum(out_lens[b] for b, key in enumerate(k)
                                 if key is not None)),
               "latency_ms": latency * 1e3,
               "samples_per_s": samples / latency,
               "x_realtime": samples / SAMPLE_RATE / latency}
        print("audio request", json.dumps(row), flush=True)
        if fb != want_fb or k5 != 3 * passes or k1 != 8 * passes + 4 * fb:
            raise AssertionError(f"audio request launches: {row}")
        rows.append(row)
    launches = fused_mrf.launches
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
    report = profile_kernels(
        lambda: engine.run_cached_to_audio(inputs, pt, keys),
        {"k1_ms": K1_KERNELS, "k5_ms": K5_KERNELS,
         "cudnn_conv_ms": CUDNN_KERNELS})
    if report is not None:
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


def stream_utterance(engine, gen, request):
    """One long utterance (the longest row of the overflow request's mel)
    through StreamingVocoder, against vocode_mels of the same mel padded
    by the halo; time to the first chunk and total, after one warm-up
    stream."""
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
    sv.vocode(mel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks, first = [], None
    for chunk in sv.stream(mel):
        if first is None:
            first = time.perf_counter() - t0
        chunks.append(chunk)
    total = time.perf_counter() - t0
    got = np.concatenate(chunks)
    if got.shape != ref.shape:
        raise AssertionError(f"stream {got.shape} vs {ref.shape}")
    control = StreamingVocoder(gen, halo_frames=1).vocode(mel)
    report = {"frames": T, "chunk_frames": sv.chunk, "halo_frames": sv.halo,
              "windows": len(chunks), "first_chunk_ms": first * 1e3,
              "total_ms": total * 1e3,
              "x_realtime": got.size / SAMPLE_RATE / total,
              "max_abs_err": float(np.abs(got - ref).max()),
              "rel_l2": _np_rel_l2(got, ref),
              "control_rel_l2": _np_rel_l2(control, ref),
              "limit": STREAM_REL_TOL}
    print("stream", json.dumps(report), flush=True)
    if not report["rel_l2"] <= STREAM_REL_TOL < report["control_rel_l2"]:
        raise AssertionError(f"stream differs from vocode_mels: {report}")
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


K2_TC_KERNELS = ("attn_fwd_tc_kernel", "attn_bwd_dq_tc_kernel",
                 "attn_bwd_dkdv_tc_kernel")
K2_KERNELS = ("attn_fwd_kernel", "attn_bwd_dq_kernel",
              "attn_bwd_dkdv_kernel") + K2_TC_KERNELS
K3_KERNELS = ("cff_rows_kernel", "cff_hidden_kernel", "wgrad_kernel",
              "sum_rows_kernel")
K4_TC_KERNELS = ("tc_conv_gemm_kernel", "tc_weight_grad_kernel",
                 "tc_rows_fwd_kernel", "tc_rows_bwd_kernel", "sum_rows_kernel")
K4_KERNELS = ("cffb_rows_kernel", "cffb_hidden_kernel",
              "wgrad_kernel") + K4_TC_KERNELS
TRAIN_COUNTERS = {
    "attention_train_forward": (attention_core, "fwd_launches"),
    "attention_train_backward": (attention_core, "bwd_launches"),
    "attention_train_forward_tensor_core": (attention_core,
                                            "tc_fwd_launches"),
    "attention_train_backward_tensor_core": (attention_core,
                                             "tc_bwd_launches"),
    "conv_ff_train_forward": (conv_ff_train, "fwd_launches"),
    "conv_ff_train_backward": (conv_ff_train, "bwd_launches"),
    "conv_ff_train_blocked_forward": (conv_ff_train_blocked, "fwd_launches"),
    "conv_ff_train_blocked_backward": (conv_ff_train_blocked,
                                       "bwd_launches"),
    "conv_ff_train_blocked_forward_tensor_core": (conv_ff_train_blocked,
                                                  "tc_fwd_launches"),
    "conv_ff_train_blocked_backward_tensor_core": (conv_ff_train_blocked,
                                                   "tc_bwd_launches"),
}


def expected_launches(conv_ff, n, tensor_core):
    """The training counters when K2 and the conv-FF kernel ``conv_ff``
    launched n times in each direction, the other conv-FF kernel never,
    and K2 and K4 all on their tensor-core instances (bf16 steps) or none
    (f32)."""
    ran = {"attention_train_forward", "attention_train_backward",
           f"{conv_ff}_forward", f"{conv_ff}_backward"}
    if tensor_core:
        ran |= {"attention_train_forward_tensor_core",
                "attention_train_backward_tensor_core"}
        if conv_ff == "conv_ff_train_blocked":
            ran |= {f"{conv_ff}_forward_tensor_core",
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


def train(hp, conv_ff, warmup=2, steps=5):
    """Optimizer steps at full width through make_train_step, with the
    training kernels' launch counters read around the timed steps: K2 and
    the conv-FF kernel ``conv_ff`` (``"conv_ff_train"``, K3, or
    ``"conv_ff_train_blocked"``, K4) once per FFT block and micro-batch in
    each direction, the other conv-FF kernel and K1 never."""
    torch.cuda.reset_peak_memory_stats()
    model = DaftExprt(hp, seed=0)
    step = make_train_step(model, hp)
    rng = np.random.default_rng(5)
    L, T = 128, 768
    batch = train_batch(hp, rng, L, T)
    gen = torch.Generator(device="cuda").manual_seed(0)
    start = [p.detach().clone() for p in model.parameters()]
    for i in range(warmup):
        step(batch, gen, i + 1)
    torch.cuda.synchronize()
    for fn, attr in TRAIN_COUNTERS.values():
        setattr(fn, attr, 0)
    fused_fft_block.launches = 0
    t0 = time.perf_counter()
    metrics = [step(batch, gen, warmup + i + 1) for i in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in TRAIN_COUNTERS.items()}
    n_blocks = sum(hp.__dict__[m]["nb_blocks"] for m in
                   ("prosody_encoder", "phoneme_encoder", "frame_decoder"))
    expect = n_blocks * hp.accumulation_steps * steps
    want = expected_launches(conv_ff, expect, tensor_core=True)
    print(f"training: launches {json.dumps(launches)} (expected "
          f"{json.dumps(want)}), K1 {fused_fft_block.launches} (expected 0)",
          flush=True)
    if launches != want or fused_fft_block.launches != 0:
        raise AssertionError(f"training launches {launches}, K1 "
                             f"{fused_fft_block.launches}")
    rows = [{k: float(v) for k, v in m.items()} for m in metrics]
    for r in rows:
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f"non-finite training metrics {r}")
    moved = sum(bool((a != p.detach()).any())
                for a, p in zip(start, model.parameters()))
    if moved != len(start):
        raise AssertionError(f"{len(start) - moved} parameters did not move")
    frames = int(batch["output_lengths"].sum())  # over accumulation x B
    report = {"steps": steps, "step_ms": seconds / steps * 1e3,
              "steps_per_s": steps / seconds,
              "mel_frames_per_s": frames * steps / seconds,
              "frames_per_step": frames, "launches": launches,
              "loss": [r["loss"] for r in rows],
              "grad_norm": [r["grad_norm"] for r in rows],
              "params_moved": moved,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    print("training", json.dumps(report), flush=True)
    it = warmup + steps + 1
    groups = {"k2_ms": K2_KERNELS, "k2_tensor_core_ms": K2_TC_KERNELS}
    if conv_ff == "conv_ff_train":
        groups["k3_ms"] = K3_KERNELS
    else:
        groups.update(k4_ms=K4_KERNELS, k4_tensor_core_ms=K4_TC_KERNELS)
    report["profile"] = prof = profile_kernels(
        lambda: step(batch, gen, it), groups)
    if prof is not None:
        prof["k2_share"] = prof["k2_ms"] / prof["device_busy_ms"]
    print("training profile", json.dumps(prof), flush=True)
    if prof is not None and not 0 < prof["k2_tensor_core_ms"] \
            == prof["k2_ms"]:
        raise AssertionError("K2's device time in the training step is not "
                             "all on its tensor-core kernels")
    if prof is not None and "k4_ms" in prof \
            and not 0 < prof["k4_tensor_core_ms"] == prof["k4_ms"]:
        raise AssertionError("K4's device time in the training step is not "
                             "all on its tensor-core kernels")
    return report, launches


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
    n_blocks = sum(hp.__dict__[m]["nb_blocks"] for m in
                   ("prosody_encoder", "phoneme_encoder", "frame_decoder"))
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
    if f"{direction}_device_ms" in head:  # K2, K4: device time alone
        out.update({
            "device_ms": head[f"{direction}_device_ms"],
            "library_device_ms": head.get(f"{direction}_library_device_ms"),
            "device_ms_at_rate_0.1": drop[f"{direction}_device_ms"]})
    if f"{direction}_staged_ms" in head:  # K4: its GEMMs in cuBLAS
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


def k5_entry(rows, launches, audio, two_step_err, profile, stream,
             audio_cpu):
    """The ``kernels`` entry of K5: errors over every checked shape (fans
    and single units beside their controls), times summed over the three
    launches of one V1 vocode pass at B=8, bucket 512."""
    timed = [r for r in rows if "ms" in r]
    fans = [r for r in rows if r["limit"] == K5_REL_TOL["fan"]]
    units = [r for r in rows if r["limit"] == K5_REL_TOL["unit"]]
    return {
        "name": "fused_mrf", "route": "cuda",
        "source": "daft_exprt_tpu_torch/csrc/mrf_vocoder.cu",
        "replaces": "daft_exprt_tpu/ops/mrf_vocoder.py:127",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "rel_l2": max(r["rel_l2"] for r in fans),
        "control_rel_l2": min(r["control_rel_l2"] for r in fans),
        "rel_l2_limit": K5_REL_TOL["fan"],
        "unit_rel_l2": max(r["rel_l2"] for r in units),
        "unit_control_rel_l2": min(r["control_rel_l2"] for r in units),
        "unit_rel_l2_limit": K5_REL_TOL["unit"],
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in timed) else "bytes",
        "library_ms": None,  # no single PyTorch call computes the fan
        "staged_cudnn_ms": sum(r["staged_cudnn_ms"] for r in timed),
        "at": "one V1 vocode pass: stages 1-3 (C=128/64/32, N=32768/65536/"
              "131072), B=8, bucket 512, bf16 operands",
        "shapes": [{k: r[k] for k in r if k not in ("taps", "halo")}
                   for r in rows],
        "serving": audio, "two_step_max_abs_err": two_step_err,
        "profile": profile, "stream": stream, "card_vs_cpu_f32": audio_cpu,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {json.dumps(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
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

    gen = torch.Generator().manual_seed(0)
    k1 = check_k1(gen)
    rows, launches, engines, requests = serve(flagship_hparams())
    name, pt, inputs = requests[2]  # measure, bucket 512
    profile = profile_request(engines[name], inputs, pt)
    cpu_err = check_against_cpu()
    cumsum = time_duration_cumsum(flagship_hparams())
    k5 = check_k5()
    vocoder = HiFiGanGenerator(seed=0)
    audio, k5_launches, audio_engines, audio_requests = serve_audio(
        engines["speculate"].model, vocoder)
    two_step_err = audio_equals_two_step(audio_engines["audio"], vocoder,
                                         audio_requests[1])
    audio_profile = profile_audio(audio_engines["audio"], audio_requests[1])
    stream = stream_utterance(audio_engines["audio_rerun"], vocoder,
                              audio_requests[-1])
    audio_cpu = audio_against_cpu()
    del vocoder, audio_engines, audio_requests
    k2_plan = check_k2_plan()
    k2 = check_k2()
    k3 = check_conv_ff("K3", K3_SHAPES, gen, 4)
    training, train_launches = train(flagship_hparams(
        batch_size=16, accumulation_steps=3), "conv_ff_train")
    train_cpu = train_against_cpu(flagship_hparams, "conv_ff_train")
    k4_plan = check_k4_plan()
    k4 = check_conv_ff("K4", K4_SHAPES, gen, 9)
    wide, wide_launches = train(wide_head_hparams(
        batch_size=16, accumulation_steps=3), "conv_ff_train_blocked")
    wide_cpu = train_against_cpu(small_wide_hparams, "conv_ff_train_blocked")

    head = next(r for r in k1 if r["shape"] == "frame_decoder"
                and r["dtype"] == "bfloat16")
    entry = {
        "name": "fused_fft_block",
        "route": "cuda",
        "source": "daft_exprt_tpu_torch/csrc/fft_block.cu",
        "replaces": "daft_exprt_tpu/ops/fft_block.py:97",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1
                           if r["dtype"] == "bfloat16"),
        "max_abs_err_f32": max(r["max_abs_err"] for r in k1
                               if r["dtype"] == "float32"),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,  # no single PyTorch call computes K1
        "at": "frame_decoder B=8 T=512 bf16",
        "shapes": [{k: r[k] for k in ("shape", "T", "H", "dtype",
                                      "max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by")} for r in k1],
        "serving": rows,
        "card_vs_cpu_f32_mel_err": cpu_err,
        "durations_cumsum": cumsum,
        "profile": profile,
    }
    k2_src = ("daft_exprt_tpu_torch/csrc/attention_train.cu",
              "daft_exprt_tpu/ops/attention_train.py")
    k3_src = ("daft_exprt_tpu_torch/csrc/conv_ff_train.cu",
              "daft_exprt_tpu/ops/conv_ff_train.py")
    k4_src = ("daft_exprt_tpu_torch/csrc/conv_ff_blocked_tc.cu",
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
        if kernel == "K4":
            extra = dict(instance="tensor_core",
                         launches_tensor_core=wide_launches[tc],
                         cuda_core_source="daft_exprt_tpu_torch/csrc/"
                                          "conv_ff_blocked.cu",
                         smem_bytes_by_width=k4_plan)
        entries.append(kernel_entry(name, kernel, src, f"{ref}:{line}",
                                    main_run[name], rows, direction, library,
                                    launches_wide=wide_launches[name],
                                    **extra))
    entries[1]["training"] = training
    entries[1]["training_card_vs_cpu_f32"] = train_cpu
    entries[5]["training"] = wide
    entries[5]["training_card_vs_cpu_f32"] = wide_cpu
    entries.append(k5_entry(k5, k5_launches, audio, two_step_err,
                            audio_profile, stream, audio_cpu))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
