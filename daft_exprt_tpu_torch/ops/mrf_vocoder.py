"""Fused multi-receptive-field (MRF) vocoder stage: CUDA kernel, wrapper,
plain version.

Port of the Pallas TPU kernel ``daft_exprt_tpu/ops/mrf_vocoder.py``
``_make_kernel`` (K5). One HiFi-GAN upsample stage runs ``nk`` resblock
chains over the same input and averages them; for each chain and each
dilation d

  x <- x + conv2(leaky(conv1_d(leaky(x))))        (ResBlock1)
  x <- x + conv1_d(leaky(x))                      (ResBlock2)

A CUDA kernel computes the whole fan for one time tile per block, with
every inter-conv activation in shared memory; :func:`plan_mrf` names its
instance: at C = 32, 64 and 128 (every V1 stage) the tensor-core one,
``csrc/mrf_vocoder_tc.cu`` (each conv a shifted-row GEMM on bf16
``wgmma``, the taps fed by the TMA unit), at C = 8 and 16 the CUDA-core
one, ``csrc/mrf_vocoder.cu``.
See the sources for what bounds them on an H100 and how the designs answer
it.

Numerics follow the Pallas kernel: every conv's input is leaky(x)
rounded to ``dot_dtype`` (bf16 when serving), its weights are rounded to
``dot_dtype``, products accumulate in float32 and the float32 bias is
added after the tap sum; residual carries are float32; every conv output
is zero outside [0, N) before the next conv reads it (per-conv SAME zero
padding); the chains are summed in order and the sum is multiplied by
``1/nk``. The layout is the plain (B, N, C), channel-last.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from daft_exprt_tpu_torch.ops._build import load_library

LRELU_SLOPE = 0.1
KERNEL_CHANNELS = (8, 16, 32, 64, 128)  # the CUDA kernels' instances
TC_CHANNELS = (32, 64, 128)  # the tensor-core instance's; the rest CUDA-core
SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
_SLACK_ROWS = 8  # rows a thread's last row group may read past the region
# the tensor-core instance (csrc/mrf_vocoder_tc.cu): ring stages of 32
# input channels of one tap (64 C bytes), m64 output tiles a block holds
# (two warpgroups of 128 float32 sums a thread: at C = 128 each takes half
# the columns of every tile, at C = 64 and 32 every other tile)
_TC_STAGES = {128: 5, 64: 8, 32: 8}
_TC_TILES = {128: 4, 64: 8, 32: 16}

# descriptor flags, as in csrc/mrf_vocoder.cu and csrc/mrf_vocoder_tc.cu
CHAIN_START, SECOND_CONV, TO_CARRY, CHAIN_END, FIRST_CHAIN = 1, 2, 4, 8, 16


class MrfProgram(NamedTuple):
    """One stage's resblock fan, packed once per generator.

    ``chains``: per chain, per dilation unit, the unit's convs as
    (weight (C, C, k) float32, bias (C,) float32, dilation). The kernel's
    copy: ``w_taps`` bf16, (n_taps, C_in, C_out) for the CUDA-core
    instance and (n_taps, C_in / 8, C_out, 8) for the tensor-core one (tap
    t's [g, n, e] = weight[n, 8 g + e, t]: the image of wgmma's K-major B
    operand in shared memory, see :func:`pack_taps`), ``biases`` (n_convs, C)
    float32, ``desc`` (n_convs, 5) int32 rows (k, dilation, first tap,
    flags, chain halo), all on the generator's device; ``halo`` is the
    widest chain's one-sided reach in samples."""
    chains: tuple
    w_taps: torch.Tensor
    biases: torch.Tensor
    desc: torch.Tensor
    halo: int


def build_mrf_program(chains) -> MrfProgram:
    """Pack a stage's resblocks.

    :param chains: per chain (resblock), per dilation unit, a list of
        (weight (C_out, C_in, k), bias (C_out,), dilation) -- one conv for
        ResBlock2, two for ResBlock1 (the second at dilation 1)
    """
    packed, taps, biases, desc = [], [], [], []
    reaches = [sum((w.shape[-1] - 1) * d // 2 for unit in chain
                   for w, _, d in unit) for chain in chains]
    for j, chain in enumerate(chains):
        units = []
        for u, unit in enumerate(chain):
            convs = []
            for i, (w, b, d) in enumerate(unit):
                w = w.detach().float()
                b = b.detach().float()
                convs.append((w, b, int(d)))
                flags = (CHAIN_START if u == 0 and i == 0 else 0) \
                    | (SECOND_CONV if i == 1 else 0) \
                    | (TO_CARRY if i == len(unit) - 1 else 0) \
                    | (CHAIN_END if u == len(chain) - 1
                       and i == len(unit) - 1 else 0) \
                    | (FIRST_CHAIN if j == 0 else 0)
                desc.append([w.shape[-1], int(d), len(taps), flags,
                             reaches[j]])
                taps.extend(pack_taps(w))
                biases.append(b)
            units.append(tuple(convs))
        packed.append(tuple(units))
    device = packed[0][0][0][0].device
    return MrfProgram(
        chains=tuple(packed),
        w_taps=torch.stack(taps).contiguous(),
        biases=torch.stack(biases).contiguous(),
        desc=torch.tensor(desc, dtype=torch.int32, device=device),
        halo=max(reaches))


def pack_taps(w):
    """A conv's weight (C_out, C_in, k) as the kernel reads its taps, in
    bf16: (k, C_in, C_out) where the CUDA-core instance takes C, else (k,
    C_in / 8, C_out, 8), 8 input channels of an output channel 16
    contiguous bytes (the tensor-core instance copies a tap's 32 input
    channels into shared memory as they lie)."""
    k, C = w.shape[-1], w.shape[0]
    w = w.to(torch.bfloat16)
    if C not in TC_CHANNELS:
        return w.permute(2, 1, 0)
    return w.permute(2, 0, 1).reshape(k, C, C // 8, 8).permute(0, 2, 1, 3)


# ----------------------------------------------------------------------
# Plain version (PyTorch tensor code): the CPU path and the oracle
# ----------------------------------------------------------------------
def mrf_plain(x, program: MrfProgram, dot_dtype=torch.bfloat16):
    """K5's function in plain PyTorch; same arguments as
    :func:`fused_mrf`. ``dot_dtype=torch.float32`` (no rounding) exists
    for the controls of the tests and ``chip_smoke.py``, never for
    serving. Float32 convs on the card must not take TF32
    (``torch.backends.cudnn.allow_tf32 = False``)."""
    xt = x.float().transpose(1, 2)  # (B, C, N)
    acc = None
    for chain in program.chains:
        cur = xt
        for unit in chain:
            t = cur
            for w, b, d in unit:
                k = w.shape[-1]
                a = F.leaky_relu(t, LRELU_SLOPE).to(dot_dtype).float()
                t = F.conv1d(a, w.to(dot_dtype).float(), dilation=d,
                             padding=(k - 1) * d // 2) + b[:, None]
            cur = cur + t
        acc = cur if acc is None else acc + cur
    return (acc * (1.0 / len(program.chains))).transpose(1, 2).contiguous()


# ----------------------------------------------------------------------
# Wrapper
# ----------------------------------------------------------------------
@functools.cache
def _kernel(tensor_core: bool):
    """The C entry point of ``csrc/mrf_vocoder_tc.cu`` or
    ``csrc/mrf_vocoder.cu``, built at first use."""
    lib = load_library("mrf_vocoder_tc" if tensor_core else "mrf_vocoder")
    fn = lib.mrf_tc_forward if tensor_core else lib.mrf_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_smem_bytes(C: int, halo: int) -> int:
    """The built tensor-core kernel's own count of what :func:`plan_mrf`
    mirrors (0 where it does not take the shape)."""
    fn = load_library("mrf_vocoder_tc").mrf_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    return int(fn(C, halo))


def tile_rows(C: int) -> int:
    """The CUDA-core instance's output samples per block: 8192 / C, so
    that the tile's rows of all channels cost the same at every width."""
    return 8192 // C


def smem_bytes(C: int, halo: int) -> int:
    """Shared memory of one CUDA-core block: the float32 carry over the
    tile and both halos, two bf16 conv operands with slack rows, the
    float32 sum of the chains over the tile."""
    tn = tile_rows(C)
    rows = tn + 2 * halo
    return rows * C * 4 + 2 * (rows + _SLACK_ROWS) * C * 2 + tn * C * 4


def tc_tile_split(C: int) -> int:
    """Warpgroups of the tensor-core instance that split a conv's m64
    tiles between them: 1 at C = 128 (each takes half the columns of
    every tile), 2 at C = 64 and 32 (each every other tile)."""
    return 1 if C == 128 else 2


def tc_smem_bytes(C: int, rows: int) -> int:
    """Shared memory of one tensor-core block over ``rows`` rows: the ring,
    the bf16 operand (C / 8 channel groups of ``rows`` rounded up to 1 mod
    8 rows, 16 bytes each), the float32 carry and the ring's barriers."""
    stages = _TC_STAGES[C]
    group = rows + (1 - rows) % 8
    return stages * 64 * C + 2 * C * group + 4 * C * rows + 16 * stages


class MrfPlan(NamedTuple):
    instance: str     # "tensor_core" or "cuda_core"
    tile_rows: int    # output samples a block owns
    smem_bytes: int   # its dynamic shared memory


def plan_mrf(C: int, halo: int) -> MrfPlan:
    """K5's instance at width C for a fan of one-sided reach ``halo``,
    mirroring the kernels (``tile_rows`` and ``mrf_smem_bytes`` of
    ``csrc/mrf_vocoder_tc.cu``): at C in :data:`TC_CHANNELS` the
    tensor-core instance with the largest tile (a multiple of 64 samples,
    whole m64 output tiles) whose rows, tile plus both halos, fit one
    block's shared memory (:func:`tc_smem_bytes`) and its warpgroups' sums
    (:data:`_TC_TILES` m64 tiles); at C = 8 or 16 the CUDA-core instance
    (:func:`tile_rows`, :func:`smem_bytes`). Raises ValueError where
    neither takes the shape."""
    if C in TC_CHANNELS and halo >= 0:
        rows = 64 * _TC_TILES[C]
        while rows > 0 and tc_smem_bytes(C, rows) > SMEM_LIMIT:
            rows -= 1
        tn = (rows - 2 * halo) // 64 * 64
        if tn >= 64:
            return MrfPlan("tensor_core", tn,
                           tc_smem_bytes(C, tn + 2 * halo))
    elif C in KERNEL_CHANNELS and halo >= 0 \
            and smem_bytes(C, halo) <= SMEM_LIMIT:
        return MrfPlan("cuda_core", tile_rows(C), smem_bytes(C, halo))
    raise ValueError(f"fused_mrf: no kernel takes C={C} with a halo of "
                     f"{halo} samples (C in {KERNEL_CHANNELS}, the tile and "
                     f"both halos within {SMEM_LIMIT} bytes of shared "
                     "memory)")


def _check_cuda(x, program):
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 3:
        raise ValueError("fused_mrf: x must be contiguous float32 (B, N, C)")
    B, N, C = x.shape
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"fused_mrf: the kernel takes C in {KERNEL_CHANNELS}"
                         f", got {C}")
    n_convs = program.desc.shape[0]
    taps = (C // 8, C, 8) if C in TC_CHANNELS else (C, C)
    if (program.w_taps.dtype != torch.bfloat16
            or program.w_taps.shape[1:] != taps
            or tuple(program.biases.shape) != (n_convs, C)
            or any(t.device != x.device for t in (
                program.w_taps, program.biases, program.desc))):
        raise ValueError(f"fused_mrf: program for C={C} on {x.device} "
                         "expected")
    if B == 0 or N == 0:
        raise ValueError("fused_mrf: empty input")
    return plan_mrf(C, program.halo)


def fused_mrf(x, program: MrfProgram):
    """One stage's whole MRF fan.

    :param x: (B, N, C) float32, the stage input after the upsampler
    :param program: :class:`MrfProgram` (see :func:`build_mrf_program`)
    :return: (B, N, C) float32, the mean over the resblock chains

    A CPU tensor takes :func:`mrf_plain` at bf16; a CUDA tensor launches
    the kernel :func:`plan_mrf` names (counted in ``fused_mrf.launches``;
    the tensor-core instance also in ``fused_mrf.tc_launches``; under
    CUDA-graph capture in ``.captured`` and ``.tc_captured``) or raises.
    """
    if x.device.type == "cpu":
        return mrf_plain(x, program)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mrf: unsupported device {x.device}")
    plan = _check_cuda(x, program)
    tensor_core = plan.instance == "tensor_core"
    B, N, C = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        capturing = torch.cuda.is_current_stream_capturing()
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(tensor_core)(
            x.data_ptr(), program.w_taps.data_ptr(),
            program.biases.data_ptr(), program.desc.data_ptr(),
            out.data_ptr(), B, N, C, program.desc.shape[0], program.halo,
            plan.tile_rows, plan.smem_bytes, 1.0 / len(program.chains),
            stream)
    if err != 0:
        raise RuntimeError(f"fused_mrf: CUDA error {err} at launch")
    if capturing:  # recorded into a CUDA graph: runs at its replays
        fused_mrf.captured += 1
        fused_mrf.tc_captured += tensor_core
    else:
        fused_mrf.launches += 1
        fused_mrf.tc_launches += tensor_core
    return out


fused_mrf.launches = 0
fused_mrf.tc_launches = 0  # the launches that took the tensor-core instance
# launches recorded into a CUDA graph under capture (none of them ran)
fused_mrf.captured = 0
fused_mrf.tc_captured = 0
