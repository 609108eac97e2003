"""Fused FFT block forward (inference): CUDA kernels, wrapper, plain version.

Port of the Pallas TPU kernel ``daft_exprt_tpu/ops/fft_block.py:_kernel``
(K1). One FFT block is

  x (T, E) -> QKV -> per-head masked softmax attention -> merge
    -> out proj -> +x -> LN -> row mask
    -> k=3 conv -> relu -> k=3 conv -> +res -> LN -> FiLM -> row mask

computed per batch row with its valid length. Two instances, named by
:func:`plan_fft_block`: bf16 dots at C % 128 == 0 (the serving and
evaluation path) take the tensor-core instance (``csrc/fft_block_tc.cu``:
six or seven launches on ``mma.sync``), float32 dots the CUDA-core one
(``csrc/fft_block.cu``: four launches, the (T, C) conv hidden in shared
memory); both take E = 128, 256, 512 with head dims 16, 64, 128. See the
sources for what bounds each on an H100 and how the design answers it.

Numerics follow the Pallas kernel: dots take operands rounded to
``dot_dtype`` (float32 or bfloat16) with float32 accumulation, rounded at
the same points (q/k/v after the bias, P before PV, ctx, the LN1 output
before the convs, the hidden after the ReLU); LayerNorm and FiLM are
float32; masked logits take ``finfo(float32).min``; the softmax
denominator is floored at 1e-30; hidden rows outside [0, T) are zero.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from daft_exprt_tpu_torch.ops._build import load_library
from daft_exprt_tpu_torch.ops.masking import mask_from_lengths

_NEG = torch.finfo(torch.float32).min
KERNEL_WIDTHS = (128, 256, 512)  # the kernels' model widths E
KERNEL_HEAD_DIMS = (16, 64, 128)  # D = E / H
SMEM_BYTES = 227 * 1024  # one block's dynamic shared memory on an H100
# The tensor-core instance takes conv channels in 128-column GEMM tiles.
TC_CHANNEL_MULTIPLE = 128
# The CUDA-core instance's conv tile (csrc/conv_ff_tile.cuh, shared with
# the training conv-FF K3): 32 output rows, the (32 + 4) x E input and
# (32 + 2) x C hidden in float32, and a 3 x 16 x 128-float weight slice,
# in one block's shared memory; at E=128 that bounds C at 1392.
_CC_ROWS = 32
_CC_WEIGHT_SLICE = 3 * 16 * 128
KERNEL_MAX_CHANNELS = (SMEM_BYTES // 4 - (_CC_ROWS + 4) * 128
                       - _CC_WEIGHT_SLICE) // (_CC_ROWS + 2) // 16 * 16
# The tensor-core instance's shared memory (csrc/fft_block_tc.cu): 128 x
# 128 GEMM tiles, a 3-stage ring of 32-deep bf16 chunks, rows padded by 8
# elements (the convs' operand chunks carry a halo row on each side); the
# E=128 out-projection stages a 128 x (128 + 4) float32 tile; attention
# double-buffers 64-row K and V tiles of one head.
_TC_TILE, _TC_STAGES, _TC_PAD, _TC_DEPTH, _TC_ATTN_ROWS = 128, 3, 8, 32, 64


class FFTBlockWeights(NamedTuple):
    """One block's weights in the kernels' layout ("in x out" matrices,
    conv taps first). The dot weights are rounded to the dot dtype and
    stored in bfloat16 where the tensor-core instance takes them
    (:func:`bf16_weights`), else in float32; the vectors are float32."""
    wqkv: torch.Tensor   # (E, 3E) columns [q | k | v]
    bqkv: torch.Tensor   # (3E,)
    wo: torch.Tensor     # (E, E)
    bo: torch.Tensor     # (E,)
    ln1_s: torch.Tensor  # (E,)
    ln1_b: torch.Tensor  # (E,)
    w1: torch.Tensor     # (3, E, C)
    b1: torch.Tensor     # (C,)
    w2: torch.Tensor     # (3, C, E)
    b2: torch.Tensor     # (E,)
    ln2_s: torch.Tensor  # (E,)
    ln2_b: torch.Tensor  # (E,)


_DOT_WEIGHTS = ("wqkv", "wo", "w1", "w2")


def bf16_weights(c: int, dot_dtype) -> bool:
    """Whether the dot weights of a block with C conv channels are kept in
    bfloat16 (the tensor-core instance's operands) at ``dot_dtype``."""
    return dot_dtype == torch.bfloat16 and c % TC_CHANNEL_MULTIPLE == 0


def pack_weights(in_proj_weight, in_proj_bias, out_proj_weight,
                 out_proj_bias, ln1_weight, ln1_bias, conv1_weight,
                 conv1_bias, conv2_weight, conv2_bias, ln2_weight, ln2_bias,
                 dot_dtype: torch.dtype) -> FFTBlockWeights:
    """Reference-layout block parameters -> :class:`FFTBlockWeights`.

    Inputs are the reference state_dict layouts: in_proj (3E, E), out_proj
    (E, E) as (out, in), convs (out, in, k).
    """
    store = torch.bfloat16 \
        if bf16_weights(conv1_weight.shape[0], dot_dtype) else torch.float32

    def dot_w(w):
        w = w.detach()
        if store != dot_dtype:  # float32 storage of bf16-rounded values
            w = w.to(dot_dtype)
        return w.to(store, memory_format=torch.contiguous_format,
                    copy=True)

    def vec(v):
        return v.detach().float().contiguous()

    return FFTBlockWeights(
        wqkv=dot_w(in_proj_weight.t()), bqkv=vec(in_proj_bias),
        wo=dot_w(out_proj_weight.t()), bo=vec(out_proj_bias),
        ln1_s=vec(ln1_weight), ln1_b=vec(ln1_bias),
        w1=dot_w(conv1_weight.permute(2, 1, 0)), b1=vec(conv1_bias),
        w2=dot_w(conv2_weight.permute(2, 1, 0)), b2=vec(conv2_bias),
        ln2_s=vec(ln2_weight), ln2_b=vec(ln2_bias))


def as_float32(weights: FFTBlockWeights) -> FFTBlockWeights:
    """The same weights with float32 dot weights (the CUDA-core
    instance's layout)."""
    return weights._replace(**{n: getattr(weights, n).float()
                               for n in _DOT_WEIGHTS})


# ----------------------------------------------------------------------
# Plain version (PyTorch tensor code): the CPU path and the oracle
# ----------------------------------------------------------------------
def _layer_norm(y, scale, bias, eps=1e-5):
    mean = y.mean(-1, keepdim=True)
    var = (y - mean).square().mean(-1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + eps) * scale + bias


def _conv_same(x, w):
    """SAME zero-padded conv as shifted matmuls: x (B, T, Cin), w (k, Cin,
    Cout) -> (B, T, Cout) float32. Rows outside [0, T) count as zero."""
    k, T = w.shape[0], x.shape[1]
    pad = (k - 1) // 2
    xp = F.pad(x, (0, 0, pad, pad))
    y = xp[:, 0:T] @ w[0]
    for d in range(1, k):
        y = y + xp[:, d:d + T] @ w[d]
    return y


def fft_block_plain(x, weights: FFTBlockWeights, film, lengths, *,
                    num_heads: int, dot_dtype=torch.float32):
    """K1's function in plain PyTorch; same arguments as
    :func:`fused_fft_block`."""
    def rnd(t):
        return t.to(dot_dtype).float()

    w = as_float32(weights)
    B, T, E = x.shape
    H = num_heads
    D = E // H
    valid = mask_from_lengths(lengths, T)

    qkv = rnd(rnd(x) @ w.wqkv + w.bqkv)
    q, k, v = (t.reshape(B, T, H, D).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    logits = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    logits = logits.masked_fill(~valid[:, None, None, :], _NEG)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = rnd(p / p.sum(-1, keepdim=True).clamp_min(1e-30))
    ctx = rnd((p @ v).transpose(1, 2).reshape(B, T, E))

    attn = _layer_norm(ctx @ w.wo + w.bo + x, w.ln1_s, w.ln1_b)
    attn = torch.where(valid[..., None], attn, 0.0)

    hid = rnd(torch.relu(_conv_same(rnd(attn), w.w1) + w.b1))
    y = _layer_norm(_conv_same(hid, w.w2) + w.b2 + attn, w.ln2_s, w.ln2_b)
    if film is not None:
        y = film[:, None, :E] * y + film[:, None, E:]
    return torch.where(valid[..., None], y, 0.0)


# ----------------------------------------------------------------------
# Dispatch: which instance takes a call
# ----------------------------------------------------------------------
class FFTBlockPlan(NamedTuple):
    instance: str     # "tensor_core" or "cuda_core"
    smem_bytes: int   # the largest dynamic shared memory of its launches


def cuda_core_smem_bytes(e: int, c: int) -> int:
    """The CUDA-core instance's conv tile in float32 (its only dynamic
    shared memory)."""
    return 4 * ((_CC_ROWS + 4) * e + (_CC_ROWS + 2) * c + _CC_WEIGHT_SLICE)


def _tc_smem_bytes(e: int, h: int) -> int:
    """The tensor-core instance's largest launch: the conv ring ((128 + 2)
    x 32 operand rows and 3 x 32 x 128 weights a stage), beside the
    projections' ring (128 x 32 and 32 x 128 a stage), the E=128
    out-projection's float32 tile and attention's two stages of K and V."""
    row = _TC_TILE + _TC_PAD
    conv = (_TC_TILE + 2) * (_TC_DEPTH + _TC_PAD) + 3 * _TC_DEPTH * row
    proj = _TC_TILE * (_TC_DEPTH + _TC_PAD) + _TC_DEPTH * row
    ln_tile = _TC_TILE * (_TC_TILE + 4) * 4 if e == _TC_TILE else 0
    attn = 4 * _TC_ATTN_ROWS * (e // h + _TC_PAD) * 2
    return max(_TC_STAGES * 2 * max(conv, proj), ln_tile, attn)


@functools.lru_cache(maxsize=256)
def plan_fft_block(t: int, e: int, h: int, c: int, dot_dtype) -> FFTBlockPlan:
    """K1's instance at (T, E, H, C) for ``dot_dtype``, mirroring
    ``csrc/fft_block_tc.cu`` and ``csrc/fft_block.cu``: the tensor-core
    instance for bfloat16 dots at C % 128 == 0 (any C: it streams the
    weights), the CUDA-core one otherwise (C % 16 == 0 with its conv tile
    in one block's shared memory, :func:`cuda_core_smem_bytes`). Both take
    E in :data:`KERNEL_WIDTHS`, D = E / H in :data:`KERNEL_HEAD_DIMS` and
    any T. Raises ValueError outside that envelope."""
    del t
    if e not in KERNEL_WIDTHS or h <= 0 or e % h \
            or e // h not in KERNEL_HEAD_DIMS:
        raise ValueError(f"fused_fft_block: the kernels take E in "
                         f"{KERNEL_WIDTHS} with head dims {KERNEL_HEAD_DIMS}, "
                         f"got E={e}, H={h}")
    if dot_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_fft_block: dot_dtype {dot_dtype}")
    if bf16_weights(c, dot_dtype):
        return FFTBlockPlan("tensor_core", _tc_smem_bytes(e, h))
    smem = cuda_core_smem_bytes(e, c)
    if c <= 0 or c % 16 or smem > SMEM_BYTES:
        raise ValueError(f"fused_fft_block: the CUDA-core kernel takes conv "
                         f"channels C % 16 == 0 within {SMEM_BYTES} bytes of "
                         f"shared memory ({smem} at E={e}, C={c})")
    return FFTBlockPlan("cuda_core", smem)


# ----------------------------------------------------------------------
# Wrapper
# ----------------------------------------------------------------------
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _cuda_core_kernel():
    """The C entry point of ``csrc/fft_block.cu``, built at first use."""
    fn = load_library("fft_block").fft_block_forward
    fn.argtypes = [_P] * 15 + [_I] + [_P] * 4 + [_I] * 6 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def _tc_kernels():
    """The C entry points of ``csrc/fft_block_tc.cu``, built at first use:
    (workspace bytes, forward)."""
    lib = load_library("fft_block_tc")
    ws = lib.fft_block_tc_workspace_bytes
    ws.argtypes, ws.restype = [_I] * 5, ctypes.c_longlong
    fwd = lib.fft_block_tc_forward
    fwd.argtypes = [_P] * 15 + [_I] + [_P] * 2 + [_I] * 5 + [_P]
    fwd.restype = _I
    return ws, fwd


def kernel_smem_bytes(e: int, h: int, c: int, instance: str) -> int:
    """The built kernels' own count of what :func:`plan_fft_block` mirrors:
    the largest dynamic shared memory of the instance's launches."""
    if instance == "tensor_core":
        fn = load_library("fft_block_tc").fft_block_tc_smem_bytes
        fn.argtypes, args = [_I] * 3, (e, h, c)
    else:
        fn = load_library("fft_block").fft_block_smem_bytes
        fn.argtypes, args = [_I] * 2, (e, c)
    fn.restype = ctypes.c_longlong
    return int(fn(*args))


@functools.lru_cache(maxsize=64)
def _tc_workspace_bytes(B, T, E, C, H):
    nbytes = _tc_kernels()[0](B, T, E, C, H)
    if nbytes < 0:
        raise ValueError(f"fused_fft_block: the tensor-core kernel does not "
                         f"take {(B, T, E)}, C={C}, H={H}")
    return nbytes


@functools.lru_cache(maxsize=64)
def _weight_specs(E, C, dot):
    """(name, shape, dtype) of every weight the instance reads."""
    f32 = torch.float32
    return (("wqkv", (E, 3 * E), dot), ("bqkv", (3 * E,), f32),
            ("wo", (E, E), dot), ("bo", (E,), f32), ("ln1_s", (E,), f32),
            ("ln1_b", (E,), f32), ("w1", (3, E, C), dot), ("b1", (C,), f32),
            ("w2", (3, C, E), dot), ("b2", (E,), f32), ("ln2_s", (E,), f32),
            ("ln2_b", (E,), f32))


def _check_cuda(x, weights, film, lengths, tensor_core):
    """Raise on what the instance does not take; return FiLM's row
    stride (0 without FiLM)."""
    B, T, E = x.shape
    dev = x.device
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("fused_fft_block: x must be contiguous float32")
    dot = torch.bfloat16 if tensor_core else torch.float32
    for name, shape, dtype in _weight_specs(E, weights.w1.shape[-1], dot):
        t = getattr(weights, name)
        if (t.shape != shape or t.dtype != dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"fused_fft_block: weight {name} must be "
                             f"contiguous {dtype} {shape} on {dev}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or lengths.device != dev or not lengths.is_contiguous():
        raise ValueError("fused_fft_block: lengths must be contiguous int32 "
                         f"(B,) on {dev}")
    if film is None:
        return 0
    # rows of 2E float32, 16-byte aligned, any batch stride (a block's
    # slice of the (B, blocks, 2E) FiLM tensor is taken as it is)
    if (film.shape != (B, 2 * E) or film.dtype != torch.float32
            or film.device != dev or film.stride(1) != 1
            or film.stride(0) % 4 or film.data_ptr() % 16):
        raise ValueError("fused_fft_block: film must be float32 (B, 2E) on "
                         f"{dev}, rows contiguous and 16-byte aligned")
    return film.stride(0)


def fft_block_cuda(x, weights: FFTBlockWeights, film, lengths, *,
                   num_heads: int, dot_dtype, instance=None):
    """K1 on CUDA tensors: the instance :func:`plan_fft_block` names, or
    ``instance`` ("cuda_core" also takes bf16 rounding, on float32 weights:
    :func:`as_float32`). Counted in ``fused_fft_block.launches`` (and
    ``.tc_launches`` on the tensor-core instance); raises on what the
    kernels do not take or on a launch error."""
    B, T, E = x.shape
    C = weights.w1.shape[-1]
    planned = plan_fft_block(T, E, num_heads, C, dot_dtype).instance
    instance = instance or planned
    if instance not in (planned, "cuda_core"):
        raise ValueError(f"fused_fft_block: no {instance} instance at "
                         f"E={E}, H={num_heads}, C={C}, {dot_dtype}")
    tensor_core = instance == "tensor_core"
    film_stride = _check_cuda(x, weights, film, lengths, tensor_core)
    w = weights
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), lengths.data_ptr(), w.wqkv.data_ptr(),
                w.bqkv.data_ptr(), w.wo.data_ptr(), w.bo.data_ptr(),
                w.ln1_s.data_ptr(), w.ln1_b.data_ptr(), w.w1.data_ptr(),
                w.b1.data_ptr(), w.w2.data_ptr(), w.b2.data_ptr(),
                w.ln2_s.data_ptr(), w.ln2_b.data_ptr(),
                None if film is None else film.data_ptr(), film_stride)
        if tensor_core:
            ws = torch.empty(_tc_workspace_bytes(B, T, E, C, num_heads),
                             dtype=torch.uint8, device=x.device)
            err = _tc_kernels()[1](*args, ws.data_ptr(), out.data_ptr(), B,
                                   T, E, C, num_heads, stream)
        else:
            # qkv (B T, 3E), ctx and attn (B T, E) float32
            scratch = torch.empty((5, B * T, E), dtype=torch.float32,
                                  device=x.device)
            err = _cuda_core_kernel()(
                *args, scratch[0].data_ptr(), scratch[3].data_ptr(),
                scratch[4].data_ptr(), out.data_ptr(), B, T, E, C,
                num_heads, int(dot_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_fft_block: CUDA error {err} at launch")
    fused_fft_block.launches += 1
    fused_fft_block.tc_launches += tensor_core
    return out


def fused_fft_block(x, weights: FFTBlockWeights, film, lengths, *,
                    num_heads: int, dot_dtype=torch.bfloat16):
    """One whole FFT block forward.

    :param x: (B, T, E) float32
    :param weights: :class:`FFTBlockWeights` (see :func:`pack_weights`)
    :param film: (B, 2E) [gammas | betas] float32 (rows contiguous; any
        batch stride), or None for identity
    :param lengths: (B,) int32 valid lengths (contiguous-from-zero masks)
    :return: (B, T, E) float32, rows at or past each length zero

    A CPU tensor takes :func:`fft_block_plain`; a CUDA tensor launches the
    instance :func:`plan_fft_block` names (:func:`fft_block_cuda`, counted
    in ``fused_fft_block.launches`` and ``.tc_launches``) or raises.
    """
    if x.device.type == "cpu":
        return fft_block_plain(x, weights, film, lengths,
                               num_heads=num_heads, dot_dtype=dot_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_fft_block: unsupported device {x.device}")
    return fft_block_cuda(x, weights, film, lengths, num_heads=num_heads,
                          dot_dtype=dot_dtype)


fused_fft_block.launches = 0
fused_fft_block.tc_launches = 0
