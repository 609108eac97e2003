"""Fused FFT block forward (inference): CUDA kernels, wrapper, plain version.

Port of the Pallas TPU kernel ``daft_exprt_tpu/ops/fft_block.py:_kernel``
(K1). One FFT block is

  x (T, E) -> QKV -> per-head masked softmax attention -> merge
    -> out proj -> +x -> LN -> row mask
    -> k=3 conv -> relu -> k=3 conv -> +res -> LN -> FiLM -> row mask

computed per batch row with its valid length. Two instances, named by
:func:`plan_fft_block`: bf16 dots at C % 128 == 0 (the serving and
evaluation path) take the tensor-core instance (``csrc/fft_block_tc.cu``:
three launches on ``wgmma``, the weights streamed from images made once a
weight version, :func:`pack_images`), float32 dots the CUDA-core one
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
import threading
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
# The tensor-core instance's shared memory (csrc/fft_block_tc.cuh), which
# the plan mirrors: rings of 8 KB weight blocks (64 x 64 bf16), each as
# deep as the rest leaves (launches 1 and 3 up to 24 stages, at least 8 in
# launch 3; launch 2 up to 12 a warpgroup), 8 bytes of mbarrier a
# barrier. Launch 1 holds two 64-row tiles of rnd(x); launch 2 ctx (64 x E
# bf16), a Q tile a warpgroup, LN1's row sums (a warpgroup's and the
# block's) and its rings of K or V tiles (16 KB at D=128, else 8 KB);
# launch 3 conv1's operand (64 mt + 2 rows for its mt m64 tiles, rounded
# up to 1 KB) and its block's share of the hidden, or the float32 pre-LN
# tile over both. C is split over a cluster of up to 8 blocks where one
# block's share does not fit, and launch 3 runs in equal chunks of the
# hidden where a cluster of 8 does not hold it.
_TC_BLOCK, _TC_ROWS, _TC_CLUSTER = 8192, 64, 8
_TC_RING_MAX = _TC_CONV_RING_MAX = 24


class FFTBlockWeights(NamedTuple):
    """One block's weights in the kernels' layout ("in x out" matrices,
    conv taps first). The dot weights are rounded to the dot dtype and
    stored in bfloat16 where the tensor-core instance takes them
    (:func:`bf16_weights`), else in float32; the vectors are float32.
    Where the tensor-core instance takes the block, ``images`` holds the
    bf16 dot weights as it streams them (:func:`pack_images`) and the four
    dot-weight fields are None (:func:`unpacked` rebuilds them); elsewhere
    ``images`` is None."""
    wqkv: torch.Tensor | None  # (E, 3E) columns [q | k | v]
    bqkv: torch.Tensor   # (3E,)
    wo: torch.Tensor | None    # (E, E)
    bo: torch.Tensor     # (E,)
    ln1_s: torch.Tensor  # (E,)
    ln1_b: torch.Tensor  # (E,)
    w1: torch.Tensor | None    # (3, E, C)
    b1: torch.Tensor     # (C,)
    w2: torch.Tensor | None    # (3, C, E)
    b2: torch.Tensor     # (E,)
    ln2_s: torch.Tensor  # (E,)
    ln2_b: torch.Tensor  # (E,)
    images: torch.Tensor | None = None  # (4 E^2 + 6 E C,) bf16


_DOT_WEIGHTS = ("wqkv", "wo", "w1", "w2")


def bf16_weights(c: int, dot_dtype) -> bool:
    """Whether the dot weights of a block with C conv channels are kept in
    bfloat16 (the tensor-core instance's operands) at ``dot_dtype``."""
    return dot_dtype == torch.bfloat16 and c % TC_CHANNEL_MULTIPLE == 0


def _image(w):
    """A (K, N) matrix as the tensor-core instance's weight image: the
    64 x 64 blocks of each 64-column slice in K order, each block [8][64][8]
    (8 K rows of a column 16 bytes apart: the no-swizzle K-major layout of a
    wgmma B operand), flat."""
    k, n = w.shape
    return w.reshape(k // 64, 8, 8, n // 64, 64).permute(3, 0, 1, 4, 2) \
        .reshape(-1)


def _from_image(img, k, n):
    return img.reshape(n // 64, k // 64, 8, 64, 8).permute(1, 2, 4, 0, 3) \
        .reshape(k, n)


def pack_images(wqkv, wo, w1, w2):
    """The bf16 dot weights (:class:`FFTBlockWeights` layout) as one flat
    bf16 tensor of weight images, in launch order: Wqkv (E, 3E), Wo (E, E),
    W1 as (3E, C) and W2 as (3C, E), rows tap-major."""
    e, c = w1.shape[1], w1.shape[2]
    return torch.cat([_image(wqkv), _image(wo), _image(w1.reshape(3 * e, c)),
                      _image(w2.reshape(3 * c, e))]).contiguous()


def unpack_images(images, e: int, c: int):
    """(wqkv, wo, w1, w2) back from :func:`pack_images`."""
    sizes = (3 * e * e, e * e, 3 * e * c, 3 * c * e)
    wqkv, wo, w1, w2 = torch.split(images, sizes)
    return (_from_image(wqkv, e, 3 * e), _from_image(wo, e, e),
            _from_image(w1, 3 * e, c).reshape(3, e, c),
            _from_image(w2, 3 * c, e).reshape(3, c, e))


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

    w = FFTBlockWeights(
        wqkv=dot_w(in_proj_weight.t()), bqkv=vec(in_proj_bias),
        wo=dot_w(out_proj_weight.t()), bo=vec(out_proj_bias),
        ln1_s=vec(ln1_weight), ln1_b=vec(ln1_bias),
        w1=dot_w(conv1_weight.permute(2, 1, 0)), b1=vec(conv1_bias),
        w2=dot_w(conv2_weight.permute(2, 1, 0)), b2=vec(conv2_bias),
        ln2_s=vec(ln2_weight), ln2_b=vec(ln2_bias))
    if store == torch.bfloat16 and w.wo.shape[0] in KERNEL_WIDTHS:
        w = w._replace(images=pack_images(w.wqkv, w.wo, w.w1, w.w2),
                       **dict.fromkeys(_DOT_WEIGHTS))
    return w


def unpacked(weights: FFTBlockWeights) -> FFTBlockWeights:
    """The same weights with the dot-weight fields set: rebuilt from the
    images where :func:`pack_weights` kept only those."""
    if weights.images is None:
        return weights
    e, c = weights.bo.shape[0], weights.b1.shape[0]
    return weights._replace(images=None, **dict(zip(
        _DOT_WEIGHTS, unpack_images(weights.images, e, c))))


def as_float32(weights: FFTBlockWeights) -> FFTBlockWeights:
    """The same weights with float32 dot weights (the CUDA-core
    instance's layout)."""
    weights = unpacked(weights)
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


def _tc_conv_region(e: int, blocks: int) -> int:
    """Launch 3's operand and hidden with ``blocks`` 64-channel hidden
    blocks a block: mt m64 row tiles (2 at E=128, else 1), the operand's
    64 mt + 2 rows rounded up to 1 KB, then the hidden's; or the pre-LN
    tile over both."""
    rows = _TC_ROWS * (2 if e == 128 else 1)
    operand = -(-(rows + 2) * e * 2 // 1024) * 1024
    return max(operand + blocks * _TC_BLOCK * rows // _TC_ROWS,
               rows * (e + 8) * 4)


def _tc_conv_stages(e: int, blocks: int) -> int:
    """Launch 3's ring: as many stages (an even count) as the shared
    memory leaves, up to 24."""
    free = (SMEM_BYTES - _tc_conv_region(e, blocks)) // (_TC_BLOCK + 16)
    return min(_TC_CONV_RING_MAX, free // 2 * 2)


def _tc_cluster(e: int, blocks: int) -> int:
    """The smallest cluster over which ``blocks`` 64-channel hidden blocks
    fit beside 8 ring stages (0: none up to 8 blocks does)."""
    cs = 1
    while cs <= min(_TC_CLUSTER, blocks):
        if _tc_conv_stages(e, -(-blocks // cs)) >= 8:
            return cs
        cs *= 2
    return 0


def _tc_conv_chunks(e: int, c: int) -> int:
    """Launch 3's chunks of the hidden: 1 where a cluster holds it, else
    the fewest equal ones that a cluster of 8 holds."""
    n = 1
    while not _tc_cluster(e, -(-(c // 64) // n)):
        n += 1
    return n


def _tc_smem_bytes(e: int, h: int, c: int) -> int:
    """The tensor-core instance's largest launch (launch 3 at its largest
    chunk and smallest cluster)."""
    d = e // h
    tile = 2 * _TC_ROWS * d
    stage = max(tile, _TC_BLOCK)
    rows = 4 * _TC_ROWS * e
    qkv = rows + min(_TC_RING_MAX, (SMEM_BYTES - rows) // (_TC_BLOCK + 16)) \
        * (_TC_BLOCK + 16)
    fixed = 2 * _TC_ROWS * e + 2 * tile + 6 * _TC_ROWS * 4
    stages = min(12, (SMEM_BYTES - fixed) // (2 * (stage + 16)))
    attn = fixed + 2 * stages * (stage + 16)
    chunk = -(-(c // 64) // _tc_conv_chunks(e, c))
    blocks = -(-chunk // _tc_cluster(e, chunk))
    conv = _tc_conv_region(e, blocks) \
        + _tc_conv_stages(e, blocks) * (_TC_BLOCK + 16)
    return max(qkv, attn, conv)


@functools.lru_cache(maxsize=256)
def plan_fft_block(t: int, e: int, h: int, c: int, dot_dtype) -> FFTBlockPlan:
    """K1's instance at (T, E, H, C) for ``dot_dtype``, mirroring
    ``csrc/fft_block_tc.cuh`` and ``csrc/fft_block.cu``: the tensor-core
    instance for bfloat16 dots at C % 128 == 0 (it streams the weights;
    its conv launch runs in chunks of the hidden past what a cluster of 8
    blocks holds: C above 4096, 8192, 6144 at E = 128, 256, 512), the
    CUDA-core one otherwise (C % 16 == 0 with
    its conv tile in one block's shared memory,
    :func:`cuda_core_smem_bytes`). Both take E in :data:`KERNEL_WIDTHS`,
    D = E / H in :data:`KERNEL_HEAD_DIMS` and any T. Raises ValueError
    outside that envelope."""
    del t
    if e not in KERNEL_WIDTHS or h <= 0 or e % h \
            or e // h not in KERNEL_HEAD_DIMS:
        raise ValueError(f"fused_fft_block: the kernels take E in "
                         f"{KERNEL_WIDTHS} with head dims {KERNEL_HEAD_DIMS}, "
                         f"got E={e}, H={h}")
    if dot_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_fft_block: dot_dtype {dot_dtype}")
    if c > 0 and bf16_weights(c, dot_dtype):
        return FFTBlockPlan("tensor_core", _tc_smem_bytes(e, h, c))
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
_COUNT_LOCK = threading.Lock()


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
    fwd.argtypes = _TC_ARGTYPES
    fwd.restype = _I
    return ws, fwd


# fft_block_tc_forward's arguments: x, lengths, images, the eight vectors,
# film, film_stride, workspace, out, B, T, E, C, H, stream
_TC_ARGTYPES = [_P] * 12 + [_I] + [_P] * 2 + [_I] * 5 + [_P]


def tc_kernel_weights(w: FFTBlockWeights):
    """The tensor-core launch's weight pointers after (x, lengths): the
    images, then the vectors."""
    return (w.images.data_ptr(), w.bqkv.data_ptr(), w.bo.data_ptr(),
            w.ln1_s.data_ptr(), w.ln1_b.data_ptr(), w.b1.data_ptr(),
            w.b2.data_ptr(), w.ln2_s.data_ptr(), w.ln2_b.data_ptr())


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
def _weight_specs(E, C, tensor_core):
    """(name, shape, dtype) of every weight the instance reads: the
    vectors, then the dot weights (the tensor-core instance's as images)."""
    f32 = torch.float32
    vectors = (("bqkv", (3 * E,), f32), ("bo", (E,), f32),
               ("ln1_s", (E,), f32), ("ln1_b", (E,), f32), ("b1", (C,), f32),
               ("b2", (E,), f32), ("ln2_s", (E,), f32), ("ln2_b", (E,), f32))
    if tensor_core:
        return vectors + (("images", (4 * E * E + 6 * E * C,),
                           torch.bfloat16),)
    return vectors + (("wqkv", (E, 3 * E), f32), ("wo", (E, E), f32),
                      ("w1", (3, E, C), f32), ("w2", (3, C, E), f32))


def _check_cuda(x, weights, film, lengths, tensor_core):
    """Raise on what the instance does not take; return FiLM's row
    stride (0 without FiLM)."""
    B, T, E = x.shape
    dev = x.device
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("fused_fft_block: x must be contiguous float32")
    C = weights.b1.shape[0]
    for name, shape, dtype in _weight_specs(E, C, tensor_core):
        t = getattr(weights, name)
        if (t is None or t.shape != shape or t.dtype != dtype
                or t.device != dev or not t.is_contiguous()):
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
    ``.tc_launches`` on the tensor-core instance), or ``.captured`` (and
    ``.tc_captured``) under CUDA-graph capture; raises on what the
    kernels do not take or on a launch error."""
    B, T, E = x.shape
    C = weights.b1.shape[0]
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
        capturing = torch.cuda.is_current_stream_capturing()
        stream = torch.cuda.current_stream().cuda_stream
        film_ptr = None if film is None else film.data_ptr()
        if tensor_core:
            ws = torch.empty(_tc_workspace_bytes(B, T, E, C, num_heads),
                             dtype=torch.uint8, device=x.device)
            err = _tc_kernels()[1](
                x.data_ptr(), lengths.data_ptr(), *tc_kernel_weights(w),
                film_ptr, film_stride, ws.data_ptr(), out.data_ptr(), B, T,
                E, C, num_heads, stream)
        else:
            # qkv (B T, 3E), ctx and attn (B T, E) float32
            scratch = torch.empty((5, B * T, E), dtype=torch.float32,
                                  device=x.device)
            err = _cuda_core_kernel()(
                x.data_ptr(), lengths.data_ptr(), w.wqkv.data_ptr(),
                w.bqkv.data_ptr(), w.wo.data_ptr(), w.bo.data_ptr(),
                w.ln1_s.data_ptr(), w.ln1_b.data_ptr(), w.w1.data_ptr(),
                w.b1.data_ptr(), w.w2.data_ptr(), w.b2.data_ptr(),
                w.ln2_s.data_ptr(), w.ln2_b.data_ptr(), film_ptr,
                film_stride, scratch[0].data_ptr(), scratch[3].data_ptr(),
                scratch[4].data_ptr(), out.data_ptr(), B, T, E, C,
                num_heads, int(dot_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_fft_block: CUDA error {err} at launch")
    with _COUNT_LOCK:  # replica threads of a data-parallel engine
        if capturing:  # recorded into a CUDA graph: runs at its replays
            fused_fft_block.captured += 1
            fused_fft_block.tc_captured += tensor_core
        else:
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
# launches recorded into a CUDA graph under capture (none of them ran)
fused_fft_block.captured = 0
fused_fft_block.tc_captured = 0
