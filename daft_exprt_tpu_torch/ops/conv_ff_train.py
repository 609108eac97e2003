"""Training conv feed-forward with in-kernel dropout: K3 and its C-blocked
variant K4. CUDA kernels, wrappers, plain versions, the dispatch plan and
the autograd Function.

Port of the Pallas TPU kernels ``daft_exprt_tpu/ops/conv_ff_train.py``
``_fwd_kernel`` and ``_bwd_kernel`` (K3) and ``_fwd_kernel_blocked``,
``_bwd_rowlocal_kernel``, ``_bwd_blockgrads_kernel`` and
``_bwd_dx_kernel`` (K4). One FFT block's feed-forward half for training:

  out = gamma * LN(dropout(conv2(relu(conv1(x)))) + x) + beta

with k=3 SAME convs as shifted matmuls (rows outside [0, T) are zero; no
length mask: the block masks rows afterwards). The backward recomputes
the hidden from x and forms dx, the conv weight and bias gradients
(summed over the batch), the LayerNorm scale and bias gradients and the
per-row FiLM gradient. Dropout on the conv output uses the same
counter-based hash as K2 (salt 0, row t, column e); kept values are
divided by ``1 - rate``. K4 is the same function with the C hidden
channels taken in blocks: conv2's sum a2 starts as the first block's
partial plus b2 and adds each later block's partial in block order, and
dx = dr + the blocks' conv1 transposes in block order, as the Pallas
kernels accumulate them.

Numerics follow the Pallas kernels: x is rounded to the compute dtype
before conv1, the hidden after the ReLU, the dropped-out LN-input
gradient (da2) before dW2 and dh, da1 before dW1 and dx; the weights are
cast to the compute dtype; LayerNorm, FiLM, dr and every accumulation
are float32.

Parameters are taken in the port's (reference PyTorch) layouts: conv
weights (out, in, k), vectors (n,), FiLM (B, 2E) ``[gammas | betas]``;
the gradients come back in the same layouts. :func:`plan_conv_ff` picks
K3 or K4 from the shapes. On a CUDA tensor the wrappers launch K3's
kernels (counted in ``conv_ff_train.fwd_launches`` and ``.bwd_launches``)
or K4's (``conv_ff_train_blocked.fwd_launches`` and ``.bwd_launches``),
or raise; on a CPU tensor they take the plain versions below. Each has
two instances, which :func:`plan_conv_ff_train` and
:func:`plan_conv_ff_blocked` name: bfloat16 dots (the training path) take
the tensor-core one, ``csrc/conv_ff_blocked_tc.cu`` on the ``wgmma``
cores of ``csrc/conv_ff_wgmma.cuh`` for both (3 launches forward, 7
backward, chained by programmatic dependent launch; the weights as the
images :func:`tc_weights` packs; :func:`tc_launch_plan` mirrors its
launches; also counted in ``tc_fwd_launches`` and ``tc_bwd_launches`` on
the same functions), float32 dots the CUDA-core ones,
``csrc/conv_ff_train.cu`` (K3) and ``csrc/conv_ff_blocked.cu`` (K4). A
launch under CUDA-graph capture (the training step's graph,
``training/step.py``) is counted in
``fwd_captured``/``bwd_captured`` (and ``tc_...``) instead: it runs at
every replay of the graph, where no wrapper runs.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from daft_exprt_tpu_torch.ops._build import load_library
from daft_exprt_tpu_torch.ops.attention_train import (dropout_threshold,
                                                      keep_mask)
# the conv tile K1 shares with these kernels bounds C the same way
from daft_exprt_tpu_torch.ops.fft_block import KERNEL_MAX_CHANNELS

_EPS = 1e-5
KERNEL_WIDTH = 128
KERNEL_CHANNEL_MULTIPLE = 64  # the weight-gradient product's 64-wide tile
# K4: widths E = 128 .. 512 in steps of 128 (one register accumulator of
# E / 32 columns per lane), C blocks of multiples of 128 within one
# block's 227 KB of dynamic shared memory on an H100
BLOCKED_WIDTH_MULTIPLE = 128
BLOCKED_MAX_WIDTH = 512
BLOCKED_C_BLOCK = 128  # the plan's block: 4-channel groups fill 256 threads
SMEM_BYTES = 227 * 1024
_ROW_TILE = 32  # rows per tile (conv_ff_tile.cuh TT)
_K3_WEIGHT_SLICE = 16  # conv_ff_tile.cuh KC2
# The tensor-core instance of K3 and K4 (csrc/conv_ff_blocked_tc.cu on the
# wgmma cores of csrc/conv_ff_wgmma.cuh): 128 x 128 output tiles; the
# activations as bf16 images of 64-row chunks that store 66 rows (a halo
# row on each side); the conv GEMMs' ring of 3 stages (64 input channels of
# the tile's two chunks and the three taps' 64 x 128 weight blocks), the
# weight gradients' of 8 (a chunk of 64 channels of the first factor and
# of 128 of the second); the conv GEMMs with N = E columns and the weight
# gradients split K over a cluster of at most 8 blocks, sized for the
# least-loaded SM of an H100's 132
TC_TILE = 128
TC_CHUNK = 64
TC_CHUNK_ROWS = TC_CHUNK + 2
TC_CONV_STAGES = 3
TC_WGRAD_STAGES = 8
TC_WGRAD_M = 64
TC_SMS = 132
TC_MAX_CLUSTER = 8
# k16 columns of a partial sum (fresh f32 accumulators a k64 chunk, added
# in order); 192 and 0 (chained) are chip_smoke.py's comparisons
TC_SUM_K = 64
_TC_CONV_STAGE = 2 * 8 * TC_CHUNK_ROWS * 16 + 3 * 64 * TC_TILE * 2
_TC_WGRAD_STAGE = (8 + 16) * TC_CHUNK_ROWS * 16


def _rnd(t, dot_dtype):
    return t.to(dot_dtype).float()


def kernel_weights(w1, w2, dot_dtype):
    """Reference conv weights (out, in, 3) -> the kernels' (3, in, out),
    rounded to the dot dtype, as float32: (w1 (3, E, C), w2 (3, C, E))."""
    return (_rnd(w1.permute(2, 1, 0), dot_dtype).contiguous(),
            _rnd(w2.permute(2, 1, 0), dot_dtype).contiguous())


class TCWeights(NamedTuple):
    """The tensor-core instance's bfloat16 weights as images of its K-major
    B operand (:func:`pack_image`): w1 (conv1: K = E, N = C), w2 (conv2:
    K = C, N = E), and the tap-reversed transposes the data gradients take,
    w1r (tap d = W1[2 - d]^T: K = C, N = E) and w2r (K = E, N = C).
    :func:`unpack_image` gives back the kernel layout (3, K, N)."""
    w1: torch.Tensor
    w2: torch.Tensor
    w1r: torch.Tensor
    w2r: torch.Tensor


def pack_image(w):
    """Conv weight (N, K, 3) (out, in, tap) -> the bfloat16 image
    (N/128, K/64, 3, 8, 128, 8): for each 128-column tile and 64-row chunk
    of K the three taps' blocks [k // 8][n][k % 8], each a contiguous
    16 KB that one bulk copy brings into shared memory. One cast-copy; N
    and K that the instance does not take are padded with zeros."""
    N, K, _ = w.shape
    w = w.detach()
    if N % TC_TILE or K % 64:
        w = F.pad(w, (0, 0, 0, -K % 64, 0, -N % TC_TILE))
    return w.reshape(-(-N // TC_TILE), TC_TILE, -(-K // 64), 8, 8,
                     3).permute(0, 2, 5, 3, 1, 4).to(
        torch.bfloat16, memory_format=torch.contiguous_format)


def unpack_image(image, k=None, n=None):
    """:func:`pack_image`'s image -> the kernel layout (3, K, N), cut to
    K and N where given."""
    nt, kc = image.shape[:2]
    w = image.permute(2, 1, 3, 5, 0, 4).reshape(3, 64 * kc, TC_TILE * nt)
    return w[:, :k, :n]


# w1 -> (versions and addresses of w1 and w2, w2, TCWeights), while w1 lives
_TC_WEIGHTS = WeakIdKeyDictionary()


def tc_weights(w1, w2) -> TCWeights:
    """:class:`TCWeights` from reference conv weights (out, in, 3). They
    are kept while ``w1`` lives and made again only when either weight is
    replaced or changes in place (which moves its version counter), so the
    micro-batches of an optimizer step, forward and backward, share one
    set."""
    key = (w1._version, w2._version, w1.data_ptr(), w2.data_ptr())
    kept = _TC_WEIGHTS.get(w1)
    if kept is not None and kept[0] == key and kept[1]() is w2:
        return kept[2]
    made = TCWeights(pack_image(w1), pack_image(w2),
                     pack_image(w1.detach().transpose(0, 1).flip(2)),
                     pack_image(w2.detach().transpose(0, 1).flip(2)))
    _TC_WEIGHTS[w1] = (key, weakref.ref(w2), made)
    return made


def drop_tc_weights():
    """Forget every kept :class:`TCWeights`: the next call casts anew. A
    pass captured into a CUDA graph starts with this, so that the graph
    casts the weights at every replay instead of reading a set an eager
    run made (which a later cast would free)."""
    _TC_WEIGHTS.clear()


# ----------------------------------------------------------------------
# Dispatch: which kernel takes a shape
# ----------------------------------------------------------------------
def k3_takes(E: int, C: int) -> bool:
    """K3's envelope: E = 128 and the (32 + 2) x C hidden tile of the
    shared conv tile in one block's shared memory."""
    return (E == KERNEL_WIDTH and C % KERNEL_CHANNEL_MULTIPLE == 0
            and C <= KERNEL_MAX_CHANNELS)


def blocked_smem_bytes(E: int, c_block: int) -> int:
    """Dynamic shared memory of one K4 tile (``csrc/conv_ff_blocked.cu``
    ``smem_floats``): the (32 + 6) x E input halo and the (32 + 2) x
    c_block hidden, or the backward's 8 x 5 partial rows of E."""
    tile = (_ROW_TILE + 6) * E + (_ROW_TILE + 2) * c_block
    return 4 * max(tile, 40 * E)


def blocked_takes(E: int, C: int, c_block: int) -> bool:
    """K4's envelope."""
    return (E % BLOCKED_WIDTH_MULTIPLE == 0 and 0 < E <= BLOCKED_MAX_WIDTH
            and c_block > 0 and c_block % BLOCKED_WIDTH_MULTIPLE == 0
            and C % c_block == 0
            and blocked_smem_bytes(E, c_block) <= SMEM_BYTES)


class ConvFFPlan(NamedTuple):
    instance: str     # "tensor_core" or "cuda_core"
    rows: int         # output rows a block owns
    smem_bytes: int   # the largest dynamic shared memory of its launches


def _tc_smem():
    """Dynamic shared memory of the tensor-core instance's three GEMM
    launches (``csrc/conv_ff_blocked_tc.cu``): the conv ring (3 stages and
    their 6 mbarriers) with conv_c's 8 warps x 128 float32 db1 sums after
    it, the same ring for conv_e (its partial tile and row sums go over the
    drained ring), and the weight gradients' ring."""
    ring = TC_CONV_STAGES * _TC_CONV_STAGE + 16 * TC_CONV_STAGES
    return (ring + 8 * TC_TILE * 4, ring,
            TC_WGRAD_STAGES * _TC_WGRAD_STAGE + 16 * TC_WGRAD_STAGES)


def _tc_plan(e: int) -> ConvFFPlan:
    """The tensor-core instance at width E: 128-row tiles and the largest
    shared memory of its launches. E, T and C do not enter."""
    del e
    return ConvFFPlan("tensor_core", TC_TILE, max(_tc_smem()))


class TCLaunchPlan(NamedTuple):
    """The tensor-core instance's launches for one call, as
    ``conv_ff_blocked_tc_plan`` gives them."""
    row_tiles: int    # 128-row tiles of a batch row
    image_rows: int   # rows an image stores a batch row (66 a 64-row chunk)
    e_splits: int     # conv_e (N = E): splits of K = 3C
    e_cluster: int    # conv_e's cluster: E / 128 column tiles x e_splits
    w_cluster: int    # wgrad: row splits of a tile, its cluster
    c_blocks: int     # conv_c (N = C): persistent blocks
    smem_conv_c: int
    smem_conv_e: int
    smem_wgrad: int


def _least_load(n: int, hi: int) -> int:
    """The count s in [1, hi] of equal pieces n units are cut into that
    least loads the busiest SM at one block an SM, ceil(n s / SMs) / s;
    the smallest s on a tie."""
    best, best_w = 1, -(-n // TC_SMS)
    for s in range(2, hi + 1):
        w = -(-n * s // TC_SMS)
        if w * best < best_w * s:
            best, best_w = s, w
    return best


def tc_launch_plan(b: int, t: int, e: int, c: int) -> TCLaunchPlan:
    """The launch plan of the tensor-core instance for a (B, T, E) input at
    C conv channels, mirroring ``csrc/conv_ff_blocked_tc.cu`` ``plan``."""
    rt = -(-t // TC_TILE)
    ev = e // TC_TILE
    # a split keeps at least 4 of the 64-channel chunks
    splits = _least_load(ev * rt * b,
                         max(1, min(TC_MAX_CLUSTER // ev, c // 256)))
    chunks = b * -(-t // TC_CHUNK)
    w_cluster = _least_load(2 * (e // TC_WGRAD_M) * (c // TC_TILE),
                            min(chunks, TC_MAX_CLUSTER))
    return TCLaunchPlan(rt, 2 * rt * TC_CHUNK_ROWS, splits, ev * splits,
                        w_cluster, min((c // TC_TILE) * rt * b, TC_SMS),
                        *_tc_smem())


def tc_workspace_bytes(b: int, t: int, e: int, c: int, backward: bool) -> int:
    """Device scratch of a forward or backward call, mirroring the kernel's
    carve: the images of rnd(x) and h ((B, chunks, K/8, 66, 8) bf16),
    and for the backward those of rnd(da2) and rnd(da1), dr and the
    partials of dLN, db2, dfilm and db1 (float32), each 256-byte
    aligned."""
    p = tc_launch_plan(b, t, e, c)
    rows = b * p.image_rows
    pieces = [2 * rows * e, 2 * rows * c]
    if backward:
        parts = b * p.row_tiles * p.e_cluster
        pieces += [2 * rows * e, 2 * rows * c, 4 * b * t * e,
                   4 * parts * 3 * e, 4 * parts * 2 * e,
                   4 * b * p.row_tiles * c]
    return sum(-(-n // 256) * 256 for n in pieces)


def plan_conv_ff_train(t: int, e: int, c: int, dot_dtype) -> ConvFFPlan:
    """K3's instance at (T, E, C) for ``dot_dtype``, mirroring
    ``csrc/conv_ff_blocked_tc.cu`` and ``csrc/conv_ff_train.cu``: the
    tensor-core instance for bfloat16 dots at C % 128 == 0 (K4's, which
    takes all of C in one pass; :func:`tc_launch_plan` gives its launches),
    the CUDA-core one otherwise (a 32-row tile: the (32 + 4) x
    E input, the (32 + 2) x C hidden and a 3 x 16 x E weight slice in
    float32). T does not enter the plan. Raises ValueError outside K3's
    envelope (:func:`k3_takes`)."""
    del t
    if not k3_takes(e, c):
        raise ValueError(
            f"conv_ff_train: the kernel takes E={KERNEL_WIDTH}, C % "
            f"{KERNEL_CHANNEL_MULTIPLE} == 0, C <= {KERNEL_MAX_CHANNELS}, "
            f"got E={e}, C={c}")
    if dot_dtype == torch.bfloat16 and c % TC_TILE == 0:
        return _tc_plan(e)
    floats = ((_ROW_TILE + 4) * e + (_ROW_TILE + 2) * c
              + 3 * _K3_WEIGHT_SLICE * e)
    return ConvFFPlan("cuda_core", _ROW_TILE, 4 * floats)


def plan_conv_ff_blocked(t: int, e: int, c: int, c_block: int,
                         dot_dtype) -> ConvFFPlan:
    """K4's instance at (T, E, C) and C block for ``dot_dtype``, mirroring
    ``csrc/conv_ff_blocked_tc.cu`` and ``csrc/conv_ff_blocked.cu``: the
    tensor-core instance for bfloat16 dots (all of C in one pass: the C
    block does not enter; :func:`tc_launch_plan` gives its launches), the
    CUDA-core one for float32 (:func:`blocked_smem_bytes`).
    T does not enter: both take any T. Raises ValueError outside K4's
    envelope."""
    del t
    if not blocked_takes(e, c, c_block):
        raise ValueError(
            f"conv_ff_train_blocked: the kernel takes E % "
            f"{BLOCKED_WIDTH_MULTIPLE} == 0, E <= {BLOCKED_MAX_WIDTH}, a C "
            f"block that is a multiple of {BLOCKED_WIDTH_MULTIPLE} dividing "
            f"C within {SMEM_BYTES} bytes of shared memory, got E={e}, "
            f"C={c}, c_block={c_block}")
    if dot_dtype == torch.bfloat16:
        return _tc_plan(e)
    return ConvFFPlan("cuda_core", _ROW_TILE, blocked_smem_bytes(e, c_block))


def plan_conv_ff(t: int, e: int, c: int, kernel: int) -> int:
    """Dispatch plan for the training conv-FF at (T, E, C); the port's
    counterpart of the JAX package's ``plan_conv_ff``, built on the H100
    envelope of its own kernels (T does not enter: both take any T).

    :return: ``c`` -- K3 (:func:`conv_ff_train`): where K3 takes the
        shape, and at widths that are no multiple of 128 (on a CUDA tensor
        K3's wrapper then raises; the CPU runs the plain version); a block
        that divides ``c`` and is smaller -- K4
        (:func:`conv_ff_train_blocked`) with that block: at widths E that
        are multiples of 128 that K3 does not take.
    """
    del t
    if kernel != 3:
        raise ValueError(f"the training conv-FF takes k=3, got k={kernel}")
    if k3_takes(e, c) or e % BLOCKED_WIDTH_MULTIPLE:
        return c
    cb = BLOCKED_C_BLOCK
    return cb if cb < c and blocked_takes(e, c, cb) else c


# ----------------------------------------------------------------------
# Plain versions (PyTorch tensor code): the CPU path and the oracle
# ----------------------------------------------------------------------
def _shift_down(x):  # row t <- row t-1
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _shift_up(x):    # row t <- row t+1
    return F.pad(x, (0, 0, 0, 1))[:, 1:]


def _shifts(x):
    return (_shift_down(x), x, _shift_up(x))


def _conv3(x, w):
    """SAME 3-tap conv: x (B, T, Cin) @ w (3, Cin, Cout) -> (B, T, Cout)."""
    xs = _shifts(x)
    return xs[0] @ w[0] + xs[1] @ w[1] + xs[2] @ w[2]


def _conv3_t(g, w):
    """Data gradient of :func:`_conv3`: g (B, T, Cout) -> (B, T, Cin)."""
    return (_shift_up(g @ w[0].t()) + g @ w[1].t()
            + _shift_down(g @ w[2].t()))


def _blocks(C, c_block):
    return [slice(c, c + c_block) for c in range(0, C, c_block)]


def _forward_core(x, w1k, b1, w2k, b2, seeds, rate, c_block, dot_dtype):
    """Up to r = dropout(a2) + x, the hidden channels in blocks of
    ``c_block``: ([(h, a1 > 0) per block], keep or None, r)."""
    xc = _rnd(x, dot_dtype)
    hidden, a2 = [], None
    for s in _blocks(w1k.shape[-1], c_block):
        a1 = _conv3(xc, w1k[..., s]) + b1[s]
        a1_pos = a1 > 0.0
        h = _rnd(torch.where(a1_pos, a1, 0.0), dot_dtype)
        hidden.append((h, a1_pos))
        part = _conv3(h, w2k[:, s])
        a2 = part + b2 if a2 is None else a2 + part
    keep = None
    if rate > 0.0:
        keep = keep_mask(seeds.to(x.device)[:, None, None], 0, 0,
                         x.shape[1:], dropout_threshold(rate))
        a2 = torch.where(keep, a2 / (1.0 - rate), 0.0)
    return hidden, keep, a2 + x


def _ln_stats(r):
    mean = r.mean(-1, keepdim=True)
    var = (r - mean).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + _EPS)
    return (r - mean) * inv, inv


def conv_ff_blocked_plain(x, w1, b1, w2, b2, ln_s, ln_b, film, seeds,
                          rate: float, c_block: int,
                          dot_dtype=torch.float32):
    """K4's forward in plain PyTorch; same arguments as
    :func:`conv_ff_train_blocked`. Returns (B, T, E) float32."""
    w1k, w2k = kernel_weights(w1, w2, dot_dtype)
    E = x.shape[-1]
    _, _, r = _forward_core(x.float(), w1k, b1, w2k, b2, seeds, rate,
                            c_block, dot_dtype)
    n, _ = _ln_stats(r)
    y = n * ln_s + ln_b
    return film[:, None, :E] * y + film[:, None, E:]


def conv_ff_blocked_plain_backward(x, w1, b1, w2, b2, ln_s, ln_b, film,
                                   seeds, g, rate: float, c_block: int,
                                   dot_dtype=torch.float32):
    """K4's backward in plain PyTorch, the math of the three blocked Pallas
    calls: the row-local LayerNorm/FiLM/dropout backward once, then per C
    block the weight and bias gradients from the recomputed hidden and the
    block's term of dx. Returns float32 (dx, dw1, db1, dw2, db2, dln_s,
    dln_b, dfilm) in the arguments' layouts."""
    w1k, w2k = kernel_weights(w1, w2, dot_dtype)
    x, g = x.float(), g.float()
    E = x.shape[-1]
    hidden, keep, r = _forward_core(x, w1k, b1, w2k, b2, seeds, rate,
                                    c_block, dot_dtype)
    n, inv = _ln_stats(r)
    y_ln = n * ln_s + ln_b
    dfilm = torch.cat([(g * y_ln).sum(1), g.sum(1)], dim=-1)
    dy = g * film[:, None, :E]
    dls = (dy * n).sum((0, 1))
    dlb = dy.sum((0, 1))
    dn = dy * ln_s
    dr = (dn - dn.mean(-1, keepdim=True)
          - n * (dn * n).mean(-1, keepdim=True)) * inv
    da2 = dr if keep is None else torch.where(keep, dr / (1.0 - rate), 0.0)
    db2 = da2.sum((0, 1))
    da2c = _rnd(da2, dot_dtype)
    xc = _rnd(x, dot_dtype)
    dw1, db1, dw2, dx = [], [], [], dr
    for s, (h, a1_pos) in zip(_blocks(w1k.shape[-1], c_block), hidden):
        dw2.append(torch.stack([torch.einsum("btc,bte->ce", hs, da2c)
                                for hs in _shifts(h)]))
        da1 = torch.where(a1_pos, _conv3_t(da2c, w2k[:, s]), 0.0)
        db1.append(da1.sum((0, 1)))
        da1c = _rnd(da1, dot_dtype)
        dw1.append(torch.stack([torch.einsum("bte,btc->ec", xs, da1c)
                                for xs in _shifts(xc)]))
        dx = dx + _conv3_t(da1c, w1k[..., s])
    return (dx, torch.cat(dw1, -1).permute(2, 1, 0), torch.cat(db1),
            torch.cat(dw2, 1).permute(2, 1, 0), db2, dls, dlb, dfilm)


def conv_ff_plain(x, w1, b1, w2, b2, ln_s, ln_b, film, seeds, rate: float,
                  dot_dtype=torch.float32):
    """K3's forward in plain PyTorch (one C block); same arguments as
    :func:`conv_ff_train`. Returns (B, T, E) float32."""
    return conv_ff_blocked_plain(x, w1, b1, w2, b2, ln_s, ln_b, film, seeds,
                                 rate, w1.shape[0], dot_dtype)


def conv_ff_plain_backward(x, w1, b1, w2, b2, ln_s, ln_b, film, seeds, g,
                           rate: float, dot_dtype=torch.float32):
    """K3's backward in plain PyTorch, the recompute math of the Pallas
    ``_bwd_kernel`` (one C block). Returns float32 (dx, dw1, db1, dw2,
    db2, dln_s, dln_b, dfilm) in the arguments' layouts."""
    return conv_ff_blocked_plain_backward(x, w1, b1, w2, b2, ln_s, ln_b,
                                          film, seeds, g, rate, w1.shape[0],
                                          dot_dtype)


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------
@functools.cache
def _tc_kernels():
    """The C entry points of ``csrc/conv_ff_blocked_tc.cu`` (the
    tensor-core instance of K3 and K4), built at first use: (workspace
    bytes, forward, backward)."""
    lib = load_library("conv_ff_blocked_tc")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ws = lib.conv_ff_blocked_tc_workspace_bytes
    ws.argtypes, ws.restype = [i] * 5, ctypes.c_longlong
    fwd = lib.conv_ff_blocked_tc_forward
    fwd.argtypes = [p] * 11 + [i] * 5 + [ctypes.c_uint32, f, i, p]
    fwd.restype = i
    bwd = lib.conv_ff_blocked_tc_backward
    bwd.argtypes = [p] * 19 + [i] * 5 + [ctypes.c_uint32, f, i, p]
    bwd.restype = i
    return ws, fwd, bwd


def tc_smem_bytes(e: int) -> int:
    """The built kernel's own count of what :func:`plan_conv_ff_train`
    and :func:`plan_conv_ff_blocked` mirror for the tensor-core instance at
    width E."""
    fn = load_library("conv_ff_blocked_tc").conv_ff_blocked_tc_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return int(fn(e))


def tc_built_plan(b: int, t: int, e: int, c: int) -> TCLaunchPlan:
    """The built kernel's own launch plan, which :func:`tc_launch_plan`
    mirrors."""
    fn = load_library("conv_ff_blocked_tc").conv_ff_blocked_tc_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(TCLaunchPlan._fields))()
    if fn(b, t, e, c, ctypes.addressof(out)) != 0:
        raise ValueError(f"conv_ff_train: the tensor-core kernel does not "
                         f"take {(b, t, e)}, C={c}")
    return TCLaunchPlan(*out)


def cuda_core_smem_bytes(c: int) -> int:
    """The built kernel's own count of what :func:`plan_conv_ff_train`
    mirrors for K3's CUDA-core instance at C conv channels."""
    fn = load_library("conv_ff_train").conv_ff_train_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return int(fn(c))


@functools.cache
def _kernels(blocked: bool):
    """The C entry points of ``csrc/conv_ff_train.cu`` (K3) or
    ``csrc/conv_ff_blocked.cu`` (K4), built at first use: (workspace
    floats, forward, backward). K4's also take E and the C block."""
    name = "conv_ff_blocked" if blocked else "conv_ff_train"
    lib = load_library(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    n_ints = 6 if blocked else 4  # shapes, then use_dropout
    ws = getattr(lib, f"{name}_workspace_floats")
    ws.argtypes = [i] * (4 if blocked else 3)
    ws.restype = ctypes.c_longlong
    fwd = getattr(lib, f"{name}_forward")
    fwd.argtypes = [p] * 10 + [i] * n_ints + [ctypes.c_uint32, f, i, p]
    fwd.restype = i
    bwd = getattr(lib, f"{name}_backward")
    bwd.argtypes = [p] * 19 + [i] * n_ints + [ctypes.c_uint32, f, i, p]
    bwd.restype = i
    return ws, fwd, bwd


def _check_cuda(x, w1k, b1, w2k, b2, ln_s, ln_b, film, seeds, dot_dtype,
                g=None, c_block=None, reversed_weights=None):
    """Raise on what K3 (``c_block`` None) or K4 does not take; return
    (B, T, C, whether the plan names the tensor-core instance)."""
    B, T, E = x.shape
    C = b1.shape[0]
    f32 = torch.float32
    if c_block is None:
        if E != KERNEL_WIDTH:
            raise ValueError(f"conv_ff_train: the kernel takes "
                             f"E={KERNEL_WIDTH}, got {E}")
        if not k3_takes(E, C):
            raise ValueError(f"conv_ff_train: the kernel takes conv channels "
                             f"C % {KERNEL_CHANNEL_MULTIPLE} == 0, C <= "
                             f"{KERNEL_MAX_CHANNELS}, got {C}")
    elif not blocked_takes(E, C, c_block):
        raise ValueError(
            f"conv_ff_train_blocked: the kernel takes E % "
            f"{BLOCKED_WIDTH_MULTIPLE} == 0, E <= {BLOCKED_MAX_WIDTH}, a C "
            f"block that is a multiple of {BLOCKED_WIDTH_MULTIPLE} dividing "
            f"C within {SMEM_BYTES} bytes of shared memory, got E={E}, "
            f"C={C}, c_block={c_block}")
    if dot_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_ff_train: dot_dtype {dot_dtype}")
    tensor_core = _tensor_core(x, C, c_block, dot_dtype)
    if tensor_core:  # TCWeights' images
        wt, shape = torch.bfloat16, _image_shape
    else:  # kernel_weights
        wt, shape = f32, lambda k, n: (3, k, n)
    tensors = {"x": (x, (B, T, E), f32), "w1": (w1k, shape(E, C), wt),
               "b1": (b1, (C,), f32), "w2": (w2k, shape(C, E), wt),
               "b2": (b2, (E,), f32), "ln_s": (ln_s, (E,), f32),
               "ln_b": (ln_b, (E,), f32), "film": (film, (B, 2 * E), f32),
               "seeds": (seeds, (B,), torch.int32)}
    if g is not None:
        tensors["g"] = (g, (B, T, E), f32)
    if reversed_weights is not None:
        tensors["w1r"] = (reversed_weights[0], shape(C, E), wt)
        tensors["w2r"] = (reversed_weights[1], shape(E, C), wt)
    elif tensor_core and g is not None:
        raise ValueError("conv_ff_train: the tensor-core backward takes the "
                         "reversed weights' images (tc_weights)")
    for name, (t, shape, dtype) in tensors.items():
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"conv_ff_train: {name} must be contiguous "
                             f"{dtype} {shape} on {x.device}")
    return B, T, C, tensor_core


def _image_shape(k, n):
    """Shape of :func:`pack_image`'s image of a (3, K, N) weight."""
    return (n // TC_TILE, k // 64, 3, 8, TC_TILE, 8)


def _dropout_args(rate):
    return (int(rate > 0.0), dropout_threshold(rate) if rate > 0.0 else 0,
            1.0 - rate)


def _shape_args(x, C, c_block):
    B, T, E = x.shape
    return (B, T, C) if c_block is None else (B, T, E, C, c_block)


def _tensor_core(x, C, c_block, dot_dtype):
    T, E = x.shape[1], x.shape[-1]
    plan = plan_conv_ff_train(T, E, C, dot_dtype) if c_block is None \
        else plan_conv_ff_blocked(T, E, C, c_block, dot_dtype)
    return plan.instance == "tensor_core"


def _launched(err, c_block, tensor_core, direction, capturing):
    """Raise on a launch error; count the launch: in ``.{direction}_
    launches`` (and ``.tc_...`` on the tensor-core instance), or under
    CUDA-graph capture in ``.{direction}_captured`` (``.tc_...``): a
    captured launch runs at every replay, where no wrapper runs."""
    if err != 0:
        raise RuntimeError(f"conv_ff_train: CUDA error {err} at launch")
    fn = conv_ff_train if c_block is None else conv_ff_train_blocked
    kind = "captured" if capturing else "launches"
    for name in (f"{direction}_{kind}",) + (
            (f"tc_{direction}_{kind}",) if tensor_core else ()):
        setattr(fn, name, getattr(fn, name) + 1)


@functools.lru_cache(maxsize=64)
def _tc_workspace_bytes(B, T, E, C, backward):
    nbytes = _tc_kernels()[0](B, T, E, C, int(backward))
    if nbytes < 0:
        raise ValueError(f"conv_ff_train: the tensor-core kernel does not "
                         f"take {(B, T, E)}, C={C}")
    return nbytes


def _tc_scratch(x, C, backward):
    """The tensor-core instance's workspace (its first launch writes x's
    bf16 image there: no cast of its own)."""
    B, T, E = x.shape
    return torch.empty(_tc_workspace_bytes(B, T, E, C, backward),
                       dtype=torch.uint8, device=x.device)


def conv_ff_forward_cuda(x, w1k, b1, w2k, b2, ln_s, ln_b, film, seeds,
                         rate, dot_dtype, c_block=None, sum_k=TC_SUM_K):
    """K3's forward kernels, or K4's with ``c_block`` (the tensor-core
    instance where the plan names it), on the instance's weights: float32
    in the kernel layout from :func:`kernel_weights` for the CUDA-core
    instance, the bfloat16 images of :func:`tc_weights` for the
    tensor-core one (whose partial sums span ``sum_k`` k16 columns: 64,
    192, or 0 for chained)."""
    B, T, C, tensor_core = _check_cuda(x, w1k, b1, w2k, b2, ln_s, ln_b, film,
                                       seeds, dot_dtype, c_block=c_block)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        capturing = torch.cuda.is_current_stream_capturing()
        stream = torch.cuda.current_stream().cuda_stream
        if tensor_core:
            ws = _tc_scratch(x, C, False)
            err = _tc_kernels()[1](
                x.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2k.data_ptr(),
                b2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
                film.data_ptr(), seeds.data_ptr(), ws.data_ptr(),
                out.data_ptr(), B, T, x.shape[-1], C, *_dropout_args(rate),
                sum_k, stream)
        else:
            err = _kernels(c_block is not None)[1](
                x.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2k.data_ptr(),
                b2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
                film.data_ptr(), seeds.data_ptr(), out.data_ptr(),
                *_shape_args(x, C, c_block), *_dropout_args(rate),
                int(dot_dtype == torch.bfloat16), stream)
    _launched(err, c_block, tensor_core, "fwd", capturing)
    return out


def conv_ff_backward_cuda(x, w1k, b1, w2k, b2, ln_s, ln_b, film, seeds, g,
                          rate, dot_dtype, c_block=None,
                          reversed_weights=None, sum_k=TC_SUM_K):
    """K3's backward kernels, or K4's with ``c_block`` (the tensor-core
    instance where the plan names it), on the weights
    :func:`conv_ff_forward_cuda` takes and their tap-reversed transposes
    (w1r, w2r): the images of :func:`tc_weights` for the tensor-core
    instance, the kernel layout for the CUDA-core one (made here where
    None): float32 (dx, dw1 (3, E, C), db1, dw2 (3, C, E), db2, dln_s,
    dln_b, dfilm)."""
    B, T, C, tensor_core = _check_cuda(x, w1k, b1, w2k, b2, ln_s, ln_b, film,
                                       seeds, dot_dtype, g, c_block,
                                       reversed_weights)
    E = x.shape[-1]
    if reversed_weights is None:
        reversed_weights = (w1k.flip(0).transpose(1, 2).contiguous(),
                            w2k.flip(0).transpose(1, 2).contiguous())
    w1r, w2r = reversed_weights
    dx = torch.empty_like(x)
    dw1 = torch.empty((3, E, C), dtype=torch.float32, device=x.device)
    dw2 = torch.empty((3, C, E), dtype=torch.float32, device=x.device)
    db1 = torch.empty((C,), dtype=torch.float32, device=x.device)
    dvec = torch.empty((3, E), dtype=torch.float32, device=x.device)
    dfilm = torch.empty((B, 2 * E), dtype=torch.float32, device=x.device)
    grads = (dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
             dvec.data_ptr(), dfilm.data_ptr())
    with torch.cuda.device(x.device):
        capturing = torch.cuda.is_current_stream_capturing()
        stream = torch.cuda.current_stream().cuda_stream
        if tensor_core:
            ws = _tc_scratch(x, C, True)
            err = _tc_kernels()[2](
                x.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2k.data_ptr(),
                b2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
                film.data_ptr(), seeds.data_ptr(), g.data_ptr(),
                w1r.data_ptr(), w2r.data_ptr(), ws.data_ptr(), *grads, B, T,
                E, C, *_dropout_args(rate), sum_k, stream)
        else:
            wsize, _, bwd = _kernels(c_block is not None)
            shape = _shape_args(x, C, c_block)
            ws_shape = shape if c_block is None else shape[:-1]  # no C block
            ws = torch.empty(int(wsize(*ws_shape)), dtype=torch.float32,
                             device=x.device)
            err = bwd(
                x.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2k.data_ptr(),
                b2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
                film.data_ptr(), seeds.data_ptr(), g.data_ptr(),
                w1r.data_ptr(), w2r.data_ptr(), ws.data_ptr(), *grads, *shape,
                *_dropout_args(rate), int(dot_dtype == torch.bfloat16), stream)
    _launched(err, c_block, tensor_core, "bwd", capturing)
    return dx, dw1, db1, dw2, dvec[2], dvec[0], dvec[1], dfilm


def _instance_weights(x, w1, w2, c_block, dot_dtype):
    """The weights in the type and layout of the instance the plan names:
    (w1k, w2k, (w1r, w2r) or None)."""
    if _tensor_core(x, w1.shape[0], c_block, dot_dtype):
        w = tc_weights(w1, w2)
        return w.w1, w.w2, (w.w1r, w.w2r)
    return (*kernel_weights(w1, w2, dot_dtype), None)


class _ConvFFTrain(torch.autograd.Function):
    """K3 (``c_block`` None) or K4 with its C block."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_s, ln_b, film, seeds, rate,
                c_block, dot_dtype):
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_s, ln_b, film, seeds)
        ctx.args = (rate, c_block, dot_dtype)
        if x.device.type == "cpu":
            return conv_ff_blocked_plain(x, w1, b1, w2, b2, ln_s, ln_b, film,
                                         seeds, rate, c_block or w1.shape[0],
                                         dot_dtype)
        if x.device.type != "cuda":
            raise ValueError(f"conv_ff_train: unsupported device {x.device}")
        w1k, w2k, _ = _instance_weights(x, w1, w2, c_block, dot_dtype)
        return conv_ff_forward_cuda(x.contiguous(), w1k, b1.contiguous(),
                                    w2k, b2.contiguous(), ln_s.contiguous(),
                                    ln_b.contiguous(), film.contiguous(),
                                    seeds, rate, dot_dtype, c_block)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, ln_s, ln_b, film, seeds = ctx.saved_tensors
        rate, c_block, dot_dtype = ctx.args
        g = g.float().contiguous()
        if x.device.type == "cpu":
            grads = conv_ff_blocked_plain_backward(
                x, w1, b1, w2, b2, ln_s, ln_b, film, seeds, g, rate,
                c_block or w1.shape[0], dot_dtype)
        else:
            w1k, w2k, rev = _instance_weights(x, w1, w2, c_block, dot_dtype)
            dx, dw1, db1, dw2, db2, dls, dlb, dfilm = conv_ff_backward_cuda(
                x.contiguous(), w1k, b1.contiguous(), w2k, b2.contiguous(),
                ln_s.contiguous(), ln_b.contiguous(), film.contiguous(),
                seeds, g, rate, dot_dtype, c_block, rev)
            grads = (dx, dw1.permute(2, 1, 0), db1, dw2.permute(2, 1, 0),
                     db2, dls, dlb, dfilm)
        return (*grads, None, None, None, None)


def conv_ff_train(x, w1, b1, w2, b2, ln_s, ln_b, film, seeds, rate: float,
                  dot_dtype=torch.bfloat16):
    """gamma * LN(dropout(conv2(relu(conv1(x)))) + x) + beta, differentiable
    in every tensor argument but ``seeds`` (K3).

    :param x: (B, T, E) float32
    :param w1, b1: conv1 (C, E, 3), (C,); :param w2, b2: conv2 (E, C, 3), (E,)
    :param ln_s, ln_b: (E,) LayerNorm scale and bias
    :param film: (B, 2E) [gammas | betas]
    :param seeds: (B,) int32 dropout seeds (ignored at rate 0)
    :param rate: dropout rate on the conv output
    :return: (B, T, E) float32
    """
    return _ConvFFTrain.apply(x, w1, b1, w2, b2, ln_s, ln_b, film, seeds,
                              rate, None, dot_dtype)


def conv_ff_train_blocked(x, w1, b1, w2, b2, ln_s, ln_b, film, seeds,
                          rate: float, c_block: int,
                          dot_dtype=torch.bfloat16):
    """:func:`conv_ff_train` with the C hidden channels taken in blocks of
    ``c_block`` (K4, for the widths :func:`plan_conv_ff` gives it); same
    arguments and result."""
    return _ConvFFTrain.apply(x, w1, b1, w2, b2, ln_s, ln_b, film, seeds,
                              rate, c_block, dot_dtype)


conv_ff_train.fwd_launches = 0
conv_ff_train.bwd_launches = 0
conv_ff_train_blocked.fwd_launches = 0
conv_ff_train_blocked.bwd_launches = 0
# the launches of the above that took the tensor-core instance
conv_ff_train.tc_fwd_launches = 0
conv_ff_train.tc_bwd_launches = 0
conv_ff_train_blocked.tc_fwd_launches = 0
conv_ff_train_blocked.tc_bwd_launches = 0
# launches recorded under CUDA-graph capture (run at every replay)
conv_ff_train.fwd_captured = 0
conv_ff_train.bwd_captured = 0
conv_ff_train.tc_fwd_captured = 0
conv_ff_train.tc_bwd_captured = 0
conv_ff_train_blocked.fwd_captured = 0
conv_ff_train_blocked.bwd_captured = 0
conv_ff_train_blocked.tc_fwd_captured = 0
conv_ff_train_blocked.tc_bwd_captured = 0
