"""Training attention core with in-kernel dropout (K2): CUDA kernels,
wrappers, plain versions and the autograd Function.

Port of the Pallas TPU kernels ``daft_exprt_tpu/ops/attention_train.py``
``_fwd_kernel`` and ``_bwd_kernel``:

  forward:  out = dropout(softmax(mask(q k^T / sqrt(D)))) @ v per head, on
            head-packed (B, T, E) q/k/v, keys masked past each length;
  backward: recompute the probabilities (nothing of size T x T is stored)
            and form dq, dk, dv.

Dropout on the probabilities comes from a counter-based hash (murmur3
fmix32 over (row seed, head * tiles + tile, row, col)), bit-equal to the
JAX package's, so forward and backward recompute identical masks and the
port's masks equal the JAX ones. Kept probabilities are multiplied by
``1 / (1 - rate)``.

Numerics follow the Pallas kernels: q/k/v arrive in the compute dtype;
logits, softmax and every accumulation are float32; the dropped
probabilities are rounded before PV; in the backward the cotangent is
rounded per head, the dropped probabilities are rounded for dv, and
``ds = p (dp - sum(dp p)) / sqrt(D)`` is rounded before dq and dk, whose
other factors k and q are rounded to the dot dtype too (a no-op unless
float32 q/k/v meet bfloat16 dots). The
row max is held constant (no gradient through it). The gradients are
returned in q's dtype.

On a CUDA tensor the wrappers launch the kernels of
``csrc/attention_train.cu`` (counted in ``attention_core.fwd_launches``
and ``.bwd_launches``) or raise; on a CPU tensor they take the plain
versions below. :func:`plan_attention` says which instance of the kernels
a call takes: bfloat16 q/k/v with bfloat16 rounding (the training path)
the tensor-core one (``csrc/attention_wgmma.cuh``: wgmma and TMA; also
counted in ``attention_core.tc_fwd_launches`` and ``.tc_bwd_launches``),
float32, and bfloat16 with the rounding off, the CUDA-core one. The
tensor-core forward also leaves ``o' = sum_j pd_ij v_j`` with the
unrounded dropped probabilities (the plain forward at float32 dots), from
which its backward takes the JAX kernels' ``delta = sum_j dp_ij p_ij`` as
``rnd(g_i) . o'_i`` without a pass over the keys. A launch under
CUDA-graph capture (the training step's graph, ``training/step.py``) is
counted in ``attention_core.fwd_captured``/``.bwd_captured`` (and
``tc_...``) instead: it runs at every replay, where no wrapper runs; its
tensor maps, encoded at capture, hold the graph's own addresses.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from daft_exprt_tpu_torch.ops._build import load_library
from daft_exprt_tpu_torch.ops.attention_common import NEG_INF, pick_q_tile

# the CUDA kernels' envelope: packed widths E that are multiples of 128
# (the flagship's 128, the wide ablation's 512), head dims 16, 64 and 128
KERNEL_WIDTH_MULTIPLE = 128
KERNEL_HEAD_DIMS = (16, 64, 128)
# the tensor-core instance (csrc/attention_wgmma.cuh): a warpgroup owns 64
# query (or key) rows; the most dynamic shared memory of its launches at
# each head dim D, dk-dv's (the header's dkdv_smem<D>(), which sets the
# depth of its ring; chip_smoke.py checks these against the built count)
TC_ROWS = 64
TC_SMEM_BYTES = {16: 26112, 64: 70144, 128: 101888}

_MASK32 = 0xFFFFFFFF


# ----------------------------------------------------------------------
# Counter-based dropout bits (bit-equal to the JAX package's)
# ----------------------------------------------------------------------
def dropout_threshold(rate: float) -> int:
    """uint32 threshold: keep iff bits >= threshold."""
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32), without int64
    overflow: the constant is split into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix(seed, salt, rows, cols) -> torch.Tensor:
    """murmur3 fmix32 over seed + salt*0x9E3779B9 + rows*0x85EBCA6B +
    cols*0xC2B2AE35 (all mod 2^32); int64 tensors that broadcast, values
    in [0, 2^32)."""
    h = ((seed & _MASK32) + _mul32(salt & _MASK32, 0x9E3779B9)
         + _mul32(rows & _MASK32, 0x85EBCA6B)
         + _mul32(cols & _MASK32, 0xC2B2AE35)) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_bits(seed, salt: int, row0: int, shape) -> torch.Tensor:
    """Counter-based uniform uint32 bits (as int64) over a (rows, cols)
    grid with global rows ``row0 + i``; ``seed`` an int or a tensor that
    broadcasts against the grid (e.g. (B, 1, 1) per-row seeds), on whose
    device the bits are made. Bit-equal to the JAX package's
    ``_hash_bits``."""
    seed = torch.as_tensor(seed).long()
    rows = torch.arange(shape[0], dtype=torch.int64,
                        device=seed.device)[:, None] + row0
    cols = torch.arange(shape[1], dtype=torch.int64,
                        device=seed.device)[None, :]
    return _fmix(seed, torch.tensor(salt, dtype=torch.int64,
                                    device=seed.device), rows, cols)


def keep_mask(seed, salt: int, row0: int, shape, threshold: int):
    """Keep-mask with probability 1 - rate; identical given identical
    coordinates."""
    return hash_bits(seed, salt, row0, shape) >= threshold


def _attention_bits(seeds, h: int, T: int):
    """K2's dropout bits of head ``h``: (B, T, T) over (row, col), salt
    ``h * (T / TQ) + row // TQ`` with TQ = pick_q_tile(T)."""
    tq = pick_q_tile(T)
    dev = seeds.device
    rows = torch.arange(T, dtype=torch.int64, device=dev)
    salt = (h * (T // tq) + rows // tq)[None, :, None]
    return _fmix(seeds.long()[:, None, None], salt, rows[None, :, None],
                 rows[None, None, :])


# ----------------------------------------------------------------------
# Plain versions (PyTorch tensor code): the CPU path and the oracle
# ----------------------------------------------------------------------
def _probs(q_h, k_h, key_valid, scale):
    logits = (q_h @ k_h.transpose(-1, -2)) * scale
    logits = logits.masked_fill(~key_valid[:, None, :], NEG_INF)
    m = logits.amax(-1, keepdim=True).detach()  # the max is a constant
    p = torch.exp(logits - m)
    return p / p.sum(-1, keepdim=True).clamp_min(1e-30)


def _setup(q, lengths, num_heads):
    B, T, E = q.shape
    D = E // num_heads
    col = torch.arange(T, device=q.device)
    key_valid = col[None, :] < lengths.to(q.device)[:, None].long()
    return T, D, key_valid, float(torch.tensor(1.0 / math.sqrt(D),
                                               dtype=torch.float32))


def attention_plain(q, k, v, lengths, seeds, num_heads: int, rate: float,
                    dot_dtype=torch.float32):
    """K2's forward in plain PyTorch: same arguments as
    :func:`attention_core`; returns (B, T, E) float32."""
    q, k, v = q.float(), k.float(), v.float()
    T, D, key_valid, scale = _setup(q, lengths, num_heads)
    outs = []
    for h in range(num_heads):
        sl = slice(h * D, (h + 1) * D)
        p = _probs(q[..., sl], k[..., sl], key_valid, scale)
        if rate > 0.0:
            keep = _attention_bits(seeds, h, T) >= dropout_threshold(rate)
            p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        outs.append(p.to(dot_dtype).float() @ v[..., sl])
    return torch.cat(outs, dim=-1)


def attention_plain_backward(q, k, v, g, lengths, seeds, num_heads: int,
                             rate: float, dot_dtype=torch.float32):
    """K2's backward in plain PyTorch, the recompute math of the Pallas
    ``_bwd_kernel``: returns float32 (dq, dk, dv)."""
    q, k, v, g = q.float(), k.float(), v.float(), g.float()
    T, D, key_valid, scale = _setup(q, lengths, num_heads)
    inv_keep = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    dqs, dks, dvs = [], [], []
    for h in range(num_heads):
        sl = slice(h * D, (h + 1) * D)
        q_h, k_h, v_h = q[..., sl], k[..., sl], v[..., sl]
        g_h = g[..., sl].to(dot_dtype).float()
        p = _probs(q_h, k_h, key_valid, scale)
        if rate > 0.0:
            keep = _attention_bits(seeds, h, T) >= dropout_threshold(rate)
            p_drop = torch.where(keep, p * inv_keep, 0.0)
        else:
            p_drop = p
        dvs.append(p_drop.to(dot_dtype).float().transpose(-1, -2) @ g_h)
        dp = g_h @ v_h.transpose(-1, -2)
        if rate > 0.0:
            dp = torch.where(keep, dp * inv_keep, 0.0)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        ds = (ds * scale).to(dot_dtype).float()
        dqs.append(ds @ k_h.to(dot_dtype).float())
        dks.append(ds.transpose(-1, -2) @ q_h.to(dot_dtype).float())
    return tuple(torch.cat(t, dim=-1) for t in (dqs, dks, dvs))


# ----------------------------------------------------------------------
# Dispatch: which instance of the kernels takes a call
# ----------------------------------------------------------------------
class AttentionPlan(NamedTuple):
    instance: str     # "tensor_core" or "cuda_core"
    rows: int         # query rows (forward, dq) or key rows (dk-dv) a block owns
    smem_bytes: int   # the largest dynamic shared memory of its launches


@functools.lru_cache(maxsize=None)
def plan_attention(t: int, e: int, h: int, io_dtype, dot_dtype) -> AttentionPlan:
    """The kernels' instance at (T, E, H) for q/k/v in ``io_dtype`` and
    rounding at ``dot_dtype``, mirroring ``csrc/attention_train.cu``: the
    tensor-core instance for bfloat16 with bfloat16 rounding
    (``TC_SMEM_BYTES``), the CUDA-core one (static shared memory, 128 /
    (D / 16) rows a block) otherwise. T does not enter: both take any T.
    Raises ValueError outside the kernels' envelope."""
    del t
    if e % KERNEL_WIDTH_MULTIPLE or e % h or e // h not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention_core: the kernel takes E % "
                         f"{KERNEL_WIDTH_MULTIPLE} == 0 with head dims "
                         f"{KERNEL_HEAD_DIMS}, got E={e}, H={h}")
    d = e // h
    if io_dtype == torch.bfloat16 and dot_dtype == torch.bfloat16:
        return AttentionPlan("tensor_core", TC_ROWS, TC_SMEM_BYTES[d])
    return AttentionPlan("cuda_core", 128 * 16 // d, 0)


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------
@functools.cache
def _kernels():
    """The C entry points of ``csrc/attention_train.cu``, built at first
    use: the CUDA-core forward and backward, then the tensor-core ones."""
    lib = load_library("attention_train")
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    fwd = lib.attention_train_forward
    fwd.argtypes = [p] * 8 + [i] * 5 + [f, i, u, f, i, i, p]
    bwd = lib.attention_train_backward
    bwd.argtypes = [p] * 12 + [i] * 5 + [f, i, u, f, i, i, p]
    tc_fwd = lib.attention_train_tc_forward
    tc_fwd.argtypes = [p] * 8 + [i] * 5 + [f, i, u, f, p]
    tc_bwd = lib.attention_train_tc_backward
    tc_bwd.argtypes = [p] * 13 + [i] * 5 + [f, i, u, f, p]
    for fn in (fwd, bwd, tc_fwd, tc_bwd):
        fn.restype = i
    return fwd, bwd, tc_fwd, tc_bwd


def tc_smem_bytes(head_dim: int) -> int:
    """The built kernel's own count of what :func:`plan_attention` mirrors
    (0 for a head dim the tensor-core instance does not take)."""
    fn = load_library("attention_train").attention_train_tc_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return int(fn(head_dim))


def tc_map_stats() -> tuple[int, int]:
    """The tensor maps the tensor-core launches have encoded (one per
    streamed tensor a launch) and the host nanoseconds spent encoding them,
    since the built library loaded."""
    fn = load_library("attention_train").attention_train_tc_map_stats
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    out = (ctypes.c_longlong * 2)()
    fn(out)
    return out[0], out[1]


def _check_cuda(q, k, v, lengths, seeds, num_heads, dot_dtype, g=None):
    """Raise unless the kernels take these arguments; :return: the plan."""
    B, T, E = shape = q.shape
    plan = plan_attention(T, E, num_heads, q.dtype, dot_dtype)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention_core: q/k/v dtype {q.dtype}")
    for name, t, dtype in (("q", q, q.dtype), ("k", k, q.dtype),
                           ("v", v, q.dtype), ("g", g, torch.float32)):
        if t is not None and (t.shape != shape or t.dtype != dtype
                              or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError(f"attention_core: {name} must be contiguous "
                             f"{dtype} {(B, T, E)} on {q.device}")
    for name, t in (("lengths", lengths), ("seeds", seeds)):
        if (t.shape != (B,) or t.dtype != torch.int32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"attention_core: {name} must be contiguous "
                             f"int32 (B,) on {q.device}")
    if dot_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention_core: dot_dtype {dot_dtype}")
    # the tensor-core instance reads q/k/v by TMA and g by float4 loads,
    # from 16-byte boundaries
    if plan.instance == "tensor_core" and any(
            t is not None and t.data_ptr() % 16 for t in (q, k, v, g)):
        raise ValueError("attention_core: q/k/v/g must be 16-byte aligned")
    return plan


@functools.lru_cache(maxsize=None)
def _scalars(T, E, num_heads, rate):
    """The kernels' scalar arguments after the pointers and B: T, E, H,
    the dropout query tile, 1 / sqrt(D), and the dropout terms."""
    D = E // num_heads
    return (T, E, num_heads, pick_q_tile(T), 1.0 / math.sqrt(D),
            int(rate > 0.0), dropout_threshold(rate) if rate > 0.0 else 0,
            1.0 / (1.0 - rate) if rate > 0.0 else 1.0)


def _launch(fn, device, *args) -> bool:
    """``fn(*args, stream)`` on ``device``'s current stream, switching the
    current device only where it differs; raises on a CUDA error.
    :return: whether the stream was capturing a CUDA graph."""
    index = device.index
    if index == torch.cuda.current_device():
        capturing = torch.cuda.is_current_stream_capturing()
        err = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            capturing = torch.cuda.is_current_stream_capturing()
            err = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_core: CUDA error {err} at launch"
                           if err > 0 else "attention_core: "
                           "cuTensorMapEncodeTiled refused a tensor map")
    return capturing


def _count(direction: str, tensor_core: bool, capturing: bool):
    """One launch of ``direction`` ("fwd" or "bwd"): in ``.{direction}_
    launches`` (and ``.tc_...`` on the tensor-core instance), or under
    CUDA-graph capture in ``.{direction}_captured`` (``.tc_...``): a
    captured launch runs at every replay, where no wrapper runs."""
    kind = "captured" if capturing else "launches"
    for name in (f"{direction}_{kind}",) + (
            (f"tc_{direction}_{kind}",) if tensor_core else ()):
        setattr(attention_core, name, getattr(attention_core, name) + 1)


def attention_forward_cuda(q, k, v, lengths, seeds, num_heads, rate,
                           dot_dtype):
    """K2's forward kernel on q/k/v in float32 or bfloat16: (out (B, T, E)
    float32, what the backward takes: (row stats (2, B, H, T): max, sum,)
    and for the tensor-core instance o' (B, T, E) float32)."""
    plan = _check_cuda(q, k, v, lengths, seeds, num_heads, dot_dtype)
    B, T, E = q.shape
    tensor_core = plan.instance == "tensor_core"
    stats = torch.empty((2, B, num_heads, T), dtype=torch.float32,
                        device=q.device)
    scalars = _scalars(T, E, num_heads, rate)
    if tensor_core:
        out, oprime = torch.empty((2, B, T, E), dtype=torch.float32,
                                  device=q.device)
        capturing = _launch(_kernels()[2], q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), lengths.data_ptr(), seeds.data_ptr(),
                out.data_ptr(), oprime.data_ptr(), stats.data_ptr(), B,
                *scalars)
        saved = (stats, oprime)
    else:
        out = torch.empty((B, T, E), dtype=torch.float32, device=q.device)
        capturing = _launch(_kernels()[0], q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), lengths.data_ptr(), seeds.data_ptr(),
                out.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), B,
                *scalars, int(dot_dtype == torch.bfloat16),
                int(q.dtype == torch.bfloat16))
        saved = (stats,)
    _count("fwd", tensor_core, capturing)
    return out, saved


def attention_backward_cuda(q, k, v, g, lengths, seeds, saved, num_heads,
                            rate, dot_dtype):
    """K2's backward kernels: (dq, dk, dv) in q's dtype; ``g`` float32,
    ``saved`` the forward's. The tensor-core instance rounds the cotangent
    to bfloat16 once (the Pallas kernel rounds it per head: the same
    values), in its dq launch."""
    plan = _check_cuda(q, k, v, lengths, seeds, num_heads, dot_dtype, g)
    B, T, E = q.shape
    tensor_core = plan.instance == "tensor_core"
    stats = saved[0]
    if (len(saved) != 1 + tensor_core
            or stats.shape != (2, B, num_heads, T)
            or (tensor_core and saved[1].shape != q.shape)
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   or t.device != q.device for t in saved)):
        raise ValueError("attention_core: row stats of another call")
    # the dq launch reads o' by float4 loads
    if tensor_core and saved[1].data_ptr() % 16:
        raise ValueError("attention_core: o' must be 16-byte aligned")
    scalars = _scalars(T, E, num_heads, rate)
    if tensor_core:
        # dq, dk, dv, and the bf16 cotangent the dq launch writes for dk-dv
        dq, dk, dv, gr = torch.empty((4, B, T, E), dtype=q.dtype,
                                     device=q.device)
        terms = torch.empty((B, num_heads, T, 4), dtype=torch.float32,
                            device=q.device)
        capturing = _launch(_kernels()[3], q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), g.data_ptr(), lengths.data_ptr(),
                seeds.data_ptr(), stats.data_ptr(), saved[1].data_ptr(),
                terms.data_ptr(), gr.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, *scalars)
    else:
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        delta = torch.empty((B, num_heads, T), dtype=torch.float32,
                            device=q.device)
        capturing = _launch(_kernels()[1], q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), g.data_ptr(), lengths.data_ptr(),
                seeds.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, *scalars, int(dot_dtype == torch.bfloat16),
                int(q.dtype == torch.bfloat16))
    _count("bwd", tensor_core, capturing)
    return dq, dk, dv


class _AttentionCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, seeds, num_heads, rate, dot_dtype):
        args = (lengths, seeds, num_heads, rate, dot_dtype)
        if q.device.type == "cpu":
            out, saved = attention_plain(q, k, v, *args), ()
        elif q.device.type != "cuda":
            raise ValueError(f"attention_core: unsupported device {q.device}")
        else:
            q, k, v = (t.contiguous() for t in (q, k, v))
            out, saved = attention_forward_cuda(q, k, v, *args)
        ctx.save_for_backward(q, k, v, lengths, seeds, *saved)
        ctx.args = (num_heads, rate, dot_dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lengths, seeds, *saved = ctx.saved_tensors
        num_heads, rate, dot_dtype = ctx.args
        g = g.float().contiguous()
        if not saved:
            dq, dk, dv = attention_plain_backward(
                q, k, v, g, lengths, seeds, num_heads, rate, dot_dtype)
        else:
            dq, dk, dv = attention_backward_cuda(
                q, k, v, g, lengths, seeds, tuple(saved), num_heads, rate,
                dot_dtype)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def attention_core(q, k, v, lengths, seeds, num_heads: int, rate: float,
                   dot_dtype=torch.bfloat16):
    """Multi-head masked softmax attention with probability dropout.

    :param q, k, v: (B, T, E) head-packed projections in the compute dtype
    :param lengths: (B,) int32 valid key counts (contiguous masks)
    :param seeds: (B,) int32 per-row dropout seeds (ignored at rate 0)
    :param num_heads: H; D = E // H
    :param rate: dropout rate on the attention probabilities
    :return: (B, T, E) float32 attention output (before the output
        projection); differentiable in q, k and v
    """
    return _AttentionCore.apply(q, k, v, lengths, seeds, num_heads, rate,
                                dot_dtype)


attention_core.fwd_launches = 0
attention_core.bwd_launches = 0
# the launches of the above that took the tensor-core instance
attention_core.tc_fwd_launches = 0
attention_core.tc_bwd_launches = 0
# launches recorded under CUDA-graph capture (run at every replay)
attention_core.fwd_captured = 0
attention_core.bwd_captured = 0
attention_core.tc_fwd_captured = 0
attention_core.tc_bwd_captured = 0
