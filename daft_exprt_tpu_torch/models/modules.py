"""Neural-net building blocks of the port.

Counterparts of ``daft_exprt_tpu/models/modules.py``. Parameters live in
the reference PyTorch layouts and under the reference state_dict names
(linear ``linear_layer.weight`` (out, in), conv ``conv.weight``
(out, in, k), attention ``multi_head_attention.in_proj_weight`` (3E, E)),
so reference checkpoints load with ``strict=True``. Activations are
channel-last (B, T, C) and FiLM rows are (B, 2C) ``[gammas | betas]``, as
in the JAX package.

Dots take operands rounded to the compute dtype and accumulate in
float32 (the JAX ``preferred_element_type=float32`` contract); convs run
in the compute dtype, add the bias in float32 and cast to ``out_dtype``;
LayerNorm statistics are float32. In training, convs take the JAX
package's shifted-matmul form (float32 results from operands rounded to
the compute dtype), FFT blocks run the training kernels K2 and K3 (or, at
the widths ``plan_conv_ff`` gives it, the C-blocked K4) with their
in-kernel hash dropout, and the other dropouts draw from an
explicit ``torch.Generator``.

Each parameter-holding module has ``reset_parameters(gen)``, which draws
from the JAX init's distributions (``modules.py`` xavier/bias init) with
an explicit CPU ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from daft_exprt_tpu_torch.ops.attention_train import attention_core
from daft_exprt_tpu_torch.ops.conv_ff_train import (conv_ff_train,
                                                    conv_ff_train_blocked,
                                                    plan_conv_ff)
from daft_exprt_tpu_torch.ops.fft_block import fused_fft_block, pack_weights
from daft_exprt_tpu_torch.ops.masking import mask_from_lengths

_GAINS = {"linear": 1.0, "relu": math.sqrt(2.0)}
_NEG = torch.finfo(torch.float32).min


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


@torch.no_grad()
def _fill_uniform(p: torch.Tensor, limit: float, gen: torch.Generator):
    p.copy_(torch.rand(p.shape, generator=gen) * (2 * limit) - limit)


def _xavier_limit(fan_in: int, fan_out: int, gain: str = "linear") -> float:
    return _GAINS[gain] * math.sqrt(6.0 / (fan_in + fan_out))


def init_parameters(module: nn.Module, gen: torch.Generator):
    """Draw every parameter under ``module`` from the JAX init's
    distributions, in a fixed module order, from ``gen``."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)


def rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype``, as float32."""
    return t.to(dtype).float()


def _uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform [0, 1) draws from ``generator`` (on its own device), moved
    to ``device``."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def dropout(x, rate: float, generator: torch.Generator, training: bool):
    """Inverted dropout: kept values are divided by 1 - rate (as the JAX
    package's ``modules.dropout``)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _uniform(x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def draw_seeds(batch: int, rate: float, generator: torch.Generator,
               device) -> torch.Tensor:
    """Per-row int32 seeds of the training kernels' hash dropout: a fresh
    draw from ``generator`` when ``rate > 0``, zeros otherwise."""
    if rate <= 0.0:
        return torch.zeros((batch,), dtype=torch.int32, device=device)
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    return torch.randint(-2 ** 31, 2 ** 31, (batch,), generator=generator,
                         device=generator.device,
                         dtype=torch.int32).to(device)


def linear(x, weight, bias, dtype=torch.float32):
    """x @ weight.T + bias; operands rounded to ``dtype``, f32 result."""
    y = rounded(x, dtype) @ rounded(weight, dtype).t()
    return y if bias is None else y + bias


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm with float32 statistics and biased variance."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


# ----------------------------------------------------------------------
# Linear, Conv1d, LayerNorm, Embedding
# ----------------------------------------------------------------------
class _Affine(nn.Module):
    """A weight and a bias (the reference's inner nn.Linear / nn.Conv1d)."""

    def __init__(self, weight_shape, out_dim: int, gain: str = "linear"):
        super().__init__()
        self.weight = _param(*weight_shape)
        self.bias = _param(out_dim)
        self.gain = gain

    def reset_parameters(self, gen: torch.Generator):
        w = self.weight
        k = w.shape[2] if w.dim() == 3 else 1
        fan_in, fan_out = w.shape[1] * k, w.shape[0] * k
        _fill_uniform(w, _xavier_limit(fan_in, fan_out, self.gain), gen)
        _fill_uniform(self.bias, 1.0 / math.sqrt(fan_in), gen)


class Linear(nn.Module):
    """Reference LinearNorm: weight (out, in) under ``linear_layer``."""

    def __init__(self, in_dim: int, out_dim: int, gain: str = "linear"):
        super().__init__()
        self.linear_layer = _Affine((out_dim, in_dim), out_dim, gain)

    def forward(self, x, dtype=torch.float32):
        return linear(x, self.linear_layer.weight, self.linear_layer.bias,
                      dtype)


class Conv1d(nn.Module):
    """Reference ConvNorm1D: weight (out, in, k) under ``conv``; SAME zero
    padding, stride 1, on channel-last (B, L, C) activations."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 gain: str = "linear"):
        super().__init__()
        self.conv = _Affine((out_ch, in_ch, kernel), out_ch, gain)

    def forward(self, x, dtype=torch.float32, out_dtype=torch.float32,
                matmul_form: bool = False):
        """``matmul_form`` (training, odd kernels): sum over taps of the
        shifted input times the tap's weight, in float32 from operands
        rounded to ``dtype``, as the JAX package's training convs; else
        one conv in ``dtype``.

        The taps slice the input already cast to ``dtype``, so each tap's
        input gradient is rounded to ``dtype`` and autograd adds the k of
        them in ``dtype``, last tap first: the order of JAX's backward
        pass as XLA:CPU runs it (bit-equal at bf16, see
        tests/test_torch_train_ops.py)."""
        w = self.conv.weight
        k = w.shape[-1]
        pad = (k - 1) // 2
        if matmul_form and k % 2 == 1:
            L = x.shape[1]
            xp = F.pad(x.to(dtype), (0, 0, pad, pad))
            wr = rounded(w, dtype)
            y = xp[:, 0:L].float() @ wr[:, :, 0].t()
            for d in range(1, k):
                y = y + xp[:, d:d + L].float() @ wr[:, :, d].t()
        else:
            y = F.conv1d(x.to(dtype).transpose(1, 2), w.to(dtype),
                         padding=pad).transpose(1, 2).float()
        return (y + self.conv.bias).to(out_dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = _param(dim)
        self.bias = _param(dim)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, out_dtype=torch.float32):
        return layer_norm(x, self.weight, self.bias).to(out_dtype)


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = _param(num, dim)

    def reset_parameters(self, gen: torch.Generator):
        num, dim = self.weight.shape
        _fill_uniform(self.weight, _xavier_limit(num, dim), gen)

    def forward(self, ids):
        return self.weight[ids.long()]


# ----------------------------------------------------------------------
# Multi-head self-attention (+ residual + post-LN)
# ----------------------------------------------------------------------
class _AttentionParams(nn.Module):
    """The reference nn.MultiheadAttention's parameters: packed q/k/v
    ``in_proj_weight`` (3E, E) and an ``out_proj`` Linear."""

    def __init__(self, embed_dim: int):
        super().__init__()
        E = embed_dim
        self.in_proj_weight = _param(3 * E, E)
        self.in_proj_bias = _param(3 * E)
        self.out_proj = nn.Module()
        self.out_proj.weight = _param(E, E)
        self.out_proj.bias = _param(E)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        E = self.out_proj.weight.shape[0]
        # q/k/v: xavier over the packed (3E, E) matrix; out_proj uniform
        # +-1/sqrt(E); biases zero.
        for i in range(3):
            _fill_uniform(self.in_proj_weight[i * E:(i + 1) * E],
                          _xavier_limit(E, 3 * E), gen)
        _fill_uniform(self.out_proj.weight, 1.0 / math.sqrt(E), gen)
        self.in_proj_bias.zero_()
        self.out_proj.bias.zero_()


class MultiHeadAttention(nn.Module):
    """Counterpart of ``mha_apply`` (deterministic): key-masked softmax
    attention, output projection, residual, LayerNorm."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.multi_head_attention = _AttentionParams(embed_dim)
        self.layer_norm = LayerNorm(embed_dim)
        self.num_heads = num_heads

    def forward(self, x, key_valid, dtype=torch.float32):
        """:param x: (B, T, E); :param key_valid: (B, T) bool."""
        B, T, E = x.shape
        H = self.num_heads
        D = E // H
        p = self.multi_head_attention
        q, k, v = (linear(x, p.in_proj_weight[i * E:(i + 1) * E],
                          p.in_proj_bias[i * E:(i + 1) * E], dtype)
                   .reshape(B, T, H, D).transpose(1, 2) for i in range(3))
        logits = (rounded(q, dtype) @ rounded(k, dtype).transpose(-1, -2)) \
            * (1.0 / math.sqrt(D))
        logits = logits.masked_fill(~key_valid[:, None, None, :], _NEG)
        # Padded query rows get a finite (uniform) softmax and are zeroed
        # by the block's row mask.
        unnorm = torch.exp(logits - logits.amax(-1, keepdim=True))
        probs = unnorm / unnorm.sum(-1, keepdim=True).clamp_min(1e-30)
        ctx = rounded(probs, dtype) @ rounded(v, dtype)
        ctx = ctx.transpose(1, 2).reshape(B, T, E)
        out = linear(ctx, p.out_proj.weight, p.out_proj.bias, dtype)
        return self.layer_norm(out + x)

    def forward_train(self, x, lengths, dtype, rate: float,
                      generator: torch.Generator):
        """Training path (``mha_apply``, train kernel branch): q/k/v
        rounded to ``dtype`` -> K2 with probability dropout -> output
        projection -> dropout -> +x -> LayerNorm.

        :param lengths: (B,) int32 valid key counts
        """
        B, T, E = x.shape
        p = self.multi_head_attention
        q, k, v = (linear(x, p.in_proj_weight[i * E:(i + 1) * E],
                          p.in_proj_bias[i * E:(i + 1) * E], dtype).to(dtype)
                   for i in range(3))
        seeds = draw_seeds(B, rate, generator, x.device)
        ctx = attention_core(q, k, v, lengths, seeds, self.num_heads, rate,
                             dtype)
        out = linear(ctx, p.out_proj.weight, p.out_proj.bias, dtype)
        out = dropout(out, rate, generator, True)
        return self.layer_norm(out + x)


# ----------------------------------------------------------------------
# Position-wise conv feed-forward (+ FiLM)
# ----------------------------------------------------------------------
class ConvFF(nn.Module):
    """Counterpart of ``conv_ff_apply``: conv -> relu -> conv -> residual
    -> LayerNorm -> FiLM; in training one K3 or K4 call."""

    def __init__(self, embed_dim: int, conv_channels: int, kernel: int):
        super().__init__()
        self.convs = nn.ModuleDict({
            "0": Conv1d(embed_dim, conv_channels, kernel, "relu"),
            "2": Conv1d(conv_channels, embed_dim, kernel, "linear"),
        })
        self.layer_norm = LayerNorm(embed_dim)

    def forward(self, x, film, dtype=torch.float32):
        """:param film: (B, 2E) ``[gammas | betas]`` or None."""
        h = torch.relu(self.convs["0"](x, dtype))
        h = self.convs["2"](h, dtype)
        out = self.layer_norm(h + x)
        if film is not None:
            E = out.shape[-1]
            out = film[:, None, :E] * out + film[:, None, E:]
        return out

    def forward_train(self, x, film, dtype, rate: float,
                      generator: torch.Generator):
        """Training path: K3, or K4 at the widths ``plan_conv_ff`` gives
        it, with the kernels' in-kernel dropout; ``film`` None is the
        identity ``[1 | 0]``."""
        B, T, E = x.shape
        if film is None:
            film = torch.cat([torch.ones((B, E), device=x.device),
                              torch.zeros((B, E), device=x.device)], dim=1)
        c1, c2 = self.convs["0"].conv, self.convs["2"].conv
        C, _, kernel = c1.weight.shape
        c_block = plan_conv_ff(T, E, C, kernel)
        seeds = draw_seeds(B, rate, generator, x.device)
        args = (x.float(), c1.weight, c1.bias, c2.weight, c2.bias,
                self.layer_norm.weight, self.layer_norm.bias, film.float(),
                seeds, rate)
        if c_block == C:
            return conv_ff_train(*args, dtype)
        return conv_ff_train_blocked(*args, c_block, dtype)


# ----------------------------------------------------------------------
# FFT block
# ----------------------------------------------------------------------
class FFTBlock(nn.Module):
    """MHA -> mask -> ConvFF(FiLM) -> mask (``fft_block_apply``).

    In inference (no dropout, no gradients) the block is one fused K1
    call. In training (dropout rates given, or gradients needed) it runs
    MHA through K2 -> row mask -> ConvFF through K3 or K4 (as
    ``plan_conv_ff`` picks: K3 at the flagship's E=128, K4 at the wide
    ablation's E=512) -> row mask, both differentiable. Each is the CUDA
    kernel for CUDA tensors and its plain version on the CPU.
    """

    def __init__(self, embed_dim: int, num_heads: int, conv_channels: int,
                 kernel: int):
        super().__init__()
        self.attention = MultiHeadAttention(embed_dim, num_heads)
        self.feed_forward = ConvFF(embed_dim, conv_channels, kernel)
        self.num_heads = num_heads
        self._packed = None  # (key, FFTBlockWeights) for the fused kernel

    def _params(self):
        a = self.attention
        f = self.feed_forward
        return (a.multi_head_attention.in_proj_weight,
                a.multi_head_attention.in_proj_bias,
                a.multi_head_attention.out_proj.weight,
                a.multi_head_attention.out_proj.bias,
                a.layer_norm.weight, a.layer_norm.bias,
                f.convs["0"].conv.weight, f.convs["0"].conv.bias,
                f.convs["2"].conv.weight, f.convs["2"].conv.bias,
                f.layer_norm.weight, f.layer_norm.bias)

    def kernel_weights(self, dot_dtype):
        """The block's weights in K1's layout (bf16 dot weights for the
        tensor-core instance), made once per weight version: repacked
        whenever a parameter moved or changed in place."""
        params = self._params()
        key = (dot_dtype,) + tuple((p.data_ptr(), p._version) for p in params)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_weights(*params, dot_dtype=dot_dtype))
        return self._packed[1]

    def forward(self, x, film, lengths, dtype=torch.float32, drop=None):
        """:param x: (B, T, E) float32; :param film: (B, 2E) or None;
        :param lengths: (B,) int32 valid lengths;
        :param drop: None in inference, else (attention rate, conv
            rate, torch.Generator) for the training path."""
        lengths = lengths.to(torch.int32).contiguous()
        needs_grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self._params()))
        if drop is not None or needs_grad:
            attn_rate, conv_rate, gen = drop or (0.0, 0.0, None)
            valid = mask_from_lengths(lengths, x.shape[1])[..., None]
            a = self.attention.forward_train(x.float(), lengths, dtype,
                                             attn_rate, gen)
            a = torch.where(valid, a, 0.0)
            out = self.feed_forward.forward_train(a, film, dtype, conv_rate,
                                                  gen)
            return torch.where(valid, out, 0.0)
        if film is not None:  # a (B, blocks, 2E) slice: taken as it is
            film = film.float()
        return fused_fft_block(x.float().contiguous(),
                               self.kernel_weights(dtype), film, lengths,
                               num_heads=self.num_heads, dot_dtype=dtype)
