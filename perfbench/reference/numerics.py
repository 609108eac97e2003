"""Operand precision of the plain references.

``"f32"`` is the reference itself: every product in float32 with TF32 off
(set by :func:`no_tf32`). ``"bf16"`` rounds every operand to bfloat16, the
configurations' own precision (for studying the readings). ``"fp8"`` is
the control: the same arithmetic,
but each operand of every product (matmul and conv) first rounded to
float8 e4m3 with a per-tensor scale (the largest magnitude mapped to 448),
the step below the bfloat16 the configurations state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("f32", "bf16", "fp8")
FP8_MAX = 448.0


def no_tf32():
    """float32 products in float32 (cuBLAS and cuDNN would take TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Numerics:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"numerics {mode!r} not in {MODES}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand as the products see it (float32)."""
        t = t.float()
        if self.mode == "f32":
            return t
        if self.mode == "bf16":
            return _RoundBf16.apply(t)
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return _Round8.apply(t, scale)

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def conv1d(self, x, w, **kw):
        return F.conv1d(self.q(x), self.q(w), **kw)

    def conv_transpose1d(self, x, w, **kw):
        return F.conv_transpose1d(self.q(x), self.q(w), **kw)


class _Round8(torch.autograd.Function):
    """Rounding to float8 e4m3 at ``scale``; the gradient passes through
    (a straight-through estimator: the control's backward sees its rounded
    forward, and its own products round their operands again)."""

    @staticmethod
    def forward(ctx, t, scale):
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundBf16(torch.autograd.Function):
    """Rounding to bfloat16; the gradient passes through."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g
