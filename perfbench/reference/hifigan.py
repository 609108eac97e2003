"""HiFi-GAN's generator in plain PyTorch: the benchmark's reference.

jik876/hifi-gan ``models.py`` ``Generator`` with ``ResBlock1``
(Kong et al., arXiv:2010.05646): conv_pre (k=7) -> per upsample rate
[leaky ReLU -> transposed conv -> the mean of the stage's resblocks] ->
leaky ReLU -> conv_post (k=7) -> tanh. A ResBlock1 unit, at each dilation,
is leaky -> conv(dilated) -> leaky -> conv -> + input. Parameters under the
official state_dict names, without weight norm (folded), as dicts.

One departure, which the program under test has: the leaky ReLU before
conv_post takes the slope 0.1 of every other one (the official code calls
``F.leaky_relu(x)`` there, whose slope is 0.01).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.numerics import Numerics

SLOPE = 0.1


def param_spec(cfg: dict) -> list:
    """[(name, shape, init)]: torch's Conv1d default init (uniform within
    1/sqrt(fan_in) for the bias, sqrt(3)/sqrt(fan_in) for the weight)."""
    spec = []

    def conv(name, shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        spec.append((f"{name}.weight", shape, math.sqrt(3.0) * bound))
        spec.append((f"{name}.bias", (shape[1] if "ups." in name
                                      else shape[0],), bound))

    ch0 = cfg["upsample_initial_channel"]
    conv("conv_pre", (ch0, cfg["num_mels"], 7), cfg["num_mels"] * 7)
    n = 0
    for i, k in enumerate(cfg["upsample_kernel_sizes"]):
        cin, cout = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
        conv(f"ups.{i}", (cin, cout, k), cin * k)
    for i in range(len(cfg["upsample_rates"])):
        c = ch0 // 2 ** (i + 1)
        for kr, dil in zip(cfg["resblock_kernel_sizes"],
                           cfg["resblock_dilation_sizes"]):
            for j in range(len(dil)):
                conv(f"resblocks.{n}.convs1.{j}", (c, c, kr), c * kr)
            for j in range(len(dil)):
                conv(f"resblocks.{n}.convs2.{j}", (c, c, kr), c * kr)
            n += 1
    c = ch0 // 2 ** len(cfg["upsample_rates"])
    conv("conv_post", (1, c, 7), c * 7)
    return spec


def _conv(nx: Numerics, x, P, name, dilation=1):
    w = P[f"{name}.weight"]
    y = nx.conv1d(x, w, dilation=dilation,
                  padding=(w.shape[-1] - 1) * dilation // 2)
    return y + P[f"{name}.bias"][:, None]


def generate(nx: Numerics, P, cfg, mel):
    """mel (B, num_mels, T) -> waveform (B, T * prod(rates))."""
    x = _conv(nx, mel, P, "conv_pre")
    nk = len(cfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"],
                                   cfg["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, SLOPE)
        x = nx.conv_transpose1d(x, P[f"ups.{i}.weight"], stride=u,
                                padding=(k - u) // 2) \
            + P[f"ups.{i}.bias"][:, None]
        acc = None
        for r in range(nk):
            name = f"resblocks.{i * nk + r}"
            y = x
            for j, d in enumerate(cfg["resblock_dilation_sizes"][r]):
                t = _conv(nx, F.leaky_relu(y, SLOPE), P, f"{name}.convs1.{j}",
                          d)
                t = _conv(nx, F.leaky_relu(t, SLOPE), P, f"{name}.convs2.{j}")
                y = y + t
            acc = y if acc is None else acc + y
        x = acc / nk
    x = _conv(nx, F.leaky_relu(x, SLOPE), P, "conv_post")
    return torch.tanh(x)[:, 0]
