"""HiFi-GAN generator, PyTorch port.

Counterpart of ``daft_exprt_tpu/vocoder/hifigan.py``: conv_pre(k7) ->
[leaky -> ConvTranspose upsample -> multi-receptive-field fusion (the
resblocks of the stage, averaged)] per rate -> leaky -> conv_post(k7) ->
tanh, with ResBlock1 (two convs per dilation, official v1/v2) or ResBlock2
(one conv per dilation, v3). Parameters carry the official HiFi-GAN
state_dict names (``conv_pre``, ``ups.{i}``, ``resblocks.{i}.convs1.{j}``
/ ``convs2.{j}`` or ``convs.{j}``, ``conv_post``), so official checkpoints
load with ``strict=True`` (:func:`load_torch_generator`).

Activations are (B, C, T). The staged convs are cuDNN / the CPU's convs
with operands in the caller's ``dtype`` (float32 by default, the dot dtype
of the JAX server's vocoder) and a float32 result, with the bias added
after, as the JAX package's ``_conv``. A stage whose channel count
C satisfies ``C <= 128`` and ``128 % C == 0`` (the JAX package's
``c_out * r_out == 128``) runs its whole resblock fan as one
:func:`~daft_exprt_tpu_torch.ops.mrf_vocoder.fused_mrf` call (K5): bf16
operands and float32 carries, as on the TPU. For V1 that is stages 1-3
(C = 128, 64, 32). :meth:`HiFiGanGenerator.forward` serves (no
gradients, K5); :meth:`HiFiGanGenerator.staged` is the same map through the
staged convs alone, differentiable, the generator of GAN training
(``vocoder/train.py``). Under weight norm (``train.wn_wrap``) a conv holds
``weight_v`` and ``weight_g`` instead of ``weight`` and materializes its
weight from them on every call.

:meth:`HiFiGanGenerator.replayed` runs :meth:`~HiFiGanGenerator.forward`
through the generator's own :class:`~daft_exprt_tpu_torch.inference.
graphs.GraphCache` (one CUDA graph per label, dtype and input shape,
captured at the first call of a shape): the counterpart of the JAX
package's ``_prepared_vocoder`` and its ``_vocode_cache``. :func:`vocode_mels`
(per rows and padded length) and the streamer's window
(``vocoder/streaming.py``) go through it. Its graphs are dropped whenever
a parameter moves or changes in place (the key ``mrf_programs`` repacks
K5's programs on), so a replay never reads new staged-conv weights beside
stale K5 programs: the graphs of one weight version live at a time, within
the JAX cache's bound of two.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from daft_exprt_tpu_torch.device import default_device
from daft_exprt_tpu_torch.inference.graphs import GraphCache, to_host
from daft_exprt_tpu_torch.ops.mrf_vocoder import (LRELU_SLOPE,
                                                  build_mrf_program,
                                                  fused_mrf)

V1_CONFIG = {
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "num_mels": 80,
    # "1": ResBlock1 (two convs per dilation, official v1/v2);
    # "2": ResBlock2 (one conv per dilation, official v3)
    "resblock": "1",
}
# the most graphs a generator keeps (the streamer's window, vocode_mels'
# (rows, padded T) buckets), the least recently run evicted first
VOCODER_GRAPHS = 64
MEL_FLOOR = math.log(1e-5)  # the mel log-clamp floor: padding past a length


def _leaky(x):
    return F.leaky_relu(x, LRELU_SLOPE)


def weight_norm_weight(v, g):
    """w = g * v / max(||v||, 1e-12), the norm over every dim but 0: torch's
    ``weight_norm(dim=0)`` grouping, the output channel of a conv and the
    input channel of a transposed conv in torch's (in, out, k) layout."""
    norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return g * v / norm.clamp_min(1e-12)


class _Conv(nn.Module):
    """A conv's ``weight`` and ``bias``: (out, in, k) for a conv, (in, out,
    k) for a transposed conv, as torch's modules lay them out."""

    def __init__(self, weight_shape, out_ch: int, fan_in: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*weight_shape))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.fan_in = fan_in

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        """torch's Conv1d default init (kaiming uniform, a=sqrt(5)), the
        JAX package's ``_conv_init``."""
        bound = 1.0 / math.sqrt(self.fan_in)
        for p, limit in ((self.weight, math.sqrt(3.0) * bound),
                         (self.bias, bound)):
            p.copy_(torch.rand(p.shape, generator=gen) * (2 * limit) - limit)

    def effective_weight(self):
        """``weight``, or under weight norm the weight materialized from
        ``weight_v`` and ``weight_g`` (so that gradients reach both)."""
        if "weight_v" in self._parameters:
            return weight_norm_weight(self.weight_v, self.weight_g)
        return self.weight


def _conv(in_ch, out_ch, k):
    return _Conv((out_ch, in_ch, k), out_ch, in_ch * k)


def conv(x, p: _Conv, dilation: int = 1, dtype=torch.float32):
    """SAME-padded dilated conv of (B, C, T) in ``dtype``, float32 result
    plus the float32 bias."""
    w = p.effective_weight()
    y = F.conv1d(x.to(dtype), w.to(dtype), dilation=dilation,
                 padding=(w.shape[-1] - 1) * dilation // 2)
    return y.float() + p.bias[:, None]


def conv_transpose(x, p: _Conv, stride: int, dtype=torch.float32):
    """torch ConvTranspose1d(k, stride u, padding (k - u) // 2) in ``dtype``,
    float32 result plus the float32 bias: T -> T * u for even k - u."""
    w = p.effective_weight()
    y = F.conv_transpose1d(x.to(dtype), w.to(dtype), stride=stride,
                           padding=(w.shape[-1] - stride) // 2)
    return y.float() + p.bias[:, None]


class ResBlock(nn.Module):
    """One resblock: official ResBlock1 (``convs1`` at the dilations,
    ``convs2`` at dilation 1) or ResBlock2 (``convs``)."""

    def __init__(self, ch: int, k: int, dilations, two_convs: bool):
        super().__init__()
        self.dilations = list(dilations)
        self.two_convs = two_convs
        first = nn.ModuleList([_conv(ch, ch, k) for _ in dilations])
        if two_convs:
            self.convs1 = first
            self.convs2 = nn.ModuleList([_conv(ch, ch, k) for _ in dilations])
        else:
            self.convs = first

    def units(self):
        """Per dilation, the unit's convs as (conv, dilation)."""
        first = self.convs1 if self.two_convs else self.convs
        return [[(c1, d)] + ([(self.convs2[j], 1)] if self.two_convs else [])
                for j, (c1, d) in enumerate(zip(first, self.dilations))]

    def forward(self, x, dtype=torch.float32):
        for unit in self.units():
            t = x
            for p, d in unit:
                t = conv(_leaky(t), p, d, dtype)
            x = x + t
        return x


def mrf_eligible(channels: int) -> bool:
    """Whether a stage of this width runs its fan through K5."""
    return channels <= 128 and 128 % channels == 0


class HiFiGanGenerator(nn.Module):
    """The generator, constructed on ``cuda`` unless ``device`` says
    otherwise, with parameters drawn from ``seed``.

    :param config: HiFi-GAN config dict (keys of :data:`V1_CONFIG`;
        others are ignored); V1 when None
    """

    def __init__(self, config: dict | None = None, device=None,
                 seed: int = 0):
        super().__init__()
        cfg = dict(V1_CONFIG)
        if config:
            cfg.update({k: v for k, v in config.items() if k in V1_CONFIG})
        cfg["resblock"] = str(cfg["resblock"])
        if cfg["resblock"] not in ("1", "2"):
            raise ValueError(
                "only ResBlock1 (v1/v2) and ResBlock2 (v3) generators are "
                f"supported; got resblock={cfg['resblock']!r}")
        self.cfg = cfg
        self.num_upsamples = len(cfg["upsample_rates"])
        self.num_kernels = len(cfg["resblock_kernel_sizes"])
        self.two_convs = cfg["resblock"] == "1"
        ch0 = cfg["upsample_initial_channel"]
        self.conv_pre = _conv(cfg["num_mels"], ch0, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, k in enumerate(cfg["upsample_kernel_sizes"]):
            cin, cout = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
            self.ups.append(_Conv((cin, cout, k), cout, cin * k))
            for kr, dil in zip(cfg["resblock_kernel_sizes"],
                               cfg["resblock_dilation_sizes"]):
                self.resblocks.append(ResBlock(cout, kr, dil,
                                               self.two_convs))
        self.conv_post = _conv(ch0 // 2 ** self.num_upsamples, 1, 7)
        self._programs = None  # (key, {stage: MrfProgram}) for K5
        self._graphs = None  # (weights key, GraphCache) of replayed()
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(default_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.conv_pre.bias.device

    def reset_parameters(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, _Conv):
                m.reset_parameters(gen)

    def stage_channels(self, i: int) -> int:
        return self.cfg["upsample_initial_channel"] // 2 ** (i + 1)

    def stage_resblocks(self, i: int):
        return self.resblocks[i * self.num_kernels:
                              (i + 1) * self.num_kernels]

    def mrf_programs(self):
        """{stage: MrfProgram} of the K5 stages, repacked whenever a
        parameter moved or changed in place."""
        params = list(self.resblocks.parameters())
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._programs is None or self._programs[0] != key:
            programs = {}
            for i in range(self.num_upsamples):
                if mrf_eligible(self.stage_channels(i)):
                    programs[i] = build_mrf_program([
                        [[(p.effective_weight(), p.bias, d) for p, d in unit]
                         for unit in rb.units()]
                        for rb in self.stage_resblocks(i)])
            self._programs = (key, programs)
        return self._programs[1]

    def graph_state(self):
        """What a captured pass reads besides the parameters: K5's
        programs as last built (None before the first pass)."""
        return self._programs and self._programs[1]

    def graphs(self) -> GraphCache:
        """The cache of :meth:`replayed`, emptied (a new one, with its own
        pool) whenever any parameter moved or changed in place since its
        graphs were captured."""
        key = (self.device,) + tuple((p.data_ptr(), p._version)
                                     for p in self.parameters())
        if self._graphs is None or self._graphs[0] != key:
            self._graphs = (key, GraphCache(self.device,
                                            max_entries=VOCODER_GRAPHS))
        return self._graphs[1]

    @torch.no_grad()
    def replayed(self, mel, dtype=torch.float32, label: str = "vocode"):
        """:meth:`forward` through the graph of (``label``, ``dtype``,
        ``mel``'s shape): eager at a shape's first call (then captured on
        the card), a replay after it.

        :param mel: (B, num_mels, T) numpy array or tensor, copied into the
            graph's static input
        :return: the waveform, valid until the next call of this
            generator's graphs (a replay overwrites it): copy it out first
        """
        cache = self.graphs()
        programs = self.mrf_programs()
        return cache.run((label, dtype),
                         lambda m: self._run(m, dtype, programs), (mel,),
                         keep=self.graph_state)

    def _run(self, mel, dtype, programs):
        x = conv(mel.float(), self.conv_pre, dtype=dtype)
        for i, u in enumerate(self.cfg["upsample_rates"]):
            x = conv_transpose(_leaky(x), self.ups[i], u, dtype)
            if i in programs:
                x = fused_mrf(x.transpose(1, 2).contiguous(),
                              programs[i]).transpose(1, 2)
                continue
            acc = None
            for rb in self.stage_resblocks(i):
                y = rb(x, dtype)
                acc = y if acc is None else acc + y
            x = acc / self.num_kernels
        x = conv(_leaky(x), self.conv_post, dtype=dtype)
        return torch.tanh(x)[:, 0]

    @torch.no_grad()
    def forward(self, mel, dtype=torch.float32):
        """mel (B, num_mels, T) log-mel -> waveform (B, T * prod(rates)),
        float32. ``dtype`` is the operand dtype of the staged convs
        (conv_pre, ups, the stages K5 does not take, conv_post); K5 keeps
        its bf16 operands."""
        return self._run(mel, dtype, self.mrf_programs())

    def staged(self, mel, dtype=torch.float32):
        """:meth:`forward`'s map through the staged convs alone (no K5,
        which has no backward), differentiable: the JAX package's
        ``HiFiGanGenerator.apply``."""
        return self._run(mel, dtype, {})


def vocode_mels(gen: HiFiGanGenerator, mels, *, bucket: int = 128,
                max_batch: int = 16, dtype=torch.float32):
    """Batched mel -> waveform with bucketed padding, on the generator's
    device.

    :param mels: list of (num_mels, T_i) arrays (true lengths)
    :return: list of 1-D float32 numpy waveforms cropped to T_i *
        prod(rates)

    Rows are grouped by length padded up to a multiple of ``bucket``
    (padding with the mel floor ``log(1e-5)``) and run ``max_batch`` at a
    time, with the staged convs' operands in ``dtype``: one
    :meth:`~HiFiGanGenerator.replayed` pass per (rows, padded length),
    copied to the host with one wait.
    """
    up = int(np.prod(gen.cfg["upsample_rates"]))
    n_mels = gen.cfg["num_mels"]
    groups = {}
    for i, mel in enumerate(mels):
        t = mel.shape[1]
        groups.setdefault(max(-(-t // bucket) * bucket, bucket), []).append(i)
    wavs = [None] * len(mels)
    for t_pad, idxs in sorted(groups.items()):
        for start in range(0, len(idxs), max_batch):
            chunk = idxs[start:start + max_batch]
            batch = np.full((len(chunk), n_mels, t_pad), MEL_FLOOR,
                            np.float32)
            for row, i in enumerate(chunk):
                batch[row, :, :mels[i].shape[1]] = mels[i]
            out = to_host(gen.replayed(batch, dtype))
            for row, i in enumerate(chunk):
                wavs[i] = out[row, :mels[i].shape[1] * up]
    return wavs


def generator_from_state_dict(state, config=None,
                              device=None) -> HiFiGanGenerator:
    """A :class:`HiFiGanGenerator` from a torch HiFi-GAN state_dict, with or
    without weight norm (``weight_v``/``weight_g`` folded into ``weight``)."""
    gen = HiFiGanGenerator(config, device=device)
    folded = {}
    for prefix in {k.rsplit(".", 1)[0] for k in state}:
        folded[f"{prefix}.weight"] = (
            state[f"{prefix}.weight"].float() if f"{prefix}.weight" in state
            else weight_norm_weight(state[f"{prefix}.weight_v"].float(),
                                    state[f"{prefix}.weight_g"].float()))
        folded[f"{prefix}.bias"] = state[f"{prefix}.bias"].float()
    gen.load_state_dict(folded, strict=True)
    return gen


def load_torch_generator(checkpoint_path: str, config=None, device=None):
    """An official PyTorch HiFi-GAN generator checkpoint
    (``{'generator': state_dict}`` or a bare state_dict, with or without
    weight norm) as a :class:`HiFiGanGenerator`.

    :param config: HiFi-GAN config dict or the path of its JSON file
    """
    blob = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    return generator_from_state_dict(blob.get("generator", blob), config,
                                     device)


def export_torch_state_dict(gen: HiFiGanGenerator) -> dict:
    """The generator as an official weight-normalized torch HiFi-GAN blob,
    ``{"generator": state_dict}`` on the CPU: each conv's weight re-derived
    from its effective weight w as ``weight_v`` = w and ``weight_g`` = ||w||
    in torch's ``weight_norm(dim=0)`` grouping (the JAX package's
    ``export_torch_state_dict``)."""
    sd = {}
    for name, m in gen.named_modules():
        if isinstance(m, _Conv):
            w = m.effective_weight().detach().float().cpu()
            sd[f"{name}.weight_g"] = w.square().sum(
                dim=(1, 2), keepdim=True).sqrt()
            sd[f"{name}.weight_v"] = w.clone()
            sd[f"{name}.bias"] = m.bias.detach().float().cpu().clone()
    return {"generator": sd}


def load_generator(path: str, config=None, device=None) -> HiFiGanGenerator:
    """A generator from a torch HiFi-GAN ``g_*`` file
    (:func:`load_torch_generator`), such as the port's own trainer writes
    (``vocoder/train.py``). A ``Vocoder_*`` directory (one holding
    ``meta.json``) is refused: it is the JAX trainer's Orbax format, which
    the port cannot read."""
    if os.path.isdir(path) and os.path.isfile(os.path.join(path,
                                                           "meta.json")):
        raise NotImplementedError(
            f"{path} is a Vocoder_* directory, the JAX trainer's Orbax "
            "checkpoint format, which the port cannot read. Export it to a "
            "torch g_* file with tools/export_vocoder_torch.py (on a machine "
            "with JAX); the port's own trainer writes g_* files, which "
            "load_generator reads")
    return load_torch_generator(path, config, device=device)
