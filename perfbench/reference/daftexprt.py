"""Daft-Exprt in plain PyTorch: the benchmark's reference.

Daft-Exprt (Zaidi et al., arXiv:2108.02271; the reference repo's
``src/daft_exprt/model.py``): a prosody encoder reads a reference
utterance (mel, frame energy and pitch) and a speaker, pools it to one
embedding, and predicts FiLM parameters (gammas, betas) for every FFT
block of the phoneme encoder, for the local prosody predictor and for the
frame decoder; the phoneme encoder's output predicts per-symbol duration,
energy and pitch; a Gaussian upsampler spreads the symbols over frames;
the frame decoder emits an 80-bin mel. An FFT block is multi-head
self-attention (keys masked past the length) + residual + LayerNorm, then
conv(k=3) -> ReLU -> conv(k=3) + residual + LayerNorm, then FiLM.

Parameters are a flat dict under the reference repo's state_dict names
(:func:`param_spec` lists them, with the initial distribution the
benchmark draws them from). Activations are (B, T, C), float32 throughout;
every product goes through :class:`~numerics.Numerics`, which is the only
place a precision enters. No kernel, cache or graph of the program is
used. A row's result depends on the row and on the length its batch was
padded to: the prosody predictor's and the prenet's second convs read the
padding's LayerNorm output beside the last real position, as in the
reference repo; callers pad as the program's batch was padded.

Departures from the reference repo, as the program under test has them:
the post-multipliers scale the FiLM gammas and betas, dropout in training
comes from the counter hash of :mod:`dropout` inside attention and the
conv feed-forward and from a ``torch.Generator`` elsewhere (the order of
the draws is the program's, which :mod:`dropout` documents), and the
integer durations follow the reference repo's framing rule in float32
sums (:func:`durations_to_frames`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference import dropout as hashdrop
from reference.numerics import Numerics

NEG = float(torch.finfo(torch.float32).min)
_INV_SQRT_2PI = 0.3989422804014327


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------
def _xavier(fan_in, fan_out, gain=1.0):
    return gain * math.sqrt(6.0 / (fan_in + fan_out))


def _conv(spec, name, cin, cout, k, gain=1.0):
    spec.append((f"{name}.conv.weight", (cout, cin, k),
                 _xavier(cin * k, cout * k, gain)))
    spec.append((f"{name}.conv.bias", (cout,), 1.0 / math.sqrt(cin * k)))


def _linear(spec, name, cin, cout, gain=1.0):
    spec.append((f"{name}.linear_layer.weight", (cout, cin),
                 _xavier(cin, cout, gain)))
    spec.append((f"{name}.linear_layer.bias", (cout,), 1.0 / math.sqrt(cin)))


def _ln(spec, name, dim):
    spec.append((f"{name}.weight", (dim,), "ones"))
    spec.append((f"{name}.bias", (dim,), "zeros"))


def _fft_block(spec, name, E, C, k):
    a = f"{name}.attention"
    spec.append((f"{a}.multi_head_attention.in_proj_weight", (3 * E, E),
                 _xavier(E, 3 * E)))
    spec.append((f"{a}.multi_head_attention.in_proj_bias", (3 * E,),
                 "zeros"))
    spec.append((f"{a}.multi_head_attention.out_proj.weight", (E, E),
                 1.0 / math.sqrt(E)))
    spec.append((f"{a}.multi_head_attention.out_proj.bias", (E,), "zeros"))
    _ln(spec, f"{a}.layer_norm", E)
    f = f"{name}.feed_forward"
    _conv(spec, f"{f}.convs.0", E, C, k, math.sqrt(2.0))
    _conv(spec, f"{f}.convs.2", C, E, k)
    _ln(spec, f"{f}.layer_norm", E)


def param_spec(cfg: dict) -> list:
    """[(name, shape, init)] in the reference repo's state_dict names;
    ``init`` is the half-width of a uniform draw about zero, or "ones" or
    "zeros".

    :param cfg: a configuration file's contents (module dicts as the
        reference repo's hparams, and ``n_symbols``, ``n_speakers``,
        ``n_mel_channels``)
    """
    pe, ph = cfg["prosody_encoder"], cfg["phoneme_encoder"]
    pp, fd = cfg["local_prosody_predictor"], cfg["frame_decoder"]
    D, E = pe["hidden_embed_dim"], ph["hidden_embed_dim"]
    k, C = pe["conv_kernel"], pe["conv_channels"]
    n_mels, S = cfg["n_mel_channels"], cfg["n_speakers"]
    layout = film_layout(cfg)
    n_film = sum(b * c for b, c in layout)
    spec = []
    p = "prosody_encoder"
    spec.append((f"{p}.post_multipliers", (2, sum(b for b, _ in layout)),
                 _xavier(2, sum(b for b, _ in layout))))
    _conv(spec, f"{p}.energy_embedding", 1, D, k)
    _conv(spec, f"{p}.pitch_embedding", 1, D, k)
    for i, (cin, cout) in enumerate(((n_mels, C), (C, C), (C, D))):
        _conv(spec, f"{p}.convs.{4 * i}", cin, cout, k, math.sqrt(2.0))
        _ln(spec, f"{p}.convs.{4 * i + 2}", cout)
    for b in range(pe["nb_blocks"]):
        _fft_block(spec, f"{p}.blocks.{b}", D, C, k)
    spec.append((f"{p}.spk_embedding.weight", (S, D), _xavier(S, D)))
    _linear(spec, f"{p}.gammas_predictor", D, n_film)
    _linear(spec, f"{p}.betas_predictor", D, n_film)
    s = "speaker_classifier.classifier"
    _linear(spec, f"{s}.1", D, D, math.sqrt(2.0))
    _linear(spec, f"{s}.3", D, D, math.sqrt(2.0))
    _linear(spec, f"{s}.5", D, S - 1)
    spec.append(("phoneme_encoder.symbols_embedding.weight",
                 (cfg["n_symbols"], E), _xavier(cfg["n_symbols"], E)))
    for b in range(ph["nb_blocks"]):
        _fft_block(spec, f"phoneme_encoder.blocks.{b}", E,
                   ph["conv_channels"], ph["conv_kernel"])
    P, kp = pp["conv_channels"], pp["conv_kernel"]
    for b in range(pp["nb_blocks"]):
        q = f"prosody_predictor.blocks.{b}"
        _conv(spec, f"{q}.0", E if b == 0 else P, P, kp, math.sqrt(2.0))
        _ln(spec, f"{q}.2", P)
        _conv(spec, f"{q}.4", P, P, kp, math.sqrt(2.0))
        _ln(spec, f"{q}.6", P)
    _linear(spec, "prosody_predictor.projection", P, 3)
    kg = cfg["gaussian_upsampling_module"]["conv_kernel"]
    for name in ("duration", "energy", "pitch"):
        _conv(spec, f"gaussian_upsampling.{name}_projection", 1, E, kg)
    _linear(spec, "gaussian_upsampling.projection.0", E, 1, math.sqrt(2.0))
    for b in range(fd["nb_blocks"]):
        _fft_block(spec, f"frame_decoder.blocks.{b}", E,
                   fd["conv_channels"], fd["conv_kernel"])
    _linear(spec, "frame_decoder.projection", E, n_mels)
    return spec


def film_layout(cfg):
    """[(blocks, channels)] of the FiLM rows: phoneme encoder, prosody
    predictor, frame decoder."""
    E = cfg["phoneme_encoder"]["hidden_embed_dim"]
    return [(cfg["phoneme_encoder"]["nb_blocks"], E),
            (cfg["local_prosody_predictor"]["nb_blocks"],
             cfg["local_prosody_predictor"]["conv_channels"]),
            (cfg["frame_decoder"]["nb_blocks"], E)]


def positional_table(dim: int, n: int, device) -> torch.Tensor:
    """Sinusoidal positions (Vaswani et al.): sin on even, cos on odd
    channels, made in float64."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64)
                 * (-np.log(10000.0) / dim))
    table = np.zeros((n, dim))
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(table.astype(np.float32)).to(device)


# ----------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------
def mask(lengths, n):
    return torch.arange(n, device=lengths.device)[None, :] < \
        lengths.long()[:, None]


def layer_norm(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def linear(nx: Numerics, x, P, name):
    return nx.mm(x, P[f"{name}.linear_layer.weight"].t()) \
        + P[f"{name}.linear_layer.bias"]


def conv(nx: Numerics, x, P, name):
    """SAME zero-padded conv of (B, T, Cin) -> (B, T, Cout)."""
    w = P[f"{name}.conv.weight"]
    y = nx.conv1d(x.transpose(1, 2), w, padding=(w.shape[-1] - 1) // 2)
    return y.transpose(1, 2) + P[f"{name}.conv.bias"]


def dropout(x, rate, drop):
    """Inverted dropout from the generator's uniform draws (None: off)."""
    if drop is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = drop.uniform(x.shape)
    return torch.where(u.to(x.device) < keep, x / keep, 0.0)


def attention(nx, x, P, name, heads, lengths, rate, drop):
    """Multi-head self-attention, residual and LayerNorm; in training the
    probabilities and the output projection dropped."""
    B, T, E = x.shape
    D = E // heads
    m = f"{name}.multi_head_attention"
    w, b = P[f"{m}.in_proj_weight"], P[f"{m}.in_proj_bias"]
    q, k, v = (nx.mm(x, w[i * E:(i + 1) * E].t()) + b[i * E:(i + 1) * E]
               for i in range(3))
    seeds = drop.seeds(B) if drop is not None else None
    valid = mask(lengths, T)
    outs = []
    for h in range(heads):
        sl = slice(h * D, (h + 1) * D)
        logits = nx.mm(q[..., sl], k[..., sl].transpose(1, 2)) \
            * (1.0 / math.sqrt(D))
        logits = logits.masked_fill(~valid[:, None, :], NEG)
        p = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
        p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
        if seeds is not None and rate > 0.0:
            keep = hashdrop.attention_keep(seeds.to(x.device), h, T, rate)
            p = torch.where(keep, p / (1.0 - rate), 0.0)
        outs.append(nx.mm(p, v[..., sl]))
    ctx = torch.cat(outs, -1)
    out = nx.mm(ctx, P[f"{m}.out_proj.weight"].t()) + P[f"{m}.out_proj.bias"]
    out = dropout(out, rate, drop)
    return layer_norm(out + x, P[f"{name}.layer_norm.weight"],
                      P[f"{name}.layer_norm.bias"])


def conv_ff(nx, x, P, name, film, rate, drop):
    """conv -> ReLU -> conv (dropped in training) + residual -> LayerNorm
    -> FiLM."""
    seeds = drop.seeds(x.shape[0]) if drop is not None else None
    h = torch.relu(conv(nx, x, P, f"{name}.convs.0"))
    y = conv(nx, h, P, f"{name}.convs.2")
    if seeds is not None and rate > 0.0:
        keep = hashdrop.conv_ff_keep(seeds.to(x.device), x.shape[1],
                                     x.shape[2], rate)
        y = torch.where(keep, y / (1.0 - rate), 0.0)
    y = layer_norm(y + x, P[f"{name}.layer_norm.weight"],
                   P[f"{name}.layer_norm.bias"])
    if film is not None:
        E = y.shape[-1]
        y = film[:, None, :E] * y + film[:, None, E:]
    return y


def fft_block(nx, x, P, name, heads, film, lengths, cfg, drop):
    valid = mask(lengths, x.shape[1])[..., None]
    a = attention(nx, x, P, f"{name}.attention", heads, lengths,
                  cfg["attn_dropout"], drop)
    a = torch.where(valid, a, 0.0)
    y = conv_ff(nx, a, P, f"{name}.feed_forward", film,
                cfg["conv_dropout"], drop)
    return torch.where(valid, y, 0.0)


# ----------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------
def prosody_encoder(nx, P, cfg, energy, pitch, mels, lengths, speakers,
                    drop=None):
    """:return: (pooled embedding, [encoder, predictor, decoder] FiLM
    rows (B, blocks, 2C))."""
    pe = cfg["prosody_encoder"]
    p = "prosody_encoder"
    T = mels.shape[-1]
    e = conv(nx, energy[..., None], P, f"{p}.energy_embedding")
    f0 = conv(nx, pitch[..., None], P, f"{p}.pitch_embedding")
    x = mels.transpose(1, 2)
    for i in range(3):
        x = torch.relu(conv(nx, x, P, f"{p}.convs.{4 * i}"))
        x = layer_norm(x, P[f"{p}.convs.{4 * i + 2}.weight"],
                       P[f"{p}.convs.{4 * i + 2}.bias"])
        x = dropout(x, pe["conv_dropout"], drop)
    valid = mask(lengths, T)[..., None]
    pos = positional_table(x.shape[-1], T, x.device)
    x = torch.where(valid, x + e + f0 + pos, 0.0)
    for b in range(pe["nb_blocks"]):
        x = fft_block(nx, x, P, f"{p}.blocks.{b}", pe["attn_nb_heads"],
                      None, lengths, pe, drop)
    pooled = x.sum(1) / lengths.float()[:, None]
    h = pooled + P[f"{p}.spk_embedding.weight"][speakers.long()]
    gammas = linear(nx, h, P, f"{p}.gammas_predictor")
    betas = linear(nx, h, P, f"{p}.betas_predictor")
    post = P[f"{p}.post_multipliers"]
    films, col, blk = [], 0, 0
    for nb, ch in film_layout(cfg):
        n = nb * ch
        g = gammas[:, col:col + n].reshape(-1, nb, ch)
        bt = betas[:, col:col + n].reshape(-1, nb, ch)
        g = post[0, blk:blk + nb][None, :, None] * g
        bt = post[1, blk:blk + nb][None, :, None] * bt
        films.append(torch.cat([g + 1.0, bt], dim=2))
        col, blk = col + n, blk + nb
    return pooled, films


def speaker_classifier(nx, P, x):
    s = "speaker_classifier.classifier"
    x = _Reverse.apply(x)
    x = torch.relu(linear(nx, x, P, f"{s}.1"))
    x = torch.relu(linear(nx, x, P, f"{s}.3"))
    return linear(nx, x, P, f"{s}.5")


class _Reverse(torch.autograd.Function):
    """Gradient reversal, lambda 1."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def phoneme_encoder(nx, P, cfg, symbols, film, lengths, drop=None):
    ph = cfg["phoneme_encoder"]
    L = symbols.shape[1]
    x = P["phoneme_encoder.symbols_embedding.weight"][symbols.long()]
    x = x + positional_table(x.shape[-1], L, x.device)
    x = torch.where(mask(lengths, L)[..., None], x, 0.0)
    for b in range(ph["nb_blocks"]):
        x = fft_block(nx, x, P, f"phoneme_encoder.blocks.{b}",
                      ph["attn_nb_heads"], film[:, b], lengths, ph, drop)
    return x


def prosody_predictor(nx, P, cfg, x, film, lengths, drop=None):
    pp = cfg["local_prosody_predictor"]
    for b in range(pp["nb_blocks"]):
        q = f"prosody_predictor.blocks.{b}"
        for c, n in (("0", "2"), ("4", "6")):
            x = layer_norm(torch.relu(conv(nx, x, P, f"{q}.{c}")),
                           P[f"{q}.{n}.weight"], P[f"{q}.{n}.bias"])
            x = dropout(x, pp["conv_dropout"], drop)
        ch = x.shape[-1]
        x = film[:, b, None, :ch] * x + film[:, b, None, ch:]
    valid = mask(lengths, x.shape[1])[..., None]
    x = torch.where(valid, x, 0.0)
    preds = linear(nx, x, P, "prosody_predictor.projection")
    preds = torch.where(valid, preds, 0.0)
    return preds[..., 0], preds[..., 1], preds[..., 2]


class _Normalize(torch.autograd.Function):
    """p / (sum over symbols + 1e-20), with the backward written out so
    that frames where every Gaussian underflows get no NaN."""

    @staticmethod
    def forward(ctx, p):
        s = p.sum(dim=1, keepdim=True) + 1e-20
        y = p / s
        ctx.save_for_backward(y, s)
        return y

    @staticmethod
    def backward(ctx, g):
        y, s = ctx.saved_tensors
        return (g - (g * y).sum(dim=1, keepdim=True)) / s


def gaussian_upsampling(nx, P, x, dur_float, dur_int, energy, pitch,
                        lengths, frames):
    """Symbol i spreads over frames by a Gaussian centred on its interval's
    middle, with a predicted width, normalized over the symbols."""
    g = "gaussian_upsampling"
    d = conv(nx, dur_float[..., None], P, f"{g}.duration_projection")
    x = x + conv(nx, energy[..., None], P, f"{g}.energy_projection") \
        + conv(nx, pitch[..., None], P, f"{g}.pitch_projection")
    ranges = F.softplus(linear(nx, x + d, P, f"{g}.projection.0"))[..., 0]
    valid = mask(lengths, x.shape[1])
    sig = torch.where(valid, ranges, 1.0).clamp_min(1e-6)
    dur = dur_int.float()
    means = torch.cumsum(dur, 1) - dur / 2.0
    t = torch.arange(frames, device=x.device, dtype=torch.float32) + 0.5
    z = (t[None, None, :] - means[..., None]) / sig[..., None]
    probs = (_INV_SQRT_2PI / sig[..., None]) * torch.exp(-0.5 * z * z)
    probs = torch.where(valid[..., None], probs, 0.0)
    w = _Normalize.apply(probs)
    return nx.mm(w.transpose(1, 2), x)


def frame_decoder(nx, P, cfg, x, film, lengths, drop=None):
    fd = cfg["frame_decoder"]
    T = x.shape[1]
    valid = mask(lengths, T)[..., None]
    x = torch.where(valid, x + positional_table(x.shape[-1], T, x.device),
                    0.0)
    for b in range(fd["nb_blocks"]):
        x = fft_block(nx, x, P, f"frame_decoder.blocks.{b}",
                      fd["attn_nb_heads"], film[:, b], lengths, fd, drop)
    mel = torch.where(valid, linear(nx, x, P, "frame_decoder.projection"),
                      0.0)
    return mel.transpose(1, 2)


# ----------------------------------------------------------------------
# Durations (the reference repo's framing of each phone's interval)
# ----------------------------------------------------------------------
def durations_to_frames(seconds, sr: int, filter_length: int, hop: int):
    """(B, L) float seconds -> (B, L) int frame counts: the frames whose
    centre sample falls in a phone's interval (centred STFT), the edge
    frames given to the first and last phone, zero-length phones none.
    Interval ends are float32 running sums in index order."""
    s = seconds.float()
    cum = torch.zeros_like(s)
    acc = torch.zeros_like(s[:, 0])
    for i in range(s.shape[1]):
        acc = acc + s[:, i]
        cum[:, i] = acc
    begin = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
    b_s = torch.floor(begin * sr).long()
    e_s = torch.floor(cum * sr).long()
    c = filter_length // 2
    diff = e_s[:, -1:] - filter_length
    n_frames = (1 + torch.sign(diff) * (diff.abs() // hop)).clamp_min(0)
    kmin = ((b_s - c) // hop + 1).clamp_min(0)
    kmax = torch.minimum((e_s - c) // hop, n_frames - 1)
    nz = s > 0.0
    counts = torch.where(nz, (kmax - kmin + 1).clamp_min(0), 0)
    edge = c // hop
    L = s.shape[1]
    idx = torch.arange(L, device=s.device)[None, :]
    first = torch.argmax(nz.long(), 1)[:, None]
    last = (L - 1 - torch.argmax(nz.flip(1).long(), 1))[:, None]
    add = edge * ((idx == first).long() + (idx == last).long())
    return counts + torch.where(nz.any(1, keepdim=True), add, 0)


# ----------------------------------------------------------------------
# Inference
# ----------------------------------------------------------------------
def films(nx, P, cfg, energy, pitch, mels, lengths, speakers):
    return prosody_encoder(nx, P, cfg, energy, pitch, mels, lengths,
                           speakers)[1]


def synthesize(nx, P, cfg, audio, symbols, input_lengths, film_rows,
               pitch_means, pitch_stds, speakers, max_frames):
    """Text to mel with the "add" pitch transform at factor 0 and unit
    duration and energy factors.

    :param audio: the configuration's ``audio`` group
    :return: (mel (B, n_mels, max_frames), output lengths (B,))
    """
    enc_film, pred_film, dec_film = film_rows
    x = phoneme_encoder(nx, P, cfg, symbols, enc_film, input_lengths)
    dur, energy, pitch = prosody_predictor(nx, P, cfg, x, pred_film,
                                           input_lengths)
    sr, fl, hop = (audio["sampling_rate"], audio["filter_length"],
                   audio["hop_length"])
    dur = torch.where(dur < (fl / sr) / 2.0, 0.0, dur)
    dur_int = durations_to_frames(dur, sr, fl, hop)
    silent = dur_int == 0
    energy = torch.where(silent, 0.0, energy)
    pitch = torch.where(silent, 0.0, pitch)
    mean = pitch_means[speakers.long()][:, None]
    std = pitch_stds[speakers.long()][:, None]
    hz = torch.exp(std * pitch + mean)
    shifted = (torch.log(hz.clamp_min(1e-8)) - mean) / std
    pitch = torch.where(pitch == 0.0, 0.0, shifted)
    total = dur_int.sum(1)
    out_lengths = total.clamp_max(max_frames)
    frames = gaussian_upsampling(nx, P, x, dur, dur_int, energy, pitch,
                                 input_lengths, max_frames)
    mel = frame_decoder(nx, P, cfg, frames, dec_film, out_lengths)
    return mel, out_lengths


# ----------------------------------------------------------------------
# Training
# ----------------------------------------------------------------------
INPUT_KEYS = ("symbols", "durations_float", "durations_int",
              "symbols_energy", "symbols_pitch", "input_lengths",
              "frames_energy", "frames_pitch", "mel_specs", "output_lengths",
              "speaker_ids")
LOSS_KEYS = ("speaker_loss", "post_mult_loss", "duration_loss",
             "energy_loss", "pitch_loss", "mel_spec_l1_loss",
             "mel_spec_l2_loss")


def train_loss(nx, P, cfg, weights, batch, iteration, drop):
    """The training loss of one micro-batch (teacher-forced durations,
    energy and pitch), and its terms.

    :param weights: the configuration's ``loss`` group
    :param batch: tensors keyed by :data:`INPUT_KEYS`
    """
    b = batch
    pooled, (enc_f, pred_f, dec_f) = prosody_encoder(
        nx, P, cfg, b["frames_energy"], b["frames_pitch"], b["mel_specs"],
        b["output_lengths"], b["speaker_ids"], drop)
    spk = speaker_classifier(nx, P, pooled)
    x = phoneme_encoder(nx, P, cfg, b["symbols"], enc_f, b["input_lengths"],
                        drop)
    dur, energy, pitch = prosody_predictor(nx, P, cfg, x, pred_f,
                                           b["input_lengths"], drop)
    frames = gaussian_upsampling(
        nx, P, x, b["durations_float"], b["durations_int"],
        b["symbols_energy"], b["symbols_pitch"], b["input_lengths"],
        b["mel_specs"].shape[-1])
    mel = frame_decoder(nx, P, cfg, frames, dec_f, b["output_lengths"], drop)

    inv_in = 1.0 / b["input_lengths"].float()
    logits = spk
    m = logits.amax(-1)
    log_z = torch.log(torch.exp(logits - m[:, None]).sum(-1)) + m
    ce = (log_z - logits.gather(-1, b["speaker_ids"].long()[:, None])[:, 0]
          ).mean()
    post = P["prosody_encoder.post_multipliers"]

    def seq_mse(pred, tgt):
        return ((pred - tgt).square().sum(1) * inv_in).mean()

    diff = mel - b["mel_specs"]
    inv_out = 1.0 / (mel.shape[1] * b["output_lengths"].float())
    warm = weights["warmup_steps"]
    adv = min(weights["adv_max_weight"],
              iteration * warm ** -1.5 * weights["adv_max_weight"]
              / warm ** -0.5)
    terms = {
        "speaker_loss": adv * ce,
        "post_mult_loss": weights["post_mult_weight"]
        * torch.sqrt(post.square().sum()),
        "duration_loss": weights["dur_weight"]
        * seq_mse(dur, b["durations_float"]),
        "energy_loss": weights["energy_weight"]
        * seq_mse(energy, b["symbols_energy"]),
        "pitch_loss": weights["pitch_weight"]
        * seq_mse(pitch, b["symbols_pitch"]),
        "mel_spec_l1_loss": weights["mel_spec_weight"]
        * (diff.abs().sum((1, 2)) * inv_out).mean(),
        "mel_spec_l2_loss": weights["mel_spec_weight"]
        * (diff.square().sum((1, 2)) * inv_out).mean(),
    }
    return sum(terms.values()), terms
