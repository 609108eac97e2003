"""Operations of a whole pass or step, from the configuration and the real
lengths: the dense products (matmuls, convs, attention scores and weighted
values) at 2 FLOPs a multiply-add. Elementwise work is not counted. The
share of the card's peak these give is a model FLOPs utilization: the
numerator counts what the model needs for the real rows, whatever the
program computes on padding."""

from __future__ import annotations


def fft_block(n: int, E: int, C: int, k: int) -> float:
    """One FFT block over a row of ``n`` positions: QKV and output
    projections, scores and weighted values, the two convs."""
    return 8.0 * n * E * E + 4.0 * n * n * E + 4.0 * n * k * E * C


def prosody_encoder(cfg, n: int) -> float:
    """The prosody encoder over a reference of ``n`` frames."""
    pe = cfg["prosody_encoder"]
    D, C, k = pe["hidden_embed_dim"], pe["conv_channels"], pe["conv_kernel"]
    M = cfg["n_mel_channels"]
    n_film = 2 * sum(b * c for b, c in _layout(cfg))
    return (2.0 * n * k * 2 * D
            + 2.0 * n * k * (M * C + C * C + C * D)
            + pe["nb_blocks"] * fft_block(n, D, C, k)
            + 2.0 * D * n_film)


def _layout(cfg):
    E = cfg["phoneme_encoder"]["hidden_embed_dim"]
    return [(cfg["phoneme_encoder"]["nb_blocks"], E),
            (cfg["local_prosody_predictor"]["nb_blocks"],
             cfg["local_prosody_predictor"]["conv_channels"]),
            (cfg["frame_decoder"]["nb_blocks"], E)]


def acoustic(cfg, L: int, T: int) -> float:
    """Phoneme encoder, prosody predictor, Gaussian upsampling and frame
    decoder over a row of ``L`` symbols and ``T`` output frames."""
    ph, pp = cfg["phoneme_encoder"], cfg["local_prosody_predictor"]
    fd = cfg["frame_decoder"]
    E = ph["hidden_embed_dim"]
    P, kp = pp["conv_channels"], pp["conv_kernel"]
    kg = cfg["gaussian_upsampling_module"]["conv_kernel"]
    pred = 0.0
    for b in range(pp["nb_blocks"]):
        pred += 2.0 * L * kp * ((E if b == 0 else P) * P + P * P)
    pred += 2.0 * L * P * 3
    ups = 3 * 2.0 * L * kg * E + 2.0 * L * E + 2.0 * T * L * E
    return (ph["nb_blocks"] * fft_block(L, E, ph["conv_channels"],
                                        ph["conv_kernel"])
            + pred + ups
            + fd["nb_blocks"] * fft_block(T, E, fd["conv_channels"],
                                          fd["conv_kernel"])
            + 2.0 * T * E * cfg["n_mel_channels"])


def speaker_classifier(cfg) -> float:
    D = cfg["prosody_encoder"]["hidden_embed_dim"]
    return 2.0 * (2 * D * D + D * (cfg["n_speakers"] - 1))


def vocoder(vcfg, T: int) -> float:
    """The HiFi-GAN generator over ``T`` mel frames."""
    ch0 = vcfg["upsample_initial_channel"]
    flops = 2.0 * T * 7 * vcfg["num_mels"] * ch0
    n = T
    per = 2 if str(vcfg.get("resblock", "1")) == "1" else 1
    taps = sum(per * k * len(d) for k, d in
               zip(vcfg["resblock_kernel_sizes"],
                   vcfg["resblock_dilation_sizes"]))
    c = ch0
    for u, k in zip(vcfg["upsample_rates"], vcfg["upsample_kernel_sizes"]):
        cout = c // 2
        flops += 2.0 * n * k * c * cout
        n *= u
        flops += 2.0 * n * cout * cout * taps
        c = cout
    return flops + 2.0 * n * 7 * c


def train_step(cfg, rows) -> float:
    """Forward and backward (3x the forward) over the rows of a step:
    ``rows`` is [(L, T)] of the real lengths."""
    fwd = sum(prosody_encoder(cfg, T) + acoustic(cfg, L, T)
              + speaker_classifier(cfg) for L, T in rows)
    return 3.0 * fwd
