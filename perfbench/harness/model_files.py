"""What a Daft-Exprt configuration gives the program: hyper-parameters,
weights drawn from the seed, and the files its entry points read (a
checkpoint, a style bank, a vocoder), written under ``TMPDIR``."""

from __future__ import annotations

import json

import numpy as np
import torch

from harness import seeding
from reference import daftexprt, hifigan

# the configuration keys that are hyper-parameters of the program
HPARAM_KEYS = ("prosody_encoder", "phoneme_encoder",
               "local_prosody_predictor", "gaussian_upsampling_module",
               "frame_decoder", "compute_dtype", "batch_size",
               "accumulation_steps", "symbol_bucket", "frame_bucket",
               "max_symbols", "max_frames", "sampling_rate",
               "filter_length", "hop_length", "n_mel_channels", "language",
               "speakers", "warmup_steps", "adv_max_weight",
               "post_mult_weight", "dur_weight", "energy_weight",
               "pitch_weight", "mel_spec_weight", "lambda_reversal",
               "initial_learning_rate", "max_learning_rate", "betas",
               "epsilon", "weight_decay", "grad_clip_thresh", "seed")


def stats(cfg) -> dict:
    """stats.json as the program reads it: per-symbol duration statistics
    (the speculative output bucket) and per-speaker pitch statistics (the
    pitch transform), from the configuration's ``assumed`` group."""
    a = cfg["assumed"]
    out = {"symbols": {s: {"dur_mean": a["duration_s_per_phone"],
                           "dur_std": a["duration_std_s"]}
                       for s in cfg["symbols"]}}
    for i, (mean, std) in enumerate(a["pitch_log_hz"]):
        out[f"spk {i}"] = {"pitch": {"mean": mean, "std": std},
                           "energy": {"mean": 0.0, "std": 1.0}}
    return out


def hparams(cfg, output_directory: str):
    from daft_exprt_tpu_torch.config import HyperParams

    kw = {k: cfg[k] for k in HPARAM_KEYS if k in cfg}
    hp = HyperParams(verbose=False, training_files="unused",
                     validation_files="unused",
                     output_directory=output_directory, stats=stats(cfg),
                     **kw)
    if list(hp.symbols) != list(cfg["symbols"]) \
            or hp.n_speakers != cfg["n_speakers"]:
        raise ValueError("the program's symbols or speakers differ from the "
                         "configuration's")
    return hp


def pitch_stats(cfg, device):
    """(means, stds) of log-F0 by speaker id, as the pitch transform reads
    them (mean 0 and std 1 for the padding speaker)."""
    means = torch.zeros(cfg["n_speakers"], device=device)
    stds = torch.ones(cfg["n_speakers"], device=device)
    for i, (m, s) in enumerate(cfg["assumed"]["pitch_log_hz"]):
        means[i], stds[i] = m, max(s, 1e-6)
    return means, stds


def bucket(n: int, step: int, cap: int) -> int:
    """``n`` rounded up to a multiple of ``step``, at most ``cap``: the
    padded length of a collated batch."""
    return min(-(-n // step) * step, cap)


def acoustic_weights(cfg, seed: int, device) -> dict:
    """The acoustic model's parameters from ``seed`` on ``device``, with
    the duration head pinned to the assumed seconds a phone (random
    weights predict empty outputs)."""
    P = seeding.make_weights(daftexprt.param_spec(cfg), seed, "acoustic",
                             device)
    P["prosody_predictor.projection.linear_layer.weight"][0].zero_()
    P["prosody_predictor.projection.linear_layer.bias"][0].fill_(
        cfg["assumed"]["duration_s_per_phone"])
    return P


def vocoder_weights(cfg, seed: int, device) -> dict:
    return seeding.make_weights(hifigan.param_spec(cfg["vocoder"]), seed,
                                "vocoder", device)


def write_checkpoint(path, P, hp):
    """A reference ``.pt`` (``{"state_dict", "config_params"}``)."""
    torch.save({"iteration": 0, "learning_rate": 0.0,
                "best_val_loss": float("inf"),
                "state_dict": {k: v.detach().cpu() for k, v in P.items()},
                "optimizer": None,
                "config_params": {k: v for k, v in hp.as_dict().items()
                                  if v is not None}}, path)


def write_vocoder(folder, V, cfg):
    """A torch HiFi-GAN ``g_*`` file and its config: (g path, config
    path)."""
    g, c = folder / "g_bench", folder / "hifigan.json"
    torch.save({"generator": {k: v.detach().cpu() for k, v in V.items()}}, g)
    c.write_text(json.dumps(cfg["vocoder"]))
    return str(g), str(c)


def style_bank(cfg, seed: int, size: int, lengths):
    """``size`` references {energy, pitch, mel_spec}: frame counts from
    ``lengths`` (the corpus model's), contents from ``seed``."""
    rng = seeding.rng(seed, "style_bank")
    n_mels = cfg["n_mel_channels"]
    bank = []
    for t in lengths[:size]:
        bank.append({
            "energy": (np.abs(rng.standard_normal(t)) + 1.0).astype(
                np.float32),
            "pitch": rng.standard_normal(t).astype(np.float32),
            "mel_spec": rng.standard_normal((n_mels, t)).astype(np.float32)})
    return bank


def write_bank(folder, bank):
    folder.mkdir(parents=True, exist_ok=True)
    names = []
    for i, ref in enumerate(bank):
        name = f"ref_{i:02d}"
        np.savez(folder / f"{name}.npz", **ref)
        names.append(name)
    return names


def random_sentence(rng, n: int, symbols):
    """A pre-phonemized sentence of ``n`` symbols: words of 1-6 stressed
    ARPAbet phones between boundaries, a final "." and the EOS "~".
    :return: (text as ``{...}`` groups, symbol ids)"""
    phones = [s for s in symbols[7:]]
    n = max(n, 3)
    words, count = [], 0
    budget = n - 2  # "." and "~"
    while count < budget:
        room = budget - count - (1 if words else 0)
        if room <= 0:
            break
        k = int(min(room, rng.integers(1, 7)))
        words.append([phones[i] for i in rng.integers(0, len(phones), k)])
        count += k + (1 if len(words) > 1 else 0)
    text = " ".join("{" + " ".join(w) + "}" for w in words) + " . ~"
    table = {s: i for i, s in enumerate(symbols)}
    ids = []
    for j, w in enumerate(words):
        if j:
            ids.append(table[" "])
        ids.extend(table[p] for p in w)
    ids += [table["."], table["~"]]
    return text, np.asarray(ids, np.int32)
