"""Tiny configurations and traffic for running the harness on the CPU:
the cells' configurations with every width cut down, at their own depth
(a float8 control's error grows with it), which only tests use."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import corpus  # noqa: E402

_corpus_lengths = corpus.corpus_lengths
MAX_SYMBOLS = 29  # 30 with the end of sentence: the tiny buckets' longest


def capped_lengths(*args, **kwargs):
    """The corpus model's lengths with every sentence cut to
    ``MAX_SYMBOLS``: patched over ``corpus.corpus_lengths`` where a tiny
    model serves the mixes."""
    return [(min(n, MAX_SYMBOLS), t)
            for n, t in _corpus_lengths(*args, **kwargs)]


def load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def tiny_model(cfg: dict, max_frames: int = 512) -> dict:
    cfg = copy.deepcopy(cfg)
    for m, heads in (("prosody_encoder", 2), ("phoneme_encoder", 2),
                     ("frame_decoder", 2)):
        cfg[m].update(attn_nb_heads=heads, conv_channels=32)
        if m != "frame_decoder":
            cfg[m]["hidden_embed_dim"] = 16
    cfg["local_prosody_predictor"].update(conv_channels=16)
    cfg["compute_dtype"] = "float32"
    cfg["symbol_bucket"] = 64
    cfg["max_frames"] = max_frames
    cfg["batch_size"] = 4
    cfg["accumulation_steps"] = 2
    # 1/32 s a phone (2.7 frames): the corpus model's sentences fit 512
    cfg["assumed"]["duration_s_per_phone"] = 0.03125
    if "vocoder" in cfg:
        cfg["vocoder"]["upsample_initial_channel"] = 16
    return cfg


def serve_traffic() -> dict:
    tr = load("traffic", "serve_poisson")
    tr.update(rate_per_s=20.0, max_batch=2, check_requests=3,
              client_threads=4, trace_seconds=0.5)
    return tr


def train_traffic() -> dict:
    tr = load("traffic", "train_corpus")
    tr.update(utterances=400, min_step_s=1.0, trace_steps=1)
    return tr


def mel_traffic() -> dict:
    tr = load("traffic", "mel_bulk50")
    tr.update(batch=4, batches=3, checked_batches=2, reference_rows=2)
    return tr
