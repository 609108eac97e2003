"""The corpus model: utterance lengths of an LJSpeech + ESD-like corpus.

Copied from the JAX repo's ``tools/padding_report.py`` corpus model (as
``chip_smoke.py`` ``corpus_lengths`` holds it): LJSpeech clips ~N(6.5 s,
2.2 s) in [1.1, 10.1] s, ESD ~N(2.9 s, 1.0 s) in [1.0, 7.0] s, 13.1k +
3.5k utterances, ~12.5 phones a second jittered (N(12.5, 1.5) clipped to
[8, 18]). The corpus is one fixed draw (``seed`` 0): every run sees the
same utterances, in the order its own seed gives them.
"""

from __future__ import annotations

import numpy as np

FPS = 22050.0 / 256.0  # mel frames a second
N_UTTERANCES = 16600


def corpus_lengths(n=N_UTTERANCES, seed=0):
    """[(n_symbols, n_frames)] of ``n`` utterances."""
    rng = np.random.default_rng(seed)

    def trunc_normal(mean, std, lo, hi, k):
        out = np.empty(k)
        filled = 0
        while filled < k:
            draw = rng.normal(mean, std, size=k - filled)
            draw = draw[(draw >= lo) & (draw <= hi)]
            out[filled:filled + len(draw)] = draw
            filled += len(draw)
        return out

    lengths = []
    n_lj = int(n * 13100 / (13100 + 3500))
    for k, args in ((n_lj, (6.5, 2.2, 1.1, 10.1)),
                    (n - n_lj, (2.9, 1.0, 1.0, 7.0))):
        secs = trunc_normal(*args, k)
        frames = np.maximum((secs * FPS).astype(int), 8)
        rate = rng.normal(12.5, 1.5, size=k).clip(8.0, 18.0)
        symbols = np.maximum((secs * rate).astype(int), 2)
        lengths += list(zip(symbols.tolist(), frames.tolist()))
    return lengths


def split_frames(rng, n_symbols: int, n_frames: int) -> np.ndarray:
    """Integer frames a symbol (each at least 1 where there are enough
    frames), summing to ``n_frames``: a uniform random composition."""
    if n_frames < n_symbols:
        out = np.zeros(n_symbols, np.int32)
        out[rng.choice(n_symbols, n_frames, replace=False)] = 1
        return out
    cuts = np.sort(rng.choice(np.arange(1, n_frames), n_symbols - 1,
                              replace=False))
    return np.diff(np.concatenate([[0], cuts, [n_frames]])).astype(np.int32)
