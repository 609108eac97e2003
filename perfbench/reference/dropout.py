"""Training dropout as the program draws it, for the reference to follow.

Two sources, in the order a forward pass meets them:

- ``Draws.uniform(shape)``: uniform [0, 1) draws from a
  ``torch.Generator`` on its own device (the prosody encoder's prenet
  after each LayerNorm, the output projection of every attention, the
  prosody predictor after each LayerNorm);
- ``Draws.seeds(B)``: one int32 seed per row from the same generator
  (every attention, then every conv feed-forward), which a counter hash
  (murmur3's fmix32) turns into the keep masks of the attention
  probabilities and of the feed-forward's second conv.

The hash and its salts are those of the JAX package's training kernels
(``ops/attention_train.py`` ``_hash_bits``, ``pick_q_tile``), written out
here again. A keep is bits >= round(rate * 2^32).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
LOGIT_TILE_BYTES = 2 * 1024 * 1024


class Draws:
    """The generator a training step's dropout draws from."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator

    def uniform(self, shape):
        return torch.rand(shape, generator=self.gen, device=self.gen.device)

    def seeds(self, batch: int):
        return torch.randint(-2 ** 31, 2 ** 31, (batch,), generator=self.gen,
                             device=self.gen.device, dtype=torch.int32)


def _threshold(rate: float) -> int:
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def _mul(a, c: int):
    """(a * c) mod 2^32 on int64 values in [0, 2^32)."""
    return ((a * (c & 0xFFFF)) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def fmix(seed, salt, rows, cols):
    h = ((seed & _M32) + _mul(salt & _M32, 0x9E3779B9)
         + _mul(rows & _M32, 0x85EBCA6B) + _mul(cols & _M32, 0xC2B2AE35)) \
        & _M32
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def q_tile(t: int) -> int:
    """Query rows a tile of the JAX training attention: the largest power
    of two up to 512 dividing ``t`` whose (tile, t) float32 logits fit in
    2 MiB."""
    budget = max(LOGIT_TILE_BYTES // (t * 4), 8)
    for tq in (512, 256, 128, 64, 32, 16, 8):
        if tq <= budget and t % tq == 0:
            return min(tq, t)
    return t


def attention_keep(seeds, head: int, T: int, rate: float):
    """(B, T, T) keep mask of head ``head``'s probabilities: salt ``head *
    (T / tile) + row // tile``, coordinates (row, col)."""
    tq = q_tile(T)
    rows = torch.arange(T, dtype=torch.int64, device=seeds.device)
    salt = (head * (T // tq) + rows // tq)[None, :, None]
    bits = fmix(seeds.long()[:, None, None], salt, rows[None, :, None],
                rows[None, None, :])
    return bits >= _threshold(rate)


def conv_ff_keep(seeds, T: int, E: int, rate: float):
    """(B, T, E) keep mask of the feed-forward's second conv: salt 0,
    coordinates (frame, channel)."""
    rows = torch.arange(T, dtype=torch.int64, device=seeds.device)[:, None]
    cols = torch.arange(E, dtype=torch.int64, device=seeds.device)[None, :]
    bits = fmix(seeds.long()[:, None, None], torch.zeros((), dtype=torch.int64,
                device=seeds.device), rows[None], cols[None])
    return bits >= _threshold(rate)
