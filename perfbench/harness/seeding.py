"""Seeds and weights drawn from a run's ``--seed``.

Every stream of a run (weights, style bank, traffic order, features,
dropout) has a seed of its own, derived from (``--seed``, stream name) by
``numpy.random.SeedSequence``, so any whole number is a valid seed and no
stream shifts another.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed of ``stream`` under the run's ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             zlib.crc32(stream.encode())]
    return int(np.random.SeedSequence(words).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream))


def make_weights(spec, seed: int, stream: str, device,
                 dtype=torch.float32) -> dict:
    """Parameters of ``spec`` ([(name, shape, init)]) on ``device``, drawn
    in one uniform call of a ``torch.Generator`` on that device and cut to
    shape: a uniform in [-init, init], or ones, or zeros."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, stream))
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    flat = torch.rand(sum(sizes), generator=gen, device=device,
                      dtype=dtype) * 2.0 - 1.0
    out = {}
    for (name, shape, init), part in zip(spec, flat.split(sizes)):
        if init == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        else:
            out[name] = (part * float(init)).reshape(shape)
    return out
