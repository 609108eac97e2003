"""Small pieces every driver uses: the card's description, quantiles,
the comparison's verdict lines."""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or
    "unknown" where it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (linear between order statistics, numpy's
    default), with missing answers (None) counted as infinitely late."""
    vals = [float("inf") if v is None else float(v) for v in values]
    if not vals:
        return float("nan")
    return float(np.percentile(np.asarray(vals), q))


def rel_l2(got, want) -> float:
    """||got - want|| / ||want||, float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / max(den, 1e-30)


def rel_l2_centered(got, want) -> float:
    """||got - want|| over the norm of ``want``'s deviation from its own
    mean: a waveform's offset counts as no signal."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = float(np.linalg.norm(want - want.mean()))
    return float(np.linalg.norm(got - want)) / max(den, 1e-30)


class Checks:
    """The numbers a run compares, each beside its limit."""

    def __init__(self):
        self.rows = []

    def add(self, name: str, value: float, limit: float):
        self.rows.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.rows) and all(v <= lim for _, v, lim in self.rows)

    def as_dict(self) -> dict:
        return {name: {"value": v, "limit": lim} for name, v, lim in
                self.rows}

    def lines(self):
        return [f"check {name}: {v!r} (limit {lim!r}) "
                f"{'ok' if v <= lim else 'FAILED'}"
                for name, v, lim in self.rows]


def device_info(chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(chips)))}
