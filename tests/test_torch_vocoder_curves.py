"""The port's HiFi-GAN trainer against the JAX package's over a whole
learning curve, on the CPU (slow tier: not in ``_FAST_MODULES``).

``chip_smoke.py``'s vocoder learning gate (the mean mel L1 of steps
181-200 more than 15% under the mean of steps 20-39, full V1 + MPD/MSD at
16 x 8192) fails on some card runs without deterministic algorithms.
This test asks whether the port's trainer itself leaves the JAX
trainer's curve: both take ``STEPS`` steps from the same seed-0 weights
(the JAX ``init_params`` carried across by ``daft_exprt_tpu_torch.
convert``) on the same batches, at the JAX tests' tiny widths
(tests/test_vocoder_train.py: a 16-channel generator, MPD channels (4, 8,
8, 8), three MSD layers, hop 8 at 800 Hz) and batch 4 x 256 samples, a
new batch every step (harmonic tones of random pitch, numpy seed 0). At
200 steps the gate's own windows apply unscaled.

The GAN amplifies a rounding: JAX itself, from its weights scaled by
``1 + eps`` for eps of one and two float32 roundings of either sign
(``CONTROL_EPS``), leaves its own unscaled curve past the 20-step parity
test's per-step bound (``STEP_REL_TOL``, rel 1e-4) after about 50 steps.
These controls give JAX's own spread, and the port is held to it:

- the port's first step past the bound is no earlier than the earliest
  control's (it tracks JAX at least as long as a rounding of JAX does);
- each loss's largest step error is within the largest of the controls';
- the gate's relative drop is within the farthest control's distance from
  JAX's.

The test prints, for the port and each control, the first step past the
bound, the largest step error and the gate's drop.

Run: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_vocoder_curves.py
-m slow -q -s`` (prints both curves' gate drops and the largest step
error).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_vocoder_train import (STEP_REL_TOL, _jax_state,
                                      _port_modules, _torch_batch)
from test_vocoder_train import MEL_CFG

from daft_exprt_tpu.vocoder import train as jtrain
from daft_exprt_tpu.vocoder.train import mel_for_loss
from daft_exprt_tpu_torch.vocoder import train

STEPS = 200
BASELINE, WINDOW = 20, 20  # chip_smoke's SOAK_VOC_BASELINE, _WINDOW
BATCH, SEGMENT, SR = 4, 256, 800
CONTROL_EPS = (2.0 ** -23, -2.0 ** -23, 2.0 ** -22, -2.0 ** -22)
KEYS = ("loss_d", "loss_g", "mel_l1")


def _batches(n, seed=0):
    """``n`` batches of harmonic tones (random f0, amplitude and phase),
    their mels from the JAX ``mel_for_loss`` as the JAX tests make
    them."""
    rng = np.random.default_rng(seed)
    t = np.arange(SEGMENT, dtype=np.float64) / SR
    out = []
    for _ in range(n):
        f0 = rng.uniform(20.0, 90.0, (BATCH, 1, 1))
        amp = rng.uniform(0.05, 0.4, (BATCH, 1, 1))
        phase = rng.uniform(0, 2 * np.pi, (BATCH, 3, 1))
        k = np.arange(1, 4)[None, :, None]
        audio = (amp * np.sum(np.sin(2 * np.pi * k * f0 * t + phase)
                              / k, axis=1, keepdims=True))[:, 0]
        audio = audio.astype(np.float32)
        mel = np.asarray(mel_for_loss(jnp.asarray(audio),
                                      **dict(MEL_CFG, fmax=400.0)))
        out.append({"mel": mel, "audio": audio})
    return out


def _gate_drop(curve):
    """The gate's relative drop of mean mel L1, windows scaled to the
    curve: steps BASELINE..BASELINE+WINDOW-1 against the last WINDOW."""
    base = np.mean(curve[BASELINE:BASELINE + WINDOW])
    return 1.0 - np.mean(curve[-WINDOW:]) / base


def _jax_curves(jstep, state, batches):
    curves = {k: [] for k in KEYS}
    for batch in batches:
        *state, want = jstep(*state, batch)
        for k in KEYS:
            curves[k].append(float(want[k]))
    return curves


def _summary(curves, ref):
    """First step (1-based) past the bound, largest step error and its
    step, by loss; the gate's drop."""
    out = {}
    for k in KEYS:
        e = np.abs(np.subtract(curves[k], ref[k])) / np.abs(ref[k])
        over = np.flatnonzero(e > STEP_REL_TOL)
        out[k] = {"first_past_bound": int(over[0]) + 1 if len(over) else None,
                  "max_rel_err": float(e.max()),
                  "at_step": int(e.argmax()) + 1}
    out["gate_drop"] = float(_gate_drop(np.asarray(curves["mel_l1"])))
    return out


def test_port_and_jax_trainers_share_a_learning_curve():
    torch.set_num_threads(1)
    jgen, jmpd, jmsd, (g_wn, d_params, msd_state) = _jax_state()
    tx_g, tx_d = jtrain.make_optimizers(2e-4, 0.999, 10)
    jstep = jtrain.make_vocoder_train_step(jgen, jmpd, jmsd, MEL_CFG, tx_g,
                                           tx_d, donate=False)
    batches = _batches(STEPS)
    ref = _jax_curves(jstep, (g_wn, d_params, msd_state, tx_g.init(g_wn),
                              tx_d.init(d_params)), batches)
    controls = []
    for eps in CONTROL_EPS:
        scaled = jax.tree.map(lambda a: a * np.float32(1 + eps),
                              (g_wn, d_params))
        controls.append(_jax_curves(jstep, (*scaled, msd_state,
                                            tx_g.init(scaled[0]),
                                            tx_d.init(scaled[1])), batches))
    gen, mpd, msd = _port_modules(g_wn, d_params, msd_state)
    opt_g, opt_d = train.make_optimizers(gen, mpd, msd, 2e-4, 0.999, 10)
    step = train.make_vocoder_train_step(gen, mpd, msd, MEL_CFG, opt_g,
                                         opt_d)
    port = {k: [] for k in KEYS}
    for batch in batches:
        got = step(_torch_batch(batch))
        for k in KEYS:
            port[k].append(float(got[k]))
    jax_drop = float(_gate_drop(np.asarray(ref["mel_l1"])))
    report = {"jax_gate_drop": jax_drop, "port": _summary(port, ref),
              "controls": [_summary(c, ref) for c in controls]}
    print("\nvocoder curves", report)

    def first_past(summary):
        steps = [summary[k]["first_past_bound"] for k in KEYS]
        return min([n for n in steps if n is not None], default=STEPS + 1)

    assert first_past(report["port"]) \
        >= min(first_past(c) for c in report["controls"]), report
    for k in KEYS:
        assert report["port"][k]["max_rel_err"] \
            <= max(c[k]["max_rel_err"] for c in report["controls"]), (k, report)
    assert abs(report["port"]["gate_drop"] - jax_drop) \
        <= max(abs(c["gate_drop"] - jax_drop) for c in report["controls"]), \
        report
