"""The port's training step against the JAX package, on the CPU.

``tests/helpers.tiny_hparams`` with every dropout at 0 (the JAX docstring
of ``training/step.py`` says dropout-on parity cannot hold: the two
packages draw different bits), accumulation 2, float32. JAX
``init_params`` crosses with ``convert.state_dict_from_jax``; gradients
cross back through the same mapping. The port's FFT blocks take K2's and
K3's plain forward and backward here; the JAX package's training path on
the CPU is XLA autodiff, the same function.

A tiny wide-head configuration (E=256, 2 heads of 128, conv channels
256) takes the same checks through the C-blocked conv-FF (K4): there
``plan_conv_ff`` leaves K3 for K4, whose plain version runs here.

Gradients and the optimizer are held apart: at step 1 Adam moves each
parameter by about lr * sign(g), so a gradient of 1e-9 in one package and
-1e-9 in the other would move it by 2 lr.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from helpers import synthetic_batch, tiny_hparams

from daft_exprt_tpu.models.daft_exprt import DaftExprt as JaxDaftExprt
from daft_exprt_tpu.training import loss as jloss
from daft_exprt_tpu.training import step as jstep
from daft_exprt_tpu.training.schedule import make_lr_schedule as jax_schedule
from daft_exprt_tpu_torch.config import HyperParams
from daft_exprt_tpu_torch.convert import state_dict_from_jax
from daft_exprt_tpu_torch.models.daft_exprt import DaftExprt
from daft_exprt_tpu_torch.ops.conv_ff_train import conv_ff_train_blocked
from daft_exprt_tpu_torch.training.loss import compute_loss
from daft_exprt_tpu_torch.training.schedule import make_lr_schedule
from daft_exprt_tpu_torch.training.step import (INPUT_KEYS, Optimizer,
                                                batch_to_inputs,
                                                batch_to_targets,
                                                make_eval_step,
                                                make_train_step)

ACCUM, MICRO_B, ITERATION = 2, 4, 5000
# float32 in both, different libraries and summation orders through ~40
# layers forward and back
OUT_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 2e-5


def _no_drop(cfg):
    keys = ("attn_dropout", "conv_dropout")
    return {**cfg, **{k: 0.0 for k in keys if k in cfg}}


def _hparams(**overrides):
    base = tiny_hparams()
    modules = {m: _no_drop(getattr(base, m)) for m in (
        "prosody_encoder", "phoneme_encoder", "local_prosody_predictor",
        "frame_decoder")}
    jhp = tiny_hparams(accumulation_steps=ACCUM, weight_decay=1e-6,
                       **{**modules, **overrides})
    return jhp, HyperParams(verbose=False, **jhp.as_dict())


def _wide_hparams():
    """Every FFT block at E=256, 2 heads of D=128, conv channels 256, one
    block per module (the wide ablation's structure, cut to size)."""
    wide = dict(hidden_embed_dim=256, attn_nb_heads=2, attn_dropout=0.0,
                conv_kernel=3, conv_channels=256, conv_dropout=0.0,
                nb_blocks=1)
    return _hparams(prosody_encoder=wide, phoneme_encoder=wide,
                    frame_decoder=wide)


def _stacked_batch(hp, seed=0, **sizes):
    batches = [synthetic_batch(hp, batch_size=MICRO_B, seed=seed + i,
                               **sizes) for i in range(ACCUM)]
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _torch(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch(t) for t in tree)
    return torch.from_numpy(np.array(tree, copy=True))


def _reference(jhp, thp, batch):
    """JAX params crossed into the port (strict), and JAX's loss, first
    micro-batch outputs and accumulated gradients on ``batch``."""
    jmodel = JaxDaftExprt(jhp)
    params = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    tmodel = DaftExprt(thp, device="cpu", seed=1)
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)

    def loss_accum(p):
        total, first = 0.0, None
        for i in range(ACCUM):
            micro = {k: jnp.asarray(v[i]) for k, v in batch.items()}
            outs = jmodel.forward(p, jstep._batch_to_inputs(micro),
                                  jax.random.PRNGKey(i), train=True)
            loss, _ = jloss.compute_loss(outs, jstep._batch_to_targets(micro),
                                         jnp.asarray(ITERATION), jhp)
            total = total + loss / ACCUM
            first = outs if first is None else first
        return total, first

    (loss, outs), grads = jax.jit(jax.value_and_grad(
        loss_accum, has_aux=True))(params)
    return dict(jhp=jhp, thp=thp, jmodel=jmodel, params=params,
                tmodel=tmodel, batch=batch, loss=float(loss),
                outs=jax.device_get(outs), grads=jax.device_get(grads))


@pytest.fixture(scope="module")
def setup():
    jhp, thp = _hparams()
    return _reference(jhp, thp, _stacked_batch(jhp))


@pytest.fixture(scope="module")
def wide_setup():
    jhp, thp = _wide_hparams()
    return _reference(jhp, thp, _stacked_batch(jhp, max_symbols=16,
                                               max_frames=64))


@pytest.fixture
def conv_ff_spy(monkeypatch):
    """Counts the model's K4 calls; a K3 call fails the test."""
    from daft_exprt_tpu_torch.models import modules
    calls = []

    def blocked(*args):
        calls.append(args[-2])  # the C block
        return conv_ff_train_blocked(*args)

    def unblocked(*args):
        raise AssertionError("K3 ran where the plan gives K4")

    monkeypatch.setattr(modules, "conv_ff_train_blocked", blocked)
    monkeypatch.setattr(modules, "conv_ff_train", unblocked)
    return calls


def _micro(batch, i):
    return {k: torch.from_numpy(np.array(v[i])) for k, v in batch.items()}


def _assert_forward_outputs(tout, jout, tol):
    t_spk, t_film, t_enc, t_dec, t_w = tout
    j_spk, j_film, j_enc, j_dec, j_w = jout
    pairs = [(t_spk, j_spk), (t_w, j_w), (t_dec[0], j_dec[0])]
    pairs += list(zip(t_film, j_film)) + list(zip(t_enc[:3], j_enc[:3]))
    for t, j in pairs:
        t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
        np.testing.assert_allclose(t, np.asarray(j), rtol=tol, atol=tol)
    np.testing.assert_array_equal(t_dec[1].numpy(), j_dec[1])
    np.testing.assert_array_equal(t_enc[3].numpy(), j_enc[3])


def _check_gradients(s, model, metrics):
    want = state_dict_from_jax(s["grads"])
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(float(metrics["loss"]), s["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(optax.global_norm(s["grads"])),
                               rtol=1e-4)


def test_forward_train_matches_jax(setup):
    s = setup
    tout = s["tmodel"](batch_to_inputs(_micro(s["batch"], 0)), train=True)
    assert tout[3][0].requires_grad  # the training path, not K1
    _assert_forward_outputs(tout, s["outs"], OUT_TOL)


def test_accumulated_gradients_match_jax(setup):
    s = setup
    model = copy.deepcopy(s["tmodel"])
    step = make_train_step(model, s["thp"])
    metrics = step(s["batch"], torch.Generator().manual_seed(0), ITERATION)
    _check_gradients(s, model, metrics)
    named = dict(model.named_parameters())
    np.testing.assert_allclose(
        float(metrics["learning_rate"]),
        float(jax_schedule(s["jhp"])(ITERATION)), rtol=1e-6)
    # the step applied an update from its optimizer
    assert not torch.equal(named["frame_decoder.projection.linear_layer."
                                 "weight"].detach(),
                           s["tmodel"].frame_decoder.projection.linear_layer
                           .weight.detach())


def test_wide_forward_train_matches_jax_through_k4(wide_setup, conv_ff_spy):
    s = wide_setup
    tout = s["tmodel"](batch_to_inputs(_micro(s["batch"], 0)), train=True)
    _assert_forward_outputs(tout, s["outs"], OUT_TOL)
    assert conv_ff_spy == [128] * 3  # one FFT block in each module


def test_wide_accumulated_gradients_match_jax_through_k4(wide_setup,
                                                         conv_ff_spy):
    s = wide_setup
    model = copy.deepcopy(s["tmodel"])
    metrics = make_train_step(model, s["thp"])(
        s["batch"], torch.Generator().manual_seed(0), ITERATION)
    _check_gradients(s, model, metrics)
    assert conv_ff_spy == [128] * 3 * ACCUM


@pytest.mark.parametrize("weighted", [False, True])
def test_compute_loss_matches_jax(setup, weighted):
    s = setup
    micro = {k: v[0] for k, v in s["batch"].items()}
    rows = np.array([1, 0, 1, 1], np.float32) if weighted else None
    jl, jind = jloss.compute_loss(s["outs"], jstep._batch_to_targets(micro),
                                  jnp.asarray(ITERATION), s["jhp"],
                                  row_weights=rows)
    tl, tind = compute_loss(_torch(s["outs"]), batch_to_targets(
        {k: torch.from_numpy(np.array(v)) for k, v in micro.items()}),
        ITERATION, s["thp"],
        row_weights=None if rows is None else torch.from_numpy(rows))
    assert set(tind) == set(jind)
    for k in jind:
        np.testing.assert_allclose(float(tind[k]), float(jind[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


def test_lr_schedule_matches_jax(setup):
    s = setup
    mine, ref = make_lr_schedule(s["thp"]), jax_schedule(s["jhp"])
    for step in (0, 1, 500, 9999, 10000, 10001, 370000):
        np.testing.assert_allclose(float(mine(step)), float(ref(step)),
                                   rtol=1e-6)


def test_optimizer_matches_optax():
    # a finite clip: steps 1-2 are clipped (norm ~30 > 1), step 3 is not
    jhp, thp = _hparams(grad_clip_thresh=1.0)
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tx, _ = jstep.make_optimizer(jhp)
    state = tx.init(params)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = [torch.from_numpy(params[k].copy()) for k in shapes]
    opt = Optimizer(tparams, thp)
    for i, scale in enumerate((10.0, 10.0, 1e-3)):
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        if i < 2:
            assert float(optax.global_norm(grads)) > 1.0
        updates, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[k]) for k in shapes])
        for k, t in zip(shapes, tparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    assert opt.count == 3


def test_eval_step_matches_jax(setup):
    s = setup
    batch = synthetic_batch(s["jhp"], batch_size=4, seed=7)
    mask = np.array([1, 1, 0, 1], np.float32)  # drops row 2
    want = jax.jit(jstep.make_eval_step(s["jmodel"], s["jhp"]))(
        s["params"], batch, jax.random.PRNGKey(0), mask)
    got = make_eval_step(s["tmodel"], s["thp"])(batch, mask)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert float(got["count"]) == 3
    assert set(INPUT_KEYS) <= set(batch)
