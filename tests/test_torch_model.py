"""The port's model and serving path against the JAX package, on the CPU.

Weights cross with ``convert.state_dict_from_jax`` from the JAX
``init_params`` (duration head pinned to 0.12 s per phone, so rows
decode to tens of frames); inputs are collated from a numpy seed. Both
run in float32 at ``tests/helpers.tiny_hparams``, and once in bfloat16
against eager JAX with the fused FFT block (K1) forced on; inference runs
once more at the wide ablation's structure (every FFT block at E=256, 2
heads of 128, conv channels 256), cut to size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import pinned_init_params, tiny_hparams

from daft_exprt_tpu.inference import inputs as jinputs
from daft_exprt_tpu.inference.engine import InferenceEngine as JaxEngine
from daft_exprt_tpu.models import modules as jnn
from daft_exprt_tpu.models.daft_exprt import DaftExprt as JaxDaftExprt
from daft_exprt_tpu.ops.fft_block import fused_fft_block as jax_fused_fft
from daft_exprt_tpu_torch.config import HyperParams
from daft_exprt_tpu_torch.convert import (fft_block_state_dict,
                                          state_dict_from_jax)
from daft_exprt_tpu_torch.inference import inputs as tinputs
from daft_exprt_tpu_torch.inference.engine import InferenceEngine
from daft_exprt_tpu_torch.models.daft_exprt import DaftExprt

MAX_FRAMES = 256
# float32 on both sides, different libraries and summation orders through
# ~10 layers: 1e-3 absolute on every real-valued output
TOL = 1e-3


def _hparams(**overrides):
    jhp = tiny_hparams(max_frames=MAX_FRAMES, **overrides)
    return jhp, HyperParams(verbose=False, **jhp.as_dict())


def _wide_hparams():
    """Every FFT block at E=256, 2 heads of D=128, conv channels 256, one
    block per module: the wide ablation's structure, cut to size."""
    wide = dict(hidden_embed_dim=256, attn_nb_heads=2, attn_dropout=0.1,
                conv_kernel=3, conv_channels=256, conv_dropout=0.1,
                nb_blocks=1)
    return _hparams(prosody_encoder=wide, phoneme_encoder=wide,
                    frame_decoder=wide)


def _models(jhp, thp):
    jmodel = JaxDaftExprt(jhp)
    params = jax.device_get(pinned_init_params(jmodel, seed=0))
    tmodel = DaftExprt(thp, device="cpu", seed=1)
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    return jhp, thp, jmodel, params, tmodel


@pytest.fixture(scope="module")
def models():
    return _models(*_hparams())


@pytest.fixture(scope="module")
def wide_models():
    return _models(*_wide_hparams())


def _batch(hp, pitch_transform, seed=0, B=3):
    """A collated batch through the port's and the JAX collation."""
    rng = np.random.default_rng(seed)
    sentences, refs, dur = [], [], []
    for b in range(B):
        n = int(rng.integers(6, 17))
        sentences.append([hp.symbols[i] for i in
                          rng.integers(1, hp.n_symbols, size=n)])
        t = int(rng.integers(20, 65))
        refs.append({"energy": np.abs(rng.standard_normal(t)) + 1.0,
                     "pitch": rng.standard_normal(t),
                     "mel_spec": rng.standard_normal((hp.n_mel_channels, t))})
        dur.append(rng.uniform(0.6, 1.4, size=n).astype(np.float32))
    pitch = [rng.uniform(0.5, 1.5, size=len(s)).astype(np.float32)
             for s in sentences]
    args = (sentences, dur, None, pitch, pitch_transform, refs,
            [b % 3 for b in range(B)])
    return args


def _collate(jhp, thp, args):
    tin, B = tinputs.collate_inference_batch(*args, thp)
    jin, jB = jinputs.collate_inference_batch(*args, jhp)
    assert B == jB
    for a, b in zip(tin, jin):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    return tin


def _assert_outputs_match(tout, jout):
    t_enc, t_dec, t_w = tout
    j_enc, j_dec, j_w = jout
    np.testing.assert_array_equal(t_enc[1], j_enc[1])      # durations_int
    np.testing.assert_array_equal(t_dec[1], j_dec[1])      # output_lengths
    np.testing.assert_array_equal(t_dec[2], j_dec[2])      # overflow
    np.testing.assert_array_equal(t_enc[4], j_enc[4])      # input_lengths
    for i in (0, 2, 3):  # duration, energy, pitch predictions
        np.testing.assert_allclose(t_enc[i], j_enc[i], rtol=TOL, atol=TOL)
    assert t_dec[0].shape == j_dec[0].shape
    np.testing.assert_allclose(t_dec[0], j_dec[0], rtol=TOL, atol=TOL)
    if j_w is not None:
        np.testing.assert_allclose(t_w, j_w, rtol=TOL, atol=TOL)


def test_config_copy_matches_jax():
    # own copy of HyperParams: same defaults, derived fields and symbols
    from daft_exprt_tpu.config import HyperParams as JaxHyperParams
    kw = dict(verbose=False, training_files="x", validation_files="x",
              output_directory="/nonexistent", language="english",
              speakers=["a", "b"])
    assert HyperParams(**kw).as_dict() == JaxHyperParams(**kw).as_dict()


def test_state_dict_from_jax_covers_every_parameter(models):
    *_, params, tmodel = models
    sd = state_dict_from_jax(params)
    own = tmodel.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("module", ["mha", "conv_ff", "fft_block_autograd",
                                    "fft_block_inference"])
def test_modules_match_jax(models, rng_np, module):
    *_, params, tmodel = models
    jblock = params["frame_decoder"]["blocks"][0]
    tblock = tmodel.frame_decoder.blocks[0]
    B, T, E = 3, 20, 16
    x = rng_np.standard_normal((B, T, E)).astype(np.float32)
    film = rng_np.standard_normal((B, 2 * E)).astype(np.float32)
    lengths = np.array([T, 11, 1], np.int32)
    valid = np.arange(T)[None, :] < lengths[:, None]
    jx, jfilm, jvalid = jnp.asarray(x), jnp.asarray(film), jnp.asarray(valid)
    tx, tfilm = torch.from_numpy(x), torch.from_numpy(film)
    tlen, tvalid = torch.from_numpy(lengths), torch.from_numpy(valid)
    kw = dict(rng=jax.random.PRNGKey(0), deterministic=True,
              dtype=jnp.float32)
    if module == "mha":
        ref = jnn.mha_apply(jblock["attn"], jx, jvalid, num_heads=2,
                            attn_dropout=0.1, **kw)
        out = tblock.attention(tx, tvalid)
    elif module == "conv_ff":
        ref = jnn.conv_ff_apply(jblock["ff"], jx, jfilm, conv_dropout=0.1,
                                **kw)
        out = tblock.feed_forward(tx, tfilm)
    elif module == "fft_block_autograd":
        # the training path (K2 -> mask -> K3 -> mask, dropout 0) and its
        # gradients for x, FiLM and every block parameter
        g = rng_np.standard_normal((B, T, E)).astype(np.float32)

        def jfn(p, x, f):
            return jnn.fft_block_apply(
                p, x, f, jvalid, num_heads=2, attn_dropout=0.0,
                conv_dropout=0.0, rng=jax.random.PRNGKey(0),
                deterministic=False, dtype=jnp.float32)

        ref, vjp = jax.vjp(jfn, jblock, jx, jfilm)
        jgrads = jax.device_get(vjp(jnp.asarray(g)))
        tx.requires_grad_()
        tfilm.requires_grad_()
        params = dict(tblock.named_parameters())
        out = tblock(tx, tfilm, tlen)
        grads = torch.autograd.grad(out, [tx, tfilm, *params.values()],
                                    torch.from_numpy(g))
        want = fft_block_state_dict(jgrads[0])
        assert set(want) == set(params)
        for name, got, ref_g in zip(["x", "film", *params], grads,
                                    [jgrads[1], jgrads[2], *(
                                        want[n] for n in params)]):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref_g),
                                       rtol=3e-4, atol=3e-4, err_msg=name)
    else:
        ref = jnn.fft_block_apply(jblock, jx, jfilm, jvalid, num_heads=2,
                                  attn_dropout=0.1, conv_dropout=0.1, **kw)
        with torch.no_grad():
            out = tblock(tx, tfilm, tlen)
    # f32 in both; the JAX kernel test's 2e-4
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pitch_transform,max_frames", [("add", MAX_FRAMES),
                                                        ("multiply", 128)])
def test_inference_matches_jax(models, pitch_transform, max_frames):
    # max_frames=128 truncates the longest rows: the overflow flags and
    # clipped output lengths must agree too
    jhp, thp, jmodel, params, tmodel = models
    inputs = _collate(jhp, thp, _batch(thp, pitch_transform))
    means, stds = tinputs.pitch_stats_arrays(thp)
    jmeans, jstds = jinputs.pitch_stats_arrays(jhp)
    jout = jax.jit(lambda p, i: jmodel.inference(
        p, i, pitch_transform, jmeans, jstds, max_frames))(params, inputs)
    tout = tmodel.inference([torch.from_numpy(a) for a in inputs],
                            pitch_transform, means, stds, max_frames)
    jout = jax.device_get(jout)
    tout = jax.tree.map(lambda t: t.numpy(), tout)
    if max_frames < MAX_FRAMES:
        assert jout[1][2].any() and not jout[1][2].all()
    assert (jout[1][1] > 20).all()  # real decodes, not empty rows
    _assert_outputs_match(tout, jout)


def test_wide_inference_matches_jax(wide_models):
    # K1 at the wide ablation's head dim (its plain version here), float32
    jhp, thp, jmodel, params, tmodel = wide_models
    inputs = _collate(jhp, thp, _batch(thp, "add", seed=5))
    means, stds = tinputs.pitch_stats_arrays(thp)
    jmeans, jstds = jinputs.pitch_stats_arrays(jhp)
    jout = jax.device_get(jax.jit(lambda p, i: jmodel.inference(
        p, i, "add", jmeans, jstds, MAX_FRAMES))(params, inputs))
    tout = jax.tree.map(lambda t: t.numpy(), tmodel.inference(
        [torch.from_numpy(a) for a in inputs], "add", means, stds,
        MAX_FRAMES))
    block = tmodel.frame_decoder.blocks[0]
    assert block.num_heads == 2 and tuple(
        block.attention.multi_head_attention.in_proj_weight.shape) == (768,
                                                                       256)
    assert (jout[1][1] > 20).all()
    _assert_outputs_match(tout, jout)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# bf16 inference, the port (K1's plain version at bf16 dots on the CPU)
# against eager JAX with the Pallas K1 in interpret mode: both round at the
# same points, so only float32 summation order is left (readings <= 2e-7
# relative L2 on the mel, the predictions and the attention weights); a
# missing or extra bf16 rounding moves them by ~1e-3
BF16_INFERENCE_REL_L2 = 1e-5


@pytest.mark.parametrize("pitch_transform", ["add", "multiply"])
def test_inference_bf16_matches_eager_jax(monkeypatch, pitch_transform):
    """``DaftExprt.inference`` at ``compute_dtype="bfloat16"``. JAX runs
    eagerly (no outer ``jax.jit``: jitted XLA:CPU keeps bf16
    intermediates in float32) with K1 forced on, as ``tests/test_fft_block.py``
    runs it: in interpret mode."""
    jhp, thp = _hparams(compute_dtype="bfloat16")
    jmodel = JaxDaftExprt(jhp)
    params = jax.device_get(pinned_init_params(jmodel, seed=0))
    tmodel = DaftExprt(thp, device="cpu", seed=1)
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    monkeypatch.setattr(jnn, "use_fused_fft_block", lambda *a: True)
    monkeypatch.setattr(jnn, "fused_fft_block",
                        functools.partial(jax_fused_fft, interpret=True))
    inputs = _collate(jhp, thp, _batch(thp, pitch_transform))
    means, stds = tinputs.pitch_stats_arrays(thp)
    jmeans, jstds = jinputs.pitch_stats_arrays(jhp)
    jout = jax.device_get(jmodel.inference(params, inputs, pitch_transform,
                                           jmeans, jstds, MAX_FRAMES))
    tout = jax.tree.map(lambda t: t.numpy(), tmodel.inference(
        [torch.from_numpy(a) for a in inputs], pitch_transform, means, stds,
        MAX_FRAMES))
    (t_enc, t_dec, t_w), (j_enc, j_dec, j_w) = tout, jout
    for i in (1, 4):  # durations_int, input_lengths
        np.testing.assert_array_equal(t_enc[i], j_enc[i])
    for i in (1, 2):  # output_lengths, overflow
        np.testing.assert_array_equal(t_dec[i], j_dec[i])
    assert (j_dec[1] > 20).all()
    errs = {"mel": _rel_l2(t_dec[0], j_dec[0]), "weights": _rel_l2(t_w, j_w),
            **{name: _rel_l2(t_enc[i], j_enc[i]) for name, i in (
                ("duration", 0), ("energy", 2), ("pitch", 3))}}
    assert all(e <= BF16_INFERENCE_REL_L2 for e in errs.values()), errs


@pytest.mark.parametrize("policy,pitch_transform,short_speculation", [
    ("speculate", "add", False),
    ("speculate", "multiply", True),  # undershoots -> full-budget re-run
    ("measure", "multiply", False),
    ("measure", "add", False),
])
def test_engine_run_matches_jax(models, policy, pitch_transform,
                                short_speculation):
    *_, params, tmodel = models
    stats = {}
    if short_speculation:  # per-symbol stats far below the pinned 0.12 s
        stats = {"symbols": {s: {"dur_mean": 0.005, "dur_std": 0.001}
                             for s in tiny_hparams().symbols}}
    jhp, thp = _hparams(stats=stats)
    inputs = _collate(jhp, thp, _batch(thp, pitch_transform, seed=3))
    jout = JaxEngine(JaxDaftExprt(jhp), params, jhp,
                     bucket_policy=policy).run(inputs, pitch_transform)
    engine = InferenceEngine(tmodel, None, thp, device="cpu",
                             bucket_policy=policy)
    tout = engine.run(inputs, pitch_transform)
    assert tout[1][0].shape[-1] in engine.out_frame_buckets
    expect_passes = 2 if short_speculation else 1
    assert engine.passes == expect_passes
    if short_speculation:
        assert tout[1][0].shape[-1] == engine.max_out_frames
    _assert_outputs_match(tout, jout)
    assert engine.run(inputs, pitch_transform, want_weights=False)[2] is None
