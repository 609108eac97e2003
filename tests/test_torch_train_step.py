"""The port's training step against the JAX package, on the CPU.

``tests/helpers.tiny_hparams`` with every dropout at 0 (the JAX docstring
of ``training/step.py`` says dropout-on parity cannot hold: the two
packages draw different bits), accumulation 2, float32. JAX
``init_params`` crosses with ``convert.state_dict_from_jax``; gradients
cross back through the same mapping. The port's FFT blocks take K2's and
K3's plain forward and backward here; the JAX package's training path on
the CPU is XLA autodiff, the same function.

One bfloat16 step (loss and gradients) is held against eager JAX with the
training Pallas kernels (K2, K3) forced on in interpret mode: the port's
plain versions round where those kernels round.

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

from daft_exprt_tpu.models import modules as jnn
from daft_exprt_tpu.models.daft_exprt import DaftExprt as JaxDaftExprt
from daft_exprt_tpu.ops.attention_train import attention_core as jax_attention
from daft_exprt_tpu.ops.conv_ff_train import conv_ff_train as jax_conv_ff
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


def _reference(jhp, thp, batch, jit=True):
    """JAX params crossed into the port (strict), and JAX's loss, first
    micro-batch outputs and accumulated gradients on ``batch`` (eagerly
    where ``jit`` is False)."""
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

    grad_fn = jax.value_and_grad(loss_accum, has_aux=True)
    (loss, outs), grads = (jax.jit(grad_fn) if jit else grad_fn)(params)
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


@pytest.fixture(scope="module")
def bf16_setup():
    """The bf16 step's reference: eager JAX (jitted XLA:CPU keeps bf16
    intermediates in float32) on the Pallas training kernels in interpret
    mode, which JAX dispatches only on a TPU."""
    jhp, thp = _hparams(compute_dtype="bfloat16")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn, "use_train_attention", lambda *a: True)
        mp.setattr(jnn, "attention_core",
                   lambda *a: jax_attention(*a, True))
        mp.setattr(jnn, "plan_conv_ff", lambda t, e, c, k: c)
        mp.setattr(jnn, "conv_ff_train", lambda *a: jax_conv_ff(*a, True))
        return _reference(jhp, thp, _stacked_batch(jhp), jit=False)


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


# bf16 step against eager JAX: both round at the same points, so float32
# summation order is what is left. Readings: loss 1.0e-7 and gradient norm
# 8.8e-7 relative; all gradients together 1.1e-4 relative L2, each
# parameter's <= 3.5e-3 (the small-norm biases of the Gaussian upsampling,
# whose gradients are sums that cancel). A rounding point missing on one
# side moves every gradient by ~1e-3.
BF16_STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grads": 5e-4,
                 "param": 1e-2}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_bf16_step_matches_eager_jax(bf16_setup):
    s = bf16_setup
    model = copy.deepcopy(s["tmodel"])
    metrics = make_train_step(model, s["thp"])(
        s["batch"], torch.Generator().manual_seed(0), ITERATION)
    want = state_dict_from_jax(s["grads"])
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    errs = {n: _rel_l2(p.grad.numpy(), want[n].numpy())
            for n, p in named.items()}
    got_all = np.concatenate([p.grad.numpy().ravel() for p in named.values()])
    want_all = np.concatenate([want[n].numpy().ravel() for n in named])
    found = {
        "loss": abs(float(metrics["loss"]) - s["loss"]) / abs(s["loss"]),
        "grad_norm": abs(float(metrics["grad_norm"]) - float(
            optax.global_norm(s["grads"]))) / float(
                optax.global_norm(s["grads"])),
        "grads": _rel_l2(got_all, want_all), "param": max(errs.values())}
    assert all(found[k] <= BF16_STEP_TOL[k] for k in found), (
        found, max(errs, key=errs.get))


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


def _check_eval_step(s, **sizes):
    batch = synthetic_batch(s["jhp"], batch_size=4, seed=7, **sizes)
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


def test_eval_step_matches_jax(setup):
    _check_eval_step(setup)


def test_wide_eval_step_matches_jax(wide_setup):
    # the no-grad forward takes K1 (its plain version here) at E=256, 2
    # heads of 128
    _check_eval_step(wide_setup, max_symbols=16, max_frames=64)


# ----------------------------------------------------------------------
# The steps through their graph caches (eager entries on the CPU)
# ----------------------------------------------------------------------
def _dropout_hparams():
    """The tiny configuration with its dropout on, accumulation 2."""
    jhp = tiny_hparams(accumulation_steps=ACCUM, weight_decay=1e-6)
    return HyperParams(verbose=False, **jhp.as_dict())


def _eager_step(model, optimizer, hp, batch, generator, iteration):
    """The train step written out eagerly, on the host count: the
    micro-batch loop, then ``Optimizer.step``."""
    params = [p for _, p in model.named_parameters()]
    for p in params:
        p.grad = None
    for i in range(hp.accumulation_steps):
        micro = _micro(batch, i)
        loss, _ = compute_loss(model(batch_to_inputs(micro), train=True,
                                     generator=generator),
                               batch_to_targets(micro), iteration, hp)
        (loss / hp.accumulation_steps).backward()
    optimizer.step([p.grad for p in params])


def test_steps_through_the_cache_equal_eager_steps():
    """Three steps with dropout on through ``make_train_step`` (one
    entry: one batch signature) equal the same steps written out eagerly
    from the same generator, parameter for parameter; the generator moves
    on as far as the eager steps move it."""
    hp = _dropout_hparams()
    batches = [_stacked_batch(hp, seed=10 * i) for i in range(3)]
    model = DaftExprt(hp, device="cpu", seed=3)
    twin = copy.deepcopy(model)
    step = make_train_step(model, hp)
    opt = Optimizer([p for _, p in twin.named_parameters()], hp)
    gen, twin_gen = torch.Generator(), torch.Generator()
    for i, batch in enumerate(batches):
        gen.manual_seed(100 + i)
        twin_gen.manual_seed(100 + i)
        metrics = step(batch, gen, 7 + i)
        _eager_step(twin, opt, hp, batch, twin_gen, 7 + i)
        assert torch.equal(gen.get_state(), twin_gen.get_state())
        assert np.isfinite(float(metrics["loss"]))
    assert step.graphs.keys() == {("accumulate", False), "update"}
    assert len(step.graphs) == 2 and step.optimizer.count == opt.count == 3
    for (name, a), b in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(a.grad, b.grad), name
    for a, b in zip(step.optimizer.mu + step.optimizer.nu, opt.mu + opt.nu):
        assert torch.equal(a, b)


def test_a_bounded_step_cache_evicts_and_stays_equal_to_eager(monkeypatch):
    """With room for two graphs, batch signatures A, B, A evict the
    least recently run entry each time (the update is run every step and
    stays); every step still equals the eager step written out."""
    from daft_exprt_tpu_torch.training import step as step_mod

    monkeypatch.setattr(step_mod, "STEP_GRAPHS", 2)
    hp = _dropout_hparams()
    sizes = [dict(max_symbols=12, max_frames=48),
             dict(max_symbols=16, max_frames=40)]
    model = DaftExprt(hp, device="cpu", seed=3)
    twin = copy.deepcopy(model)
    step = make_train_step(model, hp)
    opt = Optimizer([p for _, p in twin.named_parameters()], hp)
    gen, twin_gen = torch.Generator(), torch.Generator()
    for i, k in enumerate((0, 1, 0)):
        batch = _stacked_batch(hp, seed=10 * i, **sizes[k])
        gen.manual_seed(100 + i)
        twin_gen.manual_seed(100 + i)
        step(batch, gen, 1 + i)
        _eager_step(twin, opt, hp, batch, twin_gen, 1 + i)
    assert step.graphs.evictions == 2 and len(step.graphs) == 2
    assert step.graphs.keys() == {("accumulate", False), "update"}
    for (name, a), b in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(a, b), name


def test_a_step_reads_no_value_on_the_host(setup, monkeypatch):
    """Nothing inside the train or eval step reads a tensor's value on the
    host (a CUDA graph could not hold it): ``Tensor.item`` and
    ``Tensor.tolist`` raise there."""
    s = setup
    model = copy.deepcopy(s["tmodel"])
    step = make_train_step(model, s["thp"])

    def read(self):
        raise AssertionError("a host read inside the step")

    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "item", read)
        mp.setattr(torch.Tensor, "tolist", read)
        metrics = step(s["batch"], torch.Generator().manual_seed(0),
                       ITERATION)
        vector = make_eval_step(model, s["thp"])(
            synthetic_batch(s["jhp"], batch_size=4, seed=7),
            np.ones(4, np.float32))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(vector["loss"]))


@pytest.mark.parametrize("count", [0, 1, 499, 9999, 10000, 370000])
def test_device_scalars_equal_the_host_ones(count):
    """The 1-based count's bias corrections and step size, computed from a
    float32 scalar tensor (what a graph loads), equal the host formulas;
    and the adversarial weight of a tensor iteration equals the host
    one's."""
    from daft_exprt_tpu_torch.training.loss import adversarial_weight
    _, thp = _hparams()
    opt = Optimizer([torch.zeros(3)], thp)
    c = count + 1
    bc1, bc2, step_size = opt.scalars(torch.full((), float(c)))
    one = torch.ones((), dtype=torch.float32)
    assert bc1.item() == (1 - (one * opt.b1) ** c).item()
    assert bc2.item() == (1 - (one * opt.b2) ** c).item()
    assert step_size.item() == (-opt.schedule(c)).item()
    it = torch.full((), float(count))
    for args in ((thp.warmup_steps, thp.adv_max_weight), (10, 0.5)):
        assert adversarial_weight(it, *args).item() \
            == adversarial_weight(count, *args).item()


def test_a_resume_that_sets_the_count_alone_moves_the_step(setup):
    """The step loads the optimizer's host count before every pass: a
    count set alone (a resume without optimizer state) gives the update
    ``Optimizer.step`` gives at that count, and the logged learning rate
    is the schedule at the iteration."""
    s = setup
    model, twin = copy.deepcopy(s["tmodel"]), copy.deepcopy(s["tmodel"])
    step = make_train_step(model, s["thp"])
    opt = Optimizer([p for _, p in twin.named_parameters()], s["thp"])
    step.optimizer.count = opt.count = 123
    metrics = step(s["batch"], torch.Generator().manual_seed(0), ITERATION)
    _eager_step(twin, opt, s["thp"], s["batch"], None, ITERATION)
    assert step.optimizer.count == opt.count == 124
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
    assert float(metrics["learning_rate"]) \
        == float(make_lr_schedule(s["thp"])(ITERATION))


def test_a_replaced_parameter_drops_the_step_graphs(setup):
    """A graph reads the parameters at their addresses: the step empties
    its cache when one is replaced rather than copied into."""
    s = setup
    model = copy.deepcopy(s["tmodel"])
    step = make_train_step(model, s["thp"])
    gen = torch.Generator().manual_seed(0)
    step(s["batch"], gen, ITERATION)
    step(s["batch"], gen, ITERATION + 1)
    def entries():
        return {key: e for (key, _), e in step.graphs.entries.items()}

    before = entries()
    step(s["batch"], gen, ITERATION + 2)
    assert entries() == before
    w = model.frame_decoder.projection.linear_layer.weight
    w.data = w.data.clone()
    step(s["batch"], gen, ITERATION + 3)
    after = entries()
    assert after.keys() == before.keys() and len(step.graphs) == 2
    assert all(after[k] is not before[k] for k in after)


def test_eval_step_through_the_cache_equals_eager(setup):
    """The eval step's entry (one batch signature) gives the model and
    loss called eagerly, packs K1's weights inside its pass and keeps
    none past it, so weights changed in place are seen at the next
    batch."""
    from daft_exprt_tpu_torch.models.modules import FFTBlock
    s = setup
    model = copy.deepcopy(s["tmodel"])
    step = make_eval_step(model, s["thp"])
    mask = np.array([1, 0, 1, 1], np.float32)
    for round_ in range(2):
        for seed in (7, 8):
            batch = synthetic_batch(s["jhp"], batch_size=4, seed=seed)
            got = step(batch, mask)
            assert all(m._packed is None for m in model.modules()
                       if isinstance(m, FFTBlock))
            with torch.no_grad():
                inputs = {k: torch.from_numpy(np.asarray(batch[k]))
                          for k in INPUT_KEYS}
                outputs = model(batch_to_inputs(inputs), train=False)
                loss, terms = compute_loss(outputs, batch_to_targets(inputs),
                                           0, s["thp"],
                                           row_weights=torch.from_numpy(mask))
            assert torch.equal(got["loss"], loss)
            for k, v in terms.items():
                assert torch.equal(got[k], v), k
            assert float(got["count"]) == 3
        with torch.no_grad():  # in place, as an optimizer step
            for p in model.parameters():
                p.mul_(0.9)
    assert step.graphs.keys() == {"eval"} and len(step.graphs) == 1


def test_training_kernels_count_captured_launches_apart():
    """K2-K4's wrappers count a launch recorded under CUDA-graph capture
    in ``*_captured`` (it runs at every replay, where no wrapper runs)
    and every other in ``*_launches``; ``TRAIN_CAPTURED`` names the
    captured counters a train-step graph records."""
    from daft_exprt_tpu_torch.ops import attention_train, conv_ff_train
    from daft_exprt_tpu_torch.training.step import TRAIN_CAPTURED
    fns = (attention_train.attention_core, conv_ff_train.conv_ff_train,
           conv_ff_train.conv_ff_train_blocked)
    names = [f"{tc}{d}_{kind}" for d in ("fwd", "bwd") for tc in ("", "tc_")
             for kind in ("launches", "captured")]

    def counts():
        return [getattr(fn, n) for fn in fns for n in names]

    before = counts()
    attention_train._count("fwd", True, True)
    attention_train._count("bwd", False, False)
    conv_ff_train._launched(0, None, True, "bwd", True)
    conv_ff_train._launched(0, 128, False, "fwd", False)
    moved = {(fn.__name__, n) for fn in fns for n in names
             if getattr(fn, n) != before[fns.index(fn) * len(names)
                                         + names.index(n)]}
    assert moved == {("attention_core", "fwd_captured"),
                     ("attention_core", "tc_fwd_captured"),
                     ("attention_core", "bwd_launches"),
                     ("conv_ff_train", "bwd_captured"),
                     ("conv_ff_train", "tc_bwd_captured"),
                     ("conv_ff_train_blocked", "fwd_launches")}
    assert {(fn.__name__, n) for fn, n in TRAIN_CAPTURED} == {
        (fn.__name__, n) for fn in fns for n in names if "captured" in n}
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        conv_ff_train._launched(7, None, False, "fwd", False)


def test_a_step_casts_the_tensor_core_weights_inside_its_pass(setup):
    """K3/K4's bf16 weights kept from before a step are forgotten as the
    step's pass starts: a captured pass casts them itself at every
    replay, and never reads a set an eager run made (a later cast frees
    it)."""
    from daft_exprt_tpu_torch.ops import conv_ff_train as cft
    s = setup
    model = copy.deepcopy(s["tmodel"])
    step = make_train_step(model, s["thp"])
    conv = model.frame_decoder.blocks[0].feed_forward.convs
    cft.tc_weights(conv["0"].conv.weight, conv["2"].conv.weight)
    assert len(cft._TC_WEIGHTS) == 1
    step(s["batch"], torch.Generator().manual_seed(0), ITERATION)
    assert len(cft._TC_WEIGHTS) == 0  # the CPU's plain path casts none
