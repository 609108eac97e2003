"""The port's training ops against the JAX package, on the CPU.

On the CPU the port's K2 (``attention_core``), K3 (``conv_ff_train``)
and K4 (``conv_ff_train_blocked``) autograd Functions take their plain
forward and plain backward (the recompute math the CUDA kernels are held
to on the card by ``chip_smoke.py``); here they are held against the
Pallas kernels in interpret mode and their ``jax.vjp``, on the same numpy
inputs, with bit-equal dropout masks at rate 0.1. Tolerances are the JAX
kernel tests': K2 1e-5 forward and 2e-4 gradients
(``tests/test_attention_train.py``), K3 2e-4 and 3e-4, K4 2e-5 and 3e-4
(``tests/test_conv_ff_train.py``), float32; at bfloat16 dots the
relative L2 errors stated at each test. K2's and K4's dispatch plans (the
kernel instance and its shared memory, mirroring the CUDA sources) and the
wrappers' refusals are checked without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daft_exprt_tpu.models import modules as jnn
from daft_exprt_tpu.ops import attention_common as jcommon
from daft_exprt_tpu.ops import gaussian_upsampling as jgu
from daft_exprt_tpu.ops.attention_train import _hash_bits
from daft_exprt_tpu.ops.attention_train import attention_core as jax_attention
from daft_exprt_tpu.ops.conv_ff_train import conv_ff_train as jax_conv_ff
from daft_exprt_tpu.ops.conv_ff_train import \
    conv_ff_train_blocked as jax_conv_ff_blocked
from daft_exprt_tpu.ops.grad_reversal import gradient_reversal as jax_grl
from daft_exprt_tpu_torch.ops import attention_common
from daft_exprt_tpu_torch.ops.attention_train import (attention_core,
                                                      attention_plain,
                                                      attention_plain_backward,
                                                      hash_bits,
                                                      plan_attention)
from daft_exprt_tpu_torch.ops.conv_ff_train import (
    SMEM_BYTES, blocked_smem_bytes, conv_ff_blocked_plain,
    conv_ff_blocked_plain_backward, conv_ff_plain, conv_ff_plain_backward,
    conv_ff_train, conv_ff_train_blocked, kernel_weights, plan_conv_ff,
    plan_conv_ff_blocked, plan_conv_ff_train, tc_weights)
from daft_exprt_tpu_torch.ops.gaussian_upsampling import normalize
from daft_exprt_tpu_torch.ops.grad_reversal import gradient_reversal


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.requires_grad_() if grad else t


@pytest.mark.parametrize("seed", [-2 ** 31, -7, 0, 123456789, 2 ** 31 - 1])
def test_hash_bits_bit_equal_to_jax(seed):
    for salt in (0, 3, 17, 40):
        for row0 in (0, 16, 512):
            want = np.asarray(_hash_bits(jnp.int32(seed), salt, row0, (8, 40)))
            got = hash_bits(seed, salt, row0, (8, 40)).numpy()
            np.testing.assert_array_equal(got, want.astype(np.int64))


def test_pick_q_tile_and_neg_inf_match_jax():
    for t in (16, 48, 64, 128, 768, 2048):
        assert attention_common.pick_q_tile(t) == jcommon.pick_q_tile(t)
    assert attention_common.NEG_INF == jcommon.NEG_INF


# ----------------------------------------------------------------------
# K2: training attention
# ----------------------------------------------------------------------
B, T, E = 2, 48, 32  # T=48: TQ=16, three query tiles, salts cross tiles


def _attention_inputs(seed, width=E):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, width)).astype(np.float32)
                  for _ in range(4))
    lengths = np.array([T, 29], np.int32)  # ragged
    seeds = np.array([-5, 1 << 30], np.int32)
    return q, k, v, g, lengths, seeds


@pytest.mark.parametrize("H,rate,width", [
    pytest.param(2, 0.0, E, id="2-0.0"), pytest.param(2, 0.1, E, id="2-0.1"),
    pytest.param(8, 0.0, E, id="8-0.0"), pytest.param(8, 0.1, E, id="8-0.1"),
    # the wide ablation's head dim D=128 (K2's G=8 instance on the card)
    pytest.param(2, 0.1, 256, id="E256-2-0.1")])
def test_attention_core_matches_jax(H, rate, width):
    q, k, v, g, lengths, seeds = _attention_inputs(H, width)

    def jfn(q, k, v):
        return jax_attention(q, k, v, jnp.asarray(lengths),
                             jnp.asarray(seeds), H, rate, jnp.float32, True)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = attention_core(tq, tk, tv, _t(lengths), _t(seeds), H, rate,
                         torch.float32)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for name, t, w in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("rate,width", [
    pytest.param(0.0, E, id="0.0"), pytest.param(0.1, E, id="0.1"),
    pytest.param(0.1, 256, id="E256-0.1")])
def test_attention_core_f32_inputs_bf16_dots_match_jax(rate, width):
    """float32 q/k/v with bfloat16 dots: the Pallas backward rounds k and q
    before the dq and dk products, and so does the port (relative L2 5e-4
    on out, dq, dk, dv; without those two roundings dq and dk are ~1.7e-3
    off)."""
    H = 2
    q, k, v, g, lengths, seeds = _attention_inputs(20 + H, width)

    def jfn(q, k, v):
        return jax_attention(q, k, v, jnp.asarray(lengths),
                             jnp.asarray(seeds), H, rate, jnp.bfloat16, True)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = attention_core(tq, tk, tv, _t(lengths), _t(seeds), H, rate,
                         torch.bfloat16)
    out.backward(_t(g))
    errs = {"out": _rel_l2(out.detach().numpy(), want), **{
        f"d{n}": _rel_l2(t.grad.numpy(), w)
        for n, t, w in zip("qkv", (tq, tk, tv), want_grads)}}
    assert all(e <= 5e-4 for e in errs.values()), errs


@pytest.mark.parametrize("H,rate,width", [
    pytest.param(2, 0.0, E, id="2-0.0"), pytest.param(8, 0.1, E, id="8-0.1"),
    pytest.param(2, 0.1, 256, id="E256-2-0.1")])
def test_attention_core_bf16_inputs_match_jax(H, rate, width):
    """bfloat16 q/k/v and dots, the training path's inputs (the card's
    tensor-core instance; the plain version here), against the Pallas
    kernels in interpret mode and their VJP, run eagerly: relative L2 5e-4
    on out, dq, dk and dv. Both round at the same points, so what is left
    is float32 summation order and the bf16 rounding of the gradients it
    moves (~6e-5)."""
    q, k, v, g, lengths, seeds = _attention_inputs(40 + H, width)
    q, k, v = (a.astype(jnp.bfloat16) for a in (q, k, v))

    def jfn(q, k, v):
        return jax_attention(q, k, v, jnp.asarray(lengths),
                             jnp.asarray(seeds), H, rate, jnp.bfloat16, True)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).requires_grad_() for a in (q, k, v))
    out = attention_core(tq, tk, tv, _t(lengths), _t(seeds), H, rate,
                         torch.bfloat16)
    out.backward(_t(g))
    assert tq.grad.dtype == torch.bfloat16
    errs = {"out": _rel_l2(out.detach().numpy(), want), **{
        f"d{n}": _rel_l2(t.grad.float().numpy(), np.asarray(w, np.float32))
        for n, t, w in zip("qkv", (tq, tk, tv), want_grads)}}
    assert all(e <= 5e-4 for e in errs.values()), errs


@pytest.mark.parametrize("H", [2, 8])
def test_attention_plain_backward_is_autograd_of_plain_forward(H):
    # masks fixed by the seeds: the hand-written recompute backward equals
    # torch autograd through the plain forward
    q, k, v, g, lengths, seeds = _attention_inputs(10 + H)
    args = (_t(lengths), _t(seeds), H, 0.1, torch.float32)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    attention_plain(tq, tk, tv, *args).backward(_t(g))
    got = attention_plain_backward(_t(q), _t(k), _t(v), _t(g), *args)
    for name, t, w in zip("qkv", (tq, tk, tv), got):
        np.testing.assert_allclose(w.numpy(), t.grad.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_attention_zero_length_row_is_uniform_like_jax():
    q, k, v, g, _, seeds = _attention_inputs(7)
    lengths = np.array([T, 0], np.int32)
    want = jax_attention(*(jnp.asarray(a) for a in (q, k, v)),
                         jnp.asarray(lengths), jnp.asarray(seeds), 2, 0.0,
                         jnp.float32, True)
    got = attention_plain(_t(q), _t(k), _t(v), _t(lengths), _t(seeds), 2,
                          0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(),
                               np.broadcast_to(v[1].mean(0), (T, E)),
                               rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# K3: training conv feed-forward
# ----------------------------------------------------------------------
CB, CT, CE, CC = 2, 24, 32, 64


def _conv_ff_inputs(seed):
    rng = np.random.default_rng(seed)
    p = jnn.conv_ff_init(jax.random.PRNGKey(seed), CE, CC, 3)
    jparams = (np.asarray(p["conv1"]["w"]), np.asarray(p["conv1"]["b"]),
               np.asarray(p["conv2"]["w"]), np.asarray(p["conv2"]["b"]),
               (1 + 0.1 * rng.standard_normal(CE)).astype(np.float32),
               (0.1 * rng.standard_normal(CE)).astype(np.float32))
    x, g = (rng.standard_normal((CB, CT, CE)).astype(np.float32)
            for _ in range(2))
    film = np.concatenate([1 + 0.3 * rng.standard_normal((CB, CE)),
                           0.3 * rng.standard_normal((CB, CE))],
                          1).astype(np.float32)
    seeds = np.array([3, -77], np.int32)
    return jparams, x, g, film, seeds


def _port_params(jparams):
    """JAX (k, in, out) conv weights -> the port's (out, in, k)."""
    w1, b1, w2, b2, ls, lb = jparams
    return (w1.transpose(2, 1, 0), b1, w2.transpose(2, 1, 0), b2, ls, lb)


# bf16 dots: the port's plain version against the Pallas kernels in
# interpret mode, run eagerly (no outer jax.jit: jitted XLA:CPU keeps bf16
# intermediates in float32), relative L2 on the output and every gradient
BF16_REL_L2 = {"K3": 1e-6, "K4": 3e-4}
DOTS = {"float32": (torch.float32, jnp.float32),
        "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _check_conv_ff(kernel, out, leaves, want, want_grads, dot, tol_f):
    got = [t.grad.numpy() for t in leaves]
    got[1] = got[1].transpose(2, 1, 0)  # back to the JAX layouts
    got[3] = got[3].transpose(2, 1, 0)
    pairs = [("out", out.detach().numpy(), np.asarray(want))] + [
        (name, a, np.asarray(w).reshape(a.shape))
        for name, a, w in zip(GRAD_NAMES, got, want_grads)]
    if dot == "bfloat16":
        errs = {name: _rel_l2(a, w) for name, a, w in pairs}
        assert all(e <= BF16_REL_L2[kernel] for e in errs.values()), errs
        return
    for name, a, w in pairs:
        tol = tol_f if name == "out" else 3e-4
        np.testing.assert_allclose(a, w, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("rate,dot", [
    pytest.param(0.0, "float32", id="0.0"),
    pytest.param(0.1, "float32", id="0.1"),
    pytest.param(0.0, "bfloat16", id="bf16-0.0"),
    pytest.param(0.1, "bfloat16", id="bf16-0.1")])
def test_conv_ff_train_matches_jax(rate, dot):
    jparams, x, g, film, seeds = _conv_ff_inputs(int(rate * 10))
    w1, b1, w2, b2, ls, lb = jparams
    jargs = (jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1)[None],
             jnp.asarray(w2), jnp.asarray(b2)[None], jnp.asarray(ls)[None],
             jnp.asarray(lb)[None], jnp.asarray(film)[:, None])
    want, vjp = jax.vjp(lambda *a: jax_conv_ff(*a, jnp.asarray(seeds), rate,
                                               DOTS[dot][1], True), *jargs)
    want_grads = vjp(jnp.asarray(g))
    leaves = [_t(a, grad=True) for a in (x, *_port_params(jparams), film)]
    out = conv_ff_train(*leaves, _t(seeds), rate, DOTS[dot][0])
    out.backward(_t(g))
    _check_conv_ff("K3", out, leaves, want, want_grads, dot, 2e-4)


def test_conv_ff_plain_backward_is_autograd_of_plain_forward():
    jparams, x, g, film, seeds = _conv_ff_inputs(5)
    leaves = [_t(a, grad=True) for a in (x, *_port_params(jparams), film)]
    conv_ff_plain(*leaves, _t(seeds), 0.1).backward(_t(g))
    got = conv_ff_plain_backward(*(t.detach() for t in leaves), _t(seeds),
                                 _t(g), 0.1)
    for a, t in zip(got, leaves):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), rtol=3e-4,
                                   atol=3e-4)


# ----------------------------------------------------------------------
# K4: C-blocked training conv feed-forward
# ----------------------------------------------------------------------
GRAD_NAMES = ("x", "w1", "b1", "w2", "b2", "ln_s", "ln_b", "film")


def _blocked_inputs(seed, T_, C_, E_=128, B_=2):
    rng = np.random.default_rng(seed)
    p = jnn.conv_ff_init(jax.random.PRNGKey(seed), E_, C_, 3)
    jparams = (np.asarray(p["conv1"]["w"]), np.asarray(p["conv1"]["b"]),
               np.asarray(p["conv2"]["w"]), np.asarray(p["conv2"]["b"]),
               (1 + 0.1 * rng.standard_normal(E_)).astype(np.float32),
               (0.1 * rng.standard_normal(E_)).astype(np.float32))
    x, g = (rng.standard_normal((B_, T_, E_)).astype(np.float32)
            for _ in range(2))
    film = np.concatenate([1 + 0.3 * rng.standard_normal((B_, E_)),
                           0.3 * rng.standard_normal((B_, E_))],
                          1).astype(np.float32)
    return jparams, x, g, film, np.array([11, -3], np.int32)[:B_]


@pytest.mark.parametrize("c_block,C_,T_,rate,dot", [
    pytest.param(128, 256, 32, 0.1, "float32", id="128-256-32-0.1"),
    pytest.param(128, 512, 64, 0.0, "float32", id="128-512-64-0.0"),
    pytest.param(256, 512, 64, 0.1, "float32", id="256-512-64-0.1"),
    pytest.param(128, 256, 32, 0.1, "bfloat16", id="bf16-128-256-32-0.1"),
    pytest.param(128, 512, 64, 0.0, "bfloat16", id="bf16-128-512-64-0.0")])
def test_conv_ff_blocked_matches_jax(c_block, C_, T_, rate, dot):
    """The port's K4 (plain on the CPU) against the JAX blocked Pallas
    kernels in interpret mode and their VJP: at float32 2e-5 forward, 3e-4
    gradients (``tests/test_conv_ff_train.py`` blocked tolerances); at
    bfloat16 relative L2 3e-4."""
    jparams, x, g, film, seeds = _blocked_inputs(c_block + C_, T_, C_)
    w1, b1, w2, b2, ls, lb = jparams
    jargs = (jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1)[None],
             jnp.asarray(w2), jnp.asarray(b2)[None], jnp.asarray(ls)[None],
             jnp.asarray(lb)[None], jnp.asarray(film)[:, None])
    want, vjp = jax.vjp(lambda *a: jax_conv_ff_blocked(
        *a, jnp.asarray(seeds), rate, c_block, DOTS[dot][1], True), *jargs)
    want_grads = vjp(jnp.asarray(g))
    leaves = [_t(a, grad=True) for a in (x, *_port_params(jparams), film)]
    out = conv_ff_train_blocked(*leaves, _t(seeds), rate, c_block,
                                DOTS[dot][0])
    out.backward(_t(g))
    _check_conv_ff("K4", out, leaves, want, want_grads, dot, 2e-5)


def test_conv_ff_blocked_plain_backward_is_autograd_of_plain_forward():
    jparams, x, g, film, seeds = _conv_ff_inputs(6)
    leaves = [_t(a, grad=True) for a in (x, *_port_params(jparams), film)]
    conv_ff_blocked_plain(*leaves, _t(seeds), 0.1, CC // 4).backward(_t(g))
    got = conv_ff_blocked_plain_backward(
        *(t.detach() for t in leaves), _t(seeds), _t(g), 0.1, CC // 4)
    for name, a, t in zip(GRAD_NAMES, got, leaves):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), rtol=3e-4,
                                   atol=3e-4, err_msg=name)


def test_conv_ff_blocked_plain_matches_unblocked_at_rate_half():
    """Masks from the same (seed, row, column) coordinates: blocked and
    unblocked plain versions agree, forward and gradients (2e-5)."""
    jparams, x, g, film, seeds = _conv_ff_inputs(7)
    args = (_t(x), *(_t(a) for a in _port_params(jparams)), _t(film),
            _t(seeds))
    np.testing.assert_allclose(
        conv_ff_blocked_plain(*args, 0.5, CC // 2).numpy(),
        conv_ff_plain(*args, 0.5).numpy(), rtol=2e-5, atol=2e-5)
    for name, a, b in zip(GRAD_NAMES,
                          conv_ff_blocked_plain_backward(*args, _t(g), 0.5,
                                                         CC // 2),
                          conv_ff_plain_backward(*args, _t(g), 0.5)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def test_plan_conv_ff_picks_k3_or_k4():
    # K3: the flagship and the CPU tests' narrow widths
    assert plan_conv_ff(768, 128, 1024, 3) == 1024
    assert plan_conv_ff(48, 16, 24, 3) == 24
    # K4: the wide ablation (and E=128 past K3's tile), 128-channel blocks
    assert plan_conv_ff(768, 512, 512, 3) == 128
    assert plan_conv_ff(64, 256, 256, 3) == 128
    assert plan_conv_ff(768, 128, 2048, 3) == 128
    with pytest.raises(ValueError, match="k=3"):
        plan_conv_ff(768, 512, 512, 5)


@pytest.mark.parametrize("shape", [(768, 128, 1024), (768, 512, 512)])
def test_plan_conv_ff_picks_the_jax_kernel(monkeypatch, shape):
    """The same kernel as the JAX plan on a TPU at the flagship and the
    wide shape (K3 where it returns C, K4 where it returns a block)."""
    from daft_exprt_tpu.ops.conv_ff_train import \
        plan_conv_ff as jax_plan_conv_ff
    monkeypatch.delenv("DAFT_DISABLE_TRAIN_FF", raising=False)
    monkeypatch.delenv("DAFT_VMEM_BUDGET_MB", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    C_ = shape[2]
    want = jax_plan_conv_ff(*shape, 3)
    got = plan_conv_ff(*shape, 3)
    assert (got == C_) == (want == C_)
    assert C_ % got == 0


@pytest.mark.parametrize("T_,C_", [(768, 1024), (128, 1024), (40, 1024),
                                   (2048, 1024), (64, 256)])
def test_plan_conv_ff_train_bf16_takes_tensor_cores(T_, C_):
    """K3 at bf16 dots runs the tensor-core instance that K4 runs (one C
    block): 128-row tiles, its 109,536 bytes of shared memory at E=128,
    at every training shape T."""
    plan = plan_conv_ff_train(T_, 128, C_, torch.bfloat16)
    assert plan == ("tensor_core", 128, 109536)
    assert plan == plan_conv_ff_blocked(T_, 128, C_, 128, torch.bfloat16)


@pytest.mark.parametrize("C_,dtype", [(1024, torch.float32),
                                      (576, torch.bfloat16),
                                      (1344, torch.float32)])
def test_plan_conv_ff_train_cuda_cores(C_, dtype):
    """float32 dots, and bf16 at C % 128 != 0, keep K3's CUDA-core
    instance: 32-row tiles whose shared memory fits one block and grows
    with C (chip_smoke.py holds the bytes against the built kernel's
    ``conv_ff_train_smem_bytes``)."""
    plan = plan_conv_ff_train(768, 128, C_, dtype)
    assert plan.instance == "cuda_core" and plan.rows == 32
    assert plan.smem_bytes <= SMEM_BYTES
    assert plan_conv_ff_train(768, 128, C_ - 64, dtype).smem_bytes \
        < plan.smem_bytes


def test_tc_weights_are_the_rounded_kernel_weights_made_once(rng_np):
    """The tensor-core instance's bf16 weights are the kernel layout's
    rounded weights and their tap-reversed transposes, bit for bit; they
    are made once for the micro-batches of a step and again after an
    in-place update or a new weight."""
    w1, w2 = (torch.nn.Parameter(_t(rng_np.standard_normal(shape).astype(
        np.float32))) for shape in ((256, 128, 3), (128, 256, 3)))
    made = tc_weights(w1, w2)
    assert all(w.dtype == torch.bfloat16 and w.is_contiguous()
               for w in made)
    w1k, w2k = kernel_weights(w1, w2, torch.bfloat16)
    for got, want in ((made.w1, w1k), (made.w2, w2k),
                      (made.w1r, w1k.flip(0).transpose(1, 2)),
                      (made.w2r, w2k.flip(0).transpose(1, 2))):
        assert torch.equal(got.float(), want)
    assert tc_weights(w1, w2) is made
    with torch.no_grad():
        w2.add_(1.0)  # as the optimizer updates it
    again = tc_weights(w1, w2)
    assert again is not made
    assert torch.equal(again.w2.float(),
                       kernel_weights(w1, w2, torch.bfloat16)[1])
    other = torch.nn.Parameter(w2.detach().clone())
    assert tc_weights(w1, other) is not again


def test_conv_ff_wrapper_takes_bf16_weights_on_tensor_cores():
    """The tensor-core instance (bf16 dots) reads bf16 weights, the
    CUDA-core one (f32 dots) float32 weights: each refuses the other's
    before any launch."""
    from daft_exprt_tpu_torch.ops.conv_ff_train import conv_ff_forward_cuda
    E_, C_ = 128, 256
    vecs = (torch.zeros(C_), torch.zeros(E_), torch.zeros(E_),
            torch.zeros(E_))
    rest = (torch.zeros((2, 2 * E_)), torch.zeros((2,), dtype=torch.int32))
    for dot_dtype, wrong in ((torch.bfloat16, torch.float32),
                             (torch.float32, torch.bfloat16)):
        w1 = torch.zeros((3, E_, C_), dtype=wrong)
        w2 = torch.zeros((3, C_, E_), dtype=wrong)
        with pytest.raises(ValueError, match="w1 must be contiguous"):
            conv_ff_forward_cuda(torch.zeros((2, 16, E_)), w1, vecs[0], w2,
                                 *vecs[1:], *rest, 0.0, dot_dtype)


@pytest.mark.parametrize("E_,C_", [(256, 1024), (128, 1400), (128, 96)])
def test_plan_conv_ff_train_refuses_outside_k3(E_, C_):
    with pytest.raises(ValueError, match="conv_ff_train"):
        plan_conv_ff_train(768, E_, C_, torch.bfloat16)


def test_conv_ff_train_on_the_cpu_counts_no_launch():
    jparams, x, g, film, seeds = _conv_ff_inputs(8)
    counters = ("fwd_launches", "bwd_launches", "tc_fwd_launches",
                "tc_bwd_launches")
    before = [getattr(conv_ff_train, c) for c in counters]
    leaves = [_t(a, grad=True) for a in (x, *_port_params(jparams), film)]
    conv_ff_train(*leaves, _t(seeds), 0.1, torch.bfloat16).backward(_t(g))
    assert [getattr(conv_ff_train, c) for c in counters] == before


# ----------------------------------------------------------------------
# Small ops
# ----------------------------------------------------------------------
def test_gradient_reversal_matches_jax(rng_np):
    x = rng_np.standard_normal((3, 5)).astype(np.float32)
    g = rng_np.standard_normal((3, 5)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jax_grl(a, 0.7), jnp.asarray(x))
    tx = _t(x, grad=True)
    got = gradient_reversal(tx, 0.7)
    got.backward(_t(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(
        jnp.asarray(g))[0]), rtol=1e-7, atol=0)


def test_normalize_backward_finite_where_probabilities_underflow(rng_np):
    probs = rng_np.uniform(0.0, 1.0, (2, 4, 6)).astype(np.float32)
    probs[:, :, 3:] = 0.0  # every Gaussian underflows on these frames
    g = rng_np.standard_normal((2, 4, 6)).astype(np.float32)
    want, vjp = jax.vjp(jgu._normalize, jnp.asarray(probs))
    tp = _t(probs, grad=True)
    got = normalize(tp)
    got.backward(_t(g))
    assert np.isfinite(tp.grad.numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tp.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# The CUDA wrappers refuse what their kernels do not take (checked before
# any launch, so CPU tensors reach the checks here)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("E_,H", [(32, 2), (128, 4), (1024, 4)])
def test_attention_wrapper_refuses_unsupported_widths(E_, H):
    from daft_exprt_tpu_torch.ops.attention_train import \
        attention_forward_cuda
    q = torch.zeros((2, 16, E_))
    ints = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head dims"):
        attention_forward_cuda(q, q, q, ints, ints, H, 0.0, torch.bfloat16)


# ----------------------------------------------------------------------
# K2's plan: which instance of the kernels takes a call (the training path
# at bf16 on tensor cores), mirroring csrc/attention_train.cu
# ----------------------------------------------------------------------
K2_HEAD_DIMS = [pytest.param(128, 8, id="D16"), pytest.param(128, 2, id="D64"),
                pytest.param(512, 4, id="D128")]


@pytest.mark.parametrize("E_,H", K2_HEAD_DIMS)
def test_plan_attention_bf16_rounding_takes_tensor_cores(E_, H):
    plan = plan_attention(768, E_, H, torch.bfloat16, torch.bfloat16)
    D = E_ // H
    # dk-dv's tiles: K and V of 64 keys and two stages of 64-query Q and G
    # tiles, bf16 rows padded by 8 elements, and two stages of four f32
    # terms per query
    assert plan == ("tensor_core", 64, 6 * 64 * (D + 8) * 2 + 2 * 4 * 64 * 4)


@pytest.mark.parametrize("io_dtype,dot_dtype", [
    pytest.param(torch.float32, torch.float32, id="f32"),
    pytest.param(torch.bfloat16, torch.float32, id="bf16_rounding_off")])
@pytest.mark.parametrize("E_,H", K2_HEAD_DIMS)
def test_plan_attention_cuda_core_for_f32_and_unrounded_bf16(
        io_dtype, dot_dtype, E_, H):
    # G = D / 16 lanes share a query row, 128 threads a block
    plan = plan_attention(768, E_, H, io_dtype, dot_dtype)
    assert plan == ("cuda_core", 128 * 16 // (E_ // H), 0)


# (T, E, H) of chip_smoke.py's K2_SHAPES: the flagship and wide training
# shapes and their edges
@pytest.mark.parametrize("T_,E_,H", [
    pytest.param(768, 128, 8, id="prosody_encoder"),
    pytest.param(128, 128, 2, id="phoneme_encoder"),
    pytest.param(768, 128, 2, id="frame_decoder"),
    pytest.param(48, 128, 8, id="edge_T48"),
    pytest.param(37, 128, 2, id="edge_T37"),
    pytest.param(2048, 128, 2, id="edge_T2048"),
    pytest.param(768, 512, 4, id="wide_frame_rate"),
    pytest.param(128, 512, 4, id="wide_symbol_rate"),
    pytest.param(48, 512, 4, id="wide_edge_T48")])
def test_plan_attention_fits_every_training_shape(T_, E_, H):
    for io_dtype, dot_dtype in ((torch.bfloat16, torch.bfloat16),
                                (torch.float32, torch.float32),
                                (torch.bfloat16, torch.float32)):
        plan = plan_attention(T_, E_, H, io_dtype, dot_dtype)
        assert plan.smem_bytes <= SMEM_BYTES == 227 * 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E_,H", [pytest.param(128, 4, id="D32"),
                                  pytest.param(192, 3, id="E192")])
def test_plan_attention_refuses_outside_the_envelope(E_, H, dtype):
    with pytest.raises(ValueError, match="head dims"):
        plan_attention(768, E_, H, dtype, dtype)


@pytest.mark.parametrize("k_dtype,g_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16)])
def test_attention_wrapper_refuses_mixed_dtypes(k_dtype, g_dtype):
    """The kernels read q/k/v in one dtype (float32 or bfloat16) and the
    cotangent in float32."""
    from daft_exprt_tpu_torch.ops.attention_train import \
        attention_backward_cuda
    q = torch.zeros((2, 16, 128), dtype=torch.bfloat16)
    k = torch.zeros((2, 16, 128), dtype=k_dtype)
    g = torch.zeros((2, 16, 128), dtype=g_dtype)
    ints = torch.zeros((2,), dtype=torch.int32)
    stats = torch.zeros((2, 2, 2, 16))
    with pytest.raises(ValueError, match="must be contiguous"):
        attention_backward_cuda(q, k, q, g, ints, ints, stats, 2, 0.0,
                                torch.bfloat16)


@pytest.mark.parametrize("E_,C", [(64, 1024), (128, 1000), (128, 2048)])
def test_conv_ff_wrapper_refuses_unsupported_widths(E_, C):
    from daft_exprt_tpu_torch.ops.conv_ff_train import conv_ff_forward_cuda
    x = torch.zeros((2, 16, E_))
    with pytest.raises(ValueError, match="the kernel takes"):
        conv_ff_forward_cuda(
            x, torch.zeros((3, E_, C)), torch.zeros(C), torch.zeros((3, C, E_)),
            torch.zeros(E_), torch.zeros(E_), torch.zeros(E_),
            torch.zeros((2, 2 * E_)), torch.zeros((2,), dtype=torch.int32),
            0.0, torch.bfloat16)


# ----------------------------------------------------------------------
# K4's plan: which instance takes a call (the bf16 training path on tensor
# cores), mirroring csrc/conv_ff_blocked_tc.cu and csrc/conv_ff_blocked.cu
# ----------------------------------------------------------------------
K4_WIDTHS = [128, 256, 384, 512]


@pytest.mark.parametrize("E_", K4_WIDTHS)
def test_plan_conv_ff_blocked_bf16_takes_tensor_cores(E_):
    plan = plan_conv_ff_blocked(768, E_, 512, 128, torch.bfloat16)
    # the conv GEMM's ring: 3 stages of (128 + 2) operand rows x 32
    # channels and 3 taps x 32 x 128 weights, bf16 rows padded by 8; the
    # weight gradients' ring (2 x 64 + 2 rows x 128) and the backward row
    # kernel's 8 warps x 5 float32 sums of E are smaller
    conv = 3 * (130 * 40 + 3 * 32 * 136) * 2
    assert 3 * (130 * 136) * 2 < conv and 8 * 5 * E_ * 4 < conv
    assert plan == ("tensor_core", 128, conv)
    assert plan.smem_bytes <= SMEM_BYTES


@pytest.mark.parametrize("E_", K4_WIDTHS)
def test_plan_conv_ff_blocked_f32_takes_cuda_cores(E_):
    plan = plan_conv_ff_blocked(768, E_, 512, 128, torch.float32)
    assert plan == ("cuda_core", 32, blocked_smem_bytes(E_, 128))


# (T, E, C, C block) of chip_smoke.py's K4_SHAPES at the port plan's block
@pytest.mark.parametrize("T_,E_,C_,cb", [
    pytest.param(768, 512, 512, 128, id="wide_frame_rate"),
    pytest.param(128, 512, 512, 128, id="wide_symbol_rate"),
    pytest.param(40, 512, 512, 128, id="edge_T40_short_row"),
    pytest.param(64, 256, 256, 128, id="edge_E256"),
    pytest.param(64, 512, 128, 128, id="edge_single_block")])
def test_plan_conv_ff_blocked_fits_every_k4_shape(T_, E_, C_, cb):
    assert plan_conv_ff(T_, E_, C_, 3) == cb
    for dot_dtype in (torch.bfloat16, torch.float32):
        plan = plan_conv_ff_blocked(T_, E_, C_, cb, dot_dtype)
        assert plan.smem_bytes <= SMEM_BYTES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E_,C,c_block", [(1024, 512, 128), (192, 512, 128),
                                          (512, 512, 96), (512, 384, 256)])
def test_plan_conv_ff_blocked_refuses_outside_the_envelope(E_, C, c_block,
                                                           dtype):
    with pytest.raises(ValueError, match="the kernel takes"):
        plan_conv_ff_blocked(768, E_, C, c_block, dtype)


@pytest.mark.parametrize("E_,C,c_block", [(1024, 512, 128), (192, 512, 128),
                                          (512, 512, 96), (512, 384, 256)])
def test_conv_ff_blocked_wrapper_refuses_unsupported_widths(E_, C, c_block):
    """Widths neither kernel takes: past K4's 512, no multiple of 128, a
    block that is no multiple of 128 or does not divide C."""
    from daft_exprt_tpu_torch.ops.conv_ff_train import conv_ff_forward_cuda
    x = torch.zeros((2, 16, E_))
    with pytest.raises(ValueError, match="the kernel takes"):
        conv_ff_forward_cuda(
            x, torch.zeros((3, E_, C)), torch.zeros(C), torch.zeros((3, C, E_)),
            torch.zeros(E_), torch.zeros(E_), torch.zeros(E_),
            torch.zeros((2, 2 * E_)), torch.zeros((2,), dtype=torch.int32),
            0.0, torch.bfloat16, c_block)


# ----------------------------------------------------------------------
# Shifted-matmul training conv at bf16: gradients as JAX's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_shifted_matmul_conv_bf16_grads_match_jax(k, x_dtype):
    """dx and dW bit-equal to ``jax.vjp`` of ``conv1d_apply(...,
    matmul_form=True)`` at bf16 compute: JAX rounds each tap's input
    gradient to bf16 and adds the taps in bf16, last tap first. db is a
    float32 sum of the cotangent over B x L rows in another order: held
    to twice the recursive-summation bound (n - 1) u sum|g|, u = 2^-24."""
    from daft_exprt_tpu_torch.models.modules import Conv1d

    rng = np.random.default_rng(k)
    B, L, cin, cout = 2, 40, 64, 48
    x = rng.standard_normal((B, L, cin)).astype(np.float32)
    w = (0.2 * rng.standard_normal((k, cin, cout))).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    g = rng.standard_normal((B, L, cout)).astype(np.float32)
    jdt = jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(lambda p, x: jnn.conv1d_apply(
        p, x, dtype=jnp.bfloat16, matmul_form=True),
        {"w": w, "b": b}, jnp.asarray(x).astype(jdt))
    jgrads, jdx = vjp(jnp.asarray(g))

    conv = Conv1d(cin, cout, k)
    with torch.no_grad():
        conv.conv.weight.copy_(_t(w.transpose(2, 1, 0)))
        conv.conv.bias.copy_(_t(b))
    tx = _t(x).to(x_dtype).requires_grad_()
    y = conv(tx, torch.bfloat16, matmul_form=True)
    dx, dw, db = torch.autograd.grad(
        y, [tx, conv.conv.weight, conv.conv.bias], _t(g))
    assert dx.dtype == x_dtype
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(jdx, np.float32))
    np.testing.assert_array_equal(dw.numpy().transpose(2, 1, 0),
                                  np.asarray(jgrads["w"]))
    n = B * L
    bound = 2 * (n - 1) * 2.0 ** -24 * np.abs(g).reshape(n, -1).sum(0)
    assert (np.abs(db.numpy() - np.asarray(jgrads["b"])) <= bound).all()
