"""The port's fused FFT block (K1) against the JAX package.

On the CPU the port's ``fused_fft_block`` takes its plain version
(``fft_block_plain``), which is held against the Pallas kernel in
interpret mode and against the XLA path ``modules.fft_block_apply``, on
the same weights (carried with ``convert.fft_block_state_dict``) and the
same numpy inputs. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``, at the main path's shapes;
these tests import JAX, while ``chip_smoke.py`` needs only PyTorch.
The cases span the kernels' widths: E=32 (the plain version only), and the
wide ablation's head dim of 128 at E=256 and E=512. ``plan_fft_block``
and the kernels' weight layouts are checked here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daft_exprt_tpu.models import modules as jnn
from daft_exprt_tpu.ops.fft_block import fused_fft_block as jax_fused
from daft_exprt_tpu_torch.convert import fft_block_state_dict
from daft_exprt_tpu_torch.models.modules import FFTBlock
from daft_exprt_tpu_torch.ops.fft_block import (FFTBlockPlan, SMEM_BYTES,
                                                fft_block_plain,
                                                fused_fft_block,
                                                plan_fft_block)

E, C = 32, 64


def _jax_block(rng_np, H, E=E, C=C):
    params = jnn.fft_block_init(jax.random.PRNGKey(0), E, H, C, 3)
    attn = dict(params["attn"])
    for key in ("q_b", "k_b", "v_b", "out_b"):  # exercise every term
        attn[key] = jnp.asarray(rng_np.standard_normal(E) * 0.1, jnp.float32)
    ff = jax.tree.map(lambda a: a, params["ff"])
    ff["ln"] = {"scale": jnp.asarray(1 + 0.1 * rng_np.standard_normal(E),
                                     jnp.float32),
                "bias": jnp.asarray(0.1 * rng_np.standard_normal(E),
                                    jnp.float32)}
    return {"attn": attn, "ff": ff}


def _port_block(jparams, H, E=E, C=C):
    block = FFTBlock(E, H, C, 3)
    block.load_state_dict(fft_block_state_dict(jax.device_get(jparams)),
                          strict=True)
    return block


def _case(rng_np, B, H, T, with_film, E=E, C=C):
    jparams = _jax_block(rng_np, H, E, C)
    x = rng_np.standard_normal((B, T, E)).astype(np.float32)
    film = (rng_np.standard_normal((B, 2 * E)).astype(np.float32)
            if with_film else None)
    lengths = rng_np.integers(2, T, size=B).astype(np.int32)
    lengths[0] = T  # one full row
    lengths[-1] = 1  # one row with a single valid position
    return jparams, x, film, lengths


# (B, H, T, FiLM, E, C)
CASES = [
    (2, 2, 32, True, E, C),     # decoder / phoneme-encoder heads, FiLM
    (3, 8, 64, False, E, C),    # prosody-encoder heads, no FiLM
    (3, 4, 48, True, E, C),     # T not a power of two
    (3, 2, 24, True, 256, 256),   # E=256: 2 heads of 128
    (2, 4, 16, False, 512, 512),  # the wide ablation: 4 heads of 128
]
BF16_CASES = CASES[:2] + CASES[3:]


def _ids(cases):
    return ["-".join(map(str, c[:4])) + ("" if c[4] == E else f"-E{c[4]}")
            for c in cases]


@pytest.mark.parametrize("B,H,T,with_film,E,C", CASES, ids=_ids(CASES))
def test_plain_matches_pallas_and_xla_f32(rng_np, B, H, T, with_film, E, C):
    jparams, x, film, lengths = _case(rng_np, B, H, T, with_film, E, C)
    valid = np.arange(T)[None, :] < lengths[:, None]
    jfilm = None if film is None else jnp.asarray(film)
    pallas = np.asarray(jax_fused(jnp.asarray(x), jparams, jfilm,
                                  jnp.asarray(valid), num_heads=H,
                                  dot_dtype=jnp.float32, interpret=True))
    xla = np.asarray(jnn.fft_block_apply(
        jparams, jnp.asarray(x), jfilm, jnp.asarray(valid), num_heads=H,
        attn_dropout=0.1, conv_dropout=0.1, rng=jax.random.PRNGKey(1),
        deterministic=True, dtype=jnp.float32))

    block = _port_block(jparams, H, E, C)
    before = fused_fft_block.launches, fused_fft_block.tc_launches
    out = fused_fft_block(torch.from_numpy(x), block.kernel_weights(
        torch.float32), None if film is None else torch.from_numpy(film),
        torch.from_numpy(lengths), num_heads=H,
        dot_dtype=torch.float32).numpy()
    # a CPU tensor takes the plain version and launches nothing
    assert (fused_fft_block.launches, fused_fft_block.tc_launches) == before
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[~valid], 0.0)
    # f32 dots in another library and order: the JAX kernel test's 2e-4
    np.testing.assert_allclose(out, pallas, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out, xla, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,H,T,with_film,E,C", BF16_CASES,
                         ids=_ids(BF16_CASES))
def test_plain_matches_pallas_bf16(rng_np, B, H, T, with_film, E, C):
    # Same rounding points as the Pallas kernel: only f32 summation order
    # differs, which can flip an occasional bf16 rounding by one ulp.
    # These cases agree to ~1e-6, while dropping any one rounding point
    # moves the output by ~1e-2 (the bf16-vs-f32 gap), so 1e-3 both
    # holds and would catch a misplaced rounding.
    jparams, x, film, lengths = _case(rng_np, B, H, T, with_film, E, C)
    valid = np.arange(T)[None, :] < lengths[:, None]
    pallas = np.asarray(jax_fused(
        jnp.asarray(x), jparams, None if film is None else jnp.asarray(film),
        jnp.asarray(valid), num_heads=H, dot_dtype=jnp.bfloat16,
        interpret=True))
    block = _port_block(jparams, H, E, C)
    out = fft_block_plain(
        torch.from_numpy(x), block.kernel_weights(torch.bfloat16),
        None if film is None else torch.from_numpy(film),
        torch.from_numpy(lengths), num_heads=H,
        dot_dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(out[~valid], 0.0)
    np.testing.assert_allclose(out, pallas, rtol=1e-3, atol=1e-3)


def test_kernel_weights_repack_after_load(rng_np):
    block = _port_block(_jax_block(rng_np, 2), 2)
    first = block.kernel_weights(torch.float32)
    assert block.kernel_weights(torch.float32) is first  # cached
    assert block.kernel_weights(torch.bfloat16) is not first
    block.load_state_dict(fft_block_state_dict(
        jax.device_get(_jax_block(rng_np, 2))))
    again = block.kernel_weights(torch.bfloat16)
    assert not torch.equal(again.wqkv, first.wqkv)
    # bf16 packing rounds the dot weights, not the vectors
    assert torch.equal(again.wqkv, again.wqkv.bfloat16().float())


def test_wrapper_takes_plain_only_on_cpu(rng_np):
    # Any device but the CPU goes to the kernel or raises: here the meta
    # device, which the kernel does not take, must raise, not fall back.
    block = _port_block(_jax_block(rng_np, 2), 2)
    w = block.kernel_weights(torch.float32)
    x = torch.empty((1, 8, E), device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_fft_block(x, w, None, torch.ones(1, dtype=torch.int32),
                        num_heads=2, dot_dtype=torch.float32)



# (T, E, H, C, dot dtype, instance, shared-memory bytes): the tensor-core
# instance's largest launch is the conv ring, 3 stages x ((128 + 2) x 40 +
# 3 x 32 x 136) bf16, at every shape; the CUDA-core one's the conv tile,
# 4 x ((32 + 4) E + (32 + 2) C + 3 x 16 x 128) bytes
PLANS = [
    (512, 128, 2, 1024, torch.bfloat16, "tensor_core", 109536),
    (64, 128, 8, 1024, torch.bfloat16, "tensor_core", 109536),
    (768, 512, 4, 512, torch.bfloat16, "tensor_core", 109536),
    (200, 256, 2, 256, torch.bfloat16, "tensor_core", 109536),
    (512, 128, 2, 1024, torch.float32, "cuda_core", 182272),
    (768, 512, 4, 512, torch.float32, "cuda_core", 167936),
    (200, 256, 2, 256, torch.float32, "cuda_core", 96256),
    (64, 128, 2, 1392, torch.float32, "cuda_core", 232320),  # the largest C
    # bf16 dots at C % 128 != 0: the CUDA-core instance rounds
    (64, 128, 2, 1040, torch.bfloat16, "cuda_core", 4 * (36 * 128 + 34 * 1040
                                                         + 6144)),
]


@pytest.mark.parametrize("t,e,h,c,dtype,instance,smem", PLANS)
def test_plan_fft_block(t, e, h, c, dtype, instance, smem):
    plan = plan_fft_block(t, e, h, c, dtype)
    assert plan == FFTBlockPlan(instance, smem)
    assert plan.smem_bytes <= SMEM_BYTES


@pytest.mark.parametrize("e,h,c,dtype", [
    (384, 3, 384, torch.bfloat16),   # no kernel width
    (128, 4, 1024, torch.bfloat16),  # D=32
    (512, 3, 512, torch.float32),    # E % H
    (512, 4, 1024, torch.float32),   # the CUDA-core conv tile past 227 KB
    (128, 2, 1400, torch.float32),   # C % 16
    (128, 2, 1024, torch.float16),
])
def test_plan_fft_block_raises_outside_the_envelope(e, h, c, dtype):
    with pytest.raises(ValueError):
        plan_fft_block(64, e, h, c, dtype)


@pytest.mark.parametrize("dtype,C,stored", [
    (torch.bfloat16, 256, torch.bfloat16),  # the tensor-core instance's
    (torch.bfloat16, 64, torch.float32),    # rounded, for the CUDA-core one
    (torch.float32, 256, torch.float32),
])
def test_kernel_weights_layout(rng_np, dtype, C, stored):
    # every weight contiguous in the layout and dtype the instance reads
    block = _port_block(_jax_block(rng_np, 2, E, C), 2, E, C)
    w = block.kernel_weights(dtype)
    for name, t in zip(w._fields, w):
        assert t.is_contiguous(), name
        dot = name in ("wqkv", "wo", "w1", "w2")
        assert t.dtype == (stored if dot else torch.float32), name
        if dot:  # rounded to the dot dtype, whatever the storage
            assert torch.equal(t, t.to(dtype).to(t.dtype)), name
    assert tuple(w.w1.shape) == (3, E, C) and tuple(w.w2.shape) == (3, C, E)
    assert tuple(w.wqkv.shape) == (E, 3 * E)
