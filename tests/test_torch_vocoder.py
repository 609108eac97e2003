"""The port's HiFi-GAN vocoder and K5 against the JAX package, on the CPU.

On the CPU ``fused_mrf`` takes its plain version, ``mrf_plain``: bf16
operands, float32 carries and sums, the rounding points of the Pallas
kernel. It is held against ``daft_exprt_tpu.ops.mrf_vocoder.fused_mrf``
in interpret mode on the time-blocked layout (the port's (B, N, C)
reshaped), and the whole generator against ``apply_blocked(...,
mrf="interpret")``, the function the TPU served. Both round at the same
points, so they differ only where another float32 summation order moves
a value across a bf16 rounding boundary; the limit is on the relative L2
error, and the control -- plain without its roundings -- must exceed it.
Stages that do not take K5 are held to ``apply`` at the JAX generator
test's float32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_vocoder import TINY, TINY_V3, TorchGenerator

from daft_exprt_tpu.ops.mrf_vocoder import build_mrf_program as jax_program
from daft_exprt_tpu.ops.mrf_vocoder import fused_mrf as jax_fused_mrf
from daft_exprt_tpu.vocoder import hifigan as jhifigan
from daft_exprt_tpu.vocoder import streaming as jstreaming
from daft_exprt_tpu_torch.convert import generator_state_dict_from_jax
from daft_exprt_tpu_torch.ops.mrf_vocoder import (CHAIN_END, CHAIN_START,
                                                  LRELU_SLOPE, SMEM_LIMIT,
                                                  TO_CARRY,
                                                  build_mrf_program,
                                                  fused_mrf, mrf_plain,
                                                  plan_mrf)
from daft_exprt_tpu_torch.vocoder import hifigan
from daft_exprt_tpu_torch.vocoder.streaming import (StreamingVocoder,
                                                    mel_halo_frames)

# relative L2 of the port's bf16-operand path against the Pallas kernel
# (interpret mode): at most 4.1e-6 read on these fans (float32 summation
# order), the float32 controls 4.2-8.0e-4; the limit sits between, 15x
# and 7x from each
REL_TOL = 6e-5
# the whole generator: a flip crosses every later conv of two stages, so
# kernel and reference drift further apart (1.0e-4 and 3.0e-5 read on the
# two configs below, controls 9.4e-4 and 1.4e-3); at the default init's
# gain of ~1 per conv the ResBlock1 drift nears its control, so these
# tests scale the resblock weights by 0.5
GEN_REL_TOL = 3e-4
RESBLOCK1 = {"upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
             "upsample_initial_channel": 128,
             "resblock_kernel_sizes": [3, 7],
             "resblock_dilation_sizes": [[1, 3], [2, 5]], "num_mels": 16}
V1_SHAPED = {"upsample_rates": [2, 2, 2], "upsample_kernel_sizes": [4, 4, 4],
             "upsample_initial_channel": 128,
             "resblock_kernel_sizes": [3, 7, 11],
             "resblock_dilation_sizes": [[1, 3, 5]] * 3, "num_mels": 16}
V3_SHAPED = {"upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
             "upsample_initial_channel": 128, "resblock": "2",
             "resblock_kernel_sizes": [3, 7],
             "resblock_dilation_sizes": [[1, 2], [2, 6]], "num_mels": 16}
# no stage takes K5 (C = 96, 48 do not divide 128): the staged path alone
STAGED = dict(TINY, upsample_initial_channel=192)


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _jax_generator(cfg, seed):
    gen = jhifigan.HiFiGanGenerator(cfg)
    params = jax.device_get(gen.init_params(jax.random.PRNGKey(seed)))
    return gen, params


def _port_generator(cfg, params):
    gen = hifigan.HiFiGanGenerator(cfg, device="cpu", seed=99)
    gen.load_state_dict(generator_state_dict_from_jax(params), strict=True)
    return gen


# ----------------------------------------------------------------------
# K5's plain version against the Pallas kernel
# ----------------------------------------------------------------------
def _resblocks(rng, c, kernel_sizes, dilation_sizes, two_convs, zero_bias):
    def conv_p(k):
        return {"w": (rng.standard_normal((k, c, c))
                      * (0.5 / np.sqrt(c * k))).astype(np.float32),
                "b": np.zeros(c, np.float32) if zero_bias else
                (0.1 * rng.standard_normal(c)).astype(np.float32)}
    out = []
    for kr, dils in zip(kernel_sizes, dilation_sizes):
        rb = {"convs1": [conv_p(kr) for _ in dils]}
        if two_convs:
            rb["convs2"] = [conv_p(kr) for _ in dils]
        out.append(rb)
    return out


def _port_program(resblocks, dilation_sizes):
    def conv(p):
        return (torch.from_numpy(p["w"].transpose(2, 1, 0).copy()),
                torch.from_numpy(p["b"]))
    return build_mrf_program([
        [[(*conv(rb["convs1"][u]), d)]
         + ([(*conv(rb["convs2"][u]), 1)] if "convs2" in rb else [])
         for u, d in enumerate(dils)]
        for rb, dils in zip(resblocks, dilation_sizes)])


@pytest.mark.parametrize("c,r,two_convs,tile,blocks,kernels,dilations", [
    # the three cases of tests/test_mrf_vocoder.py, then its ragged one
    (32, 4, True, 16, 64, [3, 7], [[1, 3], [2, 5]]),
    (128, 1, True, 1024, 64, [3, 7], [[1, 3], [2, 5]]),
    (64, 2, False, 8, 64, [3, 7], [[1, 3], [2, 5]]),
    (32, 4, True, 8, 21, [3], [[1, 2]]),
], ids=["C32_tiled", "C128", "C64_resblock2", "ragged"])
def test_mrf_plain_matches_pallas_interpret(rng_np, c, r, two_convs, tile,
                                            blocks, kernels, dilations):
    resblocks = _resblocks(rng_np, c, kernels, dilations, two_convs,
                           zero_bias=blocks == 21)
    B, N = 2, blocks * r
    x = rng_np.standard_normal((B, N, c)).astype(np.float32)
    want = np.asarray(jax_fused_mrf(
        jnp.asarray(x.reshape(B, blocks, r * c)),
        jax_program(resblocks, kernels, dilations, two_convs, r),
        tile=tile, interpret=True)).reshape(B, N, c)
    program = _port_program(resblocks, dilations)
    got = fused_mrf(torch.from_numpy(x), program).numpy()
    control = mrf_plain(torch.from_numpy(x), program,
                        dot_dtype=torch.float32).numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= REL_TOL < _rel_l2(control, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def _mrf_from_kernel_copy(x, program):
    """K5's function read from the kernel's copy of the program alone, as
    the kernel walks it: the descriptor rows (k, dilation, first tap,
    flags, chain reach), the bf16 taps in their packed layout (at C = 32,
    64 and 128 (n_taps, C_in / 8, C_out, 8)), the biases; a conv is one
    shifted-row product a tap, zero outside [0, N)."""
    B, N, C = x.shape
    w = program.w_taps.float()
    if w.dim() == 4:
        w = w.permute(0, 1, 3, 2).reshape(w.shape[0], C, C)
    out, chains, cur, t = None, 0, None, None
    for (k, d, tap0, flags, _), bias in zip(program.desc.tolist(),
                                            program.biases):
        if flags & CHAIN_START:
            cur = t = x
        a = torch.nn.functional.leaky_relu(t, LRELU_SLOPE).to(
            torch.bfloat16).float()
        pad = (k - 1) * d // 2
        a = torch.nn.functional.pad(a, (0, 0, pad, pad))
        y = bias.float()
        for i in range(k):
            y = y + a[:, i * d:i * d + N] @ w[tap0 + i]
        if flags & TO_CARRY:
            cur = t = cur + y
            if flags & CHAIN_END:
                out = cur if out is None else out + cur
                chains += 1
        else:
            t = y
    return out * (1.0 / chains)


@pytest.mark.parametrize("c,r,two_convs,tile,blocks,kernels,dilations", [
    (32, 4, True, 16, 64, [3, 7], [[1, 3], [2, 5]]),
    (128, 1, True, 1024, 64, [3, 7], [[1, 3], [2, 5]]),
    (64, 2, False, 8, 64, [3, 7], [[1, 3], [2, 5]]),
    (32, 4, True, 8, 21, [3], [[1, 2]]),
], ids=["C32_tiled", "C128", "C64_resblock2", "ragged"])
def test_packed_taps_match_pallas_interpret(rng_np, c, r, two_convs, tile,
                                            blocks, kernels, dilations):
    """The tensor-core instance's copy of the program -- taps packed as
    (n_taps, C_in / 8, C_out, 8), tap t's [g, n, e] = weight[n, 8 g + e,
    t] -- read back conv by conv as the kernel reads it, against the
    Pallas kernel in interpret mode at the cases of
    test_mrf_plain_matches_pallas_interpret."""
    resblocks = _resblocks(rng_np, c, kernels, dilations, two_convs,
                           zero_bias=blocks == 21)
    B, N = 2, blocks * r
    x = rng_np.standard_normal((B, N, c)).astype(np.float32)
    want = np.asarray(jax_fused_mrf(
        jnp.asarray(x.reshape(B, blocks, r * c)),
        jax_program(resblocks, kernels, dilations, two_convs, r),
        tile=tile, interpret=True)).reshape(B, N, c)
    program = _port_program(resblocks, dilations)
    n_taps = sum(len(dils) * k * (2 if two_convs else 1)
                 for k, dils in zip(kernels, dilations))
    assert program.w_taps.shape == (n_taps, c // 8, c, 8)
    got = _mrf_from_kernel_copy(torch.from_numpy(x), program).numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= REL_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_mrf_program_packs_taps_and_flags(rng_np):
    """The kernel's copy of the program: one descriptor per conv (k,
    dilation, first tap, flags, chain reach), taps (C_in, C_out) in
    bf16, the widest chain's reach as the halo."""
    resblocks = _resblocks(rng_np, 8, [3, 5], [[1, 2], [3]], True, False)
    program = _port_program(resblocks, [[1, 2], [3]])
    desc = program.desc.tolist()
    assert [row[:3] for row in desc] == [[3, 1, 0], [3, 1, 3], [3, 2, 6],
                                         [3, 1, 9], [5, 3, 12], [5, 1, 17]]
    # chain start 1, second conv 2, to carry 4, chain end 8, first chain 16
    assert [row[3] for row in desc] == [17, 22, 16, 30, 1, 14]
    assert [row[4] for row in desc] == [5, 5, 5, 5, 8, 8]
    assert program.halo == 8
    assert program.w_taps.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        program.w_taps[4].float().numpy(),
        torch.from_numpy(resblocks[0]["convs2"][0]["w"][1]).to(
            torch.bfloat16).float().numpy())


# the published V3 generator (ResBlock2) and a narrow V1 whose later stages
# reach C = 16 and 8, beside V1 itself
V3 = {"upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
      "upsample_initial_channel": 256, "resblock": "2",
      "resblock_kernel_sizes": [3, 5, 7],
      "resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]]}
NARROW_V1 = {"upsample_initial_channel": 64}


@pytest.mark.parametrize("cfg", [None, V3, NARROW_V1],
                         ids=["v1", "v3", "narrow_v1"])
def test_plan_mrf_fits_every_stage(cfg):
    """Every K5 stage of V1, V3 and the narrow V1 has an instance within
    one block's shared memory: the tensor-core one at C = 32, 64 and 128,
    the CUDA-core one at C = 8 and 16 (the narrow V1's last stage, C = 4,
    has none: it raises on the card)."""
    gen = hifigan.HiFiGanGenerator(cfg, device="cpu", seed=0)
    programs = gen.mrf_programs()
    assert programs
    for stage, program in programs.items():
        C = gen.stage_channels(stage)
        if C < 8:
            with pytest.raises(ValueError):
                plan_mrf(C, program.halo)
            continue
        plan = plan_mrf(C, program.halo)
        assert plan.instance == ("tensor_core" if C >= 32 else "cuda_core")
        assert 0 < plan.smem_bytes <= SMEM_LIMIT == 227 * 1024
        assert plan.tile_rows % 16 == 0
        assert plan.tile_rows + 2 * program.halo > 0


def test_plan_mrf_v1_tiles():
    """V1's halo of 60 samples: tiles of 128, 384 and 896 samples at C =
    128, 64 and 32, each the largest multiple of 64 (whole m64 output
    tiles) whose rows (tile and both halos) fit the weight ring (5, 8, 8
    stages of 32 input channels of a tap), the bf16 operand (C / 8 channel
    groups of the rows rounded up to 1 mod 8), the float32 carry and the
    ring's barriers in shared memory, and the two warpgroups' sums (4, 8,
    16 m64 tiles a block)."""
    for C, tn, stages, tiles in ((128, 128, 5, 4), (64, 384, 8, 8),
                                 (32, 896, 8, 16)):
        def smem(rows):
            group = rows + (1 - rows) % 8
            return (stages * 64 * C + 2 * C * group + 4 * C * rows
                    + 16 * stages)
        plan = plan_mrf(C, 60)
        assert plan == ("tensor_core", tn, smem(tn + 120))
        assert tn + 120 <= 64 * tiles and smem(tn + 120) <= SMEM_LIMIT
        grown = tn + 64 + 120
        assert smem(grown) > SMEM_LIMIT or grown > 64 * tiles


@pytest.mark.parametrize("C,halo", [(4, 12), (256, 60), (48, 60),
                                    (128, 120), (16, 1000)])
def test_plan_mrf_refuses_what_no_kernel_takes(C, halo):
    with pytest.raises(ValueError, match="no kernel takes"):
        plan_mrf(C, halo)


def test_fused_mrf_on_the_cpu_counts_no_launch(rng_np):
    program = _port_program(_resblocks(rng_np, 8, [3], [[1]], True, False),
                            [[1]])
    before = (fused_mrf.launches, fused_mrf.tc_launches)
    fused_mrf(torch.zeros((1, 40, 8)), program)
    assert (fused_mrf.launches, fused_mrf.tc_launches) == before


# ----------------------------------------------------------------------
# The generator
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [RESBLOCK1, V3_SHAPED],
                         ids=["resblock1", "resblock2"])
def test_generator_matches_apply_blocked_interpret(rng_np, monkeypatch, cfg):
    jgen, params = _jax_generator(cfg, seed=3)
    for rb in params["resblocks"]:
        for convs in rb.values():
            for c in convs:
                c["w"] = 0.5 * c["w"]
    plan, arrays = jhifigan.make_blocked_params(jgen, params)
    assert all("mrf" in s for s in plan["stages"])
    gen = _port_generator(cfg, params)
    assert sorted(gen.mrf_programs()) == list(range(len(plan["stages"])))
    mel = rng_np.standard_normal((2, cfg["num_mels"], 24)).astype(np.float32)
    want = np.asarray(jgen.apply_blocked(plan, arrays, mel, mrf="interpret"))
    got = gen(torch.from_numpy(mel)).numpy()
    monkeypatch.setattr(hifigan, "fused_mrf", lambda x, p: mrf_plain(
        x, p, dot_dtype=torch.float32))
    control = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 24 * 4)
    assert _rel_l2(got, want) <= GEN_REL_TOL < _rel_l2(control, want)


def test_staged_generator_matches_apply(rng_np):
    jgen, params = _jax_generator(STAGED, seed=4)
    gen = _port_generator(STAGED, params)
    assert gen.mrf_programs() == {}
    mel = rng_np.standard_normal((2, STAGED["num_mels"], 24)).astype(
        np.float32)
    want = np.asarray(jax.jit(jgen.apply)(params, mel))
    got = gen(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_seeded_init_draws_the_jax_distributions():
    gen = hifigan.HiFiGanGenerator(V1_SHAPED, device="cpu", seed=0)
    for name, p in gen.named_parameters():
        w = gen.get_submodule(name.rsplit(".", 1)[0])
        bound = 1.0 / np.sqrt(w.fan_in)
        limit = bound * (np.sqrt(3.0) if name.endswith("weight") else 1.0)
        assert p.abs().max().item() <= limit, name
        assert p.abs().max().item() > 0.9 * limit or p.numel() < 64, name
    again = hifigan.HiFiGanGenerator(V1_SHAPED, device="cpu", seed=0)
    other = hifigan.HiFiGanGenerator(V1_SHAPED, device="cpu", seed=1)
    sd, sd_again, sd_other = (g.state_dict() for g in (gen, again, other))
    assert all(torch.equal(sd[k], sd_again[k]) for k in sd)
    assert not torch.equal(sd["conv_pre.weight"], sd_other["conv_pre.weight"])


@pytest.mark.parametrize("weight_norm", [False, True])
@pytest.mark.parametrize("cfg", [TINY, TINY_V3], ids=["resblock1",
                                                       "resblock2"])
def test_load_torch_generator(tmp_path, rng_np, weight_norm, cfg):
    """An official-format checkpoint (names, weight norm) loads strictly;
    the weights equal the JAX loader's, and at widths no stage takes K5
    the output equals the torch reference generator's."""
    cfg = dict(cfg, upsample_initial_channel=192)
    torch.manual_seed(0)
    ref = TorchGenerator(cfg, weight_norm=weight_norm).eval()
    ckpt = tmp_path / "g.pt"
    torch.save({"generator": ref.state_dict()}, ckpt)
    gen = hifigan.load_torch_generator(str(ckpt), cfg, device="cpu")
    _, jparams = jhifigan.load_torch_generator(str(ckpt), cfg)
    want_sd = generator_state_dict_from_jax(jax.device_get(jparams))
    got_sd = gen.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    mel = rng_np.standard_normal((2, cfg["num_mels"], 24)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(mel)).squeeze(1).numpy()
    np.testing.assert_allclose(gen(torch.from_numpy(mel)).numpy(), want,
                               rtol=1e-4, atol=1e-5)
    bad = {k: v for k, v in ref.state_dict().items()
           if not k.startswith("conv_post")}
    torch.save(bad, ckpt)
    with pytest.raises((KeyError, RuntimeError)):
        hifigan.load_torch_generator(str(ckpt), cfg, device="cpu")


def test_vocode_mels_bucketing(rng_np):
    """Bucketed, batched rows equal an unpadded single-row run, and at
    widths no stage takes K5 equal the JAX ``vocode_mels``."""
    jgen, params = _jax_generator(TINY, seed=0)
    gen = _port_generator(TINY, params)
    up = 8
    mels = [rng_np.standard_normal((TINY["num_mels"], t)).astype(np.float32)
            for t in (5, 17, 16, 40)]
    wavs = hifigan.vocode_mels(gen, mels, bucket=16, max_batch=2)
    for mel, wav in zip(mels, wavs):
        assert wav.shape == (mel.shape[1] * up,)
        assert np.isfinite(wav).all()
    solo = gen(torch.from_numpy(mels[2][None])).numpy()[0]
    np.testing.assert_allclose(wavs[2], solo, rtol=1e-5, atol=1e-6)

    jgen, params = _jax_generator(STAGED, seed=0)
    gen = _port_generator(STAGED, params)
    want = jhifigan.vocode_mels(jgen, params, mels, bucket=16, max_batch=2,
                                blocked=False)
    got = hifigan.vocode_mels(gen, mels, bucket=16, max_batch=2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# Streaming (the cases of tests/test_streaming_vocoder.py)
# ----------------------------------------------------------------------
# stream vs full run of the port: every kept sample sees the same inputs,
# and at the lengths below the CPU reads them bit-equal; at other lengths
# its float32 convs may pick another algorithm for the full run (at T=300,
# 2003 samples moved by up to 4.1e-4 after flipped bf16 roundings)
STREAM_TOL = 1e-3


@pytest.fixture(scope="module")
def tiny_gen():
    _, params = _jax_generator(TINY, seed=7)
    return _port_generator(TINY, params)


def _full_run(gen, mel, pad):
    T = mel.shape[1]
    ext = np.full((mel.shape[0], T + pad), np.log(1e-5), np.float32)
    ext[:, :T] = mel
    return gen(torch.from_numpy(ext[None])).numpy()[0, :T * 8]


def _mel(rng, t):
    return rng.standard_normal((TINY["num_mels"], t)).astype(np.float32)


@pytest.mark.parametrize("cfg", [V1_SHAPED, V3_SHAPED, TINY, jhifigan.V1_CONFIG])
def test_halo_bound_matches_jax(cfg):
    gen = hifigan.HiFiGanGenerator(cfg, device="cpu")
    assert mel_halo_frames(gen) == jstreaming.mel_halo_frames(
        jhifigan.HiFiGanGenerator(cfg))


def test_stream_equals_full_run(tiny_gen, rng_np):
    T = 75  # several chunks and a ragged tail
    mel = _mel(rng_np, T)
    sv = StreamingVocoder(tiny_gen, chunk_frames=16)
    assert sv.halo == mel_halo_frames(tiny_gen)
    chunks = list(sv.stream(mel))
    assert len(chunks) == -(-T // 16)
    got = np.concatenate(chunks)
    want = _full_run(tiny_gen, mel, sv.window)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=STREAM_TOL)


def test_insufficient_halo_breaks_seams(tiny_gen, rng_np):
    mel = _mel(rng_np, 75)
    want = _full_run(tiny_gen, mel, StreamingVocoder(tiny_gen).window)
    sv = StreamingVocoder(tiny_gen, chunk_frames=16, halo_frames=1)
    got = np.concatenate(list(sv.stream(mel)))
    assert np.abs(got - want).max() > 30 * STREAM_TOL


def test_short_and_tail_lengths(tiny_gen, rng_np):
    """One window up to ``window - halo`` frames; the lengths just past it
    take the windowed loop, and both keep the floor tail exact."""
    sv = StreamingVocoder(tiny_gen, chunk_frames=16)
    for T in (sv.window - sv.halo, sv.window - sv.halo + 1, sv.window - 1):
        mel = _mel(rng_np, T)
        chunks = list(sv.stream(mel))
        assert (len(chunks) == 1) == (T + sv.halo <= sv.window)
        got = np.concatenate(chunks)
        want = _full_run(tiny_gen, mel, sv.window)
        assert got.shape == want.shape == (T * 8,)
        np.testing.assert_allclose(got, want, rtol=0, atol=STREAM_TOL)


def test_window_plan_matches_jax(tiny_gen):
    jgen, params = _jax_generator(TINY, seed=7)
    jsv = jstreaming.StreamingVocoder(jgen, params, chunk_frames=16,
                                      blocked=False)
    sv = StreamingVocoder(tiny_gen, chunk_frames=16)
    assert (sv.halo, sv.window) == (jsv.halo, jsv.window)
    for T in (sv.window, sv.window + 1, 75, 161):
        assert sv.windows(T) == jsv.windows(T)


def test_stream_ignores_junk_beyond_true_length(tiny_gen, rng_np):
    T = 75
    mel = _mel(rng_np, T)
    sv = StreamingVocoder(tiny_gen, chunk_frames=16)
    want = _full_run(tiny_gen, mel, sv.window)
    padded = np.concatenate([mel, 7.0 * _mel(rng_np, 13)], axis=1)
    got = np.concatenate(list(sv.stream(padded, n_frames=T)))
    np.testing.assert_allclose(got, want, rtol=0, atol=STREAM_TOL)


# ----------------------------------------------------------------------
# The vocoder's passes through the generator's graph cache
# ----------------------------------------------------------------------
def _eager_stream(gen, sv, mel):
    """The stream's windows run eagerly, one ``gen(...)`` each: the
    windows and crops of ``StreamingVocoder.stream``."""
    T = mel.shape[1]
    ext = np.full((mel.shape[0], T + sv.window), np.log(1e-5), np.float32)
    ext[:, :T] = mel
    if T + sv.halo <= sv.window:
        plan = [(0, 0, T)]
    else:
        plan = sv.windows(T)
    return [gen(torch.from_numpy(ext[None, :, ws:ws + sv.window]))
            [0, rel * 8:(rel + n) * 8].numpy() for ws, rel, n in plan]


@pytest.mark.parametrize("T", [20, 75])
def test_stream_through_the_window_graph_equals_eager_and_jax(rng_np, T):
    """Every window of a stream is one pass of the generator's "window"
    entry (one shape, one entry); the chunks equal the windows run eagerly
    and, at widths no stage takes K5, the JAX ``StreamingVocoder``."""
    jgen, params = _jax_generator(STAGED, seed=3)
    gen = _port_generator(STAGED, params)
    mel = rng_np.standard_normal((STAGED["num_mels"], T)).astype(np.float32)
    sv = StreamingVocoder(gen, chunk_frames=16)
    chunks = list(sv.stream(mel))
    eager = _eager_stream(gen, sv, mel)
    assert len(chunks) == len(eager)
    for got, want in zip(chunks, eager):
        np.testing.assert_array_equal(got, want)
    cache = gen.graphs()
    assert cache.keys() == {("window", torch.float32)} and len(cache) == 1
    jsv = jstreaming.StreamingVocoder(jgen, params, chunk_frames=16,
                                      blocked=False)
    want = np.concatenate([np.asarray(c) for c in jsv.stream(mel)])
    np.testing.assert_allclose(np.concatenate(chunks), want, rtol=1e-4,
                               atol=1e-5)


def test_stream_chunks_survive_outputs_that_alias(tiny_gen, rng_np,
                                                  monkeypatch):
    """A replay writes every window into one static output; the stream
    copies each crop into one of its two host buffers before the next
    window and each chunk out of its buffer before the buffer takes the
    window after next, so the chunks (collected, not consumed one by one)
    still equal the eager ones."""
    mel = _mel(rng_np, 75)
    sv = StreamingVocoder(tiny_gen, chunk_frames=16)
    want = list(sv.stream(mel))
    static = {}
    replayed = hifigan.HiFiGanGenerator.replayed

    def aliasing(self, mel, dtype=torch.float32, label="vocode"):
        out = replayed(self, mel, dtype, label)
        if label not in static:
            static[label] = out.clone()
        return static[label].copy_(out)

    monkeypatch.setattr(hifigan.HiFiGanGenerator, "replayed", aliasing)
    buffers = []
    made = StreamingVocoder._buffers

    def counted(self):
        buffers.append(made(self))
        return buffers[-1]

    monkeypatch.setattr(StreamingVocoder, "_buffers", counted)
    got = list(sv.stream(mel))
    assert len(got) == len(want) == 5 and len(buffers) == 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_vocode_mels_through_the_cache_equals_eager(rng_np):
    """``vocode_mels`` runs one entry per (rows, padded length) and gives
    what the generator called eagerly on the same padded batch gives."""
    _, params = _jax_generator(TINY, seed=0)
    gen = _port_generator(TINY, params)
    mels = [_mel(rng_np, t) for t in (5, 17, 16, 40, 9)]
    wavs = hifigan.vocode_mels(gen, mels, bucket=16, max_batch=2)
    cache = gen.graphs()
    sigs = sorted(s[1][0][0] for _, s in cache.entries)
    # 16: rows (5, 16), then (9,); 32: (17,); 48: (40,)
    assert sigs == sorted([(2, 16, 16), (1, 16, 16), (1, 16, 32),
                           (1, 16, 48)])
    assert cache.keys() == {("vocode", torch.float32)}
    for mel, wav in zip(mels, wavs):
        t_pad = max(-(-mel.shape[1] // 16) * 16, 16)
        ext = np.full((1, 16, t_pad), np.log(1e-5), np.float32)
        ext[0, :, :mel.shape[1]] = mel
        solo = gen(torch.from_numpy(ext)).numpy()[0, :mel.shape[1] * 8]
        np.testing.assert_allclose(wav, solo, rtol=1e-5, atol=1e-6)
    again = hifigan.vocode_mels(gen, mels, bucket=16, max_batch=2)
    assert gen.graphs() is cache and len(cache) == 4
    for a, b in zip(again, wavs):
        np.testing.assert_array_equal(a, b)


def test_an_in_place_weight_update_drops_the_vocoder_graphs(rng_np):
    """A parameter changed in place (K5's programs repack on it) empties
    the generator's cache, so no replay reads new staged-conv weights
    beside stale K5 programs; the next pass runs on the new weights."""
    _, params = _jax_generator(TINY, seed=0)
    gen = _port_generator(TINY, params)
    mel = _mel(rng_np, 32)[None]
    before = gen.replayed(mel).clone()
    cache = gen.graphs()
    assert len(cache) == 1 and gen.graphs() is cache
    with torch.no_grad():
        gen.resblocks[0].convs1[0].weight.mul_(0.5)
    fresh = gen.graphs()
    assert fresh is not cache and len(fresh) == 0
    after = gen.replayed(mel)
    np.testing.assert_array_equal(after.numpy(),
                                  gen(torch.from_numpy(mel)).numpy())
    assert not torch.equal(after, before)
    with torch.no_grad():  # a staged conv's weight: dropped as well
        gen.conv_pre.weight.mul_(0.5)
    assert len(gen.graphs()) == 0
