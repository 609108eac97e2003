"""The plain reference agrees with the program's CPU path (the kernels'
plain versions) at a tiny size: the acoustic model's FiLMs and mel, the
HiFi-GAN generator, and three training steps with dropout."""

import numpy as np
import pytest
import torch

import tiny
from drivers import serve
from harness import common, model_files
from reference import daftexprt as R
from reference import hifigan as H
from reference.numerics import Numerics


@pytest.fixture(scope="module")
def acoustic(tmp_path_factory):
    from daft_exprt_tpu_torch.models.daft_exprt import DaftExprt

    cfg = tiny.tiny_model(tiny.load("configs", "daftexprt_hifigan_v1"))
    hp = model_files.hparams(cfg, str(tmp_path_factory.mktemp("exp")))
    P = model_files.acoustic_weights(cfg, 2 ** 33 + 5, "cpu")
    model = DaftExprt(hp, device="cpu")
    model.load_state_dict(P, strict=True)
    return cfg, P, model


def test_inference_matches_the_program(acoustic):
    cfg, P, model = acoustic
    text, ids = model_files.random_sentence(np.random.default_rng(1), 20,
                                            cfg["symbols"])
    ref = model_files.style_bank(cfg, 3, 1, [100])[0]
    e, p, m = serve.padded_reference(ref, 128, "cpu")
    stats = model_files.pitch_stats(cfg, "cpu")
    sym = torch.zeros((1, 64), dtype=torch.int32)
    sym[0, :len(ids)] = torch.as_tensor(ids)
    L = torch.tensor([len(ids)], dtype=torch.int32)
    spk = torch.tensor([3], dtype=torch.int32)
    t = torch.tensor([100], dtype=torch.int32)
    with torch.no_grad():
        got_f = model.inference_film(e, p, m, t, spk)
        want_f = R.films(Numerics("f32"), P, cfg, e, p, m, t, spk)
        for a, b in zip(got_f, want_f):
            assert common.rel_l2(a.numpy(), b.numpy()) < 1e-5
        ones, zeros = torch.ones((1, 64)), torch.zeros((1, 64))
        _, (mel, n, _), _ = model.inference(
            (sym, ones, ones, zeros, L, e, p, m, t, spk), "add", stats[0],
            stats[1], cfg["max_frames"], films=got_f)
        want, n_ref = R.synthesize(Numerics("f32"), P, cfg, cfg["audio"],
                                   sym, L, want_f, stats[0], stats[1], spk,
                                   cfg["max_frames"])
    k = int(n_ref[0])
    assert int(n[0]) == k > 0
    assert common.rel_l2(mel[0, :, :k].numpy(), want[0, :, :k].numpy()) \
        < 1e-5


def test_vocoder_matches_the_program():
    from daft_exprt_tpu_torch.vocoder.hifigan import HiFiGanGenerator

    cfg = tiny.tiny_model(tiny.load("configs", "daftexprt_hifigan_v1"))
    V = model_files.vocoder_weights(cfg, 11, "cpu")
    gen = HiFiGanGenerator(cfg["vocoder"], device="cpu")
    gen.load_state_dict(V, strict=True)
    mel = torch.randn(2, 80, 40, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = gen.staged(mel).numpy()
        want = H.generate(Numerics("f32"), V, cfg["vocoder"], mel).numpy()
    assert common.rel_l2(got, want) < 1e-5


def test_durations_follow_the_framing_rule():
    from daft_exprt_tpu_torch.ops.durations import durations_to_int_frames

    secs = torch.tensor([[0.078125] * 30 + [0.0] * 2,
                         [0.03, 0.0, 0.2, 0.01] + [0.05] * 28])
    got = durations_to_int_frames(secs, 22050, 1024, 256, True)
    want = R.durations_to_frames(secs, 22050, 1024, 256)
    assert torch.equal(got.long(), want.long())


def test_training_steps_match_the_program(tmp_path):
    from run import Context
    from drivers import train

    cfg = tiny.tiny_model(tiny.load("configs", "daftexprt_flagship"))
    ctx = Context(cfg, tiny.train_traffic(), 2 ** 32 + 77, 0.5, False, 1,
                  device="cpu", scratch=tmp_path)
    res = train.run(ctx)
    got = dict((n, v) for n, v, _ in res["checks"].rows)
    # float32 on both sides, the same dropout: rounding only
    assert got["loss_terms_step1_rel"] < 1e-5
    assert got["first_grad_median_leaf_gap"] < 1e-5
    assert got["change_median_leaf_gap"] < 1e-3
    assert res["e2e"]["train_frames_per_s"] > 0
