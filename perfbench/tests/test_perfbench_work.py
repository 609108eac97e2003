"""Each kernel's and the model's work counts, against a hand count at one
shape."""

import pytest

import tiny  # noqa: F401  (the import path)
from work import k1, k2, k3, k5, model, peaks

V1 = tiny.load("configs", "daftexprt_hifigan_v1")


def test_k1_one_row():
    # one row of 10 of 16 positions, E=128, C=1024: QKV + output
    # projection 2 * 10 * 4 * 128^2, two k=3 convs 2 * 10 * 6 * 128 * 1024,
    # scores and values 4 * 10^2 * 128
    flops, nbytes = k1.work([10], 16, 128, 1024)
    assert flops == 2 * 10 * 4 * 128 ** 2 + 2 * 10 * 6 * 128 * 1024 \
        + 4 * 100 * 128
    # x and out in f32, 4 E^2 + 6 E C bf16 weights, FiLM row, length
    assert nbytes == 2 * 16 * 128 * 4 + (4 * 128 ** 2 + 6 * 128 * 1024) * 2 \
        + 2 * 128 * 4 + 4


@pytest.mark.parametrize("backward", [False, True])
def test_k2_pairs(backward):
    # two rows of T=8 with 3 and 8 valid keys: 8 * (3 + 8) pairs
    flops, _ = k2.work([3, 8], 8, 128, 2, backward)
    assert flops == (10 if backward else 4) * 128 * 8 * 11


@pytest.mark.parametrize("backward", [False, True])
def test_k3_real_rows(backward):
    flops, _ = k3.work([5, 7], 16, 128, 1024, backward)
    assert flops == (36 if backward else 12) * 12 * 128 * 1024


def test_k5_fan_of_v1():
    taps, convs = k5.fan(V1["vocoder"])
    assert (taps, convs) == (2 * 3 * (3 + 7 + 11), 18)
    flops, nbytes = k5.work([100, 50], 2, 128, 64, taps, convs)
    assert flops == 2 * 150 * 64 * 64 * 126
    assert nbytes == 2 * 2 * 128 * 64 * 4 + 126 * 64 * 64 * 2 + 18 * 64 * 4


def test_bound_is_the_larger():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_vocoder_flops_of_one_frame():
    v = V1["vocoder"]
    # conv_pre 7 taps 80 -> 512; per stage the transposed conv at the input
    # rate and 126 taps of C^2 at the output rate; conv_post 7 taps 32 -> 1
    want = 2 * 7 * 80 * 512
    n, c = 1, 512
    for u, k in zip(v["upsample_rates"], v["upsample_kernel_sizes"]):
        want += 2 * n * k * c * (c // 2)
        n, c = n * u, c // 2
        want += 2 * n * c * c * 126
    want += 2 * n * 7 * 32
    assert model.vocoder(v, 1) == pytest.approx(want)


def test_train_step_is_three_forwards():
    cfg = tiny.load("configs", "daftexprt_flagship")
    fwd = model.prosody_encoder(cfg, 100) + model.acoustic(cfg, 20, 100) \
        + model.speaker_classifier(cfg)
    assert model.train_step(cfg, [(20, 100)]) == pytest.approx(3 * fwd)
