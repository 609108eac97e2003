"""The comparison that decides ``correct`` fails what it should, at a tiny
size on the CPU: each cell's control (the reference at float8 operands in
the program's place), and a run with its timed path broken underneath,
which skips only the look for a card: an answer altered where it is made
(serving, bulk mels: every answer, or only the last row of each batch),
a step that returns its state unchanged and a step that leaves half of
each micro-batch out (training). The limits are the cells' own."""

import pytest
import torch

import tiny
from drivers import mel, serve, train
from harness import corpus
from run import Context

SEED = 2 ** 31 + 4242


@pytest.fixture
def short_sentences(monkeypatch):
    """The mixes' sentences cut to what the tiny models' buckets hold."""
    monkeypatch.setattr(corpus, "corpus_lengths", tiny.capped_lengths)


def ctx_of(tmp_path, config, traffic, fault=None, max_frames=512,
           seconds=0.5):
    cfg = tiny.tiny_model(tiny.load("configs", config), max_frames)
    tmp_path.mkdir(parents=True, exist_ok=True)
    return Context(cfg, traffic, SEED, seconds, False, 1, device="cpu",
                   scratch=tmp_path, fault=fault)


def test_serve_control_fails(tmp_path, short_sentences):
    ctx = ctx_of(tmp_path, "daftexprt_hifigan_v1", tiny.serve_traffic(),
                 max_frames=128)
    assert not serve.control(ctx).correct


def test_serve_sound_and_altered(tmp_path, short_sentences):
    sound = serve.run(ctx_of(tmp_path / "a", "daftexprt_hifigan_v1",
                             tiny.serve_traffic(), max_frames=128))
    assert sound["checks"].correct and sound["attempted"] > 0

    def alter(service):
        inner = service.engine.run_cached_to_audio

        def wrapped(*args):
            wavs, lens, overflow = inner(*args)
            return [w * 1.1 for w in wavs], lens, overflow
        service.engine.run_cached_to_audio = wrapped

    broken = serve.run(ctx_of(tmp_path / "b", "daftexprt_hifigan_v1",
                              tiny.serve_traffic(), alter, max_frames=128))
    assert not broken["checks"].correct


def test_mel_control_fails(tmp_path, short_sentences):
    ctx = ctx_of(tmp_path, "daftexprt_flagship", tiny.mel_traffic(),
                 max_frames=128)
    assert not mel.control(ctx).correct


def test_mel_sound_and_altered(tmp_path, short_sentences):
    # a window long enough on the CPU to reach every batch it checks
    sound = mel.run(ctx_of(tmp_path / "a", "daftexprt_flagship",
                           tiny.mel_traffic(), max_frames=128, seconds=3.0))
    assert sound["checks"].correct

    def alter(run_call):
        def wrapped(*args, **kw):
            enc, (m, lens, overflow), w = run_call(*args, **kw)
            return enc, (m * 1.1, lens, overflow), w
        return wrapped

    broken = mel.run(ctx_of(tmp_path / "b", "daftexprt_flagship",
                            tiny.mel_traffic(), alter, max_frames=128,
                            seconds=3.0))
    assert not broken["checks"].correct


def serve_last_row(service):
    """Each engine call's last real row answered wrong (sign flipped)."""
    inner = service.engine.run_cached_to_audio

    def wrapped(inputs, pitch_transform, film_keys):
        wavs, lens, overflow = inner(inputs, pitch_transform, film_keys)
        last = max(i for i, k in enumerate(film_keys) if k is not None)
        wavs = list(wavs)
        wavs[last] = wavs[last] * -1
        return wavs, lens, overflow
    service.engine.run_cached_to_audio = wrapped


def test_serve_last_row_altered_fails(tmp_path, short_sentences):
    res = serve.run(ctx_of(tmp_path, "daftexprt_hifigan_v1",
                           tiny.serve_traffic(), serve_last_row,
                           max_frames=128))
    assert not res["checks"].correct


def mel_last_row(run_call):
    """Each call's last row answered wrong (its frames reversed)."""
    def wrapped(*args, **kw):
        enc, (m, lens, overflow), w = run_call(*args, **kw)
        m = m.copy()
        m[-1] = m[-1][:, ::-1]
        return enc, (m, lens, overflow), w
    return wrapped


def test_mel_last_row_altered_fails(tmp_path, short_sentences):
    res = mel.run(ctx_of(tmp_path, "daftexprt_flagship", tiny.mel_traffic(),
                         mel_last_row, max_frames=128, seconds=3.0))
    assert not res["checks"].correct


def test_train_control_fails(tmp_path):
    ctx = ctx_of(tmp_path, "daftexprt_flagship", tiny.train_traffic())
    assert not train.control(ctx).correct


def unchanged(step, model):
    """A step that leaves the parameters and moments as they were."""
    def wrapped(batch, gen, it):
        keep = [t.detach().clone() for t in
                list(model.parameters()) + step.optimizer.mu
                + step.optimizer.nu]
        out = step(batch, gen, it)
        with torch.no_grad():
            for t, k in zip(list(model.parameters()) + step.optimizer.mu
                            + step.optimizer.nu, keep):
                t.copy_(k)
        return out
    wrapped.optimizer, wrapped.graphs = step.optimizer, step.graphs
    return wrapped


def half_batch(step, model):
    """A step over the first half of each micro-batch's rows alone, its
    means taken over them."""
    def wrapped(batch, gen, it):
        half = batch["symbols"].shape[1] // 2
        return step({k: v[:, :half] for k, v in batch.items()}, gen, it)
    wrapped.optimizer, wrapped.graphs = step.optimizer, step.graphs
    return wrapped


@pytest.mark.parametrize("fault", [unchanged, half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_train_fault_fails(tmp_path, fault):
    res = train.run(ctx_of(tmp_path, "daftexprt_flagship",
                           tiny.train_traffic(), fault))
    assert not res["checks"].correct
