"""The port's compiled-graph layer (``inference/graphs.py``) against the
JAX engine's executable cache, on the CPU.

On the CPU an entry runs its pass eagerly, so these tests hold everything
but ``torch.cuda.CUDAGraph`` itself: the cache's keys against the JAX
engine's ``_compiled`` keys after the same calls, entry reuse by argument
signature, the graphs dropped by ``update_params`` and ``attach_vocoder``,
outputs bit-equal to ``DaftExprt.inference`` called directly, pass
counting, and (with a stand-in for the graph) the launch counters through
a capture and a replay. Models are ``tests/helpers.tiny_hparams`` at
float32 with the duration head pinned, as in
``tests/test_torch_serving_audio.py``.
"""

import jax
import numpy as np
import pytest
import torch

from helpers import pinned_init_params, tiny_hparams
from test_torch_model import _batch, _collate
from test_torch_serving_audio import KEYS, MAX_FRAMES, VOC_CFG, _hparams

from daft_exprt_tpu.inference.engine import InferenceEngine as JaxEngine
from daft_exprt_tpu.models.daft_exprt import DaftExprt as JaxDaftExprt
from daft_exprt_tpu.vocoder import hifigan as jhifigan
from daft_exprt_tpu_torch.convert import (generator_state_dict_from_jax,
                                          state_dict_from_jax)
from daft_exprt_tpu_torch.inference import graphs
from daft_exprt_tpu_torch.inference.engine import InferenceEngine
from daft_exprt_tpu_torch.inference.inputs import (collate_inference_batch,
                                                   pitch_stats_arrays)
from daft_exprt_tpu_torch.models.daft_exprt import DaftExprt
from daft_exprt_tpu_torch.ops.fft_block import fused_fft_block
from daft_exprt_tpu_torch.ops.mrf_vocoder import fused_mrf
from daft_exprt_tpu_torch.vocoder.hifigan import MEL_FLOOR, HiFiGanGenerator

BUCKETS = [128, MAX_FRAMES]  # two rungs: fewer JAX compiles
# per-symbol stats far below the pinned 0.12 s: speculation undershoots
LOW_STATS = {"symbols": {s: {"dur_mean": 0.005, "dur_std": 0.001}
                         for s in tiny_hparams().symbols}}


@pytest.fixture(scope="module")
def setup():
    jhp, thp = _hparams()
    params = jax.device_get(pinned_init_params(JaxDaftExprt(jhp), seed=0))
    other = jax.device_get(pinned_init_params(JaxDaftExprt(jhp), seed=3))
    jgen = jhifigan.HiFiGanGenerator(VOC_CFG)
    vparams = jax.device_get(jgen.init_params(jax.random.PRNGKey(1)))
    return params, other, jgen, vparams


def _model(thp, params):
    model = DaftExprt(thp, device="cpu", seed=1)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _generator(vparams):
    gen = HiFiGanGenerator(VOC_CFG, device="cpu", seed=5)
    gen.load_state_dict(generator_state_dict_from_jax(vparams), strict=True)
    return gen


def _request(hp, B, n_symbols, ref_frames, seed=0):
    """Collated inputs of B rows: row 0 has ``n_symbols`` symbols and a
    ``ref_frames``-frame reference."""
    rng = np.random.default_rng(seed)
    sentences, refs = [], []
    for b in range(B):
        n = n_symbols if b == 0 else max(1, n_symbols - b)
        sentences.append([hp.symbols[i]
                          for i in rng.integers(1, hp.n_symbols, size=n)])
        t = ref_frames if b == 0 else max(1, ref_frames - 3 * b)
        refs.append({"energy": np.abs(rng.standard_normal(t)) + 1.0,
                     "pitch": rng.standard_normal(t),
                     "mel_spec": rng.standard_normal((hp.n_mel_channels, t))})
    inputs, _ = collate_inference_batch(sentences, None, None, None, "add",
                                        refs, [b % 3 for b in range(B)], hp)
    return inputs


def _equal(a, b):
    """Bit-equal nests of numpy arrays (None where None)."""
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_keys_equal_the_jax_engines_after_the_same_calls(setup):
    """(a) speculate with a re-run, measure, run_cached,
    run_cached_to_audio and warmup: the port's graph keys are the JAX
    engine's ``_compiled`` keys, the JAX fused key's ``packed`` flag
    aside. (With a vocoder the port's warmup also captures the fused
    passes with films of every bucket, which the JAX warmup leaves to
    their first call; the ``run_cached`` calls before it gave the JAX
    engine those keys.)"""
    params, _, jgen, vparams = setup
    jhp, thp = _hparams(stats=LOW_STATS)
    jeng = JaxEngine(JaxDaftExprt(jhp), params, jhp,
                     out_frame_buckets=BUCKETS)
    engine = InferenceEngine(_model(thp, params), None, thp, device="cpu",
                             out_frame_buckets=BUCKETS)
    inputs = _collate(jhp, thp, _batch(thp, "add", seed=3))
    small = engine._buckets.speculate(inputs)
    for eng in (jeng, engine):
        out = eng.run(inputs, "add", want_weights=False)
        assert small < MAX_FRAMES == out[1][0].shape[-1]  # re-ran
        eng._buckets.policy = "measure"
        eng.run(inputs, "multiply")
        eng._buckets.policy = "speculate"
        eng.run_cached(inputs, "add", KEYS)
    engine.attach_vocoder(_generator(vparams))
    jeng.attach_vocoder(jgen, vparams)
    assert jeng.out_frame_buckets == engine.out_frame_buckets == BUCKETS
    for eng in (jeng, engine):
        eng.run_cached_to_audio(inputs, "multiply", KEYS)
        eng.warmup(("add",), batch_sizes=(1,))

    def without_packed(key):
        return key[:4] if isinstance(key, tuple) and key[0] == "fused" \
            else key

    want = {without_packed(k) for k in jeng._compiled}
    assert engine.graphs.keys() == want
    assert want >= {("fused", "add", small, False),
                    ("fused", "add", MAX_FRAMES, False),
                    ("prosody", "multiply", False), "film",
                    ("audio", "multiply", small), ("audio", "add", 128)}


def test_a_signature_reuses_its_entry(setup):
    """(b) the same signature reuses its entry; a new B, symbol bucket or
    reference bucket adds one; (e) every call counts its passes."""
    params, *_ = setup
    jhp, thp = _hparams()
    engine = InferenceEngine(_model(thp, params), None, thp, device="cpu")
    keys = [("s", 0), ("t", 1)]

    def run_cached(inputs, keys):
        before = engine.passes, engine.film_batches, len(engine.graphs)
        engine.run_cached(inputs, "add", keys, want_weights=False)
        return tuple(a - b for a, b in zip(
            (engine.passes, engine.film_batches, len(engine.graphs)),
            before))

    base = _request(thp, 2, 10, 40)
    assert run_cached(base, keys) == (1, 1, 2)  # film, fused: new
    again = _request(thp, 2, 12, 50, seed=1)  # same buckets, other values
    assert run_cached(again, keys) == (1, 0, 0)  # films cached
    engine.films.clear()
    assert run_cached(again, keys) == (1, 1, 0)  # the film entry reused
    assert run_cached(_request(thp, 3, 10, 40), keys + [("u", 2)]) \
        == (1, 1, 2)  # B=3: film and fused
    assert run_cached(_request(thp, 2, 20, 40), keys) \
        == (1, 0, 1)  # L: 16 -> 32 symbols, the fused entry alone
    assert run_cached(_request(thp, 2, 10, 70), [("v", 0), ("w", 1)]) \
        == (1, 1, 1)  # the reference bucket: 64 -> 128 frames, film alone
    sigs = [sig for key, sig in engine.graphs.entries if key == "film"]
    assert len(sigs) == 3 and len(engine.graphs.keys()) == 2
    assert engine.graphs.keys() == {"film", ("fused", "add", 256, True)}


def test_update_params_drops_every_graph(setup):
    """(c) ``update_params`` empties the cache, and the next request
    equals a fresh engine's with the new weights."""
    params, other, *_ = setup
    jhp, thp = _hparams()
    inputs = _collate(jhp, thp, _batch(thp, "add", seed=4))
    engine = InferenceEngine(_model(thp, params), None, thp, device="cpu")
    first = engine.run_cached(inputs, "add", KEYS)
    engine.run(inputs, "add")
    assert len(engine.graphs) == 3
    state = state_dict_from_jax(other)
    engine.update_params(state)
    assert len(engine.graphs) == 0 and len(engine.films) == 0
    got = engine.run_cached(inputs, "add", KEYS)
    fresh = InferenceEngine(DaftExprt(thp, device="cpu", seed=9), state, thp,
                            device="cpu")
    _equal(got, fresh.run_cached(inputs, "add", KEYS))
    assert not np.array_equal(got[1][0], first[1][0])


def test_attach_vocoder_drops_the_audio_graphs(setup):
    params, _, _, vparams = setup
    jhp, thp = _hparams()
    inputs = _collate(jhp, thp, _batch(thp, "add", seed=5))
    engine = InferenceEngine(_model(thp, params), None, thp, device="cpu")
    gen = _generator(vparams)
    engine.attach_vocoder(gen)
    engine.run_cached_to_audio(inputs, "add", KEYS)
    engine.run_cached(inputs, "add", KEYS)
    assert {k[0] if isinstance(k, tuple) else k
            for k in engine.graphs.keys()} == {"film", "audio", "fused"}
    engine.attach_vocoder(gen, torch.bfloat16)
    assert {k[0] if isinstance(k, tuple) else k
            for k in engine.graphs.keys()} == {"film", "fused"}


def test_warmup_with_a_vocoder_captures_every_serving_pass(setup):
    """With a vocoder, ``warmup`` captures the audio pass and the fused
    pass with films (``/stream``'s) of every (B, transform, bucket), and
    the FiLM batch at every reference bucket it is given: requests of
    those shapes then add no entry."""
    params, _, _, vparams = setup
    jhp, thp = _hparams()
    engine = InferenceEngine(_model(thp, params), None, thp, device="cpu",
                             out_frame_buckets=BUCKETS)
    engine.attach_vocoder(_generator(vparams))
    engine.warmup(("add", "multiply"), n_symbols=16, ref_frames=[64, 128],
                  batch_sizes=(1, 2))
    want = {"film"} | {(kind, pt, T) + ((True,) if kind == "fused" else ())
                       for kind in ("fused", "audio")
                       for pt in ("add", "multiply") for T in BUCKETS}
    assert engine.graphs.keys() == want
    films = [sig for key, sig in engine.graphs.entries if key == "film"]
    assert len(films) == 2 * 2  # (B, reference bucket)
    assert len(engine.graphs) == 2 * 2 + 2 * 2 * 2 * len(BUCKETS)
    assert engine.film_batches == 2 * 2 and not engine.films.entries
    before = len(engine.graphs)
    for B, ref in ((2, 40), (1, 70), (2, 100)):
        keys = [(f"style_{B}_{ref}", b) for b in range(B)]
        inputs = _request(thp, B, 10, ref, seed=B)
        engine.run_cached_to_audio(inputs, "multiply", keys)
        engine.run_cached(inputs, "add", keys, want_weights=False)
    assert len(engine.graphs) == before


@pytest.mark.parametrize("policy", ["speculate", "measure"])
def test_outputs_equal_the_model_called_directly(setup, policy):
    """(d) ``run`` and ``run_cached_to_audio`` through the cache, first
    call and reuse, bit-equal to ``DaftExprt.inference`` (and the
    generator on the floor-padded mel) called directly."""
    params, _, _, vparams = setup
    jhp, thp = _hparams()
    model = _model(thp, params)
    engine = InferenceEngine(model, None, thp, device="cpu",
                             bucket_policy=policy)
    means, stds = pitch_stats_arrays(thp)
    for seed in (6, 7):  # the second call reuses every entry
        inputs = _collate(jhp, thp, _batch(thp, "multiply", seed=seed))
        got = engine.run(inputs, "multiply")
        T = got[1][0].shape[-1]
        enc, dec, weights = model.inference(
            [torch.from_numpy(a) for a in inputs], "multiply", means, stds,
            max_frames=T)
        _equal(got, graphs.to_host((enc, dec, weights)))
    assert len(engine.graphs) == (1 if policy == "speculate" else 2)

    gen = _generator(vparams)
    engine.attach_vocoder(gen)
    for seed in (8, 9):  # new styles: each request's own films
        keys = [(seed, b) for b in range(3)]
        inputs = _collate(jhp, thp, _batch(thp, "add", seed=seed))
        wavs, lens, overflow = engine.run_cached_to_audio(inputs, "add",
                                                          keys)
        T = engine._buckets.speculate(inputs)
        films = model.inference_film(*(torch.from_numpy(a)
                                       for a in inputs[5:10]))
        _, (mel, out_lens, over), _ = model.inference(
            [torch.from_numpy(a) for a in inputs], "add", means, stds,
            max_frames=T, films=films)
        valid = torch.arange(T)[None, :] < out_lens[:, None]
        audio = gen(torch.where(valid[:, None, :], mel, MEL_FLOOR)).numpy()
        np.testing.assert_array_equal(lens, out_lens.numpy())
        np.testing.assert_array_equal(overflow, over.numpy())
        for b in range(3):
            np.testing.assert_array_equal(wavs[b],
                                          audio[b, :int(lens[b]) * 256])


def test_capture_and_replay_keep_the_launch_counters(monkeypatch):
    """The CUDA path's bookkeeping, with a stand-in for the graph: the
    first call runs eagerly (counted by the wrappers as launches) and
    captures (counted as captured, noted on the entry); a replay leaves
    the wrappers' counters alone and adds the entry's captured counts to
    the cache's derived ``replayed``; ``keep`` is taken once a capture; a
    capture that fails, in the pass or at its end, raises, keeps the
    eager run's launches alone and leaves no entry; dropping the last
    entry takes a new pool id (the old pool is released)."""

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    class Capture:
        active = False
        fail_at_exit = False

        def __init__(self, graph, pool=None, capture_error_mode=None):
            assert capture_error_mode == "thread_local"

        def __enter__(self):
            Capture.active = True
            return self

        def __exit__(self, *exc):
            Capture.active = False
            if Capture.fail_at_exit and exc[0] is None:
                raise RuntimeError("capture invalidated")
            return False

    class Device:
        def __init__(self, device):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(torch.cuda, "device", Device)
    pools = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: (0, next(pools)))
    for counter in (fused_fft_block, fused_mrf):
        for name in ("launches", "tc_launches", "captured", "tc_captured"):
            monkeypatch.setattr(counter, name, 0)
    cache = graphs.GraphCache("cpu")
    cache.cuda = True  # the capture path, on the CPU
    kept = []

    def launch(counter, n, tensor_core):
        """A wrapper's count of ``n`` launches."""
        kind = "captured" if Capture.active else "launches"
        setattr(counter, kind, getattr(counter, kind) + n)
        tc = "tc_" + kind
        setattr(counter, tc, getattr(counter, tc) + n * tensor_core)

    def fn(x, rows):
        launch(fused_fft_block, 12, True)
        launch(fused_mrf, 3, False)
        return [x * 2, rows[0] + 1]

    def counts():
        return tuple(getattr(c, name) for c in (fused_fft_block, fused_mrf)
                     for name in ("launches", "tc_launches"))

    def keep():
        kept.append(1)
        return ["packed"]

    args = (np.ones((2, 3), np.float32), [torch.zeros(2)])
    out = cache.run("k", fn, args, keep=keep)
    np.testing.assert_array_equal(out[0].numpy(), 2 * np.ones((2, 3)))
    assert counts() == (12, 12, 3, 0)  # the eager run's alone
    assert (fused_fft_block.captured, fused_fft_block.tc_captured,
            fused_mrf.captured) == (12, 12, 3)
    assert cache.captures == 1 and len(kept) == 1 and len(cache) == 1
    entry = next(iter(cache.entries.values()))
    assert entry.recorded == (12, 12, 3, 0) and entry.keep == ["packed"]
    out = cache.run("k", fn, (np.zeros((2, 3), np.float32),
                              [torch.ones(2)]), keep=keep)
    assert out is entry.outputs and Graph.replays == 1
    assert torch.equal(entry.inputs[1], torch.ones(2))  # loaded
    assert counts() == (12, 12, 3, 0)  # a replay runs no wrapper
    assert cache.replays == 1 and cache.replayed == (12, 12, 3, 0)
    assert cache.captures == 1 and len(kept) == 1
    cache.run("k", fn, (np.ones((3, 3), np.float32), [torch.zeros(2)]))
    assert len(cache) == 2 and cache.keys() == {"k"}
    assert counts() == (24, 24, 6, 0) and cache.captures == 2

    def failing(x, rows):
        if Capture.active:
            raise RuntimeError("capture failed")
        return fn(x, rows)

    with pytest.raises(RuntimeError, match="capture failed"):
        cache.run("bad", failing, args)
    Capture.fail_at_exit = True
    with pytest.raises(RuntimeError, match="capture invalidated"):
        cache.run("bad_end", fn, args)
    Capture.fail_at_exit = False
    # each failed capture: its eager run's launches, no entry, no capture
    assert counts() == (48, 48, 12, 0)
    assert len(cache) == 2 and cache.keys() == {"k"}
    assert cache.captures == 2 and cache.replays == 1
    cache.pool = torch.cuda.graph_pool_handle()
    cache.drop(lambda key: key == "bad")  # no entry of that key
    assert cache.pool == (0, 0)
    cache.drop(lambda key: key == "k")
    assert len(cache) == 0 and cache.pool == (0, 1)


def test_to_host_copies_and_keeps_the_nesting():
    x = torch.arange(6).reshape(2, 3)
    out = graphs.to_host([x, (None, x > 2)])
    assert isinstance(out, list) and isinstance(out[1], tuple)
    assert out[1][0] is None and out[1][1].dtype == np.bool_
    x += 1  # the host copy does not alias the tensor
    np.testing.assert_array_equal(out[0], np.arange(6).reshape(2, 3))
    with pytest.raises(TypeError, match="numpy arrays, tensors and None"):
        graphs.GraphCache("cpu").run("k", lambda v: v, (3,))


def test_a_capture_registers_the_generators_and_draws_nothing(monkeypatch):
    """A cache's generators are registered with every graph it captures,
    and a capture leaves their state as it found it: the first call's
    eager run draws, the capture that follows does not move the
    generator (a replay would draw from the state the caller loads)."""
    registered = []

    class Graph:
        def register_generator_state(self, gen):
            registered.append(gen)

        def replay(self):
            pass

    class Capture:
        def __init__(self, graph, pool=None, capture_error_mode=None):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Device:
        def __init__(self, device):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 0))
    gen = torch.Generator().manual_seed(5)
    cache = graphs.GraphCache("cpu", counters=(), generators=(gen,))
    cache.cuda = True  # the capture path, on the CPU
    assert cache.replayed == ()

    def fn(x):
        return x + torch.rand(x.shape, generator=gen)

    out = cache.run("k", fn, (np.zeros(3, np.float32),))
    want = torch.rand(3, generator=torch.Generator().manual_seed(5))
    assert torch.equal(out, want)
    assert registered == [gen]
    twin = torch.Generator().manual_seed(5)
    torch.rand(3, generator=twin)
    assert torch.equal(gen.get_state(), twin.get_state())
    assert next(iter(cache.entries.values())).recorded == ()


def test_a_bounded_cache_evicts_the_least_recently_run_entry(monkeypatch):
    """With ``max_entries`` a new signature evicts the entry run longest
    ago (a hit counts as a run); an evicted signature runs its pass again
    as a first call; evicting the last entry takes a new pool id, as
    ``drop`` does."""
    ran = []

    def fn(x):
        ran.append(tuple(x.shape))
        return x + 1

    def arg(n):
        return (np.zeros(n, np.float32),)

    cache = graphs.GraphCache("cpu", max_entries=2)
    for n in (1, 2, 1, 3):
        cache.run("k", fn, arg(n))
    assert [sig[1][0][0] for _, sig in cache.entries] == [(1,), (3,)]
    assert cache.evictions == 1 and len(cache) == 2
    ran.clear()
    out = cache.run("k", fn, arg(2))  # a first call again
    assert ran == [(2,)] and torch.equal(out, torch.ones(2))
    assert [sig[1][0][0] for _, sig in cache.entries] == [(3,), (2,)]
    assert cache.evictions == 2

    class Graph:
        def replay(self):
            pass

    class Context:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Context)
    monkeypatch.setattr(torch.cuda, "device", Context)
    pools = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: (0, next(pools)))
    cache = graphs.GraphCache("cpu", max_entries=1)
    cache.cuda, cache.pool = True, torch.cuda.graph_pool_handle()
    cache.run("k", fn, arg(1))
    assert cache.pool == (0, 0)
    cache.run("k", fn, arg(2))
    assert cache.pool == (0, 1) and len(cache) == 1 and cache.evictions == 1
