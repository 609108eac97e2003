"""The port's training runtime on the CPU: ``Trainer`` against the JAX
package's, and the JAX trainer's own behaviours (checkpoints, resume,
the benchmark hook, preemption, the learning-rate fast-forward) on the
port, with its asynchronous saver, its weight caches and its logger.

Parity: one synthetic corpus (``chip_smoke.write_corpus``), the tiny
widths of ``tests/helpers.tiny_hparams`` with every dropout at 0, float32,
accumulation 2, the JAX ``init_params`` crossed into the port with
``convert.state_dict_from_jax``. The port ``Trainer(device="cpu")`` and
the JAX ``Trainer(hp, use_mesh=False)`` each train 2 iterations; each
logged loss, term and gradient norm, the validation metrics and every
parameter afterwards are held to the bounds below.
"""

import copy
import json
import os
import signal
import socket
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from helpers import tiny_hparams

from daft_exprt_tpu.training import logger as jlogger
from daft_exprt_tpu.training import trainer as jtrainer
from daft_exprt_tpu_torch import checkpoint as inference_checkpoint
from daft_exprt_tpu_torch.config import HyperParams
from daft_exprt_tpu_torch.convert import state_dict_from_jax
from daft_exprt_tpu_torch.models.daft_exprt import DaftExprt
from daft_exprt_tpu_torch.ops.conv_ff_train import tc_weights, unpack_image
from daft_exprt_tpu_torch.training import logger, trainer
from daft_exprt_tpu_torch.training.checkpoint import (AsyncSaver,
                                                      load_checkpoint)
from daft_exprt_tpu_torch.training.step import batch_to_inputs, to_device

# float32 on both sides, different libraries and summation orders
METRIC_RTOL = 1e-5
PARAM_REL_L2 = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on the
    CPU at once (tests/test_torch_entry_points.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_drop(cfg):
    return {**cfg, **{k: 0.0 for k in ("attn_dropout", "conv_dropout")
                      if k in cfg}}


def tiny_kwargs(corpus, out_dir, dropout=False, **overrides):
    """tests/helpers.tiny_hparams's widths, one FFT block a module (the
    JAX steps compile in half the time), over ``corpus`` (dropout 0 unless
    asked for), as keyword arguments of either HyperParams."""
    base = tiny_hparams()
    modules = {m: {**getattr(base, m), "nb_blocks": 1} for m in (
        "prosody_encoder", "phoneme_encoder", "local_prosody_predictor",
        "frame_decoder")}
    if not dropout:
        modules = {m: _no_drop(c) for m, c in modules.items()}
    kwargs = dict(verbose=False, training_files=corpus["train"],
                  validation_files=corpus["val"],
                  output_directory=str(out_dir), language="english",
                  speakers=list(chip_smoke.CORPUS_SPEAKERS),
                  stats=corpus["stats"], compute_dtype="float32",
                  batch_size=2, accumulation_steps=2, iters_per_checkpoint=2,
                  iters_check_for_model_improvement=2, **modules)
    return {**kwargs, **overrides}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """6 utterances a speaker (2 validate) of 6-12 symbols at 2-4 frames:
    2 steps an epoch at 2 x 2 rows."""
    return chip_smoke.write_corpus(tmp_path_factory.mktemp("trainer"),
                                   n_utts=6, symbols=(6, 12),
                                   frames_per_symbol=(2, 4), n_val=2,
                                   audio=False)


class Recorder:
    """Stands in for either package's TrainingLogger."""

    def __init__(self, log_dir=None):
        self.training, self.validation = [], []
        self.iter_seconds = []

    def log_training(self, metrics, iteration, iter_seconds=None):
        self.training.append((iteration, {k: float(v)
                                          for k, v in metrics.items()}))
        self.iter_seconds.append((iteration, iter_seconds))

    def log_validation(self, val, iteration, sample=None):
        self.validation.append((iteration, dict(val), sample is not None))

    def close(self):
        pass


def _recording(monkeypatch, module):
    made = []

    def make(log_dir):
        made.append(Recorder())
        return made[-1]

    monkeypatch.setattr(module, "TrainingLogger", make)
    return made


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def key_bias(k, v):
    """The attention key-bias slice of an ``in_proj_bias``, else None."""
    if not k.endswith("in_proj_bias"):
        return None
    E = v.shape[0] // 3
    return np.s_[E:2 * E]


def assert_params_close(got, want):
    """Every parameter within relative L2 ``PARAM_REL_L2``, the attention
    key biases left out: their gradient is zero in exact arithmetic
    (softmax ignores a shift of a query's scores;
    ``test_attention_key_bias_gradient_vanishes``), so Adam moves them from
    zero by up to ~lr a step following the sign of the rounding noise,
    which differs between summation orders (reading, 2 steps at lr 1e-4:
    |b_k| <= 1.79e-4, relative L2 between the packages up to 1.6). The
    query and value parts of the same tensors are held like the rest."""
    assert got.keys() == want.keys()
    errs = {}
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        keys = key_bias(k, g)
        if keys is not None:
            g, w = np.delete(g, keys), np.delete(w, keys)
        errs[k] = _rel_l2(g, w)
    assert max(errs.values()) <= PARAM_REL_L2, max(errs.items(),
                                                   key=lambda kv: kv[1])


def test_two_iterations_match_the_jax_trainer(corpus, tmp_path, monkeypatch):
    jhp = tiny_hparams(**tiny_kwargs(corpus, tmp_path / "jax",
                                     iters_per_checkpoint=1000))
    thp = HyperParams(**tiny_kwargs(corpus, tmp_path / "port",
                                    iters_per_checkpoint=1000))
    jlogs = _recording(monkeypatch, jtrainer)
    tlogs = _recording(monkeypatch, trainer)

    jt = jtrainer.Trainer(jhp, use_mesh=False, log_every=1)
    params = jt.model.init_params(jax.random.PRNGKey(0))
    start = state_dict_from_jax(jax.device_get(params))
    jparams, _ = jt.train(params=params, opt_state=jt.tx.init(params),
                          max_iterations=2)
    tt = trainer.Trainer(thp, device="cpu", log_every=1)
    tt.train(state=start, max_iterations=2)

    (jrec,), (trec,) = jlogs, tlogs
    assert [it for it, _ in trec.training] == [1, 2]
    for (jit_, jm), (tit, tm) in zip(jrec.training, trec.training):
        assert jit_ == tit and jm.keys() == tm.keys()
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=METRIC_RTOL,
                                       err_msg=f"iteration {tit}: {k}")
    (jit_, jval, jsample), = jrec.validation
    (tit, tval, tsample), = trec.validation
    assert jit_ == tit == 2 and jsample and tsample
    assert jval.keys() == tval.keys()
    for k in jval:
        np.testing.assert_allclose(tval[k], jval[k], rtol=METRIC_RTOL,
                                   err_msg=f"validation {k}")
    want = state_dict_from_jax(jax.device_get(jparams))
    got = tt.model.state_dict()
    assert_params_close(got, want)
    # the weights moved
    assert any(not torch.equal(got[k], start[k]) for k in start)


class StepClock:
    """The trainers' ``time`` module: ``perf_counter`` reads a clock that
    only ``sleep`` advances, so each logged window holds exactly the time
    slept in it."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


HOOK_SLEEP_S = 0.3


def test_logged_window_holds_the_hook_time_of_the_window_before(
        corpus, tmp_path, monkeypatch):
    """``log_every=2``, a checkpoint and the benchmark hook at 2 and 4, the
    hook sleeping 0.3 s at 2: the window logged at 2 ends before the hook
    runs and holds none of it; the window logged at 4 holds all of it, as
    the JAX trainer's windows do (it restarts its clock where it logs)."""
    windows = {}
    for name, module, make in (
            ("jax", jtrainer, lambda hp: jtrainer.Trainer(
                tiny_hparams(**hp), use_mesh=False, log_every=2)),
            ("port", trainer, lambda hp: trainer.Trainer(
                HyperParams(**hp), device="cpu", log_every=2))):
        clock = StepClock()
        monkeypatch.setattr(module, "time", clock)
        logs = _recording(monkeypatch, module)
        hooks = []

        def hook(state, iteration, out_dir):
            hooks.append(iteration)
            if iteration == 2:
                clock.sleep(HOOK_SLEEP_S)

        t = make(tiny_kwargs(corpus, tmp_path / name,
                             iters_check_for_model_improvement=1000))
        t.train(benchmark_hook=hook, max_iterations=4)
        assert hooks == [2, 4]
        (rec,) = logs
        windows[name] = rec.iter_seconds
    assert windows["jax"] == [(2, 0.0), (4, HOOK_SLEEP_S / 2)]
    assert windows["port"] == windows["jax"]


def test_checkpoint_resume_and_hook(corpus, tmp_path, monkeypatch):
    """tests/test_pipeline.py's trainer test on the port: checkpoints at
    2, the hook fired once at 2, resume to 3."""
    _recording(monkeypatch, trainer)
    hp = HyperParams(**tiny_kwargs(corpus, tmp_path, dropout=True))
    hooks = []
    t = trainer.Trainer(hp, device="cpu", log_every=1)
    t.train(benchmark_hook=lambda s, it, out: hooks.append(it),
            max_iterations=2)
    assert t.iteration == 2 and hooks == [2]
    ckpt_dir = tmp_path / "checkpoints"
    assert sorted(os.listdir(ckpt_dir)) == [
        "DaftExprt_2.pt", "DaftExprt_best.pt", "DaftExprt_last.pt"]
    state, opt, meta = load_checkpoint(str(ckpt_dir / "DaftExprt_2.pt"),
                                       hparams=hp)
    assert meta["iteration"] == 2 and opt["count"] == 2
    for k, v in t.model.state_dict().items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    # the synthesis entry points read the trainer's files as they are
    served, shp = inference_checkpoint.load_any_checkpoint(
        str(ckpt_dir / "DaftExprt_best.pt"))
    assert served.keys() == state.keys() and shp.stats == hp.stats

    hp.checkpoint = str(ckpt_dir / "DaftExprt_2.pt")
    t2 = trainer.Trainer(hp, device="cpu", log_every=1)
    t2.train(max_iterations=3)
    assert t2.iteration == 3 and t2.optimizer.count == 3


def test_mid_epoch_resume_equals_the_uninterrupted_run(corpus, tmp_path,
                                                       monkeypatch):
    """2 steps an epoch: resuming at 1 continues epoch 0 at its second
    step; with the optimizer state and each iteration's dropout seed
    restored, the resumed run's weights equal the uninterrupted run's
    bit for bit (dropout on)."""
    _recording(monkeypatch, trainer)
    hp = HyperParams(**tiny_kwargs(corpus, tmp_path / "a", dropout=True,
                                   iters_per_checkpoint=1))
    full = trainer.Trainer(hp, device="cpu")
    full.train(max_iterations=3)
    hp2 = HyperParams(**tiny_kwargs(
        corpus, tmp_path / "b", dropout=True, iters_per_checkpoint=1,
        checkpoint=str(tmp_path / "a" / "checkpoints" / "DaftExprt_1.pt")))
    resumed = trainer.Trainer(hp2, device="cpu")
    resumed.train(max_iterations=3)
    assert resumed.iteration == full.iteration == 3
    for k, v in full.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v,
                                   rtol=0, atol=0, msg=k)


def test_sigterm_writes_last_and_exits(corpus, tmp_path, monkeypatch):
    """tests/test_pipeline.py's preemption test: a real SIGTERM from the
    checkpoint hook at iteration 2 stops the loop at that step boundary
    with DaftExprt_last at 2."""
    _recording(monkeypatch, trainer)
    hp = HyperParams(**tiny_kwargs(corpus, tmp_path,
                                   iters_check_for_model_improvement=10000))

    def hook(state, iteration, out_dir):
        os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    t = trainer.launch_training(hp, benchmark_hook=hook, max_iterations=50,
                                device="cpu")
    assert signal.getsignal(signal.SIGTERM) == before
    assert t.iteration == 2, "the loop must stop at the step boundary"
    _, _, meta = load_checkpoint(str(tmp_path / "checkpoints"
                                     / "DaftExprt_last.pt"))
    assert meta["iteration"] == 2


def test_resume_without_optimizer_state_fast_forwards_lr(corpus, tmp_path,
                                                         monkeypatch):
    """A .pt whose ``optimizer`` is None (as tools/export_acoustic_torch.py
    writes from a JAX checkpoint) continues the learning-rate schedule
    from its iteration, with fresh Adam moments
    (tests/test_checkpoint.py's fast-forward test)."""
    hp = HyperParams(**tiny_kwargs(corpus, tmp_path))
    model = DaftExprt(hp, device="cpu", seed=5)
    path = str(tmp_path / "exported.pt")
    inference_checkpoint.save_reference_checkpoint(path, model, hp,
                                                   iteration=12345)
    t = trainer.Trainer(hp, device="cpu")
    t.resume(path)
    assert t.iteration == 12345 and t.optimizer.count == 12345
    assert all(float(m.abs().max()) == 0.0
               for m in t.optimizer.mu + t.optimizer.nu)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(t.model.state_dict()[k], v, rtol=0,
                                   atol=0)


def _batch(t):
    train_loader, val_loader = t.make_loaders()
    return next(train_loader.epoch(0)), next(iter(val_loader))


def test_async_save_is_the_pre_step_weights(corpus, tmp_path):
    hp = HyperParams(**tiny_kwargs(corpus, tmp_path, dropout=True))
    t = trainer.Trainer(hp, device="cpu")
    batch, _ = _batch(t)
    gen = torch.Generator().manual_seed(0)
    t.train_step(batch, gen, 1)
    before = copy.deepcopy(t.model.state_dict())
    moments = copy.deepcopy(t.optimizer.state_dict())
    saver = AsyncSaver()
    path = saver.save(str(tmp_path), 1, t.model, t.optimizer, hp, 1.5,
                      name="async")
    t.train_step(batch, gen, 2)  # updates the weights in place at once
    saver.close()
    state, opt, meta = load_checkpoint(path)
    assert meta == {"iteration": 1, "best_val_loss": 1.5,
                    "learning_rate": float(t.schedule(1)),
                    "config_params": meta["config_params"]}
    moved = 0
    for k, v in before.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
        moved += not torch.equal(v, t.model.state_dict()[k])
    assert moved > 0
    assert opt["count"] == 1 and t.optimizer.count == 2
    for k, v in moments["mu"].items():
        torch.testing.assert_close(opt["mu"][k], v, rtol=0, atol=0)


def test_a_forward_after_a_step_sees_the_new_weights(corpus, tmp_path):
    """The in-place update invalidates the weight caches: FFTBlock's
    K1 packing (``kernel_weights``) on the validation forward and the
    tensor-core conv weights (``tc_weights``)."""
    hp = HyperParams(**tiny_kwargs(corpus, tmp_path))
    t = trainer.Trainer(hp, device="cpu")
    batch, val = _batch(t)
    inputs = batch_to_inputs(to_device(
        {k: v for k, v in val.items() if k not in ("feature_dirs",
                                                   "feature_files")},
        "cpu"))
    old = t.model(inputs, train=False)[3][0]
    conv = t.model.frame_decoder.blocks[0].feed_forward.convs
    w1, w2 = conv["0"].conv.weight, conv["2"].conv.weight
    cached = tc_weights(w1, w2).w1.clone()
    t.train_step(batch, torch.Generator().manual_seed(0), 1)
    new = t.model(inputs, train=False)[3][0]
    fresh = DaftExprt(hp, device="cpu")
    fresh.load_state_dict(t.model.state_dict())
    torch.testing.assert_close(new, fresh(inputs, train=False)[3][0],
                               rtol=0, atol=0)
    assert not torch.equal(new, old)
    now = tc_weights(w1, w2).w1
    torch.testing.assert_close(unpack_image(now, w1.shape[1], w1.shape[0]),
                               w1.detach().permute(2, 1, 0).to(
                                   torch.bfloat16), rtol=0, atol=0)
    assert not torch.equal(now, cached)


def test_attention_key_bias_gradient_vanishes(corpus, tmp_path):
    """Why ``assert_params_close`` leaves the key biases out: on one
    micro-batch at the start weights their gradient is rounding noise,
    while the query and value biases of the same tensors get real ones.
    Reading: the largest key-bias gradient 1.2e-8 to 3.1e-8 of the
    largest query or value-bias gradient, a block each; a real gradient
    would be of the same order as theirs."""
    from daft_exprt_tpu_torch.training.loss import compute_loss
    from daft_exprt_tpu_torch.training.step import batch_to_targets

    hp = HyperParams(**tiny_kwargs(corpus, tmp_path))
    t = trainer.Trainer(hp, device="cpu")
    batch, _ = _batch(t)
    micro = to_device({k: v[0] for k, v in batch.items()}, "cpu")
    outputs = t.model(batch_to_inputs(micro), train=True,
                      generator=torch.Generator().manual_seed(0))
    loss, _ = compute_loss(outputs, batch_to_targets(micro), 1, hp)
    loss.backward()
    ratios = {}
    for k, p in t.model.named_parameters():
        keys = key_bias(k, p)
        if keys is None:
            continue
        g = p.grad.detach().numpy()
        others = np.abs(np.delete(g, keys)).max()
        assert others > 0, k
        ratios[k] = np.abs(g[keys]).max() / others
    assert len(ratios) == 3  # the prosody, phoneme and frame blocks
    assert max(ratios.values()) <= 1e-5, ratios


def test_logger_records_what_the_jax_logger_records(tmp_path, monkeypatch):
    class Writer:
        def __init__(self):
            self.calls = []

        def add_scalar(self, tag, value, step):
            self.calls.append((tag, float(value), int(step)))

        def close(self):
            pass

    metrics = {"loss": 3.5, "grad_norm": 1.25, "learning_rate": 1e-4,
               "speaker_loss": 0.5, "mel_spec_l1_loss": 1.0,
               "duration_loss": 0.25}
    val = {"loss": 2.0, "mel_spec_l1_loss": 0.75, "speaker_accuracy": 0.5}
    jl = jlogger.TrainingLogger(str(tmp_path / "jax"))
    jl.writer.close()
    jl.writer = Writer()
    mine = logger.TrainingLogger(str(tmp_path / "port"), writer=Writer())
    for lg in (jl, mine):
        lg.log_training(metrics, 7, iter_seconds=0.125)
        lg.log_validation(val, 8)
    assert mine.writer.calls == jl.writer.calls
    assert len(mine.writer.calls) == 7 + 3

    # without tensorboardX: the same triples as JSON lines
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    jsonl = logger.TrainingLogger(str(tmp_path / "jsonl"))
    jsonl.log_training(metrics, 7, iter_seconds=0.125)
    jsonl.log_validation(val, 8, sample={"unused": True})  # no figures
    jsonl.close()
    with open(tmp_path / "jsonl" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] \
        == jl.writer.calls


def test_training_cli_raises_without_cuda_and_joins_a_group(
        corpus, tmp_path, monkeypatch):
    """``cli.training train`` runs on ``cuda`` unless ``--device cpu`` is
    given; under a torchrun-style environment of one rank it joins a gloo
    group (the step's all-reduce runs, exact in a world of one) and the
    weights equal a run without a group's."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from daft_exprt_tpu_torch.cli import training as cli
    from daft_exprt_tpu_torch.parallel import distributed

    runs = {}
    for name in ("plain", "group"):
        exp = tmp_path / name
        HyperParams(**tiny_kwargs(
            corpus, exp, dropout=True,
            iters_check_for_model_improvement=1000)).save_hyper_params(
                str(exp / "config.json"))
        argv = ["train", "--experiments_dir", str(tmp_path),
                "--experiment_name", name, "--max_iterations", "2",
                "--no_benchmark_synthesis"]
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
        with monkeypatch.context() as mp:
            if name == "group":
                with socket.socket() as s:
                    s.bind(("127.0.0.1", 0))
                    port = s.getsockname()[1]
                for k, v in (("MASTER_ADDR", "127.0.0.1"),
                             ("MASTER_PORT", str(port)),
                             ("WORLD_SIZE", "1"), ("RANK", "0")):
                    mp.setenv(k, v)
                step = trainer.make_train_step
                ranks = []

                def spy(model, hp):
                    ranks.append(distributed.world_size())
                    return step(model, hp)

                mp.setattr(trainer, "make_train_step", spy)
            t = cli.main(argv + ["--device", "cpu"])
            if name == "group":
                assert ranks == [1] and not torch.distributed.is_initialized()
        assert t.iteration == 2
        runs[name] = load_checkpoint(str(exp / "checkpoints"
                                         / "DaftExprt_last.pt"))[0]
    for k, v in runs["plain"].items():
        torch.testing.assert_close(runs["group"][k], v, rtol=0, atol=0)


def test_validation_goes_through_the_eval_graphs_with_one_copy_a_batch(
        corpus, tmp_path, monkeypatch):
    """``Trainer.validate`` takes each batch through the eval step's
    entry of its signature and copies its metrics to the host once; the
    result is the row-weighted mean of the eval step called directly. The
    train step's cache holds one entry a batch signature, and a resume
    that sets the optimizer's count alone is loaded by the next step."""
    from daft_exprt_tpu_torch.training.step import (EVAL_METRICS,
                                                    make_eval_step)
    hp = HyperParams(**tiny_kwargs(corpus, tmp_path))
    t = trainer.Trainer(hp, device="cpu")
    _, val_loader = t.make_loaders()
    copies = []
    to_host = trainer.to_host

    def counted(tree):
        copies.append(len(tree))
        return to_host(tree)

    monkeypatch.setattr(trainer, "to_host", counted)
    got = t.validate(val_loader)
    eager, rows = {}, 0.0
    direct = make_eval_step(t.model, hp)
    for batch in val_loader:
        batch = {k: v for k, v in batch.items()
                 if k not in ("feature_dirs", "feature_files")}
        m = direct(batch, np.ones(batch["symbols"].shape[0], np.float32))
        n = float(m.pop("count"))
        for k, v in m.items():
            eager[k] = eager.get(k, 0.0) + float(v) * n
        rows += n
    assert len(copies) == len(list(val_loader))
    assert set(copies) == {len(EVAL_METRICS)}
    assert set(got) == set(eager)
    for k in got:
        np.testing.assert_allclose(got[k], eager[k] / rows, rtol=1e-6,
                                   err_msg=k)
    sigs = {sig for _, sig in t.eval_step.graphs.entries}
    assert t.eval_step.graphs.keys() == {"eval"} and 1 <= len(sigs) \
        == len(t.eval_step.graphs)
    t.optimizer.count = 40  # a resume without optimizer state
    batch, _ = _batch(t)
    t.train_step(batch, torch.Generator().manual_seed(0), 41)
    assert t.optimizer.count == 41
    assert t.train_step.graphs.keys() == {("accumulate", False), "update"}
