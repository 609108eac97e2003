"""Training orchestration (counterpart of
``daft_exprt_tpu/training/trainer.py``): host-side epoch and batch
bookkeeping around :func:`~daft_exprt_tpu_torch.training.step.
make_train_step`, rank-0 logging, periodic validation with best-model
tracking, checkpoints every ``iters_per_checkpoint`` and an optional
benchmark-synthesis hook at every checkpoint and new best model.

Data parallelism is one process per card (``parallel.distributed``):
each rank loads its own rows of every micro-batch and the step averages
gradients once per optimizer step. Only rank 0 writes checkpoints and
logs; every rank validates the whole validation set on its own card, so
all reach the same best-model decision.

Each iteration's dropout stream is seeded from (``hp.seed``, rank,
iteration), so a resumed run draws the masks the uninterrupted one drew.

On the card every step and every validation batch is one CUDA graph
replay (``training/step.py``): the loop hands each step a host batch and
the iteration, and reads the step's metrics (device scalars) once a log
interval; a resume copies into the parameters and moments and sets the
optimizer's host count, which the step loads before each replay.
"""

from __future__ import annotations

import gc
import logging
import os
import time

import numpy as np
import torch

from daft_exprt_tpu_torch.data.loader import (EvalLoader, FeatureDataset,
                                              TrainLoader)
from daft_exprt_tpu_torch.device import default_device
from daft_exprt_tpu_torch.inference.graphs import to_host
from daft_exprt_tpu_torch.models.daft_exprt import DaftExprt
from daft_exprt_tpu_torch.models.modules import init_parameters
from daft_exprt_tpu_torch.parallel.distributed import (any_rank,
                                                       local_device, rank,
                                                       world_size)
from daft_exprt_tpu_torch.training.checkpoint import (AsyncSaver,
                                                      load_checkpoint)
from daft_exprt_tpu_torch.training.logger import TrainingLogger
from daft_exprt_tpu_torch.training.step import (batch_to_inputs,
                                                dropout_seed, make_eval_step,
                                                make_train_step, to_device)
from daft_exprt_tpu_torch.utils import prefetch_iterator

_logger = logging.getLogger(__name__)

_ID_KEYS = ("feature_dirs", "feature_files")


def _floats(metrics: dict, device) -> dict:
    """Scalar tensors (on the device or the host) as floats, one copy."""
    keys = list(metrics)
    values = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                          device=device) for k in keys])
    return dict(zip(keys, values.tolist()))


class Trainer:
    """:param device: ``cuda`` unless given (``cuda:LOCAL_RANK`` under a
        process group of several ranks); raises without CUDA
    :param profile_steps: if > 0, a ``torch.profiler`` trace of
        ``profile_steps`` optimizer steps from iteration ``profile_start``
        is written to ``<output_dir>/logs/profile`` (the profiler object
        stays as ``self.profile``, the window's host seconds as
        ``self.profile_wall_s``)
    """

    def __init__(self, hparams, device=None, log_every: int = 10,
                 profile_steps: int = 0, profile_start: int = 10):
        self.hp = hparams
        if device is None and world_size() > 1:
            device = local_device()
        self.device = default_device(device)
        self.log_every = log_every
        self.profile_steps = profile_steps
        self.profile_start = profile_start
        self.profile = None
        self._profiling = False
        self.model = DaftExprt(hparams, device=self.device, seed=hparams.seed)
        self.train_step = make_train_step(self.model, hparams)
        self.optimizer = self.train_step.optimizer
        self.schedule = self.optimizer.schedule
        self.eval_step = make_eval_step(self.model, hparams)
        self.is_chief = rank() == 0
        self.iteration = 0
        self.best_val_loss = float("inf")
        # request_stop() makes the loop exit at the next step boundary
        # after writing DaftExprt_last
        self._stop_requested = False
        self.preempt_sync_every = 10  # multi-rank stop-flag agreement

    # ------------------------------------------------------------------
    def request_stop(self):
        """Ask the training loop to checkpoint and exit at the next step
        boundary. Signal-handler safe (only sets a flag)."""
        self._stop_requested = True

    def _should_stop(self) -> bool:
        """One process: the local flag. Several: every rank must stop at
        the same step (the steps' all-reduces pair up), so the flag is
        max-reduced every ``preempt_sync_every`` steps -- a SIGTERM may
        reach one rank only."""
        if world_size() == 1:
            return self._stop_requested
        if self.iteration % self.preempt_sync_every:
            return False
        return any_rank(self._stop_requested, self.device)

    # ------------------------------------------------------------------
    def init_state(self, seed: int | None = None):
        """Fresh weights drawn from ``seed`` (default ``hp.seed``) and a
        fresh optimizer state."""
        seed = self.hp.seed if seed is None else seed
        init_parameters(self.model, torch.Generator().manual_seed(seed))
        self.optimizer.count = 0
        with torch.no_grad():
            for m in self.optimizer.mu + self.optimizer.nu:
                m.zero_()
        n = sum(p.numel() for p in self.model.parameters())
        _logger.info(f"Initialized DaftExprt with {n:,} parameters")

    def resume(self, ckpt_path: str):
        state, opt, meta = load_checkpoint(ckpt_path, hparams=self.hp)
        self.model.load_state_dict(state, strict=True)
        iteration = int(meta["iteration"])
        if opt is not None:
            self.optimizer.load_state_dict(opt)
        else:
            # the recreated optimizer continues the learning-rate schedule
            # from the checkpoint's iteration: a count of 0 would re-run
            # the whole warm-up
            self.optimizer.count = iteration
            _logger.warning(
                "optimizer state not restored; fast-forwarded the LR "
                f"schedule to iteration {iteration} (Adam moments restart)")
        self.iteration = iteration
        best = meta.get("best_val_loss")
        self.best_val_loss = float("inf") if best is None else float(best)
        _logger.info(f"Resumed from {ckpt_path} at iteration "
                     f"{self.iteration}")

    # ------------------------------------------------------------------
    def make_loaders(self):
        hp = self.hp
        train_ds = FeatureDataset(hp.training_files, hp)
        val_ds = FeatureDataset(hp.validation_files, hp, shuffle=False)
        loader_cls = TrainLoader
        if getattr(hp, "data_loader", "native") == "grain":
            from daft_exprt_tpu_torch.data.worker_loader import \
                WorkerTrainLoader
            loader_cls = WorkerTrainLoader
        train_loader = loader_cls(train_ds, hp, process_index=rank(),
                                  process_count=world_size())
        if train_loader.n_dropped:
            _logger.warning(
                f"{train_loader.n_dropped} utterances exceed the shape "
                f"caps (max_symbols={hp.max_symbols}, "
                f"max_frames={hp.max_frames}) and were dropped")
        return train_loader, EvalLoader(val_ds, hp)

    # ------------------------------------------------------------------
    def validate(self, val_loader) -> dict:
        """Eval-step metrics averaged over every validation row (each
        batch weighted by its row count)."""
        totals, count = {}, 0.0
        for batch in val_loader:
            batch = {k: v for k, v in batch.items() if k not in _ID_KEYS}
            row_mask = np.ones((batch["symbols"].shape[0],), np.float32)
            metrics = self.eval_step(batch, row_mask)
            # one copy to the host a batch
            metrics = dict(zip(metrics, map(float, to_host(
                list(metrics.values())))))
            b = metrics.pop("count")
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + v * b
            count += b
        return {k: v / max(count, 1.0) for k, v in totals.items()}

    def validation_sample(self, val_loader):
        """One forward pass on one batch, for the logger's figures."""
        for batch in val_loader:
            clean = {k: v for k, v in batch.items() if k not in _ID_KEYS}
            outputs = self.model(batch_to_inputs(
                to_device(clean, self.device)), train=False)
            _, film_params, encoder_preds, decoder_preds, weights = outputs

            def host(t):
                return t.float().cpu().numpy()

            return {
                "film_params": [host(f) for f in film_params[1:]],
                "duration_preds": host(encoder_preds[0])[0],
                "duration_targets": clean["durations_float"][0],
                "energy_preds": host(encoder_preds[1])[0],
                "energy_targets": clean["symbols_energy"][0],
                "pitch_preds": host(encoder_preds[2])[0],
                "pitch_targets": clean["symbols_pitch"][0],
                "mel_pred": host(decoder_preds[0])[0],
                "mel_target": clean["mel_specs"][0],
                "weights": host(weights)[0],
                "durations_int": clean["durations_int"][0],
                "input_length": int(clean["input_lengths"][0]),
                "output_length": int(clean["output_lengths"][0]),
            }
        return None

    # ------------------------------------------------------------------
    def _profile_window(self, out_dir: str):
        if self.profile_steps <= 0 or not self.is_chief:
            return
        end = self.profile_start + self.profile_steps
        if self.profile is None and \
                self.profile_start <= self.iteration < end:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.profile = torch.profiler.profile(activities=activities)
            self.profile.start()
            self._profiling = True
            self._profile_t0 = time.perf_counter()
        elif self._profiling and self.iteration >= end:
            self._stop_profile(out_dir)

    def _stop_profile(self, out_dir: str):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profile_wall_s = time.perf_counter() - self._profile_t0
        self.profile.stop()
        self._profiling = False
        trace_dir = os.path.join(out_dir, "logs", "profile")
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace_{self.iteration}.json")
        self.profile.export_chrome_trace(path)
        _logger.info(f"profiler trace written to {path}")

    def _save(self, saver, ckpt_dir, name=None):
        return saver.save(ckpt_dir, self.iteration, self.model,
                          self.optimizer, self.hp, self.best_val_loss,
                          name=name)

    def _batches(self, train_loader, steps_per_epoch: int):
        """The planned steps from the current iteration on, across epoch
        ends, assembled ahead by a prefetch thread; mid-epoch resume
        continues at the exact planned step the interrupted run stopped at
        instead of replaying the epoch."""
        return prefetch_iterator(train_loader.steps(
            self.iteration // steps_per_epoch,
            self.iteration % steps_per_epoch))

    # ------------------------------------------------------------------
    def train(self, state=None, benchmark_hook=None,
              max_iterations: int | None = None):
        """Run the training loop until ``nb_iterations``.

        :param state: a ``state_dict`` to start from (default: fresh
            weights from ``hp.seed``, then ``hp.checkpoint`` if set)
        :param benchmark_hook: optional callable(state_dict, iteration,
            output_dir) invoked at every checkpoint and new best model
            (benchmark-sentence synthesis in the full pipeline), at most
            once an iteration
        :return: the trained model
        """
        hp = self.hp
        out_dir = str(hp.output_directory)
        ckpt_dir = os.path.join(out_dir, "checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        logger_tb = TrainingLogger(os.path.join(out_dir, "logs")) \
            if self.is_chief else None

        if state is None:
            self.init_state()
            if hp.checkpoint:
                self.resume(hp.checkpoint)
        else:
            self.model.load_state_dict(state, strict=True)
        saver = AsyncSaver()
        train_loader, val_loader = self.make_loaders()
        steps_per_epoch = train_loader.batches_per_epoch()
        assert steps_per_epoch > 0, (
            "not enough training data for one optimizer step "
            "(need batch_size*accumulation_steps examples)")
        target = min(max_iterations or hp.nb_iterations, hp.nb_iterations)
        _logger.info(f"Training: {steps_per_epoch} steps/epoch, "
                     f"target {target} iterations")

        generator = torch.Generator(device=self.device)
        batches = self._batches(train_loader, steps_per_epoch)
        self._t_log = time.perf_counter()
        try:
            while self.iteration < target:
                batch = next(batches)
                self.iteration += 1
                self._profile_window(out_dir)
                generator.manual_seed(dropout_seed(hp, self.iteration))
                metrics = self.train_step(batch, generator, self.iteration)
                self._after_step(metrics, logger_tb, saver, ckpt_dir,
                                 out_dir, val_loader, benchmark_hook)
                if self._should_stop():
                    _logger.warning(
                        f"stop requested at iteration {self.iteration} "
                        "(preemption?) -- writing DaftExprt_last and "
                        "exiting")
                    break
            if self._profiling:  # training ended inside the window
                self._stop_profile(out_dir)
            self._save(saver, ckpt_dir, name="DaftExprt_last")
        finally:
            batches.close()  # stops and joins the prefetch thread
            saver.close()  # flush the in-flight write before returning
            if logger_tb is not None:
                logger_tb.close()
        return self.model

    def _after_step(self, metrics, logger_tb, saver, ckpt_dir, out_dir,
                    val_loader, benchmark_hook):
        hp = self.hp
        if self.is_chief and self.iteration % self.log_every == 0:
            metrics = _floats(metrics, self.device)
            # the window restarts here, as the JAX trainer's does: the
            # validation, saves and hook below fall into the next window
            now = time.perf_counter()
            dt = (now - self._t_log) / self.log_every
            self._t_log = now
            logger_tb.log_training(metrics, self.iteration, iter_seconds=dt)
            _logger.info(f"iter {self.iteration}: "
                         f"loss={metrics['loss']:.4f} "
                         f"grad_norm={metrics['grad_norm']:.3f} "
                         f"({dt:.3f}s/it)")

        bench_fired = False
        if self.iteration % hp.iters_check_for_model_improvement == 0:
            val = self.validate(val_loader)
            if self.is_chief:
                sample = self.validation_sample(val_loader)
                logger_tb.log_validation(val, self.iteration, sample)
                _logger.info(f"validation @ {self.iteration}: "
                             f"loss={val.get('loss', 0):.4f}")
            if val.get("loss", float("inf")) < self.best_val_loss:
                self.best_val_loss = val["loss"]
                self._save(saver, ckpt_dir, name="DaftExprt_best")
                if self.is_chief:
                    _logger.info("new best model saved")
                    if benchmark_hook is not None:
                        # every new best model gets an audio snapshot
                        benchmark_hook(self.model.state_dict(),
                                       self.iteration, out_dir)
                        bench_fired = True

        if self.iteration % hp.iters_per_checkpoint == 0:
            path = self._save(saver, ckpt_dir)
            if self.is_chief:
                _logger.info(f"checkpoint saved: {path}")
                if benchmark_hook is not None and not bench_fired:
                    # once per iteration even when a best-model save and a
                    # periodic checkpoint coincide
                    benchmark_hook(self.model.state_dict(),
                                   self.iteration, out_dir)

        if self.iteration % 500 == 0:
            # long runs: a periodic full collection caps host-RSS growth
            # from dropped references
            gc.collect()
            if self.is_chief:
                try:
                    with open("/proc/self/status") as sf:
                        rss_kb = next(int(line.split()[1]) for line in sf
                                      if line.startswith("VmRSS:"))
                    _logger.info(f"host RSS {rss_kb / 1048576:.1f} GB")
                except (OSError, StopIteration, ValueError):
                    pass


def launch_training(hparams, benchmark_hook=None,
                    max_iterations: int | None = None,
                    profile_steps: int = 0, device=None) -> Trainer:
    """Seed, build a :class:`Trainer` and run it; returns the trainer.

    SIGTERM (a preemption notice) triggers a clean exit: the loop
    finishes its current step, writes ``DaftExprt_last`` and returns, so a
    preempted run resumes with ``--checkpoint`` losing at most one
    optimizer step.
    """
    import signal

    np.random.seed(hparams.seed)
    trainer = Trainer(hparams, device=device, profile_steps=profile_steps)
    prev_handler = None
    try:  # signal.signal only works on the main thread
        prev_handler = signal.signal(
            signal.SIGTERM, lambda signum, frame: trainer.request_stop())
    except ValueError:
        pass
    try:
        trainer.train(benchmark_hook=benchmark_hook,
                      max_iterations=max_iterations)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    return trainer
