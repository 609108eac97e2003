"""Training loader with worker processes assembling the steps
(counterpart of ``daft_exprt_tpu.data.grain_loader``).

:class:`TrainLoader` assembles each stacked batch inline, on one
prefetch thread. This loader keeps the same epoch plan (shuffle,
length-sorted chunks, step-wide buckets, per-process rows:
``TrainLoader.plan_epoch`` / ``assemble``) and hands step assembly to a
``torch.utils.data.DataLoader`` over the planned steps, whose worker
processes build several future batches at once. Batches are bit-equal
to :class:`TrainLoader`'s. The training loop's stream (``steps``) keeps
one set of workers across epoch ends: forking them anew from a process
that holds the card's context made the flagship loop 40% slower
(``PERF.md``, "Findings").

It is chosen by ``hparams.data_loader == "grain"``, the value the JAX
package reads for its Grain loader: ``config_params`` is one schema,
shared with the JAX package's checkpoints and configs.

Workers are forked (a spawned worker would re-import the caller's main
module, torch and the port) and run numpy only: a forked child of a
process that holds a CUDA context fails on its first CUDA call. Batches
come back as CPU tensors in shared memory and are handed on as numpy
views; the host-to-device copy is the consumer's.
"""

from __future__ import annotations

import gc

import torch
from torch.utils.data import DataLoader, Dataset

from daft_exprt_tpu_torch.data.loader import FeatureDataset, TrainLoader


class _StepSource(Dataset):
    """Planned steps keyed by (epoch, step), each assembled on access; a
    worker plans each epoch it meets once."""

    def __init__(self, loader: TrainLoader):
        self._loader = loader
        self._epoch, self._plan = None, None

    def __getitem__(self, key) -> dict:
        epoch, b = key
        if epoch != self._epoch:
            self._epoch, self._plan = epoch, self._loader.plan_epoch(epoch)
        return self._loader.assemble(self._plan[b])


class _Keys:
    """(epoch, step) keys from ``epoch``'s ``start`` on, through
    ``epochs`` epochs (None: without end)."""

    def __init__(self, per_epoch: int, epoch: int, start: int,
                 epochs: int | None):
        self._args = per_epoch, epoch, start, epochs

    def __iter__(self):
        per_epoch, epoch, start, epochs = self._args
        while epochs is None or epochs > 0:
            for b in range(start, per_epoch):
                yield epoch, b
            epoch, start = epoch + 1, 0
            epochs = None if epochs is None else epochs - 1


class WorkerTrainLoader(TrainLoader):
    """TrainLoader with multi-process step assembly.

    :param worker_count: worker processes (default ``hp.data_workers``;
        0 assembles inline, still through the ``DataLoader``)
    :param read_ahead: batches each worker keeps ready
    """

    def __init__(self, dataset: FeatureDataset, hparams,
                 process_index: int = 0, process_count: int = 1,
                 worker_count: int | None = None, read_ahead: int = 2):
        super().__init__(dataset, hparams, process_index=process_index,
                         process_count=process_count)
        if worker_count is None:
            worker_count = int(getattr(hparams, "data_workers", 4))
        self.worker_count = worker_count
        self.read_ahead = read_ahead

    def _load(self, keys: _Keys):
        workers = self.worker_count > 0
        if workers:
            # the parent's unreachable cycles are collected before the
            # fork: a child's collector would otherwise finalize the CUDA
            # objects among them (a step's CUDA graphs, pinned buffers),
            # and a CUDA call in a forked child aborts it
            gc.collect()
        loader = DataLoader(
            _StepSource(self), batch_size=None, shuffle=False,
            sampler=keys, num_workers=self.worker_count,
            multiprocessing_context="fork" if workers else None,
            prefetch_factor=self.read_ahead if workers else None)
        for batch in loader:
            yield {k: v.numpy() if isinstance(v, torch.Tensor) else v
                   for k, v in batch.items()}

    def epoch(self, epoch_idx: int, start_step: int = 0):
        if start_step >= self.batches_per_epoch():
            return iter(())
        return self._load(_Keys(self.batches_per_epoch(), epoch_idx,
                                start_step, 1))

    def steps(self, epoch_idx: int, start_step: int = 0):
        """As ``TrainLoader.steps``, from one set of workers: they are
        forked once for the whole stream, not once an epoch."""
        return self._load(_Keys(self.batches_per_epoch(), epoch_idx,
                                start_step, None))
