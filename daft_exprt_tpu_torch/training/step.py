"""Train and eval steps (port of the JAX package's ``training/step.py``).

One optimizer step runs ``accumulation_steps`` micro-batches, each
``loss / accum`` backpropagated into the parameters' ``.grad`` (so the
gradients add up as the JAX scan's do), then one update. With a process
group initialised (one process per card, each on its own rows of every
micro-batch) the accumulated gradients, the loss and its seven terms are
averaged over the ranks by one flattened all-reduce after the micro-batch
loop and before the gradient norm and the update, as the JAX mesh step's
``pmean``; each rank draws dropout from its own stream
(:func:`dropout_seed`).

Each step is one CUDA graph replay on the card, as the JAX step is one
compiled executable (a ``lax.scan`` over the micro-batches, then the
optimizer, under one ``jax.jit``): :class:`~daft_exprt_tpu_torch.
inference.graphs.GraphCache` keeps a graph per batch signature (the shape
and dtype of every input array), captured at the signature's first step,
which runs eagerly. Everything a step reads that changes from step to
step is a static input loaded before the replay: the batch, the 1-based
optimizer count (:class:`Optimizer` keeps its host ``count`` for
checkpoints and resume) and the iteration (the adversarial weight, the
logged learning rate). Dropout draws from a generator registered with the
graph (``torch.cuda.CUDAGraph.register_generator_state``) whose state is
the caller's generator's before the step and is handed back after it: a
replay draws what the eager step would. Nothing inside a step reads a
value on the host. The step is two graphs, the micro-batch loop (one a
batch signature) and the update (one for every signature), with the
all-reduce between them where a process group is initialised (the only
place the gradients exist for a collective): one layout with or without
ranks. A replay moves the
parameters and moments without the autograd version counters noticing,
so the step bumps them after it: caches keyed on them (K1's packed
weights, K3/K4's bf16 weights) see every update. On the CPU the same
entries run every step eagerly. The eval step is one graph per batch
signature the same way, with K1's weights packed inside the graph from
the current parameters.

The optimizer is the JAX package's optax chain written out by hand:
clip by global norm (only if the threshold is finite; optax's
``select(norm < t, g, g / norm * t)``) -> coupled L2 weight decay
(``g + wd * p``) -> Adam(b1, b2, eps added outside the square root, bias
correction by the 1-based count) -> ``-lr`` with lr = schedule(count + 1)
from the optimizer's own 0-based count. ``torch.optim.Adam`` computes
the Adam part but neither optax's clip (``clip_grad_norm_`` adds 1e-6)
nor its learning-rate count.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from daft_exprt_tpu_torch.inference.graphs import GraphCache
from daft_exprt_tpu_torch.models.modules import drop_kernel_weights
from daft_exprt_tpu_torch.ops.attention_train import attention_core
from daft_exprt_tpu_torch.ops.conv_ff_train import (conv_ff_train,
                                                    conv_ff_train_blocked,
                                                    drop_tc_weights)
from daft_exprt_tpu_torch.parallel.distributed import (all_reduce_mean,
                                                       rank, world_size)
from daft_exprt_tpu_torch.training.loss import compute_loss
from daft_exprt_tpu_torch.training.schedule import make_lr_schedule

# Batch dict keys, in model-input order.
INPUT_KEYS = (
    "symbols", "durations_float", "durations_int", "symbols_energy",
    "symbols_pitch", "input_lengths", "frames_energy", "frames_pitch",
    "mel_specs", "output_lengths", "speaker_ids",
)
TARGET_KEYS = ("durations_float", "symbols_energy", "symbols_pitch",
               "mel_specs", "speaker_ids")
LOSS_KEYS = ("speaker_loss", "post_mult_loss", "duration_loss",
             "energy_loss", "pitch_loss", "mel_spec_l1_loss",
             "mel_spec_l2_loss")
# the train step's metrics, in the order of its graph's output vector
TRAIN_METRICS = ("loss",) + LOSS_KEYS + ("grad_norm", "learning_rate")
EVAL_METRICS = ("loss",) + LOSS_KEYS + ("speaker_accuracy", "count")
# the most graphs a train step keeps: its update and the micro-batch loops
# of the batch signatures last run (an LJ+ESD-like corpus needs 26-30 an
# epoch at the default buckets; each keeps a full set of gradients)
STEP_GRAPHS = 64
# the training kernels' counts of launches under capture: K2, K3, K4 in
# each direction, and of those the tensor-core instance's
TRAIN_CAPTURED = tuple((fn, f"{tc}{d}_captured")
                       for fn in (attention_core, conv_ff_train,
                                  conv_ff_train_blocked)
                       for d in ("fwd", "bwd") for tc in ("", "tc_"))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class Optimizer:
    """Clip-if-finite -> L2 weight decay -> Adam -> -lr(count + 1), in
    place on ``params``; state: the 0-based ``count`` and Adam's moments.

    ``count`` may be set alone: a resume without optimizer state sets it
    to the checkpoint's iteration so the learning rate continues its
    schedule (the moments restart at zero).

    :param names: the parameters' names (default their indices), the
        keys of :meth:`state_dict`
    """

    def __init__(self, params, hp, names=None):
        self.params = list(params)
        self.names = [str(i) for i in range(len(self.params))] \
            if names is None else list(names)
        assert len(self.names) == len(self.params)
        self.clip = float(hp.grad_clip_thresh)
        self.weight_decay = hp.weight_decay
        self.b1, self.b2 = hp.betas
        self.eps = hp.epsilon
        self.schedule = make_lr_schedule(hp)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def scalars(self, count):
        """(bias corrections bc1 and bc2, step size -lr) at the 1-based
        ``count``, a float32 scalar tensor: device values, no host read."""
        one = torch.ones((), dtype=torch.float32, device=count.device)
        return (1 - (one * self.b1) ** count, 1 - (one * self.b2) ** count,
                -self.schedule(count))

    @torch.no_grad()
    def update(self, grads, count):
        """Apply one update from ``grads`` (aligned with ``params``) at the
        1-based ``count`` (a float32 scalar tensor on the parameters'
        device); ``self.count`` is left to the caller."""
        grads = [g.float() for g in grads]
        if math.isfinite(self.clip):
            norm = global_norm(grads)
            keep = norm < self.clip
            grads = [torch.where(keep, g, (g / norm) * self.clip)
                     for g in grads]
        if self.weight_decay:
            grads = [g + self.weight_decay * p
                     for g, p in zip(grads, self.params)]
        bc1, bc2, step_size = self.scalars(count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g.square() + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(step_size * update)

    @torch.no_grad()
    def step(self, grads):
        """Apply one update from ``grads`` (aligned with ``params``)."""
        self.update(grads, torch.full((), float(self.count + 1),
                                      device=self.params[0].device))
        self.count += 1

    def state_dict(self) -> dict:
        """{"count", "mu", "nu"}: the moments by parameter name (the live
        tensors: copy them before the next step changes them)."""
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        assert set(state["mu"]) == set(self.names) == set(state["nu"]), \
            "optimizer state does not match the parameters"
        for name, mu, nu in zip(self.names, self.mu, self.nu):
            mu.copy_(state["mu"][name])
            nu.copy_(state["nu"][name])
        self.count = int(state["count"])


def dropout_seed(hp, iteration: int) -> int:
    """The seed of this rank's dropout generator at ``iteration``, from
    (``hp.seed``, rank, iteration): ranks draw independent masks (the JAX
    mesh step folds the device index into its key), rank 0 draws the same
    with or without a process group, and a resumed run draws what the
    uninterrupted one drew."""
    return int(np.random.SeedSequence(
        [hp.seed, rank(), iteration]).generate_state(1)[0])


def make_optimizer(params, hp, names=None):
    """:return: (optimizer, schedule)."""
    opt = Optimizer(params, hp, names)
    return opt, opt.schedule


def to_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _graph_args(batch):
    """The batch's arrays in ``INPUT_KEYS`` order, as the graphs take them
    (numpy arrays or tensors)."""
    return tuple(v if isinstance(v, torch.Tensor) else np.asarray(v)
                 for v in (batch[k] for k in INPUT_KEYS))


def _metrics(keys, vector) -> dict:
    """A graph's metric vector as a dict of float32 scalar tensors that
    outlive the next replay (one copy)."""
    return dict(zip(keys, vector.clone().unbind()))


class _Drawing:
    """Dropout of a step drawn from ``rng`` (the generator registered with
    the step's graphs) in the state of the caller's ``generator``, which
    gets the advanced state back: the step draws what an eager step on
    ``generator`` would, and moves it on as far."""

    def __init__(self, rng, generator):
        if generator is not None and generator.device.type \
                != rng.device.type:
            raise ValueError(f"the step draws dropout on {rng.device}; "
                             f"got a generator on {generator.device}")
        self.rng, self.generator = rng, generator

    def __enter__(self):
        if self.generator is not None:
            self.rng.set_state(self.generator.get_state())
        return self.rng if self.generator is not None else None

    def __exit__(self, *exc):
        if self.generator is not None and exc[0] is None:
            self.generator.set_state(self.rng.get_state())
        return False


def batch_to_inputs(batch):
    return tuple(batch[k] for k in INPUT_KEYS)


def batch_to_targets(batch):
    return tuple(batch[k] for k in TARGET_KEYS)


def make_train_step(model, hp, device=None):
    """Build the train step (with a fresh :class:`Optimizer` over the
    model's named parameters, kept as ``step.optimizer``, and its graphs,
    ``step.graphs``).

    :param device: where batches go (default: the model's device)
    :return: step(batch, generator, iteration) -> metrics; ``batch`` maps
        the keys of ``INPUT_KEYS`` to arrays shaped (accumulation_steps,
        micro_batch / world_size, ...): this rank's rows; ``generator``
        (on the model's device) seeds dropout and is advanced past the
        step's draws (None draws nothing: dropout must then be off);
        metrics are float32 scalar tensors: ``loss``, the seven terms,
        ``grad_norm`` (before clipping) and ``learning_rate`` =
        schedule(iteration), averaged over the ranks. The step updates the
        model's parameters in place and leaves the gradients (averaged
        over the ranks) in their ``.grad``.
    """
    dp = world_size()
    assert hp.batch_size % dp == 0, (
        f"batch_size ({hp.batch_size}) is the GLOBAL micro-batch "
        f"and must be divisible by the data-parallel size ({dp} "
        f"devices); effective batch = batch_size x "
        f"accumulation_steps (see docs/deployment.md)")
    names, params = zip(*model.named_parameters())
    params = list(params)
    optimizer, schedule = make_optimizer(params, hp, names)
    accum = hp.accumulation_steps
    device = params[0].device if device is None else torch.device(device)
    rng = torch.Generator(device=device)
    graphs = GraphCache(device, TRAIN_CAPTURED, generators=(rng,),
                        max_entries=STEP_GRAPHS)
    state = params + optimizer.mu + optimizer.nu

    sizes = [p.numel() for p in params] + [1 + len(LOSS_KEYS)]

    def accumulate(generator, iteration, *inputs):
        """The micro-batch loop: one float32 vector of the gradients,
        flattened in parameter order, then the mean loss and its seven
        terms. K3/K4's bf16 weights are cast inside it, so that a graph
        casts them at every replay."""
        drop_tc_weights()
        for p in params:
            p.grad = None
        tot_loss = torch.zeros((), device=device)
        indiv = {k: torch.zeros((), device=device) for k in LOSS_KEYS}
        for i in range(accum):
            micro = {k: v[i] for k, v in zip(INPUT_KEYS, inputs)}
            with torch.enable_grad():  # the graphs run under no_grad
                outputs = model(batch_to_inputs(micro), train=True,
                                generator=generator)
                loss, terms = compute_loss(outputs, batch_to_targets(micro),
                                           iteration, hp)
                (loss / accum).backward()
            tot_loss += loss.detach() / accum
            for k in LOSS_KEYS:
                indiv[k] += terms[k].detach() / accum
        return torch.cat(
            [torch.zeros(p.numel(), device=device) if p.grad is None
             else p.grad.reshape(-1) for p in params]
            + [tot_loss[None]] + [indiv[k][None] for k in LOSS_KEYS])

    def update(flat, count, iteration):
        """Norm and update from ``accumulate``'s vector: (the metric vector
        in ``TRAIN_METRICS`` order, the gradients as views of ``flat``)."""
        grads = [g.view_as(p) for g, p in zip(flat.split(sizes), params)]
        grad_norm = global_norm(grads)
        optimizer.update(grads, count)
        return torch.cat([flat[-len(LOSS_KEYS) - 1:], grad_norm[None],
                          schedule(iteration)[None]]), grads

    def step(batch, generator, iteration):
        # a graph reads the parameters and moments at their addresses: one
        # replaced (not copied into) invalidates every graph
        addresses = tuple(t.data_ptr() for t in state)
        if addresses != step.addresses:
            graphs.drop()
            step.addresses = addresses
        inputs = _graph_args(batch)
        it = np.asarray(iteration, np.float32)
        count = np.asarray(optimizer.count + 1, np.float32)
        with _Drawing(rng, generator) as drawing:
            key = drawing is None  # a step without a generator draws none
            flat = graphs.run(
                ("accumulate", key),
                lambda i, *x: accumulate(drawing, i, *x), (it, *inputs))
        if torch.distributed.is_initialized():
            # the mean over the global batch; one collective a step
            all_reduce_mean([flat])
        vector, grads = graphs.run("update", update, (flat, count, it))
        # the gradients of this step, views of the update's input (the
        # next step rewrites them)
        for p, g in zip(params, grads):
            p.grad = g
        if graphs.cuda:
            torch.autograd.graph.increment_version(state)
        optimizer.count += 1
        return _metrics(TRAIN_METRICS, vector)

    step.optimizer = optimizer
    step.graphs = graphs
    step.addresses = None
    return step


def make_eval_step(model, hp, device=None):
    """Validation step: loss on a (B, ...) batch, no dropout, no
    gradients; one graph per batch signature (``step.graphs``), K1's
    weights packed inside it from the current parameters.

    :return: step(batch, row_mask) -> metrics; ``row_mask`` (B,) 0/1 marks
        real rows: the metrics are weighted means over them, plus
        ``speaker_accuracy`` (the adversary's top-1 accuracy) and
        ``count``, the number of valid rows.
    """
    device = next(model.parameters()).device if device is None \
        else torch.device(device)
    graphs = GraphCache(device)

    def evaluate(row_mask, *inputs):
        # K1's weights packed in the pass (a graph repacks at every
        # replay), and not kept past it: the parameters move between
        # validations
        drop_kernel_weights(model)
        batch = dict(zip(INPUT_KEYS, inputs))
        outputs = model(batch_to_inputs(batch), train=False)
        drop_kernel_weights(model)
        loss, indiv = compute_loss(outputs, batch_to_targets(batch), 0, hp,
                                   row_weights=row_mask)
        hits = (outputs[0].argmax(-1) == batch["speaker_ids"].long()).float()
        w = row_mask.float()
        return torch.stack(
            [loss] + [indiv[k] for k in LOSS_KEYS]
            + [(hits * w).sum() / w.sum().clamp_min(1.0), w.sum()])

    @torch.no_grad()
    def step(batch, row_mask):
        row_mask = row_mask if isinstance(row_mask, torch.Tensor) \
            else np.asarray(row_mask)
        vector = graphs.run("eval", evaluate,
                            (row_mask, *_graph_args(batch)))
        return _metrics(EVAL_METRICS, vector)

    step.graphs = graphs
    return step
