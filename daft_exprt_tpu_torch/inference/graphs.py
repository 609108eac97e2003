"""Compiled passes of the inference engine: one CUDA graph per (graph,
input signature).

Counterpart of the JAX engine's ``_jit`` and ``_compiled`` cache
(``daft_exprt_tpu/inference/engine.py``) and of the in-process half of
``daft_exprt_tpu/aot.py``: where the JAX engine runs each pass as one
compiled executable per (label, argument signature), :class:`GraphCache`
runs it as one ``torch.cuda.CUDAGraph`` replay. The on-disk half of
``aot.py`` has no counterpart here (a CUDA graph cannot be serialized);
the kernels' nvcc builds are cached on disk by ``ops/_build.py``.

An entry is keyed by the engine's graph key (``("fused", pitch_transform,
T, with_films)`` and the like) and the signature of the pass's arguments:
the shape and dtype of every array and tensor, as ``aot._arg_signature``
keys an executable. It holds static input tensors, the captured graph,
its static outputs and references to every tensor the graph reads besides
them (K1's packed weights, K5's programs), so that no address a replay
reads is ever freed.

- The first call of a signature runs the pass eagerly and returns that
  result. The eager run does the first-use work that must not happen
  under capture: the kernels' nvcc build, K1's shared-memory raise,
  cuBLAS and cuDNN handles, workspaces and algorithm choices, K1's packed
  weights and K5's programs. Then the pass is captured. A capture that
  fails raises: there is no eager fallback on CUDA.
- Later calls copy the arguments into the static inputs and replay.
- On the CPU the same keys, entries and static inputs are kept and every
  call runs the pass eagerly on the static inputs: no graph exists there.

Every graph of one cache shares one memory pool
(``torch.cuda.graph_pool_handle()``). A replay may therefore overwrite
the static outputs of any other entry: that is safe because the engine
runs one pass at a time and copies each replay's outputs out (to the
host, or into the static inputs of the next pass) before it starts
another. The outputs of :meth:`GraphCache.run` are valid until then.

The kernels' launch counters are the wrappers' alone: a wrapper counts a
launch under capture in ``.captured`` (it runs at every replay, where no
wrapper runs) and every other in ``.launches``. An entry notes the
captured counts of its capture (the counters of ``counters``: K1's and
K5's by default, K2-K4's for the training step), and
:attr:`GraphCache.replayed` adds them up at each replay: a number derived
from the capture, not counted at a launch, which only a trace of the
device can confirm.

A cache may hold at most ``max_entries`` entries: a new signature then
evicts the least recently run entry (its graph, static inputs and
outputs), and that signature, if it comes back, runs eagerly and is
captured again. The training step bounds its cache so: a corpus's batch
signatures are a few dozen an epoch, but the loader's buckets allow
hundreds, each holding a full set of gradients.

A pass that draws random numbers names its generators (``generators``):
each capture registers their states with the graph, so that a replay
draws from the generator's current seed and offset and advances the
offset by what the pass consumed, as an eager run of the pass would.

The same caches serve the vocoder's passes (``vocoder/hifigan.py``
:meth:`~daft_exprt_tpu_torch.vocoder.hifigan.HiFiGanGenerator.replayed`)
and the training and eval steps (``training/step.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from daft_exprt_tpu_torch.ops.fft_block import fused_fft_block
from daft_exprt_tpu_torch.ops.mrf_vocoder import fused_mrf

# the wrappers' counts of launches recorded under capture: K1, K1 on the
# tensor cores, K5, K5 on the tensor cores
CAPTURED = ((fused_fft_block, "captured"), (fused_fft_block, "tc_captured"),
            (fused_mrf, "captured"), (fused_mrf, "tc_captured"))


def _flatten(tree):
    """(leaves, structure) of nested lists and tuples."""
    if isinstance(tree, (list, tuple)):
        leaves, specs = [], []
        for t in tree:
            sub, spec = _flatten(t)
            leaves += sub
            specs.append(spec)
        return leaves, (type(tree), tuple(specs))
    return [tree], None


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, children = s
        return kind(build(c) for c in children)

    return build(spec)


def _leaf_signature(x):
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        return x.shape, x.dtype.str
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    raise TypeError(f"graph argument of type {type(x).__name__}: numpy "
                    "arrays, tensors and None only")


def to_host(tree):
    """Tensors -> numpy arrays of the same nesting (None stays None).

    A CUDA tensor is copied into pinned host memory without waiting, and
    the current stream is synchronized once after every copy is queued:
    one wait for the card a pass, the counterpart of the JAX engine's
    one ``device_get``. CPU tensors are copied too (a pass's outputs may
    be its static inputs).
    """
    leaves, spec = _flatten(tree)
    host, cuda = [], None
    for t in leaves:
        if t is None:
            host.append(None)
            continue
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        h.copy_(t, non_blocking=t.is_cuda)
        host.append(h)
        cuda = t.device if t.is_cuda else cuda
    if cuda is not None:
        torch.cuda.current_stream(cuda).synchronize()
    return _unflatten(spec, [None if h is None else h.numpy() for h in host])


class _Entry:
    __slots__ = ("inputs", "graph", "outputs", "recorded", "keep")

    def __init__(self, leaves, device, n_counters):
        self.inputs = [
            None if x is None else torch.empty(
                x.shape, dtype=torch.from_numpy(np.empty(0, x.dtype)).dtype
                if isinstance(x, np.ndarray) else x.dtype, device=device)
            for x in leaves]
        self.graph = self.outputs = None
        self.recorded = (0,) * n_counters  # launches the capture recorded
        self.keep = ()

    def load(self, leaves):
        """Copy a call's arguments into the static inputs: host arrays
        straight from their memory (CUDA stages a copy from pageable
        memory before the call returns), device tensors on the current
        stream."""
        for static, x in zip(self.inputs, leaves):
            if static is None:
                continue
            if isinstance(x, np.ndarray):
                # np.require keeps a 0-d array 0-d (ascontiguousarray not)
                x = torch.from_numpy(np.require(x, requirements="C"))
            static.copy_(x, non_blocking=True)


class GraphCache:
    """(graph key, argument signature) -> a captured pass.

    :param device: the engine's device; entries capture CUDA graphs on a
        CUDA device and run eagerly on the CPU
    :param counters: the (object, attribute) launch counters under
        capture whose growth an entry records (:data:`CAPTURED`)
    :param generators: the ``torch.Generator`` objects the passes draw
        from, registered with every graph
    :param max_entries: the most entries kept (None: no bound); the least
        recently run is evicted for a new one
    """

    def __init__(self, device, counters=CAPTURED, generators=(),
                 max_entries=None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.counters = tuple(counters)
        self.generators = tuple(generators)
        self.max_entries = max_entries
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.entries: dict = {}     # in the order they were last run
        self.captures = 0           # graphs captured since construction
        self.capture_seconds = 0.0  # host seconds spent capturing them
        self.replays = 0            # graph replays since construction
        self.evictions = 0          # entries evicted for max_entries
        # derived: the launches each replayed capture recorded, summed
        self.replayed = (0,) * len(self.counters)

    def _captured(self):
        return tuple(getattr(obj, name) for obj, name in self.counters)

    def __len__(self):
        return len(self.entries)

    def keys(self) -> set:
        """The graph keys of the entries, without their signatures."""
        return {key for key, _ in self.entries}

    def drop(self, select=None):
        """Drop the entries whose graph key ``select`` accepts (every entry
        without it); their graphs and static tensors go with them."""
        for k in [k for k in self.entries if select is None or select(k[0])]:
            del self.entries[k]
        self._new_pool_if_empty()

    def _new_pool_if_empty(self):
        if self.cuda and not self.entries:
            # the last graph released the pool: capturing into a released
            # pool's id fails inside the caching allocator
            self.pool = torch.cuda.graph_pool_handle()

    def pool_bytes(self) -> int:
        """Device bytes the graphs' shared memory pool holds (0 on the
        CPU)."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    @torch.no_grad()
    def run(self, key, fn, args, keep=None):
        """``fn(*args)`` through the entry of (``key``, the signature of
        ``args``).

        :param fn: the pass; device tensors in, a nest of device tensors
            out, no read of a tensor's value on the host
        :param args: a tuple of numpy arrays, tensors on the device, None
            and lists or tuples of those
        :param keep: a callable returning what the pass reads besides
            ``args`` and the parameters, held while the entry lives
        :return: ``fn``'s outputs, valid until the next call of any entry
        """
        leaves, spec = _flatten(args)
        sig = (spec, tuple(_leaf_signature(x) for x in leaves))
        # taken out and put back last: the entries stay in the order of use
        entry = self.entries.pop((key, sig), None)
        if entry is None:
            if self.max_entries is not None \
                    and len(self.entries) >= self.max_entries:
                del self.entries[next(iter(self.entries))]
                self.evictions += 1
                self._new_pool_if_empty()
            entry = _Entry(leaves, self.device, len(self.counters))
            entry.load(leaves)
            out = fn(*_unflatten(spec, entry.inputs))
            if self.cuda:
                self._capture(entry, fn, spec)
                entry.keep = keep() if keep is not None else ()
            self.entries[(key, sig)] = entry
            return out
        self.entries[(key, sig)] = entry
        entry.load(leaves)
        if not self.cuda:
            return fn(*_unflatten(spec, entry.inputs))
        entry.graph.replay()
        self.replays += 1
        self.replayed = tuple(a + b for a, b in zip(self.replayed,
                                                    entry.recorded))
        return entry.outputs

    def _capture(self, entry, fn, spec):
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        # a capture draws nothing: the generators leave it as they came
        states = [gen.get_state() for gen in self.generators]
        t0 = time.perf_counter()
        before = self._captured()
        # thread_local: another thread's CUDA calls (a server's HTTP
        # threads, a loader's) do not invalidate this capture
        with torch.cuda.device(self.device), torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"):
            outputs = fn(*_unflatten(spec, entry.inputs))
        for gen, state in zip(self.generators, states):
            gen.set_state(state)
        entry.recorded = tuple(a - b
                               for a, b in zip(self._captured(), before))
        entry.graph, entry.outputs = graph, outputs
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
