"""Host-side utilities (own copy of the parts of ``daft_exprt_tpu.utils``
that inference and training need): chunking, the process-pool launcher
with centralized queue logging, the plots (synthesis previews,
histograms, prediction scatters), the training batches' prefetch thread
and the per-op device time of a ``torch.profiler`` trace.
"""

from __future__ import annotations

import gc
import logging
import multiprocessing as mp
import sys
import threading
import time
from functools import partial

_logger = logging.getLogger(__name__)


def chunker(seq, size: int):
    """Yield successive chunks of ``size`` items from ``seq``."""
    return (seq[pos:pos + size] for pos in range(0, len(seq), size))


def get_nb_jobs(n_jobs) -> int:
    """Resolve an ``n_jobs`` spec ('max' or int) to a concrete count."""
    max_jobs = mp.cpu_count()
    if n_jobs == "max":
        return max_jobs
    n = int(n_jobs)
    if n > max_jobs:
        _logger.warning(
            f"Requested {n} parallel jobs but only {max_jobs} CPUs -- "
            f"using {max_jobs}")
        return max_jobs
    return n


def _progress(i: int, n: int, t0: float, bar_size: int = 16):
    done = ((i + 1) * bar_size) // n
    bar = "#" * done + "-" * (bar_size - done)
    eta = (n - i - 1) * (time.time() - t0) / (i + 1)
    mins, secs = divmod(int(eta), 60)
    hours, mins = divmod(mins, 60)
    end = " Finished!\n" if i + 1 == n else " "
    sys.stdout.write(f"\r{bar} {i + 1}/{n} -- ETA {hours:02}:{mins:02}:"
                     f"{secs:02} --{end}")


def _log_listener(queue):
    while True:
        record = queue.get()
        if record is None:
            break
        _logger.handle(record)


def worker_logger(log_queue) -> logging.Logger:
    """Build a per-worker logger that forwards to the parent's queue."""
    import logging.handlers
    import uuid
    root = logging.getLogger()
    has_queue_handler = any(
        isinstance(h, logging.handlers.QueueHandler)
        for h in root.handlers)
    if not has_queue_handler:
        root.setLevel(logging.INFO)
        # replace any handlers inherited over fork: N workers writing
        # concurrently to the parent's stream/file handlers interleave
        # and corrupt lines -- everything routes through the queue to
        # the parent's listener thread instead
        root.handlers = [logging.handlers.QueueHandler(log_queue)]
    return logging.getLogger(f"worker{uuid.uuid4()}")


def launch_multi_process(iterable, func, n_jobs: int, chunksize: int = 1,
                         ordered: bool = True, timer_verbose: bool = True,
                         **kwargs):
    """Fan ``func`` out over ``iterable`` with a process pool.

    ``func`` must accept a ``log_queue`` keyword (pass it to
    ``worker_logger`` to log from workers); results are gathered into a
    list (input order preserved when ``ordered``).
    """
    # fork, as the JAX package does: workers inherit the parent's seeded
    # ``random`` state (phonemizer variant draws repeat run for run) and
    # start without re-importing ``__main__``. RULE: worker functions are
    # numpy/matplotlib only -- a forked child of a process holding a CUDA
    # context fails on its first CUDA call. Device work (mel, Griffin-Lim)
    # stays batched in the main process.
    ctx = mp.get_context("fork")
    n = len(iterable)
    # the parent's unreachable cycles are collected before the forks: a
    # child's collector would otherwise finalize the CUDA objects among
    # them (CUDA graphs, pinned buffers), and a CUDA call in a forked
    # child aborts it
    gc.collect()
    manager = ctx.Manager()
    queue = manager.Queue()
    listener = threading.Thread(target=_log_listener, args=(queue,))
    listener.start()

    results = []
    t0 = time.time()
    try:
        with ctx.Pool(processes=max(min(n_jobs, n), 1)) as pool:
            bound = partial(func, log_queue=queue, **kwargs)
            it = (pool.imap if ordered else pool.imap_unordered)(
                bound, iterable, chunksize=chunksize)
            for i, out in enumerate(it):
                results.append(out)
                if timer_verbose and n:
                    _progress(i, n, t0)
            pool.close()
            pool.join()
    finally:
        # always release the (non-daemon) listener thread -- a worker
        # exception re-raised by imap would otherwise leave it blocked
        # on queue.get() and deadlock interpreter shutdown
        queue.put(None)
        listener.join()
        manager.shutdown()
    return results


def save_preview_plot(item, output_dir, log_queue):
    """Process-pool worker of ``inference.generate.save_previews``: one
    (file_name, mel, alignment) plot (numpy and matplotlib only; workers
    never touch the card)."""
    import os
    logger = worker_logger(log_queue)
    file_name, mel_spec, weight = item
    try:
        plot_2d_data(data=(mel_spec, weight),
                     x_labels=("Mel-Spec Prediction", "Alignments"),
                     filename=os.path.join(output_dir, f"{file_name}.png"))
    except Exception as e:  # previews must not kill generation
        logger.warning(f"preview plot failed for {file_name}: {e}")


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_histogram(data, filename=None, fig=None, n_rows=1, n_cols=1,
                   plot_id=1, x_label=""):
    plt = _mpl()
    fig = fig or plt.figure(figsize=(6 * n_cols, 4 * n_rows))
    ax = fig.add_subplot(n_rows, n_cols, plot_id)
    ax.hist(data, bins=50)
    ax.set_xlabel(x_label)
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig


def plot_scatter(targets, preds, filename=None, fig=None, n_rows=1,
                 n_cols=1, plot_id=1, x_label=""):
    plt = _mpl()
    fig = fig or plt.figure(figsize=(6 * n_cols, 4 * n_rows))
    ax = fig.add_subplot(n_rows, n_cols, plot_id)
    ax.scatter(targets, preds, s=4, alpha=0.5)
    lim = [min(min(targets), min(preds)), max(max(targets), max(preds))]
    ax.plot(lim, lim, "r--", linewidth=1)
    ax.set_xlabel(f"{x_label} target")
    ax.set_ylabel(f"{x_label} prediction")
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig


def plot_2d_data(data, x_labels=(), filename=None):
    """Stack of 2-D arrays (mel-specs, alignment maps) as image panels."""
    plt = _mpl()
    n = len(data)
    fig, axes = plt.subplots(n, 1, figsize=(10, 3 * n), squeeze=False)
    for i, arr in enumerate(data):
        ax = axes[i, 0]
        im = ax.imshow(arr, aspect="auto", origin="lower",
                       interpolation="none")
        fig.colorbar(im, ax=ax)
        if i < len(x_labels):
            ax.set_title(x_labels[i])
    fig.tight_layout()
    if filename:
        fig.savefig(filename)
        plt.close(fig)
    return fig


def prefetch_iterator(iterable, depth: int = 3):
    """Run ``iterable`` in a background thread, keeping ``depth`` items
    ready.

    Host-side batch assembly (``.npy`` reads + collation, numpy only)
    overlaps the device's work on the previous step; the host-to-device
    copy stays with the consumer. Exceptions in the producer re-raise at
    the consuming site. When the consumer stops early (break,
    GeneratorExit) the producer is told to stop and is joined, instead of
    blocking forever on a full queue.
    """
    import queue

    q = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(obj):
        """stop-aware put: never block forever on an abandoned queue."""
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # re-raised by the consumer
            put(e)
        finally:  # a generator's own clean-up runs on this thread
            close = getattr(iterable, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


# the device rows of a torch.profiler Chrome trace, by category
DEVICE_OP_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DEVICE_RANGE_CAT = "gpu_user_annotation"


def aggregate_device_trace(trace_dir: str, level: str = "ops"):
    """Aggregate per-op device time from ``torch.profiler`` Chrome traces.

    Reads the newest ``*.json`` or ``*.json.gz`` under ``trace_dir``
    (``prof.export_chrome_trace`` or ``tensorboard_trace_handler``),
    keeps its complete (``"X"``) device rows and sums their duration by
    name. ``level`` selects:

    - ``"ops"`` (default): kernels, copies and sets (categories
      ``kernel``, ``gpu_memcpy``, ``gpu_memset``);
    - ``"ops_exclusive"``: the same rows with nesting resolved on each
      device stream by interval containment: an enclosing row is charged
      only its self time (on a CUDA stream, where kernels do not nest,
      this equals ``"ops"``);
    - ``"modules"``: the ``record_function`` ranges as the device sees
      them (``gpu_user_annotation``: first to last kernel of the range);
    - ``"all"``: every device row, ranges included (double counts; the
      raw view).

    :return: (collections.Counter op_name -> total ms, total_ms)
    """
    import collections
    import glob
    import gzip
    import json
    import os

    if level not in ("ops", "ops_exclusive", "modules", "all"):
        raise ValueError(f"unknown level {level!r}")
    files = [p for pattern in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(trace_dir, "**", pattern), recursive=True)]
    if not files:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    path = max(files, key=lambda p: (os.path.getmtime(p), p))
    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])

    def keep(e):
        if e.get("ph") != "X":
            return False
        cat = e.get("cat", "")
        if level in ("ops", "ops_exclusive"):
            return cat in DEVICE_OP_CATS
        if level == "modules":
            return cat == DEVICE_RANGE_CAT
        return cat in DEVICE_OP_CATS or cat == DEVICE_RANGE_CAT

    if level == "ops_exclusive":
        by_stream = collections.defaultdict(list)
        for e in events:
            if keep(e):
                by_stream[(e.get("pid"), e.get("tid"))].append(
                    (e.get("ts", 0), e.get("dur", 0), e.get("name", "?")))
        agg = collections.Counter()
        for rows in by_stream.values():
            # parents start no later and end no earlier than children;
            # sorting by (start, -dur) visits parents first
            rows.sort(key=lambda r: (r[0], -r[1]))
            stack = []  # (end_ts, name)
            for ts, dur, name in rows:
                while stack and stack[-1][0] <= ts:
                    stack.pop()
                agg[name] += dur / 1e3
                if stack:  # charge only self time to the parent
                    agg[stack[-1][1]] -= dur / 1e3
                stack.append((ts + dur, name))
        return agg, sum(agg.values())

    agg = collections.Counter()
    total = 0.0
    for e in events:
        if keep(e):
            ms = e.get("dur", 0) / 1e3
            agg[e.get("name", "?")] += ms
            total += ms
    return agg, total
