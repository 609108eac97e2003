"""Open-loop text-to-waveform serving through ``cli.serve``'s
``SynthesisService`` in process, its ``DynamicBatcher`` collating the
requests.

Set-up (``setup_s``): weights from the seed on the device, written as a
checkpoint and a HiFi-GAN ``g_*`` file with a style bank under ``TMPDIR``;
the service built on them; its own warm-up (every output bucket, batch
size and symbol bucket the traffic reaches); the FiLM cache primed for
every (reference, speaker) of the bank, as a running service has it; a
full garbage collection.

Window: requests arrive at the traffic's fixed rate, Poisson, each a
pre-phonemized sentence from the corpus model with a bank reference and a
speaker; each is timed from when it was due to when its waveform came
back. The traffic's sizes and gaps are one fixed draw; the run's seed
draws the sentences' phones, speakers and references.

Correctness: a sample of the window's requests drawn from the seed, the
longest among them, is synthesized again by the plain reference (float32
acoustic model and HiFi-GAN) from the same inputs, each padded as the
batch that served it: to the symbol bucket of that batch's longest
sentence, the batch's rows as the benchmark's span around
``run_jobs`` recorded them. Each waveform's frame count must be equal;
of the waveforms' L2 distances, relative to the reference's deviation
from its own mean, the 90th percentile over the sample must be under its
limit, and at most ``wavs_over_answer_limit`` of them over the per-answer
limit (one altered answer among many: the largest is recorded, PERF.md
says why it is not compared). The last ``tail_frames`` frames' samples
are left out: within the generator's receptive field of the end they
depend on how far the program padded.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from harness import common, corpus, model_files, seeding, trace
from reference import daftexprt as ref_model
from reference import hifigan as ref_vocoder
from reference.numerics import Numerics, no_tf32


class Traffic:
    """The schedule: the window's requests, then the traced slice's. Each
    part is one fixed draw (``base_seed``) of arrival gaps and sentence
    lengths: every seed offers requests of the same lengths at the same
    times (the order of long sentences sets the tail as much as the
    program does). Sentences' phones, speakers and references come from
    the run's seed."""

    def __init__(self, cfg, tr, seed: int, bank_size: int, seconds: float):
        base = np.random.default_rng(tr["base_seed"])
        lengths = corpus.corpus_lengths()
        order = seeding.rng(seed, "schedule")
        self.symbols, self.due, self.parts = [], [], []
        for span in (seconds, tr["trace_seconds"]):
            n = max(int(round(tr["rate_per_s"] * span)), 1)
            pick = base.choice(len(lengths), n, replace=False)
            gaps = base.exponential(1.0 / tr["rate_per_s"], n)
            gaps *= span / gaps.sum()  # n requests over exactly ``span``
            self.parts.append((len(self.symbols), n))
            self.symbols += [lengths[i][0] + 1 for i in pick]  # + EOS
            self.due += list(np.cumsum(gaps))
        total = len(self.symbols)
        self.speakers = order.integers(0, len(cfg["speakers"]), total)
        self.styles = order.integers(0, bank_size, total)
        words = seeding.rng(seed, "sentences")
        self.sentences = [model_files.random_sentence(words, n,
                                                      cfg["symbols"])
                          for n in self.symbols]

    def max_symbols(self):
        return max(len(ids) for _, ids in self.sentences)


def setup(ctx):
    from daft_exprt_tpu_torch.cli.serve import SynthesisService

    cfg, tr = ctx.cfg, ctx.traffic
    hp = model_files.hparams(cfg, str(ctx.scratch / "exp"))
    P, V, bank, traffic, keep = feed(ctx)
    ckpt = ctx.scratch / "acoustic.pt"
    model_files.write_checkpoint(ckpt, P, hp)
    g, gcfg = model_files.write_vocoder(ctx.scratch, V, cfg)
    names = model_files.write_bank(ctx.scratch / "bank", bank)
    buckets = -(-traffic.max_symbols() // cfg["symbol_bucket"])
    service = SynthesisService(
        str(ckpt), str(ctx.scratch / "bank"), vocoder=g,
        vocoder_config=gcfg, batch_window_ms=tr["batch_window_ms"],
        max_batch=tr["max_batch"], warmup_symbol_buckets=buckets,
        device=ctx.device)
    service.warmup((tr["pitch_transform"],))
    # the FiLM cache primed for every (reference, speaker), a style at a
    # time (a batch's references pad to its longest: one style's FiLMs are
    # then those of its own reference padded to its own bucket)
    text, _ = model_files.random_sentence(np.random.default_rng(0), 8,
                                          cfg["symbols"])
    speakers = range(len(cfg["speakers"]))
    for name in names:
        for i in range(0, len(speakers), tr["max_batch"]):
            jobs = [service.prepare_job(text, speaker_id=k, style=name,
                                        pitch_transform=tr["pitch_transform"])
                    for k in speakers[i:i + tr["max_batch"]]]
            service.run_jobs(jobs, tr["pitch_transform"])
    return service, P, V, bank, traffic, keep


class EngineSpans:
    """The benchmark's span around each engine call (the service's
    ``run_cached_to_audio``): its host seconds, padded rows, the real
    rows' output frames and the output bucket it decoded at (the key of
    the audio graph last run, where the engine says)."""

    def __init__(self, engine):
        self.engine = engine
        self.calls = []
        self.on = False
        inner = engine.run_cached_to_audio

        def wrapped(inputs, pitch_transform, film_keys):
            t0 = time.perf_counter()
            out = inner(inputs, pitch_transform, film_keys)
            t1 = time.perf_counter()
            if self.on:
                real = [i for i, k in enumerate(film_keys) if k is not None]
                self.calls.append({
                    "t0": t0, "t1": t1, "rows_padded": len(film_keys),
                    "frames": [int(out[1][i]) for i in real],
                    "symbols": [int(inputs[4][i]) for i in real],
                    "bucket": self.bucket()})
            return out

        engine.run_cached_to_audio = wrapped

    def bucket(self):
        entries = getattr(self.engine.graphs, "entries", None)
        if not entries:
            return None
        key = next(reversed(entries))[0]
        if isinstance(key, tuple) and key and key[0] == "audio":
            return int(key[-1])
        return None


class Batches:
    """The benchmark's span around each batch the service runs
    (``run_jobs``, which the batcher calls): when it started and which
    requests of the schedule it held, each request known by the job that
    ``prepare_jobs`` made for it on the request's own thread."""

    def __init__(self, service):
        self.batches = []
        self.on = False
        self.local = threading.local()
        tags = {}
        prepare, run_jobs = service.prepare_jobs, service.run_jobs

        def prepared(*args, **kwargs):
            jobs = prepare(*args, **kwargs)
            for job in jobs:
                tags[id(job)] = getattr(self.local, "index", None)
            return jobs

        def ran(jobs, *args, **kwargs):
            t0 = time.perf_counter()
            out = run_jobs(jobs, *args, **kwargs)
            if self.on:
                self.batches.append({"t0": t0, "rows": [tags.get(id(j))
                                                        for j in jobs]})
            return out

        service.prepare_jobs, service.run_jobs = prepared, ran

    def of(self, traffic, cfg):
        """{schedule index: (the batch's start, the symbols its sentences
        pad to)}: the bucket of the batch's longest sentence, as the
        benchmark reckons it."""
        out = {}
        for b in self.batches:
            rows = [j for j in b["rows"] if j is not None]
            if not rows:
                continue
            L = model_files.bucket(
                max(len(traffic.sentences[j][1]) for j in rows),
                cfg["symbol_bucket"], cfg["max_symbols"])
            for j in rows:
                out[j] = (b["t0"], L)
        return out


class Collections:
    """The interpreter's garbage collections while on: (generation,
    seconds) each. A collection stops every thread of the process, the
    service's and the clients' alike."""

    def __init__(self):
        self.pauses = []
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t0))

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def offer(service, traffic, tr, part: int, keep, batches=None):
    """The open-loop requests of ``traffic``'s part (0: the window, 1: the
    traced slice), each sent when due: [{index, due, done, frames, wav for
    those in ``keep``}], and the generator's lateness."""
    start, n = traffic.parts[part]
    due = np.asarray(traffic.due[start:start + n])
    out = [None] * n
    lock = threading.Lock()

    def one(i):
        j = start + i
        text, _ = traffic.sentences[j]
        rec = {"index": j, "due": t0 + due[i]}
        if batches is not None:
            batches.local.index = j
        try:
            wav, frames, _, _ = service.synthesize(
                text, split=False, speaker_id=int(traffic.speakers[j]),
                style=f"ref_{int(traffic.styles[j]):02d}",
                pitch_transform=tr["pitch_transform"])
            rec["done"] = time.perf_counter()
            rec["frames"] = int(frames)
            if j in keep:
                rec["wav"] = np.array(wav, copy=True)
        except Exception as e:  # noqa: BLE001 -- a failed request
            rec["done"] = None
            rec["error"] = repr(e)
        with lock:
            out[i] = rec

    late = []
    with ThreadPoolExecutor(max_workers=tr["client_threads"]) as pool:
        t0 = time.perf_counter()
        futures = []
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - (t0 + due[i]))
            futures.append(pool.submit(one, i))
        for f in futures:
            f.result(timeout=tr["drain_timeout_s"])
    return out, t0, late


def run(ctx):
    cfg, tr = ctx.cfg, ctx.traffic
    service, P, V, bank, traffic, keep = setup(ctx)
    spans = EngineSpans(service.engine)
    batched = Batches(service)
    if ctx.fault is not None:
        ctx.fault(service)
    sync = torch.cuda.synchronize if ctx.device == "cuda" else (lambda: None)
    sync()
    # set-up's survivors (the warm-up's graphs, the primed cache) collected
    # in set-up: otherwise the window pays for them, in full collections
    # of 0.2-0.3 s that stop every thread and fall where they happen to
    gc.collect()
    setup_s = time.perf_counter() - ctx.t_start

    before = dict(service.stats()["batch_sizes"])
    captures0 = service.engine.graphs.captures
    spans.on = batched.on = True
    with Collections() as collected:
        reqs, t0, late = offer(service, traffic, tr, 0, keep, batched)
        sync()
    spans.on = batched.on = False
    served = batched.of(traffic, cfg)
    window_calls = spans.calls
    spans.calls = []
    captures = service.engine.graphs.captures - captures0
    after = dict(service.stats()["batch_sizes"])
    batches = {int(k): after.get(k, 0) - before.get(k, 0) for k in after}

    lat = [None if r["done"] is None else r["done"] - r["due"]
           for r in reqs]
    failed = sum(r["done"] is None for r in reqs)
    waits = [served[r["index"]][0] - r["due"] for r in reqs
             if r["index"] in served]
    record = {
        "window_s": ctx.seconds,
        "latency_s": lat,
        "lateness_s": late,
        "queue_wait_s": waits,
        "gc_pauses_s": collected.pauses,
        "batch_sizes": batches,
        "engine_calls": window_calls,
        "window_captures": captures,
        "config": cfg,
    }

    sl = None
    if ctx.trace:
        work = {"engine_calls": spans.calls}
        spans.on = True
        sl = trace.profile(lambda: offer(service, traffic, tr, 1, set()),
                           work)
        spans.on = False
    memory = common.device_info(ctx.chips) if ctx.device == "cuda" else {}

    # the program's state goes before the reference runs
    service.engine.graphs.drop()
    del service
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    calls = [(c["t1"] - c["t0"]) * 1e3 for c in window_calls]
    rows = [len(c["frames"]) for c in window_calls]
    print(f"serve: latency p50 {common.percentile(lat, 50) * 1e3!r} ms, "
          f"p95 {common.percentile(lat, 95) * 1e3!r} ms; queue wait p50 "
          f"{common.percentile(waits, 50) * 1e3!r} ms, p95 "
          f"{common.percentile(waits, 95) * 1e3!r} ms; engine call p50 "
          f"{common.percentile(calls, 50)!r} ms, p95 "
          f"{common.percentile(calls, 95)!r} ms, {len(calls)} calls, "
          f"{np.mean(rows) if rows else 0.0!r} rows a call; generator late "
          f"p99 {common.percentile(late, 99) * 1e3!r} ms, max "
          f"{max(late, default=0.0) * 1e3!r} ms; collections of generation "
          f"2 {sum(g == 2 for g, _ in collected.pauses)}, all "
          f"{len(collected.pauses)} for "
          f"{sum(d for _, d in collected.pauses) * 1e3!r} ms, longest "
          f"{max((d for _, d in collected.pauses), default=0.0) * 1e3!r} ms",
          file=sys.stderr)
    checks = check(ctx, P, V, bank, traffic, reqs, keep,
                   {j: served[j][1] for j in keep if j in served})
    e2e = {"latency_p95_ms": common.percentile(lat, 95) * 1e3,
           "setup_s": setup_s}
    return {"e2e": e2e, "record": record, "slice": sl, "checks": checks,
            "attempted": len(reqs), "failed": failed, "device": memory}


def reference_wave(nx, P, V, cfg, film_rows, ids, L_pad, speaker, stats):
    """The reference's waveform and frame count of one request, its
    symbols padded to ``L_pad`` as its batch padded them."""
    dev = P["frame_decoder.projection.linear_layer.bias"].device
    sym = torch.zeros((1, L_pad), dtype=torch.int32, device=dev)
    sym[0, :len(ids)] = torch.as_tensor(ids, device=dev)
    lengths = torch.tensor([len(ids)], device=dev)
    spk = torch.tensor([speaker], device=dev)
    audio = cfg["audio"]
    mel, out_len = ref_model.synthesize(
        nx, P, cfg, audio, sym, lengths, film_rows, stats[0], stats[1], spk,
        cfg["max_frames"])
    n = int(out_len[0])
    floor = float(np.log(1e-5))
    padded = torch.full((1, mel.shape[1], n + cfg["vocoder_margin_frames"]),
                        floor, device=dev)
    padded[:, :, :n] = mel[:, :, :n]
    wav = ref_vocoder.generate(nx, V, cfg["vocoder"], padded)
    return wav[0, :n * audio["hop_length"]].cpu().numpy(), n


def padded_reference(ref, T_pad, device):
    """A reference's (energy, pitch, mel) zero-padded to ``T_pad`` frames,
    a batch of one."""
    t = ref["mel_spec"].shape[1]
    e = torch.zeros((1, T_pad), device=device)
    p = torch.zeros((1, T_pad), device=device)
    m = torch.zeros((1, ref["mel_spec"].shape[0], T_pad), device=device)
    e[0, :t] = torch.as_tensor(ref["energy"], device=device)
    p[0, :t] = torch.as_tensor(ref["pitch"], device=device)
    m[0, :, :t] = torch.as_tensor(ref["mel_spec"], device=device)
    return e, p, m


@torch.no_grad()
def reference_outputs(nx, cfg, P, V, bank, traffic, indices, pads):
    """{schedule index: (waveform, frames)} of the reference; ``pads``
    gives each request's padded symbol count (default: its own
    bucket)."""
    dev = P["frame_decoder.projection.linear_layer.bias"].device
    stats = model_files.pitch_stats(cfg, dev)
    out = {}
    for j in sorted(indices):
        ref = bank[int(traffic.styles[j])]
        t = ref["mel_spec"].shape[1]
        T_pad = model_files.bucket(t, cfg["frame_bucket"], cfg["max_frames"])
        e, p, m = padded_reference(ref, T_pad, dev)
        film_rows = ref_model.films(
            nx, P, cfg, e, p, m, torch.tensor([t], device=dev),
            torch.tensor([int(traffic.speakers[j])], device=dev))
        ids = traffic.sentences[j][1]
        L_pad = pads.get(j) or model_files.bucket(
            len(ids), cfg["symbol_bucket"], cfg["max_symbols"])
        out[j] = reference_wave(nx, P, V, cfg, film_rows, ids, L_pad,
                                int(traffic.speakers[j]), stats)
    return out


def compare(cfg, got, want, limits):
    """Checks of the program's {index: (wav, frames)} against the
    reference's; a request that never came back counts as failed."""
    hop = cfg["audio"]["hop_length"]
    tail = cfg["tail_frames"] * hop
    checks = common.Checks()
    errs, mismatched, missing, empty = [], 0, 0, 0
    for j, (w_ref, n_ref) in want.items():
        if j not in got:
            missing += 1
            continue
        if n_ref <= cfg["tail_frames"]:
            empty += 1  # nothing to compare: the check would be void
            continue
        w, n = got[j]
        if n != n_ref or len(w) != len(w_ref):
            mismatched += 1
            continue
        end = max(len(w) - tail, hop)
        errs.append(common.rel_l2_centered(w[:end], w_ref[:end]))
    if errs:
        print(f"serve: {len(errs)} waveforms, relative L2 least "
              f"{min(errs)!r}, median {float(np.median(errs))!r}, largest "
              f"{max(errs)!r}", file=sys.stderr)
    checks.add("wav_rel_l2_p90",
               float(np.percentile(errs, 90)) if errs else float("nan"),
               limits["wav_rel_l2_p90"])
    checks.add("wavs_over_answer_limit",
               sum(e > limits["wav_rel_l2_answer"] for e in errs),
               limits["wavs_over_answer_limit"])
    checks.add("frames_mismatched", mismatched, 0)
    checks.add("requests_missing", missing, 0)
    checks.add("references_empty", empty, 0)
    return checks


def feed(ctx):
    """What the run feeds both sides, without the program: (weights,
    vocoder weights, bank, traffic, the sample it checks)."""
    cfg, tr = ctx.cfg, ctx.traffic
    P = model_files.acoustic_weights(cfg, ctx.seed, ctx.device)
    V = model_files.vocoder_weights(cfg, ctx.seed, ctx.device)
    base = np.random.default_rng(tr["base_seed"] + 1)
    ref_frames = [min(int(t), cfg["max_frames"]) for _, t in base.choice(
        np.asarray(corpus.corpus_lengths()), tr["bank_size"])]
    bank = model_files.style_bank(cfg, ctx.seed, tr["bank_size"],
                                  ref_frames)
    traffic = Traffic(cfg, tr, ctx.seed, len(bank), ctx.seconds)
    return P, V, bank, traffic, sample(ctx, traffic)


def sample(ctx, traffic):
    """The requests of the window the run checks, drawn from the seed,
    and the longest."""
    n_window = traffic.parts[0][1]
    pick = seeding.rng(ctx.seed, "check").choice(
        n_window, min(ctx.traffic["check_requests"], n_window),
        replace=False)
    longest = int(np.argmax(traffic.symbols[:n_window]))
    return set(int(i) for i in pick) | {longest}


def control(ctx, mode="fp8"):
    """The checks of a run whose program is the reference in ``mode``'s
    precision, on the same sample (step 2 of deciding ``correct``)."""
    if ctx.device == "cuda":
        no_tf32()
    P, V, bank, traffic, keep = feed(ctx)
    got = reference_outputs(Numerics(mode), ctx.cfg, P, V, bank, traffic,
                            keep, {})
    want = reference_outputs(Numerics("f32"), ctx.cfg, P, V, bank, traffic,
                             keep, {})
    return compare(ctx.cfg, got, want, ctx.traffic["limits"])


def check(ctx, P, V, bank, traffic, reqs, keep, pads):
    """The checks of the window's sample; ``pads``: each request's padded
    symbols, from the batch that served it."""
    if ctx.device == "cuda":
        no_tf32()
    got = {r["index"]: (r["wav"], r["frames"]) for r in reqs
           if r.get("wav") is not None}
    want = reference_outputs(Numerics("f32"), ctx.cfg, P, V, bank, traffic,
                             keep, pads)
    return compare(ctx.cfg, got, want, ctx.traffic["limits"])
