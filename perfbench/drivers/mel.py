"""Bulk mel synthesis, closed loop, through ``InferenceEngine.run`` (the
default "speculate" bucket policy): batches of sentences for an external
vocoder, as the reference repo's ``generate.py`` makes them.

The traffic is a list of batches drawn once (``base_seed``): each
``batch`` sentences with lengths from the corpus model, one style-bank
reference a batch; the run's seed orders the batches and draws their
contents (symbols, the references' features, a speaker a row). Set-up
runs every batch once, which captures every graph signature; the window
cycles through the list, one call after the other, and
``speech_s_per_s`` is the seconds of speech in the real output frames
over the window's seconds.

Correctness: a sample of the batches drawn from the seed, and the one
with the longest sentence, as the window first returned them, against
the plain reference (float32) on the same inputs: every row's output
length; of the rows' relative L2 distances over their frames, the median
must be under its limit, and at most ``rows_over_row_limit`` of them
over the per-row limit, so that a few rows altered among many fail (the
largest and the 90th percentile are recorded; PERF.md says why neither
is compared).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from harness import common, corpus, model_files, seeding, trace
from reference import daftexprt as ref_model
from reference.numerics import Numerics, no_tf32


class Batches:
    """The traffic's batches: sizes from ``base_seed``, contents and order
    from the run's seed."""

    def __init__(self, cfg, tr, seed: int):
        base = np.random.default_rng(tr["base_seed"])
        lengths = corpus.corpus_lengths()
        n, B = tr["batches"], tr["batch"]
        sym = [[lengths[i][0] + 1 for i in base.choice(len(lengths), B)]
               for _ in range(n)]  # + EOS
        refs = [min(lengths[i][1], cfg["max_frames"])
                for i in base.choice(len(lengths), n)]
        rng = seeding.rng(seed, "batches")
        order = rng.permutation(n)
        self.symbols = [sym[i] for i in order]
        self.ref_frames = [refs[i] for i in order]
        self.sentences, self.speakers, self.refs = [], [], []
        phones = np.arange(7, len(cfg["symbols"]))
        for b in range(n):
            rows = []
            for L in self.symbols[b]:
                ids = rng.choice(phones, L)
                ids[-1] = cfg["symbols"].index("~")
                rows.append(ids.astype(np.int32))
            self.sentences.append(rows)
            self.speakers.append(rng.integers(0, len(cfg["speakers"]), B))
            t = self.ref_frames[b]
            self.refs.append({
                "energy": (np.abs(rng.standard_normal(t)) + 1.0).astype(
                    np.float32),
                "pitch": rng.standard_normal(t).astype(np.float32),
                "mel_spec": rng.standard_normal(
                    (cfg["n_mel_channels"], t)).astype(np.float32)})

    def __len__(self):
        return len(self.sentences)


def collated(cfg, hp, batches, b):
    from daft_exprt_tpu_torch.inference.inputs import collate_inference_batch

    sents = [[cfg["symbols"][i] for i in row] for row in batches.sentences[b]]
    B = len(sents)
    inputs, _ = collate_inference_batch(
        sents, None, None, None, "add", [batches.refs[b]] * B,
        batches.speakers[b].tolist(), hp)
    return inputs


def checked(ctx, batches):
    """The batch indices the run checks: drawn from the seed, and the one
    holding the longest sentence."""
    n = len(batches)
    pick = seeding.rng(ctx.seed, "check").choice(
        n, min(ctx.traffic["checked_batches"], n), replace=False)
    longest = int(np.argmax([max(s) for s in batches.symbols]))
    return sorted(set(int(i) for i in pick) | {longest})


def run(ctx):
    from daft_exprt_tpu_torch.inference.engine import InferenceEngine
    from daft_exprt_tpu_torch.models.daft_exprt import DaftExprt

    cfg, tr = ctx.cfg, ctx.traffic
    hp = model_files.hparams(cfg, str(ctx.scratch / "exp"))
    P = model_files.acoustic_weights(cfg, ctx.seed, ctx.device)
    model = DaftExprt(hp, device=ctx.device)
    engine = InferenceEngine(model, {k: v for k, v in P.items()}, hp,
                             device=ctx.device)
    batches = Batches(cfg, tr, ctx.seed)
    inputs = [collated(cfg, hp, batches, b) for b in range(len(batches))]
    run_call = engine.run
    if ctx.fault is not None:
        run_call = ctx.fault(run_call)
    for x in inputs:  # every signature, captured
        run_call(x, "add", want_weights=False)
    sync = torch.cuda.synchronize if ctx.device == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - ctx.t_start
    keep = set(checked(ctx, batches))
    got = {}
    hop, sr = cfg["hop_length"], cfg["sampling_rate"]

    def call(b, calls):
        p0 = engine.passes
        t0 = time.perf_counter()
        _, (mel, out_lens, _), _ = run_call(inputs[b], "add",
                                            want_weights=False)
        t1 = time.perf_counter()
        x = inputs[b]
        calls.append({"t0": t0, "t1": t1, "batch": b,
                      "passes": engine.passes - p0,
                      "bucket": int(mel.shape[-1]),
                      "symbols_padded": int(x[0].shape[1]),
                      "symbols": x[4].tolist(),
                      "frames": [int(n) for n in out_lens],
                      "ref_padded": int(x[5].shape[1]),
                      "ref_frames": x[8].tolist()})
        return mel, out_lens

    calls, speech, i = [], 0.0, 0
    captures0 = engine.graphs.captures
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        b = i % len(batches)
        mel, out_lens = call(b, calls)
        speech += float(np.sum(out_lens)) * hop / sr
        if b in keep and b not in got:
            got[b] = (mel.copy(), np.array(out_lens, copy=True))
        i += 1
    window = time.perf_counter() - t0
    record = {"window_s": window, "calls": calls, "config": cfg,
              "window_captures": engine.graphs.captures - captures0}
    sl = None
    if ctx.trace:
        work = {"calls": []}

        def traced():
            for k in range(tr["trace_calls"]):
                call((i + k) % len(batches), work["calls"])
        sl = trace.profile(traced, work)
    memory = common.device_info(ctx.chips) if ctx.device == "cuda" else {}
    engine.graphs.drop()
    del engine, model
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, P, batches, got, sorted(keep), Numerics("f32"))
    return {"e2e": {"speech_s_per_s": speech / window, "setup_s": setup_s},
            "record": record, "slice": sl, "checks": checks,
            "attempted": len(calls), "failed": 0, "device": memory}


@torch.no_grad()
def reference_batch(nx, cfg, P, batches, b, rows_a_block: int):
    """The reference's (mels, lengths) of batch ``b``: lists a row."""
    dev = P["frame_decoder.projection.linear_layer.bias"].device
    ref = batches.refs[b]
    t = ref["mel_spec"].shape[1]
    stats = model_files.pitch_stats(cfg, dev)
    rows = batches.sentences[b]
    spk = torch.as_tensor(batches.speakers[b], device=dev)
    # as the batch was collated: symbols padded to the bucket of its
    # longest row, the reference to its own bucket
    L = model_files.bucket(max(len(r) for r in rows), cfg["symbol_bucket"],
                           cfg["max_symbols"])
    T_pad = model_files.bucket(t, cfg["frame_bucket"], cfg["max_frames"])
    pad = torch.zeros((3, T_pad), device=dev)
    pad[0, :t] = torch.as_tensor(ref["energy"], device=dev)
    pad[1, :t] = torch.as_tensor(ref["pitch"], device=dev)
    mel_ref = torch.zeros((1, ref["mel_spec"].shape[0], T_pad), device=dev)
    mel_ref[0, :, :t] = torch.as_tensor(ref["mel_spec"], device=dev)
    mels, lens = [], []
    for s in range(0, len(rows), rows_a_block):
        part = rows[s:s + rows_a_block]
        n = len(part)
        sym = torch.zeros((n, L), dtype=torch.int32, device=dev)
        for j, r in enumerate(part):
            sym[j, :len(r)] = torch.as_tensor(r, device=dev)
        lengths = torch.tensor([len(r) for r in part], device=dev)
        sp = spk[s:s + n]
        # the FiLM rows of every row's (reference, speaker)
        f = ref_model.films(
            nx, P, cfg, pad[0:1].expand(n, -1), pad[1:2].expand(n, -1),
            mel_ref.expand(n, -1, -1), torch.full((n,), t, device=dev), sp)
        mel, out = ref_model.synthesize(
            nx, P, cfg, cfg["audio"], sym, lengths, f, stats[0], stats[1],
            sp, cfg["max_frames"])
        for j in range(n):
            k = int(out[j])
            mels.append(mel[j, :, :k].cpu().numpy())
            lens.append(k)
    return mels, lens


def compare(cfg, got, want):
    """Checks of the program's {batch: (mel, lengths)} against the
    reference's {batch: (mels, lengths)}."""
    checks = common.Checks()
    mismatched, missing, empty = 0, 0, 0
    errs = []
    for b, (mels, lens) in want.items():
        if b not in got:
            missing += 1
            continue
        mel, out = got[b]
        for j, (m_ref, n) in enumerate(zip(mels, lens)):
            if int(out[j]) != n:
                mismatched += 1
                continue
            if n == 0:
                empty += 1
                continue
            errs.append(common.rel_l2(mel[j, :, :n], m_ref))
    limits = cfg["limits"]
    if errs:
        print(f"mel: {len(errs)} rows, relative L2 least {min(errs)!r}, "
              f"90th percentile {float(np.percentile(errs, 90))!r}, "
              f"largest {max(errs)!r}", file=sys.stderr)
    checks.add("mel_rel_l2_median",
               float(np.median(errs)) if errs else float("nan"),
               limits["mel_rel_l2_median"])
    checks.add("rows_over_row_limit",
               sum(e > limits["mel_rel_l2_row"] for e in errs),
               limits["rows_over_row_limit"])
    checks.add("lengths_mismatched", mismatched, 0)
    checks.add("batches_missing", missing, 0)
    checks.add("rows_empty", empty, 0)
    return checks


def check(ctx, P, batches, got, keep, nx):
    if ctx.device == "cuda":
        no_tf32()
    want = {b: reference_batch(nx, ctx.cfg, P, batches, b,
                               ctx.traffic["reference_rows"])
            for b in keep}
    lim = dict(ctx.cfg, limits=ctx.traffic["limits"])
    return compare(lim, got, want)


def control(ctx, mode="fp8"):
    """The checks of a run whose program is the reference at ``mode``'s
    precision, on the same batches."""
    if ctx.device == "cuda":
        no_tf32()
    P = model_files.acoustic_weights(ctx.cfg, ctx.seed, ctx.device)
    batches = Batches(ctx.cfg, ctx.traffic, ctx.seed)
    keep = checked(ctx, batches)
    rows = ctx.traffic["reference_rows"]
    got = {}
    for b in keep:
        mels, lens = reference_batch(Numerics(mode), ctx.cfg, P, batches, b,
                                     rows)
        T = max(lens)
        mel = np.zeros((len(mels), mels[0].shape[0], max(T, 1)), np.float32)
        for j, m in enumerate(mels):
            mel[j, :, :m.shape[1]] = m
        got[b] = (mel, np.asarray(lens))
    want = {b: reference_batch(Numerics("f32"), ctx.cfg, P, batches, b, rows)
            for b in keep}
    return compare(dict(ctx.cfg, limits=ctx.traffic["limits"]), got, want)
