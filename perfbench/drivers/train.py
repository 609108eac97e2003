"""Flagship training as the ``Trainer`` runs it: ``training/step.py``
``make_train_step`` fed the epoch plan of the port's loader
(``data/loader.py`` ``plan_steps``: a shuffle by the run's seed, length
sorted within chunks, each step 16 x 3 rows at its own (L, T) buckets),
each step collated by the port's ``collate`` on a prefetch thread
(``utils.prefetch_iterator``), the dropout generator reseeded every
iteration.

Data: the corpus model's 16,600 utterances, each step's rows cut from
seeded arrays made once in set-up (mel frames, frame and symbol energy
and pitch, symbols, integer durations summing to the frame count).

Set-up (``setup_s``): the model on the seed's weights; one step of
every batch signature the first steps and the window can reach, so that
every graph is captured before them; the parameters then copied back to
the seed's weights in place, Adam's moments zeroed and its count reset;
then the first three steps, kept for the check, each a replay of the
graphs the window runs. Window: steps until ``--seconds`` have passed on
the host, then a wait for the card; ``train_frames_per_s`` is the real
(unpadded) frames of every step launched over that time.

Correctness: the plain reference follows the first three steps from the
same initial weights, rows and dropout draws (``reference/dropout.py``),
each micro-batch padded by the benchmark's own code
(:func:`padded_step`), not the loader's: each step's loss and terms, the
first step's gradient as the optimizer took it (from Adam's first
moment), and every leaf's change after the three steps. The checked
steps must capture nothing: each is a replay.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from harness import common, corpus, model_files, seeding, trace
from reference import daftexprt as ref_model
from reference.dropout import Draws
from reference.numerics import Numerics, no_tf32


class Corpus:
    """The utterances' features, cut from pools drawn once from the
    seed."""

    def __init__(self, cfg, seed: int, n: int):
        # the loader drops what its caps cannot hold (none at the
        # configurations' own caps)
        self.lengths = [(L, T) for L, T in corpus.corpus_lengths(n)
                        if L <= cfg["max_symbols"] and T <= cfg["max_frames"]]
        n = len(self.lengths)
        rng = seeding.rng(seed, "features")
        total = sum(t for _, t in self.lengths)
        pool = min(total, 1 << 18)
        self.mel = rng.standard_normal((cfg["n_mel_channels"], pool),
                                       dtype=np.float32)
        self.f_energy = np.abs(rng.standard_normal(pool, dtype=np.float32))
        self.f_pitch = rng.standard_normal(pool, dtype=np.float32)
        sym_pool = 1 << 16
        self.symbols = rng.integers(1, len(cfg["symbols"]), sym_pool,
                                    dtype=np.int32)
        self.s_energy = rng.standard_normal(sym_pool, dtype=np.float32)
        self.s_pitch = rng.standard_normal(sym_pool, dtype=np.float32)
        self.speakers = rng.integers(0, len(cfg["speakers"]), n)
        self.offsets = rng.integers(0, pool - cfg["max_frames"], n)
        self.sym_offsets = rng.integers(0, sym_pool - cfg["max_symbols"], n)
        self.durations = [corpus.split_frames(rng, L, T)
                          for L, T in self.lengths]
        self.frame_s = cfg["hop_length"] / cfg["sampling_rate"]

    def example(self, j: int) -> dict:
        L, T = self.lengths[j]
        o, s = int(self.offsets[j]), int(self.sym_offsets[j])
        d = self.durations[j]
        return {"symbols": self.symbols[s:s + L],
                "durations_float": d.astype(np.float32) * self.frame_s,
                "durations_int": d,
                "symbols_energy": self.s_energy[s:s + L],
                "symbols_pitch": self.s_pitch[s:s + L],
                "frames_energy": self.f_energy[o:o + T],
                "frames_pitch": self.f_pitch[o:o + T],
                "mel_spec": self.mel[:, o:o + T],
                "speaker_id": int(self.speakers[j]),
                "features_dir": "", "feature_file": str(j)}


def assemble(data, hp, step) -> dict:
    """One planned step as the loader stacks it: (accumulation, batch,
    ...) arrays, each micro-batch collated at the step's (L, T)."""
    from daft_exprt_tpu_torch.data.loader import collate

    idxs, L, T = step
    B, accum = hp.batch_size, hp.accumulation_steps
    examples = [data.example(j) for j in idxs]
    micros = [collate(examples[m * B:(m + 1) * B], hp, pad_symbols=L,
                      pad_frames=T) for m in range(accum)]
    return {k: np.stack([m[k] for m in micros]) for k in micros[0]
            if k not in ("feature_dirs", "feature_files")}


def padded_step(data, cfg, step) -> dict:
    """The reference's copy of one planned step's rows: (accumulation,
    batch, ...) arrays, zero-padded to the buckets of the step's longest
    symbols and frames, by the benchmark's own code."""
    idxs = step[0]
    ex = [data.example(j) for j in idxs]
    L = model_files.bucket(max(len(e["symbols"]) for e in ex),
                           cfg["symbol_bucket"], cfg["max_symbols"])
    T = model_files.bucket(max(e["mel_spec"].shape[1] for e in ex),
                           cfg["frame_bucket"], cfg["max_frames"])
    n = len(ex)
    out = {k: np.zeros((n, L), np.int32 if k in ("symbols", "durations_int")
                       else np.float32)
           for k in ("symbols", "durations_float", "durations_int",
                     "symbols_energy", "symbols_pitch")}
    out.update({k: np.zeros((n, T), np.float32)
                for k in ("frames_energy", "frames_pitch")})
    out["mel_specs"] = np.zeros((n, cfg["n_mel_channels"], T), np.float32)
    for k in ("input_lengths", "output_lengths", "speaker_ids"):
        out[k] = np.zeros(n, np.int32)
    for i, e in enumerate(ex):
        sl, t = len(e["symbols"]), e["mel_spec"].shape[1]
        for k in ("symbols", "durations_float", "durations_int",
                  "symbols_energy", "symbols_pitch"):
            out[k][i, :sl] = e[k]
        out["frames_energy"][i, :t] = e["frames_energy"]
        out["frames_pitch"][i, :t] = e["frames_pitch"]
        out["mel_specs"][i, :, :t] = e["mel_spec"]
        out["input_lengths"][i] = sl
        out["output_lengths"][i] = t
        out["speaker_ids"][i] = e["speaker_id"]
    accum = cfg["accumulation_steps"]
    return {k: v.reshape((accum, n // accum) + v.shape[1:])
            for k, v in out.items()}


class Plan:
    """The steps of the epochs, in order, each epoch shuffled by a seed of
    its own."""

    def __init__(self, data, hp, seed: int):
        from daft_exprt_tpu_torch.data.loader import plan_steps

        self.data, self.hp, self.seed = data, hp, seed
        self._plan_steps = plan_steps
        self.epochs = []

    def epoch(self, e: int):
        while len(self.epochs) <= e:
            s = seeding.derive(self.seed, f"epoch{len(self.epochs)}")
            self.epochs.append(self._plan_steps(self.data.lengths, self.hp,
                                                s))
        return self.epochs[e]

    def steps(self, start: int = 0):
        """(iteration index, step) from ``start`` on, without end."""
        i = 0
        e = 0
        while True:
            for step in self.epoch(e):
                if i >= start:
                    yield i, step
                i += 1
            e += 1


def frames_of(batch) -> int:
    return int(batch["output_lengths"].sum())


def run(ctx):
    from daft_exprt_tpu_torch.models.daft_exprt import DaftExprt
    from daft_exprt_tpu_torch.training.step import make_train_step
    from daft_exprt_tpu_torch.utils import prefetch_iterator

    cfg, tr = ctx.cfg, ctx.traffic
    dev = ctx.device
    hp = model_files.hparams(cfg, str(ctx.scratch / "exp"))
    P0 = model_files.acoustic_weights(cfg, ctx.seed, dev)
    model = DaftExprt(hp, device=dev)
    model.load_state_dict(P0, strict=True)
    model.train()
    step = make_train_step(model, hp)
    if ctx.fault is not None:
        step = ctx.fault(step, model)
    data = Corpus(cfg, ctx.seed, tr["utterances"])
    plan = Plan(data, hp, ctx.seed)
    gen = torch.Generator(device=dev)
    names = [n for n, _ in model.named_parameters()]

    def one(batch, it):
        gen.manual_seed(seeding.derive(ctx.seed, f"dropout{it}"))
        return step(batch, gen, it)

    # one step of every batch signature the window can reach, then those
    # of the checked steps (the most recently run: a full cache evicts the
    # window's first)
    n_check = tr["checked_steps"]
    reach = int(ctx.seconds / tr["min_step_s"]) + tr["trace_steps"] + 64
    first = []
    seen, it = set(), 0
    for i, s in plan.steps():
        if i >= n_check + reach:
            break
        if i < n_check:
            first.append(s)
        elif (s[1], s[2]) not in seen:
            seen.add((s[1], s[2]))
            it += 1
            one(assemble(data, hp, s), it)
    for s in first:
        it += 1
        one(assemble(data, hp, s), it)

    # back to the seed's weights and a fresh optimizer, in place (the
    # graphs read them at their addresses)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(P0[n])
        for t in step.optimizer.mu + step.optimizer.nu:
            t.zero_()
    step.optimizer.count = 0

    # the first steps, replayed, which the reference follows
    checked, it = [], 0
    captures0 = step.graphs.captures
    for s in first:
        batch = assemble(data, hp, s)
        it += 1
        metrics = one(batch, it)
        checked.append({"batch": padded_step(data, cfg, s), "it": it,
                        "metrics": {k: float(v) for k, v in
                                    metrics.items()}})
        if it == 1:
            mu1 = [m.detach().clone() for m in step.optimizer.mu]
    after = [p.detach().clone() for p in model.parameters()]
    checked_captures = step.graphs.captures - captures0
    it = n_check + reach
    feed = prefetch_iterator((assemble(data, hp, s)
                              for _, s in plan.steps(n_check)),
                             depth=tr["prefetch_depth"])
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    try:
        sync()
        setup_s = time.perf_counter() - ctx.t_start
        captures0 = step.graphs.captures

        # the window
        waits, marks, rows, real = [], [], [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            w0 = time.perf_counter()
            batch = next(feed)
            waits.append(time.perf_counter() - w0)
            if dev == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
            it += 1
            one(batch, it)
            real += frames_of(batch)
            rows.append(list(zip(batch["input_lengths"].reshape(-1).tolist(),
                                 batch["output_lengths"].reshape(-1)
                                 .tolist())))
        if dev == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        sync()
        window = time.perf_counter() - t0
        step_s = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        record = {"window_s": window, "steps": rows, "step_s": step_s,
                  "data_wait_s": waits, "config": cfg,
                  "window_captures": step.graphs.captures - captures0}

        sl = None
        if ctx.trace:
            work = {"steps": []}

            def traced():
                nonlocal it
                for _ in range(tr["trace_steps"]):
                    batch = next(feed)
                    it += 1
                    one(batch, it)
                    work["steps"].append(micro_shapes(batch))
            sl = trace.profile(traced, work)
    finally:
        feed.close()
    memory = common.device_info(ctx.chips) if dev == "cuda" else {}
    program = {"metrics": [c["metrics"] for c in checked],
               "mu1": mu1, "after": after,
               "b1": float(hp.betas[0]), "captures": checked_captures}
    step.graphs.drop()
    del step, model
    if dev == "cuda":
        torch.cuda.empty_cache()
    checks = compare(ctx, P0, names, checked, program, Numerics("f32"))
    e2e = {"train_frames_per_s": real / window, "setup_s": setup_s}
    return {"e2e": e2e, "record": record, "slice": sl, "checks": checks,
            "attempted": len(rows), "failed": 0, "device": memory}


def micro_shapes(batch):
    """[(L, T, input lengths, output lengths)] of a step's micro-batches."""
    L, T = batch["symbols"].shape[-1], batch["mel_specs"].shape[-1]
    return [(L, T, batch["input_lengths"][m].tolist(),
             batch["output_lengths"][m].tolist())
            for m in range(batch["symbols"].shape[0])]


# ----------------------------------------------------------------------
# The reference's three steps and the comparison
# ----------------------------------------------------------------------
def lr_schedule(cfg, count: float) -> float:
    """Linear warm-up from the initial to the largest learning rate, then
    inverse square-root decay (the reference repo's schedule)."""
    lo, hi = cfg["initial_learning_rate"], cfg["max_learning_rate"]
    warm = cfg["warmup_steps"]
    if count < warm:
        return (hi - lo) / warm * count + lo
    return count ** -0.5 * hi / warm ** -0.5


def reference_steps(nx, cfg, P0, names, checked, seed):
    """The reference's steps over the checked batches: (per step the loss
    and terms, the first step's gradient as Adam took it, the parameters
    after the steps)."""
    dev = P0[names[0]].device
    P = {n: P0[n].detach().clone().requires_grad_(True) for n in names}
    mu = {n: torch.zeros_like(P[n]) for n in names}
    nu = {n: torch.zeros_like(P[n]) for n in names}
    b1, b2 = cfg["betas"]
    wd, eps = cfg["weight_decay"], cfg["epsilon"]
    accum = cfg["accumulation_steps"]
    gen = torch.Generator(device=dev)
    losses, first = [], None
    for k, c in enumerate(checked, start=1):
        gen.manual_seed(seeding.derive(seed, f"dropout{c['it']}"))
        draws = Draws(gen)
        grads = {n: torch.zeros_like(P[n]) for n in names}
        tot, terms = 0.0, {t: 0.0 for t in ref_model.LOSS_KEYS}
        for m in range(accum):
            micro = {key: torch.as_tensor(c["batch"][key][m], device=dev)
                     for key in ref_model.INPUT_KEYS}
            loss, parts = ref_model.train_loss(nx, P, cfg, cfg, micro,
                                               c["it"], draws)
            g = torch.autograd.grad(loss / accum, [P[n] for n in names],
                                    allow_unused=True)
            for n, gi in zip(names, g):
                if gi is not None:
                    grads[n] += gi
            tot += float(loss.detach()) / accum
            for t in terms:
                terms[t] += float(parts[t].detach()) / accum
        losses.append({"loss": tot, **terms})
        with torch.no_grad():
            lr = lr_schedule(cfg, float(k))
            for n in names:
                g = grads[n] + wd * P[n]
                if k == 1:
                    first = first or {}
                    first[n] = g.clone()
                mu[n].mul_(b1).add_((1 - b1) * g)
                nu[n].mul_(b2).add_((1 - b2) * g.square())
                upd = (mu[n] / (1 - b1 ** k)) / (
                    torch.sqrt(nu[n] / (1 - b2 ** k)) + eps)
                P[n].add_(-lr * upd)
    return losses, first, {n: P[n].detach() for n in names}


def leaf_gaps(got: dict, want: dict):
    """Each leaf's |norm(got) - norm(want)|, over the larger of that
    leaf's reference norm and the median leaf's: {leaf: gap}."""
    g = {n: float(got[n].float().norm()) for n in want}
    w = {n: float(want[n].float().norm()) for n in want}
    med = float(np.median(list(w.values())))
    return {n: abs(g[n] - w[n]) / max(w[n], med, 1e-30) for n in want}


def moving(first: dict) -> dict:
    """Per leaf, the elements whose reference gradient is not nought to
    rounding: at least a thousandth of the median leaf's root mean square
    gradient (a key's bias under softmax is nought, and Adam moves it by
    round-off alone)."""
    rms = [float(g.norm()) / max(g.numel(), 1) ** 0.5
           for g in first.values()]
    floor = 1e-3 * float(np.median(rms))
    return {n: g.abs() >= floor for n, g in first.items()}


def readings(cfg, P0, names, program, ref):
    """The compared numbers of a run, and for the record the ones they
    stand in for (PERF.md): the first step's terms (later steps start from
    parameters that Adam moved by the sign of rounding noise; the total
    loss averages its terms' errors away until the control reads under
    three times the program), the median leaf's first gradient and change
    (a small leaf's gradient can be a sum that cancels to a tenth of its
    terms)."""
    losses, first, after_ref = ref
    p1, r1 = program["metrics"][0], losses[0]
    b1 = program["b1"]
    g_prog = {n: m / (1 - b1) for n, m in zip(names, program["mu1"])}
    grad = leaf_gaps(g_prog, first)
    keep = moving(first)
    d_prog = {n: (a - P0[n])[keep[n]]
              for n, a in zip(names, program["after"]) if keep[n].any()}
    d_ref = {n: (after_ref[n] - P0[n])[keep[n]] for n in d_prog}
    change = leaf_gaps(d_prog, d_ref)
    values = {
        "loss_terms_step1_rel": max(abs(p1[t] - r1[t]) / abs(r1["loss"])
                                    for t in ref_model.LOSS_KEYS),
        "first_grad_median_leaf_gap": float(np.median(list(grad.values()))),
        "change_median_leaf_gap": float(np.median(list(change.values())))}
    info = {"loss_step1_rel": abs(p1["loss"] - r1["loss"]) / abs(r1["loss"]),
            "loss_rel_max": max(abs(p["loss"] - r["loss"]) / abs(r["loss"])
                                for p, r in zip(program["metrics"], losses)),
            "first_grad_worst_leaf_gap": max(grad.values()),
            "first_grad_worst_leaf": max(grad, key=grad.get),
            "change_worst_leaf_gap": max(change.values()),
            "change_worst_leaf": max(change, key=change.get)}
    return values, info


def compare(ctx, P0, names, checked, program, nx):
    if ctx.device == "cuda":
        no_tf32()
    ref = reference_steps(nx, ctx.cfg, P0, names, checked, ctx.seed)
    values, info = readings(ctx.cfg, P0, names, program, ref)
    print(f"train: {info}", file=sys.stderr)
    checks = common.Checks()
    for name, value in values.items():
        checks.add(name, value, ctx.traffic["limits"][name])
    # a checked step that captured ran eagerly, off the window's path
    checks.add("checked_steps_captured", program["captures"], 0)
    return checks


def control(ctx, mode="fp8"):
    """The checks of a run whose program is the reference at ``mode``'s
    precision over the same first steps; ``"half_batch"``: the reference
    in float32 over the first half of each micro-batch's rows alone (step
    3's fault, read at the cell's size)."""
    cfg, tr = ctx.cfg, ctx.traffic
    hp = model_files.hparams(cfg, str(ctx.scratch / "exp"))
    P0 = model_files.acoustic_weights(cfg, ctx.seed, ctx.device)
    names = list(P0)
    data = Corpus(cfg, ctx.seed, tr["utterances"])
    plan = Plan(data, hp, ctx.seed)
    steps = plan.steps()
    checked = []
    for it in range(1, tr["checked_steps"] + 1):
        _, s = next(steps)
        checked.append({"batch": padded_step(data, cfg, s), "it": it})
    if ctx.device == "cuda":
        no_tf32()
    if mode == "half_batch":
        half = [dict(c, batch={k: v[:, :v.shape[1] // 2]
                               for k, v in c["batch"].items()})
                for c in checked]
        losses, first, after = reference_steps(Numerics("f32"), cfg, P0,
                                               names, half, ctx.seed)
    else:
        losses, first, after = reference_steps(Numerics(mode), cfg, P0,
                                               names, checked, ctx.seed)
    b1 = cfg["betas"][0]
    program = {"metrics": losses, "b1": b1,
               "mu1": [first[n] * (1 - b1) for n in names],
               "after": [after[n] for n in names]}
    ref = reference_steps(Numerics("f32"), cfg, P0, names, checked,
                          ctx.seed)
    values, info = readings(cfg, P0, names, program, ref)
    print(f"train: {info}", file=sys.stderr)
    checks = common.Checks()
    for name, value in values.items():
        checks.add(name, value, tr["limits"][name])
    return checks
