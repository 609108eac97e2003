"""Model FLOPs utilization of serving: the dense products of the window's
requests at their real lengths, through the acoustic model (the FiLMs
come from the cache) and the HiFi-GAN generator, over the summed time of
the engine calls, against the card's bf16 peak."""

from work import model, peaks


def read(record, sl):
    calls = record.get("engine_calls")
    if not calls:
        return None
    cfg = record["config"]
    flops = sum(model.acoustic(cfg, L, T) + model.vocoder(cfg["vocoder"], T)
                for c in calls for L, T in zip(c["symbols"], c["frames"]))
    secs = sum(c["t1"] - c["t0"] for c in calls)
    return 100.0 * flops / secs / peaks.BF16_FLOPS if secs > 0 else None
