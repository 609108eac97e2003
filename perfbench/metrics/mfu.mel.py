"""Model FLOPs utilization of bulk synthesis: the products of every
call's real rows (the prosody encoder over its reference, then the
acoustic model) over the window's seconds, against the card's bf16
peak."""

from work import model, peaks


def read(record, sl):
    calls = record.get("calls")
    if not calls:
        return None
    cfg = record["config"]
    flops = sum(model.prosody_encoder(cfg, r) + model.acoustic(cfg, L, T)
                for c in calls
                for L, T, r in zip(c["symbols"], c["frames"],
                                   c["ref_frames"]))
    return 100.0 * flops / record["window_s"] / peaks.BF16_FLOPS
