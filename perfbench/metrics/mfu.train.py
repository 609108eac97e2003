"""Model FLOPs utilization of training: forward and backward (3x the
forward) products of every step's real rows in the window, over the
window's seconds, against the card's bf16 peak."""

from work import model, peaks


def read(record, sl):
    steps = record.get("steps")
    if not steps:
        return None
    cfg = record["config"]
    flops = sum(model.train_step(cfg, rows) for rows in steps)
    return 100.0 * flops / record["window_s"] / peaks.BF16_FLOPS
