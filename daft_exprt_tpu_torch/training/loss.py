"""Daft-Exprt training loss (port of the JAX package's
``training/loss.py``).

Total = warmup-scheduled adversarial speaker CE
      + L2 penalty on the FiLM scalar post-multipliers
      + per-length-normalized MSE on duration / energy / pitch
      + per-length-normalized mel L1 + L2,
with the adversarial-weight ramp
min(adv_max, iter * warmup^-1.5 * adv_max / warmup^-0.5).
"""

from __future__ import annotations

import torch


def adversarial_weight(iteration, warmup_steps: int, adv_max_weight: float,
                       device=None):
    """Adversarial speaker-loss weight ramp (float32), on ``iteration``'s
    device for a tensor (the training step's graph loads it), else made on
    ``device`` by a fill (no copy from the host, which a CUDA graph cannot
    hold)."""
    it = iteration.float() if isinstance(iteration, torch.Tensor) \
        else torch.full((), float(iteration), dtype=torch.float32,
                        device=device)
    weight_iter = (it * warmup_steps ** -1.5
                   * adv_max_weight / warmup_steps ** -0.5)
    return torch.clamp_max(weight_iter, adv_max_weight)


def _row_mean(per_row, row_weights):
    """Batch mean, or weighted mean over valid rows if weights given."""
    if row_weights is None:
        return per_row.mean()
    w = row_weights.float()
    return (per_row * w).sum() / w.sum().clamp_min(1.0)


def cross_entropy(logits, labels, row_weights=None):
    """Mean softmax cross entropy (torch nn.CrossEntropyLoss semantics);
    ``row_weights`` (B,) makes it a weighted mean over rows with non-zero
    weight."""
    logits = logits.float()
    m = logits.amax(-1)
    log_z = torch.log(torch.exp(logits - m[:, None]).sum(-1)) + m
    picked = logits.gather(-1, labels.long()[:, None])[:, 0]
    return _row_mean(log_z - picked, row_weights)


def compute_loss(outputs, targets, iteration, hp, row_weights=None):
    """Total training loss and the individual-loss dict.

    :param outputs: ``DaftExprt.forward`` outputs (speaker_preds,
        film_params, encoder_preds, decoder_preds, alignments)
    :param targets: (duration_targets, energy_targets, pitch_targets,
        mel_spec_targets, speaker_ids)
    :param iteration: current optimizer step: a number, or a float32
        scalar tensor on the outputs' device
    :param row_weights: optional (B,) 0/1 weights: batch means become
        weighted means over valid rows
    """
    (duration_targets, energy_targets, pitch_targets, mel_spec_targets,
     speaker_ids) = targets
    speaker_preds, film_params, encoder_preds, decoder_preds, _ = outputs
    post_multipliers = film_params[0]
    duration_preds, energy_preds, pitch_preds, input_lengths = encoder_preds
    mel_spec_preds, output_lengths = decoder_preds
    device = speaker_preds.device

    inv_in_len = 1.0 / input_lengths.float()
    speaker_loss = cross_entropy(speaker_preds, speaker_ids, row_weights)
    if hp.post_mult_weight != 0.0:
        post_mult_loss = torch.sqrt(post_multipliers.float().square().sum())
    else:
        post_mult_loss = torch.zeros((), device=device)

    def seq_mse(pred, tgt):
        se = (pred.float() - tgt.float()).square()
        return _row_mean(se.sum(1) * inv_in_len, row_weights)

    duration_loss = seq_mse(duration_preds, duration_targets)
    energy_loss = seq_mse(energy_preds, energy_targets)
    pitch_loss = seq_mse(pitch_preds, pitch_targets)

    mel_diff = mel_spec_preds.float() - mel_spec_targets.float()
    inv_out = 1.0 / (hp.n_mel_channels * output_lengths.float())
    mel_l1 = _row_mean(mel_diff.abs().sum((1, 2)) * inv_out, row_weights)
    mel_l2 = _row_mean(mel_diff.square().sum((1, 2)) * inv_out, row_weights)

    speaker_weight = adversarial_weight(iteration, hp.warmup_steps,
                                        hp.adv_max_weight, device)
    individual = {
        "speaker_loss": speaker_weight * speaker_loss,
        "post_mult_loss": hp.post_mult_weight * post_mult_loss,
        "duration_loss": hp.dur_weight * duration_loss,
        "energy_loss": hp.energy_weight * energy_loss,
        "pitch_loss": hp.pitch_weight * pitch_loss,
        "mel_spec_l1_loss": hp.mel_spec_weight * mel_l1,
        "mel_spec_l2_loss": hp.mel_spec_weight * mel_l2,
    }
    loss = (individual["speaker_loss"] + individual["post_mult_loss"]
            + individual["duration_loss"] + individual["energy_loss"]
            + individual["pitch_loss"] + individual["mel_spec_l1_loss"]
            + individual["mel_spec_l2_loss"])
    return loss, individual
