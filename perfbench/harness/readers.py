"""What the per-layer metrics' readers share: the kernels' names in a
device trace, and their work from the shapes a run noted.

Kernel names are those of the program's CUDA sources (``csrc/``), both
instances of each kernel (tensor cores and CUDA cores). A reader that
finds no such kernel in the slice reads nothing.
"""

from __future__ import annotations

import statistics

from work import k1, k2, k3, k5, peaks

KERNELS = {
    "k1": r"(?<!\w)(qkv_wgmma|attn_wgmma|conv_wgmma|qkv|attention|outproj_ln"
          r"|conv_ff)_kernel\b",
    "k2": r"(?<!\w)attn_(fwd|bwd_dq|bwd_dkdv)(_wgmma)?_kernel\b",
    "k3": r"(?<!\w)(cff_pack_x|conv_c_wgmma|conv_e_wgmma|wgrad_wgmma"
          r"|cff_finish|cff_hidden|cff_rows|cffb_hidden|cffb_rows|wgrad"
          r"|sum_rows)_kernel\b",
    "k5": r"(?<!\w)mrf_(wgmma_)?kernel\b",
}
ANY_KERNEL = "|".join(f"(?:{p})" for p in KERNELS.values())


def share(bound_s: float, sl, kernel: str):
    """100 x the bound over the union of ``kernel``'s intervals in the
    slice, or None where the slice holds none of them."""
    if sl is None or not sl.matches(KERNELS[kernel]):
        return None
    took = sl.union_s(KERNELS[kernel])
    return 100.0 * bound_s / took if took > 0 else None


def p50(values):
    return statistics.median(values) if values else None


def k1_bound_s(calls) -> float:
    """``calls``: [(lengths, T, E, C)] of K1."""
    return sum(peaks.bound_s(*k1.work(lens, T, E, C))
               for lens, T, E, C in calls)


def k2_bound_s(calls) -> float:
    """``calls``: [(lengths, T, E, H)], each forward and backward."""
    return sum(peaks.bound_s(*k2.work(lens, T, E, H, b))
               for lens, T, E, H in calls for b in (False, True))


def k3_bound_s(calls) -> float:
    """``calls``: [(lengths, T, E, C)], each forward and backward."""
    return sum(peaks.bound_s(*k3.work(lens, T, E, C, b))
               for lens, T, E, C in calls for b in (False, True))


def k5_bound_s(vcfg, calls) -> float:
    """``calls``: [(frames of the real rows, padded rows, bucket)] of the
    audio passes; K5 takes the stages of at most 128 channels that divide
    128."""
    n_taps, n_convs = k5.fan(vcfg)
    total = 0.0
    for frames, rows_padded, bucket in calls:
        up, c = 1, vcfg["upsample_initial_channel"]
        for u in vcfg["upsample_rates"]:
            up, c = up * u, c // 2
            if c <= 128 and 128 % c == 0:
                total += peaks.bound_s(*k5.work(
                    [f * up for f in frames], rows_padded, bucket * up, c,
                    n_taps, n_convs))
    return total


def fft_blocks(cfg):
    """[(module, blocks, E, heads, C)] of the acoustic model's FFT
    stacks."""
    out = []
    for m in ("prosody_encoder", "phoneme_encoder", "frame_decoder"):
        g = cfg[m]
        E = g.get("hidden_embed_dim",
                  cfg["phoneme_encoder"]["hidden_embed_dim"])
        out.append((m, g["nb_blocks"], E, g["attn_nb_heads"],
                    g["conv_channels"]))
    return out
