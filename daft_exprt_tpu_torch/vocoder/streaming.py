"""Streaming (chunked) HiFi-GAN vocoding: a short time to the first audio.

Counterpart of ``daft_exprt_tpu/vocoder/streaming.py``. HiFi-GAN is purely
convolutional, so every output sample depends on a finite window of mel
frames (:func:`mel_halo_frames` bounds it). The stream slices the mel
into windows of one shape, ``chunk + 2 * halo`` frames, clamped at frame
0 on the left only; past the true length T the mel continues with the
floor ``log(1e-5)``, as in the padded buckets of ``vocode_mels`` and the
engine's audio path. Each window's output is cropped to its chunk, so the
concatenated chunks equal the full run on the floor-padded mel, cropped
to ``T * prod(upsample_rates)`` samples (up to the convs' summation order
at the window's shape).

Every window is one pass of the generator's graph of that shape
(:meth:`~daft_exprt_tpu_torch.vocoder.hifigan.HiFiGanGenerator.replayed`,
label ``"window"``): the port's counterpart of JAX's single compiled
window shape. The first window of a generator runs eagerly and captures
the graph (``SynthesisService.warmup`` streams one job, so a server's
requests only replay it); every later window replays it.

A replay overwrites the graph's static output, so each window's crop is
copied out before the next window runs: the copy into one of the
stream's two pinned host buffers is queued on the same CUDA stream right
after the replay, then window i+1 is dispatched, and only then does the
host wait for chunk i (double buffering), which it copies out of its
buffer before the buffer takes window i+2. The graph lives in the
generator's own memory pool, not the engine's: a server releases its
lock between windows, and the engine's replays that run there never
write the window's output.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from daft_exprt_tpu_torch.vocoder.hifigan import MEL_FLOOR, HiFiGanGenerator


def mel_halo_frames(gen: HiFiGanGenerator) -> int:
    """Conservative one-sided receptive field of the generator, in mel
    frames: a window with this halo on each side yields interior outputs
    equal to a full-utterance run.

    ``reach`` is the one-sided dependency radius in frames and ``s`` the
    output samples per frame at the current stage: a conv with kernel k
    and dilation d adds ``(k - 1) d / 2 / s`` frames, a transposed conv at
    most ``k / s``; the fan's resblocks run in parallel (max of their
    reaches), the dilations of one resblock in sequence (sum).
    """
    cfg = gen.cfg
    reach = (7 - 1) / 2  # conv_pre, k=7
    s = 1.0
    for u, k in zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"]):
        reach += k / s
        s *= u
        fan = 0.0
        for kr, dils in zip(cfg["resblock_kernel_sizes"],
                            cfg["resblock_dilation_sizes"]):
            chain = 0.0
            for d in dils:
                chain += (kr - 1) * d / 2  # convs1[j], dilation d
                if gen.two_convs:
                    chain += (kr - 1) / 2  # convs2[j], dilation 1
            fan = max(fan, chain)
        reach += fan / s
    reach += (7 - 1) / 2 / s  # conv_post, k=7
    return int(math.ceil(reach))


class StreamingVocoder:
    """Chunked mel -> waveform with a single window shape.

    :param gen: the generator (on its device)
    :param chunk_frames: mel frames of new audio per chunk (64 frames =
        743 ms at 22050 Hz and hop 256)
    :param halo_frames: one-sided context; default
        ``mel_halo_frames(gen)``. Values below it break the seams.
    """

    def __init__(self, gen: HiFiGanGenerator, *, chunk_frames: int = 64,
                 halo_frames: int | None = None):
        self.gen = gen
        self.up = int(np.prod(gen.cfg["upsample_rates"]))
        self.chunk = int(chunk_frames)
        self.halo = mel_halo_frames(gen) if halo_frames is None \
            else int(halo_frames)
        self.window = self.chunk + 2 * self.halo

    def windows(self, n_frames: int):
        """[(window_start, crop_start, crop_len), ...] in mel frames;
        ``sum(crop_len) == n_frames``."""
        plan = []
        for c0 in range(0, n_frames, self.chunk):
            ws = max(c0 - self.halo, 0)
            plan.append((ws, c0 - ws, min(c0 + self.chunk, n_frames) - c0))
        return plan

    def _dispatch(self, window, crop: slice, host, done):
        """Run one (num_mels, window) mel through the window's graph; queue
        the crop's copy into ``host`` (a buffer of ``window * up``
        samples), recorded by the CUDA event ``done`` (None on the CPU).
        :return: a callable giving the chunk as numpy, waiting for it."""
        out = self.gen.replayed(window[None], label="window")[0, crop]
        dst = host[:out.shape[0]]
        dst.copy_(out, non_blocking=done is not None)
        if done is not None:
            done.record(torch.cuda.current_stream(out.device))

        def fetch():
            if done is not None:
                done.synchronize()
            return dst.numpy().copy()  # the buffer takes window i + 2
        return fetch

    def _buffers(self):
        """Two host buffers of one window's samples (pinned on the card)
        and their CUDA events: one pair per stream, so that streams
        interleaved by a server never share one."""
        cuda = self.gen.device.type == "cuda"
        return [(torch.empty(self.window * self.up, dtype=torch.float32,
                             pin_memory=cuda),
                 torch.cuda.Event() if cuda else None) for _ in range(2)]

    def stream(self, mel, n_frames: int | None = None):
        """Yield float32 waveform chunks for ``mel`` (num_mels, T).

        The chunks concatenate to ``n_frames * prod(rates)`` samples.
        Frames of ``mel`` past ``n_frames`` are ignored (the floor takes
        their place). An utterance with ``T + halo <= window`` is one
        window, cropped.
        """
        mel = np.asarray(mel, np.float32)
        T = mel.shape[1] if n_frames is None else int(n_frames)
        up = self.up
        # continue the mel with the floor: the tail windows see the values
        # the padded buckets of the batch paths hold
        ext = np.full((mel.shape[0], T + self.window), MEL_FLOOR, np.float32)
        ext[:, :T] = mel[:, :T]
        buffers = self._buffers()
        if T + self.halo <= self.window:
            # one window; its floor region covers the tail's receptive
            # field [T, T + halo), so the whole chunk is exact
            yield self._dispatch(ext[:, :self.window], slice(0, T * up),
                                 *buffers[0])()
            return
        pending = None
        for i, (ws, rel, n) in enumerate(self.windows(T)):
            fetch = self._dispatch(ext[:, ws:ws + self.window],
                                   slice(rel * up, (rel + n) * up),
                                   *buffers[i % 2])
            if pending is not None:
                yield pending()
            pending = fetch
        yield pending()

    def vocode(self, mel, n_frames: int | None = None):
        """Run the stream to its end; one waveform."""
        return np.concatenate(list(self.stream(mel, n_frames)))
