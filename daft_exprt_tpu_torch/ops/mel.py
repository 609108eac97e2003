"""Mel-spectrogram and energy extraction on the device (counterpart of
``daft_exprt_tpu/ops/mel.py``).

HiFi-GAN-compatible mel extraction: centered reflect-padded STFT with a
periodic Hann window, magnitude ``sqrt(re^2 + im^2 + 1e-9)``, Slaney-norm
mel filterbank, ``log(clamp(mel, min_clipping))``. The frames are cut
explicitly as the JAX package's ``frame_signal`` cuts them (frame counts
and padding follow :func:`num_frames`), then go through
``torch.fft.rfft``; ``torch.stft``'s defaults are not used. The filter bank
is a numpy array built once per configuration and copied to each device
once.

On the CPU the vector math (square root, log, exp) runs once on one
element before the first spectrogram of a process
(:func:`cpu_vector_math_ready`), so that every process computes the same
mel from the same wav.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from daft_exprt_tpu_torch.device import default_device


# ----------------------------------------------------------------------
# Mel filterbank (librosa-compatible, Slaney scale + Slaney norm)
# ----------------------------------------------------------------------
def _hz_to_mel(freq):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asanyarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        mels)
    return mels


def _mel_to_hz(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filter_bank(sampling_rate: int, n_fft: int, n_mels: int,
                    fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft // 2).

    Matches librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax) with the
    0.8.1 defaults htk=False, norm='slaney'.
    """
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, 1 + n_fft // 2)
    mel_min, mel_max = _hz_to_mel(fmin), _hz_to_mel(fmax)
    mel_f = _mel_to_hz(np.linspace(mel_min, mel_max, n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style energy normalization (area of each filter).
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=16)
def filter_bank_on(device: torch.device, sampling_rate: int, n_fft: int,
                   n_mels: int, fmin: float, fmax: float) -> torch.Tensor:
    """:func:`mel_filter_bank` as a float32 tensor on ``device``, made once
    per (device, configuration)."""
    return torch.from_numpy(mel_filter_bank(
        sampling_rate, n_fft, n_mels, fmin, fmax)).to(device)


# ----------------------------------------------------------------------
# STFT
# ----------------------------------------------------------------------
def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window default)."""
    n = np.arange(n_fft, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)).astype(np.float32)


def num_frames(num_samples: int, n_fft: int, hop_length: int,
               center: bool = True) -> int:
    """Number of STFT frames for a signal of ``num_samples`` samples."""
    if center:
        return 1 + num_samples // hop_length
    # 1 + int((n - n_fft) / hop): int() truncates toward zero, so signals
    # shorter than one window still count 1 frame
    d = num_samples - n_fft
    return 1 + (d // hop_length if d >= 0 else -((-d) // hop_length))


def frame_signal(wav: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """Slice a (..., S) signal into overlapping frames (..., F, n_fft).

    With ``center`` the signal is reflect-padded by n_fft//2 on both sides
    (torch.stft pad_mode='reflect' semantics).
    """
    if center:
        pad = n_fft // 2
        lead = wav.shape[:-1]
        wav = F.pad(wav.reshape(-1, 1, wav.shape[-1]), (pad, pad),
                    mode="reflect").reshape(*lead, -1)
    return wav.unfold(-1, n_fft, hop_length)


@functools.lru_cache(maxsize=16)
def hann_window_on(device: torch.device, n_fft: int) -> torch.Tensor:
    """:func:`hann_window` as a float32 tensor on ``device``, made once per
    (device, n_fft): a copy from host memory on every call would make the
    host wait for the work queued on the card."""
    return torch.from_numpy(hann_window(n_fft)).to(device)


@functools.lru_cache(maxsize=None)
def cpu_vector_math_ready() -> bool:
    """Run the CPU's vector-math square root, log and exp once, on one
    element (so on one thread), once a process. Their first call over
    many elements, spread over the intra-op threads, has given one
    thread's share approximate square roots (relative error up to
    3.2e-4, in 3 of 24 fresh processes on an 8-core host:
    ``chip_smoke.py --extraction-processes``), which moved the
    extraction's frame energy against the card's by up to 7.5e-5."""
    torch.exp(torch.log(torch.sqrt(torch.ones(1))))
    return True


def stft_magnitude(wav: torch.Tensor, n_fft: int, hop_length: int,
                   center: bool = True) -> torch.Tensor:
    """Magnitude spectrogram (..., 1 + n_fft//2, F) with a periodic Hann
    window: ``sqrt(re^2 + im^2 + 1e-9)``."""
    if wav.device.type == "cpu":
        cpu_vector_math_ready()
    window = hann_window_on(wav.device, n_fft)
    frames = frame_signal(wav, n_fft, hop_length, center) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return mag.transpose(-1, -2)


def mel_spectrogram(wav: torch.Tensor, sampling_rate: int, n_fft: int,
                    hop_length: int, n_mels: int, fmin: float, fmax: float,
                    min_clipping: float = 1e-5,
                    center: bool = True) -> torch.Tensor:
    """Log-mel spectrogram (..., n_mels, F) -- HiFi-GAN-exact recipe."""
    mag = stft_magnitude(wav, n_fft, hop_length, center)
    fb = filter_bank_on(mag.device, sampling_rate, n_fft, n_mels, fmin, fmax)
    mel = torch.einsum("mf,...ft->...mt", fb, mag)
    return torch.log(torch.clamp(mel, min=min_clipping))


def mel_kwargs(hparams) -> dict:
    """The mel arguments of a HyperParams object."""
    return dict(sampling_rate=hparams.sampling_rate,
                n_fft=hparams.filter_length, hop_length=hparams.hop_length,
                n_mels=hparams.n_mel_channels, fmin=hparams.mel_fmin,
                fmax=hparams.mel_fmax, min_clipping=hparams.min_clipping,
                center=hparams.centered)


def mel_spectrogram_hifi(wav, hparams, device=None) -> np.ndarray:
    """(S,) host waveform -> (n_mels, F) float32 numpy log-mel, computed on
    ``device`` (``cuda`` unless given)."""
    device = default_device(device)
    wav = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    return mel_spectrogram(wav, **mel_kwargs(hparams)).cpu().numpy()


def extract_energy(mel_spec: np.ndarray) -> np.ndarray:
    """Per-frame energy: L2 norm over mel channels of the linear mel.

    ``mel_spec`` is the *linear* (exp'd) mel, shape (n_mels, F).
    """
    return np.linalg.norm(mel_spec, axis=0)


def mel_and_energy_batch(wavs: torch.Tensor, sampling_rate: int, n_fft: int,
                         hop_length: int, n_mels: int, fmin: float,
                         fmax: float, min_clipping: float = 1e-5,
                         center: bool = True):
    """Batched (B, S) -> (log-mel (B, n_mels, F), frame energy (B, F)) on
    the tensor's device; crop per-utterance frames on the host."""
    log_mel = mel_spectrogram(wavs, sampling_rate, n_fft, hop_length,
                              n_mels, fmin, fmax, min_clipping, center)
    energy = torch.linalg.vector_norm(torch.exp(log_mel), dim=-2)
    return log_mel, energy
