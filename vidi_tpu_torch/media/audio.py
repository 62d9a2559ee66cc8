"""Audio featurization: Whisper-style 128-bin log-mel spectrograms.

Replaces WhisperFeatureExtractor (reference: Vidi1.5_9B/vidi/dataset/
vid_utils.py:53-63 `process_audio`): the waveform is chunked into 30-s
windows, each padded to 30 s and converted to a [128, 3000] log-mel; `length`
is the total number of real mel frames (len(chunk) // hop per chunk — what HF
returns as num_frames with return_token_timestamps=True).

Implemented in numpy on the host (cheap next to decode).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from vidi_tpu_torch.core.config import AudioConfig


def hertz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = 3.0 * freq / 200.0
    log_region = freq >= 1000.0
    mels = np.where(
        log_region,
        15.0 + np.log(np.maximum(freq, 1e-10) / 1000.0) * (27.0 / np.log(6.4)),
        mels,
    )
    return mels


def mel_to_hertz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    freq = 200.0 * mels / 3.0
    log_region = mels >= 15.0
    freq = np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0 * (mels - 15.0)), freq)
    return freq


def mel_filter_bank(n_freqs: int, n_mels: int, f_min: float, f_max: float,
                    sample_rate: int) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filters [n_freqs, n_mels]
    (matches HF audio_utils.mel_filter_bank(norm='slaney', mel_scale='slaney'))."""
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_min = hertz_to_mel_slaney(f_min)
    mel_max = hertz_to_mel_slaney(f_max)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    freq_pts = mel_to_hertz_slaney(mel_pts)

    fdiff = np.diff(freq_pts)
    slopes = freq_pts[None, :] - fft_freqs[:, None]  # [F, n_mels+2]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    enorm = 2.0 / (freq_pts[2: n_mels + 2] - freq_pts[:n_mels])
    fb *= enorm[None, :]
    return fb.astype(np.float32)


def log_mel_window(wave: np.ndarray, cfg: AudioConfig,
                   filters: np.ndarray) -> np.ndarray:
    """One (already padded to n_samples) window -> [n_mels, nb_max_frames]."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    window = np.hanning(n_fft + 1)[:-1].astype(np.float64)  # periodic hann
    pad = n_fft // 2
    w = np.pad(wave.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(w) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = w[idx] * window[None, :]
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2  # [T, F]
    spec = spec[:-1]  # drop the final frame (Whisper convention)
    mel = spec @ filters.astype(np.float64)  # [T, n_mels]
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.T.astype(np.float32)  # [n_mels, T]


_FILTER_CACHE = {}


def _filters(cfg: AudioConfig) -> np.ndarray:
    key = (cfg.n_fft, cfg.num_mel_bins, cfg.sampling_rate)
    if key not in _FILTER_CACHE:
        _FILTER_CACHE[key] = mel_filter_bank(
            1 + cfg.n_fft // 2, cfg.num_mel_bins, 0.0,
            cfg.sampling_rate / 2.0, cfg.sampling_rate)
    return _FILTER_CACHE[key]


def process_audio(audio: np.ndarray, cfg: AudioConfig) -> Tuple[np.ndarray, int]:
    """waveform float32 [-1, 1] -> (mel windows [W, n_mels, 3000], length).

    Mirrors vid_utils.py:53-63: chunk into n_samples windows, featurize each
    (padded), length = total real mel frames across chunks.
    """
    n = cfg.n_samples
    chunks: List[np.ndarray] = [audio[i: i + n] for i in range(0, max(len(audio), 1), n)]
    filters = _filters(cfg)
    mels = []
    length = 0
    for c in chunks:
        length += len(c) // cfg.hop_length
        if len(c) < n:
            c = np.pad(c, (0, n - len(c)))
        mels.append(log_mel_window(c, cfg, filters))
    return np.stack(mels, axis=0), length

