"""Seeded synthetic PCM and configs for tests, smoke runs and benchmarks."""

from __future__ import annotations

import numpy as np

from ..config import PacketConfig


def make_config(
    depth: int = 16,
    channels: int = 2,
    frame_length: int = 4096,
    sample_rate: int = 44100,
    pb: int = 40,
    mb: int = 10,
    kb: int = 14,
    max_run: int = 255,
) -> PacketConfig:
    """A PacketConfig with Apple-standard entropy tuning defaults."""
    return PacketConfig(
        frame_length=frame_length,
        bit_depth=depth,
        num_channels=channels,
        pb=pb,
        mb=mb,
        kb=kb,
        max_run=max_run,
        max_frame_bytes=0,
        avg_bit_rate=0,
        sample_rate=sample_rate,
    )


def music_pcm(
    num_samples: int, channels: int, depth: int, seed: int = 0, tonality: float = 0.98
) -> np.ndarray:
    """Deterministic music-like PCM: correlated tones + low-level noise.

    ``tonality`` near 1 compresses well (predictor-dominated profile);
    near 0 approaches white noise (entropy/escape-dominated profile) —
    the two benchmark regimes of the reference (QA.md:138-147, 199-229).
    The tone periods are not whole frames and the noise is fresh for every
    sample, so every packet of a long signal has distinct content.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(num_samples)
    sig = np.zeros((num_samples, channels))
    for c in range(channels):
        tone = (
            0.35 * np.sin(2 * np.pi * t / (97.3 + 11 * c))
            + 0.2 * np.sin(2 * np.pi * t / (23.7 + 3 * c))
            + 0.1 * np.sin(2 * np.pi * t / (389.0 + 29 * c))
        )
        noise = rng.standard_normal(num_samples)
        sig[:, c] = tonality * tone * 0.8 + (1 - tonality) * noise * 0.5
    scale = (1 << (depth - 1)) - 1
    return np.clip(sig * scale, -scale - 1, scale).astype(np.int64)


def expected_pcm_bytes(pcm: np.ndarray, depth: int) -> bytes:
    """Interleaved LE bytes the decoder must produce for raw samples."""
    from ..codec.matrixing import pack_pcm

    vals = pcm.astype(np.int64)
    if depth == 20:
        vals = vals << 4
    return pack_pcm(vals, depth)
