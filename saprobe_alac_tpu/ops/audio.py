"""On-device audio post-processing for decoded PCM.

The device-resident consumption story: decoded samples stay in device
memory and feed feature extraction / models on the same device — no host round-trip (the
device-resident path bench.py measures).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("depth",))
def pcm_to_float(samples, depth):
    """(B, F, C) int32 decoder output -> float32 in [-1, 1)."""
    scale = jnp.float32(1.0 / (1 << (depth - 1)))
    return samples.astype(jnp.float32) * scale


def _num_frames(total: int, frame: int, hop: int) -> int:
    """Number of full analysis frames (0 when the input is too short —
    never a clamped-gather partial frame)."""
    return 0 if total < frame else 1 + (total - frame) // hop


@partial(jax.jit, static_argnames=("frame", "hop"))
def frame_energy(x, frame=1024, hop=512):
    """Per-frame RMS energy of (B, F) mono float audio (windowed)."""
    B, F = x.shape
    n = _num_frames(F, frame, hop)
    idx = jnp.arange(n)[:, None] * hop + jnp.arange(frame)[None, :]
    frames = x[:, idx]  # (B, n, frame)
    return jnp.sqrt(jnp.mean(frames * frames, axis=-1) + 1e-12)


@partial(jax.jit, static_argnames=("frame", "hop", "n_bins"))
def log_spectrogram(x, frame=512, hop=256, n_bins=128):
    """Log-magnitude spectrogram of (B, F) mono float audio (rfft)."""
    B, F = x.shape
    n = _num_frames(F, frame, hop)
    idx = jnp.arange(n)[:, None] * hop + jnp.arange(frame)[None, :]
    window = 0.5 - 0.5 * jnp.cos(2 * jnp.pi * jnp.arange(frame) / frame)
    frames = x[:, idx] * window[None, None, :]
    spec = jnp.abs(jnp.fft.rfft(frames, axis=-1))[..., :n_bins]
    return jnp.log1p(spec)
