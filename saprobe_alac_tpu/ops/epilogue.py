"""Phase 3: fully parallel finishing stages.

Escape raw-sample extraction and shift-buffer extraction are fixed-stride bit
gathers (no serial dependency); stereo un-decorrelation, shift re-insert,
20-bit normalization, and MPEG->SMPTE channel remap are element-wise
(matrix.go semantics throughout).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .jaxint import I32, U32, s, sext, sshr, u
from .streambits import vread


@partial(jax.jit, static_argnames=("frame_length", "num_channels"))
def extract_escape(words, res, esc, esc_base, esc_cb, role, frame_length, num_channels):
    """Fill escape channels' planes with raw sign-extended samples.

    Escape data layout (decoder.go:326-345, 507-535): SCE = consecutive
    chan_bits-wide values; CPE = U/V interleaved.  Values land in the residual
    planes with order forced 0 so phase 2 passes them through.

    ``res`` is the walk's (F, C, B) F-major plane stack; the bit gather runs
    lane-major (vread's layout) and transposes per plane.  The caller gates
    it on any(esc).
    """
    F = frame_length
    C = num_channels
    i = jnp.arange(F, dtype=I32)[None, :]
    planes = []
    for c in range(C):
        active = esc[:, c] == 1
        cb = esc_cb[:, c][:, None]
        rl = role[:, c][:, None]
        # Mono: stride cb.  Pair U: stride 2cb phase 0.  Pair V: stride 2cb, phase cb.
        stride = jnp.where(rl == 0, cb, 2 * cb)
        phase = jnp.where(rl == 2, cb, 0)
        pos = esc_base[:, c][:, None] + i * stride + phase
        vals = sext(vread(words, pos, jnp.maximum(cb, 1)), cb)  # (B, F)
        planes.append(jnp.where(active[None, :], vals.T, res[:, c]))
    return jnp.stack(planes, axis=1)


@partial(jax.jit, static_argnames=("frame_length", "num_channels"))
def extract_shift(words, shift_base, bs, role, frame_length, num_channels):
    """Extract shift-buffer LSB values: (F, C, B) int32 F-major planes.

    Mono channels read consecutive width-bit values; pairs are interleaved
    U/V (decoder.go:314-321, 492-502).  Cond-gated on any(bs > 0): only
    24/32-bit shifted streams pay the gather (and its transposes).
    """
    F = frame_length
    C = num_channels
    i = jnp.arange(F, dtype=I32)[None, :]
    planes = []
    for c in range(C):
        width = bs[:, c][:, None] * 8
        rl = role[:, c][:, None]
        stride = jnp.where(rl == 0, width, 2 * width)
        phase = jnp.where(rl == 2, width, 0)
        pos = shift_base[:, c][:, None] + i * stride + phase
        vals = vread(words, pos, jnp.maximum(width, 1))  # (B, F)
        planes.append(jnp.where((bs[:, c] > 0)[None, :], vals.T, 0))
    return jnp.stack(planes, axis=1)


@partial(jax.jit, static_argnames=("frame_length", "num_channels", "depth"))
def finish(mix, shift_vals, bs, mixbits, mixres, role, out_chan, filled, frame_length, num_channels, depth):
    """Unmix pairs, re-insert shift bits, normalize 20-bit, remap channels.

    mix: (F, C*B) F-major reconstructed channel values, channel-major lanes
    (lane = c*B + b) — the LPC kernel's native output layout.  shift_vals:
    (F, C, B).  ``filled`` masks slots no element decoded into (early END
    leaves those output channels zero, matching the reference's zeroed
    output buffer).  Returns (B, F, C) int32 output samples in SMPTE order.

    Channels live as a Python list of (F, B) planes so every update is a
    pure select; the single relayout in the whole epilogue is the final
    (F, B, C) -> (B, F, C) transpose feeding the D2H byte packer.
    """
    planes = _finish_planes(
        mix, shift_vals, bs, mixbits, mixres, role, out_chan, filled,
        frame_length, num_channels, depth,
    )
    return jnp.stack(planes, axis=-1).transpose(1, 0, 2)


def _finish_planes(mix, shift_vals, bs, mixbits, mixres, role, out_chan, filled, frame_length, num_channels, depth):
    """finish() body up to (but not including) the lane-major relayout:
    returns the C SMPTE-ordered (F, B) output planes."""
    F = frame_length
    C = num_channels
    B = mix.shape[1] // C

    # Stereo un-decorrelation (matrix.go:38-49), wrapping int32:
    #   left = u + v - ((mixres*v) >> mixbits); right = left - v
    chans = [mix[:, c * B : (c + 1) * B] for c in range(C)]
    for c in range(C - 1):
        is_u = (role[:, c] == 1)[None, :]
        uvals = chans[c]
        vvals = chans[c + 1]
        mres = mixres[:, c][None, :]
        mbits = mixbits[:, c][None, :]
        corr = sshr(mres * vvals, mbits)
        left = jnp.where(is_u & (mres != 0), uvals + vvals - corr, uvals)
        right = jnp.where(is_u & (mres != 0), left - vvals, vvals)
        chans[c] = jnp.where(is_u, left, chans[c])
        chans[c + 1] = jnp.where(is_u, right, chans[c + 1])

    # Shift re-insert: (val << shift) | shiftbits (matrix.go:129-131).  Only
    # the 24/32-bit writers apply it; 16/20-bit ignore bytesShifted
    # (matrix.go:30-105 take no shift buffer).
    if depth in (24, 32):
        for c in range(C):
            shift = (bs[:, c] * 8)[None, :]
            shifted = s(
                jax.lax.shift_left(u(chans[c]), u(jnp.minimum(shift, 31)))
            ) | shift_vals[:, c]
            chans[c] = jnp.where((bs[:, c] > 0)[None, :], shifted, chans[c])

    # 20-bit output is stored << 4 (matrix.go:91-101).
    if depth == 20:
        chans = [s(jax.lax.shift_left(u(p), U32(4))) for p in chans]

    # MPEG -> SMPTE remap via recorded out_chan (decoder.go:55-64), built
    # as selects per output position rather than a scatter; out_chan is a
    # permutation per lane, so each output channel has at most one source.
    # Later slots win on (malformed) duplicates; slots without a decoded
    # element leave their SMPTE positions zero, matching the reference's
    # zeroed output buffer.
    planes = []
    for c_out in range(C):
        acc = jnp.zeros((F, B), I32)
        for c in range(C):
            sel = ((filled[:, c] != 0) & (out_chan[:, c] == c_out))[None, :]
            acc = jnp.where(sel, chans[c], acc)
        planes.append(acc)
    return planes


def finish_packed(mix, shift_vals, bs, mixbits, mixres, role, out_chan, filled, frame_length, num_channels, depth):
    """finish() + pack_output() with the 16-bit interleave fused.

    For 16-bit even-channel batches, adjacent channel pairs pack into one
    int32 word per frame WHILE still in the (F, B) plane layout —
    little-endian int32 bytes are exactly two little-endian int16 samples
    (matrix.go:30-63's 2-byte LE writer), so the one unavoidable
    (F, ...) -> (B, ...) relayout moves half the bytes and the separate
    int16 cast pass over the transposed array disappears.

    20/24-bit batches (3-byte LE triples, matrix.go:91-131) pack four
    samples into three int32 words arithmetically while still plane-major:
    two fused passes and a 3/4-weight relayout instead of pack_output's five
    byte-granular passes.  All other
    depths/channel counts fall back to finish() + pack_output().
    """
    F = frame_length
    C = num_channels
    if depth in (20, 24) and (F * C) % 4 == 0:
        planes = _finish_planes(
            mix, shift_vals, bs, mixbits, mixres, role, out_chan, filled,
            frame_length, num_channels, depth,
        )
        # Sample-stream order s = f*C + c, grouped in fours; each group of
        # four 3-byte samples is exactly three LE int32 words.
        x = jnp.stack(planes, axis=1).reshape(F * C, -1)
        s0, s1, s2, s3 = x[0::4], x[1::4], x[2::4], x[3::4]
        w0 = (s0 & 0xFFFFFF) | s(jax.lax.shift_left(u(s1), U32(24)))
        w1 = (s(jax.lax.shift_right_logical(u(s1), U32(8))) & 0xFFFF) | s(
            jax.lax.shift_left(u(s2), U32(16))
        )
        w2 = (s(jax.lax.shift_right_logical(u(s2), U32(16))) & 0xFF) | s(
            jax.lax.shift_left(u(s3 & 0xFFFFFF), U32(8))
        )
        w = jnp.stack([w0, w1, w2], axis=-1)  # (F*C/4, B, 3)
        B = w.shape[1]
        return w.transpose(1, 0, 2).reshape(B, (F * C * 3) // 4)
    if depth != 16 or num_channels % 2 != 0:
        out = finish(
            mix, shift_vals, bs, mixbits, mixres, role, out_chan, filled,
            frame_length, num_channels, depth,
        )
        return pack_output(out, depth)
    planes = _finish_planes(
        mix, shift_vals, bs, mixbits, mixres, role, out_chan, filled,
        frame_length, num_channels, depth,
    )
    pairs = [
        (planes[2 * i] & 0xFFFF)
        | s(jax.lax.shift_left(u(planes[2 * i + 1]), U32(16)))
        for i in range(C // 2)
    ]
    if C == 2:
        packed = pairs[0].T  # (B, F): word f = (left_f, right_f)
    else:
        # (F, B, C/2) -> (B, F, C/2): word (f, i) = channels (2i, 2i+1).
        packed = jnp.stack(pairs, axis=-1).transpose(1, 0, 2)
    B = packed.shape[0]
    return packed.reshape(B, (frame_length * C) // 2)


@partial(jax.jit, static_argnames=("depth",))
def pack_output(out, depth):
    """Device-side interleaved little-endian PCM byte packing.

    Keeps the device->host transfer at exactly the PCM payload size
    (16-bit: int16 lanes; 20/24-bit: 3-byte triples as uint8; 32-bit: int32).
    Matches the matrix.go writers' byte layout.
    """
    B, F, C = out.shape
    flat = out.reshape(B, F * C)
    if depth == 16:
        return flat.astype(jnp.int16)
    if depth in (20, 24):
        u8 = jnp.stack(
            [
                (flat & 0xFF).astype(jnp.uint8),
                (sshr(flat, 8) & 0xFF).astype(jnp.uint8),
                (sshr(flat, 16) & 0xFF).astype(jnp.uint8),
            ],
            axis=-1,
        )
        return u8.reshape(B, F * C * 3)
    return flat  # 32-bit: int32 little-endian on host
