"""Batch decode orchestration: host packing -> device phases -> host bytes.

JaxBatchDecoder compiles one program per (config, batch-bucket, width-bucket)
and reuses it across calls.  The device program ends with on-device PCM byte
packing so the device->host transfer is exactly the PCM payload.  Packets
that trip on-device validation fall back to the host path (threaded native
core when built, else the scalar oracle), reproducing the reference's exact
per-packet error surface.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..codec import decode_packet as scalar_decode_packet
from ..config import PacketConfig
from ..formats import bytes_per_sample
from .bitpack import pack_packets_device_swap
from .epilogue import extract_escape, extract_shift, finish_packed
from .lpc import _lpc_batch
from .walk import ERR_NONE, _walk_batch, resolve_impl


#: Packets this process decoded on the host after the device flagged them
#: (malformed input, or a layout the device path declines).
_host_fallback_packets = 0


def host_fallback_packets() -> int:
    """How many packets the device batch path has handed to the host path."""
    return _host_fallback_packets


def _host_decode(config: PacketConfig, packets: Sequence[bytes]) -> list[bytes]:
    """Host-side decode at the fastest available speed.

    Fallback order auto -> native -> scalar: the threaded C++ core (~280x
    realtime) when built, else the Python oracle (~0.3x).  Packets the native
    core rejects are re-run through the oracle so genuinely malformed input
    raises the oracle's typed exception either way.
    """
    from .. import native

    if native.available():
        out, lens, errs = native.decode_batch(config, list(packets))
        results: list[bytes] = []
        for i, p in enumerate(packets):
            if errs[i] != 0:
                results.append(scalar_decode_packet(config, p)[0])  # raises typed error
            else:
                results.append(out[i, : lens[i]].tobytes())
        return results
    return [scalar_decode_packet(config, p)[0] for p in packets]


#: Bucket granularity steps: powers of two and midpoints (1.5x), bounding
#: recompiles to ~2 per octave while keeping padding waste <= 33%.
def _bucket(n: int, floor: int = 8) -> int:
    b = floor
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


def _byteswap_words(words):
    """LE<->BE 32-bit byteswap as 4 vector ops (data already in HBM)."""
    u = jax.lax.bitcast_convert_type(words, jnp.uint32)
    return jax.lax.bitcast_convert_type(
        jax.lax.shift_left(u, jnp.uint32(24))
        | jax.lax.shift_left(u & jnp.uint32(0xFF00), jnp.uint32(8))
        | (jax.lax.shift_right_logical(u, jnp.uint32(8)) & jnp.uint32(0xFF00))
        | jax.lax.shift_right_logical(u, jnp.uint32(24)),
        jnp.int32,
    )


@partial(
    jax.jit,
    static_argnames=(
        "frame_length", "num_channels", "depth", "pb", "mb", "kb", "impl",
        "pre_swapped",
    ),
)
def _decode_batch(
    words, size_bits, frame_length, num_channels, depth, pb, mb, kb, impl,
    pre_swapped=True,
):
    if not pre_swapped:
        # Host uploaded raw little-endian words (single-core packer skips
        # the byteswap); flip to the big-endian bit order the walk expects.
        words = _byteswap_words(words)
    return _decode_core(
        words, size_bits, frame_length, num_channels, depth, pb, mb, kb, impl
    )


@partial(
    jax.jit,
    static_argnames=(
        "w_bucket", "frame_length", "num_channels", "depth", "pb", "mb",
        "kb", "impl", "pre_swapped",
    ),
)
def _decode_batch_tight(
    flat, offsets, size_bits, w_bucket, frame_length, num_channels, depth,
    pb, mb, kb, impl, pre_swapped=False,
):
    """Decode from a TIGHT staging buffer: packets concatenated back to back
    (each padded only to its own word boundary) plus per-packet word offsets.

    The host uploads exactly the compressed payload — no per-row padding to
    the batch's max packet width — and the (B, W) padded layout the walk
    expects is materialized on device.  This cuts H2D bytes by the batch's
    padding ratio (~20-30% for music); rows read zeros past their own
    packet, preserving the guard-word semantics of the padded path
    (bitpack.GUARD_WORDS).
    """
    if not pre_swapped:
        flat = _byteswap_words(flat)
    Wb = w_bucket
    wcount = jax.lax.shift_right_logical(size_bits + 31, 5)
    col = jnp.arange(Wb, dtype=jnp.int32)[None, :]
    # Row materialization via vmapped dynamic_slice (contiguous row copies)
    # rather than a (B, Wb)-index elementwise gather.  _stage_tight
    # guarantees offsets[i] + Wb <= len(flat), so no slice is clamped.
    words = jax.vmap(lambda o: jax.lax.dynamic_slice(flat, (o,), (Wb,)))(
        offsets
    )
    words = jnp.where(col < wcount[:, None], words, 0)
    return _decode_core(
        words, size_bits, frame_length, num_channels, depth, pb, mb, kb, impl
    )


def _decode_core(words, size_bits, frame_length, num_channels, depth, pb, mb, kb, impl):
    F = frame_length
    C = num_channels
    B = words.shape[0]
    w = _walk_batch(words, size_bits, F, C, depth, pb, mb, kb, impl)

    # Escape channels: raw samples land in the residual planes (order == 0),
    # extracted post-hoc by a whole-batch bit gather gated on any(esc).
    # Residuals stay in the F-major (F, C, B) plane layout end to end; the
    # LPC phase reads (F, C*B) as a free reshape.
    res = jax.lax.cond(
        jnp.any(w.esc == 1),
        lambda: extract_escape(words, w.res, w.esc, w.esc_base, w.esc_cb, w.role, F, C),
        lambda: w.res,
    )

    # LPC reconstruction over (B*C) lanes, channel-major (lane = c*B + b) so
    # the (F, L) lane axis is a plain reshape of the plane stack.
    L = B * C
    mix = _lpc_batch(
        res.reshape(F, L),
        w.order.T.reshape(L),
        w.mode.T.reshape(L),
        w.den.T.reshape(L),
        w.cb.T.reshape(L),
        jnp.tile(w.ns, C),
        w.coefs.transpose(1, 0, 2).reshape(L, 32),
        F,
        impl,
    )

    # bytesShifted > 0 only appears on 24/32-bit streams; 16/20-bit finish()
    # never reads shift_vals, so XLA drops the gather there.
    shift_vals = jax.lax.cond(
        jnp.any(w.bs > 0),
        lambda: extract_shift(words, w.shift_base, w.bs, w.role, F, C),
        lambda: jnp.zeros((F, C, B), jnp.int32),
    )
    packed = finish_packed(
        mix, shift_vals, w.bs, w.mixbits, w.mixres, w.role, w.out_chan,
        w.filled, F, C, depth,
    )
    return packed, w.err, w.ns


class JaxBatchDecoder:
    """Device-batched packet decoding for one PacketConfig."""

    def __init__(self, config: PacketConfig, tight: bool = False, impl: str | None = None):
        self.config = config
        self._bps_frame = bytes_per_sample(config.bit_depth) * config.num_channels
        #: Tight staging: upload the concatenated payload + offsets and build
        #: the padded (B, W) layout on device (see _decode_batch_tight).
        #: Off by default — identical results, fewer H2D bytes when on.
        self.tight = tight
        #: Device path for the walk and LPC phases (ops/walk.default_impl).
        self.impl = resolve_impl(impl)
        # Degenerate entropy tuning (kb == 0) relies on Go uint32 bit-position
        # wrap semantics, and absurd frame lengths would blow device memory;
        # route such streams to the host path (native core, else oracle).
        self._scalar_only = config.kb == 0 or not 1 <= config.frame_length <= (1 << 16)

    def _stage(self, packets: Sequence[bytes]):
        """Host packing + padding to bucketed shapes.

        Returns (words, sizes, swapped): when swapped is False the words
        are raw little-endian and _decode_batch byteswaps on device."""
        words_np, sizes_np, swapped = pack_packets_device_swap(list(packets))
        B = len(packets)
        Bb = _bucket(B)
        Wb = _bucket(words_np.shape[1], floor=16)
        words = np.zeros((Bb, Wb), dtype=np.int32)
        words[:B, : words_np.shape[1]] = words_np
        sizes = np.zeros(Bb, dtype=np.int32)
        sizes[:B] = sizes_np
        return words, sizes, swapped

    def _stage_tight(self, packets: Sequence[bytes]):
        """Concatenated staging: (flat words, word offsets, size_bits, Wb).

        Each packet is padded only to its own 4-byte word boundary; rows are
        zero-filled past their packet on device.  flat is raw little-endian
        (the device byteswaps — one pass over the tight payload)."""
        from .bitpack import GUARD_WORDS

        B = len(packets)
        lens = np.fromiter((len(p) for p in packets), np.int64, count=B)
        wc = (lens + 3) // 4
        offs = np.zeros(B, np.int64)
        np.cumsum(wc[:-1], out=offs[1:] if B > 1 else offs[:0])
        total = int(offs[-1] + wc[-1]) + GUARD_WORDS if B else GUARD_WORDS
        # The device materializes rows with dynamic_slice(flat, offsets[i],
        # Wb): every slice must end inside flat or XLA clamps the start and
        # reads the wrong words, so size flat past the LAST packet's slice.
        Wb = _bucket(int(wc.max()) + GUARD_WORDS if B else 16, floor=16)
        total = max(total, (int(offs[-1]) + Wb) if B else Wb)
        flat = np.zeros(_bucket(total, floor=1024), np.int32)
        fb = flat.view(np.uint8)
        for i, p in enumerate(packets):
            o = int(offs[i]) * 4
            fb[o : o + len(p)] = np.frombuffer(p, np.uint8)
        Bb = _bucket(B)
        offsets = np.zeros(Bb, np.int32)
        offsets[:B] = offs
        sizes = np.zeros(Bb, np.int32)
        sizes[:B] = lens * 8
        return flat, offsets, sizes, Wb

    def decode_async(self, packets: Sequence[bytes]):
        """Dispatch a batch; returns device arrays (packed, err, ns) without
        blocking — callers can pipeline multiple batches in flight."""
        cfg = self.config
        if self.tight:
            flat, offsets, sizes, Wb = self._stage_tight(packets)
            return _decode_batch_tight(
                jnp.asarray(flat),
                jnp.asarray(offsets),
                jnp.asarray(sizes),
                Wb,
                cfg.frame_length,
                cfg.num_channels,
                cfg.bit_depth,
                cfg.pb,
                cfg.mb,
                cfg.kb,
                self.impl,
                pre_swapped=False,
            )
        words, sizes, swapped = self._stage(packets)
        return _decode_batch(
            jnp.asarray(words),
            jnp.asarray(sizes),
            cfg.frame_length,
            cfg.num_channels,
            cfg.bit_depth,
            cfg.pb,
            cfg.mb,
            cfg.kb,
            self.impl,
            pre_swapped=swapped,
        )

    def _to_bytes(self, packed_row: np.ndarray, ns: int) -> bytes:
        depth = self.config.bit_depth
        C = self.config.num_channels
        if depth == 16:
            if C % 2 == 0:
                # finish_packed fused pairs: one int32 word per (frame,
                # channel pair); LE int32 bytes == two LE int16 samples.
                return packed_row[: ns * C // 2].tobytes()
            return packed_row[: ns * C].tobytes()
        if depth in (20, 24):
            nb = ns * C * 3
            if (self.config.frame_length * C) % 4 == 0:
                # finish_packed fused triples: rows are LE int32 words, four
                # 3-byte samples per three words; trim to the byte payload.
                return packed_row[: (nb + 3) // 4].tobytes()[:nb]
            return packed_row[:nb].tobytes()
        return packed_row[: ns * C].astype("<i4").tobytes()

    def finish_async(self, handle, packets: Sequence[bytes]) -> list[bytes]:
        """Materialize a decode_async result into per-packet PCM bytes."""
        cfg = self.config
        packed, err, ns = handle
        packed = np.asarray(packed)
        err = np.asarray(err)
        ns = np.asarray(ns)

        fb_idx = [i for i in range(len(packets)) if err[i] != ERR_NONE]
        fb: dict[int, bytes] = {}
        if fb_idx:
            global _host_fallback_packets
            _host_fallback_packets += len(fb_idx)
            decoded = _host_decode(cfg, [packets[i] for i in fb_idx])
            fb = dict(zip(fb_idx, decoded))
        results: list[bytes] = []
        for i in range(len(packets)):
            if i in fb:
                results.append(fb[i])
            else:
                results.append(self._to_bytes(packed[i], int(ns[i])))
        return results

    def decode_packets(self, packets: Sequence[bytes]) -> list[bytes]:
        """Decode a batch to per-packet interleaved LE PCM bytes.

        Raises the oracle's exception for genuinely malformed packets;
        silently falls back per-packet for streams the device path declines
        (degenerate widths), keeping output bit-exact either way.
        """
        if self._scalar_only:
            return _host_decode(self.config, packets)
        return self.finish_async(self.decode_async(packets), packets)
