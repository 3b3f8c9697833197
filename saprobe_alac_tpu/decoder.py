"""Packet-level decode API.

``PacketDecoder`` is the low-level single-packet surface (parity with
reference decoder.go:79-128: NewPacketDecoder / DecodePacket / Format).

``BatchDecoder`` is the device throughput surface the reference lacks: it
decodes batches of packets in parallel on the accelerator (one packet per
lane), falling back to the host decoder per packet when a packet fails
on-device validation.
"""

from __future__ import annotations

from typing import Sequence

from .codec import decode_packet as _scalar_decode_packet
from .config import PacketConfig
from .errors import UnsupportedBitDepth
from .formats import ALAC_BIT_DEPTHS, PCMFormat


class PacketDecoder:
    """Decodes single ALAC packets into interleaved LE signed PCM bytes.

    backend: "auto" (native C++ core when available, else the Python scalar
    oracle), "native", or "scalar".
    """

    def __init__(self, config: PacketConfig, backend: str = "auto"):
        if config.bit_depth not in ALAC_BIT_DEPTHS:
            raise UnsupportedBitDepth(f"unsupported bit depth {config.bit_depth}")
        self.config = config
        if backend == "auto":
            from . import native

            backend = "native" if native.available() else "scalar"
        self.backend = backend
        self._format = PCMFormat(
            sample_rate=config.sample_rate,
            bit_depth=config.bit_depth,
            channels=config.num_channels,
        )

    def format(self) -> PCMFormat:
        return self._format

    def decode_packet(self, packet: bytes) -> bytes:
        """Decode one packet to interleaved LE signed PCM (truncated to the
        actual sample count for partial frames)."""
        if self.backend == "native":
            from . import native

            return native.decode_packet(self.config, packet)
        pcm, _ = _scalar_decode_packet(self.config, packet)
        return pcm


class BatchDecoder:
    """Batched packet decoding on the accelerator (the framework's throughput
    path).

    All packets in a batch share one PacketConfig (one file / one cookie), so
    frame length and channel layout are static shapes for the compiled kernel
    (SURVEY §7 batching contract).
    """

    def __init__(self, config: PacketConfig, backend: str = "auto"):
        if config.bit_depth not in ALAC_BIT_DEPTHS:
            raise UnsupportedBitDepth(f"unsupported bit depth {config.bit_depth}")
        self.config = config
        self._format = PCMFormat(
            sample_rate=config.sample_rate,
            bit_depth=config.bit_depth,
            channels=config.num_channels,
        )
        if backend == "auto":
            backend = "jax"
        self.backend = backend
        self._jax_impl = None

    def format(self) -> PCMFormat:
        return self._format

    def _jax(self):
        if self._jax_impl is None:
            import jax

            if len(jax.devices()) > 1:
                # Several devices: shard the packet axis over the mesh.
                from .parallel import ShardedBatchDecoder

                self._jax_impl = ShardedBatchDecoder(self.config)
            else:
                from .ops.batch import JaxBatchDecoder

                self._jax_impl = JaxBatchDecoder(self.config)
        return self._jax_impl

    def decode_packets(self, packets: Sequence[bytes]) -> list[bytes]:
        """Decode a batch of packets; returns per-packet PCM byte strings."""
        if not packets:
            return []
        if self.backend == "scalar":
            return [_scalar_decode_packet(self.config, p)[0] for p in packets]
        if self.backend == "native":
            return self._decode_native(packets)
        return self._jax().decode_packets(packets)

    def decode_async(self, packets: Sequence[bytes]):
        """Dispatch a batch without blocking; pass the returned handle to
        :meth:`finish_async` to materialize per-packet PCM bytes.

        On the device path the handle wraps in-flight device arrays, so
        callers can keep several batches in flight and overlap host packing
        with device compute (the corpus service does).  Host backends decode
        eagerly and the handle is just the finished result.
        """
        if not packets:
            return ("sync", [])
        if self.backend in ("scalar", "native"):
            return ("sync", self.decode_packets(packets))
        impl = self._jax()
        if hasattr(impl, "decode_async"):
            return ("jax", impl.decode_async(packets))
        return ("sync", impl.decode_packets(packets))

    def finish_async(self, handle, packets: Sequence[bytes]) -> list[bytes]:
        """Materialize a :meth:`decode_async` handle into PCM byte strings."""
        kind, payload = handle
        if kind == "sync":
            return payload
        return self._jax().finish_async(payload, packets)

    def _decode_native(self, packets: Sequence[bytes]) -> list[bytes]:
        """Threaded host batch decode via the C++ core; per-packet scalar
        fallback reproduces the oracle's exact error surface."""
        from . import native

        out, lens, errs = native.decode_batch(self.config, list(packets))
        results: list[bytes] = []
        for i, packet in enumerate(packets):
            if errs[i] != 0:
                results.append(_scalar_decode_packet(self.config, packet)[0])
            else:
                results.append(out[i, : lens[i]].tobytes())
        return results
