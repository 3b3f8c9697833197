"""Streaming M4A decoder facade.

Parity with reference decode.go:32-190: a file-like reader over decoded PCM
with O(1) packet-aligned Seek, Duration/Position arithmetic, and per-packet
on-demand decode.  Device twist: instead of decoding one packet per Read, the
facade prefetches a window of packets and decodes them as one device batch,
amortizing dispatch across the embarrassingly parallel packet axis
(SURVEY §2.3: packets are fully independent).
"""

from __future__ import annotations

from typing import BinaryIO

from .config import parse_magic_cookie
from .decoder import BatchDecoder, PacketDecoder
from .formats import PCMFormat
from .mp4 import SampleInfo, find_alac_track


def demux_stream(reader: BinaryIO):
    """Sniff the container (MP4/M4A or CAF) and demux the ALAC track.

    Returns (PacketConfig, flat sample table).  Shared by the streaming
    Decoder and the corpus service.
    """
    from .caf import find_alac_track_caf, sniff_container

    if sniff_container(reader) == "caf":
        cookie, samples = find_alac_track_caf(reader)
    else:
        cookie, samples = find_alac_track(reader)
    return parse_magic_cookie(cookie), samples


class Decoder:
    """Streams decoded PCM from an ALAC M4A/MP4 source.

    The container (sample table, config) is parsed upfront; PCM is decoded in
    packet batches on demand via :meth:`read`.
    """

    def __init__(
        self,
        reader: BinaryIO,
        backend: str = "auto",
        batch_size: int = 64,
    ):
        """backend: "auto"/"native"/"scalar" decode on host per packet;
        "jax" decodes packet batches on the accelerator.

        The container is sniffed automatically: MP4/M4A (reference parity)
        or CAF (a capability the reference lacks, README.md:32-36)."""
        config, samples = demux_stream(reader)

        self._reader = reader
        self.config = config
        self._samples: list[SampleInfo] = samples
        self._sample_idx = 0
        self._buf = b""
        self._buf_off = 0
        self._eof = False
        self._batch_size = max(1, batch_size)

        if backend not in ("jax", "native") or self._batch_size == 1:
            self._packet_dec = PacketDecoder(config, backend=backend if backend != "jax" else "auto")
            self._batch_dec = None
        else:
            self._packet_dec = None
            self._batch_dec = BatchDecoder(config, backend=backend)
        # Device prefetch state: (first_sample_idx, packets, async handle).
        self._prefetch = None

    # --- Format / timing (decode.go:78-97) ---

    def format(self) -> PCMFormat:
        return PCMFormat(
            sample_rate=self.config.sample_rate,
            bit_depth=self.config.bit_depth,
            channels=self.config.num_channels,
        )

    def duration(self) -> float:
        """Total stream duration in seconds (packet-count approximation)."""
        total = len(self._samples) * self.config.frame_length
        return total / self.config.sample_rate

    def position(self) -> float:
        """Current playback position in seconds."""
        return self._sample_idx * self.config.frame_length / self.config.sample_rate

    # --- Seek (decode.go:103-124) ---

    def seek(self, t: float) -> float:
        """Seek to time ``t`` seconds; returns the actual (packet-aligned)
        position.  Negative seeks clamp to start, past-end to end."""
        target_frame = int(t * self.config.sample_rate)
        target = target_frame // self.config.frame_length
        target = max(0, min(target, len(self._samples)))

        self._sample_idx = target
        self._buf = b""
        self._buf_off = 0
        self._eof = target >= len(self._samples)
        self._prefetch = None  # prefetched window no longer matches

        return target * self.config.frame_length / self.config.sample_rate

    def seek_exact(self, t: float) -> float:
        """Sample-accurate seek (beyond the reference's packet-aligned
        :meth:`seek`): positions at the exact sample for time ``t`` by
        decoding and discarding the partial packet prefix."""
        from .formats import bytes_per_sample

        target_sample = max(0, int(t * self.config.sample_rate))
        pos = self.seek(t)
        aligned_sample = round(pos * self.config.sample_rate)
        skip = target_sample - aligned_sample
        if skip > 0 and not self._eof:
            bpf = self.config.num_channels * bytes_per_sample(self.config.bit_depth)
            skipped = len(self.read(skip * bpf)) // bpf
            return (aligned_sample + skipped) / self.config.sample_rate
        return pos

    # --- Read (decode.go:127-190) ---

    def read(self, n: int = -1) -> bytes:
        """Read up to ``n`` decoded PCM bytes (all remaining if n < 0).

        Returns b"" at end of stream (Python file-object convention; the
        reference returns (0, io.EOF))."""
        if n is None or n < 0:
            chunks = []
            while True:
                chunk = self.read(1 << 20)
                if not chunk:
                    break
                chunks.append(chunk)
            return b"".join(chunks)

        out = bytearray()
        while len(out) < n:
            if self._buf_off < len(self._buf):
                take = min(n - len(out), len(self._buf) - self._buf_off)
                out += self._buf[self._buf_off : self._buf_off + take]
                self._buf_off += take
                continue

            if self._eof or self._sample_idx >= len(self._samples):
                self._eof = True
                break

            self._fill_buffer()

        return bytes(out)

    def _read_packets(self, start: int, count: int) -> list[bytes]:
        packets = []
        for info in self._samples[start : start + count]:
            self._reader.seek(info.offset)
            data = self._reader.read(info.size)
            if len(data) < info.size:
                raise EOFError(f"short read for packet {start}: {len(data)} < {info.size}")
            packets.append(data)
        return packets

    def _fill_buffer(self) -> None:
        """Decode the next packet (or batch of packets) into the drain buffer.

        With the device backend, the NEXT batch is dispatched before the
        current one is materialized, overlapping host IO, transfers and
        device compute across windows (packets are independent, so prefetch
        never speculates wrongly except across a seek, which drops it).
        """
        if self._batch_dec is None:
            packets = self._read_packets(self._sample_idx, 1)
            self._buf = self._packet_dec.decode_packet(packets[0])
            self._buf_off = 0
            self._sample_idx += 1
            return

        count = min(self._batch_size, len(self._samples) - self._sample_idx)
        if self._batch_dec.backend == "native":
            packets = self._read_packets(self._sample_idx, count)
            self._buf = b"".join(self._batch_dec.decode_packets(packets))
            self._buf_off = 0
            self._sample_idx += count
            return

        impl = self._batch_dec._jax()
        if impl._scalar_only:
            packets = self._read_packets(self._sample_idx, count)
            self._buf = b"".join(impl.decode_packets(packets))
            self._buf_off = 0
            self._sample_idx += count
            return
        if self._prefetch is not None and self._prefetch[0] == self._sample_idx:
            _, packets, handle = self._prefetch
            count = len(packets)
        else:
            packets = self._read_packets(self._sample_idx, count)
            handle = impl.decode_async(packets)
        self._prefetch = None

        # Dispatch the next window before blocking on this one.
        nxt = self._sample_idx + count
        nxt_count = min(self._batch_size, len(self._samples) - nxt)
        if nxt_count > 0:
            nxt_packets = self._read_packets(nxt, nxt_count)
            self._prefetch = (nxt, nxt_packets, impl.decode_async(nxt_packets))

        self._buf = b"".join(impl.finish_async(handle, packets))
        self._buf_off = 0
        self._sample_idx += count


def new_decoder(reader: BinaryIO, backend: str = "auto", batch_size: int = 64) -> Decoder:
    """Open an M4A/MP4 stream containing ALAC audio (reference NewDecoder)."""
    return Decoder(reader, backend=backend, batch_size=batch_size)


def decode_file(path_or_reader, backend: str = "auto"):
    """Convenience: decode a whole M4A/CAF to (PCMFormat, (n, channels) ints).

    Accepts a path or a binary file object.
    """
    import contextlib

    from .utils.pcmconv import pcm_bytes_to_array

    if hasattr(path_or_reader, "read"):
        cm = contextlib.nullcontext(path_or_reader)
    else:
        cm = open(path_or_reader, "rb")
    with cm as f:
        dec = Decoder(f, backend=backend)
        fmt = dec.format()
        return fmt, pcm_bytes_to_array(fmt, dec.read())
