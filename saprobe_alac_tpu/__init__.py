"""saprobe_alac_tpu — batched ALAC (Apple Lossless) decode on an accelerator.

A from-scratch reimplementation of the capabilities of mycophonic/saprobe-alac,
redesigned for packet-parallel decode on an accelerator:

- Host layer: MP4/M4A demux, magic-cookie parsing, packet batching, streaming
  ``Decoder`` facade with Read/Seek/Format/Duration/Position semantics
  (reference decode.go).
- Scalar oracle: a bit-exact host implementation of the codec core
  (``codec/``) used for differential testing and single-packet decode.
- Device compute path (``ops/``): massively parallel packet-level batch
  decoding in JAX/XLA and Pallas kernels for the GPU — adaptive Golomb-Rice entropy decoding, adaptive LPC
  reconstruction, stereo un-decorrelation and PCM formatting, one packet per
  lane.
- Multi-device scale-out (``parallel/``): pure data parallelism over the packet
  axis via jax.sharding / shard_map (packets are self-contained; the algorithm
  needs no collectives — reference SURVEY §2.4).
- Encoder (``encoder/``): full ALAC encoder + M4A muxer (fixture generation
  and a capability the reference lacks).

Public surface parity with the reference (decode.go, config.go, decoder.go):
``Decoder`` (new_decoder/read/seek/format/duration/position),
``parse_magic_cookie``, ``PacketDecoder`` (decode_packet/format), plus the
batch-throughput API ``BatchDecoder.decode_packets``.
"""

from .config import PacketConfig, parse_magic_cookie
from .decode import Decoder, decode_file, demux_stream, new_decoder
from .decoder import BatchDecoder, PacketDecoder
from .errors import (
    AlacError,
    BitstreamOverrun,
    ConfigError,
    DecodeError,
    InvalidCookie,
    InvalidHeader,
    InvalidShift,
    NoTrackError,
    SampleOverrun,
    UnsupportedBitDepth,
    UnsupportedElement,
    UnsupportedVersion,
)
from .formats import ALAC_BIT_DEPTHS, PCMFormat, bytes_per_sample
from .service import DecodedFile, decode_corpus, iter_decode_corpus

__version__ = "0.1.0"

__all__ = [
    "ALAC_BIT_DEPTHS",
    "AlacError",
    "BatchDecoder",
    "BitstreamOverrun",
    "ConfigError",
    "DecodeError",
    "Decoder",
    "InvalidCookie",
    "InvalidHeader",
    "InvalidShift",
    "NoTrackError",
    "PCMFormat",
    "PacketConfig",
    "PacketDecoder",
    "SampleOverrun",
    "UnsupportedBitDepth",
    "UnsupportedElement",
    "UnsupportedVersion",
    "bytes_per_sample",
    "decode_corpus",
    "iter_decode_corpus",
    "decode_file",
    "demux_stream",
    "new_decoder",
    "parse_magic_cookie",
]
