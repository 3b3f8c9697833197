"""ALAC encoder (host-side, pure Python/NumPy).

The reference repo relies on external encoders (ffmpeg / CoreAudio / Apple
alacconvert) to produce conformance fixtures (reference tests/conformance_test.go:427-497).
None of those exist in this environment, so this package provides a complete
in-repo encoder: it is the fixture generator for the differential test suite
(encode -> scalar-oracle decode -> device decode must all round-trip bit-exactly)
and a user-facing feature the reference lacks.

Supports 16/20/24/32-bit, 1-8 channels, compressed (adaptive Golomb-Rice +
adaptive LPC) and escape paths, stereo decorrelation, shift-buffer paths for
high bit depths, partial final frames, and M4A container output.
"""

from .api import encode_to_m4a, encode_wav_to_m4a, make_packet_config
from .encode import ChannelSpec, EncoderSpec, encode_packet, encode_packets
from .mux import build_m4a, write_m4a

__all__ = [
    "ChannelSpec",
    "EncoderSpec",
    "build_m4a",
    "encode_packet",
    "encode_packets",
    "encode_to_m4a",
    "encode_wav_to_m4a",
    "make_packet_config",
    "write_m4a",
]
