"""Error taxonomy for the ALAC decode framework.

Mirrors the reference's two-level sentinel design (reference: errors.go:25-33,
internal/alac/errors.go:25-32, internal/mp4/errors.go:25-33): public exception
classes wrap specific internal conditions so callers can catch broad categories
(`ConfigError`, `NoTrackError`, `DecodeError`) or narrow ones (`BitstreamOverrun`,
...).  Python idiom: exception subclassing replaces Go's errors.Is chains.
"""

from __future__ import annotations


class AlacError(Exception):
    """Base class for all errors raised by this package."""


# --- Public sentinels (reference: errors.go:25-33) ---


class ConfigError(AlacError):
    """Invalid or unsupported ALAC configuration.

    Bad magic cookie, unsupported version, unsupported bit depth.
    """


class NoTrackError(AlacError):
    """No usable ALAC track was found in the container."""


class DecodeError(AlacError):
    """Failure during packet decoding.

    Bitstream overrun, invalid headers, unsupported elements.
    """


# --- Codec-internal conditions (reference: internal/alac/errors.go:25-32) ---


class InvalidCookie(ConfigError):
    """Magic cookie is too short or malformed."""


class UnsupportedVersion(ConfigError):
    """ALACSpecificConfig compatibleVersion > 0."""


class UnsupportedBitDepth(ConfigError):
    """Bit depth not in {16, 20, 24, 32}."""


class UnsupportedElement(DecodeError):
    """CCE/PCE element encountered (not supported by ALAC)."""


class InvalidHeader(DecodeError):
    """The 12 unused header bits were non-zero."""


class InvalidShift(DecodeError):
    """bytesShifted field was 3 (invalid)."""


class BitstreamOverrun(DecodeError):
    """Bit cursor ran past the end of the packet."""


class SampleOverrun(DecodeError):
    """Decoded sample count exceeds the frame buffer."""


# --- Container conditions (reference: internal/mp4/errors.go:25-33) ---


class Mp4Error(NoTrackError):
    """Base class for MP4 container parse failures."""


class NoAlacTrack(Mp4Error):
    """No ALAC track found in the container."""


class InvalidSampleEntry(Mp4Error):
    """Malformed 'alac' sample entry in stsd."""


class InvalidBoxSize(Mp4Error):
    """Box size smaller than its header."""


class NoChunkOffset(Mp4Error):
    """Missing or invalid stco/co64 box."""


class NoStsc(Mp4Error):
    """Missing or invalid stsc box."""


class NoStsz(Mp4Error):
    """Missing or invalid stsz box."""
