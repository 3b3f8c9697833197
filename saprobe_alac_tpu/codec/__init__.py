"""Scalar (host, NumPy/Python) ALAC codec core.

This package is the bit-exact oracle for the device compute path: an independent
implementation of the ALAC decode math (adaptive Golomb-Rice entropy coding,
adaptive LPC prediction, stereo un-decorrelation) with Go/C fixed-width integer
semantics.  The device path in `ops/` are differentially tested against it.

Reference behavior: internal/alac/{bitbuffer,golomb,predictor,matrix}.go and
decoder.go in mycophonic/saprobe-alac.
"""

from .bitcursor import BitCursor
from .element import decode_packet

__all__ = ["BitCursor", "decode_packet"]
