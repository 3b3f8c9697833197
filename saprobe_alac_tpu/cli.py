"""Command-line M4A -> WAV/PCM decoder.

Parity with the reference CLI (cmd/alac-example-decoder/main.go):
  alac-decode [-version] [-format wav|pcm] [-backend scalar|jax] <in.m4a|-> [out]

stdin input ('-') is buffered to memory (the container needs seeking,
main.go:117-133); WAV output buffers all PCM for the 44-byte header
(main.go:91-104); PCM mode streams.
"""

from __future__ import annotations

import argparse
import io
import sys

from . import __version__, new_decoder
from .errors import AlacError
from .utils.wav import wav_header


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="alac-decode", description="Decode ALAC (Apple Lossless) M4A to WAV or raw PCM."
    )
    parser.add_argument("-version", "--version", action="version", version=f"alac-decode {__version__}")
    parser.add_argument("-format", "--format", choices=("wav", "pcm"), default="wav")
    parser.add_argument(
        "-backend", "--backend", choices=("auto", "native", "scalar", "jax"), default="auto",
        help="decode backend: scalar oracle (host) or batched device (JAX)",
    )
    parser.add_argument("-batch", "--batch", type=int, default=64, help="packets per device batch")
    parser.add_argument("input", help="input .m4a file, or '-' for stdin")
    parser.add_argument("output", nargs="?", help="output file (default: stdout)")
    args = parser.parse_args(argv)

    if args.input == "-":
        reader = io.BytesIO(sys.stdin.buffer.read())
    else:
        try:
            reader = open(args.input, "rb")
        except OSError as exc:
            print(f"alac-decode: {exc}", file=sys.stderr)
            return 1

    try:
        dec = new_decoder(reader, backend=args.backend, batch_size=args.batch)
    except AlacError as exc:
        print(f"alac-decode: {exc}", file=sys.stderr)
        return 1

    fmt = dec.format()
    print(
        f"{fmt.sample_rate} Hz, {fmt.bit_depth}-bit, {fmt.channels} ch, "
        f"{dec.duration():.3f}s",
        file=sys.stderr,
    )

    out = open(args.output, "wb") if args.output else sys.stdout.buffer

    try:
        if args.format == "wav":
            pcm = dec.read()
            out.write(wav_header(fmt, len(pcm)))
            out.write(pcm)
        else:
            while True:
                chunk = dec.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
    except AlacError as exc:
        print(f"alac-decode: {exc}", file=sys.stderr)
        return 1
    finally:
        if args.output:
            out.close()
        if args.input != "-":
            reader.close()
    return 0


def encode_main(argv: list[str] | None = None) -> int:
    """alac-encode: WAV -> ALAC M4A (a capability the reference lacks)."""
    parser = argparse.ArgumentParser(
        prog="alac-encode", description="Encode a PCM WAV file to ALAC (Apple Lossless) M4A."
    )
    parser.add_argument("-version", "--version", action="version", version=f"alac-encode {__version__}")
    parser.add_argument("-frame", "--frame", type=int, default=4096, help="samples per packet")
    parser.add_argument("-container", "--container", choices=("m4a", "caf"), default="m4a")
    parser.add_argument("input", help="input .wav file, or '-' for stdin")
    parser.add_argument("output", nargs="?", help="output .m4a (default: stdout)")
    args = parser.parse_args(argv)

    from .encoder import encode_wav_to_m4a

    if args.input == "-":
        reader = io.BytesIO(sys.stdin.buffer.read())
    else:
        try:
            reader = open(args.input, "rb")
        except OSError as exc:
            print(f"alac-encode: {exc}", file=sys.stderr)
            return 1

    try:
        m4a = encode_wav_to_m4a(reader, frame_length=args.frame, container=args.container)
    except (ValueError, AlacError) as exc:
        print(f"alac-encode: {exc}", file=sys.stderr)
        return 1
    finally:
        if args.input != "-":
            reader.close()

    if args.output:
        with open(args.output, "wb") as out:
            out.write(m4a)
    else:
        sys.stdout.buffer.write(m4a)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
