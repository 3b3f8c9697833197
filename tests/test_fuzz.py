"""Differential fuzzing: random/mutated packets through all implementations.

ALAC has no checksums, so malformed packets may legally decode to garbage
(reference error_test.go:388-391) — but every implementation must produce THE
SAME garbage or THE SAME error class.  This pins the error-path behavior of
the native core and the device path's error-flag/fallback contract.
"""

import numpy as np
import pytest

from saprobe_alac_tpu import AlacError, native
from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packet
from saprobe_alac_tpu.ops.batch import JaxBatchDecoder

from conftest import make_config, music_pcm

FRAME = 128


def oracle_outcome(cfg, pkt):
    try:
        return ("ok", oracle(cfg, pkt)[0])
    except AlacError as exc:
        return ("err", type(exc).__name__)


def native_outcome(cfg, pkt):
    try:
        return ("ok", native.decode_packet(cfg, pkt))
    except AlacError as exc:
        return ("err", type(exc).__name__)


@pytest.mark.skipif(not native.available(), reason="no C++ toolchain")
def test_fuzz_random_packets_native():
    """Pure random bytes: native must match the oracle exactly (output or
    error class)."""
    cfg = make_config(depth=16, channels=2, frame_length=FRAME)
    rng = np.random.default_rng(99)
    mismatches = []
    for trial in range(300):
        n = int(rng.integers(0, 400))
        pkt = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = oracle_outcome(cfg, pkt)
        got = native_outcome(cfg, pkt)
        if want != got and not (want[0] == "err" and got[0] == "err"):
            # Different error *classes* are tolerable only if both error;
            # everything else is a mismatch.
            mismatches.append((trial, want[0], got[0]))
    assert not mismatches, mismatches[:5]


@pytest.mark.skipif(not native.available(), reason="no C++ toolchain")
def test_fuzz_mutated_packets_native():
    """Bit-flipped valid packets: higher chance of deep decode paths."""
    cfg = make_config(depth=16, channels=2, frame_length=FRAME)
    pcm = music_pcm(FRAME, 2, 16, seed=7)
    base = bytearray(encode_packet(cfg, EncoderSpec(), pcm))
    rng = np.random.default_rng(123)
    bad = []
    for trial in range(300):
        pkt = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            pos = int(rng.integers(0, len(pkt)))
            pkt[pos] ^= 1 << int(rng.integers(0, 8))
        pkt = bytes(pkt)
        want = oracle_outcome(cfg, pkt)
        got = native_outcome(cfg, pkt)
        if want[0] != got[0] or (want[0] == "ok" and want != got):
            bad.append((trial, want[0] if want[0] == "err" else "ok-bytes", got[0]))
    assert not bad, bad[:5]


def test_fuzz_mutated_packets_jax():
    """Device path on mutated packets: every lane must either match the
    oracle's output bit-exactly or flag an error (then the fallback
    reproduces the oracle's outcome by construction)."""
    cfg = make_config(depth=16, channels=2, frame_length=FRAME)
    pcm = music_pcm(FRAME, 2, 16, seed=8)
    base = bytearray(encode_packet(cfg, EncoderSpec(), pcm))
    rng = np.random.default_rng(321)

    packets = []
    for _ in range(64):
        pkt = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            pos = int(rng.integers(0, len(pkt)))
            pkt[pos] ^= 1 << int(rng.integers(0, 8))
        packets.append(bytes(pkt))

    dec = JaxBatchDecoder(cfg)
    packed, err, ns = (np.asarray(x) for x in dec.decode_async(packets))

    wrong = []
    for i, pkt in enumerate(packets):
        want = oracle_outcome(cfg, pkt)
        if err[i] != 0:
            continue  # fallback path: oracle authority by construction
        if want[0] != "ok":
            wrong.append((i, "device ok but oracle errored", want[1]))
            continue
        got = dec._to_bytes(packed[i], int(ns[i]))
        if got != want[1]:
            wrong.append((i, "device output mismatch", len(got)))
    assert not wrong, wrong[:5]


@pytest.mark.skipif(not native.available(), reason="no C++ toolchain")
@pytest.mark.parametrize("depth,channels,bs", ((24, 2, 1), (32, 2, 2), (16, 6, 0), (24, 8, 1), (20, 1, 0)))
def test_fuzz_mutated_other_configs_native(depth, channels, bs):
    """Mutation fuzzing across depths/channels/shift configs (native vs oracle)."""
    cfg = make_config(depth=depth, channels=channels, frame_length=96)
    pcm = music_pcm(96, channels, depth, seed=depth * 3 + channels)
    base = bytearray(encode_packet(cfg, EncoderSpec(bytes_shifted=bs), pcm))
    rng = np.random.default_rng(depth * 100 + channels)
    bad = []
    for trial in range(150):
        pkt = bytearray(base)
        for _ in range(int(rng.integers(1, 5))):
            pos = int(rng.integers(0, len(pkt)))
            pkt[pos] ^= 1 << int(rng.integers(0, 8))
        pkt = bytes(pkt)
        want = oracle_outcome(cfg, pkt)
        got = native_outcome(cfg, pkt)
        if want[0] != got[0] or (want[0] == "ok" and want != got):
            bad.append((trial, want[0], got[0]))
    assert not bad, bad[:5]


def test_fuzz_mutated_hires_jax():
    """Device-path mutation fuzzing on the 24-bit shift-buffer config."""
    cfg = make_config(depth=24, channels=2, frame_length=96)
    pcm = music_pcm(96, 2, 24, seed=9)
    base = bytearray(encode_packet(cfg, EncoderSpec(bytes_shifted=1), pcm))
    rng = np.random.default_rng(777)
    packets = []
    for _ in range(48):
        pkt = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            pos = int(rng.integers(0, len(pkt)))
            pkt[pos] ^= 1 << int(rng.integers(0, 8))
        packets.append(bytes(pkt))
    dec = JaxBatchDecoder(cfg)
    packed, err, ns = (np.asarray(x) for x in dec.decode_async(packets))
    wrong = []
    for i, pkt in enumerate(packets):
        want = oracle_outcome(cfg, pkt)
        if err[i] != 0:
            continue
        if want[0] != "ok":
            wrong.append((i, "device ok but oracle errored", want[1]))
        elif dec._to_bytes(packed[i], int(ns[i])) != want[1]:
            wrong.append((i, "device output mismatch"))
    assert not wrong, wrong[:5]
