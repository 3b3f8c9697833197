"""Differential conformance: in-repo encoder -> scalar oracle decoder.

Mirrors the reference's conformance strategy (tests/conformance_test.go:568-628):
sweep bit depth x sample rate x channels x encoder modes, verify bit-for-bit
PCM.  With no external encoders in this environment, the in-repo encoder plays
the fixture-generator role; the scalar oracle is the reference decoder the device
path is later diffed against.
"""

import numpy as np
import pytest

from saprobe_alac_tpu.codec.element import decode_packet
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packet, encode_packets
from saprobe_alac_tpu.encoder.encode import ChannelSpec

from conftest import expected_pcm_bytes, make_config, music_pcm

ALL_DEPTHS = (16, 20, 24, 32)


def roundtrip(cfg, spec, pcm):
    pkt = encode_packet(cfg, spec, pcm)
    got, ns = decode_packet(cfg, pkt)
    assert ns == pcm.shape[0]
    want = expected_pcm_bytes(pcm, cfg.bit_depth)
    assert got == want


@pytest.mark.parametrize("depth", ALL_DEPTHS)
@pytest.mark.parametrize("channels", (1, 2, 3, 4, 5, 6, 7, 8))
def test_depth_channel_matrix(depth, channels):
    cfg = make_config(depth=depth, channels=channels, frame_length=256)
    pcm = music_pcm(256, channels, depth, seed=depth * 8 + channels)
    roundtrip(cfg, EncoderSpec(), pcm)


@pytest.mark.parametrize("rate", (8000, 11025, 16000, 22050, 24000, 32000, 44100, 48000, 88200, 96000, 192000))
def test_sample_rates(rate):
    cfg = make_config(depth=16, channels=2, frame_length=256, sample_rate=rate)
    pcm = music_pcm(256, 2, 16, seed=rate % 1000)
    roundtrip(cfg, EncoderSpec(), pcm)


@pytest.mark.parametrize("order", (0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 30, 31))
def test_predictor_orders(order):
    """Covers the specialized (4/5/6/8), general, delta (31), and copy (0) paths.

    Order is a 5-bit field (decoder.go:431), so 0..31 with 31 = delta mode;
    the max FIR order is 30.
    """
    cfg = make_config(depth=16, channels=2, frame_length=256)
    pcm = music_pcm(256, 2, 16, seed=order)
    roundtrip(cfg, EncoderSpec(channel=ChannelSpec(order=order)), pcm)


@pytest.mark.parametrize("mode", (0, 1))
@pytest.mark.parametrize("order", (4, 12))
def test_two_stage_mode(mode, order):
    cfg = make_config(depth=16, channels=2, frame_length=256)
    pcm = music_pcm(256, 2, 16, seed=42)
    roundtrip(cfg, EncoderSpec(channel=ChannelSpec(order=order, mode=mode)), pcm)


@pytest.mark.parametrize("depth", (24, 32))
@pytest.mark.parametrize("bytes_shifted", (1, 2))
@pytest.mark.parametrize("channels", (1, 2))
def test_shift_buffer_paths(depth, bytes_shifted, channels):
    """bytesShifted 1-2 exercises the two-cursor shift-buffer region.

    Only 24/32-bit writers re-insert shift bits (matrix.go); the encoder
    never shifts shallower depths (it would be lossy — see
    test_review_fixes.test_16bit_shifted_stream_ignores_shift_bits).
    """
    if depth == 24 and bytes_shifted == 2:
        pytest.skip("2-byte shift at 24-bit leaves too few channel bits")
    cfg = make_config(depth=depth, channels=channels, frame_length=256)
    pcm = music_pcm(256, channels, depth, seed=depth + bytes_shifted)
    roundtrip(cfg, EncoderSpec(bytes_shifted=bytes_shifted), pcm)


@pytest.mark.parametrize("depth", ALL_DEPTHS)
def test_escape_elements(depth):
    """Raw (uncompressed) element path with white noise (incompressible)."""
    cfg = make_config(depth=depth, channels=2, frame_length=256)
    pcm = music_pcm(256, 2, depth, seed=depth, tonality=0.0)
    roundtrip(cfg, EncoderSpec(escape=True), pcm)


@pytest.mark.parametrize("mix_res,mix_bits", ((0, 0), (1, 1), (2, 2), (3, 1), (-1, 1), (127, 7)))
def test_mix_modes(mix_res, mix_bits):
    """Stereo decorrelation across mixRes values incl. negative (int8)."""
    cfg = make_config(depth=16, channels=2, frame_length=256)
    pcm = music_pcm(256, 2, 16, seed=mix_res & 0xFF)
    roundtrip(cfg, EncoderSpec(mix_res=mix_res, mix_bits=max(mix_bits, 1)), pcm)


@pytest.mark.parametrize("n", (1, 5, 255, 4095))
def test_partial_frames(n):
    """Partial final frame with 32-bit sample-count override."""
    cfg = make_config(depth=16, channels=2, frame_length=4096)
    pcm = music_pcm(n, 2, 16, seed=n)
    roundtrip(cfg, EncoderSpec(), pcm)


def test_zero_runs():
    """Silence triggers the zero-run mode of the entropy coder."""
    cfg = make_config(depth=16, channels=2, frame_length=1024)
    pcm = np.zeros((1024, 2), dtype=np.int64)
    pcm[100, 0] = 5
    pcm[500, 1] = -3
    pcm[900, :] = 100
    roundtrip(cfg, EncoderSpec(), pcm)


def test_all_silence():
    cfg = make_config(depth=16, channels=2, frame_length=4096)
    roundtrip(cfg, EncoderSpec(), np.zeros((4096, 2), dtype=np.int64))


def test_full_scale_square():
    """Extreme amplitude alternation stresses residual magnitudes."""
    cfg = make_config(depth=16, channels=2, frame_length=512)
    pcm = np.zeros((512, 2), dtype=np.int64)
    pcm[0::2] = 32767
    pcm[1::2] = -32768
    roundtrip(cfg, EncoderSpec(), pcm)


def test_multi_packet_stream():
    cfg = make_config(depth=16, channels=2, frame_length=1024)
    pcm = music_pcm(4096 + 321, 2, 16, seed=7)
    packets = encode_packets(cfg, EncoderSpec(), pcm)
    assert len(packets) == 5
    out = b""
    total = 0
    for pkt in packets:
        pcm_bytes, ns = decode_packet(cfg, pkt)
        out += pcm_bytes
        total += ns
    assert total == pcm.shape[0]
    assert out == expected_pcm_bytes(pcm, 16)


@pytest.mark.parametrize("n,order", ((1, 12), (3, 12), (5, 4), (2, 31), (13, 12)))
def test_tiny_partial_frames_high_order(n, order):
    """Partial frames shorter than the predictor order: warm-up covers the
    whole frame (boundary of predictor.go:76-79)."""
    cfg = make_config(depth=16, channels=2, frame_length=4096)
    pcm = music_pcm(n, 2, 16, seed=n * 7 + order)
    roundtrip(cfg, EncoderSpec(channel=ChannelSpec(order=order, fit=False)), pcm)
