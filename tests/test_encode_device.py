"""Device-side encoder: byte-identical to the host encoder, and a full
device encode -> device decode loop."""

import numpy as np
import pytest

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packet
from saprobe_alac_tpu.encoder.encode import ChannelSpec
from saprobe_alac_tpu.ops.batch import JaxBatchDecoder
from saprobe_alac_tpu.ops.encode_device import encode_packets_device

from conftest import expected_pcm_bytes, make_config, music_pcm

F = 160


def spec_for(order, **kw):
    coefs = ([160, 80, 40, 20, 10, 5, 3, 2] * 4)[:order] if order not in (0, 31) else []
    return EncoderSpec(channel=ChannelSpec(order=order, coefs=coefs, fit=False),
                       **kw)


@pytest.mark.parametrize(
    "depth,channels,order,bs,mix_res",
    [
        (16, 2, 4, 0, 1),
        (16, 1, 8, 0, 0),
        (24, 2, 4, 1, 1),
        (16, 6, 4, 0, 1),
        (16, 2, 0, 0, 1),
        (16, 2, 31, 0, 1),
        (32, 2, 4, 0, 1),
        (24, 8, 4, 1, 2),
        (16, 2, 12, 0, -3),
    ],
    ids=["std", "mono8", "bs24", "5.1", "o0", "o31", "d32", "7.1bs", "o12mixneg"],
)
def test_device_encoder_byte_identical(depth, channels, order, bs, mix_res):
    cfg = make_config(depth=depth, channels=channels, frame_length=F)
    pcm = music_pcm(F, channels, depth, seed=depth + channels + order)
    spec = spec_for(order, bytes_shifted=bs, mix_res=mix_res)
    dev = encode_packets_device(cfg, spec, [pcm])[0]
    host = encode_packet(cfg, spec, pcm)
    assert dev == host
    assert oracle(cfg, dev)[0] == expected_pcm_bytes(pcm, depth)


def test_device_encoder_batch_and_partials():
    cfg = make_config(depth=16, channels=2, frame_length=F)
    spec = spec_for(4, mix_res=1)
    pcms = [music_pcm(F, 2, 16, seed=i) for i in range(5)] + [music_pcm(77, 2, 16, seed=9)]
    dev = encode_packets_device(cfg, spec, pcms)
    for pkt, pcm in zip(dev, pcms):
        assert pkt == encode_packet(cfg, spec, pcm)


def test_full_device_loop():
    """PCM -> device encode -> device decode -> identical PCM, host only
    moving bytes."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    spec = spec_for(4, mix_res=1)
    pcms = [music_pcm(F, 2, 16, seed=20 + i, tonality=0.9) for i in range(8)]
    pkts = encode_packets_device(cfg, spec, pcms)
    decoded = JaxBatchDecoder(cfg).decode_packets(pkts)
    for got, pcm in zip(decoded, pcms):
        assert got == expected_pcm_bytes(pcm, 16)


def test_device_encoder_silence_zero_runs():
    cfg = make_config(depth=16, channels=2, frame_length=F)
    spec = spec_for(4, mix_res=1)
    pcm = np.zeros((F, 2), dtype=np.int64)
    pcm[50, 0] = 7
    dev = encode_packets_device(cfg, spec, [pcm])[0]
    assert dev == encode_packet(cfg, spec, pcm)


def test_device_auto_escape_and_uncodable_gate():
    """Auto-escape picks the verbatim element for noise (byte-identical to
    host), and the INT32_MIN-at-32-bit uncodable gate forces escape."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    spec = EncoderSpec(channel=ChannelSpec(order=4, coefs=[160, 80, 40, 20], fit=False))
    noise = music_pcm(F, 2, 16, seed=2, tonality=0.0)
    assert encode_packets_device(cfg, spec, [noise])[0] == encode_packet(cfg, spec, noise)

    cfg32 = make_config(depth=32, channels=1, frame_length=F)
    pcm = np.full((F, 1), (1 << 31) - 1, dtype=np.int64)
    pcm[0, 0] = 0
    spec32 = EncoderSpec(channel=ChannelSpec(order=4, coefs=[160, 80, 40, 20], fit=False))
    dev = encode_packets_device(cfg32, spec32, [pcm])[0]
    assert dev == encode_packet(cfg32, spec32, pcm)
    assert oracle(cfg32, dev)[0] == expected_pcm_bytes(pcm, 32)


def test_device_large_unsigned_quotients():
    """Unsigned Golomb quotient compare (q >= 2^31 must still escape):
    32-bit content with huge alternating residuals."""
    cfg = make_config(depth=32, channels=1, frame_length=64)
    pcm = np.zeros((64, 1), dtype=np.int64)
    pcm[1::2] = (1 << 30) + 12345
    spec = spec_for(4)
    dev = encode_packets_device(cfg, spec, [pcm])[0]
    assert dev == encode_packet(cfg, spec, pcm)
    assert oracle(cfg, dev)[0] == expected_pcm_bytes(pcm, 32)


def test_device_empty_and_mix_bits_zero():
    cfg = make_config(depth=16, channels=2, frame_length=64)
    assert encode_packets_device(cfg, spec_for(4), []) == []
    pcm = music_pcm(64, 2, 16, seed=1)
    spec = spec_for(4, mix_bits=0, mix_res=2)
    dev = encode_packets_device(cfg, spec, [pcm])[0]
    assert dev == encode_packet(cfg, spec, pcm)


def test_device_mode_delta_prepass():
    """mode>0 (two-stage delta, decoder.go:307-309) now runs on-device."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    spec = EncoderSpec(channel=ChannelSpec(order=4, coefs=[160, 80, 40, 20],
                                           fit=False, mode=1))
    pcm = music_pcm(F, 2, 16, seed=3, tonality=0.8)
    dev = encode_packets_device(cfg, spec, [pcm])[0]
    assert dev == encode_packet(cfg, spec, pcm)
    assert oracle(cfg, dev)[0] == expected_pcm_bytes(pcm, 16)


def test_device_adaptive_pb_candidates():
    """Per-lane adaptive pbFactor: each channel header carries the winning
    candidate, byte-identical to the host's smallest-wins selection."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    spec = EncoderSpec(channel=ChannelSpec(
        order=4, coefs=[160, 80, 40, 20], fit=False, pb_candidates=(2, 4, 7)))
    pcms = [music_pcm(F, 2, 16, seed=s, tonality=t)
            for s, t in [(1, 0.9), (2, 0.2), (3, 0.6)]]
    dev = encode_packets_device(cfg, spec, pcms)
    for pkt, pcm in zip(dev, pcms):
        assert pkt == encode_packet(cfg, spec, pcm)
        assert oracle(cfg, pkt)[0] == expected_pcm_bytes(pcm, 16)


def test_device_per_element_specs():
    """EncoderSpec.elements overrides per bitstream element (5.1 layout:
    SCE + CPE + CPE + LFE-SCE) — mixed orders/modes on one packet."""
    cfg = make_config(depth=16, channels=6, frame_length=F)
    mk = lambda o, m=0: ChannelSpec(order=o, coefs=[160, 80, 40, 20, 10, 5][:o],
                                    fit=False, mode=m)
    spec = EncoderSpec(channel=mk(4),
                       elements=[mk(2), mk(6), mk(4, m=1), mk(0)], mix_res=1)
    pcm = music_pcm(F, 6, 16, seed=11)
    dev = encode_packets_device(cfg, spec, [pcm])[0]
    assert dev == encode_packet(cfg, spec, pcm)
    assert oracle(cfg, dev)[0] == expected_pcm_bytes(pcm, 16)


def test_device_forced_escape():
    """spec.escape forces verbatim elements on-device too."""
    cfg = make_config(depth=24, channels=2, frame_length=F)
    spec = spec_for(4, escape=True)
    pcm = music_pcm(F, 2, 24, seed=5)
    dev = encode_packets_device(cfg, spec, [pcm])[0]
    assert dev == encode_packet(cfg, spec, pcm)
    assert oracle(cfg, dev)[0] == expected_pcm_bytes(pcm, 24)


@pytest.mark.parametrize(
    "pb,mb,kb,tonality",
    [(40, 10, 14, 0.98), (10, 40, 10, 0.5), (40, 10, 1, 0.98), (40, 10, 14, 0.0)],
    ids=["apple", "alt-tuning", "kb1", "noise"],
)
def test_device_entropy_tunings_match_host(pb, mb, kb, tonality):
    """The lockstep device entropy encoder across tunings and content
    regimes — small residuals, the kb=1 corner (k == 1 emits a 0-width
    suffix), escape-heavy noise — with a partial frame and a silent run
    (zero-run codes, golomb.go:223-246), byte-identical to the host
    encoder."""
    cfg = make_config(depth=16, channels=2, frame_length=F, pb=pb, mb=mb, kb=kb)
    pcm = music_pcm(3 * F - 29, 2, 16, seed=kb + mb, tonality=tonality)
    pcm[F : F + 100] = 0
    spec = spec_for(4, mix_res=1)
    pcms = [pcm[i : i + F] for i in range(0, len(pcm), F)]
    dev = encode_packets_device(cfg, spec, pcms)
    assert dev == [encode_packet(cfg, spec, p) for p in pcms]
