"""Differential conformance: JAX device batch pipeline vs the scalar oracle.

Each distinct (depth, channels, frame) compiles once (~15s on CPU), so the
suite reuses a few configs and varies encoder specs within them.  The full
56-config sweep lives in hack/sweep_jax.py for deeper (slower) validation.
"""

import numpy as np
import pytest

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.encoder.encode import ChannelSpec
from saprobe_alac_tpu.ops.batch import JaxBatchDecoder

from conftest import make_config, music_pcm

FRAME = 160

_decoders = {}


def get_decoder(cfg):
    key = (cfg.bit_depth, cfg.num_channels, cfg.frame_length)
    if key not in _decoders:
        _decoders[key] = JaxBatchDecoder(cfg)
    return _decoders[key]


def diff(cfg, spec, pcm):
    pkts = encode_packets(cfg, spec, pcm)
    got = get_decoder(cfg).decode_packets(pkts)
    want = [oracle(cfg, p)[0] for p in pkts]
    assert got == want


@pytest.mark.parametrize(
    "spec",
    [
        EncoderSpec(),
        EncoderSpec(mix_res=0),
        EncoderSpec(mix_res=-3, mix_bits=2),
        EncoderSpec(escape=True),
        EncoderSpec(channel=ChannelSpec(order=0)),
        EncoderSpec(channel=ChannelSpec(order=5)),
        EncoderSpec(channel=ChannelSpec(order=8)),
        EncoderSpec(channel=ChannelSpec(order=30)),
        EncoderSpec(channel=ChannelSpec(order=31)),
        EncoderSpec(channel=ChannelSpec(order=12, mode=1)),
    ],
    ids=["std", "mix0", "mixneg", "escape", "o0", "o5", "o8", "o30", "o31", "o12m1"],
)
def test_stereo16_specs(spec):
    cfg = make_config(depth=16, channels=2, frame_length=FRAME)
    diff(cfg, spec, music_pcm(FRAME * 3, 2, 16, seed=7))


def test_stereo16_partial_silence_noise():
    cfg = make_config(depth=16, channels=2, frame_length=FRAME)
    diff(cfg, EncoderSpec(), music_pcm(FRAME * 3 - 37, 2, 16, seed=8))
    diff(cfg, EncoderSpec(), np.zeros((FRAME * 2, 2), dtype=np.int64))
    diff(cfg, EncoderSpec(), music_pcm(FRAME * 2, 2, 16, seed=9, tonality=0.0))


@pytest.mark.parametrize(
    "spec",
    [EncoderSpec(), EncoderSpec(bytes_shifted=1), EncoderSpec(bytes_shifted=2), EncoderSpec(escape=True)],
    ids=["std", "bs1", "bs2", "escape"],
)
def test_hires32_stereo(spec):
    """32-bit: shift-buffer two-cursor paths and wide escape reads."""
    cfg = make_config(depth=32, channels=2, frame_length=FRAME)
    diff(cfg, spec, music_pcm(FRAME * 2, 2, 32, seed=10))


def test_surround_5_1():
    """SCE+CPE+CPE+LFE element layout with SMPTE remap and shift buffers."""
    cfg = make_config(depth=24, channels=6, frame_length=FRAME)
    diff(cfg, EncoderSpec(bytes_shifted=1), music_pcm(FRAME * 2, 6, 24, seed=11))
    diff(cfg, EncoderSpec(), music_pcm(FRAME * 2, 6, 24, seed=12))


@pytest.mark.parametrize("channels", [4, 6, 5])
def test_multichannel16_fused_pack(channels):
    """16-bit multichannel through the fused channel-pair byte packer
    (even C) and the int16 fallback (odd C), including a partial final
    frame so the ns-trim of packed words is exercised."""
    cfg = make_config(depth=16, channels=channels, frame_length=FRAME)
    diff(cfg, EncoderSpec(), music_pcm(FRAME * 2 - 29, channels, 16, seed=43 + channels))


def test_malformed_packets_fall_back():
    """Corrupt packets route through the scalar oracle and raise its errors."""
    from saprobe_alac_tpu.errors import DecodeError

    cfg = make_config(depth=16, channels=2, frame_length=FRAME)
    pcm = music_pcm(FRAME, 2, 16, seed=13)
    pkts = encode_packets(cfg, EncoderSpec(), pcm)
    dec = get_decoder(cfg)
    with pytest.raises(DecodeError):
        dec.decode_packets([pkts[0][: len(pkts[0]) // 3]])
    # A good batch still works after an error.
    assert dec.decode_packets(pkts) == [oracle(cfg, p)[0] for p in pkts]


def test_large_batch_bucketing():
    """Batch sizes cross bucket boundaries; padding lanes are dropped."""
    cfg = make_config(depth=16, channels=2, frame_length=FRAME)
    pcm = music_pcm(FRAME * 9, 2, 16, seed=14)
    pkts = encode_packets(cfg, EncoderSpec(), pcm)
    assert len(pkts) == 9  # buckets to 16
    got = get_decoder(cfg).decode_packets(pkts)
    assert got == [oracle(cfg, p)[0] for p in pkts]


def test_wide_lane_block():
    """B = 2048 selects the 2048-lane (SL=16) walk blocking and the LPC
    kernel's 2x(SL=8) view of the walk rows buffer (ops/lpc.py) — the
    production headline geometry; smaller batches never reach it."""
    cfg = make_config(depth=16, channels=2, frame_length=FRAME)
    pcm = music_pcm(FRAME * 16, 2, 16, seed=23)
    pkts = encode_packets(cfg, EncoderSpec(), pcm)
    want = [oracle(cfg, p)[0] for p in pkts]
    batch = [pkts[i % len(pkts)] for i in range(2048)]
    got = get_decoder(cfg).decode_packets(batch)
    assert got == [want[i % len(pkts)] for i in range(2048)]


def test_streaming_facade_with_prefetch():
    """Decoder(backend='jax') with a small batch size exercises the
    prefetch pipeline and seek-drops-prefetch."""
    import io

    from saprobe_alac_tpu import new_decoder
    from saprobe_alac_tpu.encoder import build_m4a

    from conftest import expected_pcm_bytes

    cfg = make_config(depth=16, channels=2, frame_length=FRAME)
    pcm = music_pcm(FRAME * 7 - 11, 2, 16, seed=30)
    pkts = encode_packets(cfg, EncoderSpec(), pcm)
    spp = [min(FRAME, pcm.shape[0] - i * FRAME) for i in range(len(pkts))]
    m4a = build_m4a(cfg, pkts, spp)
    want = expected_pcm_bytes(pcm, 16)

    dec = new_decoder(io.BytesIO(m4a), backend="jax", batch_size=2)
    assert dec.read() == want

    dec = new_decoder(io.BytesIO(m4a), backend="jax", batch_size=3)
    dec.read(100)  # trigger decode + prefetch
    pos = dec.seek(0.0)  # drops prefetch
    assert pos == 0.0
    assert dec.read() == want


def test_mixed_divergent_batch():
    """One device batch mixing compressed, escape, delta-mode, partial and
    silent packets: lanes diverge in element type, bit consumption and
    zero-run behavior within the same lockstep program."""
    cfg = make_config(depth=16, channels=2, frame_length=FRAME)
    specs = [
        EncoderSpec(),
        EncoderSpec(escape=True),
        EncoderSpec(channel=ChannelSpec(order=31)),
        EncoderSpec(channel=ChannelSpec(order=0)),
        EncoderSpec(channel=ChannelSpec(order=12, mode=1)),
        EncoderSpec(mix_res=0),
    ]
    pkts = []
    for i, spec in enumerate(specs):
        pcm = music_pcm(FRAME, 2, 16, seed=100 + i, tonality=0.9 if i % 2 else 0.1)
        pkts.append(encode_packets(cfg, spec, pcm)[0])
    # a silent packet (deep zero runs) and a partial frame
    pkts.append(encode_packets(cfg, EncoderSpec(), np.zeros((FRAME, 2), dtype=np.int64))[0])
    pkts.append(encode_packets(cfg, EncoderSpec(), music_pcm(FRAME // 3, 2, 16, seed=7))[0])

    got = get_decoder(cfg).decode_packets(pkts)
    want = [oracle(cfg, p)[0] for p in pkts]
    assert got == want


def test_production_frame_4096():
    """Device-vs-oracle at the production frame length (every real ALAC file
    uses F=4096).  Guards frame-length-dependent failure modes the short-frame
    suite cannot see: bit-position growth, bucket edges, while-loop caps.
    Parity: reference conformance matrix always runs at 4096
    (tests/conformance_test.go:568-628)."""
    cfg = make_config(depth=16, channels=2, frame_length=4096)
    specs = [
        EncoderSpec(),
        EncoderSpec(escape=True),
        EncoderSpec(channel=ChannelSpec(order=31)),
        EncoderSpec(channel=ChannelSpec(order=8)),
    ]
    pkts = []
    for i, spec in enumerate(specs):
        pcm = music_pcm(4096, 2, 16, seed=200 + i, tonality=0.95 if i % 2 else 0.2)
        pkts.append(encode_packets(cfg, spec, pcm)[0])
    # partial final frame + a silent frame (deep zero runs at scale)
    pkts.append(encode_packets(cfg, EncoderSpec(), music_pcm(4096 - 321, 2, 16, seed=204))[0])
    pkts.append(encode_packets(cfg, EncoderSpec(), np.zeros((4096, 2), dtype=np.int64))[0])

    got = JaxBatchDecoder(cfg).decode_packets(pkts)
    want = [oracle(cfg, p)[0] for p in pkts]
    assert got == want


def test_tiny_partial_frames_device():
    cfg = make_config(depth=16, channels=2, frame_length=FRAME)
    pkts = []
    for n, order in ((1, 12), (3, 12), (2, 31), (13, 12)):
        pcm = music_pcm(n, 2, 16, seed=n + order)
        pkts.append(
            encode_packets(cfg, EncoderSpec(channel=ChannelSpec(order=order, fit=False)), pcm)[0]
        )
    got = get_decoder(cfg).decode_packets(pkts)
    assert got == [oracle(cfg, p)[0] for p in pkts]


def test_pack_packets_device_swap_parity():
    """Deferred-byteswap packing is byte-identical to the host-swapped
    words after one byteswap (the op _decode_batch performs on device)."""
    import numpy as np

    from saprobe_alac_tpu.ops.bitpack import pack_packets, pack_packets_device_swap

    pkts = [bytes([i % 256 for i in range(n)]) for n in (1, 2, 3, 4, 5, 17, 400)]
    ws, sz = pack_packets(pkts)
    wd, sd, swapped = pack_packets_device_swap(pkts)
    assert np.array_equal(sz, sd)
    if not swapped:
        wd = wd.view(np.uint32).byteswap().view(np.int32)
    assert np.array_equal(ws, wd)


def test_pack_packets_native_vs_fallback(monkeypatch):
    """The C++ packer and the numpy fallback produce identical batches
    (same words after the deferred byteswap, same sizes)."""
    import numpy as np

    from saprobe_alac_tpu import native
    from saprobe_alac_tpu.ops.bitpack import pack_packets

    if not native.available():
        import pytest

        pytest.skip("native core not loadable")
    pkts = [bytes([(i * 7 + n) % 256 for i in range(n)]) for n in (1, 3, 4, 33, 400, 4099)]
    wn, sn = pack_packets(pkts)
    monkeypatch.setattr(native, "available", lambda: False)
    wf, sf = pack_packets(pkts)
    assert np.array_equal(sn, sf)
    assert np.array_equal(wn, wf)
