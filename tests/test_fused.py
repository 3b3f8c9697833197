"""Full-decode round trips through JaxBatchDecoder on the GPU kernels.

Both the entropy walk (ops/walk_kernel.py) and the LPC kernel
(ops/lpc_kernel.py) run in the Pallas interpreter here, at a whole batch of
B lanes, against the scalar oracle: depths x channels, encoder variants,
partial frames, noise, multi-slot layouts, corrupt lanes and wide FIR
orders.  The same kernels compiled for the card are checked by
``chip_smoke.py``.

Parity: decoder.go:210-265/348-460, golomb.go:112-253, predictor.go:99-682.
"""

import pytest

from conftest import make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.encoder.bitwriter import BitWriter
from saprobe_alac_tpu.encoder.encode import (
    ChannelSpec,
    _append,
    _encode_cpe,
    _encode_sce,
)
from saprobe_alac_tpu.ops.batch import JaxBatchDecoder

F = 256
B = 128  # several programs of each kernel (walk_kernel.LANES, lpc_kernel.LANES)


def fused_decoder(depth, channels):
    cfg = make_config(depth=depth, channels=channels, frame_length=F)
    return JaxBatchDecoder(cfg, impl="interpret")


def roundtrip(depth, channels, spec, pcm=None, seed=None):
    cfg = make_config(depth=depth, channels=channels, frame_length=F)
    if pcm is None:
        pcm = music_pcm(3 * F, channels, depth, seed=seed or (depth * 7 + channels))
    pkts = encode_packets(cfg, spec, pcm)
    want = [oracle(cfg, p)[0] for p in pkts]
    batch = [pkts[i % len(pkts)] for i in range(B)]
    got = fused_decoder(depth, channels).decode_packets(batch)
    assert all(g == want[i % len(want)] for i, g in enumerate(got))


@pytest.mark.parametrize("depth", [16, 20, 24, 32])
@pytest.mark.parametrize("channels", [1, 2])
def test_fused_std(depth, channels):
    roundtrip(depth, channels, EncoderSpec())


@pytest.mark.parametrize(
    "name,spec",
    [
        ("mode1", EncoderSpec(channel=ChannelSpec(order=12, mode=1))),
        ("o31", EncoderSpec(channel=ChannelSpec(order=31))),
        ("o0", EncoderSpec(channel=ChannelSpec(order=0))),
        ("esc", EncoderSpec(escape=True)),
        ("bs1", EncoderSpec(bytes_shifted=1)),
        ("mix0", EncoderSpec(mix_res=0)),
        ("o31mode1", EncoderSpec(channel=ChannelSpec(order=31, mode=1))),
    ],
)
def test_fused_variants(name, spec):
    depth = 24 if name == "bs1" else 16
    roundtrip(depth, 2, spec)


def test_fused_partial_final():
    roundtrip(16, 2, EncoderSpec(), pcm=music_pcm(3 * F - 37, 2, 16, seed=5))


def test_fused_noise():
    roundtrip(16, 2, EncoderSpec(), pcm=music_pcm(3 * F, 2, 16, seed=6, tonality=0.0))


def test_fused_multislot_lane_falls_back():
    """A FIL-prefixed stereo packet needs two element slots: the slot loop
    skips the FIL on device and the kernel walks the CPE in the second slot
    — output stays bit-exact."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    pcm = music_pcm(F, 2, 16, seed=9)
    spec = EncoderSpec()
    w = BitWriter()
    w.write(6, 3)
    w.write(0, 4)  # FIL, count=0
    elem = _encode_cpe(cfg, spec, spec.channel, pcm[:, 0], pcm[:, 1], False, F)
    _append(w, elem)
    w.write(7, 3)
    w.byte_align()
    pkt = w.getvalue()
    want = oracle(cfg, pkt)[0]
    got = fused_decoder(16, 2).decode_packets([pkt] * B)
    assert all(g == want for g in got)


def test_fused_underpopulated_sce_lane():
    """One SCE then END inside a stereo config, mixed into a normal batch:
    channel 0 decoded, channel 1 zero (review finding 2 semantics)."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    pcm = music_pcm(F, 2, 16, seed=9)
    spec = EncoderSpec()
    w = BitWriter()
    elem = _encode_sce(cfg, spec, spec.channel, 0, pcm[:, 0], False, F)
    _append(w, elem)
    w.write(7, 3)
    w.byte_align()
    pkt_sce = w.getvalue()
    pkts = encode_packets(cfg, spec, music_pcm(2 * F, 2, 16, seed=10))
    batch = [pkts[i % len(pkts)] for i in range(B - 1)] + [pkt_sce]
    want = [oracle(cfg, p)[0] for p in batch]
    got = fused_decoder(16, 2).decode_packets(batch)
    assert got == want


def test_wide_order_retries_at_32_taps():
    """FIR orders above 8 beside order-8 lanes: programs of the LPC kernel
    holding both orders, and programs of order-8 lanes only, stay
    bit-exact."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    pk12 = encode_packets(cfg, EncoderSpec(channel=ChannelSpec(order=12)),
                          music_pcm(2 * F, 2, 16, seed=21))
    pk8 = encode_packets(cfg, EncoderSpec(channel=ChannelSpec(order=8)),
                         music_pcm(2 * F, 2, 16, seed=22))
    # Lanes are channel-major (lane = c*B + b) and a program owns LANES
    # consecutive packets of one channel: the first half of the batch
    # alternates order 12 and order 8 inside every program, the second half
    # is order 8 only.
    mixed = [(pk12, pk8)[i % 2][i // 2 % 2] for i in range(B // 2)]
    batch = mixed + [pk8[i % 2] for i in range(B // 2)]
    want = [oracle(cfg, p)[0] for p in batch]
    assert fused_decoder(16, 2).decode_packets(batch) == want


def test_fused_corrupt_lane_falls_back():
    """Truncated packet in a fused batch: per-lane error -> oracle error
    semantics preserved (the good lanes stay on-device)."""
    cfg = make_config(depth=16, channels=2, frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(2 * F, 2, 16, seed=11))
    bad = pkts[0][: len(pkts[0]) // 3]
    batch = [pkts[i % len(pkts)] for i in range(B - 1)] + [bad]
    dec = fused_decoder(16, 2)
    with pytest.raises(Exception):
        dec.decode_packets(batch)
    # Errors on the batch surface only when the bad lane is asked for; the
    # good lanes decode fine in a batch without it.
    good = dec.decode_packets([pkts[i % len(pkts)] for i in range(B)])
    want = [oracle(cfg, p)[0] for p in pkts]
    assert all(g == want[i % len(want)] for i, g in enumerate(good))
