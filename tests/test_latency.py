"""Interactive small-batch latency: structural regression tests.

Wall-clock budgets are meaningless off the accelerator, so these tests pin
the *structure* that makes a warm B=32 decode cheap instead: one host
pack and ONE fused device dispatch per batch — the round-2 regression was
per-packet staging/uploads inside the facade path (decode.go:127-190's
per-packet loop translated naively), which multiplied the round trips by
the batch size.
"""

from __future__ import annotations

import numpy as np

from saprobe_alac_tpu.config import PacketConfig
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.ops import batch as batch_mod


def _fixture(B=32, F=256):
    cfg = PacketConfig(
        frame_length=F, bit_depth=16, num_channels=2, pb=40, mb=10, kb=14,
        max_run=255, max_frame_bytes=0, avg_bit_rate=0, sample_rate=44100,
    )
    n = F * B
    t = np.arange(n)
    pcm = np.stack(
        [(7000 * np.sin(2 * np.pi * t / 67)).astype(np.int64),
         (7000 * np.sin(2 * np.pi * t / 101)).astype(np.int64)],
        axis=1,
    )
    return cfg, encode_packets(cfg, EncoderSpec(), pcm), pcm


def test_warm_small_batch_single_dispatch(monkeypatch):
    """A warm B=32 decode_packets performs exactly one host pack and one
    fused device dispatch — no per-packet staging or uploads."""
    cfg, pkts, pcm = _fixture()
    dec = batch_mod.JaxBatchDecoder(cfg)
    want = pcm.astype("<i2").tobytes()
    assert b"".join(dec.decode_packets(pkts)) == want  # warm the executable

    calls = {"pack": 0, "dispatch": 0}
    real_pack = batch_mod.pack_packets_device_swap
    real_decode = batch_mod._decode_batch

    def count_pack(*a, **k):
        calls["pack"] += 1
        return real_pack(*a, **k)

    def count_decode(*a, **k):
        calls["dispatch"] += 1
        return real_decode(*a, **k)

    monkeypatch.setattr(batch_mod, "pack_packets_device_swap", count_pack)
    monkeypatch.setattr(batch_mod, "_decode_batch", count_decode)
    assert b"".join(dec.decode_packets(pkts)) == want
    assert calls == {"pack": 1, "dispatch": 1}


def test_facade_prefetch_single_dispatch_per_window(monkeypatch):
    """The streaming facade issues one dispatch per prefetch window while
    reading sequentially (plus one overlapped prefetch dispatch), never one
    per packet."""
    import io

    import saprobe_alac_tpu as alac
    from saprobe_alac_tpu.encoder import build_m4a

    cfg, pkts, pcm = _fixture(B=48)
    spp = [cfg.frame_length] * len(pkts)
    buf = io.BytesIO(build_m4a(cfg, pkts, spp))

    dec = alac.new_decoder(buf, backend="jax", batch_size=16)
    dec.read(1)  # warm compile path

    calls = {"dispatch": 0}
    real_decode = batch_mod._decode_batch

    def count_decode(*a, **k):
        calls["dispatch"] += 1
        return real_decode(*a, **k)

    monkeypatch.setattr(batch_mod, "_decode_batch", count_decode)
    buf.seek(0)
    dec2 = alac.new_decoder(buf, backend="jax", batch_size=16)
    assert dec2.read() == pcm.astype("<i2").tobytes()
    # 48 packets / window 16 = 3 windows; prefetch may run one extra
    # speculative dispatch past EOF-adjacent windows but never per-packet.
    assert calls["dispatch"] <= 4
