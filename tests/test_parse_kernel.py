"""Differential test of the device walk's element-header parse.

The XLA slot loop (ops/walk.py ``_parse_elem``) parses the 3-bit tag,
element headers and predictor coefficients for both device paths; the GPU
kernel only walks the entropy data.  Its WalkResult metadata must equal
what the scalar oracle reads from the same packets, field by field, so a
parse mismatch that happens not to change a particular decode (modes,
shift widths, escape flags) cannot hide.

Parity: decoder.go:210-265 (SCE), :348-460 (CPE), :538-574 (DSE/FIL).
"""

import numpy as np
import pytest

from conftest import make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.codec.bitcursor import BitCursor
from saprobe_alac_tpu.codec.element import (
    _decode_cpe,
    _decode_sce,
    _element_header,
    _read_predictor_header,
)
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets


def _oracle_headers(cfg, packet):
    """Per decoded channel: (mode, den, order, coefs, bs, esc, mixbits,
    mixres), plus the packet's sample count, read with the oracle's own
    cursor and header readers.  Every encoder layout here is SCE/CPE only."""
    bits = BitCursor(packet)
    planes = np.zeros((cfg.frame_length, cfg.num_channels), np.int64)
    ns = cfg.frame_length
    chans = []
    while len(chans) < cfg.num_channels:
        tag = bits.read(3)
        assert tag in (0, 1, 3), tag
        pair = tag == 1
        peek = bits.copy()
        bs, esc, ns_el = _element_header(peek, cfg.frame_length, ns)
        if esc:
            chans += [(0, 0, 0, [], 0, 1, 0, 0)] * (2 if pair else 1)
        else:
            mixbits = peek.read(8)
            mixres = peek.read(8)
            mixres = mixres - 256 if mixres >= 128 else mixres
            for _ in range(2 if pair else 1):
                mode, den, _, coefs = _read_predictor_header(peek)
                chans.append(
                    (mode, den, len(coefs), coefs, bs, 0,
                     mixbits if pair else 0, mixres if pair else 0)
                )
        decode = _decode_cpe if pair else _decode_sce
        ns = decode(cfg, bits, planes, 0, ns)
        assert ns == ns_el
    return chans, ns


def _walk_xla(cfg, pkts):
    import jax.numpy as jnp

    from saprobe_alac_tpu.ops.bitpack import pack_packets
    from saprobe_alac_tpu.ops.walk import walk_batch

    words_np, sizes_np = pack_packets(pkts)
    return walk_batch(
        jnp.asarray(words_np), jnp.asarray(sizes_np), cfg.frame_length,
        cfg.num_channels, cfg.bit_depth, cfg.pb, cfg.mb, cfg.kb, impl="xla",
    )


def _assert_matches_oracle(cfg, pkts):
    w = _walk_xla(cfg, pkts)
    f = {name: np.asarray(getattr(w, name)) for name in w._fields if name != "res"}
    for b, pkt in enumerate(pkts):
        chans, ns = _oracle_headers(cfg, pkt)
        assert f["err"][b] == 0, (b, f["err"][b])
        assert f["ns"][b] == ns, b
        for c, (mode, den, order, coefs, bs, esc, mixbits, mixres) in enumerate(chans):
            got = tuple(
                int(f[k][b, c])
                for k in ("mode", "den", "order", "bs", "esc", "mixbits", "mixres")
            )
            assert got == (mode, den, order, bs, esc, mixbits, mixres), (b, c, got)
            assert f["coefs"][b, c, :order].tolist() == coefs, (b, c)
            assert not f["coefs"][b, c, order:].any(), (b, c)


@pytest.mark.parametrize(
    "depth,channels",
    [(16, 1), (16, 2), (24, 2), (20, 3), (32, 2), (16, 6)],
)
def test_parse_metadata_matches_xla(depth, channels):
    cfg = make_config(depth=depth, channels=channels, frame_length=256)
    pcm = music_pcm(256 * 2 + 57, channels, depth, seed=depth + channels)
    pkts = encode_packets(cfg, EncoderSpec(), pcm)  # includes partial final
    _assert_matches_oracle(cfg, pkts)


def test_parse_metadata_escape_and_noise():
    # Near-white noise drives escape codewords and (at low depths) whole
    # escape elements; shifted 24-bit packets carry the shift width.
    cfg = make_config(depth=16, channels=2, frame_length=256)
    pcm = music_pcm(256 * 3, 2, 16, seed=3, tonality=0.02)
    pkts = encode_packets(cfg, EncoderSpec(), pcm)
    pkts += encode_packets(cfg, EncoderSpec(escape=True), pcm[:256])
    _assert_matches_oracle(cfg, pkts)
    cfg24 = make_config(depth=24, channels=2, frame_length=256)
    pcm24 = music_pcm(256 * 2, 2, 24, seed=4)
    _assert_matches_oracle(cfg24, encode_packets(cfg24, EncoderSpec(bytes_shifted=1), pcm24))


def test_parse_metadata_corrupt_packets():
    # Truncated/corrupted packets: every lane the oracle rejects carries an
    # error code on device, and every lane the device accepts decodes to
    # the oracle's PCM.
    from saprobe_alac_tpu.errors import AlacError
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder

    cfg = make_config(depth=16, channels=2, frame_length=256)
    pcm = music_pcm(256 * 4, 2, 16, seed=5)
    pkts = [bytearray(p) for p in encode_packets(cfg, EncoderSpec(), pcm)]
    rng = np.random.default_rng(7)
    pkts[0] = pkts[0][: max(2, len(pkts[0]) // 4)]  # truncation
    for i in range(0, min(len(pkts[1]), 40), 3):  # header/coef bit flips
        pkts[1][i] ^= 1 << int(rng.integers(0, 8))
    pkts[2] = bytearray(b"\xff" * len(pkts[2]))  # all-ones garbage
    pkts = [bytes(p) for p in pkts]
    dec = JaxBatchDecoder(cfg, impl="xla")
    packed, err, ns = (np.asarray(x) for x in dec.decode_async(pkts))
    for b, pkt in enumerate(pkts):
        try:
            want = oracle(cfg, pkt)[0]
        except (AlacError, EOFError, IndexError):
            assert err[b] != 0, b
            continue
        if err[b] == 0:
            assert dec._to_bytes(packed[b], int(ns[b])) == want, b
