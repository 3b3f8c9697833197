"""Differential tests for the GPU entropy-walk kernel (ops/walk_kernel.py).

Runs the kernel in the Pallas interpreter on CPU (``impl="interpret"``)
against the scalar oracle, covering the regimes that stress it: zero-runs,
escape codewords (the widest per-step bit budget), partial frames,
multichannel layouts, escape and shifted elements beside Golomb lanes, and
corrupt-packet error lanes.  The kernel compiled for the card is checked by
``chip_smoke.py``.

Parity: golomb.go:112-253, bitbuffer.go:28-32.
"""

import numpy as np
import pytest

from conftest import make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets


@pytest.fixture(scope="module")
def dense_interpret():
    """The decoder path for this module: both kernels, interpreted."""
    return "interpret"


def _roundtrip(cfg, pcm, corrupt=None):
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder

    pkts = encode_packets(cfg, EncoderSpec(), pcm)
    if corrupt is not None:
        pkts = list(pkts)
        pkts[corrupt] = pkts[corrupt][: max(2, len(pkts[corrupt]) // 3)]
    dec = JaxBatchDecoder(cfg, impl="interpret")
    got = dec.decode_packets(pkts)
    want = [oracle(cfg, p)[0] for p in pkts]
    assert got == want


def test_dense_music(dense_interpret):
    _roundtrip(make_config(frame_length=128), music_pcm(128 * 8 - 5, 2, 16, seed=3))


def test_dense_zero_runs(dense_interpret):
    pcm = np.zeros((128 * 4, 2), np.int64)
    pcm[37, 0] = 9
    pcm[300, 1] = -5
    _roundtrip(make_config(frame_length=128), pcm)


def test_dense_noise_escape(dense_interpret):
    rng = np.random.default_rng(1)
    pcm = rng.integers(-30000, 30000, (128 * 3, 2)).astype(np.int64)
    _roundtrip(make_config(frame_length=128), pcm)


@pytest.mark.parametrize(
    "depth,channels",
    [(24, 2), (16, 1), (16, 6)],
    ids=["24bit", "mono", "5.1"],
)
def test_dense_config_matrix(dense_interpret, depth, channels):
    F = 64 if channels > 2 else 128
    cfg = make_config(depth=depth, channels=channels, frame_length=F)
    _roundtrip(cfg, music_pcm(F * 2, channels, depth, seed=depth + channels))


def test_dense_partial_final_packet(dense_interpret):
    _roundtrip(make_config(frame_length=128), music_pcm(128 * 2 + 31, 2, 16, seed=7))


def test_dense_quiet_mixed_runs(dense_interpret):
    pcm = (music_pcm(128 * 4, 2, 16, seed=8) * 0.002).astype(np.int64)
    _roundtrip(make_config(frame_length=128), pcm)


def _roundtrip_spec(cfg, pcm, spec):
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder

    pkts = encode_packets(cfg, spec, pcm)
    got = JaxBatchDecoder(cfg, impl="interpret").decode_packets(pkts)
    want = [oracle(cfg, p)[0] for p in pkts]
    assert got == want


@pytest.mark.parametrize(
    "depth,channels",
    [(16, 1), (16, 2), (24, 2), (32, 2), (20, 1), (16, 6), (24, 1), (32, 1)],
    ids=["sce16", "cpe16", "cpe24", "cpe32", "sce20", "5.1", "sce24", "sce32"],
)
def test_dense_forced_escape(dense_interpret, depth, channels):
    """Forced escape elements across depths/layouts (decoder.go:326-345,
    507-535): the kernel skips them and the XLA gather extracts the raw
    samples, incl. the CPE 32-bit case (64 bits per sample pair)."""
    F = 64 if channels > 2 else 128
    cfg = make_config(depth=depth, channels=channels, frame_length=F)
    _roundtrip_spec(
        cfg,
        music_pcm(F * 3, channels, depth, seed=50 + depth + channels),
        EncoderSpec(escape=True),
    )


@pytest.mark.parametrize(
    "depth,channels,bsf",
    [(24, 2, 1), (32, 2, 2), (24, 1, 1), (32, 1, 1)],
    ids=["cpe24bs1", "cpe32bs2", "sce24bs1", "sce32bs1"],
)
def test_dense_shift_raw_reader(dense_interpret, depth, channels, bsf):
    """Shifted elements (decoder.go:314-321, 492-502): the kernel's cursor
    starts past the shift region and the XLA gather reads it back —
    incl. a partial final frame."""
    cfg = make_config(depth=depth, channels=channels, frame_length=128)
    _roundtrip_spec(
        cfg,
        music_pcm(128 * 2 + 41, channels, depth, seed=70 + depth + bsf),
        EncoderSpec(bytes_shifted=bsf),
    )


def test_dense_escape_long_frame_rewind(dense_interpret):
    """F=1024 CPE escape: a long raw region, then the END tag read past
    it by the slot loop."""
    cfg = make_config(frame_length=1024)
    _roundtrip_spec(
        cfg, music_pcm(1024 * 2, 2, 16, seed=59), EncoderSpec(escape=True)
    )


def test_dense_escape_partial_frame(dense_interpret):
    cfg = make_config(frame_length=128)
    _roundtrip_spec(
        cfg, music_pcm(128 * 2 + 19, 2, 16, seed=57), EncoderSpec(escape=True)
    )


def test_dense_mixed_escape_compressed_batch(dense_interpret):
    """Escape and compressed lanes coexisting in one slot: escape lanes sit
    idle in the kernel while the Golomb lanes of the same block walk."""
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder

    cfg = make_config(frame_length=128)
    pcm = music_pcm(128 * 2, 2, 16, seed=58)
    pk_esc = encode_packets(cfg, EncoderSpec(escape=True), pcm)
    pk_cmp = encode_packets(cfg, EncoderSpec(), pcm)
    pkts = [p for pair in zip(pk_esc, pk_cmp) for p in pair]
    got = JaxBatchDecoder(cfg, impl="interpret").decode_packets(pkts)
    want = [oracle(cfg, p)[0] for p in pkts]
    assert got == want


def test_dense_corrupt_packet_errors(dense_interpret):
    from saprobe_alac_tpu.errors import DecodeError

    cfg = make_config(frame_length=128)
    with pytest.raises((DecodeError, EOFError, IndexError)):
        _roundtrip(cfg, music_pcm(128 * 4, 2, 16, seed=9), corrupt=2)


def test_impl_flip_retraces_same_shape():
    """The impl is a static jit argument: decoding a batch shape already
    compiled for the XLA path must retrace for the kernel path, so a
    differential check cannot pass off a cached executable that never
    routed through the kernel."""
    import jax

    import saprobe_alac_tpu.ops.walk_kernel as wk
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder

    cfg = make_config(frame_length=128)
    pcm = music_pcm(128 * 2, 2, 16, seed=11)
    pkts = encode_packets(cfg, EncoderSpec(), pcm)

    jax.clear_caches()
    fired = []
    orig = wk.entropy_channel_pallas

    def spy(*a, **k):
        fired.append(1)
        return orig(*a, **k)

    try:
        want = JaxBatchDecoder(cfg, impl="xla").decode_packets(pkts)  # caches the shape
        wk.entropy_channel_pallas = spy
        got = JaxBatchDecoder(cfg, impl="interpret").decode_packets(pkts)
    finally:
        wk.entropy_channel_pallas = orig
    assert fired, "kernel was not invoked for the kernel impl (stale jit cache)"
    assert got == want
