"""Differential tests for the GPU LPC kernel (ops/lpc_kernel.py).

Runs the kernel in the Pallas interpreter on CPU (``impl="interpret"``),
round-tripping real packets against the scalar oracle across orders (1 to
30), modes and depths.  The kernel compiled for
the card is checked by ``chip_smoke.py``.

Parity: predictor.go:99-682.
"""

import pytest

from conftest import make_config, music_pcm

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.encoder.encode import ChannelSpec


@pytest.fixture(scope="module")
def lpc_interpret():
    """The decoder path for this module: both kernels, interpreted."""
    return "interpret"


def _roundtrip(cfg, pcm, spec=None):
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder

    pkts = encode_packets(cfg, spec or EncoderSpec(), pcm)
    got = JaxBatchDecoder(cfg, impl="interpret").decode_packets(pkts)
    want = [oracle(cfg, p)[0] for p in pkts]
    assert got == want


@pytest.mark.parametrize("order", [1, 2, 4, 5, 8, 12, 30])
def test_lpc_kernel_orders(lpc_interpret, order):
    cfg = make_config(frame_length=128)
    spec = EncoderSpec(channel=ChannelSpec(order=order))
    _roundtrip(cfg, music_pcm(128 * 3, 2, 16, seed=order), spec)


def test_lpc_kernel_order31_delta(lpc_interpret):
    cfg = make_config(frame_length=128)
    spec = EncoderSpec(channel=ChannelSpec(order=31))
    _roundtrip(cfg, music_pcm(128 * 2, 2, 16, seed=40), spec)


def test_lpc_kernel_order0(lpc_interpret):
    cfg = make_config(frame_length=128)
    spec = EncoderSpec(channel=ChannelSpec(order=0))
    _roundtrip(cfg, music_pcm(128 * 2, 2, 16, seed=41), spec)


def test_lpc_kernel_mode_delta_prepass(lpc_interpret):
    cfg = make_config(frame_length=128)
    spec = EncoderSpec(channel=ChannelSpec(order=4, mode=1))
    _roundtrip(cfg, music_pcm(128 * 2, 2, 16, seed=42), spec)


def test_lpc_kernel_24bit_partial(lpc_interpret):
    cfg = make_config(depth=24, frame_length=128)
    _roundtrip(cfg, music_pcm(128 * 2 - 37, 2, 24, seed=43))


def test_lpc_impl_flip_retraces_same_shape():
    """Same retrace guarantee for the LPC kernel — see
    test_walk_kernel.test_impl_flip_retraces_same_shape."""
    import jax

    import saprobe_alac_tpu.ops.lpc_kernel as lk
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder

    cfg = make_config(frame_length=128)
    spec = EncoderSpec(channel=ChannelSpec(order=4))
    pkts = encode_packets(cfg, spec, music_pcm(128 * 2, 2, 16, seed=12))

    jax.clear_caches()
    fired = []
    orig = lk.lpc_fir_pallas

    def spy(*a, **k):
        fired.append(1)
        return orig(*a, **k)

    try:
        want = JaxBatchDecoder(cfg, impl="xla").decode_packets(pkts)
        lk.lpc_fir_pallas = spy
        got = JaxBatchDecoder(cfg, impl="interpret").decode_packets(pkts)
    finally:
        lk.lpc_fir_pallas = orig
    assert fired, "kernel was not invoked for the kernel impl (stale jit cache)"
    assert got == want
