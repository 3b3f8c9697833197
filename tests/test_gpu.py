"""Card-only checks: the compiled GPU kernels against the plain XLA layers.

At the production shape (44.1 kHz/16-bit stereo, B=2048, F=4096) the
Triton walk must give the XLA walk's WalkResult field for field, and the
Triton LPC kernel the XLA scan's output, bit for bit.  Skipped without a
GPU; run with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
``chip_smoke.py`` runs the same comparison as its phase (k).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_config, music_pcm

from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.ops.batch import JaxBatchDecoder
from saprobe_alac_tpu.ops.epilogue import extract_escape
from saprobe_alac_tpu.ops.lpc import lpc_batch
from saprobe_alac_tpu.ops.walk import walk_batch

pytestmark = pytest.mark.gpu

F, B = 4096, 2048


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (the tests run on the CPU here)")


def _walk_args(tonality):
    cfg = make_config(frame_length=F)
    pkts = encode_packets(cfg, EncoderSpec(), music_pcm(F * B, 2, 16, seed=5, tonality=tonality))
    words, sizes, _ = JaxBatchDecoder(cfg)._stage(pkts)
    return (jnp.asarray(words), jnp.asarray(sizes), F, 2, 16, cfg.pb, cfg.mb, cfg.kb)


@pytest.mark.parametrize("tonality", [0.98, 0.0], ids=["music", "noise"])
def test_walk_kernel_matches_xla(gpu, tonality):
    args = _walk_args(tonality)
    got = walk_batch(*args, impl="kernel")
    want = walk_batch(*args, impl="xla")
    for name in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name
        )


@pytest.mark.parametrize("tonality", [0.98, 0.0], ids=["music", "noise"])
def test_lpc_kernel_matches_xla(gpu, tonality):
    args = _walk_args(tonality)
    words = args[0]
    w = walk_batch(*args, impl="xla")
    res = extract_escape(words, w.res, w.esc, w.esc_base, w.esc_cb, w.role, F, 2)
    L = words.shape[0] * 2
    largs = (
        res.reshape(F, L), w.order.T.reshape(L), w.mode.T.reshape(L),
        w.den.T.reshape(L), w.cb.T.reshape(L), jnp.tile(w.ns, 2),
        w.coefs.transpose(1, 0, 2).reshape(L, 32), F,
    )
    np.testing.assert_array_equal(
        np.asarray(lpc_batch(*largs, impl="kernel")), np.asarray(lpc_batch(*largs, impl="xla"))
    )
