#!/usr/bin/env python
"""Full-matrix differential sweep: JAX batch pipeline vs scalar oracle.

Slow (one XLA compile per distinct config, ~15s each on CPU).  Run manually:
    JAX_PLATFORMS=cpu python hack/sweep_jax.py
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from saprobe_alac_tpu.codec import decode_packet as oracle
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.encoder.encode import ChannelSpec
from saprobe_alac_tpu.encoder.synth import make_config, music_pcm
from saprobe_alac_tpu.ops.batch import JaxBatchDecoder


def main() -> int:
    decs = {}
    fails = total = 0
    t0 = time.time()

    def run(depth, ch, spec, name, pcm=None):
        nonlocal fails, total
        cfg = make_config(depth=depth, channels=ch, frame_length=160)
        if pcm is None:
            pcm = music_pcm(480, ch, depth, seed=depth * 10 + ch)
        key = (depth, ch)
        if key not in decs:
            decs[key] = JaxBatchDecoder(cfg)
        pkts = encode_packets(cfg, spec, pcm)
        got = decs[key].decode_packets(pkts)
        want = [oracle(cfg, p)[0] for p in pkts]
        total += 1
        if got != want:
            fails += 1
            print(f"FAIL {name} d{depth} c{ch}", flush=True)

    for depth in (16, 20, 24, 32):
        for ch in (1, 2, 3, 4, 5, 6, 7, 8):
            run(depth, ch, EncoderSpec(), "std")
    specs = [
        (EncoderSpec(mix_res=0), "mix0"),
        (EncoderSpec(escape=True), "esc"),
        (EncoderSpec(bytes_shifted=1), "bs1"),
        (EncoderSpec(bytes_shifted=2), "bs2"),
        (EncoderSpec(channel=ChannelSpec(order=0)), "o0"),
        (EncoderSpec(channel=ChannelSpec(order=31)), "o31"),
        (EncoderSpec(channel=ChannelSpec(order=12, mode=1)), "o12m1"),
        (EncoderSpec(channel=ChannelSpec(order=30)), "o30"),
        (EncoderSpec(mix_res=-3, mix_bits=2), "mixneg"),
    ]
    for spec, name in specs:
        for depth in (16, 24, 32):
            run(depth, 2, spec, name)
    run(16, 2, EncoderSpec(), "partial", music_pcm(480 - 37, 2, 16, seed=5))
    run(16, 2, EncoderSpec(), "silence", np.zeros((480, 2), dtype=np.int64))
    run(16, 2, EncoderSpec(), "noise", music_pcm(480, 2, 16, seed=6, tonality=0.0))
    print(f"{'PASS' if fails == 0 else 'FAIL'}: {fails}/{total} failures in {time.time()-t0:.0f}s")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
