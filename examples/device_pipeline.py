#!/usr/bin/env python
"""End-to-end device-resident pipeline: ALAC packets -> PCM -> spectral features.

Demonstrates the framework's native consumption model: compressed packets
cross the host<->device link once; decode, float conversion and feature
extraction all run on the device, and only the (much smaller) features return.

    python examples/device_pipeline.py [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from saprobe_alac_tpu.config import PacketConfig
    from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
    from saprobe_alac_tpu.ops.audio import log_spectrogram, pcm_to_float
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder
    from saprobe_alac_tpu.ops.walk import ERR_NONE

    rate, depth, F = 44100, 16, 4096
    cfg = PacketConfig(frame_length=F, bit_depth=depth, num_channels=2, pb=40,
                       mb=10, kb=14, max_run=255, max_frame_bytes=0,
                       avg_bit_rate=0, sample_rate=rate)
    t = np.arange(F * args.batch)
    pcm = np.stack([(12000 * np.sin(2 * np.pi * t / 90)).astype(np.int64),
                    (12000 * np.sin(2 * np.pi * t / 131)).astype(np.int64)], axis=1)
    packets = encode_packets(cfg, EncoderSpec(), pcm)
    print(f"{len(packets)} packets, {sum(map(len, packets))/1e6:.2f} MB compressed")

    dec = JaxBatchDecoder(cfg)

    @jax.jit
    def features_from(packed):
        # packed: (B, F*C) int16 -> (B, F) mono float -> log-spectrogram
        samples = packed.reshape(packed.shape[0], F, 2).astype(jnp.int32)
        mono = pcm_to_float(samples, depth).mean(axis=-1)
        return log_spectrogram(mono)

    # Warm.
    h = dec.decode_async(packets)
    feats = features_from(h[0])
    np.asarray(feats)

    t0 = time.perf_counter()
    h = dec.decode_async(packets)
    assert (np.asarray(h[1])[: len(packets)] == ERR_NONE).all()
    feats = np.asarray(features_from(h[0]))
    dt = time.perf_counter() - t0
    audio_s = len(packets) * F / rate
    print(f"decode+features: {dt*1e3:.1f} ms for {audio_s:.1f}s audio "
          f"({audio_s/dt:.0f}x realtime), features {feats.shape} "
          f"({feats.nbytes/1e6:.2f} MB back to host)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
