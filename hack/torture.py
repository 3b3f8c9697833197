#!/usr/bin/env python
"""Randomized encode<->decode torture sweep.

Each iteration draws a random configuration (depth, channels, frame length,
entropy tuning, encoder spec) and random content (tonal mixes, noise,
silence runs, square waves, DC, full-scale), encodes with a random backend,
and decodes with the oracle, the native core, and (optionally) the device
pipeline — all must be bit-exact.

    python hack/torture.py [--iters 200] [--jax-every 20] [--seed 0]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def random_pcm(rng, n, ch, depth):
    import numpy as np

    scale = (1 << (depth - 1)) - 1
    kind = rng.integers(0, 6)
    t = np.arange(n)[:, None] + np.zeros((1, ch))
    if kind == 0:  # tonal mix
        sig = sum(
            rng.uniform(0.05, 0.4) * np.sin(2 * np.pi * t / rng.uniform(5, 500) + rng.uniform(0, 6))
            for _ in range(int(rng.integers(1, 5)))
        )
    elif kind == 1:  # noise at random level
        sig = rng.standard_normal((n, ch)) * rng.uniform(0.001, 1.0)
    elif kind == 2:  # silence with sparse spikes
        sig = np.zeros((n, ch))
        for _ in range(int(rng.integers(0, 8))):
            sig[rng.integers(0, n), rng.integers(0, ch)] = rng.uniform(-1, 1)
    elif kind == 3:  # square wave
        sig = np.sign(np.sin(2 * np.pi * t / rng.uniform(2, 64)))
    elif kind == 4:  # DC / ramps
        sig = np.linspace(rng.uniform(-1, 1), rng.uniform(-1, 1), n)[:, None] + np.zeros((1, ch))
    else:  # full-scale alternation
        sig = np.where(t % 2 == 0, 1.0, -1.0)
    out = np.clip(sig * scale, -scale - 1, scale).astype(np.int64)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--jax-every", type=int, default=20, help="device-decode every Nth case (compile cost)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from saprobe_alac_tpu import native
    from saprobe_alac_tpu.codec import decode_packet as oracle
    from saprobe_alac_tpu.codec.matrixing import pack_pcm
    from saprobe_alac_tpu.config import PacketConfig
    from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
    from saprobe_alac_tpu.encoder.encode import ChannelSpec
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder

    rng = np.random.default_rng(args.seed)
    jax_decoders = {}
    fails = 0

    for it in range(args.iters):
        depth = int(rng.choice([16, 20, 24, 32]))
        ch = int(rng.integers(1, 9))
        frame = int(rng.choice([64, 160, 256, 1024]))
        cfg = PacketConfig(
            frame_length=frame,
            bit_depth=depth,
            num_channels=ch,
            pb=int(rng.choice([40, 32, 64, 255])),
            mb=int(rng.choice([10, 5, 40])),
            kb=int(rng.choice([14, 10, 5])),
            max_run=255,
            max_frame_bytes=0,
            avg_bit_rate=0,
            sample_rate=int(rng.choice([8000, 44100, 192000])),
        )
        spec = EncoderSpec(
            channel=ChannelSpec(
                order=int(rng.choice([0, 1, 4, 8, 12, 30, 31])),
                den_shift=int(rng.integers(0, 16)),
                pb_factor=int(rng.integers(0, 8)),
                mode=int(rng.choice([0, 1])),
                fit=bool(rng.integers(0, 2)),
            ),
            mix_bits=int(rng.integers(1, 8)),
            mix_res=int(rng.integers(-128, 128)),
            bytes_shifted=int(rng.choice([0, 1, 2])),
            escape=bool(rng.integers(0, 6) == 0),
            auto_escape=bool(rng.integers(0, 2)),
        )
        n = int(rng.integers(1, frame * 2 + 1))
        pcm = random_pcm(rng, n, ch, depth)

        roll = int(rng.integers(0, 8))
        if roll < 3 and native.available():
            backend = "auto"
        elif roll == 3 and args.jax_every and spec.channel.mode == 0 and not spec.escape and it % max(args.jax_every // 4, 1) == 0:
            backend = "device"  # lane-parallel device encoder
        else:
            backend = "python"
        try:
            pkts = encode_packets(cfg, spec, pcm, backend=backend)
        except Exception as exc:  # encoder must never fail on valid PCM
            print(f"[{it}] ENCODE FAIL {type(exc).__name__}: {exc} cfg={cfg} spec={spec}")
            fails += 1
            continue

        want = b"".join(pack_pcm(pcm[i * frame : (i + 1) * frame] << (4 if depth == 20 else 0), depth)
                        for i in range(len(pkts)))
        got_oracle = b"".join(oracle(cfg, p)[0] for p in pkts)
        if got_oracle != want:
            print(f"[{it}] ORACLE MISMATCH cfg={cfg} spec={spec} n={n}")
            fails += 1
            continue
        if native.available():
            got_native = b"".join(native.decode_packet(cfg, p) for p in pkts)
            if got_native != want:
                print(f"[{it}] NATIVE MISMATCH cfg={cfg} spec={spec} n={n}")
                fails += 1
        if args.jax_every and it % args.jax_every == 0:
            key = (depth, ch, frame, cfg.pb, cfg.mb, cfg.kb)
            if key not in jax_decoders:
                jax_decoders[key] = JaxBatchDecoder(cfg)
            if not jax_decoders[key]._scalar_only:
                got_jax = b"".join(jax_decoders[key].decode_packets(pkts))
                if got_jax != want:
                    print(f"[{it}] JAX MISMATCH cfg={cfg} spec={spec} n={n}")
                    fails += 1
        if (it + 1) % 50 == 0:
            print(f"{it+1}/{args.iters} cases, {fails} failures", flush=True)

    print(f"{'PASS' if fails == 0 else 'FAIL'}: {fails}/{args.iters}")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
