#!/usr/bin/env python
"""Benchmark the five BASELINE.json configs on the device pipeline.

    python hack/bench_configs.py [--cpu] [--batch 256]

1. 44.1 kHz/16-bit stereo via Decoder.read (facade path)
2. 8 kHz mono via ParseMagicCookie + PacketDecoder.DecodePacket (low level)
3. 96 kHz/24-bit stereo with shift-buffer path + seek round-trips
4. 7.1 surround (8ch SCE+CPE layout) 48 kHz/24-bit
5. 10k-packet batched throughput, 192 kHz/32-bit, full device pipeline
"""
import argparse
import io
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import json
    import subprocess
    from pathlib import Path

    import jax
    import numpy as np

    from saprobe_alac_tpu import PacketDecoder, new_decoder, parse_magic_cookie
    from saprobe_alac_tpu.encoder import EncoderSpec, build_m4a, encode_packets
    from saprobe_alac_tpu.encoder.synth import expected_pcm_bytes, make_config, music_pcm
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder
    from saprobe_alac_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    results = []

    def report(name, audio_s, elapsed, ok):
        print(f"[{name}] {elapsed*1e3:8.1f} ms for {audio_s:6.1f}s audio "
              f"-> {audio_s/elapsed:8.0f}x realtime   bit-exact={ok}",
              flush=True)
        results.append({
            "config": name,
            "audio_s": round(audio_s, 2),
            "elapsed_ms": round(elapsed * 1e3, 1),
            "x_realtime": round(audio_s / elapsed, 1),
            "bit_exact": bool(ok),
        })

    # 1. 44.1/16 stereo facade
    cfg = make_config(depth=16, channels=2, frame_length=4096, sample_rate=44100)
    pcm = music_pcm(44100 * 8, 2, 16, seed=1)
    pkts = encode_packets(cfg, EncoderSpec(), pcm)
    spp = [min(4096, pcm.shape[0] - i * 4096) for i in range(len(pkts))]
    m4a = build_m4a(cfg, pkts, spp)
    dec = new_decoder(io.BytesIO(m4a), backend="jax", batch_size=32)
    dec.read()  # warm compile
    dec = new_decoder(io.BytesIO(m4a), backend="jax", batch_size=32)
    t0 = time.perf_counter()
    out = dec.read()
    report("1:44k16 facade", pcm.shape[0] / 44100.0, time.perf_counter() - t0,
           out == expected_pcm_bytes(pcm, 16))

    # 2. 8 kHz mono low-level API
    cfg2 = make_config(depth=16, channels=1, frame_length=4096, sample_rate=8000)
    cookie = cfg2.to_cookie()
    cfg2b = parse_magic_cookie(cookie)
    pcm2 = music_pcm(8000, 1, 16, seed=2)
    pkts2 = encode_packets(cfg2b, EncoderSpec(), pcm2)
    pd = PacketDecoder(cfg2b)
    t0 = time.perf_counter()
    got = b"".join(pd.decode_packet(p) for p in pkts2)
    report("2:8k mono lowlvl", 1.0, time.perf_counter() - t0,
           got == expected_pcm_bytes(pcm2, 16))

    # 3. 96/24 shift path + seek
    cfg3 = make_config(depth=24, channels=2, frame_length=4096, sample_rate=96000)
    pcm3 = music_pcm(96000 * 4, 2, 24, seed=3)
    pkts3 = encode_packets(cfg3, EncoderSpec(bytes_shifted=1), pcm3)
    spp3 = [min(4096, pcm3.shape[0] - i * 4096) for i in range(len(pkts3))]
    m4a3 = build_m4a(cfg3, pkts3, spp3)
    dec = new_decoder(io.BytesIO(m4a3), backend="jax", batch_size=32)
    dec.read()
    dec = new_decoder(io.BytesIO(m4a3), backend="jax", batch_size=32)
    t0 = time.perf_counter()
    out3 = dec.read()
    dt3 = time.perf_counter() - t0  # timing covers the timed read only
    ok3 = out3 == expected_pcm_bytes(pcm3, 24)
    for frac in (0.25, 0.75):  # seek verification, untimed
        pos = dec.seek(frac * dec.duration())
        off = round(pos * 96000) * 6
        ok3 = ok3 and dec.read() == expected_pcm_bytes(pcm3, 24)[off:]
    report("3:96k24+seek", 4.0, dt3, ok3)

    # 4. 7.1 @ 48k/24
    cfg4 = make_config(depth=24, channels=8, frame_length=4096, sample_rate=48000)
    pcm4 = music_pcm(48000, 8, 24, seed=4)
    pkts4 = encode_packets(cfg4, EncoderSpec(), pcm4)
    d4 = JaxBatchDecoder(cfg4)
    d4.decode_packets(pkts4)  # warm the full bucketed shape
    t0 = time.perf_counter()
    out4 = b"".join(d4.decode_packets(pkts4))
    report("4:7.1 48k24", 1.0, time.perf_counter() - t0,
           out4 == expected_pcm_bytes(pcm4[: (len(pkts4) * 4096)], 24))

    # 5. 10k-packet batch, 192k/32 — e2e (tight-staged upload + download)
    # and device compute (pre-staged, the apples-to-apples number vs the
    # reference's in-RAM decode).
    cfg5 = make_config(depth=32, channels=2, frame_length=4096, sample_rate=192000)
    pcm5 = music_pcm(4096 * 8, 2, 32, seed=5)
    base5 = encode_packets(cfg5, EncoderSpec(bytes_shifted=2), pcm5)
    big = [base5[i % len(base5)] for i in range(10000)]
    d5 = JaxBatchDecoder(cfg5, tight=True)
    np.asarray(d5.decode_async(big)[0])  # warm the full 10k bucketed shape
    t0 = time.perf_counter()
    h = d5.decode_async(big)
    packed5 = np.asarray(h[0])
    dt = time.perf_counter() - t0
    audio5 = 10000 * 4096 / 192000
    ok5 = (np.asarray(h[1])[: len(big)] == 0).all()

    # Device-compute row: inputs pre-staged in HBM, checksum crosses.
    import jax.numpy as jnp

    flat5, offs5, sz5, Wb5 = d5._stage_tight(big)
    jflat, joffs, jsz = jnp.asarray(flat5), jnp.asarray(offs5), jnp.asarray(sz5)
    jax.block_until_ready([jflat, joffs, jsz])
    from saprobe_alac_tpu.ops.batch import _decode_batch_tight

    csum = jax.jit(lambda p: jnp.sum(p.astype(jnp.int32)))

    def dc5():
        return csum(_decode_batch_tight(
            jflat, joffs, jsz, Wb5, cfg5.frame_length, cfg5.num_channels,
            cfg5.bit_depth, cfg5.pb, cfg5.mb, cfg5.kb,
            d5.impl, pre_swapped=False)[0])

    np.asarray(dc5())  # warm
    t0 = time.perf_counter()
    last = None
    for _ in range(8):
        last = dc5()
    np.asarray(last)
    dt5c = (time.perf_counter() - t0) / 8
    report("5dc:10k 192k32 device", audio5, dt5c, bool(ok5))
    # Spot-check decoded output against the source on sampled lanes.
    want_rows = {i: expected_pcm_bytes(pcm5[(i % len(base5)) * 4096 : (i % len(base5) + 1) * 4096], 32)
                 for i in (0, 1, 4999, 9999)}
    ns5 = np.asarray(h[2])
    for i, want in want_rows.items():
        got = packed5[i, : ns5[i] * 2].astype("<i4").tobytes()
        ok5 = ok5 and got == want
    report("5:10k pkts 192k32", audio5, dt, bool(ok5))

    rev = subprocess.run(
        ["git", "rev-parse", "--short", "HEAD"],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ).stdout.strip()
    artifact = {
        "device": str(jax.devices()[0]),
        "git": rev,
        "results": results,
    }
    out_path = Path(__file__).resolve().parent.parent / "chiprun_out" / "bench_configs.json"
    out_path.parent.mkdir(exist_ok=True)
    out_path.write_text(json.dumps(artifact, indent=1) + "\n")
    print(f"wrote {out_path}", flush=True)
    return 0 if all(r["bit_exact"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
