#!/usr/bin/env python
"""Benchmark: ALAC decode throughput on one CUDA GPU.

    python bench.py          # table on stderr, one JSON line on stdout

Headline configuration (BASELINE.json configs 1 and 5): 44.1 kHz/16-bit
stereo, frame length 4096, music-like content, BENCH_BATCH (default 2048)
distinct packets per batch, the whole entropy -> predict -> unmix -> pack
pipeline on the device.

Rows, each a realtime factor (audio seconds over wall seconds):
  - value / device compute (PRIMARY): packets pre-staged on the device, PCM
    left there; dispatches queued back to back, one sync at the end;
  - device-resident: packets packed and uploaded per batch, PCM consumed on
    the device (only a checksum comes back);
  - end to end: packets in host memory to PCM bytes in host memory through
    ``JaxBatchDecoder.decode_packets``, batches pipelined;
  - noise (every channel an escape element) and hi-res (96k/24, bytes
    shifted) device compute;
  - warm B=32 latency through the public path;
  - device encode and host (C++) encode.

vs_baseline divides the headline by 2630x, the reference's strongest
comparable number (44.1k/16 300 s synthetic, single core; BASELINE.md).
Correctness is checked bit for bit against the encoded source before
timing.  Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

RATE = 44100
FRAME = 4096
BATCH = int(os.environ.get("BENCH_BATCH", "2048"))
ITERS = int(os.environ.get("BENCH_ITERS", "8"))
DEPTH = int(os.environ.get("BENCH_PIPELINE_DEPTH", "3"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fixture(depth=16, rate=RATE, tonality=0.98, bytes_shifted=0, seed=42, n=BATCH):
    """n distinct packets of seeded stereo PCM, encoded on the host."""
    from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
    from saprobe_alac_tpu.encoder.synth import make_config, music_pcm

    cfg = make_config(depth=depth, frame_length=FRAME, sample_rate=rate)
    pcm = music_pcm(FRAME * n, 2, depth, seed=seed, tonality=tonality)
    return cfg, encode_packets(cfg, EncoderSpec(bytes_shifted=bytes_shifted), pcm), pcm


def check(dec, cfg, packets, pcm, name: str) -> None:
    from saprobe_alac_tpu.encoder.synth import expected_pcm_bytes

    got = b"".join(dec.decode_packets(packets))
    if got != expected_pcm_bytes(pcm[: FRAME * len(packets)], cfg.bit_depth):
        raise SystemExit(f"bench: {name} decode is not bit-exact")
    log(f"{name} bit-exactness: OK")


def device_compute_s(dec, packets) -> float:
    """Per-batch seconds with the packets already on the device: four
    row-rotated variants, ITERS*2 dispatches queued, one sync; median of 3."""
    import jax

    from saprobe_alac_tpu.ops.batch import _decode_batch

    cfg = dec.config
    words, sizes, swapped = dec._stage(packets)
    variants = [
        (jax.device_put(np.roll(words, v, axis=0)), jax.device_put(np.roll(sizes, v)))
        for v in range(4)
    ]

    def run(w, s):
        return _decode_batch(
            w, s, cfg.frame_length, cfg.num_channels, cfg.bit_depth, cfg.pb,
            cfg.mb, cfg.kb, dec.impl, pre_swapped=swapped,
        )[0]

    jax.block_until_ready(run(*variants[0]))
    n = 2 * ITERS
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [run(*variants[i % 4]) for i in range(n)]
        jax.block_until_ready(outs)
        reps.append((time.perf_counter() - t0) / n)
    return statistics.median(reps)


def pipelined_s(dispatch, consume, iters=ITERS, depth=DEPTH, warm=2) -> float:
    """Median steady-state per-batch seconds with ``depth`` batches in flight
    (pack + upload + launch on a worker thread, consume on this one)."""
    from concurrent.futures import ThreadPoolExecutor

    stamps = []
    with ThreadPoolExecutor(1) as ex:
        inflight = []
        for i in range(iters + warm):
            inflight.append(ex.submit(dispatch, i))
            if len(inflight) >= depth:
                consume(inflight.pop(0).result())
                stamps.append(time.perf_counter())
        while inflight:
            consume(inflight.pop(0).result())
            stamps.append(time.perf_counter())
    diffs = [b - a for a, b in zip(stamps, stamps[1:])][warm - 1 :]
    return statistics.median(diffs)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        )
    except OSError:
        return "unknown"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "unknown"


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench: no GPU (JAX runs on {dev.platform})")
        return 1

    from saprobe_alac_tpu import native
    from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
    from saprobe_alac_tpu.encoder.synth import expected_pcm_bytes
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder
    from saprobe_alac_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card_name = card()
    log(f"device: {dev.device_kind} x{len(jax.devices())}; card {card_name}")
    audio_s = BATCH * FRAME / RATE

    cfg, packets, pcm = fixture()
    log(f"fixture: {len(packets)} packets, {audio_s:.1f} s audio, "
        f"ratio {sum(map(len, packets)) / (pcm.size * 2):.3f}")
    dec = JaxBatchDecoder(cfg)
    t0 = time.perf_counter()
    check(dec, cfg, packets, pcm, "music")
    log(f"compile + first batch: {time.perf_counter() - t0:.1f} s")

    per_dc = device_compute_s(dec, packets)
    log(f"device compute: {per_dc * 1e3:.2f} ms/batch -> {audio_s / per_dc:.0f}x realtime")

    rot = [packets[v:] + packets[:v] for v in range(3)]
    csum = jax.jit(lambda p: jnp.sum(p.astype(jnp.int32)))
    per_dr = pipelined_s(lambda i: csum(dec.decode_async(rot[i % 3])[0]), np.asarray)
    log(f"device-resident: {per_dr * 1e3:.2f} ms/batch -> {audio_s / per_dr:.0f}x realtime")

    per_e2e = pipelined_s(
        lambda i: (dec.decode_async(rot[i % 3]), rot[i % 3]),
        lambda h: dec.finish_async(*h),
    )
    log(f"end to end: {per_e2e * 1e3:.2f} ms/batch -> {audio_s / per_e2e:.0f}x realtime")

    ncfg, npk, npcm = fixture(tonality=0.0, seed=7)
    ndec = JaxBatchDecoder(ncfg)
    check(ndec, ncfg, npk, npcm, "noise")
    per_noise = device_compute_s(ndec, npk)
    log(f"noise device compute: {per_noise * 1e3:.2f} ms/batch -> "
        f"{audio_s / per_noise:.0f}x realtime")

    hcfg, hpk, hpcm = fixture(depth=24, rate=96000, bytes_shifted=1, seed=11)
    hdec = JaxBatchDecoder(hcfg)
    check(hdec, hcfg, hpk, hpcm, "hires")
    per_hires = device_compute_s(hdec, hpk)
    hires_audio_s = BATCH * FRAME / 96000
    log(f"hires device compute: {per_hires * 1e3:.2f} ms/batch -> "
        f"{hires_audio_s / per_hires:.0f}x realtime (reference single core: 867x)")

    small = packets[:32]
    dec.decode_packets(small)
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        dec.decode_packets(small)
        lat.append(time.perf_counter() - t0)
    lat_b32 = statistics.median(lat)
    log(f"warm B=32 decode: {lat_b32 * 1e3:.2f} ms")

    # Encode: up to 256 packets through the public encoder, device and host (C++).
    n_enc = min(256, BATCH)
    enc_pcm = pcm[: FRAME * n_enc]
    enc_audio_s = n_enc * FRAME / RATE
    want = expected_pcm_bytes(enc_pcm, 16)
    x_enc = {}
    for backend in ("device", "native"):
        if backend == "native" and not native.available():
            continue
        pk = encode_packets(cfg, EncoderSpec(), enc_pcm, backend=backend)
        if b"".join(dec.decode_packets(pk)) != want:
            raise SystemExit(f"bench: {backend} encode does not round-trip")
        t0 = time.perf_counter()
        encode_packets(cfg, EncoderSpec(), enc_pcm, backend=backend)
        x_enc[backend] = enc_audio_s / (time.perf_counter() - t0)
        log(f"{backend} encode: {x_enc[backend]:.0f}x realtime")

    result = {
        "metric": "decode_x_realtime_44k16_stereo_device",
        "value": round(audio_s / per_dc, 1),
        "unit": "x_realtime",
        "vs_baseline": round(audio_s / per_dc / 2630.0, 3),
        "device_ms": round(per_dc * 1e3, 3),
        "device_resident_x_realtime": round(audio_s / per_dr, 1),
        "e2e_x_realtime": round(audio_s / per_e2e, 1),
        "e2e_ms": round(per_e2e * 1e3, 3),
        "noise_device_x_realtime": round(audio_s / per_noise, 1),
        "hires_device_x_realtime": round(hires_audio_s / per_hires, 1),
        "latency_warm_b32_ms": round(lat_b32 * 1e3, 2),
        "encode_device_x_realtime": round(x_enc.get("device", 0.0), 1),
        "encode_host_x_realtime": round(x_enc.get("native", 0.0), 1),
        "batch": BATCH,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_name,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
