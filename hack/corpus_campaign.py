#!/usr/bin/env python
"""Mass corpus campaign through the streaming service (bounded RAM).

The analogue of the reference's mass-conformance run (8,409 real files, zero
discrepancies — /root/reference/docs/QA.md:246-249): real files are
unavailable in this image (zero egress, no ffmpeg), so the corpus is
synthetic — several hundred files of music-like PCM across depths, channel
counts, durations and both containers, plus (--hour) an hour-scale file —
but the *system under test* is the production path at production scale:
``iter_decode_corpus`` windowed cross-file batching, per-file verification
against the encoder's source PCM (sha256, computed before decode so expected
PCM never accumulates in RAM), peak-RSS tracking to pin the bounded-memory
claim.

Run (host path; ~minutes):
    python hack/corpus_campaign.py --files 300 --hour --backend native
Device path:
    python hack/corpus_campaign.py --files 40 --backend jax

Writes chiprun_out/corpus_campaign.json.
"""
import argparse
import hashlib
import json
import os
import resource
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
ART = ROOT / "chiprun_out" / "corpus_campaign.json"


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", type=int, default=300)
    ap.add_argument("--hour", action="store_true", help="include a 1-hour file")
    ap.add_argument("--backend", default="native", choices=["native", "jax", "scalar"])
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--dir", default=str(ROOT / ".scratch" / "corpus"))
    args = ap.parse_args()

    if args.backend == "native":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")  # the host path needs no device

    from saprobe_alac_tpu.caf import build_caf
    from saprobe_alac_tpu.encoder import EncoderSpec, build_m4a, encode_packets
    from saprobe_alac_tpu.encoder.synth import expected_pcm_bytes, make_config, music_pcm
    from saprobe_alac_tpu.service import iter_decode_corpus

    root = Path(args.dir)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)

    # ---- corpus generation (idempotent: existing files are reused) ----
    manifest_path = root / "manifest.json"
    manifest = {}
    if manifest_path.exists():
        manifest = json.loads(manifest_path.read_text())

    t0 = time.time()
    specs = []
    for i in range(args.files):
        depth = (16, 16, 16, 24)[i % 4]  # weight toward the common case
        ch = (2, 2, 1, 2, 2, 6)[i % 6]
        dur = float(rng.uniform(3.0, 45.0))
        container = "caf" if i % 11 == 3 else "m4a"
        specs.append((f"f{i:04d}.{container}", depth, ch, dur, i))
    if args.hour:
        specs.append(("hour.m4a", 16, 2, 3600.0, 99991))

    n_generated = 0
    for name, depth, ch, dur, seed in specs:
        path = root / name
        if manifest.get(name) and path.exists():
            continue
        cfg = make_config(depth=depth, channels=ch)
        F = cfg.frame_length
        if dur > 120.0:
            # Hour-scale file without hour-scale encode time: encode a 60 s
            # block once and tile its packets in the sample table; expected
            # PCM = the tiled block (packets are self-contained, so a
            # repeated packet decodes identically at every position).
            block_s = 60.0
            reps = int(dur / block_s)
            n = int(44100 * block_s) // F * F  # whole packets only
            pcm = music_pcm(n, ch, depth, seed=seed)
            pkts = encode_packets(cfg, EncoderSpec(), pcm) * reps
            spp = [F] * len(pkts)
            h = hashlib.sha256()
            block = expected_pcm_bytes(pcm, depth)
            for _ in range(reps):
                h.update(block)
            total = n * reps
        else:
            n = int(44100 * dur)
            pcm = music_pcm(n, ch, depth, seed=seed)
            pkts = encode_packets(cfg, EncoderSpec(), pcm)
            spp = [min(F, n - k * F) for k in range(len(pkts))]
            h = hashlib.sha256(expected_pcm_bytes(pcm, depth))
            total = n
        blob = (build_caf if name.endswith(".caf") else build_m4a)(cfg, pkts, spp)
        path.write_bytes(blob)
        manifest[name] = {"sha256": h.hexdigest(), "samples": total,
                          "depth": depth, "ch": ch}
        n_generated += 1
        if n_generated % 50 == 0:
            manifest_path.write_text(json.dumps(manifest))
            print(f"generated {n_generated} files...", flush=True)
    manifest_path.write_text(json.dumps(manifest))
    gen_s = time.time() - t0
    gen_rss = rss_mb()
    print(f"corpus: {len(specs)} files, generated {n_generated} new in {gen_s:.0f}s "
          f"(RSS {gen_rss:.0f} MB)", flush=True)

    # ---- the campaign: stream-decode + verify ----
    paths = [root / name for name, *_ in specs]
    audio_samples = 0
    fails = []
    t0 = time.time()
    ndone = 0
    for res in iter_decode_corpus(paths, backend=args.backend,
                                  batch_size=args.batch_size):
        name = Path(res.source).name
        want = manifest[name]
        got = hashlib.sha256(res.pcm).hexdigest()
        n = len(res.pcm) // (res.format.channels *
                             {16: 2, 20: 3, 24: 3, 32: 4}[res.format.bit_depth])
        if got != want["sha256"] or n != want["samples"]:
            fails.append(name)
            print(f"FAIL {name}", flush=True)
        audio_samples += n
        ndone += 1
        if ndone % 50 == 0:
            print(f"decoded {ndone}/{len(paths)} (RSS {rss_mb():.0f} MB)", flush=True)
    wall = time.time() - t0
    audio_s = audio_samples / 44100.0

    out = {
        "backend": args.backend,
        "files": len(paths),
        "failures": fails,
        "audio_seconds": round(audio_s, 1),
        "wall_seconds": round(wall, 1),
        "x_realtime": round(audio_s / wall, 1),
        "batch_size": args.batch_size,
        "peak_rss_mb": round(rss_mb(), 1),
        "gen_rss_mb": round(gen_rss, 1),
        "hour_file": bool(args.hour),
    }
    ART.parent.mkdir(exist_ok=True)
    ART.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
