#!/usr/bin/env python
"""Dump the optimized HLO text of the bench-shaped fused decode batch.

Compiles the same _decode_batch the bench runs and writes
compiled.as_text() to a file, so trace op names (cond.N / fusion.N /
copy.N) can be attributed to source ops.

    python hack/hlo_dump.py [--batch 2048] [--out /tmp/decode_batch.hlo]
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--fixture", default="std", choices=["std", "noise", "hires"])
    ap.add_argument("--out", default="/tmp/decode_batch.hlo")
    args = ap.parse_args()

    import jax.numpy as jnp

    import bench
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder, _decode_batch
    from saprobe_alac_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    kwargs = {"std": {}, "noise": {"tonality": 0.0},
              "hires": {"depth": 24, "rate": 96000, "bytes_shifted": 1}}[args.fixture]
    cfg, batch, _ = bench.fixture(n=args.batch, **kwargs)
    dec = JaxBatchDecoder(cfg)
    words, sizes, swapped = dec._stage(batch)
    jw, js = jnp.asarray(words), jnp.asarray(sizes)

    lowered = _decode_batch.lower(
        jw, js, cfg.frame_length, cfg.num_channels, cfg.bit_depth,
        cfg.pb, cfg.mb, cfg.kb, dec.impl, pre_swapped=swapped,
    )
    compiled = lowered.compile()
    text = compiled.as_text()
    Path(args.out).write_text(text)
    print(f"{len(text)} chars -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
