#!/usr/bin/env python
"""Phase-level profiling of the device decode pipeline.

The device analogue of the reference's hack/bench.sh pprof harness.  Run:
    python hack/profile.py [--batch 256] [--trace /tmp/jax-trace]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--trace", help="also capture a jax.profiler trace to this dir")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from bench import fixture
    from saprobe_alac_tpu.utils.profiling import device_trace, profile_batch_decode

    cfg, batch, _ = fixture(n=args.batch)

    # (profile_batch_decode runs its own untimed warm iteration.)
    if args.trace:
        with device_trace(args.trace):
            timer = profile_batch_decode(cfg, batch, iters=args.iters)
        print(f"trace written to {args.trace}")
    else:
        timer = profile_batch_decode(cfg, batch, iters=args.iters)
    print(timer.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
