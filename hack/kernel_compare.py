#!/usr/bin/env python
"""Time each GPU kernel against the plain XLA version of its layer.

    python hack/kernel_compare.py [--batch 2048] [--sweep] [--out FILE]
    python hack/kernel_compare.py --cpu --batch 64 --frame 256   # rehearsal

For music and for white noise at 44.1 kHz/16-bit stereo, B distinct
packets, it reports:

- per layer: device busy time of the walk (``walk_batch``) and of LPC
  (``lpc_batch``) from a jax.profiler trace, kernel against XLA, and checks
  that both give identical outputs;
- end to end: wall time of ``JaxBatchDecoder.decode_packets`` with each of the
  four walk x LPC combinations (kernel or XLA per layer), median and
  quartiles over interleaved rounds, and the device busy time of one
  decode, checking that all four decode identically;
- with ``--sweep``, the layer times over lanes per program x warps.

``--cpu`` runs the kernels in the Pallas interpreter at small shapes, to
check the script itself; its times mean nothing.  Prints one summary line per
measurement and writes everything as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--frame", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=12, help="interleaved e2e rounds")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="interpret mode on the CPU")
    ap.add_argument("--out", default="chiprun_out/kernel_compare.json")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    import jax.numpy as jnp
    import numpy as np

    from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
    from saprobe_alac_tpu.encoder.synth import make_config, music_pcm
    from saprobe_alac_tpu.ops import batch as batch_mod
    from saprobe_alac_tpu.ops import lpc as lpc_mod
    from saprobe_alac_tpu.ops import lpc_kernel, walk_kernel
    from saprobe_alac_tpu.ops import walk as walk_mod
    from saprobe_alac_tpu.ops.epilogue import extract_escape
    from saprobe_alac_tpu.utils.compile_cache import enable_compile_cache
    from saprobe_alac_tpu.utils.profiling import device_busy_ns, device_trace

    dev = jax.devices()[0]
    if not args.cpu and dev.platform != "gpu":
        print(f"kernel_compare: no GPU (JAX runs on {dev.platform})", file=sys.stderr)
        return 1
    enable_compile_cache()
    kernel = "interpret" if args.cpu else "kernel"
    card = "cpu"
    if not args.cpu:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip().splitlines()[0]
    print(f"device {dev.device_kind}; card {card}", flush=True)
    out = {"device_kind": dev.device_kind, "card": card, "batch": args.batch,
           "frame": args.frame, "layers": {}, "e2e": {}, "sweep": []}

    # End-to-end combinations: the decoder's impl string names the walk's and
    # LPC's path as "walk+lpc"; these wrappers split it per layer.
    def walk_split(*a):
        return walk_mod._walk_batch(*a[:-1], a[-1].split("+")[0])

    def lpc_split(*a):
        return lpc_mod._lpc_batch(*a[:-1], a[-1].split("+")[-1])

    batch_mod._walk_batch = walk_split
    batch_mod._lpc_batch = lpc_split

    def busy_s(fn, iters):
        """Device busy seconds per call of fn, from a profiler trace."""
        with tempfile.TemporaryDirectory() as tmp:
            with device_trace(tmp):
                for _ in range(iters):
                    jax.block_until_ready(fn())
            busy = device_busy_ns(tmp)
        return sum(busy.values()) / 1e9 / iters if busy else float("nan")

    def wall_s(fn, iters):
        jax.block_until_ready(fn())
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    F, B = args.frame, args.batch
    cfg = make_config(frame_length=F)
    for content, tonality in (("music", 0.98), ("noise", 0.0)):
        pcm = music_pcm(F * B, 2, 16, seed=11, tonality=tonality)
        pkts = encode_packets(cfg, EncoderSpec(), pcm)
        words_np, sizes_np, swapped = batch_mod.JaxBatchDecoder(cfg)._stage(pkts)
        assert swapped
        words, sizes = jnp.asarray(words_np), jnp.asarray(sizes_np)
        wargs = (words, sizes, F, 2, 16, cfg.pb, cfg.mb, cfg.kb)
        wx = walk_mod.walk_batch(*wargs, impl="xla")
        res = extract_escape(words, wx.res, wx.esc, wx.esc_base, wx.esc_cb, wx.role, F, 2)
        L = words.shape[0] * 2
        largs = (
            res.reshape(F, L), wx.order.T.reshape(L), wx.mode.T.reshape(L),
            wx.den.T.reshape(L), wx.cb.T.reshape(L), jnp.tile(wx.ns, 2),
            wx.coefs.transpose(1, 0, 2).reshape(L, 32), F,
        )

        def walk_fn(impl):
            return lambda: walk_mod.walk_batch(*wargs, impl=impl)

        def lpc_fn(impl):
            return lambda: lpc_mod.lpc_batch(*largs, impl=impl)

        layers = {}
        for layer, fn in (("walk", walk_fn), ("lpc", lpc_fn)):
            outs = {}
            row = {}
            for impl in (kernel, "xla"):
                outs[impl] = jax.tree.map(np.asarray, fn(impl)())
                row[impl] = {"busy_s": busy_s(fn(impl), args.iters),
                             "wall_s": wall_s(fn(impl), args.iters)}
            same = all(
                np.array_equal(a, b)
                for a, b in zip(jax.tree.leaves(outs[kernel]), jax.tree.leaves(outs["xla"]))
            )
            row["identical"] = bool(same)
            layers[layer] = row
            print(f"{content} layer {layer}: kernel busy {row[kernel]['busy_s']} s "
                  f"wall {row[kernel]['wall_s']} s | xla busy {row['xla']['busy_s']} s "
                  f"wall {row['xla']['wall_s']} s | identical {same}", flush=True)
        out["layers"][content] = layers

        dec = batch_mod.JaxBatchDecoder(cfg)
        combos = (f"{kernel}+{kernel}", f"xla+{kernel}", f"{kernel}+xla", "xla+xla")
        e2e, ref = {}, None
        for combo in combos:
            dec.impl = combo
            got = dec.decode_packets(pkts)
            ref = got if ref is None else ref
            e2e[combo] = {"identical": got == ref,
                          "busy_s": busy_s(lambda: dec.decode_packets(pkts), 2)}
        # Interleaved rounds, rotating the order, so that no combination
        # always runs first.
        walls = {combo: [] for combo in combos}
        for r in range(args.rounds):
            for combo in combos[r % len(combos):] + combos[: r % len(combos)]:
                dec.impl = combo
                t0 = time.perf_counter()
                dec.decode_packets(pkts)
                walls[combo].append(time.perf_counter() - t0)
        for combo, row in e2e.items():
            q1, med, q3 = statistics.quantiles(walls[combo], n=4)
            row.update(wall_s=med, wall_q1_s=q1, wall_q3_s=q3)
            print(f"{content} e2e walk+lpc={combo}: wall {med} s (quartiles {q1}, {q3}), "
                  f"busy {row['busy_s']} s, identical {row['identical']}, "
                  f"realtime {F * B / 44100 / med}x", flush=True)
        out["e2e"][content] = e2e

        if content == "music" and args.sweep:
            defaults = (walk_kernel.LANES, walk_kernel.NUM_WARPS,
                        lpc_kernel.LANES, lpc_kernel.NUM_WARPS)
            for lanes, warps in ((16, 1), (32, 1), (64, 1), (64, 2), (128, 2), (128, 4)):
                walk_kernel.LANES = lpc_kernel.LANES = lanes
                walk_kernel.NUM_WARPS = lpc_kernel.NUM_WARPS = warps
                jax.clear_caches()
                row = {"lanes": lanes, "warps": warps,
                       "walk_busy_s": busy_s(walk_fn(kernel), args.iters),
                       "lpc_busy_s": busy_s(lpc_fn(kernel), args.iters)}
                out["sweep"].append(row)
                print(f"sweep lanes {lanes} warps {warps}: walk {row['walk_busy_s']} s, "
                      f"lpc {row['lpc_busy_s']} s", flush=True)
            (walk_kernel.LANES, walk_kernel.NUM_WARPS,
             lpc_kernel.LANES, lpc_kernel.NUM_WARPS) = defaults
            jax.clear_caches()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    ok = all(r["identical"] for c in out["layers"].values() for r in c.values()) and all(
        r["identical"] for c in out["e2e"].values() for r in c.values()
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
