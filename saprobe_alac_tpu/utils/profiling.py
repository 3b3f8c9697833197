"""Profiling and tracing helpers.

Device analogue of the reference's pprof harness (tests/profile_test.go,
hack/bench.sh): jax.profiler traces for the device pipeline plus wall-clock
phase timing for the decode stages.  Use hack/profile.py for the CLI.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_busy_ns(trace_dir: str) -> dict[str, int]:
    """Reduce a jax.profiler trace to device busy time per device plane.

    Busy is the union of the intervals of the events on a GPU plane's
    stream lines (kernels and copies), so overlapping streams are not
    double counted and idle gaps between launches are excluded.  Returns
    {plane name: busy nanoseconds}.
    """
    import glob

    import jax

    out: dict[str, int] = {}
    for path in glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"):
        data = jax.profiler.ProfileData.from_file(path)
        for plane in data.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            spans = sorted(
                (ev.start_ns, ev.end_ns)
                for line in plane.lines
                if line.name.startswith("Stream")
                for ev in line.events
            )
            busy, end = 0, None
            for s, e in spans:
                if end is None or s > end:
                    busy += e - s
                    end = e
                elif e > end:
                    busy += e - end
                    end = e
            out[plane.name] = out.get(plane.name, 0) + int(busy)
    return out


@dataclass
class PhaseTimer:
    """Wall-clock per-phase accounting with blocking boundaries."""

    phases: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase; ``sync`` (e.g. jax.block_until_ready) runs on the
        phase result boundary if provided."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.phases.values()) or 1.0
        lines = [f"{'phase':<24}{'total':>10}{'calls':>8}{'share':>8}"]
        for name, t in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<24}{t*1e3:>8.1f}ms{self.counts[name]:>8}{100*t/total:>7.1f}%"
            )
        return "\n".join(lines)


def profile_batch_decode(config, packets, iters: int = 3) -> PhaseTimer:
    """Per-phase timing of the device pipeline on a packet batch."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..ops.batch import _bucket
    from ..ops.bitpack import pack_packets
    from ..ops.epilogue import extract_escape, extract_shift, finish_packed
    from ..ops.lpc import lpc_batch
    from ..ops.walk import walk_batch

    timer = PhaseTimer()
    cfg = config
    F, C = cfg.frame_length, cfg.num_channels

    # Phase functions jitted once: eager lax.cond with fresh lambdas would
    # retrace every iteration and bill compile time to the phase.
    @jax.jit
    def escape_step(jw, w):
        return jax.lax.cond(
            jnp.any(w.esc == 1),
            lambda: extract_escape(jw, w.res, w.esc, w.esc_base, w.esc_cb, w.role, F, C),
            lambda: w.res,
        )

    @jax.jit
    def shift_step(jw, w):
        B = jw.shape[0]
        return jax.lax.cond(
            jnp.any(w.bs > 0),
            lambda: extract_shift(jw, w.shift_base, w.bs, w.role, F, C),
            lambda: jnp.zeros((F, C, B), jnp.int32),
        )

    # Warm pass: the phase closures above are created fresh per call, so their
    # first execution compiles; run one untimed iteration so compile time is
    # never billed to a phase.  (Each timed phase pays its own dispatch and
    # sync; the production pipeline is a single jit and pays them once per
    # batch.)
    warm = -1

    for warm in range(-1, iters):
        if warm == 0:
            timer.phases.clear()
            timer.counts.clear()
        with timer.phase("host_pack"):
            words_np, sizes_np = pack_packets(list(packets))
            Wb = _bucket(words_np.shape[1], floor=16)
            Bb = _bucket(len(packets))
            words = np.zeros((Bb, Wb), dtype=np.int32)
            words[: len(packets), : words_np.shape[1]] = words_np
            sizes = np.zeros(Bb, dtype=np.int32)
            sizes[: len(packets)] = sizes_np

        with timer.phase("h2d"):
            jw = jnp.asarray(words)
            js = jnp.asarray(sizes)
            jax.block_until_ready((jw, js))

        with timer.phase("walk"):
            w = walk_batch(jw, js, F, C, cfg.bit_depth, cfg.pb, cfg.mb, cfg.kb)
            jax.block_until_ready(tuple(w))

        with timer.phase("escape"):
            # Mirrors ops/batch.py: the raw-sample gather only runs when some
            # lane actually carries an escape element.
            res = escape_step(jw, w)
            jax.block_until_ready(res)

        with timer.phase("lpc"):
            L = Bb * C
            mix = lpc_batch(
                res.reshape(F, L),
                w.order.T.reshape(L),
                w.mode.T.reshape(L),
                w.den.T.reshape(L),
                w.cb.T.reshape(L),
                jnp.tile(w.ns, C),
                w.coefs.transpose(1, 0, 2).reshape(L, 32),
                F,
            )
            jax.block_until_ready(mix)

        with timer.phase("epilogue"):
            # Same fused finish+pack as ops/batch._decode_batch.
            sv = shift_step(jw, w)
            packed = finish_packed(
                mix, sv, w.bs, w.mixbits, w.mixres, w.role, w.out_chan, w.filled, F, C, cfg.bit_depth
            )
            jax.block_until_ready(packed)

        with timer.phase("d2h"):
            np.asarray(packed)

    return timer
