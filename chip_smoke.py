"""Smoke run of the batched decode path on one CUDA GPU.

    python chip_smoke.py                # phases (a)-(h) and (k) on one card
    python chip_smoke.py --four-cards   # sharded decode over four cards

Every phase goes through the public entry points, on seeded content made by
the in-repo encoder (every packet distinct), and checks its output bit for
bit: against the native C++ core and the source PCM, and for a sample of
packets against the Python oracle.  Each phase prints one line with its
wall time, XLA compile time, realtime factor (audio seconds over warm decode
seconds) and the packets that fell back to the host.  Any mismatch, any
host fallback on this well-formed content, or any error ends the run with a
non-zero exit.  The last line is one JSON object naming the device.

Without a GPU the script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_compile_s = [0.0]


def _on_duration(event: str, duration: float, **_kw) -> None:
    # XLA compiles (persistent-cache reads included); they never nest, so
    # their sum is time spent.
    if event == "/jax/core/compile/backend_compile_duration":
        _compile_s[0] += duration


class Phase:
    """Times one phase: wall clock, compile seconds inside it, and the host
    fallback packets it added."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from saprobe_alac_tpu.ops.batch import host_fallback_packets

        self.t0 = time.perf_counter()
        self.c0 = _compile_s[0]
        self.f0 = host_fallback_packets()
        self.audio_s = 0.0
        self.warm_s = None
        return self

    def __exit__(self, exc_type, exc, tb):
        from saprobe_alac_tpu.ops.batch import host_fallback_packets

        if exc_type is not None:
            return False
        wall = time.perf_counter() - self.t0
        fallback = host_fallback_packets() - self.f0
        rtf = self.audio_s / self.warm_s if self.warm_s else float("nan")
        print(
            f"phase {self.name}: wall {wall:.2f} s, compile {_compile_s[0] - self.c0:.2f} s, "
            f"realtime {rtf:.1f}x, host-fallback packets {fallback}",
            flush=True,
        )
        if fallback:
            _fail(f"phase {self.name}: {fallback} packets fell back to the host")
        return False


def _timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def _encode(cfg, pcm, spec=None):
    from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets

    return encode_packets(cfg, spec or EncoderSpec(), pcm)


def _native(cfg, pkts):
    from saprobe_alac_tpu import native

    out, lens, errs = native.decode_batch(cfg, list(pkts))
    if errs.any():
        _fail("native core rejected well-formed packets")
    return [out[i, : lens[i]].tobytes() for i in range(len(pkts))]


def _check_batch(name, cfg, pkts, got, pcm, n_oracle=0):
    from saprobe_alac_tpu.codec import decode_packet as oracle
    from saprobe_alac_tpu.encoder.synth import expected_pcm_bytes

    if got != _native(cfg, pkts):
        _fail(f"phase {name}: device output differs from the native core")
    if b"".join(got) != expected_pcm_bytes(pcm, cfg.bit_depth):
        _fail(f"phase {name}: device output differs from the source PCM")
    step = max(1, len(pkts) // max(n_oracle, 1))
    for i in range(0, len(pkts), step)[:n_oracle]:
        if got[i] != oracle(cfg, pkts[i])[0]:
            _fail(f"phase {name}: packet {i} differs from the Python oracle")


def batch_phase(name, depth, channels, rate, B, *, tonality=0.98, spec=None, n_oracle=0, seed=0):
    """BatchDecoder.decode_packets on B distinct packets at frame length 4096."""
    from saprobe_alac_tpu import BatchDecoder
    from saprobe_alac_tpu.encoder.synth import make_config, music_pcm

    F = 4096
    cfg = make_config(depth=depth, channels=channels, frame_length=F, sample_rate=rate)
    pcm = music_pcm(F * B, channels, depth, seed=seed, tonality=tonality)
    pkts = _encode(cfg, pcm, spec)
    with Phase(f"{name} ({rate} Hz/{depth}-bit x{channels}, B={B})") as ph:
        dec = BatchDecoder(cfg)
        got, _ = _timed(lambda: dec.decode_packets(pkts))
        again, ph.warm_s = _timed(lambda: dec.decode_packets(pkts))
        ph.audio_s = F * B / rate
        if again != got:
            _fail(f"phase {name}: two decodes of one batch differ")
        _check_batch(name, cfg, pkts, got, pcm, n_oracle)
    return cfg, pkts, got


def file_phase(tmp):
    """(f) Decoder facade on a 5-minute 44.1/16 M4A: full read, then seeks."""
    from saprobe_alac_tpu import new_decoder
    from saprobe_alac_tpu.encoder import build_m4a
    from saprobe_alac_tpu.encoder.synth import expected_pcm_bytes, make_config, music_pcm

    F, rate = 4096, 44100
    cfg = make_config(frame_length=F, sample_rate=rate)
    pcm = music_pcm(300 * rate, 2, 16, seed=6)
    pkts = _encode(cfg, pcm)
    spp = [min(F, len(pcm) - i * F) for i in range(len(pkts))]
    path = os.path.join(tmp, "five_minutes.m4a")
    with open(path, "wb") as f:
        f.write(build_m4a(cfg, pkts, spp))
    want = expected_pcm_bytes(pcm, 16)
    bpf = 4
    with Phase("f (Decoder.read + 3 seeks, 5-minute 44.1k/16 M4A)") as ph:
        with open(path, "rb") as f:
            got, _ = _timed(lambda: new_decoder(f, backend="jax").read())
        with open(path, "rb") as f:
            dec = new_decoder(f, backend="jax")
            again, ph.warm_s = _timed(dec.read)
            ph.audio_s = len(pcm) / rate
            if got != want or again != want:
                _fail("phase f: full read differs from the source PCM")
            for t in (17.3, 151.0, 297.9):
                pos = dec.seek(t)
                tail = dec.read()
                start = round(pos * rate) * bpf
                if tail != want[start:]:
                    _fail(f"phase f: tail after seek({t}) differs from the source PCM")


def corpus_phase(tmp):
    """(g) iter_decode_corpus over 6 files mixing 44.1/16, 48/24, 96/24."""
    from saprobe_alac_tpu import iter_decode_corpus
    from saprobe_alac_tpu.encoder import build_m4a
    from saprobe_alac_tpu.encoder.synth import expected_pcm_bytes, make_config, music_pcm

    F = 4096
    files = []
    for i, (depth, rate, secs) in enumerate(
        [(16, 44100, 40), (24, 48000, 25), (24, 96000, 20),
         (16, 44100, 13), (24, 48000, 31), (24, 96000, 9)]
    ):
        cfg = make_config(depth=depth, frame_length=F, sample_rate=rate)
        pcm = music_pcm(secs * rate + 1234 * i, 2, depth, seed=40 + i)
        pkts = _encode(cfg, pcm)
        spp = [min(F, len(pcm) - j * F) for j in range(len(pkts))]
        path = os.path.join(tmp, f"corpus_{i}.m4a")
        with open(path, "wb") as f:
            f.write(build_m4a(cfg, pkts, spp))
        files.append((path, expected_pcm_bytes(pcm, depth), len(pcm) / rate))
    with Phase("g (iter_decode_corpus, 6 files of 44.1k/16, 48k/24, 96k/24)") as ph:
        paths = [p for p, _, _ in files]
        first, _ = _timed(lambda: list(iter_decode_corpus(paths, backend="jax")))
        again, ph.warm_s = _timed(lambda: list(iter_decode_corpus(paths, backend="jax")))
        ph.audio_s = sum(s for _, _, s in files)
        for run in (first, again):
            if sorted(d.index for d in run) != list(range(len(files))):
                _fail("phase g: corpus service lost or repeated a file")
            for d in run:
                if d.pcm != files[d.index][1]:
                    _fail(f"phase g: file {d.index} differs from the source PCM")


def encode_phase():
    """(h) Device encode round trip: encode on the device, decode, compare."""
    from saprobe_alac_tpu import BatchDecoder
    from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
    from saprobe_alac_tpu.encoder.synth import expected_pcm_bytes, make_config, music_pcm

    F = 4096
    cfg = make_config(frame_length=F)
    pcm = music_pcm(8 * F - 300, 2, 16, seed=8)
    with Phase("h (encode_packets backend=device, 8 packets 44.1k/16)") as ph:
        pkts = encode_packets(cfg, EncoderSpec(), pcm, backend="device")
        again, ph.warm_s = _timed(lambda: encode_packets(cfg, EncoderSpec(), pcm, backend="device"))
        ph.audio_s = len(pcm) / cfg.sample_rate
        if again != pkts:
            _fail("phase h: two device encodes of one signal differ")
        got = BatchDecoder(cfg).decode_packets(pkts)
        if b"".join(got) != expected_pcm_bytes(pcm, 16):
            _fail("phase h: device-encoded stream does not decode to the source PCM")
        if got != _native(cfg, pkts):
            _fail("phase h: device decode differs from the native core")


def kernels_phase(cfg, pkts):
    """(k) Each GPU kernel against the plain XLA version of its layer, at
    B=2048, F=4096: the walk's results and the LPC output must be equal."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from saprobe_alac_tpu.ops.batch import _bucket
    from saprobe_alac_tpu.ops.bitpack import pack_packets
    from saprobe_alac_tpu.ops.epilogue import extract_escape
    from saprobe_alac_tpu.ops.lpc import lpc_batch
    from saprobe_alac_tpu.ops.walk import walk_batch

    words_np, sizes_np = pack_packets(list(pkts))
    W = _bucket(words_np.shape[1], floor=16)
    words = np.zeros((len(pkts), W), np.int32)
    words[:, : words_np.shape[1]] = words_np
    words, sizes = jnp.asarray(words), jnp.asarray(sizes_np)
    F, C = cfg.frame_length, cfg.num_channels
    args = (words, sizes, F, C, cfg.bit_depth, cfg.pb, cfg.mb, cfg.kb)
    with Phase(f"k (walk and LPC kernels vs plain XLA, B={len(pkts)} F={F})") as ph:
        wk = walk_batch(*args, impl="kernel")
        wx = walk_batch(*args, impl="xla")
        for name in wx._fields:
            if not np.array_equal(np.asarray(getattr(wk, name)), np.asarray(getattr(wx, name))):
                _fail(f"phase k: walk kernel field {name} differs from the XLA walk")
        res = extract_escape(words, wx.res, wx.esc, wx.esc_base, wx.esc_cb, wx.role, F, C)
        L = len(pkts) * C
        lpc_args = (
            res.reshape(F, L), wx.order.T.reshape(L), wx.mode.T.reshape(L),
            wx.den.T.reshape(L), wx.cb.T.reshape(L), jnp.tile(wx.ns, C),
            wx.coefs.transpose(1, 0, 2).reshape(L, 32), F,
        )
        mk = lpc_batch(*lpc_args, impl="kernel")
        mx = lpc_batch(*lpc_args, impl="xla")
        if not np.array_equal(np.asarray(mk), np.asarray(mx)):
            _fail("phase k: LPC kernel output differs from the XLA scan")
        _, t_walk = _timed(lambda: jax.block_until_ready(walk_batch(*args, impl="kernel")))
        _, t_lpc = _timed(lambda: jax.block_until_ready(lpc_batch(*lpc_args, impl="kernel")))
        ph.warm_s = t_walk + t_lpc
        ph.audio_s = F * len(pkts) / cfg.sample_rate


def four_cards(F=4096, B=8192):
    """ShardedBatchDecoder over four cards vs one-card decode, B=8192."""
    import jax

    from saprobe_alac_tpu import BatchDecoder
    from saprobe_alac_tpu.encoder.synth import expected_pcm_bytes, make_config, music_pcm
    from saprobe_alac_tpu.ops.batch import JaxBatchDecoder
    from saprobe_alac_tpu.parallel import ShardedBatchDecoder

    if len(jax.devices()) != 4:
        _fail(f"--four-cards needs 4 devices, found {len(jax.devices())}")
    cfg = make_config(frame_length=F)
    pcm = music_pcm(F * B, 2, 16, seed=9)
    pkts = _encode(cfg, pcm)
    with Phase(f"4-card (ShardedBatchDecoder, 44.1k/16 x2, B={B})") as ph:
        dec = BatchDecoder(cfg)  # every visible card: the sharded path
        got, _ = _timed(lambda: dec.decode_packets(pkts))
        if not isinstance(dec._jax(), ShardedBatchDecoder):
            _fail("BatchDecoder did not pick the sharded decoder on 4 cards")
        again, ph.warm_s = _timed(lambda: dec.decode_packets(pkts))
        ph.audio_s = F * B / cfg.sample_rate
        one = JaxBatchDecoder(cfg).decode_packets(pkts)  # on the default card
        if got != one or again != one:
            _fail("4-card decode differs from the one-card decode")
        if b"".join(one) != expected_pcm_bytes(pcm, 16):
            _fail("one-card decode differs from the source PCM")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded decode over four cards")
    args = ap.parse_args()
    if not args.four_cards:
        # The default phases use exactly one card, even where more are visible.
        os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

    import jax

    try:
        devices = jax.devices()
    except RuntimeError as exc:
        _fail(f"no accelerator: {exc}")
    if devices[0].platform != "gpu":
        _fail(f"no GPU: JAX runs on {devices[0].platform}")

    from saprobe_alac_tpu import native
    from saprobe_alac_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    if not native.available():
        _fail(f"native core unavailable: {native.build_error()}")
    print(f"devices: {devices}", flush=True)

    if args.four_cards:
        four_cards()
    else:
        import tempfile

        from saprobe_alac_tpu.encoder import EncoderSpec

        cfg, pkts, _ = batch_phase("a", 16, 2, 44100, 2048, n_oracle=16, seed=1)
        batch_phase("b", 16, 2, 44100, 2048, tonality=0.0, seed=2)
        batch_phase("c", 24, 2, 96000, 512, spec=EncoderSpec(bytes_shifted=1), n_oracle=4, seed=3)
        batch_phase("d", 24, 8, 48000, 256, n_oracle=4, seed=4)
        batch_phase("e", 32, 2, 192000, 1024, n_oracle=4, seed=5)
        with tempfile.TemporaryDirectory() as tmp:
            file_phase(tmp)
            corpus_phase(tmp)
        encode_phase()
        kernels_phase(cfg, pkts)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
