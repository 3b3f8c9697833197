"""GPU kernel for the per-channel entropy walk (Pallas, Triton route).

One packet per thread.  Each program owns a power-of-two block of lanes and
loops (``lax.while_loop`` inside the kernel) until every lane of the block
has finished its channel.  A lane's cursor, adaptive mean, zero-run mode
and sample count live in registers; each step it loads the four stream
words under its cursor (a per-lane gather that stays in L1 as the cursor
walks forward), decodes one Golomb-Rice codeword plus an optional zero-run
code from them, and stores the residual into the F-major (F, C, B) planes
with a per-lane masked store.  Zero-run samples are never stored: the
planes start zeroed.

The math is the lockstep XLA walk's (ops/walk.py ``_entropy_channel``) step
for step; ``entropy_channel_pallas`` is a drop-in replacement for it whose
residual buffer is the (F, C, B) stack instead of the flat scatter buffer.

Behavioral parity: golomb.go:112-253 (adaptive Golomb, escape, zero-run,
uint32-wrap mean), bitbuffer.go:28-32 (zero-pad reads past the packet end).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .jaxint import I32, clz, lg3a, shl, ushr
from .walk import ERR_NONE, ERR_OVERRUN, ERR_SAMPLES

#: Lanes per program and warps per program.  Few lanes per program spread a
#: batch over many SMs; the walk is latency-bound per thread, not
#: throughput-bound per SM.  Chosen by hack/kernel_compare.py --sweep on an
#: H100 at B=2048, F=4096 (see PERF.md).
LANES = 16
NUM_WARPS = 1

#: Stream words each step loads under the cursor: a sample consumes at most
#: 66 bits (escape codeword 9+32, then the zero-run code's top 25 bits), and
#: the cursor sits anywhere in its first word, so 4 words (128 bits) cover it.
_WIN_WORDS = 4


def _lsr(x, n: int):
    return jax.lax.shift_right_logical(x, I32(n))


def _sel(ws, k):
    """ws[k] for per-lane k (out-of-range k reads as zero)."""
    out = jnp.zeros_like(ws[0])
    for i, w in enumerate(ws):
        out = jnp.where(k == i, w, out)
    return out


def _kernel(
    words_ref, size_ref, pos_ref, err_ref, act_ref, chan_ref, pb_ref,
    msz_ref, ns_ref, _res_in_ref, res_ref, pos_out_ref, err_out_ref,
    *, W, F, kb, mb, lanes_per_program,
):
    lc = pl.program_id(0) * lanes_per_program + jnp.arange(
        lanes_per_program, dtype=I32
    )
    size = size_ref[lc]
    pos0 = pos_ref[lc]
    err0 = err_ref[lc]
    chan = chan_ref[lc]
    pb_local = pb_ref[lc]
    msz = msz_ref[lc]
    ns = ns_ref[lc]
    wb = (1 << kb) - 1 if kb < 32 else -1

    def word(j):
        w = words_ref[lc, jnp.clip(j, 0, W - 1)]
        return jnp.where((j >= 0) & (j < W), w, 0)

    def cond(st):
        act, it = st[0], st[-1]
        return (jnp.max(act.astype(I32)) > 0) & (it < F + 4)

    def body(st):
        act, pos, err, count, mean, zmode, it = st

        # Overrun guard (golomb.go:168-170); negative = Go uint32 wrap.
        over = act & ((pos >= size) | (pos < 0))
        err = jnp.where(over, ERR_OVERRUN, err)
        act = act & ~over

        j = jax.lax.shift_right_arithmetic(pos, I32(5))
        ws = [word(j + i) for i in range(_WIN_WORDS)]
        wsn = ws[1:] + [jnp.zeros_like(ws[0])]

        def win32(q):
            """The 32 stream bits at bit ``q`` of the loaded words."""
            k = _lsr(q, 5)
            r = q & 31
            a = _sel(ws, k)
            b = _sel(wsn, k)
            return jax.lax.shift_left(a, r) | jax.lax.shift_right_logical(
                _lsr(b, 1), 31 - r
            )

        r0 = pos & 31
        m0 = _lsr(mean, 9)
        k = jnp.minimum(lg3a(m0), kb)
        m = shl(1, k) - 1

        win = win32(r0)
        pre = clz(~win)

        # Escape: prefix >= 9 -> raw max_size bits (golomb.go:184-186).
        is_esc = pre >= 9
        val_esc = ushr(win32(r0 + 9), 32 - jnp.maximum(msz, 1))
        bits_esc = 9 + msz

        # Normal: value from prefix and k-bit remainder (golomb.go:188-201).
        win2 = shl(win, pre + 1)
        v = ushr(win2, 32 - k)
        vbig = v >= 2
        val_n = jnp.where(k != 1, jnp.where(vbig, pre * m + v - 1, pre * m), pre)
        bits_n = pre + 1 + jnp.where(k != 1, jnp.where(vbig, k, k - 1), 0)

        value = jnp.where(is_esc, val_esc, val_n)
        nbits = jnp.where(is_esc, bits_esc, bits_n)

        # Signed mapping (golomb.go:206-212), wrapping 32-bit.
        nd = value + zmode
        delta = _lsr(nd + 1, 1) * (1 - 2 * (nd & 1))
        plgpu.store(
            res_ref.at[jnp.clip(count, 0, F - 1), chan, lc], delta, mask=act
        )

        count_n = jnp.where(act, count + 1, count)
        q = r0 + nbits

        # Adaptive mean (golomb.go:215-218): uint32 wrap arithmetic.
        mean_n = pb_local * nd + mean - _lsr(pb_local * mean, 9)
        mean_n = jnp.where((value < 0) | (value > 0xFFFF), 0xFFFF, mean_n)
        mean = jnp.where(act, mean_n, mean)
        zmode = jnp.where(act, 0, zmode)

        # Zero-run mode (golomb.go:223-246); (mean<<2) < 512 unsigned.
        m4 = shl(mean, 2)
        zcond = act & (m4 >= 0) & (m4 < 512) & (count_n < ns)
        k32 = jnp.maximum(clz(mean) - 24 + _lsr(mean + 16, 6), 0)
        mz = (shl(1, k32) - 1) & wb

        zwin = win32(jnp.clip(q, 0, 32 * _WIN_WORDS - 1))
        zpre = clz(~zwin)
        z_esc = zpre >= 9
        zval_esc = _lsr(shl(zwin, 9), 16)
        zwin2 = shl(zwin, zpre + 1)
        zv = ushr(zwin2, 32 - jnp.maximum(k32, 1))
        zv = jnp.where(k32 == 0, 0, zv)
        zvbig = zv >= 2
        zval_n = jnp.where(zvbig, zpre * mz + zv - 1, zpre * mz)
        zbits_n = zpre + 1 + jnp.where(zvbig, k32, k32 - 1)
        zrun = jnp.where(z_esc, zval_esc, zval_n)
        zbits = jnp.where(z_esc, 9 + 16, zbits_n)

        zover = zcond & (count_n + zrun > ns)
        err = jnp.where(zover, ERR_SAMPLES, err)
        act = act & ~zover
        zcond = zcond & ~zover

        count_n = jnp.where(zcond, count_n + zrun, count_n)
        q = jnp.where(zcond, q + zbits, q)
        zmode = jnp.where(zcond, jnp.where(zrun >= 65535, 0, 1), zmode)
        mean = jnp.where(zcond, 0, mean)

        pos = jnp.where(act, pos - r0 + q, pos)
        act = act & (count_n < ns) & (err == ERR_NONE)
        return act, pos, err, count_n, mean, zmode, it + 1

    act0 = (act_ref[lc] != 0) & (ns > 0) & (err0 == ERR_NONE)
    zero = jnp.zeros_like(pos0)
    st = (act0, pos0, err0, zero, jnp.full_like(pos0, mb), zero, jnp.int32(0))
    act, pos, err, *_ = jax.lax.while_loop(cond, body, st)
    err = jnp.where(act, ERR_OVERRUN, err)  # guard-tripped lanes
    pos_out_ref[lc] = pos
    err_out_ref[lc] = err


def entropy_channel_pallas(
    words, size_bits, bitpos, err, res, active, chan, pb_local, max_size, ns,
    *, kb, mb, interpret=False,
):
    """Entropy-decode one channel for every active lane.

    words: (B, W) big-endian-order stream words, B a multiple of LANES;
    res: (F, C, B) residual planes, updated in place at [sample, chan[b], b].
    Returns (bitpos, err, res), as ops/walk.py's ``_entropy_channel``.
    """
    B, W = words.shape
    assert B % LANES == 0, B
    F = res.shape[0]
    kernel = functools.partial(
        _kernel, W=W, F=F, kb=kb, mb=mb, lanes_per_program=LANES
    )
    vec = jax.ShapeDtypeStruct((B,), I32)
    res, bitpos, err = pl.pallas_call(
        kernel,
        grid=(B // LANES,),
        out_shape=(jax.ShapeDtypeStruct(res.shape, I32), vec, vec),
        input_output_aliases={9: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="alac_entropy_walk",
    )(
        words, size_bits, bitpos, err, active.astype(I32), chan, pb_local,
        max_size, ns, res,
    )
    return bitpos, err, res
