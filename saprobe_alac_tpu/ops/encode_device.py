"""Device-side ALAC encoding: one packet per vector lane.

The encode direction is bit-serial per packet for the same reason decode is
(adaptive entropy state), and parallel across packets for the same reason
too.  This module mirrors ops/walk.py in reverse: an LPC forward scan over
(packet, channel) lanes produces residuals, then a lockstep entropy-encode
loop emits Golomb-Rice codewords into per-lane word buffers.

Bit emission trick: output words start zeroed and every emitted bit is new,
so "append w bits at bitpos" is two scatter-ADDs (add == or into zeros) on
the straddled words — no read-modify-write hazard, since each lane owns its
row.

Scope (v2): the full host-encoder spec space — per-element spec overrides,
mode>0 two-stage delta pre-pass, per-lane adaptive pbFactor candidates,
forced/auto escape, per-lane Levinson-Durbin coefficient fitting, byte
shifting, partial frames.  Device-encoded streams are bit-identical to the
Python encoder given the same parameters (kb=0 streams fall back to host).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..codec.element import CHANNEL_LAYOUT_OFFSETS
from ..config import PacketConfig
from .jaxint import I32, U32, clz, lg3a, s, sext, shl, sshr, u, ushr

def _emit(words, bitpos, value, width):
    """Append ``width`` (0..32) bits of ``value`` at per-lane ``bitpos``.

    words: (B, W) int32 big-endian bit order; returns (words, bitpos+width).
    """
    B, W = words.shape
    widx = sshr(bitpos, 5)
    sh = bitpos & 31
    vmask = jnp.where(width >= 32, -1, shl(1, width) - 1)
    v = value & vmask
    # 64-bit window placement: value occupies bits [sh, sh+width) MSB-first.
    right = 64 - sh - width  # distance from window LSB
    hi = jnp.where(right >= 32, shl(v, right - 32), ushr(v, 32 - right))
    lo = jnp.where(right >= 32, 0, shl(v, right))
    lanes = jnp.arange(B)
    widx0 = jnp.clip(widx, 0, W - 2)
    words = words.at[lanes, widx0].add(hi)
    words = words.at[lanes, widx0 + 1].add(lo)
    return words, bitpos + width


def _zero_run_table(res, ns):
    """zrun[i] = consecutive zeros at i (within [0, ns)); (L, F) int32."""
    L, F = res.shape
    idx = jnp.arange(F, dtype=I32)[None, :]
    valid = idx < ns[:, None]
    nonzero = (res != 0) & valid
    # Next nonzero position at/after i (ns when none), via reverse cummin.
    pos = jnp.where(nonzero, idx, ns[:, None])
    nxt = jax.lax.cummin(pos[:, ::-1], axis=1)[:, ::-1]
    return jnp.maximum(nxt - idx, 0)


def _lpc_forward_batch(x, order, den, cb, ns, coefs, frame_length):
    """Residuals for all lanes: inverse of ops/lpc.py (same recurrence, del
    solved instead of out).  x: (L, F) int32; returns (L, F) int32."""
    from .lpc import _INT32_ORDERS

    F = frame_length
    L = x.shape[0]
    PAD = 32

    wrap16 = jnp.ones(L, dtype=bool)
    for o in _INT32_ORDERS:
        wrap16 = wrap16 & (order != o)

    xP = jnp.zeros((L, PAD + F), I32)
    xP = jax.lax.dynamic_update_slice(xP, x, (0, PAD))

    den_half = jnp.where(den > 0, s(jax.lax.shift_left(u(jnp.ones(L, I32)), u(jnp.maximum(den - 1, 0)))), 0)
    tap_idx = jnp.arange(32, dtype=I32)[None, :]
    weight = order[:, None] - tap_idx
    tap_mask = tap_idx < order[:, None]
    is_fir = (order >= 1) & (order <= 30)
    is_delta = order == 31

    res0 = x  # order-0 lanes: residuals are the samples
    # delta lanes (order 31): res[i] = sext(x[i]-x[i-1])
    xm1 = jnp.concatenate([x[:, :1], x[:, :-1]], axis=1)
    delta_res = sext(x - xm1, cb[:, None])
    delta_res = jnp.where(jnp.arange(F)[None, :] == 0, x, delta_res)
    res_init = jnp.where(is_delta[:, None], delta_res, res0)

    resP = jnp.zeros((L, F), I32)
    resP = jnp.where(is_fir[:, None], 0, res_init)
    resP = resP.at[:, 0].set(x[:, 0])

    def body(t, carry):
        resP, coefs = carry
        active = is_fir & (t < ns)

        Wn = jax.lax.dynamic_slice(xP, (0, t), (L, PAD))
        WR = Wn[:, ::-1]  # WR[:, k] = x[t-1-k]
        top = jnp.take_along_axis(WR, order[:, None], axis=1)[:, 0]

        acc = jnp.sum(jnp.where(tap_mask, coefs * (WR - top[:, None]), 0), axis=1, dtype=I32)
        sum1 = sshr(acc + den_half, den)

        xt = jax.lax.dynamic_slice(xP, (0, PAD + t), (L, 1))[:, 0]
        warm = t <= order
        prev = WR[:, 0]
        delta = jnp.where(warm, sext(xt - prev, cb), sext(xt - top - sum1, cb))

        cur = jax.lax.dynamic_slice(resP, (0, t), (L, 1))[:, 0]
        resP = jax.lax.dynamic_update_slice(
            resP, jnp.where(active, delta, cur)[:, None], (0, t)
        )

        # Coefficient adaptation identical to decode (ops/lpc.py).
        sign = jnp.sign(delta)
        dd = top[:, None] - WR
        sgn = jnp.sign(dd) * sign[:, None]
        contrib = jnp.where(tap_mask, weight * sshr(sgn * dd, den[:, None]), 0)
        suffix_inc = jnp.cumsum(contrib[:, ::-1].astype(jnp.uint32), axis=1)[:, ::-1].astype(I32)
        del0 = delta[:, None] - (suffix_inc - contrib)
        run = jnp.where(sign[:, None] > 0, del0 > 0, del0 < 0) & tap_mask
        adapt = active[:, None] & (sign != 0)[:, None] & ~warm[:, None] & run
        newc = coefs - sgn
        from .jaxint import sext16

        newc = jnp.where(wrap16[:, None], sext16(newc), newc)
        coefs = jnp.where(adapt, newc, coefs)
        return resP, coefs

    def run_scan(args):
        return jax.lax.fori_loop(1, F, body, args)

    resP, _ = jax.lax.cond(jnp.any(is_fir), run_scan, lambda a: a, (resP, coefs))
    return resP


def _lpc_forward(data, order, den_shift, cb, ns, coefs, F, mode):
    """Forward LPC residuals for one channel, mode post-pass included."""
    B = data.shape[0]
    res = _lpc_forward_batch(
        data,
        jnp.full(B, order, I32),
        jnp.full(B, den_shift, I32),
        jnp.full(B, cb, I32),
        ns,
        coefs,
        F,
    )
    if mode != 0:
        # Two-stage: the decoder un-deltas first (decoder.go:307-309),
        # so the stream carries delta'd residuals.
        rm1 = jnp.concatenate([res[:, :1], res[:, :-1]], axis=1)
        d = sext(res - rm1, jnp.full(B, cb, I32)[:, None])
        res = jnp.where(jnp.arange(F, dtype=I32)[None, :] == 0, res, d)
    return res


def _entropy_encode(words, bitpos, res, zrun, active0, pb_local, max_size, ns, mb, kb):
    """Lockstep Golomb-Rice encode of one channel for all lanes."""
    B = bitpos.shape[0]
    F = res.shape[1]
    wb = (1 << kb) - 1 if kb < 32 else 0xFFFFFFFF
    max_iters = F + 4

    def cond(st):
        return jnp.any(st[0]) & (st[6] < max_iters)

    def body(st):
        act, words, bitpos, i, mean, zmode, it = st

        d = jnp.take_along_axis(res, jnp.clip(i, 0, F - 1)[:, None], axis=1)[:, 0]
        n = jnp.where(d >= 0, 2 * d, -2 * d - 1)  # wrapping int32 (u32 pattern)
        value = n - zmode

        m0 = s(jax.lax.shift_right_logical(u(mean), U32(9)))
        k = jnp.minimum(lg3a(m0), kb)
        m = shl(1, k) - 1

        qu = u(value) // u(jnp.maximum(m, 1))
        q = jnp.where(m > 0, s(qu), 9)
        escape = jnp.where(m > 0, qu >= 9, True)  # unsigned compare
        # prefix: q ones + 0 (or 9 ones for escape)
        p_w = jnp.where(escape, 9, q + 1)
        p_v = jnp.where(escape, 0x1FF, shl(1, q + 1) - 2)  # ones then a zero
        # suffix
        r = value - q * m
        sfx_w = jnp.where(escape, max_size, jnp.where(k == 1, 0, jnp.where(r == 0, k - 1, k)))
        sfx_v = jnp.where(escape, value, jnp.where(r == 0, 0, r + 1))

        p_w = jnp.where(act, p_w, 0)
        sfx_w = jnp.where(act, sfx_w, 0)
        words, bitpos = _emit(words, bitpos, jnp.where(act, p_v, 0), p_w)
        words, bitpos = _emit(words, bitpos, jnp.where(act, sfx_v, 0), sfx_w)

        i_n = jnp.where(act, i + 1, i)
        mean_n = s(u(pb_local) * u(n) + u(mean) - jax.lax.shift_right_logical(u(pb_local) * u(mean), U32(9)))
        mean_n = jnp.where(u(value) > 0xFFFF, 0xFFFF, mean_n)
        mean = jnp.where(act, mean_n, mean)
        zmode = jnp.where(act, 0, zmode)

        # Zero-run mode (mirror of golomb.go:223-246).
        zcond = act & (u(shl(mean, 2)) < 512) & (i_n < ns)
        k32 = jnp.maximum(clz(mean) - 24 + s(jax.lax.shift_right_logical(u(mean + 16), U32(6))), 0)
        mz = (shl(1, k32) - 1) & wb
        run = jnp.take_along_axis(zrun, jnp.clip(i_n, 0, F - 1)[:, None], axis=1)[:, 0]
        run = jnp.minimum(run, 65535)

        zqu = u(run) // u(jnp.maximum(mz, 1))
        zq = jnp.where(mz > 0, s(zqu), 9)
        zesc = jnp.where(mz > 0, zqu >= 9, True)
        zp_w = jnp.where(zesc, 9, zq + 1)
        zp_v = jnp.where(zesc, 0x1FF, shl(1, zq + 1) - 2)
        zr = run - zq * mz
        zs_w = jnp.where(zesc, 16, jnp.where(k32 == 1, 0, jnp.where(zr == 0, k32 - 1, k32)))
        zs_v = jnp.where(zesc, run, jnp.where(zr == 0, 0, zr + 1))

        zp_w = jnp.where(zcond, zp_w, 0)
        zs_w = jnp.where(zcond, zs_w, 0)
        words, bitpos = _emit(words, bitpos, jnp.where(zcond, zp_v, 0), zp_w)
        words, bitpos = _emit(words, bitpos, jnp.where(zcond, zs_v, 0), zs_w)

        i_n = jnp.where(zcond, i_n + run, i_n)
        zmode = jnp.where(zcond, jnp.where(run >= 65535, 0, 1), zmode)
        mean = jnp.where(zcond, 0, mean)

        act = act & (i_n < ns)
        return act, words, bitpos, i_n, mean, zmode, it + 1

    init = (
        active0 & (ns > 0),
        words,
        bitpos,
        jnp.zeros(B, I32),
        jnp.full(B, mb, I32),
        jnp.zeros(B, I32),
        jnp.zeros((), I32),
    )
    _, words, bitpos, _, _, _, _ = jax.lax.while_loop(cond, body, init)
    return words, bitpos


def _entropy_body(res, ns, pb_local, cb, mb, kb, Wch):
    """Entropy-encode one channel for all lanes into an isolated buffer at
    bit 0.  Returns (buf (B, Wch) int32 BE, bit_len (B,))."""
    B = res.shape[0]
    zrun = _zero_run_table(res, ns)
    buf = jnp.zeros((B, Wch), I32)
    buf, blen = _entropy_encode(
        buf, jnp.zeros(B, I32), res, zrun, jnp.ones(B, bool), pb_local,
        jnp.full(B, cb, I32), ns, mb, kb,
    )
    return buf, blen


def _pack_fields(values, width):
    """Dense MSB-first pack of K ``width``-bit fields at bit 0.

    values: (B, K) int32; width: static int (1..32).  Returns (B, Wd) int32
    big-endian words, Wd = ceil(K*width/32).  The bit layout is a FIXED
    pattern (field k occupies bits [k*w, (k+1)*w)), so each output word is
    the OR of at most floor(32/w)+1 statically-indexed fields — constant-
    index gathers plus elementwise shifts, no scatter-add.
    """
    B, K = values.shape
    vmask = (1 << width) - 1 if width < 32 else -1
    v = values & vmask
    Wd = (K * width + 31) // 32
    m = 32 // width + 1
    j = np.arange(Wd, dtype=np.int32)
    kf = (32 * j) // width  # first field covering bit 32j
    word = jnp.zeros((B, Wd), I32)
    for i in range(m + 1):
        k = kf + i
        off = k * width - 32 * j  # field MSB position within word j
        live = (k < K) & (off < 32) & (off > -width)
        if not live.any():
            continue
        kc = np.minimum(np.where(live, k, 0), K - 1)
        vk = jnp.take(v, jnp.asarray(kc), axis=1)  # constant-index gather
        right = 32 - off - width  # distance from word LSB (in [-31, 31])
        rs = jnp.asarray(np.clip(right, 0, 31), I32)[None, :]
        ls = jnp.asarray(np.clip(-right, 0, 31), I32)[None, :]
        piece = jnp.where(jnp.asarray(right >= 0)[None, :], shl(vk, rs), ushr(vk, ls))
        word = word + jnp.where(jnp.asarray(live)[None, :], piece, 0)
    return word


def _blit_bits(words, base, src):
    """OR ``src`` (B, Ws) int32 BE words into ``words`` at per-lane bit
    offset ``base``; returns the updated words.

    Gather restructure of the width-32 _emit_many blit: output word j
    receives src[j - q] >> r and src[j - q - 1] << (32 - r) with
    q = base >> 5, r = base & 31 — two per-lane gathers along the minor
    axis plus elementwise shifts, instead of a (B, Ws) scatter-add.
    Bits landing beyond the destination are dropped (the scatter version
    clipped them onto the last words; all call sites only ever blit zero
    tails there, so both are no-ops).  Appended bits are new (dst region
    is zero), so add == or, as everywhere in this module.
    """
    B, W = words.shape
    Ws = src.shape[1]
    q = sshr(base, 5)[:, None]
    r = (base & 31)[:, None]
    j = jnp.arange(W, dtype=I32)[None, :]
    idx0 = j - q
    idx1 = idx0 - 1
    g0 = jnp.take_along_axis(src, jnp.clip(idx0, 0, Ws - 1), axis=1)
    g0 = jnp.where((idx0 >= 0) & (idx0 < Ws), g0, 0)
    g1 = jnp.take_along_axis(src, jnp.clip(idx1, 0, Ws - 1), axis=1)
    g1 = jnp.where((idx1 >= 0) & (idx1 < Ws), g1, 0)
    lo = ushr(g0, r)
    hi = jnp.where(r == 0, 0, shl(g1, (32 - r) & 31))
    return words + lo + hi


def _emit_many(words, base, values, width):
    """Append K fixed-width fields per lane starting at ``base``.

    values: (B, K) int32; width: static int (1..32).  Packs the fields into
    a dense buffer at bit 0 (fixed pattern, no scatter) and blits it at the
    per-lane offset with two gathers — see _pack_fields/_blit_bits.
    """
    if width == 32:
        packed = values
    else:
        packed = _pack_fields(values, width)
    K = values.shape[1]
    return _blit_bits(words, base, packed), base + K * width


def _element_layout(num_channels: int):
    return {
        1: [1], 2: [2], 3: [1, 2], 4: [1, 2, 1], 5: [1, 2, 2],
        6: [1, 2, 2, 1], 7: [1, 2, 2, 1, 1], 8: [1, 2, 2, 2, 1],
    }[num_channels]


_LFE_BITSTREAM_IDX = {6: 5, 7: 6, 8: 7}


@partial(
    jax.jit,
    static_argnames=(
        "frame_length", "num_channels", "depth", "pb", "mb", "kb",
        "elem_specs", "mix_bits_s", "bytes_shifted",
        "use_lfe_tag", "force_escape", "auto_escape",
    ),
)
def encode_walk(
    planes,  # (B, C, F) int32, SMPTE channel order
    ns,  # (B,) int32 samples per packet
    mix_res,  # (B,) int32 per-packet mix_res (0 disables decorrelation)
    coefs_in,  # (E, 32) int32 shared initial coefficients per element
    frame_length, num_channels, depth, pb, mb, kb,
    elem_specs,  # static: per-element (order, den_shift, pb_candidates, mode, fit)
    mix_bits_s, bytes_shifted, use_lfe_tag, force_escape, auto_escape,
):
    """Device-side packet assembly.  Returns (words (B, W) int32 BE, bit_len (B,)).

    Each element is assembled in per-element scratch buffers (one compressed
    candidate per pbFactor, plus verbatim/escape); the smallest (or the
    escape, when residuals are uncodable or escape is forced) is blitted into
    the packet.  The blit is a width-32 scatter-add of the whole scratch:
    trailing zero words add nothing, and later emissions into the same region
    are adds too, so no masking is needed.

    ``elem_specs`` carries one static (order, den_shift, pb_candidates, mode,
    fit) tuple per bitstream element — per-element spec overrides, matching
    the host encoder's EncoderSpec.elements.  mode > 0 is the two-stage
    delta pre-pass (the decoder un-deltas before the LPC walk); multiple
    pb_candidates entropy-encode each channel once per candidate and the
    smallest wins PER LANE (the 3-bit pbFactor field is per channel header).
    """
    F = frame_length
    C = num_channels
    B = planes.shape[0]
    layout = _element_layout(C)
    assert len(elem_specs) == len(layout), (elem_specs, layout)

    def fit_coefs(d, order, den_shift, shared):
        """Per-lane Levinson-Durbin on the post-mix channel data (float32 on
        device; any coefficients are valid — the adaptive decoder walks from
        them — so fp rounding only affects compression, never losslessness).
        Mirrors native/alac_encode.cpp fit_coefs; falls back to the shared
        coefficients for degenerate lanes."""
        idxF = jnp.arange(F, dtype=I32)[None, :]
        valid = idxF < ns[:, None]
        x = jnp.where(valid, d, 0).astype(jnp.float32) * (1.0 / 32768.0)
        mean = jnp.sum(x, 1, keepdims=True) / jnp.maximum(ns[:, None], 1).astype(jnp.float32)
        x = jnp.where(valid, x - mean, 0.0)
        R = [jnp.sum(x * x, 1) * (1.0 + 1e-9) + 1e-30]
        for k in range(1, order + 1):
            R.append(jnp.sum(x[:, k:] * x[:, : F - k], 1))
        a = [jnp.zeros(B, jnp.float32) for _ in range(order + 1)]
        err = R[0]
        ok = R[0] > 1e-20
        for i in range(1, order + 1):
            acc = R[i]
            for j in range(1, i):
                acc = acc - a[j] * R[i - j]
            k_ref = jnp.clip(acc / err, -0.999, 0.999)
            prev = list(a)
            a[i] = k_ref
            for j in range(1, i):
                a[j] = prev[j] - k_ref * prev[i - j]
            err = err * (1.0 - k_ref * k_ref)
            ok = ok & (err > 0.0)
        cols = [
            jnp.clip(jnp.round(a[k + 1] * float(1 << den_shift)), -30000, 30000).astype(I32)
            for k in range(order)
        ] + [jnp.zeros(B, I32)] * (32 - order)
        fitted = jnp.stack(cols, axis=1)
        use = ok & (ns >= 4 * order + 8)
        return jnp.where(use[:, None], fitted, shared)
    offsets = CHANNEL_LAYOUT_OFFSETS[C - 1]
    bs = bytes_shifted if depth >= 24 else 0
    lfe_idx = _LFE_BITSTREAM_IDX.get(C, -1)

    # Tight worst-case sizing.  One entropy-loop iteration always advances
    # the sample cursor and emits at most one sample code (prefix <= 9 plus
    # a suffix <= max(kb, chanBits) — the escape suffix is chanBits wide)
    # and one interleaved zero-run code (prefix <= 9 + 16-bit run escape),
    # so a channel body is <= ns * bps bits.  The verbatim variant is
    # exactly header + ns*nch*depth bits; whenever escape is a candidate
    # (force/auto) the blitted element is no larger than the verbatim one,
    # which keeps the final packet buffer ~4x smaller than the compressed
    # scratch bound.  Oversized zero-tail blits stay safe: _emit/_emit_many
    # clip word indices and the clipped tail words add zeros.
    def _bounds(ei, width_e):
        order_e = elem_specs[ei][0]
        nch_e = 2 if width_e == 2 else 1
        bs_el = max(bs, 1) if (width_e == 2 and depth == 32) else bs
        cb_e = depth - bs_el * 8 + (1 if width_e == 2 else 0)
        bps = 9 + max(kb, cb_e) + 26
        hdr = 64
        esc_bits = hdr + F * nch_e * depth
        comp_bits = (hdr + 16 + nch_e * (24 + 16 * order_e)
                     + F * nch_e * 8 * bs_el + F * nch_e * bps)
        if force_escape or auto_escape:
            chosen_bits = esc_bits
        else:
            chosen_bits = max(esc_bits, comp_bits)
        return bps, comp_bits, esc_bits, chosen_bits

    _elem_bounds = [_bounds(ei, w_e) for ei, w_e in enumerate(layout)]
    W = (sum(b[3] for b in _elem_bounds) + 16) // 32 + 4
    words = jnp.zeros((B, W), I32)
    bitpos = jnp.zeros(B, I32)
    partial_f = ns != F

    def emit_hdr(buf, pos, tag, bs_field, escape_flag):
        """Common element header into a scratch buffer."""
        def emit_all(buf, pos, value, width):
            return _emit(buf, pos, jnp.broadcast_to(jnp.asarray(value, I32), (B,)),
                         jnp.broadcast_to(jnp.asarray(width, I32), (B,)))

        buf, pos = emit_all(buf, pos, tag, 3)
        buf, pos = emit_all(buf, pos, 0, 4)
        buf, pos = emit_all(buf, pos, 0, 12)
        hdr4 = jnp.where(partial_f, 8, 0) + (bs_field << 1) + escape_flag
        buf, pos = _emit(buf, pos, hdr4, jnp.full(B, 4, I32))
        pw = jnp.where(partial_f, 16, 0)
        buf, pos = _emit(buf, pos, ushr(ns, 16), pw)
        buf, pos = _emit(buf, pos, ns & 0xFFFF, pw)
        return buf, pos

    chan = 0
    for ei, width_e in enumerate(layout):
        order, den_shift, pb_cands, mode, fit = elem_specs[ei]
        pair = width_e == 2
        nch = 2 if pair else 1
        if pair and depth == 32:
            bs_e = max(bs, 1)  # avoid degenerate chanBits=33
        else:
            bs_e = bs
        cb = depth - bs_e * 8 + (1 if pair else 0)
        shift_w = bs_e * 8
        tag = 3 if (use_lfe_tag and chan == lfe_idx) else (1 if pair else 0)

        # --- channel data: split shift lows, mix pairs ---
        c0 = planes[:, offsets[chan]]
        if pair:
            c1 = planes[:, offsets[chan] + 1]
        if bs_e:
            h0 = sshr(c0, shift_w)
            l0 = c0 & ((1 << shift_w) - 1)
            if pair:
                h1 = sshr(c1, shift_w)
                l1 = c1 & ((1 << shift_w) - 1)
        else:
            h0 = c0
            if pair:
                h1 = c1

        mr = mix_res if pair else jnp.zeros(B, I32)
        if pair:
            # Inverse of unmix: v = l - r; u = r + ((mix_res * v) >> mix_bits).
            v_mix = h0 - h1  # wrapping int32
            u_mix = h1 + sshr(mr[:, None] * v_mix, mix_bits_s)
            # Overflow guard: decorrelated values must fit cb (encoder
            # convention; see encoder/encode.py).
            lim = jnp.int32(1) << (cb - 1)
            idxF = jnp.arange(F, dtype=I32)[None, :]
            validF = idxF < ns[:, None]
            over = jnp.any(validF & ((u_mix >= lim) | (u_mix < -lim) | (v_mix >= lim) | (v_mix < -lim)), axis=1)
            mr = jnp.where(over, 0, mr)
            u_mix = jnp.where((mr != 0)[:, None], u_mix, h0)
            v_mix = jnp.where((mr != 0)[:, None], v_mix, h1)
            ch_data = (u_mix, v_mix)
        else:
            ch_data = (h0,)

        # --- per-channel coefficients + residuals (and the uncodable gate) ---
        shared_c = jnp.broadcast_to(coefs_in[ei][None, :], (B, 32)).astype(I32)
        if fit and 1 <= order <= 30:
            ch_coefs = [fit_coefs(data, order, den_shift, shared_c) for data in ch_data]
        else:
            ch_coefs = [shared_c for _ in ch_data]
        res_list = []
        bad = jnp.zeros(B, bool)
        for data, ccoef in zip(ch_data, ch_coefs):
            res = _lpc_forward(data, order, den_shift, cb, ns, ccoef, F, mode)
            res_list.append(res)
            if cb >= 32:
                idxF = jnp.arange(F, dtype=I32)[None, :]
                bad = bad | jnp.any((idxF < ns[:, None]) & (res == jnp.int32(-(1 << 31))), axis=1)

        # --- adaptive pbFactor: encode each channel body per candidate into
        # an isolated scratch; the smallest wins per lane (host ties keep the
        # earlier candidate; argmin matches).  Single-candidate elements keep
        # the cheaper in-place emission below.
        bodies = None
        bps_e = _elem_bounds[ei][0]
        if len(pb_cands) > 1:
            Wch = ((F * bps_e + 256) // 32) + 4
            bodies = []
            for res in res_list:
                cbufs, clens = [], []
                for pbf in pb_cands:
                    cbuf, clen = _entropy_body(
                        res, ns, jnp.full(B, (pb * pbf) // 4, I32), cb, mb,
                        kb, Wch,
                    )
                    cbufs.append(cbuf)
                    clens.append(clen)
                lens = jnp.stack(clens, axis=1)  # (B, K)
                best = jnp.argmin(lens, axis=1).astype(I32)
                buf = jnp.take_along_axis(
                    jnp.stack(cbufs), best[None, :, None], axis=0)[0]
                pbf_lane = jnp.asarray(pb_cands, I32)[best]
                bodies.append((buf, jnp.min(lens, axis=1), pbf_lane))

        # --- compressed variant (scratch) ---
        Ws = (_elem_bounds[ei][1] + 31) // 32 + 4
        sc = jnp.zeros((B, Ws), I32)
        sp = jnp.zeros(B, I32)
        sc, sp = emit_hdr(sc, sp, tag, bs_e, 0)

        mbits = jnp.where(mr != 0, mix_bits_s, 0) if pair else jnp.zeros(B, I32)
        sc, sp = _emit(sc, sp, mbits, jnp.full(B, 8, I32))
        sc, sp = _emit(sc, sp, mr & 0xFF, jnp.full(B, 8, I32))

        for ci in range(nch):
            sc, sp = _emit(sc, sp, jnp.full(B, (mode << 4) | den_shift, I32), jnp.full(B, 8, I32))
            if bodies is not None:
                pbf_field = shl(bodies[ci][2], 5) | order
            else:
                pbf_field = jnp.full(B, (pb_cands[0] << 5) | order, I32)
            sc, sp = _emit(sc, sp, pbf_field, jnp.full(B, 8, I32))
            for kcoef in range(order):
                cval = ch_coefs[ci][:, kcoef] & 0xFFFF
                sc, sp = _emit(sc, sp, cval, jnp.full(B, 16, I32))

        if bs_e:
            if pair:
                inter = jnp.stack([l0, l1], axis=2).reshape(B, 2 * F)
                nfields = 2 * F
            else:
                inter = l0
                nfields = F
            sc2, _ = _emit_many(sc, sp, jnp.where(
                jnp.arange(nfields)[None, :] < ns[:, None] * nch, inter, 0), shift_w)
            sc = sc2
            sp = sp + ns * nch * shift_w

        if bodies is not None:
            # Blit each winning body at the current bit position (zero tail
            # words add nothing; same trick as the element blit below).
            for buf, blen, _ in bodies:
                sc, _ = _emit_many(sc, sp, buf, 32)
                sp = sp + blen
        else:
            pb_local = jnp.full(B, (pb * pb_cands[0]) // 4, I32)
            for res in res_list:
                zrun = _zero_run_table(res, ns)
                sc, sp = _entropy_encode(
                    sc, sp, res, zrun, jnp.ones(B, bool), pb_local,
                    jnp.full(B, cb, I32), ns, mb, kb,
                )

        # --- escape (verbatim) variant (scratch) ---
        We = ((F * nch * depth + 256) // 32) + 4
        se = jnp.zeros((B, We), I32)
        sep = jnp.zeros(B, I32)
        se, sep = emit_hdr(se, sep, tag, 0, 1)
        if pair:
            raw = jnp.stack([c0, c1], axis=2).reshape(B, 2 * F)
            nraw = 2 * F
        else:
            raw = c0
            nraw = F
        dmask = -1 if depth >= 32 else (1 << depth) - 1
        se2, _ = _emit_many(se, sep, jnp.where(
            jnp.arange(nraw)[None, :] < ns[:, None] * nch, raw & dmask, 0), depth)
        se = se2
        sep = sep + ns * nch * depth

        # --- choose and blit ---
        if force_escape:
            use_esc = jnp.ones(B, bool)
        elif auto_escape:
            use_esc = bad | (sep < sp)
        else:
            use_esc = bad
        Wmax = max(Ws, We)
        sc_p = jnp.pad(sc, ((0, 0), (0, Wmax - Ws)))
        se_p = jnp.pad(se, ((0, 0), (0, Wmax - We)))
        chosen = jnp.where(use_esc[:, None], se_p, sc_p)
        chosen_len = jnp.where(use_esc, sep, sp)
        words, _ = _emit_many(words, bitpos, chosen, 32)
        bitpos = bitpos + chosen_len
        chan += nch

    # END + byte align
    words, bitpos = _emit(words, bitpos, jnp.full(B, 7, I32), jnp.full(B, 3, I32))
    pad = (8 - (bitpos & 7)) & 7
    words, bitpos = _emit(words, bitpos, jnp.zeros(B, I32), pad)
    return words, bitpos


def encode_packets_device(config: PacketConfig, spec, pcm_list) -> list[bytes]:
    """Encode packets on the device; bit-identical to the Python encoder
    given the same (shared) coefficients.

    ``pcm_list``: list of (ns_i, C) int arrays (one per packet).  Lanes whose
    residuals are uncodable at 32-bit width emit the verbatim (escape)
    element on-device, like the host encoders' fallback.  Per-element
    ``spec.elements`` overrides, mode>0, pb_candidates, and forced escape
    all run on-device; only kb=0 streams (degenerate WB — the entropy loop's
    zero-run k would diverge from the host corner) fall back to the host.
    """
    from ..encoder.encode import encode_packet as host_encode

    if not pcm_list:
        return []
    if config.kb == 0:
        return [host_encode(config, spec, p) for p in pcm_list]

    from .batch import _bucket

    B = len(pcm_list)
    Bb = _bucket(B)  # fixed shape buckets bound recompiles
    F = config.frame_length
    C = config.num_channels
    layout = _element_layout(C)
    el_specs = spec.elements if spec.elements is not None else [spec.channel] * len(layout)
    if len(el_specs) != len(layout):
        raise ValueError(
            f"spec.elements has {len(el_specs)} entries; "
            f"{C}-channel layout has {len(layout)} elements"
        )
    elem_specs = tuple(
        (ch.order, ch.den_shift, tuple(ch.pb_candidates) or (ch.pb_factor,),
         ch.mode, bool(ch.fit and not ch.coefs))
        for ch in el_specs
    )

    planes = np.zeros((Bb, C, F), np.int32)
    ns = np.zeros(Bb, np.int32)
    for i, p in enumerate(pcm_list):
        n = p.shape[0]
        ns[i] = n
        planes[i, :, :n] = np.asarray(p, np.int64).T.astype(np.int32)

    # Fallback coefficients per element (degenerate lanes / fitting off);
    # with fit on and no pinned coefficients, the device re-fits per lane per
    # channel on-chip (Levinson-Durbin inside encode_walk, matching the host
    # encoders).
    offsets = CHANNEL_LAYOUT_OFFSETS[C - 1]
    coefs_arr = np.zeros((len(layout), 32), np.int32)
    chan = 0
    for ei, (w, ch) in enumerate(zip(layout, el_specs)):
        col = offsets[chan]
        cvals = ch.initial_coefs(
            np.asarray(pcm_list[0][:, col], np.int64) if ch.order not in (0, 31) else None
        )
        coefs_arr[ei, : len(cvals)] = cvals
        chan += w

    words, bits = encode_walk(
        jnp.asarray(planes),
        jnp.asarray(ns),
        jnp.full(Bb, spec.mix_res, jnp.int32),
        jnp.asarray(coefs_arr),
        F, C, config.bit_depth, config.pb, config.mb, config.kb,
        elem_specs, max(spec.mix_bits, 0), spec.bytes_shifted,
        spec.use_lfe_tag, bool(spec.escape), bool(spec.auto_escape),
    )
    words = np.asarray(words)
    bits = np.asarray(bits)

    out = []
    be = words.astype(">i4").tobytes()
    row_bytes = words.shape[1] * 4
    for i in range(B):
        nbytes = (int(bits[i]) + 7) // 8
        out.append(be[i * row_bytes : i * row_bytes + nbytes])
    return out
