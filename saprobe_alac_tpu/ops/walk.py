"""Phase 1: vectorized element walk + adaptive Golomb-Rice entropy decode.

One packet per lane.  The outer loop steps over element slots (static bound
num_channels + EXTRA_SLOTS); each slot parses SCE/LFE/CPE/DSE/FIL/END headers
branchlessly across lanes, then runs the bit-serial entropy loop in lockstep
(a jax.lax.while_loop that ends when every lane finished its channel).

Lanes that hit malformed data set an error code and go inactive; the host
falls back to the scalar oracle for those packets, reproducing the reference's
exact error surface (decoder.go / golomb.go sentinel errors).

Behavioral parity references: decoder.go:133-574 (element dispatch, headers),
golomb.go:112-253 (entropy), bitbuffer.go (cursor semantics).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codec.element import CHANNEL_LAYOUT_OFFSETS
from .jaxint import I32, U32, clz, lg3a, s, sext, sext16, shl, sshr, u, ushr
from .streambits import vread

#: Slots beyond the channel-filling elements, for DSE/FIL/END interleave.
EXTRA_SLOTS = 4

# Error codes (host maps these to the error taxonomy).
ERR_NONE = 0
ERR_OVERRUN = 1  # BitstreamOverrun
ERR_ELEMENT = 2  # UnsupportedElement (CCE/PCE)
ERR_HEADER = 3  # InvalidHeader (nonzero unused bits)
ERR_SHIFT = 4  # InvalidShift (bytesShifted == 3)
ERR_SAMPLES = 5  # SampleOverrun (zero run / partial count out of range)
ERR_SLOTS = 6  # element layout longer than the slot budget
ERR_WIDTH = 7  # chan_bits > 32 (degenerate 32-bit CPE path) -> scalar fallback


class WalkResult(NamedTuple):
    """Per-batch phase-1 outputs (all int32)."""

    res: jnp.ndarray  # (F, C, B) entropy residuals, F-major channel planes
    #                   (the LPC phase consumes (F, C*B) as a free reshape)
    err: jnp.ndarray  # (B,)
    ns: jnp.ndarray  # (B,) decoded samples per packet
    order: jnp.ndarray  # (B, C)
    mode: jnp.ndarray  # (B, C)
    den: jnp.ndarray  # (B, C)
    cb: jnp.ndarray  # (B, C) chan_bits
    bs: jnp.ndarray  # (B, C) bytes shifted (0 for escape)
    esc: jnp.ndarray  # (B, C) escape flag
    esc_base: jnp.ndarray  # (B, C) bit offset of raw escape data
    esc_cb: jnp.ndarray  # (B, C) escape read width
    shift_base: jnp.ndarray  # (B, C) bit offset of the shift region
    coefs: jnp.ndarray  # (B, C, 32)
    mixbits: jnp.ndarray  # (B, C)
    mixres: jnp.ndarray  # (B, C)
    role: jnp.ndarray  # (B, C) 0=mono, 1=pair-U, 2=pair-V
    out_chan: jnp.ndarray  # (B, C) SMPTE output channel index
    filled: jnp.ndarray  # (B, C) 1 if a channel element actually decoded here


#: Register-window geometry for the lockstep entropy loop.  Each while-loop
#: iteration fetches a 512-bit window (two _BLK-word blocks, selected by a
#: masked reduce over the packed words) and then decodes up to _K_MICRO
#: samples from those registers before refilling.  The worst-case sample
#: costs 66 bits (escape codeword 9+32 plus zero-run code 9+16), so a lane
#: keeps decoding while its window offset is <= _NWIN*32-66; typical music
#: residuals are 6-15 bits, so one fetch serves ~20+ samples.  _K_MICRO also
#: amortizes the per-iteration residual scatter.
_BLK = 8
_NWIN = 2 * _BLK
_K_MICRO = 20


def default_impl() -> str:
    """The walk and LPC path for the default backend: the Triton kernels
    (ops/walk_kernel.py, ops/lpc_kernel.py) on a GPU, the lockstep XLA loops
    elsewhere.  ``"interpret"`` runs the kernels in the Pallas interpreter
    (CPU tests); ``"xla"`` forces the plain loops on any backend."""
    return "kernel" if jax.default_backend() == "gpu" else "xla"


def resolve_impl(impl: str | None) -> str:
    impl = default_impl() if impl is None else impl
    if impl not in ("kernel", "interpret", "xla"):
        raise ValueError(f"unknown device impl {impl!r}")
    return impl


#: Bit budget that guarantees one full sample decode from the window.
_WORST_SAMPLE_BITS = 66


def _wsel(arr, j):
    """arr[j] for a list of _NWIN (B,) registers and per-lane j in [0, _NWIN)
    — a log2(_NWIN)-level binary select tree (no memory traffic)."""
    level = list(arr)
    bit = 1
    while len(level) > 1:
        level = [
            jnp.where((j & bit) != 0, level[2 * i + 1], level[2 * i])
            for i in range(len(level) // 2)
        ]
        bit <<= 1
    return level[0]


def _entropy_channel(words, size_bits, bitpos, err, res, active, cur_chan, pb_local, max_size, ns, cfg):
    """Entropy-decode one channel for all active lanes (lockstep while loop).

    Returns (bitpos, err, res).  Residual writes target res[(B, C*F+_K_MICRO)]
    flat; masked micro-steps land in the _K_MICRO dummy tail columns (one per
    micro-step, keeping scatter indices sorted and unique).
    """
    F = cfg["frame_length"]
    kb = cfg["kb"]
    wb = (1 << kb) - 1 if kb < 32 else 0xFFFFFFFF
    mb0 = cfg["mb"]
    CF = res.shape[1] - _K_MICRO  # dummy tail base
    B = bitpos.shape[0]
    lanes = jnp.arange(B)[:, None]
    # Word buckets are multiples of _BLK (bucket floor 16, steps x1.5/x2).
    nblk = words.shape[1] // _BLK
    words_blk = words.reshape(B, nblk, _BLK)
    iota_blk = jnp.arange(nblk, dtype=I32)[None, :]

    # Every iteration decodes >= 1 sample per active lane (the first
    # micro-step's window-budget test always passes: off0 <= 255 <= 446), so
    # F iterations suffice; the guard makes divergence impossible even under
    # bugs/adversarial streams (stuck lanes error out instead of hanging).
    max_iters = F + 4

    def cond(st):
        return jnp.any(st[0]) & (st[7] < max_iters)

    def body(st):
        act, bitpos, err, count, mean, zmode, res, iters = st

        # Window fetch: the two consecutive _BLK-word blocks covering each
        # lane's cursor (block-aligned, so the in-window start offset is
        # bitpos mod 256).  Out-of-range blocks match nothing and read as
        # zero — the same observable behavior as the reference's zero padding
        # (bitbuffer.go:28-32).  Negative bitpos (Go uint32 wrap on
        # adversarial streams) is caught by the in-step overrun guard.
        bi = sshr(bitpos, 8)
        off0 = bitpos & (_BLK * 32 - 1)
        relb = iota_blk - bi[:, None]
        b0 = jnp.sum(jnp.where((relb == 0)[:, :, None], words_blk, 0), axis=1)
        b1 = jnp.sum(jnp.where((relb == 1)[:, :, None], words_blk, 0), axis=1)
        ws = [b0[:, k] for k in range(_BLK)] + [b1[:, k] for k in range(_BLK)]
        wsb = ws[1:] + [jnp.zeros_like(ws[0])]  # word j+1 lookup table

        def win32(off):
            """The true 32 stream bits at window bit-offset ``off`` (int32
            pattern).  Offsets may run past the last fetched word; missing
            low bits read as zero, and every consumer below only uses bits
            that are in range (worst case: the zero-run window's top 25 bits
            at off <= 487, exactly reaching bit 512 of the window)."""
            j = sshr(off, 5)
            r = off & 31
            a = u(_wsel(ws, j))
            b = u(_wsel(wsb, j))
            win = jax.lax.shift_left(a, u(r)) | jax.lax.shift_right_logical(
                jax.lax.shift_right_logical(b, U32(1)), u(31 - r)
            )
            return s(win)

        base = shl(bi, 8)  # wrapping bi*256; base + off reconstructs bitpos

        # Micro-step loop: decode up to _K_MICRO samples from the fetched
        # registers.  A fori_loop (not a Python unroll) keeps the XLA graph —
        # and compile time — O(1) in _K_MICRO; the (K, B) index/value
        # staging buffers are updated with dynamic_update_slice rows, which
        # XLA keeps in place inside loop bodies, then flushed to ``res`` with
        # ONE scatter per outer iteration.
        def micro(k_step, mst):
            act, err, count, mean, zmode, off, idx_buf, val_buf = mst
            live = act & (off <= _NWIN * 32 - _WORST_SAMPLE_BITS)

            # Overrun guard (golomb.go:168-170); negative = Go uint32 wrap.
            curpos = base + off
            over = live & ((curpos >= size_bits) | (curpos < 0))
            err = jnp.where(over, ERR_OVERRUN, err)
            act = act & ~over
            live = live & ~over

            m0 = s(jax.lax.shift_right_logical(u(mean), U32(9)))
            k = jnp.minimum(lg3a(m0), kb)
            m = shl(1, k) - 1

            win = win32(off)
            pre = clz(~win)

            # Escape: prefix >= 9 -> raw max_size bits (golomb.go:184-186).
            is_esc = pre >= 9
            val_esc = ushr(win32(off + 9), 32 - jnp.maximum(max_size, 1))
            bits_esc = 9 + max_size

            # Normal: value from prefix and k-bit remainder (golomb.go:188-201).
            win2 = shl(win, pre + 1)
            v = ushr(win2, 32 - k)  # k=0 gives v=win2 (harmless: k!=1 branch)
            vbig = v >= 2
            val_n = jnp.where(
                k != 1,
                jnp.where(vbig, pre * m + v - 1, pre * m),
                pre,
            )
            bits_n = pre + 1 + jnp.where(k != 1, jnp.where(vbig, k, k - 1), 0)

            value = jnp.where(is_esc, val_esc, val_n)
            nbits = jnp.where(is_esc, bits_esc, bits_n)

            # Signed mapping (golomb.go:206-212), wrapping 32-bit.
            nd = value + zmode
            mult = 1 - 2 * (nd & 1)
            delta = s(jax.lax.shift_right_logical(u(nd + 1), U32(1))) * mult

            # Live samples write their residual slot; masked micro-steps land
            # in the per-step dummy tail (live steps precede dead steps within
            # an iteration, so indices stay sorted & unique for the scatter).
            idx_buf = idx_buf.at[k_step, :].set(jnp.where(live, cur_chan * F + count, CF + k_step))
            val_buf = val_buf.at[k_step, :].set(jnp.where(live, delta, 0))

            count_n = jnp.where(live, count + 1, count)
            off_n = jnp.where(live, off + nbits, off)

            # Adaptive mean (golomb.go:215-218): uint32 wrap arithmetic.
            pbl = u(pb_local)
            mean_n = s(pbl * u(nd) + u(mean) - jax.lax.shift_right_logical(pbl * u(mean), U32(9)))
            mean_n = jnp.where(u(value) > 0xFFFF, 0xFFFF, mean_n)
            mean = jnp.where(live, mean_n, mean)
            zmode = jnp.where(live, 0, zmode)

            # Zero-run mode (golomb.go:223-246); (mean<<2) < 512 unsigned.
            zcond = live & (u(shl(mean, 2)) < 512) & (count_n < ns)
            k32 = jnp.maximum(clz(mean) - 24 + s(jax.lax.shift_right_logical(u(mean + 16), U32(6))), 0)
            mz = (shl(1, k32) - 1) & wb

            zwin = win32(off_n)
            zpre = clz(~zwin)
            z_esc = zpre >= 9
            zval_esc = ushr(shl(zwin, 9), 16)
            zbits_esc = 9 + 16
            zwin2 = shl(zwin, zpre + 1)
            zv = ushr(zwin2, 32 - jnp.maximum(k32, 1))
            zv = jnp.where(k32 == 0, 0, zv)
            zvbig = zv >= 2
            zval_n = jnp.where(zvbig, zpre * mz + zv - 1, zpre * mz)
            zbits_n = zpre + 1 + jnp.where(zvbig, k32, k32 - 1)
            zrun = jnp.where(z_esc, zval_esc, zval_n)
            zbits = jnp.where(z_esc, zbits_esc, zbits_n)

            zover = zcond & (count_n + zrun > ns)
            err = jnp.where(zover, ERR_SAMPLES, err)
            act = act & ~zover
            zcond = zcond & ~zover

            count_n = jnp.where(zcond, count_n + zrun, count_n)
            off_n = jnp.where(zcond, off_n + zbits, off_n)
            zmode = jnp.where(zcond, jnp.where(zrun >= 65535, 0, 1), zmode)
            mean = jnp.where(zcond, 0, mean)

            act = act & (count_n < ns) & (err == ERR_NONE)
            return act, err, count_n, mean, zmode, off_n, idx_buf, val_buf

        mst = (
            act,
            err,
            count,
            mean,
            zmode,
            off0,
            jnp.full((_K_MICRO, B), CF, I32),
            jnp.zeros((_K_MICRO, B), I32),
        )
        act, err, count, mean, zmode, off, idx_buf, val_buf = jax.lax.fori_loop(
            0, _K_MICRO, micro, mst
        )

        # unique_indices holds (live steps write strictly ascending residual
        # slots, dead micro-steps get one distinct dummy-tail column each).
        # indices_are_sorted stays off: each row is ascending but the
        # flattened index set is not.
        res = res.at[lanes, idx_buf.T].set(val_buf.T, unique_indices=True)
        bitpos = base + off
        return act, bitpos, err, count, mean, zmode, res, iters + 1

    init_act = active & (ns > 0) & (err == ERR_NONE)
    state = (
        init_act,
        bitpos,
        err,
        jnp.zeros(B, I32),
        jnp.full(B, mb0, I32),
        jnp.zeros(B, I32),
        res,
        jnp.zeros((), I32),
    )
    act, bitpos, err, count, mean, zmode, res, _ = jax.lax.while_loop(cond, body, state)
    err = jnp.where(act, ERR_OVERRUN, err)  # guard-tripped lanes
    return bitpos, err, res


def _parse_coefs(words, p, num):
    """Read up to 32 int16 coefficients at per-lane positions; returns
    ((B, 32) coefs, new p).

    The 32 fields span <=543 bits from ``p``, so ONE contiguous 18-word
    window per lane covers them all: the window gather touches 3.6x fewer
    elements than a per-field read and the field extraction is static-index
    shifts/selects.  Real encoders sit at orders <= 8 (the reference
    hand-unrolls exactly those, predictor.go:99-618), whose 8 fields + bit
    offset fit a 6-word window — dispatched on-device by a cond on the batch
    max.
    """

    def extract(nwin, ncoef):
        wmax = words.shape[1] - 1
        wb = jax.lax.shift_right_arithmetic(p, 5)  # (B,) base word
        widx = jnp.clip(wb[:, None] + jnp.arange(nwin, dtype=I32)[None, :], 0, wmax)
        win = jnp.take_along_axis(words, widx, axis=1)  # (B, nwin), clamped
        boff = p & 31  # (B,) bit offset of coef 0 inside win[:, 0]
        cols = []
        for j in range(ncoef):
            t = boff + 16 * j  # (B,) absolute bit offset in the window
            k_lo = 16 * j // 32  # static word holding bit 16j at boff=0
            if 16 * j % 32 == 0:
                lo = win[:, k_lo]
                hi = win[:, k_lo + 1]
                sh = u(t & 31)
            else:
                carry = t >= 32 * (k_lo + 1)  # (B,) boff pushed a word over
                lo = jnp.where(carry, win[:, k_lo + 1], win[:, k_lo])
                hi = jnp.where(carry, win[:, k_lo + 2], win[:, k_lo + 1])
                sh = u(t & 31)
            # Zero-guarded 32-bit window, as streambits.window32.
            w32 = jax.lax.shift_left(u(lo), sh) | jax.lax.shift_right_logical(
                jax.lax.shift_right_logical(u(hi), U32(1)), u(31 - s(sh))
            )
            cols.append(sext16(s(jax.lax.shift_right_logical(w32, U32(16)))))
        if ncoef < 32:
            cols.extend([jnp.zeros_like(p)] * (32 - ncoef))
        return jnp.stack(cols, axis=1)  # (B, 32)

    vals = jax.lax.cond(
        jnp.max(num) <= 8,
        lambda: extract(6, 8),
        lambda: extract(18, 32),
    )
    idx = jnp.arange(32, dtype=I32)[None, :]
    coefs = jnp.where(idx < num[:, None], vals, 0)
    return coefs, p + 16 * num


def walk_batch(words, size_bits, frame_length, num_channels, depth, pb, mb, kb, impl=None):
    """Run phase 1 over a packed batch.  Returns WalkResult.

    ``impl`` picks the entropy loop (see :func:`default_impl`); it is a
    static jit argument, so each choice compiles its own executable.
    """
    return _walk_batch(
        words, size_bits, frame_length, num_channels, depth, pb, mb, kb,
        resolve_impl(impl),
    )


@partial(
    jax.jit,
    static_argnames=("frame_length", "num_channels", "depth", "pb", "mb", "kb", "impl"),
)
def _walk_batch(words, size_bits, frame_length, num_channels, depth, pb, mb, kb, impl):
    # The lockstep entropy loop fetches _BLK-word-aligned blocks; zero-pad
    # the word axis up so any caller's W works (production bucketing already
    # rounds, so this concat is a no-op on the hot path).
    if words.shape[1] % _BLK:
        pad = _BLK - words.shape[1] % _BLK
        words = jnp.concatenate([words, jnp.zeros((words.shape[0], pad), words.dtype)], axis=1)
    B_out = words.shape[0]
    if impl != "xla":
        # The kernel's programs own whole blocks of lanes; pad the batch to
        # whole blocks.  Padded lanes have no bits, so they stop at once.
        from .walk_kernel import LANES

        pad = -B_out % LANES
        words = jnp.pad(words, ((0, pad), (0, 0)))
        size_bits = jnp.pad(size_bits, (0, pad))
    B = words.shape[0]
    F = frame_length
    C = num_channels
    cfg = {"frame_length": F, "kb": kb, "mb": mb}
    offsets_table = jnp.asarray(
        np.array(CHANNEL_LAYOUT_OFFSETS[C - 1], dtype=np.int32)
    )

    def zeros_c():
        return jnp.zeros((B, C + 2), I32)

    # Carried state.  The kernel writes residuals straight into the F-major
    # (F, C, B) planes; the lockstep XLA loop keeps the flat (B, C*F + K)
    # buffer its micro-batch scatter writes (K dummy tail columns).
    state = {
        "bitpos": jnp.zeros(B, I32),
        "chan": jnp.zeros(B, I32),
        "done": jnp.zeros(B, bool),
        "err": jnp.zeros(B, I32),
        "ns": jnp.full(B, F, I32),
        "order": zeros_c(),
        "mode": zeros_c(),
        "den": zeros_c(),
        "cb": zeros_c(),
        "bs": zeros_c(),
        "esc": zeros_c(),
        "esc_base": zeros_c(),
        "esc_cb": zeros_c(),
        "shift_base": zeros_c(),
        "coefs": jnp.zeros((B, C + 2, 32), I32),
        "mixbits": zeros_c(),
        "mixres": zeros_c(),
        "role": zeros_c(),
        "out_chan": zeros_c(),
        "filled": zeros_c(),
        "res": (
            jnp.zeros((B, C * F + _K_MICRO), I32)
            if impl == "xla"
            else jnp.zeros((F, C, B), I32)
        ),
    }

    if impl == "xla":
        entropy = partial(_entropy_channel, cfg=cfg)
    else:
        from .walk_kernel import entropy_channel_pallas

        def entropy(words, size_bits, bp, er, rs, act, chan, pb_l, msz, ns):
            return entropy_channel_pallas(
                words, size_bits, bp, er, rs, act, jnp.clip(chan, 0, C - 1),
                pb_l, msz, ns, kb=kb, mb=mb, interpret=impl == "interpret",
            )

    def slot_body(_, st):
        bitpos = st["bitpos"]
        chan = st["chan"]
        err = st["err"]
        ns = st["ns"]

        active = ~st["done"] & (err == ERR_NONE)

        # Past-end check before the tag read (decoder.go:143-145).
        over = active & (sshr(bitpos, 3) >= sshr(size_bits, 3))
        err = jnp.where(over, ERR_OVERRUN, err)
        active = active & ~over

        tag = vread(words, bitpos, 3)
        p0 = bitpos + 3

        is_sce = active & ((tag == 0) | (tag == 3))
        is_cpe_raw = active & (tag == 1)
        cpe_break = is_cpe_raw & (chan + 2 > C)  # goto done (decoder.go:163-165)
        is_cpe = is_cpe_raw & ~cpe_break
        is_dse = active & (tag == 4)
        is_fil = active & (tag == 6)
        is_end = active & (tag == 7)
        is_bad = active & ((tag == 2) | (tag == 5))
        is_elem = is_sce | is_cpe

        err = jnp.where(is_bad, ERR_ELEMENT, err)

        # --- SCE/CPE header + predictor/coef parse, gated: the coef window
        # gathers and ~25 field reads only run on slots where some lane is
        # actually at a channel element.  On END/DSE/FIL-only slots the cond
        # carries ~30 small (B,)-shaped arrays — no residual-buffer traffic.
        def _parse_elem():
            err_l, ns_l = err, ns
            is_sce_l, is_cpe_l = is_sce, is_cpe
            is_elem = is_sce_l | is_cpe_l

            # (decoder.go:210-235 / 348-375)
            unused = vread(words, p0 + 4, 12)
            hdr4 = vread(words, p0 + 16, 4)
            partial = sshr(hdr4, 3)
            bsf = sshr(hdr4, 1) & 3
            escf = hdr4 & 1

            err_l = jnp.where(is_elem & (unused != 0), ERR_HEADER, err_l)
            err_l = jnp.where(is_elem & (bsf == 3), ERR_SHIFT, err_l)
            is_elem = is_elem & (err_l == ERR_NONE)
            is_sce_l = is_sce_l & is_elem
            is_cpe_l = is_cpe_l & is_elem

            p = p0 + 20
            ns_part = s(
                jax.lax.shift_left(u(vread(words, p, 16)), U32(16))
            ) | vread(words, p + 16, 16)
            ns_new = jnp.where(is_elem & (partial == 1), ns_part, ns_l)
            err_l = jnp.where(
                is_elem & ((ns_new > F) | (ns_new < 0)), ERR_SAMPLES, err_l
            )
            is_elem = is_elem & (err_l == ERR_NONE)
            is_sce_l = is_sce_l & is_elem
            is_cpe_l = is_cpe_l & is_elem
            p = p + jnp.where(is_elem & (partial == 1), 32, 0)
            ns_l = jnp.where(is_elem, ns_new, ns_l)

            # chan_bits (decoder.go:230, 371); escape resets (:326, 388).
            cb_comp = depth - bsf * 8 + jnp.where(is_cpe_l, 1, 0)
            esc_cb = jnp.where(is_cpe_l, depth, depth - bsf * 8)
            # chan_bits outside [1, 32] hits degenerate Go shift-saturation
            # paths; flag for exact scalar fallback rather than emulate.
            bad_width = (escf == 0) & ((cb_comp > 32) | (cb_comp < 1))
            bad_width = bad_width | ((escf == 1) & (esc_cb < 1))
            err_l = jnp.where(is_elem & bad_width, ERR_WIDTH, err_l)
            is_elem = is_elem & (err_l == ERR_NONE)
            is_sce_l = is_sce_l & is_elem
            is_cpe_l = is_cpe_l & is_elem

            is_comp = is_elem & (escf == 0)
            is_escape = is_elem & (escf == 1)

            # Mix info + per-channel predictor headers
            mixbits = vread(words, p, 8)
            mixres = sext(vread(words, p + 8, 8), 8)
            pc = p + 16  # compressed lanes pass the mix bytes (SCE reads too)

            b1 = vread(words, pc, 8)
            mode_u = sshr(b1, 4)
            den_u = b1 & 15
            b2 = vread(words, pc + 8, 8)
            pbf_u = sshr(b2, 5)
            num_u = b2 & 31
            coefs_u, p_after_u = _parse_coefs(words, pc + 16, num_u)

            b3 = vread(words, p_after_u, 8)
            mode_v = sshr(b3, 4)
            den_v = b3 & 15
            b4 = vread(words, p_after_u + 8, 8)
            pbf_v = sshr(b4, 5)
            num_v = b4 & 31
            coefs_v, p_after_v = _parse_coefs(words, p_after_u + 16, num_v)

            p_pred = jnp.where(is_cpe_l, p_after_v, p_after_u)

            # Shift region: saved cursor, then skipped (decoder.go:289-293,
            # 453-457).
            shift_base = p_pred
            nch_elem = 1 + jnp.where(is_cpe_l, 1, 0)
            p_ent = p_pred + jnp.where(is_comp, bsf * 8 * nch_elem * ns_l, 0)

            # Escape: raw data begins right after the element header
            esc_base = p
            p_esc_end = p + ns_l * esc_cb * nch_elem
            # Truncated raw region: flag for the oracle's BitstreamOverrun.
            err_l = jnp.where(
                is_escape & (p_esc_end > size_bits), ERR_OVERRUN, err_l
            )
            is_escape = is_escape & (err_l == ERR_NONE)
            is_elem = is_elem & (err_l == ERR_NONE)
            is_comp = is_comp & is_elem
            return (
                err_l, ns_l, is_sce_l & is_elem, is_cpe_l & is_elem, is_comp,
                is_escape, cb_comp, esc_cb, bsf, mixbits, mixres,
                mode_u, den_u, pbf_u, num_u, coefs_u,
                mode_v, den_v, pbf_v, num_v, coefs_v,
                shift_base, esc_base, p_ent, p_esc_end,
            )

        def _no_elem():
            z = jnp.zeros(B, I32)
            zb = jnp.zeros(B, bool)
            zc = jnp.zeros((B, 32), I32)
            return (
                err, ns, zb, zb, zb, zb, z, z, z, z, z,
                z, z, z, z, zc, z, z, z, z, zc, z, z, z, z,
            )

        (
            err, ns, is_sce, is_cpe, is_comp, is_escape, cb_comp, esc_cb,
            bsf, mixbits, mixres, mode_u, den_u, pbf_u, num_u, coefs_u,
            mode_v, den_v, pbf_v, num_v, coefs_v,
            shift_base, esc_base, p_ent, p_esc_end,
        ) = jax.lax.cond(jnp.any(is_elem), _parse_elem, _no_elem)
        is_elem = is_sce | is_cpe
        escf = is_escape.astype(I32)

        # --- DSE/FIL skips, gated the same way (rare elements) ---
        def _parse_skip():
            # DSE (decoder.go:554-574)
            d_align = vread(words, p0 + 4, 1)
            d_cnt = vread(words, p0 + 5, 8)
            d_cnt2 = vread(words, p0 + 13, 8)
            d_has2 = d_cnt == 255
            d_total = d_cnt + jnp.where(d_has2, d_cnt2, 0)
            p_dse = p0 + 5 + 8 + jnp.where(d_has2, 8, 0)
            p_dse = jnp.where(d_align == 1, (p_dse + 7) & ~7, p_dse)
            p_dse = p_dse + d_total * 8
            err_l = jnp.where(
                is_dse & (sshr(p_dse, 3) >= sshr(size_bits, 3)), ERR_OVERRUN, err
            )
            # FIL (decoder.go:538-551)
            f_cnt = vread(words, p0, 4)
            f_has2 = f_cnt == 15
            f_cnt2 = vread(words, p0 + 4, 8)
            f_total = f_cnt + jnp.where(f_has2, f_cnt2 - 1, 0)
            p_fil = p0 + 4 + jnp.where(f_has2, 8, 0) + f_total * 8
            err_l = jnp.where(
                is_fil & (sshr(p_fil, 3) >= sshr(size_bits, 3)), ERR_OVERRUN, err_l
            )
            return p_dse, p_fil, err_l

        p_dse, p_fil, err = jax.lax.cond(
            jnp.any(is_dse | is_fil),
            _parse_skip,
            lambda: (jnp.zeros(B, I32), jnp.zeros(B, I32), err),
        )

        # --- END: byte-align then done (decoder.go:192-195) ---
        p_end = (p0 + 7) & ~7

        # --- Commit positions for non-entropy lanes ---
        new_bitpos = bitpos
        new_bitpos = jnp.where(is_comp, p_ent, new_bitpos)
        new_bitpos = jnp.where(is_escape, p_esc_end, new_bitpos)
        new_bitpos = jnp.where(is_dse & (err == ERR_NONE), p_dse, new_bitpos)
        new_bitpos = jnp.where(is_fil & (err == ERR_NONE), p_fil, new_bitpos)
        new_bitpos = jnp.where(is_end, p_end, new_bitpos)

        # --- Record per-channel metadata ---
        chan_u = jnp.where(is_elem, chan, C)  # dummy column when masked
        chan_v = jnp.where(is_cpe, chan + 1, C)
        out_u = offsets_table[jnp.clip(chan, 0, C - 1)]

        cols_c2 = jnp.arange(C + 2, dtype=I32)[None, :]

        def put(arr, col, val):
            # Masked lanes carry col >= C, landing in the dummy columns.
            # One-hot where instead of .at[].set: the (B, C+2) select fuses
            # with its neighbours, where 17 scatters per slot would not.
            val = jnp.broadcast_to(jnp.asarray(val, arr.dtype), col.shape)
            return jnp.where(col[:, None] == cols_c2, val[:, None], arr)

        st2 = dict(st)
        st2["order"] = put(put(st["order"], chan_u, jnp.where(is_comp, num_u, 0)), chan_v, jnp.where(is_comp, num_v, 0))
        st2["mode"] = put(put(st["mode"], chan_u, jnp.where(is_comp, mode_u, 0)), chan_v, jnp.where(is_comp, mode_v, 0))
        st2["den"] = put(put(st["den"], chan_u, jnp.where(is_comp, den_u, 0)), chan_v, jnp.where(is_comp, den_v, 0))
        st2["cb"] = put(put(st["cb"], chan_u, jnp.where(is_comp, cb_comp, esc_cb)), chan_v, jnp.where(is_comp, cb_comp, esc_cb))
        st2["bs"] = put(put(st["bs"], chan_u, jnp.where(is_comp, bsf, 0)), chan_v, jnp.where(is_comp, bsf, 0))
        st2["esc"] = put(put(st["esc"], chan_u, escf), chan_v, escf)
        st2["esc_base"] = put(put(st["esc_base"], chan_u, esc_base), chan_v, esc_base)
        st2["esc_cb"] = put(put(st["esc_cb"], chan_u, esc_cb), chan_v, esc_cb)
        st2["shift_base"] = put(put(st["shift_base"], chan_u, shift_base), chan_v, shift_base)
        st2["mixbits"] = put(put(st["mixbits"], chan_u, jnp.where(is_cpe & is_comp, mixbits, 0)), chan_v, jnp.where(is_cpe & is_comp, mixbits, 0))
        st2["mixres"] = put(put(st["mixres"], chan_u, jnp.where(is_cpe & is_comp, mixres, 0)), chan_v, jnp.where(is_cpe & is_comp, mixres, 0))
        st2["role"] = put(put(st["role"], chan_u, jnp.where(is_cpe, 1, 0)), chan_v, 2)
        st2["out_chan"] = put(put(st["out_chan"], chan_u, out_u), chan_v, out_u + 1)
        st2["filled"] = put(put(st["filled"], chan_u, 1), chan_v, 1)
        oh_u = (chan_u[:, None] == cols_c2)[:, :, None]  # (B, C+2, 1)
        oh_v = (chan_v[:, None] == cols_c2)[:, :, None]
        coefs = jnp.where(
            oh_u, jnp.where(is_comp[:, None], coefs_u, 0)[:, None, :], st["coefs"]
        )
        coefs = jnp.where(
            oh_v, jnp.where(is_comp[:, None], coefs_v, 0)[:, None, :], coefs
        )
        st2["coefs"] = coefs

        # --- Entropy loops: U then V (order matters: shared bit cursor) ---
        pb_u = (pb * pbf_u) // 4
        pb_v = (pb * pbf_v) // 4
        ent_u = is_comp
        ent_v = is_comp & is_cpe

        res = st["res"]

        def run_u(args):
            bp, er, rs = args
            return entropy(
                words, size_bits, bp, er, rs, ent_u, chan, pb_u, cb_comp, ns
            )

        def run_v(args):
            bp, er, rs = args
            return entropy(
                words, size_bits, bp, er, rs, ent_v, chan + 1, pb_v, cb_comp, ns
            )

        new_bitpos, err, res = jax.lax.cond(
            jnp.any(ent_u), run_u, lambda a: a, (new_bitpos, err, res)
        )
        new_bitpos, err, res = jax.lax.cond(
            jnp.any(ent_v), run_v, lambda a: a, (new_bitpos, err, res)
        )

        # --- Advance channel counter / done flags ---
        chan_new = chan + jnp.where(is_sce, 1, 0) + jnp.where(is_cpe, 2, 0)
        done = st["done"] | is_end | cpe_break | (chan_new >= C)

        st2["bitpos"] = new_bitpos
        st2["chan"] = chan_new
        st2["done"] = done
        st2["err"] = err
        st2["ns"] = ns
        st2["res"] = res
        return st2

    # Early-exit slot loop: a homogeneous batch (the overwhelmingly common
    # case — every lane the same element layout) finishes in as many
    # iterations as it has CHANNEL elements, instead of always paying all
    # C + EXTRA_SLOTS slot bodies (each idle body copies the residual carry
    # through the dispatch conds).  The terminal END tag (decoder.go:192-195)
    # needs no entropy pass, so the cond pre-reads each unfinished lane's
    # 3-bit tag and stops as soon as every one sits on END or past the end —
    # the post-loop pass below commits them.  Lanes still unfinished when the
    # slot budget runs out get ERR_SLOTS below, exactly as with a fixed-trip
    # loop.
    def _slots_cond(carry):
        slot, st = carry
        active = ~st["done"] & (st["err"] == ERR_NONE)
        over = sshr(st["bitpos"], 3) >= sshr(size_bits, 3)
        tag = vread(words, st["bitpos"], 3)
        return (slot < C + EXTRA_SLOTS) & jnp.any(active & ~over & (tag != 7))

    def _slots_body(carry):
        slot, st = carry
        return slot + 1, slot_body(slot, st)

    _, state = jax.lax.while_loop(
        _slots_cond, _slots_body, (jnp.asarray(0, I32), state)
    )

    # Post-loop commit for the lanes the loop left unfinished: past-end
    # before the tag read -> ERR_OVERRUN (decoder.go:143-145); END -> byte
    # align + done (decoder.go:192-195); anything else ran out of slot
    # budget -> ERR_SLOTS.  Pure (B,) work — no kernel, no stack traffic.
    active = ~state["done"] & (state["err"] == ERR_NONE)
    over = active & (sshr(state["bitpos"], 3) >= sshr(size_bits, 3))
    err = jnp.where(over, ERR_OVERRUN, state["err"])
    is_end = active & ~over & (vread(words, state["bitpos"], 3) == 7)
    done = state["done"] | is_end
    err = jnp.where(~done & (err == ERR_NONE), ERR_SLOTS, err)

    if impl == "xla":
        # Normalize the flat lane-major buffer to the F-major plane layout
        # the downstream pipeline consumes.
        res_fcb = state["res"][:, : C * F].reshape(B, C, F).transpose(2, 1, 0)
    else:
        res_fcb = state["res"][:, :, :B_out]  # already (F, C, B)

    lanes = {k: v[:B_out, :C] for k, v in state.items() if k in WalkResult._fields[3:]}
    return WalkResult(res=res_fcb, err=err[:B_out], ns=state["ns"][:B_out], **lanes)
