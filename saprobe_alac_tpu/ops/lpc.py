"""Phase 2: adaptive LPC reconstruction, vectorized over (packet, channel) lanes.

The recurrence is strictly serial per channel — out[i] depends on
out[i-1..i-order] AND on coefficients mutated at every prior sample — so it
cannot be an associative scan (SURVEY §2.3).  Parallelism comes from lanes:
L = batch * channels sequences advance in lockstep through one
jax.lax.fori_loop over samples.

The per-sample coefficient sign-walk with early exit (predictor.go:660-682)
becomes predicated arithmetic: tap contributions don't depend on the mutated
coefficients, so the walk's stop condition is evaluated from an exclusive
suffix-sum of contributions and every tap update is applied under a mask.

Special modes handled vectorially outside the loop:
  order 0  -> copy;  order 31 -> delta decode = wrapping cumsum + sign-extend
  mode > 0 -> delta pre-pass over the residuals (same cumsum identity:
              sext(sext(a)+b) == sext(a+b) mod 2^chan_bits)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .jaxint import I32, s, sext, sext16, sshr, u
from .walk import resolve_impl

#: Orders whose reference kernels keep int32 (non-wrapping) coef accumulation
#: (predictor.go:99-618); all other orders wrap coefs to int16 per step.
_INT32_ORDERS = (4, 5, 6, 8)


def delta_decode(res_t, chan_bits, ns):
    """First-order delta decode: out[i] = sext(cumsum(res)[i]) for i >= 1.

    res_t: (F, L) int32 F-major; chan_bits, ns: (L,).  Rows at i >= ns are
    garbage (masked later).  out[0] = res[0] unsexted (predictor.go:53).
    """
    csum = jnp.cumsum(res_t.astype(jnp.uint32), axis=0).astype(jnp.int32)
    out = sext(csum, chan_bits[None, :])
    return jnp.where(jnp.arange(res_t.shape[0])[:, None] == 0, res_t, out)


def lpc_batch(res_t, order, mode, den, cb, ns, coefs, frame_length, impl=None):
    """Unjitted wrapper resolving ``impl`` (see ops/walk.default_impl)."""
    return _lpc_batch(
        res_t, order, mode, den, cb, ns, coefs, frame_length, resolve_impl(impl)
    )


@partial(jax.jit, static_argnames=("frame_length", "impl"))
def _lpc_batch(res_t, order, mode, den, cb, ns, coefs, frame_length, impl):
    """Reconstruct samples from residuals for all lanes.

    res_t: (F, L) int32 entropy residuals, F-major (escape lanes hold raw
           samples and have order == 0).
    order, mode, den, cb, ns: (L,) int32.
    coefs: (L, 32) int32 (int16 range), zero beyond each lane's order.

    Returns (F, L) int32 reconstructed channel samples, same layout.
    """
    F = frame_length
    L = order.shape[0]

    # Two-stage mode: delta pre-pass over the stream residuals
    # (decoder.go:307-309: UnpcBlock in-place with order 31), skipped when
    # no lane needs it — real encoders emit mode == 0.
    res_t = jax.lax.cond(
        jnp.any(mode != 0),
        lambda r: jnp.where((mode != 0)[None, :], delta_decode(r, cb, ns), r),
        lambda r: r,
        res_t,
    )

    # Vectorized special orders.
    is_delta = order == 31
    is_fir = (order >= 1) & (order <= 30)

    wrap16 = jnp.ones(L, dtype=bool)
    for o in _INT32_ORDERS:
        wrap16 = wrap16 & (order != o)

    out0_t = jax.lax.cond(
        jnp.any(is_delta),
        lambda r: jnp.where(is_delta[None, :], delta_decode(r, cb, ns), r),
        lambda r: r,
        res_t,
    )

    if impl != "xla":
        from .lpc_kernel import LANES, lpc_fir_pallas

        # Whole blocks of lanes for the kernel's programs; padded lanes are
        # not FIR lanes, so the kernel leaves them alone.
        pad = -L % LANES

        def padl(x):
            return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

        out = lpc_fir_pallas(
            jnp.pad(out0_t, ((0, 0), (0, pad))), padl(order), padl(den),
            padl(jnp.clip(cb, 1, 32)), padl(ns), padl(wrap16), padl(is_fir),
            padl(coefs).T, interpret=impl == "interpret",
        )
        return out[:, :L]

    # den in [0,15]: den_half = 1 << (den-1) for den > 0 (predictor.go:48-51).
    den_half = jnp.where(
        den > 0, s(jax.lax.shift_left(u(jnp.ones(L, I32)), u(jnp.maximum(den - 1, 0)))), 0
    )

    # --- XLA scan: lane-major internally ---
    res = res_t.T
    out0 = out0_t.T

    # FIR lanes run the serial scan.  History is kept in a left-padded buffer
    # so the 32-wide window slice never needs branching.
    PAD = 32
    outP = jnp.zeros((L, PAD + F), I32)
    outP = jax.lax.dynamic_update_slice(outP, out0, (0, PAD))

    tap_idx = jnp.arange(32, dtype=I32)[None, :]  # k
    weight = order[:, None] - tap_idx  # adaptation weight for tap k
    tap_mask = tap_idx < order[:, None]

    any_fir = jnp.any(is_fir)

    def scan_body(t, carry):
        outP, coefs = carry
        active = is_fir & (t < ns)

        # W[:, j] = out[t-32+j]; reversed: WR[:, k] = out[t-1-k], k in [0,31].
        W = jax.lax.dynamic_slice(outP, (0, t), (L, PAD))
        WR = W[:, ::-1]
        top = jnp.take_along_axis(WR, order[:, None], axis=1)[:, 0]  # out[t-1-order]

        # Prediction (predictor.go:647-656): wrapping int32 dot.
        acc = jnp.sum(coefs * (WR - top[:, None]) * tap_mask, axis=1, dtype=I32)
        sum1 = sshr(acc + den_half, den)

        delta = jax.lax.dynamic_slice(res, (0, t), (L, 1))[:, 0]
        warm = t <= order
        prev = WR[:, 0]
        fir_val = sext(delta + top + sum1, cb)
        warm_val = sext(delta + prev, cb)
        val = jnp.where(warm, warm_val, fir_val)

        cur = jax.lax.dynamic_slice(outP, (0, PAD + t), (L, 1))[:, 0]
        newcol = jnp.where(active, val, cur)
        outP = jax.lax.dynamic_update_slice(outP, newcol[:, None], (0, PAD + t))

        # Coefficient adaptation (predictor.go:660-682), predicated walk.
        sign = jnp.sign(delta)
        dd = top[:, None] - WR  # dd_k = top - out[t-1-k]
        sgn = jnp.sign(dd) * sign[:, None]
        contrib = weight * sshr(sgn * dd, den[:, None])  # int32 wrap
        contrib = jnp.where(tap_mask, contrib, 0)
        # Exclusive suffix sum: T_k = sum of contribs for taps > k
        # (walk order is k = order-1 down to 0).
        suffix_inc = jnp.cumsum(contrib[:, ::-1].astype(jnp.uint32), axis=1)[:, ::-1].astype(I32)
        T = suffix_inc - contrib
        # Tap k executes iff every earlier step left del0 on sign's side of 0
        # (branch-exact: avoid sign*x, which wraps at INT32_MIN).
        del0 = delta[:, None] - T
        run = jnp.where(sign[:, None] > 0, del0 > 0, del0 < 0) & tap_mask
        adapt = active[:, None] & (sign != 0)[:, None] & ~warm[:, None] & run
        newc = coefs - sgn
        newc = jnp.where(wrap16[:, None], sext16(newc), newc)
        coefs = jnp.where(adapt, newc, coefs)

        return outP, coefs

    def run_scan(args):
        outP, coefs = args
        return jax.lax.fori_loop(1, F, scan_body, (outP, coefs))

    outP, _ = jax.lax.cond(any_fir, run_scan, lambda a: a, (outP, coefs))

    return jax.lax.dynamic_slice(outP, (0, PAD), (L, F)).T
