"""GPU kernel for adaptive LPC reconstruction (Pallas, Triton route).

One (packet, channel) lane per thread.  The recurrence is serial in time and
independent per lane, so each program owns a power-of-two block of lanes and
walks the samples in a loop inside the kernel.  A lane's output history and
its adapting coefficients live in registers as lists of per-tap vectors:
the history shift is SSA renaming and costs nothing.  Each step reads one
residual row of the F-major (F, L) planes and writes the reconstructed row
back in place: lanes are contiguous, so both accesses coalesce.

Every lane runs the 32-tap body; taps at or beyond a lane's order are
masked.  Non-FIR lanes (order 0, order 31, escape) are left untouched; the
XLA wrapper in ops/lpc.py prepares them.

Math is ops/lpc.py's XLA scan step for step (predicated sign-walk via
exclusive suffix sums, Go fixed-width semantics — predictor.go:99-682).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .jaxint import I32, sext, sext16, sshr

#: Lanes per program and warps per program (see walk_kernel.LANES; LPC
#: time hardly moves between 16 and 128 lanes as long as each thread owns
#: one lane).
LANES = 32
NUM_WARPS = 1
#: History depth and coefficient slots, as in the (L, 32) coefficient
#: layout (FIR orders go up to 30).
TAPS = 32


def _sel(vs, k):
    """vs[k] for per-lane k (out-of-range k reads as zero)."""
    out = jnp.zeros_like(vs[0])
    for i, v in enumerate(vs):
        out = jnp.where(k == i, v, out)
    return out


def _kernel(
    buf_in_ref, order_ref, den_ref, cb_ref, ns_ref, wrap_ref, fir_ref,
    coef_ref, buf_ref, *, lanes_per_program,
):
    del buf_in_ref  # aliased to buf_ref
    lc = pl.program_id(0) * lanes_per_program + jnp.arange(
        lanes_per_program, dtype=I32
    )
    order = order_ref[lc]
    den = den_ref[lc]
    cb = cb_ref[lc]
    ns = ns_ref[lc]
    wrap16 = wrap_ref[lc] != 0
    is_fir = fir_ref[lc] != 0
    den_half = jnp.where(
        den > 0, jax.lax.shift_left(jnp.ones_like(den), jnp.maximum(den - 1, 0)), 0
    )
    t_end = jnp.max(jnp.where(is_fir, ns, 1))
    out0 = buf_ref[0, lc]

    coefs0 = tuple(coef_ref[k, lc] for k in range(TAPS))
    hist0 = (out0,) + tuple(jnp.zeros_like(out0) for _ in range(TAPS - 1))

    def step(t, carry):
        hist, coefs = carry  # hist[k] = out[t-1-k]
        active = is_fir & (t < ns)
        top = _sel(hist, order)  # out[t-1-order]

        # Prediction (predictor.go:647-656): wrapping int32 dot.
        acc = jnp.zeros_like(top)
        for k in range(TAPS):
            acc = acc + jnp.where(k < order, coefs[k] * (hist[k] - top), 0)
        sum1 = sshr(acc + den_half, den)

        delta = buf_ref[t, lc]
        warm = t <= order
        val = jnp.where(
            warm, sext(delta + hist[0], cb), sext(delta + top + sum1, cb)
        )
        plgpu.store(buf_ref.at[t, lc], val, mask=active)

        # Coefficient adaptation (predictor.go:660-682), predicated walk
        # from tap order-1 down to 0; T is the exclusive suffix sum.
        sign = jnp.sign(delta)
        can = active & (sign != 0) & ~warm
        new = list(coefs)
        T = jnp.zeros_like(top)
        for k in reversed(range(TAPS)):
            on = k < order
            dd = top - hist[k]
            sgn = jnp.sign(dd) * sign
            contrib = jnp.where(on, (order - k) * sshr(sgn * dd, den), 0)
            del0 = delta - T
            run_k = jnp.where(sign > 0, del0 > 0, del0 < 0) & on
            nc = coefs[k] - sgn
            nc = jnp.where(wrap16, sext16(nc), nc)
            new[k] = jnp.where(can & run_k, nc, coefs[k])
            T = T + contrib
        return (val,) + hist[:-1], tuple(new)

    jax.lax.fori_loop(1, t_end, step, (hist0, coefs0))


def lpc_fir_pallas(buf, order, den, cb, ns, wrap16, is_fir, coefs_t, *, interpret=False):
    """Run the FIR recurrence in place on the F-major (F, L) planes.

    ``buf`` holds the residuals of FIR lanes (row 0 is the warm-up sample,
    passed through); rows of other lanes are returned unchanged.  L must be
    a multiple of LANES.  coefs_t: (32, L) initial coefficients, zero beyond
    each lane's order.
    """
    F, L = buf.shape
    assert L % LANES == 0, L
    kernel = functools.partial(_kernel, lanes_per_program=LANES)
    return pl.pallas_call(
        kernel,
        grid=(L // LANES,),
        out_shape=jax.ShapeDtypeStruct((F, L), I32),
        input_output_aliases={0: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="alac_lpc_fir",
    )(
        buf, order, den, cb, ns, wrap16.astype(I32), is_fir.astype(I32),
        coefs_t,
    )
