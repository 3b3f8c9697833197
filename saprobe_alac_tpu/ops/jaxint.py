"""Vectorized fixed-width integer helpers with Go shift semantics (JAX).

Mirror of codec/intops.py for traced arrays.  All values are int32 bit
patterns: int32 add/sub/mul wrap two's complement exactly like Go's uint32
and int32, and logical shifts act on the bits whatever the signedness.  The
helpers use int32 operations only, so the same code traces inside the GPU
kernels (ops/walk_kernel.py, ops/lpc_kernel.py) and in plain XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

I32 = jnp.int32
U32 = jnp.uint32


def u(x):
    """Bitcast int32 -> uint32."""
    return jax.lax.bitcast_convert_type(x.astype(I32), U32)


def s(x):
    """Bitcast uint32 -> int32."""
    return jax.lax.bitcast_convert_type(x.astype(U32), I32)


def shl(x, n):
    """Go ``<< n`` on 32-bit values; n >= 32 yields 0.  n may be traced."""
    n = jnp.asarray(n, I32)
    nc = jnp.minimum(n, 31)
    return jnp.where(n >= 32, 0, jax.lax.shift_left(jnp.asarray(x, I32), nc))


def ushr(x, n):
    """Go unsigned ``>> n``; n >= 32 yields 0."""
    n = jnp.asarray(n, I32)
    nc = jnp.minimum(n, 31)
    return jnp.where(n >= 32, 0, jax.lax.shift_right_logical(jnp.asarray(x, I32), nc))


def sshr(x, n):
    """Go signed arithmetic ``>> n``; n >= 32 yields sign fill."""
    x = jnp.asarray(x, I32)
    n = jnp.asarray(n, I32)
    nc = jnp.minimum(n, 31)
    return jax.lax.shift_right_arithmetic(x, jnp.where(n >= 32, 31, nc))


def sext(x, bits):
    """Go ``(x << (32-bits)) >> (32-bits)`` with uint32 shift-count underflow
    semantics (bits > 32 saturates both shifts -> 0)."""
    cs = jnp.asarray(32 - jnp.asarray(bits, I32), I32)
    # bits > 32 -> cs negative -> Go uint32 shift count is huge -> result 0.
    cs_huge = cs < 0
    cs_c = jnp.where(cs_huge, 32, cs)
    return jnp.where(cs_huge, 0, sshr(shl(x, cs_c), cs_c))


def sext16(x):
    """Wrap to signed 16-bit."""
    return sshr(shl(x, 16), 16)


def clz(x):
    """Leading zeros of the 32-bit pattern."""
    return jax.lax.clz(jnp.asarray(x, I32))


def lg3a(x):
    """floor(log2(x+3)) (reference golomb.go:74-76)."""
    return 31 - clz(jnp.asarray(x, I32) + 3)
