"""Generic 30-iteration CORDIC (circular/hyperbolic/linear, rotate/vector).

Equivalent of reference src/cordic.rs:13-107.  The iteration
count and the hyperbolic k -> 3k+1 repeat schedule are static, so the
whole loop unrolls at trace time into 30-34 vectorized iterations; each
iteration is a pair of shifts, adds, and a select — pure elementwise work over
any batch shape.  Used mainly as a validation oracle and for
magnitude/phase where the faster `cossin`/`atan2` paths don't apply.

Phase convention: i32 circle, i32::MIN = -pi (z in units of pi for
circular mode).
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import luts

ROTATE = False
DEROTATE = True
CIRCULAR = 0
HYPERBOLIC = 1
LINEAR = 2

CORDIC_CIRCULAR_GAIN = luts.cordic_circular_gain()
CORDIC_HYPERBOLIC_GAIN = luts.cordic_hyperbolic_gain()


def _cordic(x, y, z, *, vectoring: bool, coord: int, iters: int | None = None):
    x = jnp.asarray(x, dtype=jnp.int32)
    y = jnp.asarray(y, dtype=jnp.int32)
    z = jnp.asarray(z, dtype=jnp.int32)
    table = (
        luts.cordic_circular_table()
        if coord == CIRCULAR
        else luts.cordic_hyperbolic_table()
    )
    n = luts.CORDIC_DEPTH if iters is None else iters
    imin = jnp.int32(-2147483648)

    # Fold the left half-plane into the convergence region.
    left = (x < 0) if vectoring else ((z - (imin >> 1)) < 0)
    x = jnp.where(left, -x, x)
    y = jnp.where(left, -y, y)
    z = jnp.where(left, z - imin, z)

    k = 4
    for idx in range(n):
        a = int(table[idx])
        i = idx
        if coord == LINEAR:
            # 2^-i microrotation, computed not looked up.
            a = jnp.int32(jnp.uint32(0x80000000) >> jnp.uint32(i))
        if coord == HYPERBOLIC:
            i += 1
        repeat = 1
        if coord == HYPERBOLIC and i == k:
            k = 3 * i + 1
            repeat = 2
        for _ in range(repeat):
            lower = (y <= 0) if vectoring else (z >= 0)
            dx = y >> i
            dy = x >> i
            if coord == CIRCULAR:
                x2 = jnp.where(lower, x - dx, x + dx)
            elif coord == HYPERBOLIC:
                x2 = jnp.where(lower, x + dx, x - dx)
            else:
                x2 = x
            y = jnp.where(lower, y + dy, y - dy)
            z = jnp.where(lower, z - jnp.int32(a), z + jnp.int32(a))
            x = x2
    return x, (z if vectoring else y)


def cos_sin(x, y, z):
    """F*(x*cos(z*pi) - y*sin(z*pi)), F*(x*sin(z*pi) + y*cos(z*pi))
    with F = CORDIC_CIRCULAR_GAIN (src/cordic.rs:80-82)."""
    return _cordic(x, y, z, vectoring=ROTATE, coord=CIRCULAR)


def sqrt_atan2(x, y, z):
    """F*sqrt(x^2 + y^2), z + atan2(y, x)/pi (src/cordic.rs:84-87)."""
    return _cordic(x, y, z, vectoring=DEROTATE, coord=CIRCULAR)


def mul(x, y, z):
    """y + x*z (z in Q31) (src/cordic.rs:89-92)."""
    return _cordic(x, y, z, vectoring=ROTATE, coord=LINEAR)[1]


def div(x, y, z):
    """z + y/x (result Q31) (src/cordic.rs:94-97)."""
    return _cordic(x, y, z, vectoring=DEROTATE, coord=LINEAR)[1]


def cosh_sinh(x, y, z):
    """G*(x*cosh z + y*sinh z), G*(x*sinh z + y*cosh z)
    (src/cordic.rs:99-102)."""
    return _cordic(x, y, z, vectoring=ROTATE, coord=HYPERBOLIC)


def sqrt_atanh2(x, y, z):
    """G*sqrt(x^2 - y^2), z + atanh2(y, x) (src/cordic.rs:104-107)."""
    return _cordic(x, y, z, vectoring=DEROTATE, coord=HYPERBOLIC)
