"""Small vector-math helpers used across the JAX compute path.

Analog of the reference's GLSL math library
(``ShadersSDK/include/mathlib.glsl``): everything operates on batched
``[..., 3]`` arrays, is branch-free, and is safe under jit/vmap/grad.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a, b, keepdims: bool = False):
    """Batched vec3 dot product over the last axis."""
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def length(v, keepdims: bool = False):
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 1e-30))


def normalize(v):
    return v / length(v, keepdims=True)


def reflect(d, n):
    """GLSL reflect: d - 2*dot(d,n)*n (d points *into* the surface)."""
    return d - 2.0 * dot(d, n, keepdims=True) * n


def refract(d, n, eta):
    """GLSL refract. Returns zero vector on total internal reflection.

    Divergence from the GLSL contract: at exactly k == 0 (grazing
    critical angle) GLSL returns the tangent direction while this
    returns zero — the k <= 0 boundary is deliberate so TIR lanes keep
    finite gradients (measure-zero in the transport integral).
    """
    cosi = dot(n, d, keepdims=True)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    # select-before-sqrt (see ops/intersect.py intersect_sphere): keeps
    # TIR lanes' gradients finite.
    refr = eta * d - (
        eta * cosi + jnp.sqrt(jnp.where(k > 0.0, k, 1.0))) * n
    return jnp.where(k <= 0.0, jnp.zeros_like(d), refr)


def faceforward(n, i):
    """Flip ``n`` to oppose incident direction ``i`` (GLSL faceforward)."""
    return jnp.where(dot(n, i, keepdims=True) < 0.0, n, -n)


def orthonormal_basis(n):
    """Tangent frame around normal ``n``.

    Uses the reference's axis-pick rule (``random.glsl:53-61``): choose the
    coordinate axis least aligned with ``n``, then two cross products.  The
    numpy oracle implements the identical rule so sampled directions match.
    """
    sqrt_third = 0.57735026  # sqrt(1/3), random.glsl SQRT_OF_ONE_THIRD
    ax = jnp.abs(n[..., 0:1]) < sqrt_third
    ay = jnp.abs(n[..., 1:2]) < sqrt_third
    ex = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], n.dtype), n.shape)
    ey = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], n.dtype), n.shape)
    ez = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], n.dtype), n.shape)
    perp0 = jnp.where(ax, ex, jnp.where(ay, ey, ez))
    t = normalize(cross(n, perp0))
    b = cross(n, t)
    return t, b


def luminance_length(c):
    """The reference's ``mlength`` = plain vector length of an RGB triple."""
    return length(c)


def mix(a, b, t):
    return a + (b - a) * t


def safe_rcp(x, eps: float = 1e-12):
    """Reciprocal with sign-preserving clamp away from zero."""
    return 1.0 / jnp.where(jnp.abs(x) < eps, jnp.where(x < 0, -eps, eps), x)
