"""3D Morton codes on uint32 lanes.

Replacement for ``ShadersSDK/include/morton.glsl``: the
reference prefers 64-bit codes (21 bits/axis, ``morton.glsl:37-51``) which
need int64, which JAX disables by default.  We provide:

* ``morton30``: 10 bits/axis packed in one uint32 (``morton.glsl:55-80``'s
  32-bit fallback) — the default BVH build key;
* ``morton60``: 20 bits/axis as a (hi, lo) uint32 pair for scenes dense
  enough to exhaust 10-bit resolution, sorted lexicographically with
  ``lax.sort(num_keys=2)``.
"""

from __future__ import annotations

import jax.numpy as jnp


def _part1by2_10(x):
    """Spread 10 bits: bit i -> bit 3i (uint32)."""
    x = x.astype(jnp.uint32) & 0x3FF
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def morton30(q):
    """q: u32[...,3] with components in [0, 1023] -> u32[...] codes."""
    return (
        _part1by2_10(q[..., 0])
        | (_part1by2_10(q[..., 1]) << 1)
        | (_part1by2_10(q[..., 2]) << 2)
    )


def morton60(q):
    """q: u32[...,3] in [0, 2^20) -> (hi, lo) u32 pair.

    Interleave low and high 10-bit halves separately; (hi, lo) compares
    lexicographically identically to the interleaved 60-bit code.
    """
    lo = morton30(q & 0x3FF)
    hi = morton30((q >> 10) & 0x3FF)
    return hi, lo


def quantize_unit(p, bits: int = 10):
    """Map positions already normalized to the unit cube onto the integer
    lattice [0, 2^bits - 1] (the analog of ``aabbmaker.comp``'s unit-cube
    transform, ``TriangleHierarchy.inl:257-267``)."""
    scale = float((1 << bits) - 1)
    q = jnp.clip(p, 0.0, 1.0) * scale
    return q.astype(jnp.uint32)
