"""Monte-Carlo sampling primitives + counter-based sample generation.

Replaces the reference's hash-RNG (``ShadersSDK/include/random.glsl``) with
the idiomatic JAX design: *explicit* uniform sample arrays generated once
per frame from a threefry key.  The integrator is a deterministic function
``render(scene, rays, samples)`` — the same sample arrays drive both the
JAX path and the numpy oracle, so correctness tests compare images
sample-for-sample instead of only statistically.

Sample slot layout, consumed per bounce (see render/integrator.py):
  0: alpha-transmission coin     (rayshading.comp:180  "aprom")
  1: diffuse/specular coin       (rayshading.comp:267  random() < spca)
  2: cosine-hemisphere u1        (random.glsl:49)
  3: cosine-hemisphere u2 / azimuth
  4: glossy perturbation u       (shadinglib.glsl:140  refly * random())
  5: light sphere-point u1       (random.glsl:72-75)
  6: light sphere-point u2
  7: reserved (russian roulette / light selection)
  8: environment NEE u1          (cfg.env_nee; models/textures.py)
  9: environment NEE u2
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from prismarine_core_tpu.utils import math as pm
from prismarine_core_tpu.utils.config import (
    SAMPLES_PER_BOUNCE, SAMPLES_PER_CAMERA_RAY)

# slot indices
(S_ALPHA, S_SPEC, S_COS1, S_COS2, S_GLOSS, S_LIGHT1, S_LIGHT2, S_RESERVED,
 S_ENV1, S_ENV2, S_RR) = range(11)


def make_sample_arrays(key: jax.Array, n_rays: int, max_bounces: int):
    """Uniforms for one frame: (cam f32[R,4], bounce f32[B,R,10])."""
    k1, k2 = jax.random.split(key)
    cam = jax.random.uniform(k1, (n_rays, SAMPLES_PER_CAMERA_RAY))
    bounce = jax.random.uniform(
        k2, (max_bounces, n_rays, SAMPLES_PER_BOUNCE))
    return cam, bounce


def make_coherent_sample_arrays(key: jax.Array, cfg, block=(8, 16)):
    """Tile-correlated frame uniforms (coherent path tracing, Sadeghi
    et al. 2009): every ray in an ``block``-pixel screen block (per spp
    plane) shares the SAME bounce-sample rows, so secondary rays leave
    nearby surface points in nearly identical directions and sort into
    direction-tight packets — bounce queries approach primary-ray
    coherence.  Camera jitter stays independent per ray.

    Per-pixel expectations are unchanged (each pixel still sees uniform
    samples), so the estimator remains unbiased; the correlation only
    adds cross-pixel covariance *within a frame*, which the progressive
    accumulator averages out across frames (fresh key per frame).

    Returns (cam f32[R,4], bounce f32[B,R,10]) with the ray layout of
    ``generate_rays`` (R = spp*H*W, [spp, H, W] row-major).
    """
    k1, k2 = jax.random.split(key)
    cam = jax.random.uniform(k1, (cfg.n_rays, SAMPLES_PER_CAMERA_RAY))
    bh, bw = block
    nby = -(-cfg.height // bh)
    nbx = -(-cfg.width // bw)
    ub = jax.random.uniform(
        k2, (cfg.max_bounces, cfg.spp, nby * nbx, SAMPLES_PER_BOUNCE))
    by = jnp.arange(cfg.height, dtype=jnp.int32) // bh
    bx = jnp.arange(cfg.width, dtype=jnp.int32) // bw
    bid = (by[:, None] * nbx + bx[None, :]).reshape(-1)   # [H*W]
    from prismarine_core_tpu.models.camera import (tile_order_active,
                                                   tile_pixel_perm)
    if tile_order_active(cfg):
        # lanes map to pixels through the 16x8-tile permutation; the
        # block id must follow the lane's PIXEL so correlation blocks
        # stay screen rects
        bid = bid[tile_pixel_perm(cfg)]
    bounce = ub[:, :, bid, :].reshape(
        cfg.max_bounces, cfg.n_rays, SAMPLES_PER_BOUNCE)
    return cam, bounce


def cosine_hemisphere(n, u1, u2):
    """Cosine-weighted hemisphere around normals ``n`` f32[R,3].

    Matches ``randomCosine`` (``random.glsl:48-68``): up=sqrt(u1),
    sideways magnitude sqrt(1-u1), azimuth 2*pi*u2, tangent frame from the
    least-aligned coordinate axis.
    """
    up = jnp.sqrt(u1)[..., None]
    over = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))[..., None]  # 1 - up^2
    around = (u2 * 2.0 * jnp.pi)[..., None]
    t, b = pm.orthonormal_basis(n)
    return pm.normalize(
        n * up + t * jnp.cos(around) * over + b * jnp.sin(around) * over)


def uniform_sphere(u1, u2):
    """Uniform direction on the unit sphere (``random.glsl:71-76``)."""
    up = u1 * 2.0 - 1.0
    over = jnp.sqrt(jnp.maximum(1.0 - up * up, 0.0))
    around = u2 * 2.0 * jnp.pi
    return jnp.stack(
        [up, jnp.cos(around) * over, jnp.sin(around) * over], axis=-1)


def light_sampling_weight(ldir, n, radius, dist):
    """The reference's sphere-light weight heuristic
    (``shadinglib.glsl:50-52``):
    ``1 - sqrt(1 - clamp(dot(l,n) * 2 * (r/d)^2, 0, 1))``."""
    c = jnp.clip(
        pm.dot(ldir, n) * 2.0 * (radius / jnp.maximum(dist, 1e-6)) ** 2,
        0.0, 1.0)
    # sqrt is guarded away from 0: at c == 1 the raw form's derivative is
    # -inf, and clip's zero cotangent times inf poisons vertex gradients
    # with NaN (0 * inf) for any hit point close to the light sphere.
    # Value change <= 1e-6.
    return 1.0 - jnp.sqrt(jnp.maximum(1.0 - c, 1e-12))
