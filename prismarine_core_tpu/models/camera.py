"""Camera model + primary ray generation.

Replacement for ``ShadersSDK/raytracing/camera.comp``: instead of
unprojecting through inverse view/projection matrices per pixel
(``camera.comp:61-63``), rays are generated directly from a look-at frame —
a fully vectorized, differentiable closed form.  Supports the same feature
set: jittered sub-pixel sampling (``camera.comp:35``), 360 equirect mode
(``camera.comp:48-59``), and thin-lens depth of field (``camera.comp:67-75``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from prismarine_core_tpu.utils import math as pm
from prismarine_core_tpu.utils.config import RenderConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Camera:
    eye: jax.Array      # f32[3]
    target: jax.Array   # f32[3]
    up: jax.Array       # f32[3]
    fov_y: jax.Array    # f32[] vertical field of view, radians

    @staticmethod
    def look_at(eye, target, up=(0.0, 1.0, 0.0), fov_y_deg: float = 60.0):
        return Camera(
            eye=jnp.asarray(eye, jnp.float32),
            target=jnp.asarray(target, jnp.float32),
            up=jnp.asarray(up, jnp.float32),
            fov_y=jnp.asarray(fov_y_deg * jnp.pi / 180.0, jnp.float32),
        )

    def basis(self):
        """Right-handed camera frame: forward, right, up."""
        fwd = pm.normalize(self.target - self.eye)
        right = pm.normalize(jnp.cross(fwd, pm.normalize(self.up)))
        cup = jnp.cross(right, fwd)
        return fwd, right, cup


def tile_order_active(cfg: RenderConfig) -> bool:
    """Whether cfg.primary_tile_order applies (pallas path, divisible
    frame)."""
    return (cfg.primary_tile_order and cfg.intersector == "pallas"
            and cfg.width % 16 == 0 and cfg.height % 8 == 0)


def _tile_pixel_perm_np(w: int, h: int):
    """(perm, inv) numpy pair: lane -> pixel / pixel -> lane for the
    16x8-pixel-tile lane order (pure host-side constants; kept numpy so
    callers inside jit capture them as literals)."""
    import numpy as np
    tw, th = 16, 8
    y = np.arange(h)
    x = np.arange(w)
    yy, xx = np.meshgrid(y, x, indexing="ij")
    key = (((yy // th) * (w // tw) + xx // tw) * (th * tw)
           + (yy % th) * tw + (xx % tw))
    perm = np.empty(h * w, np.int32)
    perm[key.reshape(-1)] = np.arange(h * w, dtype=np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(h * w, dtype=np.int32)
    return perm, inv


def tile_pixel_perm(cfg: RenderConfig) -> jax.Array:
    """Static lane -> pixel map grouping pixels into 16x8-PIXEL tiles
    (row-major tiles, row-major within): each 128-lane packet tile of
    the intersector becomes a compact screen rect instead of a 128x1
    scanline strip (cfg.primary_tile_order).  i32[H*W] constant."""
    return jnp.asarray(_tile_pixel_perm_np(cfg.width, cfg.height)[0])


def tile_pixel_inv_perm(cfg: RenderConfig) -> jax.Array:
    """Inverse of ``tile_pixel_perm``: pixel -> lane, for the one
    per-frame radiance unpermute."""
    return jnp.asarray(_tile_pixel_perm_np(cfg.width, cfg.height)[1])


def generate_rays(
    camera: Camera,
    cfg: RenderConfig,
    cam_samples: jax.Array,   # f32[R, 4]: jitter xy, lens uv
) -> Tuple[jax.Array, jax.Array]:
    """Primary rays for an spp-major image: returns (origins, dirs) f32[R,3]
    with R = spp*H*W laid out as [spp, H, W] flattened (row-major).

    Pixel jitter matches ``camera.comp:35`` (uniform in the pixel footprint,
    clamped away from the borders).  With ``cfg.primary_tile_order``
    lanes map to pixels through the 16x8-tile permutation instead of
    scanline order (the caller unpermutes the radiance once per frame).
    """
    w, h, spp = cfg.width, cfg.height, cfg.spp
    n = spp * h * w
    assert cam_samples.shape[0] == n

    pix = jnp.arange(n, dtype=jnp.int32) % (h * w)
    if tile_order_active(cfg):
        pix = tile_pixel_perm(cfg)[pix]
    px = (pix % w).astype(jnp.float32)
    py = (pix // w).astype(jnp.float32)

    jitter = jnp.clip(cam_samples[:, 0:2], 1e-5, 1.0 - 1e-5)
    # NDC in [0,1]; v flipped so row 0 = top of image.
    u = (px + jitter[:, 0]) / w
    v = (py + jitter[:, 1]) / h

    fwd, right, cup = camera.basis()

    if cfg.camera_360:
        # Equirect: longitude from u, latitude from v (camera.comp:48-54).
        lon = (u * 2.0 - 1.0) * jnp.pi
        lat = (0.5 - v) * jnp.pi
        cl = jnp.cos(lat)
        local = jnp.stack(
            [cl * jnp.sin(lon), jnp.sin(lat), cl * jnp.cos(lon)], axis=-1)
        d = (local[:, 0:1] * right + local[:, 1:2] * cup
             + local[:, 2:3] * fwd)
        o = jnp.broadcast_to(camera.eye, d.shape)
        return o, pm.normalize(d)

    tan_half = jnp.tan(camera.fov_y * 0.5)
    aspect = w / h
    sx = (u * 2.0 - 1.0) * tan_half * aspect
    sy = (1.0 - v * 2.0) * tan_half
    d = pm.normalize(fwd + sx[:, None] * right + sy[:, None] * cup)
    o = jnp.broadcast_to(camera.eye, d.shape)

    if cfg.dof:
        # Thin lens (camera.comp:67-75): offset eye on the aperture disk,
        # aim at the focal point.
        r = jnp.sqrt(cam_samples[:, 2:3]) * cfg.dof_focal_radius
        phi = cam_samples[:, 3:4] * (2.0 * jnp.pi)
        lens = r * (jnp.cos(phi) * right + jnp.sin(phi) * cup)
        focus = o + d * cfg.dof_focus_radius
        o = o + lens
        d = pm.normalize(focus - o)

    return o, d
