"""Sphere lights — analog of ``LightUniformStruct``.

The reference models its sun as a sphere positioned at
``normalize(lightVector.xyz) * lightVector.w + lightOffset`` with radius
``lightColor.w`` (``shadinglib.glsl:22-30``); default six identical suns at
direction (0.3, 1, 0.1), distance 400, radius 40, color ~(150,147,143)
(``Pipeline.inl:92-98``).  Lights contribute exclusively through
next-event-estimation shadow rays (``rayshading.comp:121-138`` gates the
light test on RayDL/type so only type-2 shadow rays collect light).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SphereLights:
    center: jax.Array  # f32[L,3]
    radius: jax.Array  # f32[L]
    color: jax.Array   # f32[L,3]  (radiant intensity scale)

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @staticmethod
    def suns(
        directions=((0.3, 1.0, 0.1),),
        distance: float = 400.0,
        radius: float = 40.0,
        color=(150.0 * 255 / 255, 150.0 * 250 / 255, 150.0 * 244 / 255),
    ) -> "SphereLights":
        """Reference-default sun(s) (``Pipeline.inl:92-98``)."""
        dirs = np.asarray(directions, np.float32)
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        n = dirs.shape[0]
        return SphereLights(
            center=jnp.asarray(dirs * distance),
            radius=jnp.full((n,), radius, jnp.float32),
            color=jnp.broadcast_to(
                jnp.asarray(color, jnp.float32), (n, 3)).copy(),
        )

    @staticmethod
    def single(center, radius, color) -> "SphereLights":
        return SphereLights(
            center=jnp.asarray([center], jnp.float32),
            radius=jnp.asarray([radius], jnp.float32),
            color=jnp.asarray([color], jnp.float32),
        )
