"""Triangle geometry: the scene data model.

The reference stores triangles in "mosaic" RGBA32F textures written by an
accessor-based vertex-pulling kernel (``ShadersSDK/vertex/loader.comp:32-152``,
``Include/Prismarine/VertexInstance.hpp:37-79``).  In JAX the idiomatic
equivalent is a padded structure-of-arrays triangle soup with static shapes:
fixed capacity, a validity mask for padding, and all per-vertex attributes
as dense ``f32[T, ...]`` arrays that shard cleanly over a device mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TriangleSoup:
    """Padded SoA triangle soup (all arrays share leading dim T).

    Replaces the reference's mosaic textures + material-id SSBO
    (``vertex.glsl:17-37``, binding 10).  ``valid`` masks padding lanes the
    way the reference's triangle counter bounds its dispatches.
    """

    v0: jax.Array  # f32[T,3] vertex positions
    v1: jax.Array
    v2: jax.Array
    n0: jax.Array  # f32[T,3] shading normals
    n1: jax.Array
    n2: jax.Array
    t0: jax.Array  # f32[T,2] texcoords
    t1: jax.Array
    t2: jax.Array
    mat_id: jax.Array  # i32[T]
    valid: jax.Array   # bool[T]

    @property
    def capacity(self) -> int:
        return self.v0.shape[0]

    def num_valid(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32))

    # -- constructors -----------------------------------------------------

    @staticmethod
    def from_arrays(
        vertices: np.ndarray,          # f32[V,3]
        faces: np.ndarray,             # i32[F,3]
        normals: np.ndarray | None = None,    # f32[V,3]
        texcoords: np.ndarray | None = None,  # f32[V,2]
        mat_ids: np.ndarray | None = None,    # i32[F]
        capacity: int | None = None,
    ) -> "TriangleSoup":
        """Build from an indexed mesh; computes smooth/face normals if absent.

        The indexed→soup expansion replaces the reference's vertex-pulling
        kernel (``loader.comp:72-151``) — here we expand once at load time
        rather than per frame, because the soup layout is what traversal and
        gradient kernels want resident in device memory.
        """
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        nf = faces.shape[0]
        if normals is None:
            normals = _smooth_vertex_normals(vertices, faces)
        if texcoords is None:
            texcoords = np.zeros((vertices.shape[0], 2), np.float32)
        if mat_ids is None:
            mat_ids = np.zeros((nf,), np.int32)
        cap = capacity or nf
        assert cap >= nf, f"capacity {cap} < {nf} triangles"

        def pad3(x):
            out = np.zeros((cap, x.shape[1]), np.float32)
            out[:nf] = x
            return out

        f0, f1, f2 = faces[:, 0], faces[:, 1], faces[:, 2]
        valid = np.zeros((cap,), bool)
        valid[:nf] = True
        mid = np.zeros((cap,), np.int32)
        mid[:nf] = mat_ids
        return TriangleSoup(
            v0=jnp.asarray(pad3(vertices[f0])),
            v1=jnp.asarray(pad3(vertices[f1])),
            v2=jnp.asarray(pad3(vertices[f2])),
            n0=jnp.asarray(pad3(normals[f0])),
            n1=jnp.asarray(pad3(normals[f1])),
            n2=jnp.asarray(pad3(normals[f2])),
            t0=jnp.asarray(pad3(texcoords[f0])[:, :2].reshape(cap, 2)),
            t1=jnp.asarray(pad3(texcoords[f1])[:, :2].reshape(cap, 2)),
            t2=jnp.asarray(pad3(texcoords[f2])[:, :2].reshape(cap, 2)),
            mat_id=jnp.asarray(mid),
            valid=jnp.asarray(valid),
        )

    @staticmethod
    def from_corners(v0, v1, v2, n0, n1, n2, t0, t1, t2, mat_ids,
                     capacity: int | None = None) -> "TriangleSoup":
        """Build directly from per-corner arrays (native loader path)."""
        nf = len(v0)
        cap = capacity or nf
        assert cap >= nf

        def pad(x, w):
            out = np.zeros((cap, w), np.float32)
            out[:nf] = x
            return jnp.asarray(out)

        valid = np.zeros((cap,), bool)
        valid[:nf] = True
        mid = np.zeros((cap,), np.int32)
        mid[:nf] = mat_ids
        return TriangleSoup(
            v0=pad(v0, 3), v1=pad(v1, 3), v2=pad(v2, 3),
            n0=pad(n0, 3), n1=pad(n1, 3), n2=pad(n2, 3),
            t0=pad(t0, 2), t1=pad(t1, 2), t2=pad(t2, 2),
            mat_id=jnp.asarray(mid), valid=jnp.asarray(valid),
        )

    @staticmethod
    def concatenate(soups: list["TriangleSoup"]) -> "TriangleSoup":
        return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *soups)

    def transformed(self, matrix: jax.Array) -> "TriangleSoup":
        """Apply a 4x4 transform (positions) + inverse-transpose (normals).

        Replaces the per-mesh ``MeshUniformStruct.transform`` applied by the
        loader kernel (``loader.comp:96-108``).
        """
        m = jnp.asarray(matrix, jnp.float32)
        nrm_m = jnp.linalg.inv(m[:3, :3]).T

        def xp(p):
            return p @ m[:3, :3].T + m[:3, 3]

        def xn(n):
            out = n @ nrm_m.T
            return out / jnp.maximum(
                jnp.linalg.norm(out, axis=-1, keepdims=True), 1e-12)

        return dataclasses.replace(
            self,
            v0=xp(self.v0), v1=xp(self.v1), v2=xp(self.v2),
            n0=xn(self.n0), n1=xn(self.n1), n2=xn(self.n2),
        )


def _smooth_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (numpy, load-time only)."""
    fn = np.cross(
        vertices[faces[:, 1]] - vertices[faces[:, 0]],
        vertices[faces[:, 2]] - vertices[faces[:, 0]],
    )
    out = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(out, faces[:, k], fn)
    n = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(n, 1e-12)).astype(np.float32)


# -- procedural geometry builders (test scenes) ---------------------------

def make_quad(p0, p1, p2, p3, mat_id=0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two triangles for quad p0-p1-p2-p3 (counter-clockwise)."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    mids = np.full((2,), mat_id, np.int32)
    return verts, faces, mids


def make_box(lo, hi, mat_id=0, inward=False, skip_faces=()):
    """Axis-aligned box as 12 triangles; ``inward=True`` flips winding
    (for Cornell-style room interiors).  ``skip_faces`` drops named faces
    ("back","front","floor","ceiling","left","right")."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    corners = np.asarray([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ], np.float32)
    # Each face counter-clockwise seen from outside.
    quads = {
        "back": (0, 3, 2, 1),     # z = z0
        "front": (4, 5, 6, 7),    # z = z1
        "floor": (0, 1, 5, 4),    # y = y0
        "ceiling": (3, 7, 6, 2),  # y = y1
        "left": (0, 4, 7, 3),     # x = x0
        "right": (1, 2, 6, 5),    # x = x1
    }
    faces = []
    for name, (a, b, c, d) in quads.items():
        if name in skip_faces:
            continue
        if inward:
            faces += [[a, c, b], [a, d, c]]
        else:
            faces += [[a, b, c], [a, c, d]]
    faces = np.asarray(faces, np.int64)
    mids = np.full((len(faces),), mat_id, np.int32)
    return corners, faces, mids


def merge_meshes(parts):
    """Concatenate (verts, faces, mat_ids) triples into one indexed mesh."""
    verts, faces, mids = [], [], []
    off = 0
    for v, f, m in parts:
        verts.append(v)
        faces.append(np.asarray(f) + off)
        mids.append(m)
        off += len(v)
    return (np.concatenate(verts), np.concatenate(faces), np.concatenate(mids))
