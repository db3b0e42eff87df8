"""Wavefront OBJ/MTL ingest.

The geometry-ingest layer (reference analog: tinygltf/tiny_obj_loader
usage in ``Source/Examples/Viewer.cpp:66-227`` + the vertex-pulling
kernel).  Pure numpy at load time; emits the padded TriangleSoup +
MaterialTable the device pipeline consumes.

Supported: v/vn/vt, polygonal ``f`` with triangle-fan splitting, negative
indices, usemtl/mtllib, quads (the reference's loader.comp also handles
quads, ``loader.comp:72-151``).  MTL: Kd/Ks/Ke/Ns/d/Tr/Ni plus the four
texture kinds the reference binds per material (``surface.comp:102-163``):
map_Kd/map_Ks/map_Ke/map_bump|bump|norm (decoded with Pillow, which is
optional: a textured MTL without it raises an error naming the package).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from prismarine_core_tpu.models.geometry import TriangleSoup
from prismarine_core_tpu.models.materials import MaterialTable
from prismarine_core_tpu.models.textures import TextureStack
from prismarine_core_tpu.utils.image import load_image_rgba


def _parse_mtl(path: str) -> dict[str, dict]:
    mats: dict[str, dict] = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                cur = {"name": parts[1] if len(parts) > 1 else ""}
                mats[cur["name"]] = cur
            elif cur is None:
                continue
            elif key == "kd" and len(parts) >= 4:
                cur["diffuse"] = tuple(float(x) for x in parts[1:4])
            elif key == "ks" and len(parts) >= 4:
                ks = tuple(float(x) for x in parts[1:4])
                # metallic-ish proxy: spec strength
                cur["metallic"] = float(np.clip(max(ks), 0.0, 1.0))
            elif key == "ke" and len(parts) >= 4:
                cur["emissive"] = tuple(float(x) for x in parts[1:4])
            elif key == "ns" and len(parts) >= 2:
                # shininess -> roughness (rough ~ sqrt(2/(ns+2)))
                ns = float(parts[1])
                cur["roughness"] = float(np.sqrt(2.0 / (ns + 2.0)))
            elif key in ("d",) and len(parts) >= 2:
                cur["alpha"] = float(parts[1])
            elif key == "tr" and len(parts) >= 2:
                cur["alpha"] = 1.0 - float(parts[1])
            elif key == "ni" and len(parts) >= 2:
                cur["ior"] = float(parts[1])
            elif key == "map_kd" and len(parts) >= 2:
                cur["map_kd"] = parts[-1]
            elif key == "map_ks" and len(parts) >= 2:
                cur["map_ks"] = parts[-1]
            elif key == "map_ke" and len(parts) >= 2:
                cur["map_ke"] = parts[-1]
            elif key in ("map_bump", "bump", "norm") and len(parts) >= 2:
                cur["map_bump"] = parts[-1]
    return mats


#: MTL texture statement -> MaterialTable texture slot.  Mirrors the four
#: bindless texture kinds ``surface.comp:102-163`` consumes
#: (diffuse/specular/emissive/bump).
_MTL_TEX_SLOTS = (("map_kd", "tex_diffuse"), ("map_ks", "tex_specular"),
                  ("map_ke", "tex_emissive"), ("map_bump", "tex_bump"))


def _build_materials(mat_names, mtl: dict, base: str):
    """MTL dicts -> MaterialTable dicts + decoded image list (all four
    texture kinds: diffuse/specular/emissive/bump)."""
    images: list = []
    path_cache: dict[str, int] = {}
    mat_dicts = []
    for name in mat_names:
        d = dict(mtl.get(name, {}))
        d.setdefault("diffuse", (0.7, 0.7, 0.7))
        for mtl_key, slot in _MTL_TEX_SLOTS:
            if mtl_key not in d:
                continue
            p = os.path.join(base, d[mtl_key])
            if p not in path_cache:
                path_cache[p] = len(images)
                images.append(load_image_rgba(p))
            d[slot] = path_cache[p]
        mat_dicts.append(d)
    if not mat_dicts:
        mat_dicts.append({"diffuse": (0.7, 0.7, 0.7)})
    return mat_dicts, images


def load_obj(
    path: str,
    scale: float = 1.0,
    capacity: int | None = None,
    texture_resolution: int = 256,
    use_native: bool = True,
) -> Tuple[TriangleSoup, MaterialTable, TextureStack]:
    """Parse an OBJ file into (TriangleSoup, MaterialTable, TextureStack).

    ``scale`` mirrors the viewer's ``-s/--scale`` flag
    (``Viewer.cpp:30-36``).  Geometry parsing goes through the native
    C++ parser (prismarine_core_tpu/native.py) when available, with
    this module's pure-Python path as fallback and reference.
    """
    if use_native:
        try:
            from prismarine_core_tpu.native import parse_obj_native
            parsed = parse_obj_native(os.path.abspath(path))
        except Exception:
            parsed = None
        if parsed is not None:
            return _assemble_native(parsed, path, scale, capacity,
                                    texture_resolution)
    positions: list = []
    normals: list = []
    texcoords: list = []
    tri_pos: list = []
    tri_nrm: list = []
    tri_uv: list = []
    tri_mat: list = []
    mtl: dict[str, dict] = {}
    mat_order: list[str] = []
    cur_mat = 0

    base = os.path.dirname(os.path.abspath(path))

    def mat_index(name: str) -> int:
        if name not in mat_order:
            mat_order.append(name)
        return mat_order.index(name)

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v" and len(parts) >= 4:
                positions.append([float(parts[1]), float(parts[2]),
                                  float(parts[3])])
            elif key == "vn" and len(parts) >= 4:
                normals.append([float(parts[1]), float(parts[2]),
                                float(parts[3])])
            elif key == "vt" and len(parts) >= 3:
                texcoords.append([float(parts[1]), float(parts[2])])
            elif key == "mtllib" and len(parts) >= 2:
                mtl.update(_parse_mtl(os.path.join(base, parts[1])))
            elif key == "usemtl" and len(parts) >= 2:
                cur_mat = mat_index(parts[1])
            elif key == "f" and len(parts) >= 4:
                corners = []
                for vert in parts[1:]:
                    ids = vert.split("/")
                    vi = int(ids[0])
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = ni = -1
                    if len(ids) > 1 and ids[1]:
                        ti = int(ids[1])
                        ti = ti - 1 if ti > 0 else len(texcoords) + ti
                    if len(ids) > 2 and ids[2]:
                        ni = int(ids[2])
                        ni = ni - 1 if ni > 0 else len(normals) + ni
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # triangle fan
                    tri_pos.append((corners[0][0], corners[k][0],
                                    corners[k + 1][0]))
                    tri_uv.append((corners[0][1], corners[k][1],
                                   corners[k + 1][1]))
                    tri_nrm.append((corners[0][2], corners[k][2],
                                    corners[k + 1][2]))
                    tri_mat.append(cur_mat)

    if not tri_pos:
        raise ValueError(f"no faces found in {path}")

    pos = np.asarray(positions, np.float32) * scale
    nrm = np.asarray(normals, np.float32) if normals else None
    uv = np.asarray(texcoords, np.float32) if texcoords else None
    faces = np.asarray(tri_pos, np.int64)
    fn_idx = np.asarray(tri_nrm, np.int64)
    ft_idx = np.asarray(tri_uv, np.int64)
    nf = len(faces)

    # Expand per-corner attributes (OBJ indexes normals/uvs separately).
    soup = TriangleSoup.from_arrays(
        pos, faces,
        mat_ids=np.asarray(tri_mat, np.int32),
        capacity=capacity,
    )
    import jax.numpy as jnp

    if nrm is not None and (fn_idx >= 0).all():
        n0 = nrm[fn_idx[:, 0]]
        n1 = nrm[fn_idx[:, 1]]
        n2 = nrm[fn_idx[:, 2]]
        cap = soup.capacity

        def pad(x):
            out = np.zeros((cap, 3), np.float32)
            out[:nf] = x
            return jnp.asarray(out)

        import dataclasses
        soup = dataclasses.replace(soup, n0=pad(n0), n1=pad(n1),
                                   n2=pad(n2))
    if uv is not None and (ft_idx >= 0).all():
        cap = soup.capacity

        def pad2(x):
            out = np.zeros((cap, 2), np.float32)
            out[:nf] = x
            return jnp.asarray(out)

        import dataclasses
        soup = dataclasses.replace(
            soup, t0=pad2(uv[ft_idx[:, 0]]), t1=pad2(uv[ft_idx[:, 1]]),
            t2=pad2(uv[ft_idx[:, 2]]))

    # Materials (+ all four texture kinds where decodable).
    mat_dicts, images = _build_materials(mat_order, mtl, base)
    mats = MaterialTable.build(mat_dicts)
    textures = (TextureStack.from_images(images, texture_resolution)
                if images else TextureStack.empty())
    return soup, mats, textures


def _assemble_native(parsed: dict, path: str, scale: float,
                     capacity: int | None, texture_resolution: int):
    """Materials + soup assembly for the native geometry parse."""
    base = os.path.dirname(os.path.abspath(path))
    mtl = {}
    if parsed["mtllib"]:
        mtl = _parse_mtl(os.path.join(base, parsed["mtllib"]))

    mat_dicts, images = _build_materials(parsed["mat_names"], mtl, base)

    soup = TriangleSoup.from_corners(
        parsed["v0"] * scale, parsed["v1"] * scale, parsed["v2"] * scale,
        parsed["n0"], parsed["n1"], parsed["n2"],
        parsed["t0"], parsed["t1"], parsed["t2"],
        parsed["mat"], capacity=capacity)
    mats = MaterialTable.build(mat_dicts)
    textures = (TextureStack.from_images(images, texture_resolution)
                if images else TextureStack.empty())
    return soup, mats, textures
