"""Material table — analog of ``VirtualMaterial`` + MaterialSet.

The reference keeps a CPU vector of ``VirtualMaterial`` records uploaded to
an SSBO (``Include/Prismarine/Structs.hpp:236-262``,
``MaterialSet.inl:13-23``) with bindless texture handles.  Here materials
are a dense SoA table indexed by ``mat_id`` gathers, and "bindless textures"
become integer indices into a stacked texture array (models/textures.py).

Field mapping (reference ``VirtualMaterial`` -> here):
  diffuse.rgb / .a     -> diffuse[.., :3] / alpha (transparency RR)
  specular.y (rough)   -> roughness   (surface.comp:189 packs spc.yz)
  specular.z (metal)   -> metallic
  emissive.rgb         -> emissive
  ior                  -> ior
  diffusePart etc.     -> tex_diffuse / tex_specular / tex_emissive / tex_bump
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class MaterialTable:
    diffuse: jax.Array     # f32[M,4] rgb + alpha
    specular: jax.Array    # f32[M,4] x unused, y=roughness, z=metallic
    emissive: jax.Array    # f32[M,4]
    #: transmission tint for the pass-through/refraction branch
    #: (``VirtualMaterial.transmission``); rgb all-zero means untinted
    transmission: jax.Array  # f32[M,4]
    ior: jax.Array         # f32[M]
    tex_diffuse: jax.Array   # i32[M], -1 = none
    tex_specular: jax.Array  # i32[M]
    tex_emissive: jax.Array  # i32[M]
    tex_bump: jax.Array      # i32[M]
    #: STATIC (jit-meta) per-KIND binding flags (diffuse, specular,
    #: emissive, bump): a kind no material binds lets the integrator
    #: skip that whole fetch+filter chain at TRACE time — texture ids
    #: are traced arrays, so without this the gathers execute for
    #: every lane and get discarded by the blend `where`.  The sibling
    #: of TextureStack.stub at per-kind granularity.
    kinds_bound: tuple = (True, True, True, True)

    def __post_init__(self):
        # Refresh the static flags whenever the table is constructed or
        # ``dataclasses.replace``d with CONCRETE id arrays — a
        # post-build mutation like ``replace(mats, tex_bump=...)`` must
        # not inherit stale flags (a stale False would silently skip a
        # newly-bound chain).  Traced reconstructions (tree ops inside
        # jit) and abstract shapes keep the carried value.
        arrs = (self.tex_diffuse, self.tex_specular,
                self.tex_emissive, self.tex_bump)
        if any(isinstance(a, jax.core.Tracer) for a in arrs):
            return
        try:
            self.kinds_bound = tuple(
                bool((np.asarray(a) >= 0).any()) for a in arrs)
        except Exception:   # abstract leaves (eval_shape / .lower)
            pass

    @property
    def count(self) -> int:
        return self.diffuse.shape[0]

    def lookup(self, mat_id: jax.Array) -> "MaterialTable":
        """Gather per-ray material records (mat_id: i32[R])."""
        return jax.tree.map(lambda a: a[mat_id], self)

    @staticmethod
    def build(mats: Sequence[dict]) -> "MaterialTable":
        """From a list of dicts with keys diffuse/alpha/roughness/metallic/
        emissive/ior/tex_*; missing keys get reference defaults
        (``Structs.hpp:236-247``)."""
        m = len(mats)
        diffuse = np.zeros((m, 4), np.float32)
        specular = np.zeros((m, 4), np.float32)
        emissive = np.zeros((m, 4), np.float32)
        transmission = np.zeros((m, 4), np.float32)
        ior = np.full((m,), 1.0, np.float32)
        texd = np.full((m,), -1, np.int32)
        texs = np.full((m,), -1, np.int32)
        texe = np.full((m,), -1, np.int32)
        texb = np.full((m,), -1, np.int32)
        for i, d in enumerate(mats):
            diffuse[i, :3] = d.get("diffuse", (0.0, 0.0, 0.0))
            diffuse[i, 3] = d.get("alpha", 1.0)
            specular[i, 1] = d.get("roughness", 0.0001)
            specular[i, 2] = d.get("metallic", 0.0)
            emissive[i, :3] = d.get("emissive", (0.0, 0.0, 0.0))
            transmission[i, :3] = d.get("transmission", (0.0, 0.0, 0.0))
            ior[i] = d.get("ior", 1.0)
            texd[i] = d.get("tex_diffuse", -1)
            texs[i] = d.get("tex_specular", -1)
            texe[i] = d.get("tex_emissive", -1)
            texb[i] = d.get("tex_bump", -1)
        return MaterialTable(
            diffuse=jnp.asarray(diffuse), specular=jnp.asarray(specular),
            emissive=jnp.asarray(emissive),
            transmission=jnp.asarray(transmission),
            ior=jnp.asarray(ior),
            tex_diffuse=jnp.asarray(texd), tex_specular=jnp.asarray(texs),
            tex_emissive=jnp.asarray(texe), tex_bump=jnp.asarray(texb),
            kinds_bound=tuple(bool((a >= 0).any())
                              for a in (texd, texs, texe, texb)),
        )


jax.tree_util.register_dataclass(
    MaterialTable,
    data_fields=["diffuse", "specular", "emissive", "transmission",
                 "ior", "tex_diffuse", "tex_specular", "tex_emissive",
                 "tex_bump"],
    meta_fields=["kinds_bound"])
