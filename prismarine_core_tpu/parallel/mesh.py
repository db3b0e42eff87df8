"""Device-mesh sharding: scale-out for rays and triangles.

The reference is strictly single-GPU (SURVEY.md §2: no NCCL/MPI, no
multi-device code) — this module is new capability.  Design (SURVEY.md §7
stage 7, scaling-book recipe: pick a mesh, annotate shardings, let XLA
insert collectives):

* mesh axes ``('data', 'model')``: ``data`` shards rays/pixels (pure DP —
  every ray is independent), ``model`` shards triangle ranges (the
  model-parallel analog for scenes larger than one device's memory).
* GSPMD/pjit does the partitioning: the brute-force intersector's
  [R, T] block computation splits over both axes and the closest-hit
  min-reduce over T becomes a cross-``model`` collective; per-pixel
  radiance and parameter gradients all-reduce across devices automatically
  under `jax.grad`.
* the BVH path gathers from its node arrays, which would turn into
  collective gathers if sharded — so BVH arrays stay replicated
  (correct whenever the scene fits per-chip; triangle-sharded traversal
  with ppermute ray forwarding is the planned big-scene path).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from prismarine_core_tpu.models.camera import Camera
from prismarine_core_tpu.models.scene import Scene
from prismarine_core_tpu.render.integrator import render_with_samples
from prismarine_core_tpu.utils.config import RenderConfig


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              devices=None) -> Mesh:
    """2D mesh ('data', 'model'); ``model_parallel`` divides n_devices."""
    if devices is None:
        devices = jax.devices()
    n = n_devices or len(devices)
    assert n % model_parallel == 0, (n, model_parallel)
    dev = np.asarray(devices[:n]).reshape(n // model_parallel,
                                          model_parallel)
    return Mesh(dev, ("data", "model"))


def scene_shardings(scene: Scene, mesh: Mesh, shard_triangles: bool):
    """PartitionSpec pytree for a Scene: triangle arrays split over
    'model' (leading T dim) when requested; everything else replicated."""
    def spec_for_soup(a):
        if shard_triangles:
            return NamedSharding(mesh, P("model", *([None] * (a.ndim - 1))))
        return NamedSharding(mesh, P())

    repl = NamedSharding(mesh, P())
    specs = jax.tree.map(lambda _: repl, scene)
    import dataclasses
    specs = dataclasses.replace(
        specs, triangles=jax.tree.map(spec_for_soup, scene.triangles))
    return specs


def shard_scene(scene: Scene, mesh: Mesh,
                shard_triangles: bool = False) -> Scene:
    """Place a Scene on the mesh with the standard layout."""
    return jax.device_put(
        scene, scene_shardings(scene, mesh, shard_triangles))


def make_sharded_renderer(mesh: Mesh, cfg: RenderConfig,
                          shard_triangles: bool = False):
    """jit-compiled renderer with rays sharded over 'data'.

    Returns fn(scene, camera, cam_samples, bounce_samples) -> image.
    Sample arrays shard on their ray axis; the image comes back
    replicated (the spp-mean reduction crosses the data axis and XLA
    inserts the collective).
    """
    ray_sh = NamedSharding(mesh, P("data", None))
    bounce_sh = NamedSharding(mesh, P(None, "data", None))
    repl = NamedSharding(mesh, P())

    def _render(scene, camera, cam_samples, bounce_samples):
        return render_with_samples(scene, camera, cfg, cam_samples,
                                   bounce_samples)

    return jax.jit(
        _render,
        in_shardings=(None, None, ray_sh, bounce_sh),
        out_shardings=repl,
    )


# -- differentiable training step (inverse rendering) ---------------------

def make_train_step(mesh: Mesh, cfg: RenderConfig, lr: float = 5e-2,
                    shard_triangles: bool = False, lr_scale=None,
                    normalize_grads: bool = False,
                    vertex_faces=None):
    """Inverse-rendering SGD step, the flagship 'training step':
    params = (material diffuse table, light colors, vertex positions);
    loss = MSE against a target image; gradients all-reduce over the mesh
    under GSPMD.  Returns jitted fn(params, scene, camera, cam_s,
    bounce_s, target) -> (params, loss).

    ``lr_scale``: optional dict of per-param multipliers (e.g.
    ``{"v0": 0.01}``) — vertex positions live on a very different
    scale than colors, so one global rate either stalls the colors or
    blows up the geometry.  ``normalize_grads``: RMS-normalize each
    param's gradient before the step (sign-SGD-like; makes the step
    size ``lr`` an absolute parameter-space distance, robust to the
    spp-1 gradient-magnitude noise of a stochastic renderer).

    ``vertex_faces`` (i32[T,3], from ``shared_vertices``): switch the
    geometry parameterization to a shared vertex buffer — params carry
    ``"verts"`` f32[V,3] instead of per-corner arrays, and corners
    gather through this remap so watertight meshes stay watertight
    under optimization.
    """
    lr_scale = lr_scale or {}
    ray_sh = NamedSharding(mesh, P("data", None))
    bounce_sh = NamedSharding(mesh, P(None, "data", None))
    repl = NamedSharding(mesh, P())

    def apply_params(scene: Scene, params) -> Scene:
        import dataclasses
        mats = dataclasses.replace(scene.materials,
                                   diffuse=params["mat_diffuse"])
        lights = dataclasses.replace(scene.lights,
                                     color=params["light_color"])
        if "verts" in params:
            # shared-vertex mode: one deduplicated buffer, corners
            # gathered through the index remap so shared vertices move
            # together (vertex_faces captured from shared_vertices())
            v = params["verts"]
            tris = dataclasses.replace(
                scene.triangles, v0=v[vertex_faces[:, 0]],
                v1=v[vertex_faces[:, 1]], v2=v[vertex_faces[:, 2]])
        else:
            # corner mode: ALL THREE vertex fields optimize (r3 only
            # stepped v0, leaving "gradients w.r.t. vertex positions"
            # one-third true in the training loop)
            tris = dataclasses.replace(
                scene.triangles, v0=params["v0"],
                v1=params.get("v1", scene.triangles.v1),
                v2=params.get("v2", scene.triangles.v2))
        scene = dataclasses.replace(scene, materials=mats, lights=lights,
                                    triangles=tris)
        if cfg.intersector == "pallas_sharded":
            # the production path: rebuild the acceleration structure
            # from the updated geometry INSIDE the differentiated loss
            # (the per-frame `markDirty(); build()` analog,
            # Viewer.cpp:296-297) so vertex gradients flow through the
            # sharded re-evaluation; GSPMD keeps the rebuilt packet
            # arrays 'model'-sharded via the constraint.
            from prismarine_core_tpu.accel.lbvh import build_bvh
            from prismarine_core_tpu.parallel.shard_intersect import (
                build_sharded_packets, constrain_packets)
            bvh = build_bvh(tris, leaf_size=cfg.bvh_leaf_size)
            sp = build_sharded_packets(bvh, mp=cfg.mesh.shape["model"],
                                       soup=tris)
            scene = dataclasses.replace(
                scene, packets=constrain_packets(sp, cfg.mesh), bvh=None)
        return scene

    def loss_fn(params, scene, camera, cam_s, bounce_s, target):
        scene = apply_params(scene, params)
        img = render_with_samples(scene, camera, cfg, cam_s, bounce_s)
        return jnp.mean((img - target) ** 2)

    def step(params, scene, camera, cam_s, bounce_s, target):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, scene, camera, cam_s, bounce_s, target)
        def upd(k, p):
            g = grads[k]
            if normalize_grads:
                g = g / (jnp.sqrt(jnp.mean(g * g)) + 1e-8)
            return p - lr * lr_scale.get(k, 1.0) * g

        params = {k: upd(k, p) for k, p in params.items()}
        return params, loss

    # params inherit their arg shardings (v0 may arrive 'model'-sharded
    # from shard_scene); GSPMD keeps the update sharded the same way.
    return jax.jit(
        step,
        in_shardings=(None, None, None, ray_sh, bounce_sh, repl),
        out_shardings=(None, repl),
    )


def init_params(scene: Scene):
    """Corner-mode parameters: all three vertex fields optimize."""
    return {
        "mat_diffuse": scene.materials.diffuse,
        "light_color": scene.lights.color,
        "v0": scene.triangles.v0,
        "v1": scene.triangles.v1,
        "v2": scene.triangles.v2,
    }


def shared_vertices(soup):
    """Deduplicate the corner soup into (verts f32[V,3], faces i32[T,3]).

    Shared vertices in a soup are bitwise-equal copies of the same
    source vertex (loaders gather them from one buffer), so exact
    np.unique recovers the indexed mesh.  Host-side, once, at init.
    Use with ``make_train_step(vertex_faces=faces)`` and params
    ``{"verts": verts, ...}`` (``init_shared_params``)."""
    corners = np.concatenate([np.asarray(soup.v0), np.asarray(soup.v1),
                              np.asarray(soup.v2)], axis=0)   # [3T, 3]
    verts, inv = np.unique(corners, axis=0, return_inverse=True)
    t = np.asarray(soup.v0).shape[0]
    faces = np.stack([inv[:t], inv[t:2 * t], inv[2 * t:]], axis=1)
    return (jnp.asarray(verts, jnp.float32),
            jnp.asarray(faces, jnp.int32))


def init_shared_params(scene: Scene, verts):
    return {
        "mat_diffuse": scene.materials.diffuse,
        "light_color": scene.lights.color,
        "verts": verts,
    }
