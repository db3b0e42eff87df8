"""prismarine_core_tpu — a differentiable path tracing framework in JAX.

A from-scratch re-design of the capabilities of EngineWorld/prismarine-core
(a C++17/OpenGL-compute wavefront GPU path tracer) as JAX array programs,
run on an NVIDIA H100:

* compute path: JAX / XLA / Pallas — fixed shapes, masked lanes, `lax.scan`
  over bounces, sort/scan compaction instead of atomics and linked lists;
* acceleration structure: morton-ordered complete-tree BVH built with
  `lax.sort` + log-depth reductions (replacing the reference's GPU radix
  sort + Karras LBVH host loop, ``TriangleHierarchy.inl:206-329``);
* differentiable by design: gradients w.r.t. vertex positions, material
  parameters and light parameters (a capability the reference lacks);
* scale-out: rays/pixels sharded over a `jax.sharding.Mesh` (data axis),
  triangle ranges shardable over a model axis, min-reduced hits and
  gradient all-reduce across devices.

Layer map (mirrors SURVEY.md of the reference):
  utils/    — config, math helpers          (ref: Utils.hpp, mathlib.glsl)
  models/   — scene data model: geometry, materials, lights, cameras
              (ref: Structs.hpp, VertexInstance, MaterialSet, TextureSet)
  ops/      — kernels: intersection, sampling, morton
              (ref: vertex.glsl, random.glsl, morton.glsl)
  accel/    — BVH build + traversal         (ref: hlbvh/*, radix/*)
  render/   — integrator + pipeline facade  (ref: Pipeline.*, raytracing/*)
  parallel/ — device-mesh sharding          (ref: none — new capability)
  reference/— independent numpy CPU oracle  (ref: none — new capability)
"""

__version__ = "0.1.0"

from prismarine_core_tpu.models.scene import Scene
from prismarine_core_tpu.models.camera import Camera
from prismarine_core_tpu.utils.config import RenderConfig
