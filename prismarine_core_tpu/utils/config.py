"""Render configuration.

Single-dataclass replacement for the reference's three config tiers
(GLSL compile-time defines ``constants.glsl:9-36``, CMake options, and the
viewer CLI flags ``Viewer.cpp:22-50``).  Everything here is *static* with
respect to jit: a config value change triggers a recompile, mirroring the
reference's shader-recompile semantics.
"""

from __future__ import annotations

import dataclasses


# Numeric constants, mirroring ShadersSDK/include/constants.glsl:70-77.
PZERO = 0.0005          # ray-offset epsilon   (constants.glsl: PZERO)
GAP = 2.0 * PZERO       # surface spawn offset (shadinglib.glsl:8  GAP)
INF_DIST = 10000.0      # "infinity" hit dist  (constants.glsl: INFINITY)

# Number of uniform random samples consumed per bounce / per camera ray.
# See render/integrator.py for the slot layout.
SAMPLES_PER_BOUNCE = 11
SAMPLES_PER_CAMERA_RAY = 4


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (jit-static; hashable)."""

    width: int = 256
    height: int = 256
    max_bounces: int = 4          # camera.comp:91 seeds bounce=4
    spp: int = 1                  # samples per pixel per call
    #: enable next-event-estimation shadow rays toward sphere light 0
    #: (reference: DIRECT_LIGHT_ENABLED, rayshading.comp:270-274)
    direct_light: bool = True
    #: environment (sun) importance sampling: NEE toward the envmap's
    #: bright texels with balance-heuristic MIS against the cosine
    #: bounce.  Extends the reference (whose env() is only a miss hook,
    #: environment.glsl); unbiased, dramatically lower variance under
    #: HDR sun-disc skies (models/textures.py sample_env_direction).
    env_nee: bool = False
    #: 360-degree equirectangular camera (camera.comp:48-59)
    camera_360: bool = False
    #: checkerboard interlacing — trace only half the pixels per frame
    #: (camera.comp:94-100); the progressive pipeline alternates stages
    interlace: bool = False
    #: depth of field (camera.comp:67-75, EXPERIMENTAL_DOF)
    dof: bool = False
    dof_focus_radius: float = 10.0
    dof_focal_radius: float = 1.0 / 16.0
    #: kill rays whose throughput falls below this (rayshading.comp:240)
    min_throughput: float = 1e-4
    #: Russian-roulette start bounce (0 = OFF = reference parity: the
    #: reference only has the deterministic min_throughput cutoff).
    #: From this bounce index on, lanes survive with probability
    #: q = clamp(max(throughput), rr_min_q, 1) and survivors reweight
    #: by 1/q — UNBIASED adaptive termination (tested); killed lanes
    #: sort last and emit no kernel pairs, so deep-bounce cost tracks
    #: realized liveness.
    rr_start_bounce: int = 0
    #: survival-probability floor (bounds the 1/q firefly weight)
    rr_min_q: float = 0.05
    #: fixed IOR used by the dielectric specular mix (rayshading.comp:168)
    ior: float = 1.4
    #: triangle-block size for chunked brute-force intersection
    tri_block: int = 512
    #: leaf size (triangles per BVH leaf)
    bvh_leaf_size: int = 4
    #: which intersector to use: "brute" | "bvh" | "packet" | "pallas"
    #: | "pallas_sharded" ("pallas" is the production fused-kernel fast
    #: path; "pallas_sharded" runs it over ``mesh`` with rays sharded
    #: over 'data' and superblock ranges over 'model' — the scene must
    #: carry ShardedPackets, see parallel/shard_intersect.py)
    intersector: str = "bvh"
    #: device mesh for "pallas_sharded" (jax.sharding.Mesh; jit-static)
    mesh: object = None
    #: traversal ray-chunk size (0 = whole batch in one while_loop);
    #: smaller chunks bound each while_loop's iteration count by the
    #: chunk's own worst ray instead of the global worst.
    traverse_chunk: int = 0
    #: texture filter: "bilinear" (GL_LINEAR) or "bicubic" (the
    #: reference's textureBicubic, mathlib.glsl:285-319)
    texture_filter: str = "bilinear"
    #: progressive-accumulator history clamp, the motion-blur sample lock
    #: (``SAMPLES_LOCK 4``, constants.glsl:35; ``sampler.comp:84-90``):
    #: 0 = plain cumulative average; N > 0 clamps the accumulated weight
    #: to N-1 after each blend, turning the average into a rolling one so
    #: animated content keeps updating.
    samples_lock: int = 0
    #: coherent path tracing (Sadeghi et al. 2009): correlate bounce
    #: samples across 8x16-pixel screen blocks so secondary rays form
    #: direction-tight packets (fewer culled pairs on the packet/pallas
    #: intersectors).  Unbiased per pixel; adds intra-frame cross-pixel
    #: correlation that the progressive accumulator averages out.
    coherent_bounce_sampling: bool = False
    #: reuse bounce 1's coherence permutation for every later bounce
    #: instead of re-sorting (pallas intersector only): bounce origins
    #: are the previous hits, so spatial coherence persists; saves one
    #: full u32 ray sort per bounce.  Best combined with
    #: coherent_bounce_sampling (directions/coins stay block-coherent).
    reuse_bounce_order: bool = False
    #: sort rays by direction octant + origin morton before traversal
    #: (the analog of the reference's wavefront compaction / optional
    #: ray sorting, Pipeline.hpp:101) — coherent chunks retire
    #: together.
    sort_rays: bool = False
    #: dense-cull scheme of the pallas intersector (accel/packet.py,
    #: ops/cull.py): "pallas" = one-level dense slab cull at BLOCK
    #: granularity, from which candidates and per-pair block masks
    #: derive; "pallas2" = two-level cull — dense at SUPERBLOCK
    #: granularity, then a pair-driven block refine over the compacted
    #: survivors, so block-level cull work scales with the candidate
    #: count; "xla" = the same two-level cull (the names predate the
    #: plain-XLA culls and are kept for now).
    cull_impl: str = "pallas"
    #: cull_impl override for ANY-HIT queries ("" = same as cull_impl)
    anyhit_cull_impl: str = ""
    #: skip the coherence sort for PRIMARY (bounce-0) rays: camera rays
    #: arrive in scanline order, so the identity order saves the u32
    #: key sort + the 64-byte-row gather once per frame (pallas
    #: intersector only).  Scanline tiles are 128x1 strips whose frusta
    #: overlap more superblocks than Morton-sorted tiles; see
    #: primary_tile_order.
    primary_identity: bool = False
    #: generate PRIMARY rays directly in 16x8-PIXEL-TILE order (lane
    #: tile = a compact screen rect instead of a 128x1 scanline strip)
    #: and run bounce 0 sort-free: the coherence the u32 sort buys for
    #: camera rays, at the cost of one constant-index pixel remap +
    #: one radiance unpermute per FRAME.  Requires width % 16 == 0 and
    #: height % 8 == 0 (falls back to scanline order otherwise);
    #: pallas intersector only.
    primary_tile_order: bool = False
    #: ray coherence sort variant (accel/packet.py:_sort_pad_rays):
    #: "full" (2-array u32 sort), "packed" (1-array sort, index packed
    #: into the key's low bits), "group" (sort 16-ray groups by
    #: live-centroid key — 16x fewer sort elements).
    sort_mode: str = "full"
    #: two_round round-2 pruning under the one-level cull: "sb" (per-ray
    #: superblock recull + round-1 block masks), "kernel" (re-run the
    #: block cull with tightened per-ray caps), "tn" (per-tile caps
    #: over saved block distances — cheap but re-admits whole tiles).
    #: Results identical in all modes.
    recull: str = "sb"
    #: "rounds" strategy: keep round-0 block masks instead of
    #: re-deriving them per round against tightened per-ray caps
    #: (cheaper when queries finish in a round or two — coherent;
    #: fresh masks prune far more for incoherent any-hit)
    stale_round_masks: bool = False
    #: two_round round-1 selection: 0 = K-nearest top_k; > 0 = run all
    #: candidates within this fraction of the tile's entry-distance
    #: range first (two row reduces instead of a [nt, nsb] top_k;
    #: adaptive per-tile round sizes)
    near_frac: float = 0.0
    #: execution-strategy overrides for the pallas intersector
    #: ("" / 0 = the defaults: closest -> two_round K=8, any-hit ->
    #: rounds K=8; see _run_packet_pallas)
    closest_strategy: str = ""
    closest_k: int = 0
    anyhit_strategy: str = ""
    anyhit_k: int = 0

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def n_rays(self) -> int:
        return self.width * self.height * self.spp

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
