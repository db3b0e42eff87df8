"""Matched-wall-clock quality A/B: Russian roulette vs fixed 4 bounces.

cfg.rr_start_bounce=2 trims deep-bounce live lanes off the hall frame
at the cost of extra termination variance (the 1/q reweighting).  The honest basis for recommending the knob is
time-to-quality: render for a fixed budget in each mode, average the
frames, and compare per-pixel MSE against a long RR-free reference.

Run on the card: python examples/r6_rr_quality.py [budget_s] [n_ref]
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
    from prismarine_core_tpu.ops.sampling import make_coherent_sample_arrays
    from prismarine_core_tpu.render.integrator import render_with_samples
    from prismarine_core_tpu.utils.config import RenderConfig

    budget_s = float(sys.argv[1]) if len(sys.argv) > 1 else 20.0
    n_ref = int(sys.argv[2]) if len(sys.argv) > 2 else 120

    base = RenderConfig(width=640, height=360, spp=1, max_bounces=4,
                        intersector="pallas", bvh_leaf_size=4,
                        coherent_bounce_sampling=True,
                        stale_round_masks=True,
                        anyhit_strategy="single", cull_impl="pallas2",
                        closest_k=16)
    modes = {"rr-off": base,
             "rr-2": dataclasses.replace(base, rr_start_bounce=2)}
    scene = make_hall_scene(target_tris=50_000)
    scene = dataclasses.replace(
        scene, environment=make_sky_environment(resolution=128))
    scene = jax.device_put(scene)
    camera = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                            fov_y_deg=60.0)
    print(f"[rrq] devices={jax.devices()} budget={budget_s}s "
          f"ref_frames={n_ref}", flush=True)

    def frame(c, key):
        cam_s, bounce_s = make_coherent_sample_arrays(key, c,
                                                      block=(64, 64))
        img = render_with_samples(scene, camera, c, cam_s, bounce_s)
        return np.asarray(img, np.float64)

    for c in modes.values():                  # warm both compiled paths
        frame(c, jax.random.key(9000))

    # long-run reference (RR-free, unbiased)
    acc = 0.0
    for i in range(n_ref):
        acc = acc + frame(modes["rr-off"], jax.random.key(100_000 + i))
    ref = acc / n_ref
    print(f"[rrq] reference mean={ref.mean():.5f}", flush=True)

    for name, c in modes.items():
        acc, n = 0.0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < budget_s:
            acc = acc + frame(c, jax.random.key(1000 * n + 7))
            n += 1
        img = acc / n
        mse = float(((img - ref) ** 2).mean())
        print(f"[rrq] {name:8s} frames={n:3d} mean={img.mean():.5f} "
              f"MSE={mse:.3e}", flush=True)


if __name__ == "__main__":
    main()
