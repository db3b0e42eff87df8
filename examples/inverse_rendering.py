"""Inverse rendering demo: recover material albedos from a target image.

The capability the reference does not have: gradients flow from pixels
back to scene parameters.  We render a target cornell box, perturb the
material table, and recover it by gradient descent on image MSE.

    python examples/inverse_rendering.py [--steps 60] [--gpu]
"""

import argparse
import dataclasses
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--gpu", action="store_true",
                    help="run on the default (GPU) backend instead of CPU")
    ap.add_argument("--out", default="inverse_result.png")
    args = ap.parse_args()

    if not args.gpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import optax

    from prismarine_core_tpu.models.camera import Camera
    from prismarine_core_tpu.models.scene import make_cornell_scene
    from prismarine_core_tpu.ops.sampling import make_sample_arrays
    from prismarine_core_tpu.render.integrator import render_with_samples
    from prismarine_core_tpu.utils.config import RenderConfig
    from prismarine_core_tpu.utils.image import save_png

    cfg = RenderConfig(width=args.res, height=args.res, spp=2,
                       max_bounces=2)
    cam = Camera.look_at(eye=(0, 0, 3.4), target=(0, 0, 0), fov_y_deg=50)
    scene = make_cornell_scene()
    cam_s, bounce_s = make_sample_arrays(jax.random.key(0), cfg.n_rays,
                                         cfg.max_bounces)

    target = render_with_samples(scene, cam, cfg, cam_s, bounce_s)
    true_diffuse = scene.materials.diffuse

    # start from gray materials
    init = true_diffuse.at[:, :3].set(0.5)

    def loss_fn(diffuse, key):
        # fixed sample arrays: a deterministic objective (at low spp a
        # re-sampled MSE is dominated by Monte-Carlo variance)
        del key
        s = dataclasses.replace(
            scene, materials=dataclasses.replace(
                scene.materials, diffuse=diffuse))
        img = render_with_samples(s, cam, cfg, cam_s, bounce_s)
        return jnp.mean((img - target) ** 2)

    opt = optax.adam(5e-2)
    state = opt.init(init)
    diffuse = init

    @jax.jit
    def step(diffuse, state, key):
        loss, g = jax.value_and_grad(loss_fn)(diffuse, key)
        updates, state = opt.update(g, state)
        return optax.apply_updates(diffuse, updates), state, loss

    key = jax.random.key(1)
    t0 = time.perf_counter()
    for i in range(args.steps):
        key, sub = jax.random.split(key)
        diffuse, state, loss = step(diffuse, state, sub)
        if i % 10 == 0 or i == args.steps - 1:
            err = float(jnp.abs(diffuse[:, :3]
                                - true_diffuse[:, :3]).mean())
            print(f"step {i:3d}  loss {float(loss):.6f}  "
                  f"albedo L1 {err:.4f}", file=sys.stderr)
    print(f"optimized {args.steps} steps in "
          f"{time.perf_counter()-t0:.1f}s", file=sys.stderr)

    final = render_with_samples(
        dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, diffuse=diffuse)),
        cam, cfg, cam_s, bounce_s)
    import numpy as np
    strip = np.concatenate([np.asarray(target), np.asarray(final)],
                           axis=1)
    save_png(args.out, strip)
    print(f"wrote {args.out} (target | recovered)", file=sys.stderr)

    err = float(jnp.abs(diffuse[:, :3] - true_diffuse[:, :3]).mean())
    print(f"final albedo L1 error: {err:.4f}", file=sys.stderr)
    return 0 if err < 0.15 else 1


if __name__ == "__main__":
    sys.exit(main())
