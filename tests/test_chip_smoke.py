"""chip_smoke.py's phases at tiny sizes on the CPU (kernels in interpret
mode; the four-card phase on four virtual devices).  Only its ``main``
demands a GPU."""

import jax
import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def hall():
    return (jax.device_put(cs.hall_scene(n_tris=2000)), cs.hall_camera())


def test_main_refuses_without_gpu():
    with pytest.raises(SystemExit):
        cs.main([])


def test_phase_kernels_tiny(hall):
    scene, camera = hall
    out = cs.phase_kernels(scene, camera, cs.bench_config(64, 32, 4),
                           n_subset_tiles=4, n_time=1)
    assert set(out) == {"primary", "bounce1"}
    assert all(f["pairs"] > 0 and f["slot_diff_vs_xla"] == 0
               for f in out.values())


def test_phase_main_path_tiny(hall, tmp_path):
    scene, camera = hall
    f = cs.phase_main_path(scene, camera, cs.bench_config(64, 32, 4),
                           n_tris=2000, frames=2, out_dir=str(tmp_path))
    assert (tmp_path / "hall.png").exists() and f["differing"] < 0.005


def test_phase_oracle_tiny():
    out = cs.phase_oracle(size=16, spp=1, bounces=2)
    assert set(out) == {"pallas", "bvh"}


def test_phase_gradient_tiny(hall):
    scene, camera = hall
    out = cs.phase_gradient(scene, camera, cs.bench_config(24, 16, 2))
    assert out["diffuse"]["norm"] > 0


def test_phase_four_cards_virtual_mesh():
    out = cs.phase_four_cards(n_tris=3000, size=32, bounces=2,
                              train_size=16, texture_resolution=32)
    assert out["bytes"]["planes_device"] * 4 <= \
        out["bytes"]["planes_total"] + 1024
