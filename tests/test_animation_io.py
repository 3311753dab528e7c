"""Animation scan, camera batch, checkpointing, config, image IO."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from romis.core.camera import make_camera
from romis.core.features import Features
from romis.io.checkpoint import load_checkpoint, save_checkpoint
from romis.io.config import read_config_file
from romis.io.image import write_bmp, write_png
from romis.render.animation import (
    interpolate_cameras, render_animation, render_camera_batch,
    stack_cameras,
)
from romis.render.restir import initial_temporal_state, render_restir_frame
from romis.scene.scene import load_prebuilt

HW = (16, 16)


@pytest.fixture(scope="module")
def cornell():
    return load_prebuilt("cornell_box_parallelogram_light")


def _cam(rot=(0, 0, 0)):
    return make_camera(look_at=(0, 0, 0), rotation_deg=rot, distance=2.5,
                       fov_deg=50, resolution=HW)


def test_render_animation_matches_frame_loop(cornell):
    """The scanned animation must equal the per-frame Python loop exactly."""
    h, w = HW
    feats = Features(initial_light_samples=4, spatial_resample_radius=2,
                     temporal_reprojection=True)
    cam_a, cam_b = _cam((0, 0, 0)), _cam((5, 10, 0))
    cams = interpolate_cameras(cam_a, cam_b, 3)
    key = jax.random.PRNGKey(0)

    imgs, _ = jax.jit(render_animation, static_argnums=(4, 5, 6, 7))(
        key, cams, cornell.geometry, cornell.lights, cornell.num_lights,
        h, w, feats)

    state = initial_temporal_state(h, w, 2, jax.tree.map(lambda a: a[0],
                                                         cams))
    fn = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))
    keys = jax.random.split(key, 3)
    for f in range(3):
        cam_f = jax.tree.map(lambda a: a[f], cams)
        img, state = fn(keys[f], cam_f, cornell.geometry, cornell.lights,
                        cornell.num_lights, h, w, feats, state)
        np.testing.assert_allclose(np.asarray(imgs[f]), np.asarray(img),
                                   rtol=1e-5, atol=1e-6)


def test_camera_batch_matches_individual(cornell):
    h, w = HW
    feats = Features(initial_light_samples=4, temporal_reuse=False,
                     spatial_resample_radius=2)
    cams = stack_cameras([_cam((0, 0, 0)), _cam((0, 30, 0))])
    key = jax.random.PRNGKey(1)
    imgs = jax.jit(render_camera_batch, static_argnums=(4, 5, 6, 7))(
        key, cams, cornell.geometry, cornell.lights, cornell.num_lights,
        h, w, feats)
    assert imgs.shape == (2, h, w, 3)
    assert np.isfinite(np.asarray(imgs)).all()
    assert not np.array_equal(np.asarray(imgs[0]), np.asarray(imgs[1]))


def test_checkpoint_roundtrip(cornell, tmp_path):
    h, w = HW
    feats = Features(initial_light_samples=4, spatial_resample_radius=2)
    cam = _cam()
    fn = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))
    state = initial_temporal_state(h, w, 2, cam)
    key = jax.random.PRNGKey(5)
    img1, state = fn(key, cam, cornell.geometry, cornell.lights,
                     cornell.num_lights, h, w, feats, state)

    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state, key, frame=1)
    template = initial_temporal_state(h, w, 2, cam)
    state2, key2, frame = load_checkpoint(path, template)
    assert frame == 1

    img_a, _ = fn(jax.random.fold_in(key, 99), cam, cornell.geometry,
                  cornell.lights, cornell.num_lights, h, w, feats, state)
    img_b, _ = fn(jax.random.fold_in(key2, 99), cam, cornell.geometry,
                  cornell.lights, cornell.num_lights, h, w, feats, state2)
    np.testing.assert_array_equal(np.asarray(img_a), np.asarray(img_b))


def test_cli_checkpoint_resume_bit_identical(tmp_path):
    """CLI --frames with --checkpoint: interrupt after 2 frames, resume to
    4 — the final image must be BIT-IDENTICAL to an uninterrupted 4-frame
    run (VERDICT r3 item 9; per-frame keys are fold_in(cam_key, f), so the
    resumed scan consumes exactly the keys the full run would)."""
    from romis.cli import main

    out_full = tmp_path / "full"
    out_resume = tmp_path / "resume"
    base = ["--scene", "cornell_box_parallelogram_light",
            "--size", "16", "16", "--mode", "restir", "--format", "npy",
            "--platform", "cpu", "--seed", "3"]

    assert main(base + ["--frames", "4", "--out", str(out_full)]) == 0
    ckpt = str(tmp_path / "ck")
    assert main(base + ["--frames", "2", "--out", str(tmp_path / "p1"),
                        "--checkpoint", ckpt]) == 0
    assert os.path.exists(ckpt + "_cam0.npz")
    assert main(base + ["--frames", "4", "--out", str(out_resume),
                        "--checkpoint", ckpt]) == 0

    def only_npy(d):
        files = [f for f in os.listdir(d) if f.endswith(".npy")]
        assert len(files) == 1, files
        return np.load(os.path.join(d, files[0]))

    np.testing.assert_array_equal(only_npy(out_full), only_npy(out_resume))


def test_cli_save_alphas_per_channel(tmp_path):
    """--save-alphas writes one image per (technique, color channel) — the
    reference's visualiseAlphas layout (render_utils.cpp:189-243)."""
    from romis.cli import main

    out = tmp_path / "alphas"
    assert main(["--scene", "cornell_box_parallelogram_light",
                 "--size", "8", "8", "--mode", "romis", "--format", "npy",
                 "--platform", "cpu", "--save-alphas",
                 "--out", str(out)]) == 0
    files = sorted(f for f in os.listdir(out) if "_alpha_" in f)
    # D1 = num_neighbours_to_sample + 1 = 6 techniques x 3 channels.
    assert len(files) == 18, files
    for cname in ("Red", "Green", "Blue"):
        assert sum(cname in f for f in files) == 6, files
    # Visualisations are alpha-magnitude mixes of orange/blue: finite, >= 0.
    a = np.load(os.path.join(out, files[0]))
    assert np.isfinite(a).all() and (a >= 0).all()


def test_config_parsing(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text("""
command_line_rendering = true
window_size = [320, 240]
scene = 4
output_dir = "out"
[features]
ray_trace_mode = "rmis"
initial_light_samples = 12
unbiased_combination = true
enable_shading = true
enable_recursive = true
[[cameras]]
field_of_view = 42.0
distance_from_look_at = 3.5
look_at = [1.0, 2.0, 3.0]
rotation = [10.0, 20.0, 30.0]
[[lights]]
type = "point"
position = [0.0, 1.0, 0.0]
color = [1.0, 1.0, 1.0]
[[lights]]
type = "parallelogram"
corner = [0.0, 0.0, 0.0]
edges = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
colors = [[1,1,1],[0.5,0.5,0.5],[0.5,0.5,0.5],[1,1,1]]
""")
    cfg = read_config_file(str(p))
    assert cfg.window_size == (320, 240)
    # SceneType ordinal 4 (scene.h:18-26) = CornellBoxParallelogramLight.
    assert cfg.scene == "cornell_box_parallelogram_light"
    assert cfg.features.ray_trace_mode.value == "rmis"
    assert cfg.features.initial_light_samples == 12
    assert cfg.features.unbiased_combination is True
    assert cfg.cameras[0].field_of_view == 42.0
    assert len(cfg.lights) == 2


def test_image_writers(tmp_path):
    img = np.random.default_rng(0).uniform(0, 1.2, (7, 5, 3))
    png = tmp_path / "x.png"
    bmp = tmp_path / "x.bmp"
    write_png(str(png), img)
    write_bmp(str(bmp), img)
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert bmp.read_bytes()[:2] == b"BM"
    try:
        from PIL import Image

        arr = np.asarray(Image.open(png))
        np.testing.assert_array_equal(
            arr, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        arr_b = np.asarray(Image.open(bmp).convert("RGB"))
        np.testing.assert_array_equal(arr_b, arr)
    except ImportError:
        pass
