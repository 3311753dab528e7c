"""Scene loading edge cases and the texture sampling path."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from romis.core.camera import make_camera
from romis.core.features import Features
from romis.ops.shading import acquire_texel, diffuse_albedo
from romis.render.restir import initial_temporal_state, render_restir_frame
from romis.scene.objloader import load_obj
from romis.scene.scene import (
    PREBUILT_SCENES, build_geometry, load_blob_field, load_prebuilt,
    load_scene_from_file,
)
from romis.scene.lights import LightListBuilder


def test_obj_face_formats(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text("""
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
f 1 2 3
f 1//1 2//1 3//1
f 1/1/1 2/2/1 3/3/1
f -4 -3 -2 -1
""")
    subs = load_obj(str(p))
    assert len(subs) == 1
    # 3 triangles + 1 quad (fan → 2) = 5 triangles.
    assert len(subs[0].triangles) == 5
    # Normals: either from vn or geometric; all unit.
    np.testing.assert_allclose(
        np.linalg.norm(subs[0].normals, axis=-1), 1.0, rtol=1e-5)


def test_obj_material_split(tmp_path):
    (tmp_path / "m.mtl").write_text("""
newmtl red
Kd 1 0 0
Ns 7
newmtl blue
Kd 0 0 1
Ks 0.5 0.5 0.5
""")
    p = tmp_path / "m.obj"
    p.write_text("""
mtllib m.mtl
v 0 0 0
v 1 0 0
v 0 1 0
usemtl red
f 1 2 3
usemtl blue
f 1 2 3
usemtl red
f 1 2 3
""")
    subs = load_obj(str(p))
    assert [s.material.name for s in subs] == ["red", "blue", "red"]
    assert subs[0].material.kd == (1.0, 0.0, 0.0)
    assert subs[1].material.ks == (0.5, 0.5, 0.5)
    assert subs[0].material.shininess == 7.0


def test_acquire_texel_indexing():
    """texture.cpp:4-9: x = u*(W-1), y = v*(H-1), row-major nearest."""
    tex = np.arange(2 * 3 * 4 * 3, dtype=np.float32).reshape(2, 3, 4, 3)
    tex_size = jnp.asarray([[3, 4], [2, 2]], jnp.int32)
    uv = jnp.asarray([1.0, 0.5]).reshape(2, 1, 1)  # u=1, v=0.5 → x=3, y=1
    tid = jnp.zeros((1, 1), jnp.int32)
    out = np.asarray(acquire_texel(jnp.asarray(tex), tex_size, tid, uv))
    np.testing.assert_allclose(out[:, 0, 0], tex[0, 1, 3])


def test_cube_textured_scene_renders():
    scene = load_prebuilt("cube_textured")
    has_tex = int(np.asarray(scene.geometry.mat_tex_id).max()) >= 0
    assert has_tex  # the procedural checker texture
    h, w = 24, 24
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(15, 30, 0),
                      distance=3.0, fov_deg=50, resolution=(h, w))
    feats = Features(spatial_resample_radius=2, initial_light_samples=8)
    prev = initial_temporal_state(h, w, feats.num_samples_in_reservoir, cam)
    img, _ = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))(
        jax.random.PRNGKey(0), cam, scene.geometry, scene.lights,
        scene.num_lights, h, w, feats, prev)
    img = np.asarray(img)
    assert np.isfinite(img).all() and img.max() > 0
    if has_tex:
        # Textured and untextured renders must differ.
        feats2 = feats.replace(enable_texture_mapping=False)
        img2, _ = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))(
            jax.random.PRNGKey(0), cam, scene.geometry, scene.lights,
            scene.num_lights, h, w, feats2, prev)
        assert not np.array_equal(img, np.asarray(img2))


@pytest.mark.parametrize("name", ["blob", "cornell_box", "cube"])
def test_remaining_prebuilt_scenes_render(name):
    scene = load_prebuilt(name)
    h, w = 16, 16
    cam = make_camera(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                      distance=3.0, fov_deg=50, resolution=(h, w))
    feats = Features(spatial_resample_radius=2, initial_light_samples=4)
    prev = initial_temporal_state(h, w, feats.num_samples_in_reservoir, cam)
    img, _ = jax.jit(render_restir_frame, static_argnums=(4, 5, 6, 7))(
        jax.random.PRNGKey(0), cam, scene.geometry, scene.lights,
        scene.num_lights, h, w, feats, prev)
    assert np.isfinite(np.asarray(img)).all()


# (triangles, lights) of every generated scene; the Cornell box and the
# nightclub light grid keep the reference's counts (scene.cpp:30-66).
_COUNTS = {"single_triangle": (1, 1), "cube": (12, 1),
           "cube_textured": (12, 1), "cornell_box": (32, 1),
           "cornell_box_parallelogram_light": (32, 1),
           "cornell_nightclub": (166, 512), "blob": (960, 2)}


@pytest.mark.parametrize("name", PREBUILT_SCENES)
def test_prebuilt_scene_deterministic_counts(name):
    a, b = load_prebuilt(name, seed=3), load_prebuilt(name, seed=3)
    assert (int(np.asarray(a.geometry.active).sum()), a.num_lights) == \
        _COUNTS[name]
    for x, y in zip(jax.tree.leaves((a.geometry, a.lights)),
                    jax.tree.leaves((b.geometry, b.lights))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    if name in ("cornell_nightclub", "blob"):  # the seeded scenes
        c = load_prebuilt(name, seed=4)
        assert not np.array_equal(np.asarray(a.geometry.v0),
                                  np.asarray(c.geometry.v0))


def test_blob_field_size_and_determinism():
    """n=5 stays above 24k triangles (the large-scene workload); n=2 is
    the small field the sharded large-scene tests use."""
    big = load_blob_field(5)
    assert int(np.asarray(big.geometry.active).sum()) >= 24_000
    small, again = load_blob_field(2, seed=1), load_blob_field(2, seed=1)
    assert int(np.asarray(small.geometry.active).sum()) == 4 * 960 + 2
    np.testing.assert_array_equal(np.asarray(small.geometry.v0),
                                  np.asarray(again.geometry.v0))


def test_load_prebuilt_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown prebuilt scene"):
        load_prebuilt("monkey")


def test_load_scene_from_file_uses_data_dir(tmp_path, monkeypatch):
    (tmp_path / "tri.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    lights = LightListBuilder().add_point((0, 0, -1), (1, 1, 1))
    monkeypatch.setenv("ROMIS_DATA_DIR", str(tmp_path))
    scene = load_scene_from_file("tri.obj", lights)
    assert scene.name == "tri" and scene.num_lights == 1
    monkeypatch.delenv("ROMIS_DATA_DIR")
    with pytest.raises(FileNotFoundError):
        load_scene_from_file("tri.obj", lights)
    assert load_scene_from_file("tri.obj", lights,
                                data_dir=str(tmp_path)).name == "tri"
