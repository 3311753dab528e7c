"""Benchmark: one ReSTIR frame-stream cell on one GPU.

Prints ONE JSON line naming the device, with ms/frame, rays/s and
reservoir updates/s. Fails when JAX finds no GPU.

BENCH_CONFIG picks a BASELINE.md workload by scene name (default 5: the
Cornell Nightclub, 512 parallelogram area lights, 1920x1080, full
spatiotemporal ReSTIR at the reference defaults, src/utils/common.h:103-131;
6: the 5x5 blob field, 24,002 triangles, through the BVH traversal).

Rays counted per frame: primary (H*W) + final-shade shadow rays (H*W*K).
"""

import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp


def _config(config: int):
    """(scene, (h, w), Features, camera kwargs) of a BASELINE.md config."""
    from romis.core.features import Features
    from romis.ops.bvh import with_bvh
    from romis.scene.scene import load_blob_field, load_prebuilt

    nightclub_cam = dict(look_at=(2.57, 1.23, -1.35),
                         rotation_deg=(10.3, 30.0, 0.0), distance=25.0,
                         fov_deg=30.0)
    cornell_cam = dict(look_at=(0, 0, 0), rotation_deg=(0, 0, 0),
                       distance=2.5, fov_deg=50)
    if config == 6:
        scene = load_blob_field(5)
        scene.geometry = with_bvh(scene.geometry)
        return scene, (1080, 1920), Features(), dict(
            look_at=(0, 0, 0), rotation_deg=(25, 30, 0), distance=11.0,
            fov_deg=50)
    name, hw, features, cam_kw = {
        1: ("single_triangle", (256, 256),
            Features(spatial_reuse=False, temporal_reuse=False),
            dict(look_at=(0, 0, 0), rotation_deg=(0, 0, 0), distance=3.0,
                 fov_deg=50)),
        2: ("cube", (512, 512),
            Features(spatial_reuse=False, temporal_reuse=False,
                     initial_samples_visibility_check=True),
            dict(look_at=(0, 0, 0), rotation_deg=(15, 30, 0), distance=3.0,
                 fov_deg=50)),
        3: ("cornell_box_parallelogram_light", (512, 512),
            Features(temporal_reuse=False), cornell_cam),
        4: ("cornell_box_parallelogram_light", (1080, 1920),
            Features(temporal_reprojection=True), cornell_cam),
        5: ("cornell_nightclub", (1080, 1920), Features(), nightclub_cam),
    }[config]
    return load_prebuilt(name), hw, features, cam_kw


def main():
    from romis.utils.runtime import card_info, require_gpu, setup_compile_cache

    setup_compile_cache()
    dev = require_gpu()

    from romis.core.camera import make_camera
    from romis.render.restir import (
        initial_temporal_state, render_restir_frame,
    )

    config = int(os.environ.get("BENCH_CONFIG", "5"))
    scene, (h, w), features, cam_kw = _config(config)
    cam = make_camera(resolution=(h, w), **cam_kw)
    prev = initial_temporal_state(h, w, features.num_samples_in_reservoir,
                                  cam)
    n_frames = 20

    @jax.jit
    def frames(key, prev):
        def body(state, k):
            img, state = render_restir_frame(
                k, cam, scene.geometry, scene.lights, scene.num_lights,
                h, w, features, state)
            return state, jnp.mean(img)
        return jax.lax.scan(body, prev, jax.random.split(key, n_frames))

    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    jax.block_until_ready(frames(key, prev))  # compile + warm-up
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(frames(jax.random.fold_in(key, i + 1), prev))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)

    k = features.num_samples_in_reservoir
    rays_per_frame = h * w * (1 + k)  # primary + final shadow rays
    reservoir_updates_per_frame = h * w * (
        features.initial_light_samples
        + features.spatial_resampling_passes
        * (features.num_neighbours_to_sample + 1) * k
        + 2 * k  # temporal 2-way combine
    )
    print(card_info(), file=sys.stderr)
    print(json.dumps({
        "config": config, "scene": scene.name, "resolution": [w, h],
        "ms_per_frame": 1000 * dt / n_frames,
        "window_ms": [1000 * t for t in times],
        "rays_per_s": rays_per_frame * n_frames / dt,
        "reservoir_updates_per_s": reservoir_updates_per_frame * n_frames
        / dt,
        "compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
