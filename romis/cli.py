"""Headless CLI batch renderer.

Reference analog: the command-line branch of main() (src/main.cpp:178-234):
read a TOML config, load the scene, render one image per camera, write
BMP/PNG files to the output dir, print per-image and total timings.

Differences by design:
- cameras are rendered sequentially (or as one batch) on the accelerator
  instead of one std::thread each (main.cpp:213-230);
- the reference's unsynchronized cross-camera previousFrameGrid reuse
  (main.cpp:221 — a data race, and "temporal" reuse across *cameras*) is
  replaced by --frames N: N temporally-reused frames per camera;
- deterministic: --seed controls every sample.

Usage:
    python -m romis.cli --config configs/cornell.toml
    python -m romis.cli --scene cornell_nightclub --size 1920 1080 \
        --mode restir --frames 4 --out renders/
"""

from __future__ import annotations

import argparse
import datetime
import sys
import time

import jax
import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="romis headless renderer")
    p.add_argument("--config", help="TOML config file (reference schema)")
    p.add_argument("--scene", help="prebuilt scene name or .obj path")
    p.add_argument("--size", nargs=2, type=int, metavar=("W", "H"))
    p.add_argument("--mode", choices=["restir", "rmis", "romis"])
    p.add_argument("--frames", type=int, default=1,
                   help="temporal frames per camera (ReSTIR)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help="output directory")
    p.add_argument("--format", choices=["png", "bmp", "npy"], default="png")
    p.add_argument("--checkpoint", metavar="PATH",
                   help="checkpoint file prefix for --frames runs: resume "
                        "from it when present, save the final temporal "
                        "state to it after rendering (bit-identical resume, "
                        "io/checkpoint.py)")
    p.add_argument("--platform", help="force a JAX platform (e.g. cpu)")
    p.add_argument("--save-alphas", action="store_true",
                   help="R-OMIS: save per-technique alpha visualisations")
    p.add_argument("--debug-vis", action="store_true",
                   help="save diagnostic images (hit mask, depth, normals, "
                        "shadow visibility, reservoir stats)")
    args = p.parse_args(argv)

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from .utils.runtime import setup_compile_cache

    setup_compile_cache()

    # Multi-host: a no-op unless the standard cluster env vars are set
    # (parallel/launch.py) — the same CLI serves one process and a cluster.
    from .parallel.launch import maybe_init_distributed

    maybe_init_distributed()

    from .core.camera import make_camera
    from .core.features import RayTraceMode
    from .io.config import CameraConfig, Config, read_config_file
    from .io.image import write_image
    from .render.pipeline import render_frame, write_provenance
    from .render.romis import render_romis
    from .scene.scene import load_prebuilt, load_scene_from_file

    if args.config:
        cfg = read_config_file(args.config)
    else:
        cfg = Config()
        cfg.cameras = [CameraConfig()]
    if args.scene:
        cfg.scene = args.scene
        cfg.scene_is_file = args.scene.endswith(".obj")
    if args.size:
        cfg.window_size = (args.size[0], args.size[1])
    if args.mode:
        cfg.features = cfg.features.replace(
            ray_trace_mode=RayTraceMode(args.mode))
    if args.out:
        cfg.output_dir = args.out

    w, h = cfg.window_size
    if cfg.scene_is_file:
        scene = load_scene_from_file(cfg.scene, cfg.lights,
                                     data_dir=cfg.data_path)
    else:
        scene = load_prebuilt(cfg.scene, args.seed)
    print(f"scene: {scene.name} ({int(np.asarray(scene.geometry.active).sum())}"
          f" tris, {scene.num_lights} lights), {w}x{h}, "
          f"mode={cfg.features.ray_trace_mode.value}, "
          f"platform={jax.devices()[0].platform}", file=sys.stderr)

    stamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    t_total = time.perf_counter()
    key = jax.random.PRNGKey(args.seed)

    for i, cam_cfg in enumerate(cfg.cameras):
        cam = make_camera(
            look_at=cam_cfg.look_at, rotation_deg=cam_cfg.rotation,
            distance=cam_cfg.distance_from_look_at,
            fov_deg=cam_cfg.field_of_view, resolution=(h, w),
        )
        t0 = time.perf_counter()
        cam_key = jax.random.fold_in(key, i)
        if args.debug_vis:
            import os as _os

            from .utils.debug_vis import debug_images, save_debug_images

            _os.makedirs(cfg.output_dir, exist_ok=True)
            paths = save_debug_images(
                f"{cfg.output_dir}/{scene.name}_{stamp}_cam_{i}_debug",
                debug_images(cam_key, cam, scene, h, w, cfg.features))
            print(f"debug images: {len(paths)} saved", file=sys.stderr)
        state = None
        img = None
        if (cfg.features.ray_trace_mode == RayTraceMode.ROMIS
                and args.save_alphas):
            img, alphas = jax.jit(
                render_romis,
                static_argnums=(4, 5, 6, 7, 8),
            )(cam_key, cam, scene.geometry, scene.lights, scene.num_lights,
              h, w, cfg.features, True)
            alphas = np.asarray(alphas)  # [D1, H, W, 3]
            import os

            os.makedirs(cfg.output_dir, exist_ok=True)
            # One image per (technique, color channel) — orange = positive,
            # blue = negative α, scaled by |α| (visualiseAlphas,
            # render_utils.cpp:189-243: glm::mix(zero, pureColor, ±α)).
            for d in range(alphas.shape[0]):
                for c, cname in enumerate(("Red", "Green", "Blue")):
                    a = alphas[d][..., c:c + 1]  # [H, W, 1]
                    vis = np.where(a > 0.0, a * [[1.0, 0.5, 0.0]],
                                   -a * [[0.0, 0.5, 1.0]])
                    write_image(
                        f"{cfg.output_dir}/{scene.name}_{stamp}_cam_{i}"
                        f"_alpha_{d}_{cname}.{args.format}",
                        np.clip(vis, 0.0, 1.0))
        elif (cfg.features.ray_trace_mode == RayTraceMode.RESTIR
              and args.frames > 1):
            # Multi-frame temporal runs go through render_animation's
            # lax.scan (one compiled program) with optional bit-exact
            # checkpoint resume. Per-frame keys are fold_in(cam_key, f) —
            # independent of the frame count, so a resumed run consumes
            # exactly the keys the uninterrupted run would.
            import os

            import jax.numpy as jnp

            from .io.checkpoint import load_checkpoint, save_checkpoint
            from .render.animation import render_animation
            from .render.restir import initial_temporal_state

            frames = args.frames
            start = 0
            prev = initial_temporal_state(
                h, w, cfg.features.num_samples_in_reservoir, cam)
            ckpt = f"{args.checkpoint}_cam{i}.npz" if args.checkpoint \
                else None
            if ckpt and os.path.exists(ckpt):
                prev, _, last_done = load_checkpoint(ckpt, prev)
                start = last_done + 1
                print(f"resumed {ckpt} at frame {start}", file=sys.stderr)
            if start >= frames:
                raise SystemExit(
                    f"checkpoint {ckpt} already covers frame {start - 1}; "
                    f"raise --frames above {frames} to continue the run")
            keys = jnp.stack([jax.random.fold_in(cam_key, f)
                              for f in range(start, frames)])
            cams_f = jax.tree.map(
                lambda a: jnp.broadcast_to(
                    a[None], (keys.shape[0],) + np.shape(a)), cam)
            imgs, state = jax.jit(
                render_animation, static_argnums=(4, 5, 6, 7),
            )(cam_key, cams_f, scene.geometry, scene.lights,
              scene.num_lights, h, w, cfg.features, prev, keys)
            img = imgs[-1]
            if ckpt:
                if os.path.dirname(ckpt):
                    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
                save_checkpoint(ckpt, jax.device_get(state), cam_key,
                                frames - 1)
                print(f"checkpoint saved to {ckpt}", file=sys.stderr)
        else:
            for f in range(max(args.frames, 1)):
                img, state = render_frame(
                    jax.random.fold_in(cam_key, f), cam, scene, h, w,
                    cfg.features, state)
        img = np.asarray(img)
        dt = (time.perf_counter() - t0) * 1000
        out_path = (f"{cfg.output_dir}/{scene.name}_{stamp}_cam_{i}"
                    f".{args.format}")
        import os

        os.makedirs(cfg.output_dir, exist_ok=True)
        write_image(out_path, img)
        # Reference prints "Render time: {}ms" per frame (main.cpp:168-170)
        # and "Image {} saved to {}" (main.cpp:224).
        print(f"Render time: {dt:.0f}ms", file=sys.stderr)
        print(f"Image {i} saved to {out_path}", file=sys.stderr)

    write_provenance(cfg.features, cfg.output_dir)
    total = (time.perf_counter() - t_total) * 1000
    print(f"Rendering took {total:.0f} ms, {len(cfg.cameras)} images "
          f"rendered.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
