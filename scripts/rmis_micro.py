"""Micro-profile of the R-MIS / R-OMIS building blocks at 1080p on a GPU:
which piece of the per-iteration sweep dominates. Big arrays travel as jit
ARGUMENTS (closure arrays would be baked in as constants).

Run: python scripts/rmis_micro.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def timed(name, fn, *args, reps=4):
    """fn(*args) -> array; scans reps inside one jit, min-of-3."""

    def scanned(*a):
        def step(s, _):
            return s + jnp.sum(fn(s, *a)), None

        acc, _ = jax.lax.scan(step, jnp.float32(1.0), None, length=reps)
        return acc

    jfn = jax.jit(scanned)
    t0 = time.perf_counter()
    float(jfn(*args))
    comp = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        float(jfn(*args))
        best = min(best, time.perf_counter() - t0)
    print(f"{name:>28}: {best / reps * 1e3:8.1f} ms (compile {comp:.0f}s)",
          flush=True)


def main():
    import __graft_entry__ as ge
    from romis.core.features import Features
    from romis.ops.shading import phong_shade_planes, target_pdf
    from romis.ops.wrs import gen_canonical_samples, visibility
    from romis.render.neighbours import select_neighbour_indices
    from romis.render.restir import trace_primary
    from romis.render.rmis import (
        _gather_neighbourhood, balance_heuristic_weights,
    )
    from romis.render.romis import _colvec_for_samples, solve_alpha
    from romis.core.camera import generate_rays

    res_s = os.environ.get("RMIS_RES", "1080x1920")
    h, w = (int(x) for x in res_s.split("x"))
    scene = ge._flagship_scene()
    cam = ge._flagship_camera(h, w)
    feats = Features()
    d1 = feats.num_neighbours_to_sample + 1
    k = feats.num_samples_in_reservoir
    geometry, lights, nl = scene.geometry, scene.lights, scene.num_lights

    rays = generate_rays(cam, h, w)
    _, ctx = jax.jit(lambda r: trace_primary(r, geometry, feats))(rays)
    key = jax.random.PRNGKey(0)
    ny, nx = jax.jit(lambda c: select_neighbour_indices(key, c, h, w,
                                                        feats))(ctx)
    radius = feats.spatial_resample_radius
    nbhd_ctx, res, nb = jax.jit(
        lambda c, yy, xx: (
            _gather_neighbourhood(c, yy, xx),
            (r := gen_canonical_samples(key, c, lights, nl, geometry,
                                        feats)),
            _gather_neighbourhood(r, yy, xx),
        ))(ctx, ny, nx)

    timed("gen_canonical", lambda s, c: gen_canonical_samples(
        jax.random.fold_in(key, s.astype(jnp.int32)), c, lights, nl,
        geometry, feats).big_w, ctx)

    timed("gather nbhd (res)", lambda s, r, yy, xx: _gather_neighbourhood(
        r.replace(w_sum=r.w_sum * s), yy, xx).w_sum,
        res, ny, nx)

    timed("shade D1*K at receiver", lambda s, c, p, col: jnp.stack(
        phong_shade_planes(
            c, p[:, :, 0] * s, p[:, :, 1], p[:, :, 2],
            col[:, :, 0], col[:, :, 1], col[:, :, 2], feats), axis=2),
        ctx, nb.pos, nb.color)

    timed("visibility D1*K", lambda s, c, p: visibility(
        c.position, p + 0 * s, geometry), ctx, nb.pos)

    timed("colvec J*D1*K", lambda s, n, nc: _colvec_for_samples(
        n.replace(w_sum=n.w_sum * s), nc, nl, feats), nb, nbhd_ctx)

    colvec = jax.jit(lambda n, nc: _colvec_for_samples(n, nc, nl, feats))(
        nb, nbhd_ctx)
    f = jnp.ones((d1, k, 3, h, w))

    def ab(s, colvec, f):
        w_hat = colvec * s
        scale = 1.0 / (1e-37 + float(k) * jnp.sum(colvec, axis=0))
        w_hat = w_hat * scale[None]
        wf = w_hat.reshape(d1, d1 * k, h, w)
        ws = (w_hat * scale[None]).reshape(d1, d1 * k, h, w)
        ff = f.reshape(d1 * k, 3, h, w)
        s_n = d1 * k
        acc = jnp.zeros((h, w))
        for i in range(d1):
            for j in range(i, d1):
                acc = acc + sum(wf[i, t] * wf[j, t] for t in range(s_n))
        for c in range(3):
            for j in range(d1):
                acc = acc + sum(ws[j, t] * ff[t, c] for t in range(s_n))
        return acc

    timed("A/b accumulation", ab, colvec, f)

    a_mat = jnp.broadcast_to(
        jnp.eye(d1)[:, :, None, None] + 1.0, (d1, d1, h, w)) + 0.0
    b_vec = jnp.ones((3, d1, h, w))
    timed("solve_alpha", lambda s, a, b: jnp.stack(
        [solve_alpha(a * s, b)]), a_mat, b_vec)

    recv_p = jax.jit(lambda c, p, col: target_pdf(c, p, col, feats))(
        ctx, nb.pos, nb.color)
    timed("balance heuristic (rmis)",
          lambda s, nc, p, col, rp: balance_heuristic_weights(
              nc, p * s, col, rp, feats), nbhd_ctx, nb.pos, nb.color, recv_p)


if __name__ == "__main__":
    main()
