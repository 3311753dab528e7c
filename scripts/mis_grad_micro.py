"""Per-stage decomposition of the 1080p MIS gradient step on a GPU: where
does the step's time go, and what would an analytic target_pdf VJP buy?

Each stage times value_and_grad of an isolated piece on the production
shapes (nightclub 1080p, D1=6, K=2), differentiated w.r.t. the arrays that
stage consumes. Big arrays ride as jit ARGUMENTS (closure arrays would be
baked in as constants); reps inside one jitted scan, min-of-3.

Run: python scripts/mis_grad_micro.py [stages...]
Stages: trace canon canon_surr gather sweep_equal sweep_balance colvec ab
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def _salt(tree, s):
    """Loop-step-dependent denormal perturbation of every float leaf — a
    constant-arg scan body gets HOISTED by XLA and the printed time is
    total/reps (see scripts/config7_micro.py _salt)."""
    return jax.tree.map(
        lambda l: l + s if jnp.issubdtype(l.dtype, jnp.floating) else l,
        tree)


def timed(name, make_loss, args, reps=2):
    """make_loss() -> loss_fn(*args) scalar; times value_and_grad wrt
    args[0] (a pytree)."""
    loss_fn = make_loss()

    def scanned(p, *rest):
        def step(s, i):
            p2 = _salt(p, i.astype(jnp.float32) * 1e-30)
            l_, g = jax.value_and_grad(loss_fn)(p2, *rest)
            return s + l_ + sum(jnp.sum(jnp.abs(x))
                                for x in jax.tree.leaves(g)), None

        acc, _ = jax.lax.scan(step, jnp.float32(0.0), jnp.arange(reps))
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
    print(f"{name:>16}: {best / reps * 1e3:8.1f} ms/grad (compile "
          f"{comp:.0f}s)", flush=True)
    return best / reps * 1e3


def main():
    import __graft_entry__ as ge
    from types import SimpleNamespace

    from romis.core.camera import generate_rays
    from romis.core.features import Features, MISWeight, RayTraceMode
    from romis.ops.wrs import gen_canonical_samples
    from romis.render.neighbours import select_neighbour_indices
    from romis.render.restir import trace_primary
    from romis.render.rmis import (
        PH_NEIGHBOURS, _gather_neighbourhood, rmis_sample_contrib,
    )
    from romis.render.romis import (
        _colvec_for_samples, romis_ab_from_colvec,
    )

    sel = sys.argv[1:] or ["trace", "canon", "canon_surr", "gather",
                           "sweep_equal", "sweep_balance", "colvec", "ab"]
    res_s = os.environ.get("RMIS_RES", "1080x1920")
    h, w = (int(x) for x in res_s.split("x"))
    scene = ge._flagship_scene()
    cam = ge._flagship_camera(h, w)
    geometry, lights, nl = scene.geometry, scene.lights, scene.num_lights
    feats = Features(ray_trace_mode=RayTraceMode.RMIS,
                     enable_tone_mapping=False)
    feats_bal = feats.replace(mis_weight_rmis=MISWeight.BALANCE)
    key = jax.random.PRNGKey(0)
    radius = feats.spatial_resample_radius

    rays = generate_rays(cam, h, w)
    _, ctx = trace_primary(rays, geometry, feats)
    ny, nx = select_neighbour_indices(
        jax.random.fold_in(key, PH_NEIGHBOURS), ctx, h, w, feats)
    res = gen_canonical_samples(jax.random.fold_in(key, 7), ctx, lights,
                                nl, geometry, feats)
    d1 = feats.num_neighbours_to_sample + 1

    def gather_planes(tree):
        return _gather_neighbourhood(tree, ny, nx)

    nb_dict = jax.jit(gather_planes)(dict(
        px=res.pos[:, 0], py=res.pos[:, 1], pz=res.pos[:, 2],
        cr=res.color[:, 0], cg=res.color[:, 1], cb=res.color[:, 2],
        w_sum=res.w_sum, chosen=res.chosen_w, m=res.m, big_w=res.big_w))
    nb_dict = jax.tree.map(jnp.asarray, nb_dict)

    def to_nb(g):
        return SimpleNamespace(
            pos=jnp.stack([g["px"], g["py"], g["pz"]], axis=2),
            color=jnp.stack([g["cr"], g["cg"], g["cb"]], axis=2),
            w_sum=g["w_sum"], chosen_w=g["chosen"], m=g["m"],
            big_w=g["big_w"])

    def nbhd_stream(ctx_):
        return lambda j: jax.tree.map(
            lambda a: a[0], _gather_neighbourhood(
                ctx_,
                jax.lax.dynamic_slice_in_dim(ny, j, 1, 0),
                jax.lax.dynamic_slice_in_dim(nx, j, 1, 0)))

    if "trace" in sel:
        def mk():
            def loss(p):
                g2 = geometry.replace(v0=p["v0"], e1=p["e1"], e2=p["e2"])
                from romis.scene.scene import repack_rows

                g2 = repack_rows(g2)
                _, c2 = trace_primary(rays, g2, feats)
                return (jnp.sum(c2.position) + jnp.sum(c2.normal)
                        + jnp.sum(c2.kd))
            return loss
        timed("trace", mk,
              (dict(v0=geometry.v0, e1=geometry.e1, e2=geometry.e2),))

    for nm, surr in (("canon", False), ("canon_surr", True)):
        if nm not in sel:
            continue

        def mk(surr=surr):
            f2 = feats.replace(surrogate_resampling_grad=surr)

            def loss(rows, ctx_):
                l2 = lights.replace(rows=rows)
                r = gen_canonical_samples(jax.random.fold_in(key, 9), ctx_,
                                          l2, nl, geometry, f2)
                return (jnp.sum(r.pos) + jnp.sum(r.color) + jnp.sum(r.big_w)
                        + jnp.sum(r.w_sum) + jnp.sum(r.chosen_w))
            return loss
        timed(nm, mk, (lights.rows, ctx))

    if "gather" in sel:
        def mk():
            def loss(planes):
                g = gather_planes(planes)
                return sum(jnp.sum(v) for v in g.values())
            return loss
        timed("gather", mk, (dict(
            px=res.pos[:, 0], py=res.pos[:, 1], pz=res.pos[:, 2],
            cr=res.color[:, 0], cg=res.color[:, 1], cb=res.color[:, 2],
            w_sum=res.w_sum, chosen=res.chosen_w, m=res.m),))

    if "sweep_equal" in sel:
        def mk():
            def loss(g, ctx_):
                return jnp.sum(rmis_sample_contrib(
                    ctx_, None, to_nb(g), geometry, feats))
            return loss
        timed("sweep_equal", mk, (nb_dict, ctx))

    if "sweep_balance" in sel:
        def mk():
            def loss(g, ctx_):
                return jnp.sum(rmis_sample_contrib(
                    ctx_, nbhd_stream(ctx_), to_nb(g), geometry, feats_bal))
            return loss
        timed("sweep_balance", mk, (nb_dict, ctx))

    if "colvec" in sel:
        def mk():
            def loss(g, ctx_):
                cv = _colvec_for_samples(to_nb(g), nbhd_stream(ctx_), nl,
                                         feats)
                return jnp.sum(cv)
            return loss
        timed("colvec", mk, (nb_dict, ctx))

    if "ab" in sel:
        cv0 = jax.jit(lambda g, c: _colvec_for_samples(
            to_nb(g), nbhd_stream(c), nl, feats))(nb_dict, ctx)
        cv0 = jnp.asarray(cv0)
        alphas = jnp.zeros((3, d1, h, w))

        def mk():
            def loss(cv, g, ctx_):
                a_d, b_d, _ = romis_ab_from_colvec(
                    ctx_, to_nb(g), cv, alphas, geometry, feats)
                return jnp.sum(a_d) + jnp.sum(b_d)
            return loss
        timed("ab", mk, (cv0, nb_dict, ctx))


if __name__ == "__main__":
    main()
