"""Band-sequential R-MIS / R-OMIS rendering — the single-chip road to
1080p MIS gradients.

The reference parallelises every MIS pixel loop over rows
(render.cpp:76-78,145-147); the neighbourhood any pixel reads is bounded by
±spatial_resample_radius rows (neighbour_selection.cpp:55-58). So the frame
decomposes into independent horizontal bands + a radius-row halo — the same
row-band decomposition the sharded path (parallel/mis.py) spreads over a
device mesh, here run *sequentially* on one chip as a ``lax.scan`` over
bands with a ``jax.checkpoint``-ed band body.

Why: reverse-mode R-OMIS at 1080p exceeds single-chip HBM in every
whole-frame decomposition tried (perf_artifacts.json
mis_gradient_step_ms.hbm_note — the irreducible core is the
O(J·D1·K)=72-way Phong backward at 2M pixels). The scan's backward is
inherently sequential, so one band's rematerialised residuals are live at a
time: peak memory divides by ``n_bands`` while the forward is recomputed
once per band (the standard checkpoint trade).

Estimator contract: identical to render_rmis / render_romis. Canonical
reservoirs for a band (and its halo rows) are generated band-locally with
per-band folded keys — the same per-device RNG caveat as the sharded path:
sample-wise images differ from the single-pass renderers, estimator
statistics match. With ``inject`` (explicit neighbour coords + per-iteration
reservoirs) the banded render is exactly the single-pass computation re-read
through band slices, which is what tests/test_grad_banded.py asserts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.camera import CameraParams, generate_rays
from ..core.features import Features, MISWeight, RayTraceMode
from ..ops.shading import exposure_tone_mapping
from ..ops.wrs import gen_canonical_samples
from ..render.neighbours import select_neighbour_indices
from ..render.restir import trace_primary
from ..render.rmis import (
    PH_ITER, PH_NEIGHBOURS, _gather_neighbourhood, rmis_sample_contrib,
)
from ..render.romis import romis_ab_from_colvec, solve_alpha


def _band_stack(tree, n_bands: int, h_loc: int, radius: int):
    """Every leaf [..., H, W] → overlapping band slices
    [n_bands, ..., h_loc + 2·radius, W] of the radius-row zero-padded image.
    The pad rows are never gathered (neighbour coords are clamped inside the
    image, so a center row's local index stays ≥ radius − global_row)."""
    h_ext = h_loc + 2 * radius

    def one(a):
        pad = [(0, 0)] * (a.ndim - 2) + [(radius, radius), (0, 0)]
        ap = jnp.pad(a, pad)
        ax = a.ndim - 2
        return jnp.stack([
            jax.lax.slice_in_dim(ap, b * h_loc, b * h_loc + h_ext, axis=ax)
            for b in range(n_bands)])

    return jax.tree.map(one, tree)


def _center_stack(a, n_bands: int, h_loc: int):
    """[D1, H, W] → [n_bands, D1, h_loc, W] (non-overlapping rows)."""
    d1, _, w = a.shape
    return jnp.moveaxis(a.reshape(d1, n_bands, h_loc, w), 1, 0)


def render_mis_banded(
    key,
    cam: CameraParams,
    geometry,
    lights,
    num_lights: int,
    height: int,
    width: int,
    features: Features,
    n_bands: int,
    inject=None,  # (ny, nx, [Reservoirs per iteration]) — parity tests
):
    """R-MIS or R-OMIS (selected by features.ray_trace_mode) rendered as a
    sequential scan over ``n_bands`` row bands → tone-mapped image
    [H, W, 3]. Always the differentiable XLA formulation — this function
    exists for its backward (see module docstring); forward-only rendering
    should use render_rmis / render_romis."""
    assert height % n_bands == 0, "image rows must divide n_bands"
    h_loc = height // n_bands
    radius = features.spatial_resample_radius
    assert h_loc >= radius, (
        f"band height {h_loc} must cover the halo radius {radius}")
    h_ext = h_loc + 2 * radius
    d1 = features.num_neighbours_to_sample + 1
    it_n = features.max_iterations_mis
    is_rmis = features.ray_trace_mode == RayTraceMode.RMIS
    progressive = (not is_rmis) and features.use_progressive_romis
    need_ctx = (not is_rmis) or features.mis_weight_rmis == MISWeight.BALANCE

    rays = generate_rays(cam, height, width)
    _, ctx = trace_primary(rays, geometry, features)
    if inject is not None:
        ny, nx = inject[0], inject[1]
        res_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *inject[2])
    else:
        ny, nx = select_neighbour_indices(
            jax.random.fold_in(key, PH_NEIGHBOURS), ctx, height, width,
            features)
        res_stack = None

    rows = jnp.arange(height, dtype=jnp.int32)[:, None]
    cols = jnp.arange(width, dtype=jnp.int32)[None, :]
    offs_y = ny.astype(jnp.int32) - rows[None]  # [D1, H, W], |dy| ≤ radius
    offs_x = nx.astype(jnp.int32) - cols[None]

    ctx_bands = _band_stack(ctx, n_bands, h_loc, radius)
    oy_bands = _center_stack(offs_y, n_bands, h_loc)
    ox_bands = _center_stack(offs_x, n_bands, h_loc)
    res_bands = (_band_stack(res_stack, n_bands, h_loc, radius)
                 if res_stack is not None else None)

    rows_ext = jnp.arange(h_ext, dtype=jnp.int32)[None, :, None]
    cols_b = jnp.arange(width, dtype=jnp.int32)[None, None, :]
    zpad = jnp.zeros((d1, radius, width), jnp.int32)

    def slice_center(a):
        # static center-rows slice of a [..., h_ext, W] leaf
        return jax.lax.slice_in_dim(a, radius, radius + h_loc,
                                    axis=a.ndim - 2)

    def band_color(ctx_b, oy_c, ox_c, b, res_b):
        """One band's [3, h_loc, W] linear color."""
        # Halo rows gather themselves (offset 0): keeps every gather the
        # same [D1, h_ext, W]-shaped exact-offset fetch as the single-pass
        # path (|dy|,|dx| ≤ radius).
        oy = jnp.concatenate([zpad, oy_c, zpad], axis=1)  # [D1, h_ext, W]
        ox = jnp.concatenate([zpad, ox_c, zpad], axis=1)
        ny_l = rows_ext + oy
        nx_l = cols_b + ox
        ctx_c = jax.tree.map(slice_center, ctx_b)
        dkey = jax.random.fold_in(jax.random.fold_in(key, PH_ITER), b)
        it_keys = jax.random.split(dkey, it_n)

        def gather_nb(rc):
            g = _gather_neighbourhood(rc, ny_l, nx_l)
            return jax.tree.map(slice_center, g)

        from ..render.rmis import slim_ctx_stream

        nbhd_ctx = (slim_ctx_stream(ctx_b, ny_l, nx_l, view_ctx=ctx_c,
                                    post=slice_center)
                    if need_ctx else None)

        # Replay-records gathers engage only on the whole-frame paths
        # (render_rmis/render_romis); the banded path gathers the plain
        # reservoir planes.
        use_rec = False

        def res_for(it_key, it_i):
            if res_b is not None:
                return jax.tree.map(
                    lambda a: jax.lax.dynamic_index_in_dim(a, it_i, 0,
                                                           False), res_b), \
                    None
            if use_rec:
                from ..ops.wrs import gen_canonical_with_records

                return gen_canonical_with_records(
                    it_key, ctx_b, lights, num_lights, geometry, features)
            return gen_canonical_samples(it_key, ctx_b, lights, num_lights,
                                         geometry, features), None

        if is_rmis:
            def it_body(acc, xs):
                it_key, it_i = xs
                res, rec = res_for(it_key, it_i)
                from types import SimpleNamespace

                if rec is not None:
                    # Replay-records gather: pos/color re-derived at the
                    # receiver, only big_w rides the differentiable gather
                    # (rmis.gather_nb_records — the gather backward is the
                    # dominant banded-gradient stage).
                    from ..render.rmis import gather_nb_records

                    pos, color, g_dif, _ = gather_nb_records(
                        gather_nb, rec, lights,
                        diff=dict(big_w=res.big_w))
                    nb = SimpleNamespace(pos=pos, color=color,
                                         big_w=g_dif["big_w"])
                else:
                    nb = SimpleNamespace(**gather_nb(
                        dict(pos=res.pos, color=res.color,
                             big_w=res.big_w)))
                return acc + rmis_sample_contrib(
                    ctx_c, nbhd_ctx, nb, geometry, features), None

            acc, _ = jax.lax.scan(
                jax.checkpoint(it_body), jnp.zeros((3, h_loc, width)),
                (it_keys, jnp.arange(it_n)))
            return acc / it_n

        # ===== R-OMIS =====
        from types import SimpleNamespace

        from ..render.romis import _colvec_rows

        def it_body(carry, xs):
            a_mat, b_vec, final_colors, alphas = carry
            it_key, it_i = xs
            if progressive:
                # Same traced-select α refresh + conditioning bump as
                # render_romis's scan body (see its gradient-path notes).
                do = ((it_i >= 1)
                      & (it_i % features.progressive_update_mod == 0))
                bump = (1.0 - do.astype(jnp.float32))
                a_safe = a_mat + bump * jnp.eye(d1)[:, :, None, None]
                alphas = jnp.where(do, solve_alpha(a_safe, b_vec), alphas)
                final_colors = final_colors + jnp.sum(alphas, axis=1)
            res, rec = res_for(it_key, it_i)
            if rec is not None:
                from ..render.rmis import gather_nb_records

                pos, color, g_dif, g_det = gather_nb_records(
                    gather_nb, rec, lights,
                    diff=dict(w_sum=res.w_sum, chosen=res.chosen_w),
                    det=dict(m=res.m))
                nb = SimpleNamespace(pos=pos, color=color,
                                     w_sum=g_dif["w_sum"],
                                     chosen_w=g_dif["chosen"],
                                     m=g_det["m"])
            else:
                rc = dict(
                    px=res.pos[:, 0], py=res.pos[:, 1], pz=res.pos[:, 2],
                    cr=res.color[:, 0], cg=res.color[:, 1],
                    cb=res.color[:, 2],
                    w_sum=res.w_sum, chosen=res.chosen_w, m=res.m)
                g = gather_nb(rc)
                nb = SimpleNamespace(
                    pos=jnp.stack([g["px"], g["py"], g["pz"]], axis=2),
                    color=jnp.stack([g["cr"], g["cg"], g["cb"]], axis=2),
                    w_sum=g["w_sum"], chosen_w=g["chosen"], m=g["m"])
            # List-mode colvec + reduction-form A/b: the banded backward's
            # fast formulation (see _colvec_rows / _romis_ab_rows notes).
            colvec = _colvec_rows(nb, nbhd_ctx, num_lights, features)
            a_d, b_d, prog = romis_ab_from_colvec(
                ctx_c, nb, colvec, alphas, geometry, features)
            if progressive:
                final_colors = final_colors + prog
            return (a_mat + a_d, b_vec + b_d, final_colors, alphas), None

        init = (jnp.zeros((d1, d1, h_loc, width)),
                jnp.zeros((3, d1, h_loc, width)),
                jnp.zeros((3, h_loc, width)),
                jnp.zeros((3, d1, h_loc, width)))
        (a_mat, b_vec, final_colors, alphas), _ = jax.lax.scan(
            jax.checkpoint(it_body), init, (it_keys, jnp.arange(it_n)))
        if progressive:
            return final_colors / it_n
        return jnp.sum(solve_alpha(a_mat, b_vec), axis=1)

    def band_body(_, xs):
        if res_bands is not None:
            ctx_b, oy_c, ox_c, b, res_b = xs
        else:
            ctx_b, oy_c, ox_c, b = xs
            res_b = None
        return 0.0, band_color(ctx_b, oy_c, ox_c, b, res_b)

    xs = (ctx_bands, oy_bands, ox_bands, jnp.arange(n_bands))
    if res_bands is not None:
        xs = xs + (res_bands,)
    _, colors = jax.lax.scan(jax.checkpoint(band_body), 0.0, xs)
    color = jnp.moveaxis(colors, 0, 1).reshape(3, height, width)
    if features.enable_tone_mapping:
        color = exposure_tone_mapping(color, features)
    return jnp.moveaxis(color, 0, -1)


def mis_banded_l2_loss(
    params, target, key, cam, geometry, lights,
    num_lights: int, height: int, width: int, features: Features,
    n_bands: int,
):
    """Mean-squared error of a band-sequential R-MIS/R-OMIS render against a
    target — the 1080p-capable gradient entry point (same contract as
    diff.grad.mis_l2_image_loss, which it replaces when the whole-frame
    backward exceeds HBM)."""
    from .grad import apply_params

    geometry, lights = apply_params(geometry, lights, params)
    img = render_mis_banded(key, cam, geometry, lights, num_lights, height,
                            width, features, n_bands)
    return jnp.mean((img - target) ** 2)
