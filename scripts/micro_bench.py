"""Microbenchmarks for the RIS inner-loop building blocks on a GPU.

Times each suspect of the candidate-generation cost separately, with the
repetition inside one jitted fori_loop (one dispatch per measurement).
Run: python scripts/micro_bench.py [HxW reps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def timed(name, make_fn):
    fn = jax.jit(make_fn)
    t0 = time.perf_counter()
    s = float(fn(jax.random.PRNGKey(0)))
    t1 = time.perf_counter()
    s = float(fn(jax.random.PRNGKey(1)))
    t2 = time.perf_counter()
    print(f"{name}: compile {t1 - t0 - (t2 - t1):.1f}s run {t2 - t1:.3f}s",
          flush=True)


def main():
    hw = sys.argv[1] if len(sys.argv) > 1 else "1080x1920"
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 48
    h, w = (int(x) for x in hw.split("x"))
    k = 2
    n_lights = 512
    table = jnp.arange(n_lights * 3, dtype=jnp.float32).reshape(n_lights, 3)

    def rep(body):
        def run(key):
            def f(i, acc):
                return acc + body(jax.random.fold_in(key, i))
            return jnp.sum(jax.lax.fori_loop(0, reps, f,
                                             jnp.zeros((k, h, w))))
        return run

    # 1. threefry draws (the RIS loop draws ~3 of these per slot)
    timed("threefry uniform [K,H,W]",
          rep(lambda kk: jax.random.uniform(kk, (k, h, w))))
    timed("threefry randint [K,H,W]",
          rep(lambda kk: jax.random.randint(kk, (k, h, w), 0, n_lights)
              .astype(jnp.float32)))

    # 2. random gather from a small table (7 per slot in sample_lights)
    def gather_body(kk):
        idx = jax.random.randint(kk, (k, h, w), 0, n_lights)
        out = jnp.zeros((k, h, w))
        for c in range(3):
            out = out + table[:, c][idx]
        return out
    timed("3x table gather [K,H,W]", rep(gather_body))

    # 3. pure VPU arithmetic of comparable flop count to one phong eval
    x0 = jnp.ones((k, h, w))

    def vpu_body(kk):
        x = x0 * 1.0001
        for _ in range(20):
            x = x * 1.0001 + 0.1
        return x
    timed("60-flop VPU chain [K,H,W]", rep(vpu_body))

    # 4. one full phong/target_pdf eval
    from romis.core.types import ShadeCtx
    from romis.core.features import Features
    from romis.ops.shading import target_pdf

    ctx = ShadeCtx(
        valid=jnp.ones((h, w), bool), position=jnp.zeros((3, h, w)),
        normal=jnp.ones((3, h, w)) * 0.577,
        view_origin=jnp.ones((3, h, w)),
        kd=jnp.ones((3, h, w)) * 0.5, ks=jnp.ones((3, h, w)) * 0.2,
        shininess=jnp.full((h, w), 10.0),
        geom_id=jnp.zeros((h, w), jnp.int32), depth_t=jnp.ones((h, w)))
    feats = Features()

    def phong_body(kk):
        pos = jax.random.uniform(kk, (k, 3, h, w))
        return target_pdf(ctx, pos, pos, feats)
    timed("uniform + target_pdf [K,H,W]", rep(phong_body))


def gather_variants():
    """Compare gather strategies for the light-table fetch."""
    h, w, k, L = 1080, 1920, 2, 512
    reps = 16
    table24 = jnp.arange(L * 24, dtype=jnp.float32).reshape(L, 24)

    def rep24(body):
        def run(key):
            def f(i, acc):
                return acc + body(jax.random.fold_in(key, i))
            return jnp.sum(jax.lax.fori_loop(0, reps, f,
                                             jnp.zeros((k, h, w))))
        return run

    # A) 21 scalar-component gathers (current sample_lights cost model)
    def comp_gather(kk):
        idx = jax.random.randint(kk, (k, h, w), 0, L)
        out = jnp.zeros((k, h, w))
        for c in range(21):
            out = out + table24[:, c][idx]
        return out
    timed("A: 21 scalar gathers", rep24(comp_gather))

    # B) one row-gather of 24 floats per index
    def row_gather(kk):
        idx = jax.random.randint(kk, (k, h, w), 0, L)
        rows = table24[idx]  # [k, h, w, 24]
        return rows.sum(-1)
    timed("B: 1 row(24) gather", rep24(row_gather))

    # C) block-coherent indices: one light per 8x8 pixel block
    def block_gather(kk):
        idx = jax.random.randint(kk, (k, h // 8, w // 8), 0, L)
        out = jnp.zeros((k, h // 8, w // 8))
        for c in range(21):
            out = out + table24[:, c][idx]
        out = jnp.repeat(jnp.repeat(out, 8, axis=-2), 8, axis=-1)
        return out
    timed("C: 21 gathers @ 8x8 blocks", rep24(block_gather))

    # D) one-hot matmul over pixel chunks
    def onehot(kk):
        idx = jax.random.randint(kk, (k, h, w), 0, L)
        flat = idx.reshape(-1, w)  # [k*h, w] -> treat rows as batch
        oh = jax.nn.one_hot(flat, L, dtype=jnp.bfloat16)  # [k*h, w, L]
        rows = jnp.einsum("bwl,lc->bwc", oh,
                          table24.astype(jnp.bfloat16))
        return rows.sum(-1).reshape(k, h, w).astype(jnp.float32)
    timed("D: one-hot matmul", rep24(onehot))


if __name__ == "__main__":
    if "--gathers" in sys.argv:
        gather_variants()
    else:
        main()
