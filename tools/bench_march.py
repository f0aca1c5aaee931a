"""Bisect the raycast march cost: which part of the loop body is slow."""
import sys
import time

sys.path.insert(0, ".")
from vulcan_tpu.utils.runtime import setup_cache

setup_cache()

import jax
import jax.numpy as jnp
import numpy as np

from vulcan_tpu.config import TINY
from vulcan_tpu.ops import render_cache as RC
from vulcan_tpu.ops import blocks as B

config = TINY
H, W = 120, 160
STEPS = 96


def timeit(name, fn, *args, n=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    print(f"{name:46s} {(time.perf_counter()-t0)/n*1e3:8.2f} ms")


def main():
    print("devices:", jax.devices())
    rng = np.random.default_rng(0)
    G = config.render_grid_size
    V = config.max_visible

    grid = jnp.asarray(rng.integers(0, V, (G, G, G)), jnp.int32)
    halo_t = jnp.asarray(rng.standard_normal((V + 1, 9, 9, 9)), jnp.float32)
    halo_w = jnp.asarray(
        rng.uniform(0, 2, (V + 1, 9, 9, 9)), jnp.float32
    )
    origin = jnp.asarray([0.1, 0.2, 0.3])
    rays = jnp.asarray(rng.standard_normal((H, W, 3)), jnp.float32)
    t0v = jnp.full((H, W), 0.5)

    def sample(t):
        p = origin + t[..., None] * rays
        g = jnp.round(p / config.voxel_size).astype(jnp.int32)
        block, local = B.voxel_block_local(g, config)
        rel = block  # pretend grid_min = 0
        inside = jnp.all((rel >= 0) & (rel < G), axis=-1)
        relc = jnp.clip(rel, 0, G - 1)
        row = grid[relc[..., 0], relc[..., 1], relc[..., 2]]
        row = jnp.where(inside, row, 0)
        lx, ly, lz = local[..., 0], local[..., 1], local[..., 2]
        return halo_t[row, lx, ly, lz], halo_w[row, lx, ly, lz]

    # V0: full-ish body, 7-array carry
    def v0(t0v):
        def body(i, carry):
            t, prev_t, prev_f, prev_obs, t_hit, t_before, done = carry
            f, w = sample(t)
            observed = w > 0.5
            crossing = observed & prev_obs & (prev_f > 0.0) & (f <= 0.0) & ~done
            t_hit = jnp.where(crossing, t, t_hit)
            t_before = jnp.where(crossing, prev_t, t_before)
            done = done | crossing
            dt = jnp.where(observed, jnp.maximum(f * 0.01, 0.002), 0.05)
            new_t = jnp.where(done, t, t + dt)
            prev_f = jnp.where(observed, f, prev_f)
            prev_obs = observed | prev_obs
            return new_t, t, prev_f, prev_obs, t_hit, t_before, done

        z = jnp.zeros((H, W))
        init = (t0v, t0v, jnp.ones((H, W)), jnp.zeros((H, W), bool), z, z,
                jnp.zeros((H, W), bool))
        return jax.lax.fori_loop(0, STEPS, body, init)[4]

    timeit("V0 full body fori x96 (2D)", jax.jit(v0), t0v)

    # V1: same but flat shapes
    rays_f = rays.reshape(-1, 3)
    t0f = t0v.reshape(-1)

    def sample_flat(t):
        p = origin + t[:, None] * rays_f
        g = jnp.round(p / config.voxel_size).astype(jnp.int32)
        block, local = B.voxel_block_local(g, config)
        inside = jnp.all((block >= 0) & (block < G), axis=-1)
        relc = jnp.clip(block, 0, G - 1)
        flat_idx = (relc[:, 0] * G + relc[:, 1]) * G + relc[:, 2]
        row = jnp.where(inside, grid.reshape(-1)[flat_idx], 0)
        hidx = ((row * 9 + local[:, 0]) * 9 + local[:, 1]) * 9 + local[:, 2]
        return halo_t.reshape(-1)[hidx], halo_w.reshape(-1)[hidx]

    def v1(t0f):
        def body(i, carry):
            t, prev_t, prev_f, prev_obs, t_hit, t_before, done = carry
            f, w = sample_flat(t)
            observed = w > 0.5
            crossing = observed & prev_obs & (prev_f > 0.0) & (f <= 0.0) & ~done
            t_hit = jnp.where(crossing, t, t_hit)
            t_before = jnp.where(crossing, prev_t, t_before)
            done = done | crossing
            dt = jnp.where(observed, jnp.maximum(f * 0.01, 0.002), 0.05)
            new_t = jnp.where(done, t, t + dt)
            prev_f = jnp.where(observed, f, prev_f)
            prev_obs = observed | prev_obs
            return new_t, t, prev_f, prev_obs, t_hit, t_before, done

        n = t0f.shape[0]
        z = jnp.zeros((n,))
        init = (t0f, t0f, jnp.ones((n,)), jnp.zeros((n,), bool), z, z,
                jnp.zeros((n,), bool))
        return jax.lax.fori_loop(0, STEPS, body, init)[4]

    timeit("V1 full body fori x96 (flat, fused idx)", jax.jit(v1), t0f)

    # V2: no gathers (compute-only body)
    def v2(t0v):
        def body(i, carry):
            t, acc = carry
            p = origin + t[..., None] * rays
            f = jnp.sum(p * p, -1) * 0.01 - 0.5
            t = t + jnp.maximum(f * 0.01, 0.002)
            return t, acc + f

        return jax.lax.fori_loop(0, STEPS, body, (t0v, jnp.zeros((H, W))))[1]

    timeit("V2 no-gather body fori x96", jax.jit(v2), t0v)

    # V3: gathers only, tiny carry
    def v3(t0v):
        def body(i, carry):
            t, acc = carry
            f, w = sample(t)
            t = t + jnp.maximum(f * 0.01, 0.002)
            return t, acc + w

        return jax.lax.fori_loop(0, STEPS, body, (t0v, jnp.zeros((H, W))))[1]

    timeit("V3 gathers, small carry fori x96 (2D)", jax.jit(v3), t0v)

    # V4: single iteration body cost x96 measured unrolled (python loop)
    def v4(t0v):
        t = t0v
        acc = jnp.zeros((H, W))
        for i in range(STEPS):
            f, w = sample(t)
            t = t + jnp.maximum(f * 0.01, 0.002)
            acc = acc + w
        return acc

    timeit("V4 unrolled x96 (2D)", jax.jit(v4), t0v)


if __name__ == "__main__":
    main()
