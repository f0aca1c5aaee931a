"""Per-frame raycast acceleration structure.

The CUDA reference's raycast does a hash lookup (bucket walk) per march
step and per trilinear corner [P:1410.0925].  Here every random access is
an XLA gather, so the renderer is designed around a strict random-access
budget:

  * **halo arrays** (max_visible+1, 9, 9, 9): every visible block plus one
    voxel of +x/+y/+z neighbor data, so trilinear interpolation never
    resolves blocks per corner; row 0 is the null block.  Only TWO halos
    are built: ``march`` (int8 quantized tsdf, -128 = unobserved -- doubles
    as the observed mask) and ``tsdf`` (f32, for sub-voxel refinement).
    Weight/color halos were measured to dominate cache-build DMA time and
    carry no information the march sentinel doesn't.
  * **block grid** (G, G, G) int32: dense map from block coord (relative
    to the visible AABB corner) to halo row; ``row_block`` maps halo row
    back to the volume block index so color can be read from the volume
    directly (nearest, no halo).

Visible blocks outside the G^3 window (G * block_extent meters, default
128 * 6.4 cm = 8.2 m) are counted in ``overflow`` and not rendered this
frame -- never silent.

All sampling entry points take per-axis coordinate arrays: (...,3) vectors
in hot loops force minor-dim-3 relayout copies.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Config
from ..utils.pytree import pytree_dataclass
from . import blocks as B

MARCH_UNSEEN = -128  # int8 sentinel in ``march`` for unobserved voxels


@pytree_dataclass
class RenderCache:
    """All gather targets are FLAT 1D arrays: multi-dim tables get exotic
    XLA layouts whose gathers run at half rate (measured)."""

    grid: jax.Array         # ((G*G*G),) int32 halo row; 0 = empty
    grid_min: jax.Array     # (3,) int32 block coord of grid[0,0,0]
    tsdf: jax.Array         # ((V+1)*729,) f32 halo voxels, row-major 9x9x9
    march: jax.Array        # ((V+1)*729,) int32 (int8 range + UNSEEN)
    row_block: jax.Array    # (V+1,) int32 volume block index (0 = null)
    overflow: jax.Array     # () int32 visible blocks outside the grid


def build(volume: B.VolumeState, config: Config) -> RenderCache:
    """Build the cache for the current visible set (one pass per frame)."""
    ids = volume.visible_ids                         # (V,)
    V = ids.shape[0]
    row_valid = (jnp.arange(V, dtype=jnp.int32) < volume.num_visible) & (
        ids > 0
    )
    coords = volume.block_coords[ids]                # (V, 3)

    def neighbor_idx(offset):
        idx = B.lookup_blocks(
            volume, coords + jnp.asarray(offset, jnp.int32), config
        )
        return jnp.where(row_valid, idx, 0)

    # Neighbor resolution for ALL capacity rows (cheap: V hash lookups);
    # the heavy voxel copies below are chunked by actual num_visible.
    nx = neighbor_idx((1, 0, 0))
    ny = neighbor_idx((0, 1, 0))
    nz = neighbor_idx((0, 0, 1))
    nxy = neighbor_idx((1, 1, 0))
    nxz = neighbor_idx((1, 0, 1))
    nyz = neighbor_idx((0, 1, 1))
    nxyz = neighbor_idx((1, 1, 1))
    own = jnp.where(row_valid, ids, 0)

    # Chunked halo construction: only ~num_visible rows carry data, so the
    # build loop's trip count follows the actual count instead of paying
    # full max_visible bandwidth every frame.
    C = min(2048, V)
    n_chunks = (volume.num_visible + C - 1) // C

    def chunk_ext(arr, null_value, start):
        def rows(idx_all):
            idx = jax.lax.dynamic_slice_in_dim(idx_all, start, C)
            return arr[idx].reshape(-1, 8, 8, 8)

        ext = jnp.full((C, 9, 9, 9), null_value, arr.dtype)
        ext = ext.at[:, :8, :8, :8].set(rows(own))
        ext = ext.at[:, 8, :8, :8].set(rows(nx)[:, 0, :, :])
        ext = ext.at[:, :8, 8, :8].set(rows(ny)[:, :, 0, :])
        ext = ext.at[:, :8, :8, 8].set(rows(nz)[:, :, :, 0])
        ext = ext.at[:, 8, 8, :8].set(rows(nxy)[:, 0, 0, :])
        ext = ext.at[:, 8, :8, 8].set(rows(nxz)[:, 0, :, 0])
        ext = ext.at[:, :8, 8, 8].set(rows(nyz)[:, :, 0, 0])
        ext = ext.at[:, 8, 8, 8].set(rows(nxyz)[:, 0, 0, 0])
        return ext

    def build_halos():
        halo_tsdf = jnp.ones(((V + 1) * 729,), jnp.float32)
        march = jnp.full(((V + 1) * 729,), MARCH_UNSEEN, jnp.int32)

        def cond(carry):
            i, _, _ = carry
            return i < n_chunks

        def body(carry):
            i, ht, hm = carry
            start = i * C
            et = chunk_ext(volume.tsdf, 1.0, start)
            ew = chunk_ext(volume.weight, 0.0, start)
            em = jnp.where(
                ew > 0.0,
                jnp.round(jnp.clip(et, -1.0, 1.0) * 127.0),
                float(MARCH_UNSEEN),
            ).astype(jnp.int32)
            off = (start + 1) * 729
            ht = jax.lax.dynamic_update_slice_in_dim(
                ht, et.reshape(-1), off, 0
            )
            hm = jax.lax.dynamic_update_slice_in_dim(
                hm, em.reshape(-1), off, 0
            )
            return i + 1, ht, hm

        _, halo_tsdf, march = jax.lax.while_loop(
            cond, body, (jnp.asarray(0, jnp.int32), halo_tsdf, march)
        )
        return halo_tsdf, march

    halo_tsdf, march = build_halos()

    G = config.render_grid_size
    big = jnp.int32(1 << 20)
    masked = jnp.where(row_valid[:, None], coords, big)
    grid_min = jnp.min(masked, axis=0)
    grid_min = jnp.where(grid_min == big, 0, grid_min)

    rel = coords - grid_min
    inside = row_valid & jnp.all((rel >= 0) & (rel < G), axis=-1)
    flat = (rel[:, 0] * G + rel[:, 1]) * G + rel[:, 2]
    rows = jnp.arange(1, V + 1, dtype=jnp.int32)
    grid = jnp.zeros((G * G * G,), jnp.int32)
    grid = grid.at[jnp.where(inside, flat, G * G * G)].set(
        rows, mode="drop"
    )
    overflow = jnp.sum(row_valid & ~inside)

    row_block = jnp.concatenate([jnp.zeros((1,), jnp.int32), own])

    return RenderCache(
        grid=grid,
        grid_min=grid_min,
        tsdf=halo_tsdf,
        march=march,
        row_block=row_block,
        overflow=overflow.astype(jnp.int32),
    )


def _row_and_local(cache: RenderCache, gx, gy, gz, config: Config):
    """Integer voxel coords (per axis) -> (halo_row, lx, ly, lz)."""
    bs = config.block_size
    G = config.render_grid_size
    bx = gx >> 3
    by = gy >> 3
    bz = gz >> 3
    rx = bx - cache.grid_min[0]
    ry = by - cache.grid_min[1]
    rz = bz - cache.grid_min[2]
    inside = (
        (rx >= 0) & (rx < G) & (ry >= 0) & (ry < G) & (rz >= 0) & (rz < G)
    )
    flat = (jnp.clip(rx, 0, G - 1) * G + jnp.clip(ry, 0, G - 1)) * G + jnp.clip(
        rz, 0, G - 1
    )
    row = jnp.where(inside, cache.grid[flat], 0)
    return row, gx - (bx << 3), gy - (by << 3), gz - (bz << 3)


def sample_march_texture(
    cache: RenderCache, gx: jax.Array, gy: jax.Array, gz: jax.Array,
    config: Config,
):
    """Batched march sample at integer voxel coords: int8 quantized tsdf
    with MARCH_UNSEEN for unobserved/outside.  Two gathers; positions are
    data-independent, so calls pipeline fully."""
    row, lx, ly, lz = _row_and_local(cache, gx, gy, gz, config)
    return cache.march[((row * 9 + lx) * 9 + ly) * 9 + lz]


def _floor_axes(px, py, pz, config: Config):
    inv_vs = 1.0 / config.voxel_size
    qx = px * inv_vs
    qy = py * inv_vs
    qz = pz * inv_vs
    x0 = jnp.floor(qx)
    y0 = jnp.floor(qy)
    z0 = jnp.floor(qz)
    fx = qx - x0
    fy = qy - y0
    fz = qz - z0
    return (
        x0.astype(jnp.int32), y0.astype(jnp.int32), z0.astype(jnp.int32),
        fx, fy, fz,
    )


def sample_trilinear_axes(cache: RenderCache, px, py, pz, config: Config):
    """Trilinear f32 TSDF at world points given per-axis: (value, ok).

    1 grid gather + 8 halo gathers; ``ok`` = all corners observed, read
    from the march sentinel (no weight halo needed).
    """
    x0, y0, z0, fx, fy, fz = _floor_axes(px, py, pz, config)
    row, lx, ly, lz = _row_and_local(cache, x0, y0, z0, config)
    val = jnp.zeros(row.shape, cache.tsdf.dtype)
    ok = row > 0
    for dx in (0, 1):
        wx = fx if dx else 1.0 - fx
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            for dz in (0, 1):
                wz = fz if dz else 1.0 - fz
                hidx = ((row * 9 + lx + dx) * 9 + ly + dy) * 9 + lz + dz
                f = cache.tsdf[hidx]
                m = cache.march[hidx]
                val = val + (wx * wy * wz) * f
                ok = ok & (m != MARCH_UNSEEN)
    return val, ok


def sample_march_trilinear_axes(cache: RenderCache, px, py, pz, config: Config):
    """Trilinear on the QUANTIZED march texture: one gather per corner
    (value and observed-mask in the same read; 1/127 mu resolution).  Used
    where the f32 halo's extra precision isn't worth doubling the gathers
    (splat polish)."""
    x0, y0, z0, fx, fy, fz = _floor_axes(px, py, pz, config)
    row, lx, ly, lz = _row_and_local(cache, x0, y0, z0, config)
    val = jnp.zeros(row.shape, jnp.float32)
    ok = row > 0
    for dx in (0, 1):
        wx = fx if dx else 1.0 - fx
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            for dz in (0, 1):
                wz = fz if dz else 1.0 - fz
                hidx = ((row * 9 + lx + dx) * 9 + ly + dy) * 9 + lz + dz
                m = cache.march[hidx]
                val = val + (wx * wy * wz) * m.astype(jnp.float32)
                ok = ok & (m != MARCH_UNSEEN)
    return val * (1.0 / 127.0), ok


def sample_color_nearest_axes(
    cache: RenderCache, volume: B.VolumeState, px, py, pz, config: Config
):
    """Nearest-voxel color from the volume via the row->block map: 1 grid
    gather + 1 row_block gather + 1 packed-color gather."""
    inv_vs = 1.0 / config.voxel_size
    gx = jnp.round(px * inv_vs).astype(jnp.int32)
    gy = jnp.round(py * inv_vs).astype(jnp.int32)
    gz = jnp.round(pz * inv_vs).astype(jnp.int32)
    row, lx, ly, lz = _row_and_local(cache, gx, gy, gz, config)
    b = cache.row_block[row]
    li = (lx * 8 + ly) * 8 + lz
    rgb, cw = B.unpack_voxel_color(volume.colorpack[b, li])
    ok = (row > 0) & (cw > 0.0)
    return jnp.where(ok[..., None], rgb, 0.0), ok


def sample_gradient_axes(cache: RenderCache, px, py, pz, config: Config):
    """TSDF-gradient normals via 6 trilinear samples (per-axis offsets)."""
    h = 0.5 * config.voxel_size
    gpx, okx1 = sample_trilinear_axes(cache, px + h, py, pz, config)
    gmx, okx2 = sample_trilinear_axes(cache, px - h, py, pz, config)
    gpy, oky1 = sample_trilinear_axes(cache, px, py + h, pz, config)
    gmy, oky2 = sample_trilinear_axes(cache, px, py - h, pz, config)
    gpz, okz1 = sample_trilinear_axes(cache, px, py, pz + h, config)
    gmz, okz2 = sample_trilinear_axes(cache, px, py, pz - h, config)
    nx = gpx - gmx
    ny = gpy - gmy
    nz = gpz - gmz
    norm = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    ok = okx1 & okx2 & oky1 & oky2 & okz1 & okz2 & (norm > 1e-12)
    inv = 1.0 / jnp.maximum(norm, 1e-12)
    return nx * inv, ny * inv, nz * inv, ok
