"""Batched block allocation and visible-block compaction.

JAX rebuild of SURVEY.md components #12-#13 (reference: per-pixel
allocation kernels with atomic inserts + stream compaction in ``volume.cu``
[M] [P:1410.0925]).  The CUDA atomics become a deterministic batched
pipeline, which is the idiomatic XLA answer (SURVEY.md §3 parallelism table):

  1. per-pixel ray samples in the truncation band -> candidate block coords
     (vectorized, subsampled pixel grid);
  2. pack coords to int32 codes, sort, neighbor-compare -> unique codes;
  3. second sort compacts the unique codes into a fixed-capacity batch;
  4. contention-free parallel hash insertion (``hashing.insert_unique``).

Everything is static-shape; dropped candidates increment overflow counters
instead of disappearing silently (SURVEY.md §6 observability).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.se3 import SE3
from . import blocks as B
from . import hashing


def candidate_block_codes(
    depth: jax.Array,
    camera: PinholeCamera,
    pose: SE3,
    config: Config,
) -> jax.Array:
    """Packed block codes touched by the truncation band of each depth ray.

    Returns (N,) int32 codes with INVALID_CODE holes, where
    N = ceil(H/ss) * ceil(W/ss) * alloc_samples.
    """
    ss = config.alloc_subsample
    d = depth[::ss, ::ss]
    h, w = d.shape
    uv = camera.pixel_grid(depth.shape[0], depth.shape[1])[::ss, ::ss]
    rays_cam = camera.unproject(uv, jnp.ones_like(d))        # z = 1
    rays_world = pose.rotate(rays_cam)
    origin = pose.translation

    mu = config.trunc_dist
    k = config.alloc_samples
    # z-depths of the samples: d - mu .. d + mu inclusive.
    offs = jnp.linspace(-mu, mu, k, dtype=d.dtype)           # (k,)
    t = d[..., None] + offs                                   # (h, w, k)
    pts = origin + t[..., None] * rays_world[:, :, None, :]   # (h, w, k, 3)
    coords = jnp.floor(pts / config.block_extent).astype(jnp.int32)
    valid = (
        (d > config.depth_min)
        & (d < config.depth_max)
    )[..., None] & (t > 0.0) & B.coords_in_bounds(coords)
    codes = jnp.where(valid, B.pack_block_coords(coords), B.INVALID_CODE)
    return codes.reshape(-1)


def compact_mask(keep: jax.Array, values: jax.Array, capacity: int, fill):
    """Stream compaction: pack ``values[keep]`` to the front of a
    fixed-size buffer via cumsum + scatter (no second sort -- one dense
    prefix sum and one scatter; deterministic, order-preserving)."""
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep & (pos < capacity), pos, capacity)
    out = jnp.full((capacity,), fill, values.dtype)
    return out.at[tgt].set(values, mode="drop")


def dedup_codes(codes: jax.Array, capacity: int):
    """Sort-based dedup + cumsum compaction to a fixed-size batch.

    Returns (unique_codes (capacity,), n_unique, n_dropped).  This
    replaces the reference's atomic marking of hash entries with one
    device sort + a prefix-sum compaction -- deterministic regardless of
    pixel order.
    """
    s = jnp.sort(codes)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), s[1:] != s[:-1]]
    ) & (s != B.INVALID_CODE)
    compact = compact_mask(first, s, capacity, B.INVALID_CODE)
    n_unique = jnp.sum(first).astype(jnp.int32)
    n_dropped = jnp.maximum(n_unique - capacity, 0)
    return compact, n_unique, n_dropped


def allocate_for_frame(
    volume: B.VolumeState,
    depth: jax.Array,
    camera: PinholeCamera,
    pose: SE3,
    config: Config,
):
    """Allocate every block touched by this frame's truncation band.

    Returns ``(volume, band_ids, n_band)``: the band list is the compacted
    block indices of THIS frame's truncation band -- exactly the blocks
    whose voxels the frame's depth can change, and therefore the integration
    work list (a fraction of the frustum-visible set, which accumulates the
    whole scene history in view; see integrate_sparse).
    """
    codes = candidate_block_codes(depth, camera, pose, config)
    uniq, _, n_dropped = dedup_codes(codes, config.alloc_capacity)
    want = uniq != B.INVALID_CODE
    coords = B.unpack_block_coords(uniq)

    codes_t, values, free_count, assigned, ok = hashing.insert_unique(
        volume.hash_codes,
        volume.hash_values,
        volume.free_count,
        coords,
        want,
        config,
    )
    # Record coords for every assigned block (new or existing: idempotent).
    nb = volume.block_coords.shape[0]
    tgt = jnp.where(assigned > 0, assigned, nb)
    block_coords = volume.block_coords.at[tgt].set(coords, mode="drop")

    overflow = volume.alloc_overflow + n_dropped + jnp.sum(~ok)
    volume = dataclasses.replace(
        volume,
        hash_codes=codes_t,
        hash_values=values,
        free_count=free_count,
        block_coords=block_coords,
        alloc_overflow=overflow.astype(jnp.int32),
    )
    # dedup_codes compacts unique codes to a sorted prefix, so `want` is a
    # prefix mask and the band list is already dense.
    band_ids = jnp.where(want & ok, assigned, 0)
    n_band = jnp.sum(want).astype(jnp.int32)
    return volume, band_ids, n_band


def update_visibility(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
) -> B.VolumeState:
    """Compact the dense list of blocks visible in the current frustum.

    Reference component #13 (visibility kernel + stream compaction).  Here:
    a vectorized frustum test over every *allocated* block slot, then one
    sort compacts surviving block indices to the front of the fixed
    ``visible_ids`` buffer.

    Visibility test: block center projects within the image inflated by the
    block's projected radius, with camera-space z in [near, far] inflated by
    the block diagonal -- conservative, no false negatives.
    """
    be = config.block_extent
    centers = (volume.block_coords.astype(jnp.float32) + 0.5) * be
    cam_pts = pose.inverse().apply(centers)                   # (nb, 3)
    z = cam_pts[..., 2]
    # Conservative projected block radius in pixels.
    radius_w = 0.87 * be  # ~ half diagonal = sqrt(3)/2 * be
    zc = jnp.maximum(z, 1e-3)
    r_px = jnp.maximum(camera.fx, camera.fy) * radius_w / zc
    uv = camera.project(cam_pts)
    allocated = B.allocated_mask(volume, config)
    visible = (
        allocated
        & (z > config.ray_near - radius_w)
        & (z < config.ray_far + radius_w)
        & (uv[..., 0] > -r_px)
        & (uv[..., 0] < width - 1 + r_px)
        & (uv[..., 1] > -r_px)
        & (uv[..., 1] < height - 1 + r_px)
    )
    nb = visible.shape[0]
    ids = jnp.arange(nb, dtype=jnp.int32)
    n_vis = jnp.sum(visible).astype(jnp.int32)
    cap = config.max_visible
    visible_ids = compact_mask(visible, ids, cap, jnp.int32(0))
    overflow = jnp.maximum(n_vis - cap, 0)
    return dataclasses.replace(
        volume,
        visible_ids=visible_ids,
        num_visible=jnp.minimum(n_vis, cap),
        visible_overflow=(volume.visible_overflow + overflow).astype(jnp.int32),
    )
