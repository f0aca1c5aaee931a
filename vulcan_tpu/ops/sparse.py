"""Visible-block sparse TSDF integration.

JAX rebuild of the reference's ``Integrator`` on the hashed volume
(SURVEY.md component #15, ``integrator.cu`` [M]; one CUDA thread per voxel of
each visible block [P:1410.0925] [B]).  Here: one vectorized XLA pass over
the fixed-capacity visible-block batch, shaped (chunk, 512) --
gather block rows, update, scatter back (rows are contiguous 2 KB
copies, not per-element scatters).

The pass is chunked (``integrate_chunk`` blocks per while_loop round) and
the loop trip count follows the ACTUAL ``num_visible``: with a static
(max_visible, 512) batch, scenes using a fraction of the capacity would
pay full-capacity depth-image sampling every frame.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import Config
from ..core.frame import Frame
from . import blocks as B
from .dense import _sample_nearest, voxel_update


def _pack_depth_color(depth, color, config: Config) -> jax.Array:
    """(H, W) f32 depth + (H, W, 3) f32 rgb -> (H, W) int32
    ``depth16 << 16 | rgb565``.

    Integration then needs ONE random image gather per voxel instead
    of two (random gathers are the dominant integrate cost).  Depth is
    quantized to the sensor's own
    raw grid (1/depth_raw_scale = 0.2 mm at TUM scale, exactly what a
    uint16 camera feed provides); color to RGB565 (<=1.6% per channel,
    averaged further by the running color weight)."""
    d16 = jnp.clip(
        jnp.round(depth * config.depth_raw_scale), 0, 65535
    ).astype(jnp.int32)
    c = jnp.clip(jnp.round(color * 255.0), 0, 255).astype(jnp.int32)
    rgb565 = ((c[..., 0] >> 3) << 11) | ((c[..., 1] >> 2) << 5) | (
        c[..., 2] >> 3
    )
    return (d16 << 16) | rgb565


def _unpack_depth_color(packed: jax.Array, config: Config):
    d = ((packed >> 16) & 0xFFFF).astype(jnp.float32) * (
        1.0 / config.depth_raw_scale
    )
    r = ((packed >> 11) & 0x1F).astype(jnp.float32) * (1.0 / 31.0)
    g = ((packed >> 5) & 0x3F).astype(jnp.float32) * (1.0 / 63.0)
    b = (packed & 0x1F).astype(jnp.float32) * (1.0 / 31.0)
    return d, jnp.stack([r, g, b], axis=-1)


# ---------------------------------------------------------------------------
# One-hot matmul patch gather (Config.integrate_gather="onehot")
# ---------------------------------------------------------------------------
#
# One block's 512 voxels project into a COMPACT image patch, so a gather
# from a small per-block table can run as a matmul instead of per-element
# gathers: build a (512, P) one-hot of patch-local pixel indices and
# matmul it with the patch values.  Multiple value channels ride the SAME
# one-hot as extra rhs columns.  (The flat per-element gather is the
# default: see resolve_integrate_gather.)
#
# The patch for a block is selected from a per-block MIP level so its
# projection always fits 32 x 64 patch pixels: stride 2^L keeps the
# sampling step at most ~1/4 of a voxel's projected footprint, so mip
# sampling stays sub-voxel accurate at every depth.  Patches are
# extracted as plain row gathers from statically tiled (rows, 32) mip
# images (contiguous 128-byte rows).

_MIP_LEVELS = 5           # strides 1, 2, 4, 8, 16
_TILE_W = 32              # lane-width tiles of every mip row
_PATCH_ROWS = 32
_PATCH_TILES = 2          # patch = 32 rows x 2 column tiles = 32 x 64 px
_PATCH_P = _PATCH_ROWS * _PATCH_TILES * _TILE_W  # 2048


def _mip_meta(height: int, width: int):
    """Static (offset, width_tiles, padded_h) per mip level."""
    meta = []
    off = 0
    for level in range(_MIP_LEVELS):
        h = -(-height // (1 << level))
        w = -(-width // (1 << level))
        wt = max(-(-w // _TILE_W), _PATCH_TILES)
        hp = max(h, _PATCH_ROWS)
        meta.append((off, wt, hp, h, w))
        off += hp * wt
    return meta, off


def _build_mip_tiles(packed: jax.Array):
    """(H, W) int32 -> ((total_rows, 32) int32 tile stack, static meta).

    Level L is the [::2^L, ::2^L] nearest subsample (a real sensor
    sample, no averaging of packed values), zero-padded to the tile
    grid; packed 0 decodes to depth 0 = invalid, so padding is inert.
    """
    h, w = packed.shape
    meta, total = _mip_meta(h, w)
    parts = []
    m_prev = packed
    for level, (off, wt, hp, hl, wl) in enumerate(meta):
        # Iterative halving: [::2] of level L-1 == [::2^L] of level 0
        # exactly (nearest subsample composes), and the shrinking
        # inputs cost ~1.33x one full-size pass instead of L of them.
        if level:
            m_prev = m_prev[::2, ::2]
        m = jnp.pad(m_prev, ((0, hp - hl), (0, wt * _TILE_W - wl)))
        parts.append(m.reshape(hp * wt, _TILE_W))
    return jnp.concatenate(parts, axis=0), meta


def _patch_gather_depth_color(uv, z_cam, mip_tiles, mip_meta, config):
    """Per-block patched image sampling via one-hot matmuls.

    uv: (C, 512, 2) full-res pixel coords of every voxel; returns
    (depth (C,512), color (C,512,3), sampled_ok (C,512)).
    """
    C = uv.shape[0]
    # Clip before any int32 conversion: voxels at z ~ 0 project to huge
    # coordinates (they are masked later, but the intermediate int cast
    # must not overflow).
    u = jnp.clip(uv[..., 0], -1e7, 1e7)
    v = jnp.clip(uv[..., 1], -1e7, 1e7)
    front = z_cam > 1e-6
    big = jnp.float32(1e9)
    u_min = jnp.min(jnp.where(front, u, big), axis=1)      # (C,)
    u_max = jnp.max(jnp.where(front, u, -big), axis=1)
    v_min = jnp.min(jnp.where(front, v, big), axis=1)
    v_max = jnp.max(jnp.where(front, v, -big), axis=1)
    extent = jnp.maximum(u_max - u_min, v_max - v_min)
    extent = jnp.where(jnp.isfinite(extent), extent, big)

    # Smallest mip whose 31-px budget covers the extent.
    lvl = jnp.zeros((C,), jnp.int32)
    for level in range(1, _MIP_LEVELS):
        lvl = jnp.where(extent > 31.0 * (1 << (level - 1)), level, lvl)
    inv = jnp.exp2(-lvl.astype(jnp.float32))               # (C,)

    # Per-level static tables, gathered by lvl (tiny C-sized gathers).
    offs = jnp.asarray([m[0] for m in mip_meta], jnp.int32)[lvl]
    wts = jnp.asarray([m[1] for m in mip_meta], jnp.int32)[lvl]
    hps = jnp.asarray([m[2] for m in mip_meta], jnp.int32)[lvl]

    # Patch origin on the mip grid (tile-snapped columns).
    u0m = jnp.floor(u_min * inv).astype(jnp.int32)
    v0 = jnp.clip(
        jnp.floor(v_min * inv).astype(jnp.int32), 0, hps - _PATCH_ROWS
    )
    k0 = jnp.clip(u0m // _TILE_W, 0, wts - _PATCH_TILES)

    # Row ids of the patch: (C, 32 rows, 2 tiles).
    dy = jnp.arange(_PATCH_ROWS, dtype=jnp.int32)
    dx = jnp.arange(_PATCH_TILES, dtype=jnp.int32)
    rid = (
        offs[:, None, None]
        + (v0[:, None, None] + dy[None, :, None]) * wts[:, None, None]
        + k0[:, None, None]
        + dx[None, None, :]
    )
    patch = mip_tiles[rid.reshape(-1)].reshape(
        C, _PATCH_ROWS, _PATCH_TILES, _TILE_W
    ).reshape(C, _PATCH_P)                                 # (C, 2048)

    # Patch-local index of every voxel's nearest mip sample.
    u_m = jnp.round(u * inv[:, None]).astype(jnp.int32)
    v_m = jnp.round(v * inv[:, None]).astype(jnp.int32)
    pu = u_m - k0[:, None] * _TILE_W
    pv = v_m - v0[:, None]
    inpatch = (
        (pu >= 0) & (pu < _PATCH_TILES * _TILE_W)
        & (pv >= 0) & (pv < _PATCH_ROWS)
        & front
    )
    pidx = jnp.where(inpatch, pv * (_PATCH_TILES * _TILE_W) + pu, -1)

    # One one-hot, four 8-BIT value columns.  bf16 has an 8-bit
    # significand, so wider integer payloads would be truncated;
    # byte-sliced columns are exact in bf16 -- every product is
    # 0/1 x (<= 255), each (block, voxel) row hits exactly one patch
    # index, and the sum accumulates in f32.  P-minor rhs + NT-form dot (contract the rhs's minor dim): avoids
    # materializing a byte-minor (C, P, 4) layout -- see the same
    # restructure in ops/icp.py _PatchAssoc.freeze_windows.
    rhs = jnp.stack(
        [
            (patch >> 24) & 0xFF,
            (patch >> 16) & 0xFF,
            (patch >> 8) & 0xFF,
            patch & 0xFF,
        ],
        axis=1,
    ).astype(jnp.bfloat16)                                 # (C, 4, P)
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, _PATCH_P), 2)
    onehot = (pidx[:, :, None] == iota).astype(jnp.bfloat16)
    vals = jax.lax.dot_general(
        onehot, rhs,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)                                    # (C, 512, 4)
    d16 = ((vals[..., 0] << 8) | vals[..., 1]).astype(jnp.float32)
    c565 = (vals[..., 2] << 8) | vals[..., 3]
    depth = d16 * (1.0 / config.depth_raw_scale)
    r = ((c565 >> 11) & 0x1F).astype(jnp.float32) * (1.0 / 31.0)
    g = ((c565 >> 5) & 0x3F).astype(jnp.float32) * (1.0 / 63.0)
    b = (c565 & 0x1F).astype(jnp.float32) * (1.0 / 31.0)
    return depth, jnp.stack([r, g, b], axis=-1), inpatch


def resolve_integrate_gather(config: Config) -> str:
    """``Config.integrate_gather`` with ``"auto"`` resolved to one fixed
    choice on every backend: the flat per-element gather, which the
    GPU measurement in PERF.md prefers to the one-hot patch path."""
    mode = config.integrate_gather
    return "flat" if mode == "auto" else mode


def _integrate_batch(volume, frame, packed_img, ids, row_valid, config):
    """Fuse one chunk of blocks; returns updated voxel arrays (C, 512).

    ``packed_img`` is either the flat (H, W) packed image (flat-gather
    path) or the (mip_tiles, mip_meta) pair (one-hot matmul path).
    """
    bs = config.block_size
    vs = config.voxel_size
    coords = volume.block_coords[ids]                     # (C, 3)
    local = jnp.stack(
        jnp.meshgrid(
            jnp.arange(bs), jnp.arange(bs), jnp.arange(bs), indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 3)                                      # (512, 3)
    g = coords[:, None, :] * bs + local                   # (C, 512, 3)
    world = g.astype(jnp.float32) * vs

    cam_pts = frame.pose.inverse().apply(world)
    z = cam_pts[..., 2]
    uv = frame.camera.project(cam_pts)
    if isinstance(packed_img, tuple):
        mip_tiles, mip_meta = packed_img
        depth, color, in_bounds = _patch_gather_depth_color(
            uv, z, mip_tiles, mip_meta, config
        )
    else:
        packed, in_bounds = _sample_nearest(packed_img, uv)
        depth, color = _unpack_depth_color(packed, config)
    valid = (
        row_valid[:, None]
        & in_bounds
        & (depth > config.depth_min)
        & (depth < config.depth_max)
        & (z > 0.0)
    )
    sdf = depth - z

    old_tsdf = volume.tsdf[ids]
    old_cpack = volume.colorpack[ids]
    weight = volume.weight[ids]
    col, cweight = B.unpack_voxel_color(old_cpack)
    tsdf, weight, col, cweight = voxel_update(
        old_tsdf, weight, col, cweight, sdf, color, valid, config
    )
    # Refresh the persistent surfel lists of exactly the rows whose TSDF
    # this chunk changed (see VolumeState.surfpack).
    surf, surf_count, dropped = B.pack_surfels(
        tsdf, weight, B.surfel_band(config), config.surfel_slots
    )
    cpack = B.pack_voxel_color(col, cweight)
    # Mesh-dirty gate: a block only needs re-meshing when its VALUES
    # moved -- at steady state most band blocks integrate saturated
    # observations whose running averages barely change, and blanket
    # marking made the incremental mesher re-process the whole visible
    # band every cadence (measured 10-20k blocks / 10 frames vs a few
    # hundred truly-changed).  TSDF deltas below mesh_dirty_eps move an
    # interpolated vertex by < eps/2 voxels (sub-quantization); the
    # color test compares the stored rgb888 BYTES and ignores the
    # 8-bit color-weight counter, which keeps ramping for ~seconds
    # after the quantized color has stabilized.
    eps = config.mesh_dirty_eps
    if eps > 0.0:
        changed = (
            jnp.any(jnp.abs(tsdf - old_tsdf) > eps, axis=1)
            | jnp.any(
                (cpack & 0xFFFFFF) != (old_cpack & 0xFFFFFF), axis=1
            )
        )
    else:
        changed = jnp.ones(ids.shape, bool)
    return (
        tsdf, weight, cpack,
        surf, surf_count, jnp.sum(dropped), changed,
    )


def integrate_sparse(
    volume: B.VolumeState,
    frame: Frame,
    config: Config,
    ids: jax.Array | None = None,
    count: jax.Array | None = None,
) -> B.VolumeState:
    """Fuse one frame into the listed blocks.

    Default work list: ``volume.visible_ids`` (the reference semantics:
    integrate every frustum-visible block).  The online pipeline passes the
    frame's truncation-BAND list from allocation instead: only those blocks
    can change, and the visible set accumulates the whole in-view history,
    so band integration does ~3-5x less per-voxel depth-image sampling.
    The one semantic difference -- free-space carving of previously-fused
    blocks now only happens inside the band -- matches what the truncation
    update rule can change anyway (voxels at sdf > mu clamp to +1, their
    init value, unless they once held surface).
    """
    work_ids = volume.visible_ids if ids is None else ids
    work_count = volume.num_visible if count is None else count
    V = work_ids.shape[0]
    C = min(getattr(config, "integrate_chunk", 1024), V)
    n_chunks_needed = (work_count + C - 1) // C
    nb = volume.tsdf.shape[0]
    packed_dc = _pack_depth_color(frame.depth, frame.color, config)
    if resolve_integrate_gather(config) == "onehot":
        packed_dc = _build_mip_tiles(packed_dc)

    # surf_overflow is a per-frame GAUGE (how many surfels this frame's
    # slot capacity dropped -- a hole-fill burden indicator, not an
    # error), so it resets here rather than accumulating forever.
    volume = dataclasses.replace(
        volume, surf_overflow=jnp.asarray(0, jnp.int32)
    )

    def cond(carry):
        i, _ = carry
        return i < n_chunks_needed

    def body(carry):
        i, vol = carry
        start = i * C
        ids = jax.lax.dynamic_slice_in_dim(work_ids, start, C)
        row_valid = (
            (start + jnp.arange(C, dtype=jnp.int32)) < work_count
        ) & (ids > 0)
        tsdf, weight, cpack, surf, s_count, s_drop, changed = (
            _integrate_batch(vol, frame, packed_dc, ids, row_valid, config)
        )
        tgt = jnp.where(row_valid, ids, nb)               # drop masked rows
        mark = jnp.where(row_valid & changed, ids, nb)
        vol = dataclasses.replace(
            vol,
            tsdf=vol.tsdf.at[tgt].set(tsdf, mode="drop"),
            weight=vol.weight.at[tgt].set(weight, mode="drop"),
            colorpack=vol.colorpack.at[tgt].set(cpack, mode="drop"),
            surfpack=vol.surfpack.at[tgt].set(surf, mode="drop"),
            surf_count=vol.surf_count.at[tgt].set(s_count, mode="drop"),
            surf_overflow=(vol.surf_overflow + s_drop).astype(jnp.int32),
            mesh_dirty=vol.mesh_dirty.at[mark].set(True, mode="drop"),
        )
        return i + 1, vol

    # Incremental-mesh dirty marks ride the chunk loop (one masked
    # scatter of the CHANGED rows per chunk -- see _integrate_batch's
    # mesh-dirty gate).  Neighbor expansion -- a changed block also
    # dirties the up-to-7 blocks whose mesh halos read it -- costs 7
    # hash lookups per id and is deferred to mesh-update time
    # (ops/mcubes.update_mesh_cache), keeping the per-frame tracking
    # cost at ~one scatter.
    _, volume = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), volume)
    )
    return volume
