"""Surfel-splatting renderer: the scatter-based alternative to ray marching.

Motivation: per-pixel volume sampling costs ~20M random gathers per
640x480 frame.  Splatting inverts the loop -- iterate over the VOLUME's surface, not over pixels:

  1. **Surface-block compaction**: only blocks holding voxels near the
     zero crossing can emit surfels; the visible list is filtered to them
     with one dense row pass + sort (typically a 3-6x cut of the splat
     work at scene scale -- free space and carved interiors never splat).
  2. **Surfel extraction** (dense, per surface block): a zero crossing of
     the TSDF along +x/+y/+z between neighboring voxels is a surface point
     with a sub-voxel offset t = f0/(f0-f1).  The default path reads block
     rows + the three +axis neighbor faces STRAIGHT from the volume (3
     hash lookups per block) -- no render-cache halos are built at all.
  3. **Splat**: project every candidate voxel-edge crossing and
     scatter-min its camera depth into the z-buffer, masked (no compaction
     pass: a masked scatter is cheaper than any sort-based surfel
     selection, and nothing is ever dropped).  Back-facing
     crossings are culled by their axis-aligned normal sign.
  4. **Hole fill**: surfels are ~1 px apart at range; small holes close
     with valid-neighbor-min dilation rounds (dense shifts), gated on
     neighborhood depth consistency so silhouettes don't bleed.
  5. **Polish / gradient normals / color** (optional): these need
     trilinear volume sampling, so they run over a RenderCache
     (ops/render_cache.py); the cache is only built when one of them is
     requested -- the default depth-tracking pipeline never builds it.

Trade-offs vs the hierarchical march (ops/raycast.py): ~5x fewer random
accesses; silhouettes can bleed by up to the fill radius into unseen
pixels.  Select with ``Config.render_mode = "splat"``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.se3 import SE3
from . import blocks as B
from . import render_cache as RC
from .preprocess import _shift2d
from .raycast import Render, _cross_normals_axes


def _splat_band(config: Config) -> float:
    """|tsdf| gate (mu units) for voxel surfels (shared definition in
    blocks.surfel_band -- integrate-time surfel maintenance must agree)."""
    return B.surfel_band(config)


def _surface_block_list(volume: B.VolumeState, config: Config):
    """Compact the visible list to blocks that can emit surfels.

    A block participates only if it holds an observed voxel inside the
    splat band.  One dense row pass + one prefix-sum compaction.

    (A finer-grained 64-voxel slab list was tried and REVERTED: the
    (NB,512)->(NB*8,64) view forced XLA to materialize full-volume
    relayout copies in the splat loop carry, costing more than the
    ~30% scatter-lane cut saved -- the bench scene's floor has y/z
    normals, so its shell crosses every x-slab anyway.)
    """
    ids = volume.visible_ids
    V = ids.shape[0]
    rowv = (jnp.arange(V, dtype=jnp.int32) < volume.num_visible) & (ids > 0)
    band = _splat_band(config)
    t = volume.tsdf[ids]
    w = volume.weight[ids]
    near = (jnp.abs(t) < band) & (w > 0.0)
    has_surf = rowv & jnp.any(near, axis=1)
    from .allocate import compact_mask

    n_surf = jnp.sum(has_surf).astype(jnp.int32)
    return compact_mask(has_surf, ids, V, jnp.int32(0)), n_surf


def _surfel_block_list(volume: B.VolumeState, config: Config):
    """Visible blocks with a nonempty persistent surfel list.

    Replaces the dense tsdf-row pass of ``_surface_block_list`` on the
    surfel path: the per-block counts are maintained by integration, so
    this is one (V,) gather + a prefix-sum compaction."""
    ids = volume.visible_ids
    V = ids.shape[0]
    rowv = (jnp.arange(V, dtype=jnp.int32) < volume.num_visible) & (ids > 0)
    has_surf = rowv & (volume.surf_count[ids] > 0)
    from .allocate import compact_mask

    n_surf = jnp.sum(has_surf).astype(jnp.int32)
    return compact_mask(has_surf, ids, V, jnp.int32(0)), n_surf


def select_voxel_rgb(colorpack_rows, lidx):
    """Per-surfel voxel color bytes: ``(C, 512)`` colorpack rows and
    ``(C, S)`` voxel indices -> ``(C, S, 3)`` int32 r, g, b.

    A one-hot byte-column matmul: every product is 0/1 times a byte, each
    row has exactly one hit, and the sum accumulates in f32, so the
    result equals ``take_along_axis`` bit for bit (checked at full size
    by ``chip_smoke.py`` on the GPU and at small size by the CPU tests).
    """
    cp = colorpack_rows
    rhs = jnp.stack(
        [(cp >> 16) & 0xFF, (cp >> 8) & 0xFF, cp & 0xFF], axis=-1
    ).astype(jnp.bfloat16)
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, cp.shape[1]), 2)
    onehot = (lidx[:, :, None] == iota).astype(jnp.bfloat16)
    return jax.lax.dot_general(
        onehot, rhs,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)


_ZQ_BITS = 19                       # packed-luma depth quantization bits
_ZQ_MAX = (1 << _ZQ_BITS) - 1       # depth step = ray_far / _ZQ_MAX
                                    # (9.5 um at the 5 m default -- below
                                    # the ICP model maps' own 15 um
                                    # vertex packing, so invisible to
                                    # tracking)
_LUMA_EMPTY = 0x7FFFFFFF             # packed-luma z-buffer init value
                                     # (python int, not a module-level
                                     # jnp array: weak-typed in traces)


def _decode_luma_zbuf(word: jax.Array, config: Config):
    """Packed (zq19 << 12 | i12) -> (depth f32 w/ +inf empty, intensity)."""
    valid = word != _LUMA_EMPTY
    depth = jnp.where(
        valid,
        (word >> 12).astype(jnp.float32) * (config.ray_far / _ZQ_MAX),
        jnp.inf,
    )
    inten = jnp.where(
        valid, (word & 0xFFF).astype(jnp.float32) * (1.0 / 4095.0), 0.0
    )
    return depth, inten


def _splat_zbuf_surfels(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
    with_color: bool = False,
    luma: bool = False,
):
    """Z-buffer from the persistent per-block surfel lists.

    Identical projective-TSDF surfel model to ``_splat_zbuf_direct``
    (z_surf = z_voxel + tsdf * mu on the voxel's own ray), but the
    scatter runs over the COMPACTED surfel rows maintained by
    integration: ~4x fewer scatter lanes, and no per-frame dense row
    pass to find them.

    ``with_color=True`` adds a SECOND pass over the same surfels that
    scatters each winner's voxel color (rgb888) wherever its depth
    matches the finished z-buffer -- the cache-free model-color path
    (the render-cache build this replaces re-gathered 729-voxel halos
    of every visible block each frame, ~10x the lanes of the surfel
    scatter).  Returns zbuf, or (zbuf, colorbuf int32 (-1 = no color)).

    ``luma=True`` (the online combined/light tracking path) collapses
    depth AND intensity into ONE scatter-min of a packed int32 word,
    ``zq19 << 12 | luma12``: the photometric tracker only ever consumes
    the model render as INTENSITY, so rgb888 fidelity buys nothing
    there, while the packed word halves the scatter lanes of the
    two-pass rgb path and removes its z-buffer re-gather entirely.
    Smaller word wins = nearest depth wins; surfels tied at the same
    9.5 um depth bin resolve to the darker intensity (same-surface
    ties -- the rgb path already accepts either winner within a 1e-5 m
    slack).  Depth is quantized to ray_far/2^19: an order below both
    the splat renderer's output noise and the ICP maps' 15 um vertex
    packing.  12-bit intensity is FINER than the 8-bit-rgb-derived
    intensity the rgb path feeds the tracker.  Returns the packed
    int32 buffer (decode with ``_decode_luma_zbuf``).
    """
    vs = config.voxel_size
    mu = config.trunc_dist
    S = config.surfel_slots
    w2c = pose.inverse()
    R = w2c.rotation
    tr = w2c.translation
    cw = pose.translation                       # camera center, world

    render_ids, n_surf = _surfel_block_list(volume, config)
    V = render_ids.shape[0]

    zbuf0 = jnp.full((height * width,), jnp.inf, jnp.float32)

    def scatter_tier(buf, ids_list, n_list, s_lo, s_hi, chunk, zref=None):
        """Scatter surfel slots [s_lo, s_hi) of the listed blocks.

        zref=None, luma=False: min-z scatter into ``buf`` (f32 z-buffer).
        zref=None, luma=True: packed (zq|luma) scatter-min (int32 buf).
        zref=zbuf: color scatter into ``buf`` (int32 rgb888 buffer) at
        the surfels whose depth won the z-buffer."""
        C = min(chunk, ids_list.shape[0])
        n_chunks = (n_list + C - 1) // C

        def body(carry):
            i, buf = carry
            start = i * C
            ids = jax.lax.dynamic_slice_in_dim(ids_list, start, C)
            rv = (
                (start + jnp.arange(C, dtype=jnp.int32)) < n_list
            ) & (ids > 0)
            # Batched row gather THEN static slice: the fancy-index
            # form surfpack[ids, lo:hi] lowers to one dynamic-slice per
            # row; take() is a single contiguous-row gather.
            rows = jnp.take(volume.surfpack, ids, axis=0)[:, s_lo:s_hi]
            lidx, t, valid, (gx, gy, gz) = B.unpack_surfels(rows)
            valid = valid & rv[:, None]
            coords = volume.block_coords[ids]                    # (C, 3)

            lx = (lidx // 64).astype(jnp.float32)
            ly = ((lidx // 8) % 8).astype(jnp.float32)
            lz = (lidx % 8).astype(jnp.float32)
            wx = (coords[:, 0:1].astype(jnp.float32) * 8 + lx) * vs
            wy = (coords[:, 1:2].astype(jnp.float32) * 8 + ly) * vs
            wz = (coords[:, 2:3].astype(jnp.float32) * 8 + lz) * vs
            cx = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz + tr[0]
            cy = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz + tr[1]
            cz = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + tr[2]

            z_surf = cz + t * mu
            # Back-face cull: the stored quantized orientation points
            # outward (toward free space); a surfel whose orientation
            # has positive dot with the viewing ray faces away from the
            # camera and must not write depth -- at novel viewpoints a
            # hole in the front shell otherwise lets back-shell surfels
            # win the z-buffer (measured: 35% of pixels off by up to
            # the full sphere diameter on the novel-view sphere test).
            if config.splat_backface_cull:
                back = (
                    gx * (wx - cw[0])
                    + gy * (wy - cw[1])
                    + gz * (wz - cw[2])
                ) > 0.0
            else:
                back = jnp.zeros_like(valid)
            zok = (
                valid
                & ~back
                & (z_surf > config.ray_near)
                & (z_surf < config.ray_far)
                & (cz > 1e-6)
            )
            zc = jnp.maximum(cz, 1e-6)
            u = jnp.round(
                camera.fx * cx / zc + camera.cx
            ).astype(jnp.int32)
            v = jnp.round(
                camera.fy * cy / zc + camera.cy
            ).astype(jnp.int32)
            inb = (u >= 0) & (u < width) & (v >= 0) & (v < height) & zok
            pix = jnp.where(inb, v * width + u, height * width)
            if zref is None and not luma:
                buf = buf.at[pix.reshape(-1)].min(
                    jnp.where(inb, z_surf, jnp.inf).reshape(-1),
                    mode="drop",
                )
                return i + 1, buf

            cp = jnp.take(volume.colorpack, ids, axis=0)     # (C, 512)
            rgb = select_voxel_rgb(cp, lidx)                 # (C, s, 3)

            if luma:
                # Single-pass packed z+intensity scatter (see docstring).
                lum = (
                    0.299 * rgb[..., 0]
                    + 0.587 * rgb[..., 1]
                    + 0.114 * rgb[..., 2]
                ) * (1.0 / 255.0)
                i12 = jnp.clip(
                    jnp.round(lum * 4095.0), 0, 4095
                ).astype(jnp.int32)
                zq = jnp.clip(
                    jnp.round(z_surf * (_ZQ_MAX / config.ray_far)),
                    0,
                    _ZQ_MAX - 1,   # keep word strictly below _LUMA_EMPTY
                ).astype(jnp.int32)
                word = (zq << 12) | i12
                buf = buf.at[pix.reshape(-1)].min(
                    jnp.where(inb, word, _LUMA_EMPTY).reshape(-1),
                    mode="drop",
                )
                return i + 1, buf

            # Color pass (rgb two-pass path): scattered where this
            # surfel's depth matches the z-buffer winner.  1e-5 m slack
            # absorbs any cross-fusion float reassociation; a near-tie
            # then writes either surfel's color (max of rgb888 -- both
            # are the same surface).
            rgb888 = (
                (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
            )
            zb = zref[jnp.minimum(pix, height * width - 1)]
            win = inb & (z_surf <= zb + 1e-5)
            buf = buf.at[pix.reshape(-1)].max(
                jnp.where(win, rgb888, -1).reshape(-1), mode="drop"
            )
            return i + 1, buf

        return jax.lax.while_loop(
            lambda c: c[0] < n_chunks, body,
            (jnp.asarray(0, jnp.int32), buf),
        )[1]

    # Two-tier scatter: scatter lanes are paid for masked slots too, and
    # most blocks fill well under half their surfel slots -- so tier 1
    # covers slots [0, S/2) of EVERY surface block and tier 2 only the
    # few blocks that overflow into [S/2, S).
    s1 = S // 2
    from .allocate import compact_mask

    full = volume.surf_count[render_ids] > s1
    rowv = (jnp.arange(V, dtype=jnp.int32) < n_surf) & full
    ids2 = compact_mask(rowv, render_ids, V, jnp.int32(0))
    n2 = jnp.sum(rowv).astype(jnp.int32)

    if luma:
        wbuf0 = jnp.full((height * width,), _LUMA_EMPTY, jnp.int32)
        wbuf = scatter_tier(wbuf0, render_ids, n_surf, 0, s1, 2048)
        return scatter_tier(wbuf, ids2, n2, s1, S, 512)

    zbuf = scatter_tier(zbuf0, render_ids, n_surf, 0, s1, 2048)
    zbuf = scatter_tier(zbuf, ids2, n2, s1, S, 512)
    if not with_color:
        return zbuf
    cbuf0 = jnp.full((height * width,), -1, jnp.int32)
    cbuf = scatter_tier(cbuf0, render_ids, n_surf, 0, s1, 2048, zref=zbuf)
    cbuf = scatter_tier(cbuf, ids2, n2, s1, S, 512, zref=zbuf)
    return zbuf, cbuf


def _splat_zbuf_direct(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
):
    """Z-buffer of projective-TSDF voxel surfels, read straight from the
    volume: ONE candidate per near-surface voxel instead of three
    voxel-edge crossings.

    The projective TSDF stores, at each voxel, the (mu-normalized,
    weight-averaged) signed distance to the surface measured ALONG THE
    PIXEL RAY through that voxel -- so the surface depth on that ray is
    simply ``z_voxel + tsdf * mu`` (the same relation InfiniTAM's raycast
    refinement ``t* = t - F(t) * mu`` uses).  Every observed voxel with
    |tsdf| inside ``splat_band`` splats that corrected depth at the
    voxel's own projected pixel.  vs the edge-crossing formulation this
    is 3x fewer scatter lanes and needs NO neighbor faces or hash
    lookups -- block rows only.
    """
    vs = config.voxel_size
    mu = config.trunc_dist
    w2c = pose.inverse()
    R = w2c.rotation
    tr = w2c.translation
    cw = pose.translation                       # camera center, world

    render_ids, n_surf = _surface_block_list(volume, config)
    V = render_ids.shape[0]
    C = min(1024, V)
    n_chunks = (n_surf + C - 1) // C

    # Planar local voxel coordinates, (1, 512) row-major (lx*8+ly)*8+lz.
    lidx = jnp.arange(512, dtype=jnp.int32)[None, :]
    lx = (lidx // 64).astype(jnp.float32)
    ly = ((lidx // 8) % 8).astype(jnp.float32)
    lz = (lidx % 8).astype(jnp.float32)

    band = _splat_band(config)
    zbuf0 = jnp.full((height * width,), jnp.inf, jnp.float32)

    def body(carry):
        i, zbuf = carry
        start = i * C
        ids = jax.lax.dynamic_slice_in_dim(render_ids, start, C)
        rv = (
            (start + jnp.arange(C, dtype=jnp.int32)) < n_surf
        ) & (ids > 0)
        t = volume.tsdf[ids]                                  # (C, 512)
        obs = (volume.weight[ids] > 0.0) & rv[:, None]
        coords = volume.block_coords[ids]                     # (C, 3)

        wx = (coords[:, 0:1].astype(jnp.float32) * 8 + lx) * vs
        wy = (coords[:, 1:2].astype(jnp.float32) * 8 + ly) * vs
        wz = (coords[:, 2:3].astype(jnp.float32) * 8 + lz) * vs
        cx = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz + tr[0]
        cy = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz + tr[1]
        cz = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + tr[2]

        z_surf = cz + t * mu
        # Identical back-face cull to the surfel path (same quantized
        # orientation, computed on the fly here) -- the two renderers
        # must stay bit-equal (test_splat_surfels_matches_direct).
        if config.splat_backface_cull:
            gxq, gyq, gzq = B.quantized_orientation(t)
            back = (
                gxq.astype(jnp.float32) * (wx - cw[0])
                + gyq.astype(jnp.float32) * (wy - cw[1])
                + gzq.astype(jnp.float32) * (wz - cw[2])
            ) > 0.0
        else:
            back = jnp.zeros_like(obs)
        zok = (
            obs
            & ~back
            & (jnp.abs(t) < band)
            & (z_surf > config.ray_near)
            & (z_surf < config.ray_far)
            & (cz > 1e-6)
        )
        zc = jnp.maximum(cz, 1e-6)
        u = jnp.round(camera.fx * cx / zc + camera.cx).astype(jnp.int32)
        v = jnp.round(camera.fy * cy / zc + camera.cy).astype(jnp.int32)
        inb = (u >= 0) & (u < width) & (v >= 0) & (v < height) & zok
        pix = jnp.where(inb, v * width + u, height * width)
        # One masked scatter-min per chunk (pre-compacting the ~15% live
        # surfels with a cumsum pack before the scatter was tried and
        # reverted: it ran slower in situ than the straight masked
        # scatter).
        zbuf = zbuf.at[pix.reshape(-1)].min(
            jnp.where(inb, z_surf, jnp.inf).reshape(-1), mode="drop"
        )
        return i + 1, zbuf

    def cond(carry):
        return carry[0] < n_chunks

    _, zbuf = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), zbuf0)
    )
    return zbuf


def _splat_zbuf_cached(
    volume: B.VolumeState,
    cache: RC.RenderCache,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
):
    """Z-buffer from the render-cache halos (used when polish / gradient
    normals / color need the cache anyway)."""
    vs = config.voxel_size
    w2c = pose.inverse()
    R = w2c.rotation
    tr = w2c.translation

    V = volume.visible_ids.shape[0]
    C = min(1024, V)
    n_chunks = (volume.num_visible + C - 1) // C

    zbuf0 = jnp.full((height * width,), jnp.inf, jnp.float32)

    lidx = jnp.arange(512, dtype=jnp.int32)[None, :]       # (1, 512)
    lx = (lidx // 64).astype(jnp.float32)
    ly = ((lidx // 8) % 8).astype(jnp.float32)
    lz = (lidx % 8).astype(jnp.float32)

    def body(carry):
        i, zbuf = carry
        start = i * C
        off = (start + 1) * 729
        t = jax.lax.dynamic_slice_in_dim(cache.tsdf, off, C * 729).reshape(
            C, 9, 9, 9
        )
        m = jax.lax.dynamic_slice_in_dim(cache.march, off, C * 729).reshape(
            C, 9, 9, 9
        )
        obs = m != RC.MARCH_UNSEEN
        f0 = t[:, :8, :8, :8].reshape(C, 512)
        o0 = obs[:, :8, :8, :8].reshape(C, 512)
        rows = start + 1 + jnp.arange(C, dtype=jnp.int32)
        coords = volume.block_coords[cache.row_block[rows]]  # (C, 3)
        bx = (coords[:, 0:1] * 8).astype(jnp.float32) + lx
        by = (coords[:, 1:2] * 8).astype(jnp.float32) + ly
        bz = (coords[:, 2:3] * 8).astype(jnp.float32) + lz

        for axis, sl in enumerate(
            (
                (slice(1, 9), slice(0, 8), slice(0, 8)),
                (slice(0, 8), slice(1, 9), slice(0, 8)),
                (slice(0, 8), slice(0, 8), slice(1, 9)),
            )
        ):
            f1 = t[:, sl[0], sl[1], sl[2]].reshape(C, 512)
            o1 = obs[:, sl[0], sl[1], sl[2]].reshape(C, 512)
            crossing = o0 & o1 & ((f0 > 0.0) != (f1 > 0.0))
            tt = jnp.clip(
                f0 / jnp.where(jnp.abs(f0 - f1) > 1e-12, f0 - f1, 1.0),
                0.0,
                1.0,
            )
            px = bx + tt * (axis == 0)
            py = by + tt * (axis == 1)
            pz = bz + tt * (axis == 2)
            wx = px * vs
            wy = py * vs
            wz = pz * vs
            cx = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz + tr[0]
            cy = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz + tr[1]
            cz = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + tr[2]
            # Back-face cull: normal ~ -sign(f0) * e_axis (toward +TSDF);
            # front-facing iff ray . normal < 0.  Crude but kills far-side
            # surfaces showing through front-side holes.
            sgn = jnp.where(f0 > 0.0, -1.0, 1.0)
            ndot = sgn * (
                R[0, axis] * cx + R[1, axis] * cy + R[2, axis] * cz
            )
            zok = (
                crossing
                & (cz > config.ray_near)
                & (cz < config.ray_far)
                & (ndot < 0.0)
            )
            zc = jnp.maximum(cz, 1e-6)
            u = jnp.round(camera.fx * cx / zc + camera.cx).astype(jnp.int32)
            v = jnp.round(camera.fy * cy / zc + camera.cy).astype(jnp.int32)
            inb = (u >= 0) & (u < width) & (v >= 0) & (v < height) & zok
            pix = jnp.where(inb, v * width + u, height * width)
            zbuf = zbuf.at[pix.reshape(-1)].min(
                jnp.where(inb, cz, jnp.inf).reshape(-1), mode="drop"
            )
        return i + 1, zbuf

    def cond(carry):
        return carry[0] < n_chunks

    _, zbuf = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), zbuf0)
    )
    return zbuf


def _fill_and_smooth(d, config: Config):
    """Hole fill + edge-aware smoothing of the splatted depth.  ``d``:
    depth with +inf for invalid.  Static 3x3 shifts that XLA fuses into
    elementwise loops.

    Fill only where the 3x3 neighborhood agrees on one surface (filling
    across a silhouette would bleed depth); then average valid neighbors
    within half a truncation band to remove the +-0.5 px surfel rounding
    that makes cross-product normals noisy.
    """
    mu = config.trunc_dist
    for _ in range(config.splat_fill_rounds):
        best = d
        worst = jnp.where(jnp.isfinite(d), d, -jnp.inf)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                n_d = _shift2d(d, dy, dx, fill=jnp.inf)
                best = jnp.minimum(best, n_d)
                worst = jnp.maximum(
                    worst, jnp.where(jnp.isfinite(n_d), n_d, -jnp.inf)
                )
        consistent = (worst - best) < 2.0 * mu
        d = jnp.where(jnp.isfinite(d) | ~consistent, d, best)
    acc = jnp.where(jnp.isfinite(d), d, 0.0)
    cnt = jnp.isfinite(d).astype(jnp.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            n_d = _shift2d(d, dy, dx, fill=jnp.inf)
            ok = jnp.isfinite(n_d) & (jnp.abs(n_d - d) < 0.5 * mu)
            acc = acc + jnp.where(ok, n_d, 0.0)
            cnt = cnt + ok
    return jnp.where(jnp.isfinite(d), acc / jnp.maximum(cnt, 1.0), d)


def render_splat(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
    normals: str = "cross",
    with_color: bool = True,
    cache: RC.RenderCache | None = None,
    color_space: str = "rgb",
) -> Render:
    """Render model maps by surfel splatting (see module docstring).

    ``color_space="luma"`` (online combined/light tracking): the model
    color is rendered as a grey intensity image by the single-pass
    packed z+luma scatter (see ``_splat_zbuf_surfels``) -- the
    photometric tracker reduces the color to intensity anyway, and the
    packed pass halves the color-splat scatter lanes.  Falls back to
    the rgb path whenever the surfel color pass is unavailable."""
    vs = config.voxel_size
    # The cache is only needed for trilinear work (polish, gradient
    # normals) -- and for color ONLY on the non-surfel sources: the
    # surfel renderer colors its own z-buffer winners in a second
    # scatter pass, cache-free (this is what makes combined-mode
    # tracking affordable: the cache build re-gathered 729-voxel halos
    # of every visible block each frame).
    surfel_color = (
        with_color
        and config.splat_source == "surfels"
        and config.splat_polish == 0
        and normals != "gradient"
        and cache is None
    )
    need_cache = (
        config.splat_polish > 0
        or normals == "gradient"
        or (with_color and not surfel_color)
    )
    cbuf = None
    ibuf = None
    if need_cache:
        if cache is None:
            cache = RC.build(volume, config)
        zbuf = _splat_zbuf_cached(
            volume, cache, camera, pose, height, width, config
        )
    elif surfel_color and color_space == "luma":
        wbuf = _splat_zbuf_surfels(
            volume, camera, pose, height, width, config, luma=True
        )
        zbuf, ibuf = _decode_luma_zbuf(wbuf, config)
    elif surfel_color:
        zbuf, cbuf = _splat_zbuf_surfels(
            volume, camera, pose, height, width, config, with_color=True
        )
    elif config.splat_source == "surfels":
        zbuf = _splat_zbuf_surfels(
            volume, camera, pose, height, width, config
        )
    else:
        zbuf = _splat_zbuf_direct(
            volume, camera, pose, height, width, config
        )
    depth = zbuf.reshape(height, width)
    has = jnp.isfinite(depth)

    d = _fill_and_smooth(jnp.where(has, depth, jnp.inf), config)
    depth = jnp.where(jnp.isfinite(d), d, 0.0)
    hit = depth > 0.0

    # --- view-ray geometry ---------------------------------------------------
    rays_cam = camera.rays(height, width)
    rays_world = pose.rotate(rays_cam)
    dx_ = rays_world[..., 0]
    dy_ = rays_world[..., 1]
    dz_ = rays_world[..., 2]
    origin = pose.translation
    ox, oy, oz = origin[0], origin[1], origin[2]

    # --- optional trilinear polish onto the exact ray crossing --------------
    t_surf = depth
    if config.splat_polish > 0:
        inv_dn = 1.0 / jnp.maximum(
            jnp.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_), 1e-9
        )
        half = 2.0 * vs * inv_dn

        def sample_tri(t):
            return RC.sample_march_trilinear_axes(
                cache, ox + t * dx_, oy + t * dy_, oz + t * dz_, config
            )

        t_lo = t_surf - half
        t_hi = t_surf + half
        f_both, ok_both = sample_tri(jnp.stack([t_lo, t_hi], axis=0))
        f_lo, f_hi = f_both[0], f_both[1]
        bracket = (f_lo > 0.0) & (f_hi <= 0.0) & ok_both[0] & ok_both[1]
        for _ in range(config.splat_polish - 1):
            denom = f_lo - f_hi
            alpha = jnp.where(jnp.abs(denom) > 1e-12, f_lo / denom, 0.5)
            t_mid = t_lo + jnp.clip(alpha, 0.0, 1.0) * (t_hi - t_lo)
            f_mid, _ = sample_tri(t_mid)
            posm = f_mid > 0.0
            t_lo = jnp.where(posm, t_mid, t_lo)
            f_lo = jnp.where(posm, f_mid, f_lo)
            t_hi = jnp.where(posm, t_hi, t_mid)
            f_hi = jnp.where(posm, f_hi, f_mid)
        denom = f_lo - f_hi
        alpha = jnp.where(jnp.abs(denom) > 1e-12, f_lo / denom, 0.5)
        t_ref = t_lo + jnp.clip(alpha, 0.0, 1.0) * (t_hi - t_lo)
        t_surf = jnp.where(bracket & hit, t_ref, t_surf)

    px = ox + t_surf * dx_
    py = oy + t_surf * dy_
    pz = oz + t_surf * dz_

    if normals == "gradient":
        nx, ny, nz, n_ok = RC.sample_gradient_axes(cache, px, py, pz, config)
    else:
        nx, ny, nz, n_ok = _cross_normals_axes(px, py, pz, hit)
    flip = nx * dx_ + ny * dy_ + nz * dz_ > 0.0
    sign = jnp.where(flip, -1.0, 1.0)
    nx, ny, nz = nx * sign, ny * sign, nz * sign

    # Normal smoothing (vector mean over valid 3x3, renormalized): residual
    # splat quantization makes raw cross-product normals noisy.
    for _ in range(1):
        ax = jnp.where(n_ok, nx, 0.0)
        ay = jnp.where(n_ok, ny, 0.0)
        az = jnp.where(n_ok, nz, 0.0)
        sx_, sy_, sz_ = ax, ay, az
        for ddy in (-1, 0, 1):
            for ddx in (-1, 0, 1):
                if ddx == 0 and ddy == 0:
                    continue
                sx_ = sx_ + _shift2d(ax, ddy, ddx)
                sy_ = sy_ + _shift2d(ay, ddy, ddx)
                sz_ = sz_ + _shift2d(az, ddy, ddx)
        nrm = jnp.sqrt(sx_ * sx_ + sy_ * sy_ + sz_ * sz_)
        good = nrm > 1e-6
        inv = 1.0 / jnp.maximum(nrm, 1e-6)
        nx = jnp.where(good & n_ok, sx_ * inv, nx)
        ny = jnp.where(good & n_ok, sy_ * inv, ny)
        nz = jnp.where(good & n_ok, sz_ * inv, nz)

    if with_color and ibuf is not None:
        # Luma path: diffuse intensity into depth-hole-filled pixels
        # (same reach and reason as the rgb diffusion below), then
        # broadcast grey -- intensity_from_color of (i, i, i) is i
        # exactly, so the photometric tracker sees the packed intensity
        # unchanged.  The broadcast is one dense write (~4 MB at
        # 640x480), nothing gathers from it per element.
        inten = ibuf.reshape(height, width)
        i_ok = has      # pre-fill scatter validity (= packed-word hits)
        for _ in range(config.splat_fill_rounds):
            okf = i_ok.astype(jnp.float32)
            acc = inten * okf
            cnt = okf
            for ddy in (-1, 0, 1):
                for ddx in (-1, 0, 1):
                    if ddx == 0 and ddy == 0:
                        continue
                    acc = acc + _shift2d(inten * okf, ddy, ddx)
                    cnt = cnt + _shift2d(okf, ddy, ddx)
            grown = cnt > 0.0
            fill = acc / jnp.maximum(cnt, 1.0)
            inten = jnp.where(~i_ok & grown, fill, inten)
            i_ok = i_ok | grown
        color = jnp.broadcast_to(inten[..., None], (height, width, 3))
    elif with_color and cbuf is not None:
        cimg = cbuf.reshape(height, width)
        c_ok = cimg >= 0
        color = jnp.where(
            c_ok[..., None],
            jnp.stack(
                [
                    (cimg >> 16) & 0xFF,
                    (cimg >> 8) & 0xFF,
                    cimg & 0xFF,
                ],
                axis=-1,
            ).astype(jnp.float32)
            * (1.0 / 255.0),
            0.0,
        )
        # Depth-hole-filled pixels have no scattered color; leaving them
        # black would feed zero intensity into the photometric tracker
        # (Render.valid covers them).  Diffuse valid neighbor colors in
        # with the same reach as the depth fill.
        for _ in range(config.splat_fill_rounds):
            okf = c_ok.astype(jnp.float32)
            acc = color * okf[..., None]
            cnt = okf
            for ddy in (-1, 0, 1):
                for ddx in (-1, 0, 1):
                    if ddx == 0 and ddy == 0:
                        continue
                    acc = acc + _shift2d(
                        color * okf[..., None], ddy, ddx
                    )
                    cnt = cnt + _shift2d(okf, ddy, ddx)
            grown = cnt > 0.0
            fill = acc / jnp.maximum(cnt, 1.0)[..., None]
            color = jnp.where((~c_ok & grown)[..., None], fill, color)
            c_ok = c_ok | grown
    elif with_color:
        color, _ = RC.sample_color_nearest_axes(
            cache, volume, px, py, pz, config
        )
    else:
        color = jnp.zeros((height, width, 3))

    valid = hit & n_ok
    m = valid[..., None]
    z = jnp.zeros(())
    return Render(
        depth=jnp.where(valid, t_surf, 0.0),
        vx=jnp.where(valid, px, z),
        vy=jnp.where(valid, py, z),
        vz=jnp.where(valid, pz, z),
        nx=jnp.where(valid, nx, z),
        ny=jnp.where(valid, ny, z),
        nz=jnp.where(valid, nz, z),
        color=jnp.where(m, color, 0.0),
        valid=valid,
        camera=camera,
        pose=pose,
    )
