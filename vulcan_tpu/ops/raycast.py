"""Sparse raycast through the voxel-block hash.

JAX rebuild of the reference's ``Tracer`` (SURVEY.md component #16,
``tracer.cu`` [M]; per-pixel ray march with block skipping, sign-change
detection and trilinear refinement [P:1410.0925] [B]).  Structure:

  1. **Min/max range image** (coarse, 1/``range_scale`` resolution): visible
     blocks stamp their projected AABB with scatter-min/max -- the XLA
     replacement for InfiniTAM's atomicMin/Max rasterization.  Blocks whose
     footprint exceeds the fixed stamp contribute to a conservative global
     range instead (never a silent miss).
  2. **Batched march**: the per-frame ``render_cache`` (dense block grid +
     haloed visible blocks) makes each sample two dense gathers -- no hash
     probing anywhere (the CUDA reference pays a bucket walk per step).
     Instead of a per-step adaptive walk (latency-bound: every gather
     would wait on the previous step), each round samples
     ``raycast_chunk`` data-INDEPENDENT positions across the per-ray range
     interval at once and scans for the first sign change -- the
     vectorized answer to march divergence (SURVEY.md §7 hard part #1).
  3. **Secant refinement** on trilinear samples, then world-space
     vertex/normal/color maps.  Normals come from the image-space cross
     product of the vertex map (KinectFusion-style) -- one pass, no extra
     volume reads; TSDF-gradient normals are available via
     ``normals="gradient"`` for mesh-quality rendering.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.se3 import SE3
from ..utils.pytree import pytree_dataclass
from . import blocks as B
from . import render_cache as RC


@pytree_dataclass
class Render:
    """Raycast output ("model frame" consumed by the tracker).

    Vertex/normal channels are stored PLANAR ((H, W) each): both
    renderers compute them planar, the tracker consumes them planar,
    and stacking into (H, W, 3) would add a strided copy per array per
    frame.  The stacked views remain available as properties for
    API/offline consumers."""

    depth: jax.Array          # (H, W) z-depth, 0 invalid
    vx: jax.Array             # (H, W) world vertex channels
    vy: jax.Array
    vz: jax.Array
    nx: jax.Array             # (H, W) world unit normal channels, 0 invalid
    ny: jax.Array
    nz: jax.Array
    color: jax.Array          # (H, W, 3)
    valid: jax.Array          # (H, W) bool
    camera: PinholeCamera
    pose: SE3                 # camera-to-world used for the cast

    @property
    def vertex_world(self) -> jax.Array:  # (H, W, 3)
        return jnp.stack([self.vx, self.vy, self.vz], axis=-1)

    @property
    def normal_world(self) -> jax.Array:  # (H, W, 3)
        return jnp.stack([self.nx, self.ny, self.nz], axis=-1)


def compute_range_image(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
):
    """Per-pixel conservative [t_min, t_max] from visible-block AABBs.

    Returns (t_min, t_first_max, t_max) at full resolution (upsampled from
    the coarse grid).  ``t_first_max`` is the exit depth of the NEAREST
    stamped block: the march sizes its round-1 sample spacing to the first
    block's band, since that is where the surface almost always is.
    Pixels no visible block projects to get an empty range (t_min > t_max),
    so their rays never march.
    """
    sc = config.range_scale
    hc = -(-height // sc)
    wc = -(-width // sc)
    ids = volume.visible_ids
    V = ids.shape[0]
    row_valid = (jnp.arange(V, dtype=jnp.int32) < volume.num_visible) & (
        ids > 0
    )

    be = config.block_extent
    coords = volume.block_coords[ids].astype(jnp.float32)     # (V, 3)
    # 8 AABB corners, world -> camera.
    corner = jnp.stack(
        jnp.meshgrid(
            jnp.arange(2.0), jnp.arange(2.0), jnp.arange(2.0), indexing="ij"
        ),
        axis=-1,
    ).reshape(8, 3)
    pts = (coords[:, None, :] + corner) * be                   # (V, 8, 3)
    cam = pose.inverse().apply(pts)
    z = cam[..., 2]
    uv = camera.project(cam)

    margin = config.trunc_dist
    z_min = jnp.clip(jnp.min(z, axis=1) - margin, config.ray_near, config.ray_far)
    z_max = jnp.clip(jnp.max(z, axis=1) + margin, config.ray_near, config.ray_far)

    # Coarse-cell bbox of the projected corners.  Any corner behind the
    # camera makes the footprint unbounded -> overflow path.
    behind = jnp.any(z <= 1e-3, axis=1)
    u_min = jnp.floor(jnp.min(uv[..., 0], axis=1) / sc).astype(jnp.int32)
    u_max = jnp.floor(jnp.max(uv[..., 0], axis=1) / sc).astype(jnp.int32)
    v_min = jnp.floor(jnp.min(uv[..., 1], axis=1) / sc).astype(jnp.int32)
    v_max = jnp.floor(jnp.max(uv[..., 1], axis=1) / sc).astype(jnp.int32)
    st = config.range_stamp
    oversize = (u_max - u_min >= st) | (v_max - v_min >= st)
    overflow = row_valid & (behind | oversize)
    stampable = row_valid & ~overflow

    # Global conservative range for overflowing blocks.
    any_overflow = jnp.any(overflow)
    g_min = jnp.min(jnp.where(overflow, z_min, jnp.inf))
    g_max = jnp.max(jnp.where(overflow, z_max, -jnp.inf))

    # Fixed st x st stamp, all offsets scattered in ONE call per channel
    # (st*st sequential scatter rounds serialized badly on device).
    du = jnp.arange(st, dtype=jnp.int32)
    cu = u_min[:, None, None] + du[None, :, None]           # (V, st, 1)
    cv = v_min[:, None, None] + du[None, None, :]           # (V, 1, st)
    inside = (
        stampable[:, None, None]
        & (cu <= u_max[:, None, None])
        & (cv <= v_max[:, None, None])
        & (cu >= 0)
        & (cu < wc)
        & (cv >= 0)
        & (cv < hc)
    )                                                       # (V, st, st)
    flat = jnp.where(inside, cv * wc + cu, hc * wc).reshape(-1)
    zmin_b = jnp.broadcast_to(z_min[:, None, None], inside.shape).reshape(-1)
    zmax_b = jnp.broadcast_to(z_max[:, None, None], inside.shape).reshape(-1)
    t_min = (
        jnp.full((hc * wc,), jnp.inf, jnp.float32)
        .at[flat].min(zmin_b, mode="drop").reshape(hc, wc)
    )
    t_fmax = (
        jnp.full((hc * wc,), jnp.inf, jnp.float32)
        .at[flat].min(zmax_b, mode="drop").reshape(hc, wc)
    )
    t_max = (
        jnp.full((hc * wc,), -jnp.inf, jnp.float32)
        .at[flat].max(zmax_b, mode="drop").reshape(hc, wc)
    )

    t_min = jnp.where(any_overflow, jnp.minimum(t_min, g_min), t_min)
    t_fmax = jnp.where(any_overflow, jnp.minimum(t_fmax, g_max), t_fmax)
    t_max = jnp.where(any_overflow, jnp.maximum(t_max, g_max), t_max)

    # Upsample to full resolution (nearest).
    def up(a):
        return jnp.repeat(jnp.repeat(a, sc, 0), sc, 1)[:height, :width]

    return up(t_min), up(t_fmax), up(t_max)


def _march(
    cache, config, ox, oy, oz, dx_, dy_, dz_, t0, spacing, t_limit, active,
    S, n_rounds, compact_div=0,
):
    """Batched sign-change march (shared by the coarse and fine levels).

    Gathers S data-independent samples per round and scans for the first
    +to- crossing; records the bracketing positions AND their quantized
    values so the caller can interpolate sub-voxel depth without extra
    volume reads.  Returns (t_hit, t_before, m_before, m_hit, hit).

    With ``compact_div`` > 0, only round 1 runs at full width; the
    surviving rays (long windows at silhouettes, misses) are compacted
    into a 1/compact_div-capacity list for the remaining rounds --
    re-marching every pixel per round paid ~3x the useful gather work.
    If more rays survive round 1 than the compact capacity, a lax.cond
    falls back to full-width rounds (never silently drops rays).
    """
    inv_vs = 1.0 / config.voxel_size
    offs = jnp.arange(S, dtype=jnp.float32)
    shape = t0.shape

    def make_sampler(dx, dy, dz, spacing):
        def sample_chunk(t_start):
            ts = t_start[..., None] + spacing[..., None] * offs
            gx = jnp.round((ox + ts * dx[..., None]) * inv_vs).astype(jnp.int32)
            gy = jnp.round((oy + ts * dy[..., None]) * inv_vs).astype(jnp.int32)
            gz = jnp.round((oz + ts * dz[..., None]) * inv_vs).astype(jnp.int32)
            return RC.sample_march_texture(cache, gx, gy, gz, config)
        return sample_chunk

    def round_step(sample_chunk, spacing, t_limit, carry):
        t_cur, last_m, t_hit, t_before, m_b, m_h, done = carry
        m = sample_chunk(t_cur)
        prev = jnp.concatenate([last_m[..., None], m[..., :-1]], axis=-1)
        crossing = (
            (prev > 0) & (m <= 0) & (m != RC.MARCH_UNSEEN)
            & (prev != RC.MARCH_UNSEEN)
        )
        found = jnp.any(crossing, axis=-1) & ~done
        first = jnp.argmax(crossing, axis=-1)
        th = t_cur + spacing * first.astype(jnp.float32)
        # Bracket values via masked reduction: take_along_axis on a
        # minor-dim-S array lowers to a slow per-element gather.
        sel = (
            jax.lax.broadcasted_iota(jnp.int32, m.shape, m.ndim - 1)
            == first[..., None]
        )
        m_hit_new = jnp.sum(jnp.where(sel, m, 0), axis=-1)
        m_bef_new = jnp.sum(jnp.where(sel, prev, 0), axis=-1)
        t_hit = jnp.where(found, th, t_hit)
        t_before = jnp.where(found, th - spacing, t_before)
        m_b = jnp.where(found, m_bef_new, m_b)
        m_h = jnp.where(found, m_hit_new, m_h)
        done = done | found
        t_cur = t_cur + spacing * S
        done = done | (t_cur > t_limit)
        return t_cur, m[..., -1], t_hit, t_before, m_b, m_h, done

    def init_carry(t0, active, shp):
        return (
            t0,
            jnp.full(shp, 127, jnp.int32),
            jnp.zeros(shp),
            jnp.zeros(shp),
            jnp.full(shp, 127, jnp.int32),
            jnp.full(shp, 127, jnp.int32),
            ~active,
        )

    full_sampler = make_sampler(dx_, dy_, dz_, spacing)

    if not compact_div:
        def cond(carry):
            i = carry[0]
            done = carry[-1]
            return (i < n_rounds) & ~jnp.all(done)

        def body(carry):
            i = carry[0]
            new = round_step(full_sampler, spacing, t_limit, carry[1:])
            return (i + 1,) + new

        out = jax.lax.while_loop(
            cond, body, (jnp.asarray(0, jnp.int32),) + init_carry(t0, active, shape)
        )
        _, _, _, t_hit, t_before, m_b, m_h, _ = out
        return t_hit, t_before, m_b, m_h, t_hit > 0.0

    # --- round 1 dense, remaining rounds compacted --------------------------
    carry = round_step(
        full_sampler, spacing, t_limit, init_carry(t0, active, shape)
    )
    n = carry[2].size
    M = max(n // compact_div, 256)

    def full_phase(carry):
        def cond(c):
            i = c[0]
            return (i < n_rounds) & ~jnp.all(c[-1])

        def body(c):
            i = c[0]
            return (i + 1,) + round_step(full_sampler, spacing, t_limit, c[1:])

        out = jax.lax.while_loop(
            cond, body, (jnp.asarray(1, jnp.int32),) + carry
        )
        _, _, _, t_hit, t_before, m_b, m_h, _ = out
        return t_hit, t_before, m_b, m_h

    def compact_phase(carry):
        t_cur, last_m, t_hit, t_before, m_b, m_h, done = carry
        # First-M undone rays via cumsum + scatter (a top_k here lowers
        # to a full sort over n rays).
        undone = ~done.reshape(-1)
        order = jnp.cumsum(undone.astype(jnp.int32)) - 1
        ids = jnp.full((M,), n, jnp.int32)
        ids = ids.at[jnp.where(undone & (order < M), order, M)].set(
            jnp.arange(n, dtype=jnp.int32), mode="drop"
        )
        live = ids < n
        ids = jnp.where(live, ids, 0)

        def g(a):
            return a.reshape(-1)[ids]

        spc = g(spacing)
        tlc = g(t_limit)
        samp_c = make_sampler(g(dx_), g(dy_), g(dz_), spc)
        carry_c = (
            g(t_cur), g(last_m), g(t_hit), g(t_before), g(m_b), g(m_h),
            g(done) | ~live,
        )

        def cond_c(c):
            i = c[0]
            return (i < n_rounds) & ~jnp.all(c[-1])

        def body_c(c):
            i = c[0]
            return (i + 1,) + round_step(samp_c, spc, tlc, c[1:])

        out = jax.lax.while_loop(
            cond_c, body_c, (jnp.asarray(1, jnp.int32),) + carry_c
        )
        _, _, _, th_c, tb_c, mb_c, mh_c, _ = out

        def scatter_back(full, comp):
            tgt = jnp.where(live, ids, n)
            return (
                full.reshape(-1).at[tgt].set(comp, mode="drop").reshape(shape)
            )

        return (
            scatter_back(t_hit, th_c),
            scatter_back(t_before, tb_c),
            scatter_back(m_b, mb_c),
            scatter_back(m_h, mh_c),
        )

    n_undone = jnp.sum(~carry[-1])
    t_hit, t_before, m_b, m_h = jax.lax.cond(
        n_undone <= M, compact_phase, full_phase, carry
    )
    return t_hit, t_before, m_b, m_h, t_hit > 0.0


def _minpool(a, k):
    """k x k min-pool with stride k (pads edges by replication)."""
    h, w = a.shape
    ph, pw = (-h) % k, (-w) % k
    a = jnp.pad(a, ((0, ph), (0, pw)), mode="edge")
    return a.reshape((h + ph) // k, k, (w + pw) // k, k).min(axis=(1, 3))


def _maxpool(a, k):
    h, w = a.shape
    ph, pw = (-h) % k, (-w) % k
    a = jnp.pad(a, ((0, ph), (0, pw)), mode="edge")
    return a.reshape((h + ph) // k, k, (w + pw) // k, k).max(axis=(1, 3))


def _dilate3(a, op):
    """3x3 min/max dilation (edge-replicated)."""
    from .preprocess import _shift2d

    out = a
    fill = jnp.inf if op is jnp.minimum else -jnp.inf
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = op(out, _shift2d(a, dy, dx, fill=fill))
    return out


def raycast(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
    normals: str = "cross",
    with_color: bool = True,
) -> Render:
    """Render model depth/vertex/normal/color maps from the sparse TSDF.

    Hierarchical march under a strict random-access budget (see
    render_cache.py):

      1. coarse march at 1/``raycast_coarse`` resolution over the per-ray
         range interval (first-block band from the range image);
      2. per full-res pixel, a conservative [lo, hi] window from the 3x3
         coarse neighborhood (misses widen to the full interval so thin
         geometry the coarse rays skipped is still found);
      3. fine march inside the window; sub-voxel depth by interpolating
         the QUANTIZED bracket values (no extra volume reads);
      4. ``refine_steps`` optional trilinear secant rounds for polish;
      5. cross-product normals (no reads) + nearest color.
    """
    vs = config.voxel_size
    mu = config.trunc_dist
    rays_cam = camera.rays(height, width)
    rays_world = pose.rotate(rays_cam)
    dx_ = rays_world[..., 0]
    dy_ = rays_world[..., 1]
    dz_ = rays_world[..., 2]
    dir_norm = jnp.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
    inv_dir_norm = 1.0 / jnp.maximum(dir_norm, 1e-9)
    origin = pose.translation
    ox, oy, oz = origin[0], origin[1], origin[2]

    cache = RC.build(volume, config)
    t_min, t_fmax, t_max = compute_range_image(
        volume, camera, pose, height, width, config
    )
    has_range = t_min <= t_max

    S = config.raycast_chunk
    n_rounds = -(-config.raycast_steps // S)
    k = config.raycast_coarse

    # --- coarse march at 1/k resolution ------------------------------------
    cdx, cdy, cdz = dx_[::k, ::k], dy_[::k, ::k], dz_[::k, ::k]
    c_inv = inv_dir_norm[::k, ::k]
    c_tmin = _minpool(t_min, k)
    c_tfmax = _maxpool(jnp.where(has_range, t_fmax, -jnp.inf), k)
    c_tmax = _maxpool(jnp.where(has_range, t_max, -jnp.inf), k)
    c_active = _minpool(t_min, k) <= _maxpool(
        jnp.where(has_range, t_max, -jnp.inf), k
    )
    c_span = jnp.maximum(c_tfmax - c_tmin, 0.0)
    # The coarse pass may sample up to 2x coarser than the fine pass (it
    # only needs to FIND truncation bands, ~4-5 voxels thick; the fine pass
    # resolves them), so typical rays finish in ONE round.
    c_spacing = jnp.clip(
        c_span / S,
        0.75 * vs * c_inv,
        2.0 * config.raycast_step_scale * mu * c_inv,
    )
    ct_hit, _, _, _, c_hit = _march(
        cache, config, ox, oy, oz, cdx, cdy, cdz,
        jnp.where(c_active, c_tmin, config.ray_far),
        c_spacing, c_tmax, c_active, S, n_rounds,
        compact_div=config.raycast_coarse_compact,
    )

    # --- conservative full-res window from the coarse depth ----------------
    w_pad = 2.0 * c_spacing
    c_lo = jnp.where(c_hit, ct_hit - w_pad, c_tmin)
    c_hi = jnp.where(c_hit, ct_hit + w_pad, c_tfmax)  # miss: first band only
    c_lo = _dilate3(c_lo, jnp.minimum)
    c_hi = _dilate3(c_hi, jnp.maximum)
    lo = jnp.repeat(jnp.repeat(c_lo, k, 0), k, 1)[:height, :width]
    hi = jnp.repeat(jnp.repeat(c_hi, k, 0), k, 1)[:height, :width]
    lo = jnp.maximum(lo, t_min)
    hi = jnp.minimum(jnp.maximum(hi, lo), t_max)

    # --- fine march in the window ------------------------------------------
    # The fine march is limited to the window [lo, hi] -- NOT the global
    # t_max: geometry beyond the window was already ruled out by the coarse
    # pass (up to sub-pixel thin structures past the first band, which are
    # dropped; walking every background ray to t_max at full resolution
    # cost 6x the whole raycast).
    Sf = config.raycast_fine_chunk
    span_f = jnp.maximum(hi - lo, 0.0)
    spacing_f = jnp.clip(
        span_f / Sf,
        0.5 * vs * inv_dir_norm,
        config.raycast_step_scale * mu * inv_dir_norm,
    )
    t_hit, t_before, m_b, m_h, hit = _march(
        cache, config, ox, oy, oz, dx_, dy_, dz_,
        jnp.where(has_range, lo, config.ray_far),
        spacing_f, hi, has_range, Sf, n_rounds,
        compact_div=config.raycast_fine_compact,
    )

    # --- sub-voxel depth from the quantized bracket ------------------------
    f_lo = m_b.astype(jnp.float32) / 127.0
    f_hi = m_h.astype(jnp.float32) / 127.0
    denom = f_lo - f_hi
    alpha = jnp.where(jnp.abs(denom) > 1e-12, f_lo / denom, 0.5)
    t_surf = t_before + jnp.clip(alpha, 0.0, 1.0) * (t_hit - t_before)

    # --- optional trilinear secant polish ----------------------------------
    def sample_tri(t):
        px = ox + t * dx_
        py = oy + t * dy_
        pz = oz + t * dz_
        return RC.sample_trilinear_axes(cache, px, py, pz, config)

    t_lo = t_before
    t_hi2 = t_hit
    fl = f_lo
    fh = f_hi
    for _ in range(config.refine_steps):
        f_mid, _ = sample_tri(t_surf)
        pos = f_mid > 0.0
        t_lo = jnp.where(pos, t_surf, t_lo)
        fl = jnp.where(pos, f_mid, fl)
        t_hi2 = jnp.where(pos, t_hi2, t_surf)
        fh = jnp.where(pos, fh, f_mid)
        denom = fl - fh
        alpha = jnp.where(jnp.abs(denom) > 1e-12, fl / denom, 0.5)
        t_surf = t_lo + jnp.clip(alpha, 0.0, 1.0) * (t_hi2 - t_lo)

    px = ox + t_surf * dx_
    py = oy + t_surf * dy_
    pz = oz + t_surf * dz_

    if normals == "gradient":
        nx, ny, nz, n_ok = RC.sample_gradient_axes(cache, px, py, pz, config)
    else:
        nx, ny, nz, n_ok = _cross_normals_axes(px, py, pz, hit)
    # Orient toward the viewer.
    flip = nx * dx_ + ny * dy_ + nz * dz_ > 0.0
    sign = jnp.where(flip, -1.0, 1.0)
    nx, ny, nz = nx * sign, ny * sign, nz * sign

    if with_color:
        color, _ = RC.sample_color_nearest_axes(
            cache, volume, px, py, pz, config
        )
    else:
        # Depth-only tracking doesn't read model color; skip ~5 gathers/px.
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


def render(
    volume: B.VolumeState,
    camera: PinholeCamera,
    pose: SE3,
    height: int,
    width: int,
    config: Config,
    normals: str = "cross",
    with_color: bool = True,
    color_space: str = "rgb",
) -> Render:
    """Render model maps with the configured renderer (march or splat).

    ``color_space="luma"`` is honored by the splat surfel-color path
    (grey intensity render, single-pass packed scatter -- see
    ops/splat.py); the march renderer always renders rgb."""
    if config.render_mode == "splat":
        from . import splat

        return splat.render_splat(
            volume, camera, pose, height, width, config, normals,
            with_color, color_space=color_space,
        )
    return raycast(
        volume, camera, pose, height, width, config, normals, with_color
    )


def _cross_normals_axes(px, py, pz, hit):
    """Image-space forward-difference cross-product normals, planar."""
    from .preprocess import _shift2d

    def sh(a, dy, dx):
        return _shift2d(a, dy, dx)

    e1x = sh(px, 0, 1) - px
    e1y = sh(py, 0, 1) - py
    e1z = sh(pz, 0, 1) - pz
    e2x = sh(px, 1, 0) - px
    e2y = sh(py, 1, 0) - py
    e2z = sh(pz, 1, 0) - pz
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    norm = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    hr = sh(hit.astype(jnp.float32), 0, 1) > 0.5
    hd = sh(hit.astype(jnp.float32), 1, 0) > 0.5
    ok = hit & hr & hd & (norm > 1e-12)
    inv = 1.0 / jnp.maximum(norm, 1e-12)
    return nx * inv, ny * inv, nz * inv, ok
