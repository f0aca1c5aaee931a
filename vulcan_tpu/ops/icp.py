"""Frame-to-model projective ICP tracking.

JAX rebuild of the reference ``Tracker`` hierarchy (SURVEY.md
component #17: ``depth_tracker`` geometric ICP, ``color_tracker``
photometric [M]; coarse-to-fine point-to-plane Gauss-Newton with the 6x6
normal equations built and reduced on device [B] [P:1410.0925]).

Differences from the CUDA reference (SURVEY.md §4.2):
  * per-pixel residual/Jacobian rows are one vectorized XLA pass; the 6x6
    ``J^T W J`` build fuses into 27 planar elementwise+reduce sums
    (``_pp_normal_eqs``) with no (N, 6) Jacobian materialized, instead of
    a hand-written shared-memory tree reduction;
  * the 6x6 solve happens **on device** (Cholesky) inside the same jit, so a
    whole coarse-to-fine track has zero host syncs -- the reference pays a
    device->host readback per GN iteration (SURVEY.md §4.2 "⚠ per-iter
    sync");
  * robust Huber weights instead of hard residual clipping.

Update convention: left-multiplicative, ``T <- exp(xi) @ T`` with twist
``xi = (omega, v)``; for point-to-plane rows the Jacobian is
``J = [v x n, n]``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..config import Config
from ..core.camera import PinholeCamera
from ..core.frame import FrameMaps
from ..core.se3 import SE3
from ..utils.pytree import pytree_dataclass
from .raycast import Render

# f32 products ask for full precision: on the GPU the default may run
# them in TF32 (~3 decimal digits), as core/se3.py notes too.
_HIGHEST = jax.lax.Precision.HIGHEST


@pytree_dataclass
class ModelMaps:
    """Model-side maps for one pyramid level (world space).

    Vertex channels are stored PLANAR ((H, W) each, split once per
    frame): association gathers run per channel, and slicing a channel
    out of an (H, W, 3) array inside every association round is a
    strided copy each time.

    Association is gather-rate-bound, so the maps are bit-packed to
    minimize gathers per associated pixel:
      * vertex -> TWO int32s holding three 21-bit signed fixed-point
        values (p1 = qx<<11 | qy[20:10], p2 = qy[9:0]<<22 | qz<<1) at
        ``_VERTEX_SCALE`` steps/m: 15 um quantization over a +-16 m
        span, far below the surfel renderer's own output noise;
      * normal + validity -> ONE int32 (10 bits/axis + a valid bit,
        ~0.06 degree quantization).
    Three gathers per pixel instead of the seven of the naive planar
    layout.

    Vertices are packed RELATIVE to ``origin`` (the model camera's world
    position): model renders are bounded by ``ray_far`` in camera space,
    so camera-relative coordinates stay well inside the +-16 m
    fixed-point span no matter how far the trajectory wanders from the
    world origin (absolute packing silently saturated beyond +-16 m)."""

    vpack1: jax.Array         # (H, W) int32: qx<<11 | qy[20:10]
    vpack2: jax.Array         # (H, W) int32: qy[9:0]<<22 | qz<<1
    npack: jax.Array          # (H, W) int32: valid<<30 | 3x 10-bit normal
    intensity: jax.Array      # (H, W)
    valid: jax.Array          # (H, W) bool (photometric path; associate
                              # reads the packed bit instead)
    origin: jax.Array         # (3,) world point the packed verts are
                              # relative to (the model camera center)
    camera: PinholeCamera
    world_to_cam: SE3


@pytree_dataclass
class TrackResult:
    pose: SE3                 # live camera-to-world
    error: jax.Array          # () mean robust point-to-plane error (m)
    inliers: jax.Array        # () int32 associated pixels at finest level
    valid: jax.Array          # () bool: every level had enough inliers
    level_error: jax.Array    # (levels,) robust rms per level (fine->coarse,
                              # from each level's LAST GN iteration)
    level_inliers: jax.Array  # (levels,) int32 gated pixels per level
    level_degen: jax.Array    # (levels,) f32 observability score per level:
                              # smallest eigenvalue of the diagonally
                              # normalized 6x6 normal-equation matrix (1 =
                              # perfectly conditioned, ~0 = some 6-DoF
                              # direction unobservable).  See
                              # _min_eig_normalized -- this is the detector
                              # for the dominant-plane slide that error/
                              # inlier health metrics cannot see.
    min_degen: jax.Array      # () f32: the GATE score -- min level_degen
                              # over the levels that carry every
                              # CONFIGURED term.  With photo_levels <
                              # pyramid_levels the finest level is
                              # geometric-only BY CONFIG, and its score
                              # on a plane scene reads ~0 even though the
                              # coarse photometric levels anchor the pose
                              # (Levenberg damping keeps the finer levels
                              # from drifting along their null space) --
                              # so config-skipped levels inform
                              # diagnostics but do not gate.
    geo_degen: jax.Array      # () f32: min over levels of the GEOMETRIC-
                              # only observability score (photometric
                              # rows excluded).  In depth mode equals
                              # min_degen; in combined/light it measures
                              # what the geometry ALONE constrains --
                              # the signal the auto-photo escalation
                              # (fusion.Config.auto_photo) de-escalates
                              # on, since the with-photo score is rescued
                              # by exactly the rows escalation added.
                              # 1.0 when no geometric term (mode="color")
                              # or the detector is compiled out.


_VERTEX_SCALE = 65536.0  # 21-bit fixed-point steps/m: +-16 m at 15 um
                         # (16-bit / 0.24 mm was tried and REVERTED: the
                         # deterministic quantization staircase biases the
                         # normal equations enough to diverge the
                         # 12 deg/frame large-motion canary)


def _snap_origin(t: jax.Array) -> jax.Array:
    """Snap a world point onto the vertex quantization grid.

    Packing relative to a SNAPPED origin keeps the fixed-point grid
    aligned with the absolute 1/_VERTEX_SCALE lattice (the shift is an
    integer number of steps), so re-centering changes which window of
    the lattice is addressable without moving the lattice itself --
    quantized vertices are bit-identical to absolute packing whenever
    both are in range."""
    s = _VERTEX_SCALE
    return jnp.round(t * s) * (1.0 / s)


def _pack_vertices(vx, vy, vz, origin=None):
    """Planar world-vertex channels -> two int32 images holding three
    21-bit signed fixed-point values: p1 = qx<<11 | qy[20:10],
    p2 = qy[9:0]<<22 | qz<<1.  ``origin`` (3,) re-centers the span:
    coordinates are quantized relative to it (see ModelMaps; callers
    snap it with ``_snap_origin``)."""

    def q(v, o):
        if origin is not None:
            v = v - o
        return jnp.clip(
            jnp.round(v * _VERTEX_SCALE), -(1 << 20), (1 << 20) - 1
        ).astype(jnp.int32)

    o = (None, None, None) if origin is None else origin
    qx, qy, qz = q(vx, o[0]), q(vy, o[1]), q(vz, o[2])
    p1 = (qx << 11) | ((qy >> 10) & 0x7FF)
    p2 = ((qy & 0x3FF) << 22) | ((qz & 0x1FFFFF) << 1)
    return p1, p2


def _unpack_vertices(p1, p2, origin=None):
    s = 1.0 / _VERTEX_SCALE
    qx = p1 >> 11                                   # arithmetic: top 21 bits
    qy = ((p1 & 0x7FF) << 10) | ((p2 >> 22) & 0x3FF)
    qy = (qy << 11) >> 11                           # sign-extend 21 bits
    qz = ((p2 >> 1) & 0x1FFFFF)
    qz = (qz << 11) >> 11
    ox, oy, oz = (0.0, 0.0, 0.0) if origin is None else (
        origin[0], origin[1], origin[2]
    )
    return (
        qx.astype(jnp.float32) * s + ox,
        qy.astype(jnp.float32) * s + oy,
        qz.astype(jnp.float32) * s + oz,
    )


def _pack_normals(nx, ny, nz, valid) -> jax.Array:
    """Planar unit-normal channels + valid -> one int32 per pixel
    (10 bits per axis + a valid bit; quantization ~0.06 degrees)."""

    def q(n):
        return jnp.clip(jnp.round((n + 1.0) * 511.5), 0, 1023).astype(
            jnp.int32
        )

    return (
        (valid.astype(jnp.int32) << 30)
        | (q(nx) << 20)
        | (q(ny) << 10)
        | q(nz)
    )


def _unpack_normals(p: jax.Array):
    def d(v):
        return v.astype(jnp.float32) * (1.0 / 511.5) - 1.0

    return (
        d((p >> 20) & 0x3FF),
        d((p >> 10) & 0x3FF),
        d(p & 0x3FF),
        (p >> 30) > 0,
    )


def _depth_flat_mask(
    depth: jax.Array, valid: jax.Array, reach: int = 2, thresh: float = 0.05
) -> jax.Array:
    """True where no pixel within ``reach`` sits on a depth DISCONTINUITY
    (a one-step neighbor jump above ``thresh`` meters) or is invalid.

    The criterion is the per-step jump, NOT the window's total depth
    range: a smooth slanted surface (a floor at grazing angle) has a
    large range but small per-step jumps and must KEEP its photometric
    samples -- dominant planes are exactly where the photometric term
    rescues the point-to-plane degeneracy (the desk-scene analysis).
    A fore/background silhouette is a single large jump.  ``thresh``
    defaults near the TSDF truncation band: two samples of one
    continuous fused surface cannot be further apart than the band.
    Bad seeds (jump or invalid) are dilated by separable max passes."""
    from .preprocess import _shift2d

    jump = jnp.zeros_like(depth, dtype=bool)
    for dy, dx in ((0, 1), (1, 0)):
        nb = _shift2d(depth, dy, dx, fill=0.0)
        nb_ok = _shift2d(valid, dy, dx, fill=False)
        j = nb_ok & (jnp.abs(depth - nb) > thresh)
        # Mark both sides of the step (the shifted copy covers the
        # neighbor's side).
        jump = jump | j | _shift2d(j, -dy, -dx, fill=False)
    bad = ~valid | jump
    for axis in (0, 1):
        grown = bad
        for s in range(1, reach + 1):
            sh = (s, 0) if axis == 0 else (0, s)
            grown = (
                grown
                | _shift2d(bad, sh[0], sh[1], fill=True)
                | _shift2d(bad, -sh[0], -sh[1], fill=True)
            )
        bad = grown
    return valid & ~bad


def model_pyramid(
    render: Render,
    levels: int,
    with_intensity: bool = True,
    flat_thresh: float = 0.05,
) -> tuple[ModelMaps, ...]:
    """Build model map pyramid from a raycast by nearest subsampling.

    The model Render already stores its vertex/normal channels planar
    ((H, W) each), so no (H, W, 3) channel splits happen anywhere on the
    hot path; normals+validity pack to one int32 image here, and every
    coarser level subsamples the planar views.  ``with_intensity=False``
    (geometric-only tracking) skips the intensity image entirely."""
    from .preprocess import intensity_from_color

    origin = _snap_origin(render.pose.translation)
    vp1, vp2 = _pack_vertices(render.vx, render.vy, render.vz, origin)
    npack = _pack_normals(render.nx, render.ny, render.nz, render.valid)
    c = intensity_from_color(render.color) if with_intensity else None
    ok = render.valid
    if with_intensity:
        # Photometric validity = geometric validity MINUS depth
        # discontinuities: the splat renderer's color near silhouettes is
        # untrustworthy (hole-fill diffusion + mixed fore/background
        # winner voxels), and those one-sided errors dominate the
        # coarse-level photometric normal equations -- measured on the
        # 3-sphere closed loop, combined-mode per-frame bias at truth is
        # 0.0092 with the raw mask vs 0.0032 with silhouette pixels cut
        # (depth-only: 0.0020).  ``ok`` gates ONLY the photometric
        # samples (geometric association reads the packed npack bit),
        # so eroding it costs no geometric inliers.
        ok = ok & _depth_flat_mask(
            render.depth, render.valid, thresh=flat_thresh
        )
    cam = render.camera
    w2c = render.pose.inverse()
    maps = []
    for level in range(levels):
        if level > 0:
            vp1, vp2 = vp1[::2, ::2], vp2[::2, ::2]
            npack, ok = npack[::2, ::2], ok[::2, ::2]
            c = c[::2, ::2] if c is not None else None
            cam = cam.subsampled(2)
        maps.append(ModelMaps(vp1, vp2, npack, c, ok, origin, cam, w2c))
    return tuple(maps)


def model_from_frame_maps(maps: FrameMaps, pose: SE3) -> ModelMaps:
    """Lift camera-space FrameMaps to world-space ModelMaps (used to
    bootstrap tracking before the first raycast, and in tests)."""
    ok = maps.depth > 0.0
    origin = _snap_origin(pose.translation)
    v = jnp.where(ok[..., None], pose.apply(maps.vertices), origin)
    n = jnp.where(ok[..., None], pose.rotate(maps.normals), 0.0)
    vp1, vp2 = _pack_vertices(v[..., 0], v[..., 1], v[..., 2], origin)
    return ModelMaps(
        vp1, vp2,
        _pack_normals(n[..., 0], n[..., 1], n[..., 2], ok),
        intensity=maps.intensity,
        valid=ok,
        origin=origin,
        camera=maps.camera,
        world_to_cam=pose.inverse(),
    )


def _sample_nearest_masked(img, valid, uv):
    h, w = img.shape[0], img.shape[1]
    u = jnp.round(uv[..., 0]).astype(jnp.int32)
    vv = jnp.round(uv[..., 1]).astype(jnp.int32)
    inb = (u >= 0) & (u < w) & (vv >= 0) & (vv < h)
    uc = jnp.clip(u, 0, w - 1)
    vc = jnp.clip(vv, 0, h - 1)
    return img[vc, uc], inb & valid[vc, uc]


def _sample_bilinear(img, uv):
    """Bilinear sample of (H, W) image; returns (value, in_bounds)."""
    h, w = img.shape
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    fu = u - u0
    fv = v - v0
    u0 = u0.astype(jnp.int32)
    v0 = v0.astype(jnp.int32)
    inb = (u0 >= 0) & (u0 + 1 < w) & (v0 >= 0) & (v0 + 1 < h)
    u0c = jnp.clip(u0, 0, w - 2)
    v0c = jnp.clip(v0, 0, h - 2)
    i00 = img[v0c, u0c]
    i01 = img[v0c, u0c + 1]
    i10 = img[v0c + 1, u0c]
    i11 = img[v0c + 1, u0c + 1]
    val = (
        i00 * (1 - fu) * (1 - fv)
        + i01 * fu * (1 - fv)
        + i10 * (1 - fu) * fv
        + i11 * fu * fv
    )
    return val, inb


def _huber_weight(r, delta):
    a = jnp.abs(r)
    return jnp.where(a <= delta, 1.0, delta / jnp.maximum(a, 1e-12))


def associate_depth(
    live: FrameMaps, model: ModelMaps, pose: SE3, config: Config
):
    """Projective association: the GATHER half of point-to-plane ICP.

    For each live pixel, warp into the model frame at ``pose`` and sample
    the model vertex/normal maps (nearest).  Returns (v_m, n_m, ok) --
    fixed correspondences for the dense GN re-linearizations that follow
    (warp-once: the random-access sampling here dominates ICP cost, so
    it runs ``icp_assoc[level]`` times per level, not once per GN
    iteration like the reference's per-pixel kernel).

    Sampling is per-CHANNEL from the planar (H, W) model arrays, which
    avoids gathers with a minor dimension of 3.
    """
    v_w = pose.apply(live.vertices)
    p_m = model.world_to_cam.apply(v_w)
    uv = model.camera.project(p_m)

    h, w = model.valid.shape
    u = jnp.round(uv[..., 0]).astype(jnp.int32)
    vv = jnp.round(uv[..., 1]).astype(jnp.int32)
    inb = (u >= 0) & (u < w) & (vv >= 0) & (vv < h)
    uc = jnp.clip(u, 0, w - 1)
    vc = jnp.clip(vv, 0, h - 1)
    mvx, mvy, mvz = _unpack_vertices(
        model.vpack1[vc, uc], model.vpack2[vc, uc], model.origin
    )
    v_m = jnp.stack([mvx, mvy, mvz], axis=-1)
    nx, ny, nz, okn = _unpack_normals(model.npack[vc, uc])
    n_m = jnp.stack([nx, ny, nz], axis=-1)
    ok_v = inb & okn
    # Sensor-range gate: correspondences beyond depth_max (possible in
    # synthetic scenes; a real sensor cannot produce them) are dropped on
    # the live side.  (The packed model vertices are camera-relative, so
    # they stay in fixed-point range by construction -- see ModelMaps.)
    ok = (
        (live.depth > config.depth_min)
        & (live.depth < config.depth_max)
        & ok_v
        & (p_m[..., 2] > 0.0)
    )
    return v_m, n_m, ok


# ---------------------------------------------------------------------------
# Patch-based association (one-hot matmul gather; Config.assoc_patch)
# ---------------------------------------------------------------------------
#
# Association is gather-rate-bound.  But the warp is locally smooth --
# a tile of live pixels lands in a compact model-image window -- so the
# same one-hot-matmul gather as integration's applies: extract one
# model patch per live tile (plain row gathers from 32-wide-tiled maps)
# and gather all six value columns (hi/lo halves of vpack1/vpack2/npack)
# with ONE batched matmul per round.  Pixels whose warp leaves the
# patch window (large parallax jumps, erratic motion) simply drop out of
# that round's associations -- the coarsest level keeps flat gathers and
# absorbs global motion first, and the constant-velocity prediction
# keeps fine-level windows tight.

_AT_H = 8         # live tile height
_AT_W = 32        # live tile width
_AP_ROWS = 32     # patch rows
_AP_TILES = 3     # patch column tiles (32 px each)
_AP_P = _AP_ROWS * _AP_TILES * 32  # 3072


def _pad_to(x, h, w, fill):
    ph, pw = h - x.shape[0], w - x.shape[1]
    if ph == 0 and pw == 0:
        return x
    return jnp.pad(x, ((0, ph), (0, pw)), constant_values=fill)


def _to_tiles(x, Ht, Wt):
    """(Hp, Wp) -> (T, 256) in (tile, within-tile row-major) order."""
    return (
        x.reshape(Ht, _AT_H, Wt, _AT_W)
        .transpose(0, 2, 1, 3)
        .reshape(Ht * Wt, _AT_H * _AT_W)
    )


def _from_tiles(x, Ht, Wt, Hs, Ws):
    """(T, 256, ...) -> (Hs, Ws, ...) undoing _to_tiles (+ crop)."""
    tail = x.shape[2:]
    out = (
        x.reshape(Ht, Wt, _AT_H, _AT_W, *tail)
        .transpose(0, 2, 1, 3, *(4 + i for i in range(len(tail))))
        .reshape(Ht * _AT_H, Wt * _AT_W, *tail)
    )
    return out[:Hs, :Ws]


class _PatchAssoc:
    """Per-level association state: tiled model maps + frozen windows.

    Windows are computed from the FIRST round's warp and reused by later
    rounds (the pose moves sub-pixel between rounds; the +-12 px / +-32
    px window slack absorbs it, and drifted-out pixels just drop).

    ``photo=True`` (combined mode): the photometric samples ride the
    SAME one-hot matmul as the geometric maps.  The 3x3 neighborhoods
    of the model intensity AND its two gradient images (16-bit,
    1/65535 steps over [0,1] / [-0.5,0.5], two values per int32) pack
    to 14 extra maps, so the dot gains 56 byte-columns, versus the ~14
    flat gathers/px/round of the bilinear ``color_assoc`` path.  The
    bilinear 2x2 footprint around the
    warp point is ALWAYS inside the 3x3 around the rounded gather
    pixel, so blending each gathered 3x3 with f32 hat weights
    reconstructs the flat path's bilinear samples EXACTLY (up to the
    16-bit quantization).  Tried and REVERTED cheaper variants, both
    measurably degrading tracking on the desk orbit (the photometric
    term is the only brake on the dominant-plane slide, so small
    per-frame sample bias compounds): nearest-only samples (desk ATE
    0.047 -> 0.16 m; per-frame pair error 1.28 -> 1.79 mm,
    tools/exp_photo_patch.py) and bilinear intensity with
    nearest/axis-interpolated gradients (ATE 0.047 -> 0.15 m)."""

    def __init__(self, model: ModelMaps, photo: bool = False):
        self.model = model
        Hm, Wm = model.valid.shape
        self.Hm, self.Wm = Hm, Wm
        self.Wt = max(-(-Wm // 32), _AP_TILES)
        self.Hp = max(Hm, _AP_ROWS)
        maps = [model.vpack1, model.vpack2, model.npack]
        if photo:
            from .preprocess import _shift2d

            gx, gy = intensity_grads(model.intensity)
            halves = []
            for img, lo in ((model.intensity, 0.0), (gx, -0.5), (gy, -0.5)):
                q = jnp.clip(
                    jnp.round((img - lo) * 65535.0), 0, 65535
                ).astype(jnp.int32)
                # 3x3 neighborhood in row-major (dy, dx) order.
                halves += [
                    _shift2d(q, dy, dx, fill=0)
                    for dy in (-1, 0, 1)
                    for dx in (-1, 0, 1)
                ]
            halves.append(jnp.zeros_like(halves[0]))
            maps += [
                (halves[2 * k] << 16) | halves[2 * k + 1]
                for k in range(len(halves) // 2)
            ]
        self.n_maps = len(maps)
        pads = [_pad_to(m, self.Hp, self.Wt * 32, 0) for m in maps]
        # One stacked tile buffer: row r of map k lives at k*Hp*Wt + r.
        self.tiles = jnp.concatenate(
            [p.reshape(self.Hp * self.Wt, 32) for p in pads], axis=0
        )
        self.windows = None       # (T,) v0, k0 after freeze()

    def freeze_windows(self, uv, ok, Ht, Wt_live):
        """Tile windows from this round's warp; returns patches rhs."""
        big = jnp.float32(1e9)
        u = jnp.clip(uv[..., 0], -1e6, 1e6)
        v = jnp.clip(uv[..., 1], -1e6, 1e6)
        ut = _to_tiles(jnp.where(ok, u, big), Ht, Wt_live)
        vt = _to_tiles(jnp.where(ok, v, big), Ht, Wt_live)
        u_min = jnp.min(ut, axis=1)
        v_min = jnp.min(vt, axis=1)
        # Center the slack: the window covers [v0, v0+32) rows while the
        # tile itself spans 8; start a few rows above the min.
        v0 = jnp.clip(
            jnp.floor(v_min).astype(jnp.int32) - 8, 0,
            self.Hp - _AP_ROWS,
        )
        k0 = jnp.clip(
            (jnp.floor(u_min).astype(jnp.int32) - 16) // 32, 0,
            self.Wt - _AP_TILES,
        )
        self.windows = (v0, k0)

        dy = jnp.arange(_AP_ROWS, dtype=jnp.int32)
        dx = jnp.arange(_AP_TILES, dtype=jnp.int32)
        rid = (
            (v0[:, None, None] + dy[None, :, None]) * self.Wt
            + k0[:, None, None] + dx[None, None, :]
        )                                           # (T, 32, 3)
        T = rid.shape[0]
        off = self.Hp * self.Wt
        M = self.n_maps
        rids = jnp.stack(
            [rid + k * off for k in range(M)], axis=0
        ).reshape(-1)                               # M maps x T*96 rows
        rows = self.tiles[rids].reshape(M, T, _AP_P)
        # 8-BIT value planes (4 bytes per map): byte-sliced payloads are
        # exact in a bf16 matmul (bf16 holds every byte), unlike 16-bit
        # halves -- see _patch_gather_depth_color.  Kept P-MINOR
        # (T, 4*M, P): the NT-form dot in ``gather`` contracts the rhs's
        # minor dim directly, so no map-minor relayout is needed.
        # Column order is byte-major: c = b*M + m.
        planes = jnp.stack(
            [
                (rows >> 24) & 0xFF,
                (rows >> 16) & 0xFF,
                (rows >> 8) & 0xFF,
                rows & 0xFF,
            ],
            axis=0,
        )                                              # (4, M, T, P)
        self.rhs = (
            planes.transpose(2, 0, 1, 3)
            .reshape(T, 4 * M, _AP_P)
            .astype(jnp.bfloat16)
        )                                              # (T, 4M, P)
        return self

    def gather(self, uv, ok, Ht, Wt_live, Hs, Ws):
        """One-hot gather of (v_m, n_m, ok_m) at this round's warp."""
        v0, k0 = self.windows
        u = jnp.clip(uv[..., 0], -1e6, 1e6)
        v = jnp.clip(uv[..., 1], -1e6, 1e6)
        u_m = jnp.round(u).astype(jnp.int32)
        v_m = jnp.round(v).astype(jnp.int32)
        inb = (
            (u_m >= 0) & (u_m < self.Wm) & (v_m >= 0) & (v_m < self.Hm)
        )
        ut = _to_tiles(u_m, Ht, Wt_live)
        vt = _to_tiles(v_m, Ht, Wt_live)
        okt = _to_tiles(ok & inb, Ht, Wt_live)
        pu = ut - k0[:, None] * 32
        pv = vt - v0[:, None]
        inpatch = (
            (pu >= 0) & (pu < _AP_TILES * 32)
            & (pv >= 0) & (pv < _AP_ROWS) & okt
        )
        pidx = jnp.where(inpatch, pv * (_AP_TILES * 32) + pu, -1)
        iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, _AP_P), 2)
        onehot = (pidx[:, :, None] == iota).astype(jnp.bfloat16)
        # bf16 dot, exact BECAUSE the value columns are byte-sliced (see
        # freeze_windows): 0/1 x byte products, one hit per row, f32
        # accumulation.
        vals = jax.lax.dot_general(
            onehot, self.rhs,
            dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32)                         # (T, 256, 4*M)
        M = self.n_maps
        b0, b1 = vals[..., 0:M], vals[..., M:2 * M]
        b2, b3 = vals[..., 2 * M:3 * M], vals[..., 3 * M:4 * M]
        packed = (b0 << 24) | (b1 << 16) | (b2 << 8) | b3  # (T, 256, M)
        out = _from_tiles(packed, Ht, Wt_live, Hs, Ws)
        p1, p2, npack = out[..., 0], out[..., 1], out[..., 2]
        mvx, mvy, mvz = _unpack_vertices(p1, p2, self.model.origin)
        nx, ny, nz, okn = _unpack_normals(npack)
        ok_full = _from_tiles(
            inpatch[..., None], Ht, Wt_live, Hs, Ws
        )[..., 0]
        v_mv = jnp.stack([mvx, mvy, mvz], axis=-1)
        n_mv = jnp.stack([nx, ny, nz], axis=-1)
        if M == 3:
            return v_mv, n_mv, ok_full & okn, None
        # Photometric: decode the gathered 3x3 neighborhoods of
        # (intensity, gx, gy) (row-major (dy, dx), two 16-bit values per
        # word) and blend each with f32 hat weights around the rounded
        # gather pixel -- the bilinear 2x2 footprint is always inside
        # the 3x3, so this reproduces the flat path's bilinear samples
        # at the warp point exactly (up to the 16-bit quantization).
        s = 1.0 / 65535.0
        halves = []
        for k in range(27):
            word = out[..., 3 + k // 2]
            half = (word >> 16) if k % 2 == 0 else word
            halves.append((half & 0xFFFF).astype(jnp.float32) * s)
        u = uv[..., 0][: out.shape[0], : out.shape[1]]
        v = uv[..., 1][: out.shape[0], : out.shape[1]]
        du = u - jnp.round(u)
        dv = v - jnp.round(v)
        wu = [
            jnp.maximum(0.0, 1.0 - jnp.abs(du - k)) for k in (-1.0, 0.0, 1.0)
        ]
        wv = [
            jnp.maximum(0.0, 1.0 - jnp.abs(dv - k)) for k in (-1.0, 0.0, 1.0)
        ]

        def blend(n9, lo):
            acc = jnp.zeros_like(u)
            for ky in range(3):
                for kx in range(3):
                    acc = acc + wv[ky] * wu[kx] * n9[3 * ky + kx]
            return acc + lo

        i_m0 = blend(halves[0:9], 0.0)
        gu = blend(halves[9:18], -0.5)
        gv = blend(halves[18:27], -0.5)
        return v_mv, n_mv, ok_full & okn, (i_m0, gu, gv)


def patch_assoc_enabled(config: Config) -> bool:
    """``Config.assoc_patch`` with ``"auto"`` resolved to one fixed choice
    on every backend: off (flat gathers), which the GPU measurement in
    PERF.md prefers to the one-hot patch association."""
    return config.assoc_patch in ("on", "geom")


def _warp_uv(live: FrameMaps, model: ModelMaps, pose: SE3, config: Config):
    """Shared warp half of association; returns (uv, base_ok)."""
    v_w = pose.apply(live.vertices)
    p_m = model.world_to_cam.apply(v_w)
    uv = model.camera.project(p_m)
    ok = (
        (live.depth > config.depth_min)
        & (live.depth < config.depth_max)
        & (p_m[..., 2] > 0.0)
    )
    return uv, ok


def associate_depth_patched(
    live: FrameMaps, model: ModelMaps, pose: SE3, config: Config,
    assoc: _PatchAssoc,
):
    """Patch/one-hot projective association (see _PatchAssoc).

    When ``assoc`` carries photometric maps (combined mode), the fourth
    return value is the fixed-sample tuple for ``color_rows_fixed``
    (i_m0, gu, gv, u0, v0, ok) gathered by the SAME one-hot matmul --
    i_m0 is the exact bilinear sample at the warp point (u0, v0) = (u, v)
    reconstructed from the gathered 3x3 neighborhood (see _PatchAssoc)."""
    uv, ok = _warp_uv(live, model, pose, config)
    Hs, Ws = uv.shape[:2]
    Ht = -(-Hs // _AT_H)
    Wt_live = -(-Ws // _AT_W)
    uvp = jnp.pad(
        uv, ((0, Ht * _AT_H - Hs), (0, Wt_live * _AT_W - Ws), (0, 0))
    )
    okp = _pad_to(ok, Ht * _AT_H, Wt_live * _AT_W, False)
    if assoc.windows is None:
        assoc.freeze_windows(uvp, okp, Ht, Wt_live)
    v_m, n_m, ok_m, photo = assoc.gather(uvp, okp, Ht, Wt_live, Hs, Ws)
    if photo is None:
        return v_m, n_m, ok_m & ok
    i_m0, gu, gv = photo
    u0, v0 = uv[..., 0], uv[..., 1]
    # Match the flat bilinear path's footprint gate: all four
    # interpolation neighbors in bounds (the 3x3 shifted maps are
    # zero-filled at the image border).
    inb = (
        (u0 >= 0.0) & (u0 < assoc.Wm - 1.0)
        & (v0 >= 0.0) & (v0 < assoc.Hm - 1.0)
    )
    samples = (i_m0, gu, gv, u0, v0, ok_m & ok & inb)
    return v_m, n_m, ok_m & ok, samples


def _pp_normal_eqs(live: FrameMaps, v_m, n_m, assoc_ok, pose: SE3,
                   config: Config, live_normals: bool = False):
    """Point-to-plane 6x6 normal equations as 27 FUSED planar reductions.

    Equivalent to depth_rows_fixed + normal_equations, but never
    materializes the (N, 6) Jacobian: building J as an array forces a
    minor-dim-6 relayout EVERY GN iteration (xplane trace), while 21
    upper-triangle sums of w*j_a*j_b + 6 of w*j_a*r + error/count fuse
    into one elementwise+reduce pass with no intermediate at all.
    Returns (H (6,6), b (6,), err, cnt).

    ``live_normals=True`` builds J (and the residual projection) from the
    LIVE frame's normals instead of the model's, over the SAME gated
    correspondence set.  Used only by the degeneracy detector: the splat-
    rendered model of a plane carries voxel-staircase normals whose
    lattice-locked rows make the 6x6 look well-conditioned while the pose
    is in fact free to slide by lattice periods (measured: closed-loop
    floor scene slid 0.8 m at a "healthy" normalized min-eig of 0.1).
    The live frame's filtered sensor normals measure what the SCENE can
    observe, independent of model reconstruction artifacts."""
    v_w = pose.apply(live.vertices)
    n_w = pose.rotate(live.normals)
    dx = v_w[..., 0] - v_m[..., 0]
    dy = v_w[..., 1] - v_m[..., 1]
    dz = v_w[..., 2] - v_m[..., 2]
    nx, ny, nz = n_m[..., 0], n_m[..., 1], n_m[..., 2]
    dist2 = dx * dx + dy * dy + dz * dz
    n_dot = (
        n_w[..., 0] * nx + n_w[..., 1] * ny + n_w[..., 2] * nz
    )
    gate = (
        assoc_ok
        & (dist2 < config.icp_dist_thresh**2)
        & (n_dot > config.icp_normal_thresh)
    )
    if live_normals:
        nx, ny, nz = n_w[..., 0], n_w[..., 1], n_w[..., 2]
    r = nx * dx + ny * dy + nz * dz
    w = jnp.where(gate, _huber_weight(r, config.icp_huber_delta), 0.0)

    vx, vy, vz = v_w[..., 0], v_w[..., 1], v_w[..., 2]
    j = (
        vy * nz - vz * ny,          # [v x n]
        vz * nx - vx * nz,
        vx * ny - vy * nx,
        nx, ny, nz,                 # [n]
    )
    return _fused_normal_eqs(j, r, w)


def _fused_normal_eqs(j, r, w):
    """(H, b, err, cnt) from planar Jacobian components, one reduction.

    All 29 scalars come from ONE stacked reduction, then the 6x6 is
    assembled by a static gather from the vector: building H with 27
    .at[].set calls lowers to (6,6) scatter ops in every GN iteration,
    and a materialized (N, 6) Jacobian forces a minor-dim-6 relayout.
    """
    parts = []
    for a in range(6):
        wj = w * j[a]
        for c in range(a, 6):
            parts.append(wj * j[c])
        parts.append(wj * r)
    parts.append(w * r * r)
    parts.append((w > 0.0).astype(jnp.float32))
    sums = jnp.sum(jnp.stack(parts).reshape(len(parts), -1), axis=1)
    pos = {}
    k = 0
    for a in range(6):
        for c in range(a, 6):
            pos[(a, c)] = k
            k += 1
        k += 1  # the b entry interleaved after row a's triangle
    hmap = [[pos[(min(a, c), max(a, c))] for c in range(6)] for a in range(6)]
    bmap = [pos[(a, 5)] + 1 for a in range(6)]
    H = sums[jnp.asarray(hmap)]
    b = sums[jnp.asarray(bmap)]
    err = sums[-2]
    cnt = sums[-1]
    return H, b, err, cnt


def intensity_grads(intensity: jax.Array):
    """Central-difference gradient images of the model intensity.

    Computed ONCE per level (pose-independent) so photometric rounds
    sample 3 bilinear values (I, gx, gy = 12 gathers/px) instead of the
    5 bilinear taps (20 gathers/px) the per-iteration path paid."""
    from .preprocess import _shift2d

    gx = 0.5 * (_shift2d(intensity, 0, 1) - _shift2d(intensity, 0, -1))
    gy = 0.5 * (_shift2d(intensity, 1, 0) - _shift2d(intensity, -1, 0))
    return gx, gy


def color_assoc(
    live: FrameMaps, model: ModelMaps, grads, pose: SE3, config: Config
):
    """The GATHER half of photometric tracking: sample model intensity
    and its gradient at the current warp, ONCE per association round.

    Returns fixed samples (i_m0, gu, gv, u0, v0, ok) for the dense
    first-order re-linearizations of ``color_rows_fixed`` -- the same
    warp-once trade the geometric path makes (association gathers
    dominate ICP cost; the reference re-samples every iteration).

    (I, gx, gy, valid) ride TWO packed int32 words (16-bit fixed point,
    the same 1/65535 grid the fused patch path quantizes to), so each
    bilinear sample costs 8 random gathers instead of the 13 of three
    separate f32 images + a nearest validity probe -- this path runs
    every photometric round unless ``assoc_patch`` enables the patch
    path (then only the coarsest level's first ``coarse_patch_after``
    global-motion rounds, or every round of the ``"geom"`` control).
    The dense pack
    is pose-independent; XLA CSEs it across association rounds."""
    gx_img, gy_img = grads
    s = 65535.0
    iq = jnp.clip(jnp.round(model.intensity * s), 0, 65535).astype(
        jnp.int32
    )
    gxq = jnp.clip(jnp.round((gx_img + 0.5) * s), 0, 65535).astype(
        jnp.int32
    )
    gyq = jnp.clip(jnp.round((gy_img + 0.5) * s), 0, 65535).astype(
        jnp.int32
    )
    wa = (iq << 16) | gxq            # may wrap negative; decoded via & mask
    wb = (gyq << 16) | model.valid.astype(jnp.int32)

    v_w = pose.apply(live.vertices)
    p_m = model.world_to_cam.apply(v_w)
    uv = model.camera.project(p_m)
    h, w = model.intensity.shape
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    fu = u - u0
    fv = v - v0
    u0 = u0.astype(jnp.int32)
    v0 = v0.astype(jnp.int32)
    inb = (u0 >= 0) & (u0 + 1 < w) & (v0 >= 0) & (v0 + 1 < h)
    uc = jnp.clip(u0, 0, w - 2)
    vc = jnp.clip(v0, 0, h - 2)
    a00, a01 = wa[vc, uc], wa[vc, uc + 1]
    a10, a11 = wa[vc + 1, uc], wa[vc + 1, uc + 1]
    b00, b01 = wb[vc, uc], wb[vc, uc + 1]
    b10, b11 = wb[vc + 1, uc], wb[vc + 1, uc + 1]

    w00 = (1.0 - fu) * (1.0 - fv)
    w01 = fu * (1.0 - fv)
    w10 = (1.0 - fu) * fv
    w11 = fu * fv
    inv = 1.0 / s

    def blend(x00, x01, x10, x11, shift, lo):
        def d(x):
            return ((x >> shift) & 0xFFFF).astype(jnp.float32) * inv + lo

        return w00 * d(x00) + w01 * d(x01) + w10 * d(x10) + w11 * d(x11)

    i_m0 = blend(a00, a01, a10, a11, 16, 0.0)
    gu = blend(a00, a01, a10, a11, 0, -0.5)
    gv = blend(b00, b01, b10, b11, 16, -0.5)
    # Nearest-pixel validity (same semantics as _sample_nearest_masked:
    # the tap nearest the warp point), read from wb's valid bit.
    vb = jnp.where(
        fv >= 0.5,
        jnp.where(fu >= 0.5, b11, b10),
        jnp.where(fu >= 0.5, b01, b00),
    )
    ok = inb & ((vb & 1) > 0) & (p_m[..., 2] > 0.0)
    return i_m0, gu, gv, u, v, ok


def color_rows_fixed(
    live: FrameMaps, samples, model: ModelMaps, pose: SE3, config: Config
):
    """Photometric planar rows from FIXED intensity/gradient samples.

    First-order image model around the sampled warp point:
    ``I_model(u) ~ i_m0 + gu (u - u0) + gv (v - v0)``; the projection
    and its Jacobian re-evaluate densely at the CURRENT pose.  Pixels
    whose warp drifts further than a few pixels from the sample point
    leave the linearization's validity and are gated out (they re-enter
    at the next association round).  Returns (j 6-tuple, r, w) planar,
    pre-scaled by ``rgb_weight``.
    """
    i_m0, gu, gv, u0, v0, ok0 = samples
    live_ok = (
        (live.depth > config.depth_min) & (live.depth < config.depth_max)
    )
    v_w = pose.apply(live.vertices)
    p_m = model.world_to_cam.apply(v_w)
    uv = model.camera.project(p_m)
    u, v = uv[..., 0], uv[..., 1]

    r = i_m0 + gu * (u - u0) + gv * (v - v0) - live.intensity

    x, y, z = p_m[..., 0], p_m[..., 1], p_m[..., 2]
    zc = jnp.maximum(z, 1e-6)
    fx, fy = model.camera.fx, model.camera.fy
    # g_p = dI/dp_m = gu * du/dp + gv * dv/dp (pinhole Jacobian), then
    # rotated back to world by R_m^T (chain rule through world_to_cam).
    gpx = gu * fx / zc
    gpy = gv * fy / zc
    gpz = -(gu * fx * x + gv * fy * y) / (zc * zc)
    Rm = model.world_to_cam.rotation           # world->cam; inverse = R^T
    gwx = Rm[0, 0] * gpx + Rm[1, 0] * gpy + Rm[2, 0] * gpz
    gwy = Rm[0, 1] * gpx + Rm[1, 1] * gpy + Rm[2, 1] * gpz
    gwz = Rm[0, 2] * gpx + Rm[1, 2] * gpy + Rm[2, 2] * gpz

    drift2 = (u - u0) ** 2 + (v - v0) ** 2
    gate = live_ok & ok0 & (z > 0.0) & (drift2 < 16.0)
    w = jnp.where(gate, _huber_weight(r, config.rgb_huber_delta), 0.0)

    s = config.rgb_weight
    vx, vy, vz = v_w[..., 0], v_w[..., 1], v_w[..., 2]
    j = (
        s * (vy * gwz - vz * gwy),           # [v x g]
        s * (vz * gwx - vx * gwz),
        s * (vx * gwy - vy * gwx),
        s * gwx, s * gwy, s * gwz,           # [g]
    )
    return j, s * r, w


def _min_eig_normalized(H: jax.Array) -> jax.Array:
    """Observability score of a 6x6 normal-equation matrix.

    Returns the smallest eigenvalue of D^-1/2 H D^-1/2 (D = diag(H)) --
    the correlation-normalized system.  Diagonal normalization makes the
    score invariant to pixel count, residual units, and the meters-vs-
    radians scale split between the translational and rotational blocks,
    so one threshold works across pyramid levels and scene depths.

    Why this statistic: point-to-plane ICP on a scene dominated by
    parallel planes has a 3-dimensional null space (2 translations in
    the plane + 1 rotation about its normal).  The per-pixel residual
    and inlier count stay PERFECT while the pose slides along those
    directions -- the desk-scene replay showed 6-7 cm/frame of silent
    drift at err=0.0035 / 26k inliers.  The collapse
    is invisible to every magnitude statistic but explicit in H's
    spectrum: the normalized smallest eigenvalue drops 2-3 orders of
    magnitude (measured: well-constrained orbit scene ~0.1; two-plane
    scene ~1e-4).  A 6x6 eigensolve on device costs ~nothing next to
    the reductions that built H.

    H == 0 (no inliers) returns 0 -- maximally degenerate, which the
    inlier floors catch separately.

    Implementation: INVERSE POWER ITERATION with a small ridge, not
    ``eigvalsh`` (an iterative eigensolver is a long serialized stream of
    tiny ops at 3 calls/frame): eight fixed iterations of Cholesky
    triangular solves cost the same op shapes as one extra GN solve.  The Rayleigh quotient of
    (Hn + dI)^-1 UNDERestimates its top eigenvalue until converged, so
    the returned min-eig only ever errs HIGH -- but the convergence
    ratio is (l2+d)/(lmin+d), which is ~1e4 for any actually degenerate
    system (lmin ~1e-5 vs healthy ~0.1): degeneracy is detected in one
    iteration, only the don't-care zone near the threshold is fuzzy.
    Validated against eigvalsh on the calibration scenes
    (tests/test_icp.py::test_min_eig_estimator_matches_eigvalsh)."""
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(H), 1e-20))
    Hn = H / (d[:, None] * d[None, :])
    ridge = 1e-6
    L = jnp.linalg.cholesky(Hn + ridge * jnp.eye(6))
    x = jnp.full((6,), 6.0**-0.5)
    for _ in range(8):
        y = jax.scipy.linalg.cho_solve((L, True), x)
        x = y * jax.lax.rsqrt(
            jnp.maximum(jnp.dot(y, y, precision=_HIGHEST), 1e-38)
        )
    # Rayleigh quotient of the inverse at the converged direction.
    inv_lam = jnp.dot(
        x, jax.scipy.linalg.cho_solve((L, True), x), precision=_HIGHEST
    )
    lam = 1.0 / jnp.maximum(inv_lam, 1e-30) - ridge
    # A zero/indefinite H (no inliers) NaNs the Cholesky: report 0.
    return jnp.where(jnp.isfinite(lam), jnp.maximum(lam, 0.0), 0.0)


def solve_gn(H, b, damping):
    """Damped Gauss-Newton step, solved on device via Cholesky."""
    d = jnp.diagonal(H)
    Hd = H + damping * jnp.diag(jnp.maximum(d, 1e-12)) + 1e-12 * jnp.eye(6)
    L = jnp.linalg.cholesky(Hd)
    delta = jax.scipy.linalg.cho_solve((L, True), -b)
    finite = jnp.all(jnp.isfinite(delta))
    return jnp.where(finite, delta, 0.0)


def track(
    live_pyramid: tuple[FrameMaps, ...],
    model_pyr: tuple[ModelMaps, ...],
    init_pose: SE3,
    config: Config,
    mode: str = "depth",
) -> TrackResult:
    """Coarse-to-fine GN over the pyramid; fully on device, zero syncs.

    ``mode``: "depth" (geometric point-to-plane), "color" (photometric),
    "combined" (sum of both normal equations), or "light" (combined with
    the photometric model prediction scaled by an SH illumination gain
    field re-estimated at every association round -- ops/light.py,
    reference component #20 ``LightTracker``).
    """
    from . import light as light_ops

    pose = init_pose
    light_coeffs = None  # mode="light": refit at every association round

    err = jnp.zeros(())
    inl = jnp.zeros(())
    lvl_err = [jnp.zeros(())] * config.pyramid_levels
    lvl_inl = [jnp.zeros(())] * config.pyramid_levels
    lvl_deg = [jnp.ones(())] * config.pyramid_levels
    lvl_deg_geo = [jnp.ones(())] * config.pyramid_levels
    for level in range(config.pyramid_levels - 1, -1, -1):
        live = live_pyramid[level]
        model = model_pyr[level]
        iters = config.icp_iters[level]
        strides = config.icp_stride
        if isinstance(strides, int):  # scalar legacy form: finest only
            strides = (strides,) + (1,) * (config.pyramid_levels - 1)
        if strides[level] > 1:
            # Subsample the live side: association gathers dominate ICP's
            # cost; point-to-plane accuracy is retained by the full-res
            # model side and the statistics of ~19k pairs.
            st = strides[level]
            live = FrameMaps(
                depth=live.depth[::st, ::st],
                vertices=live.vertices[::st, ::st],
                normals=live.normals[::st, ::st],
                intensity=(
                    live.intensity[::st, ::st]
                    if live.intensity is not None
                    else None
                ),
                camera=live.camera,
            )

        # Warp-once, ALL modes: ``icp_assoc[level]`` association (gather)
        # rounds, each followed by dense GN re-linearizations on the
        # fixed correspondences/intensity samples -- the reference
        # re-associates every iteration, which pays the full
        # random-access cost per iteration for associations that barely
        # move.  Photometric terms use a first-order image model around
        # the sampled warp point (color_rows_fixed).
        rounds = max(1, min(config.icp_assoc[level], iters))
        inner = -(-iters // rounds)  # ceil

        # Patch/one-hot association on every level but the coarsest
        # (which absorbs the large global warp with flat gathers).
        # At the coarsest level, the FIRST ``coarse_patch_after``
        # rounds stay flat (wide basin), later rounds re-associate
        # a nearly converged warp through frozen patch windows.
        patch_ok = patch_assoc_enabled(config)
        is_coarse = level == config.pyramid_levels - 1
        use_patch = patch_ok and not is_coarse
        patch_from = (
            0 if use_patch
            else (config.coarse_patch_after if patch_ok else rounds)
        )
        geometric = mode in ("depth", "combined", "light")
        # Photometric rows on the ``photo_levels`` COARSEST levels only
        # (default: all).  The finest level's photometric machinery is
        # the single most expensive piece of combined mode (the model-
        # side 3x3 intensity/gradient map build runs at full 640x480,
        # and the patch dot carries 56 extra byte columns there), while
        # the pose arriving at the finest level is already photometric-
        # corrected by the coarser levels.  Pure photometric tracking
        # (mode="color") has no geometric term to fall back on, so it
        # ignores the knob.
        photo_here = mode == "color" or (
            mode != "depth"
            and (config.pyramid_levels - level) <= config.photo_levels
        )
        grads = intensity_grads(model.intensity) if photo_here else None
        assoc_state = (
            _PatchAssoc(
                model,
                photo=(
                    photo_here
                    and mode in ("combined", "light")
                    and config.assoc_patch != "geom"
                ),
            )
            if geometric and patch_ok and patch_from < rounds
            else None
        )

        for _round in range(rounds):
            samples = None
            if geometric:
                if _round >= patch_from:
                    if is_coarse and config.coarse_patch_after == 0 \
                            and _round > 0:
                        # coarse_patch_after=0: patch association from
                        # round 0 with PER-ROUND window re-freezing --
                        # the coarse level's global warp moves too much
                        # for one frozen window, but re-freezing tracks
                        # it (each round's window centers on the current
                        # warp), and the coarse tile table is tiny (75
                        # tiles at 640x480), so the rebuild costs far
                        # less than the flat gathers it replaces.
                        assoc_state.windows = None
                    got = associate_depth_patched(
                        live, model, pose, config, assoc_state
                    )
                    if len(got) == 4:      # fused photometric samples
                        v_m, n_m, ok, samples = got
                    else:
                        v_m, n_m, ok = got
                else:
                    v_m, n_m, ok = associate_depth(live, model, pose, config)
            else:
                v_m = n_m = ok = None
            if photo_here and samples is None:
                samples = color_assoc(live, model, grads, pose, config)
            if photo_here and mode == "light":
                # Re-estimate the illumination gain at EVERY association
                # round (pose frozen during the estimate): each refit sees
                # a tighter warp, so residual misalignment stops leaking
                # into the 9 lighting DoF as the pose converges.  Measured
                # on the relit-sphere test: once-per-level refit leaves a
                # 0.0092 pose-error floor (stale gain fitted on the
                # coarse-level warp), per-round refit reaches 0.0037 relit
                # / 0.00024 unlit -- the feared pose/lighting alternation
                # does not appear because the ridge prior anchors the fit
                # and the gain is frozen across the inner GN iterations.
                light_coeffs = light_ops.estimate_gain(
                    n_m, samples[0], live.intensity, samples[5] & ok
                )
                samples = light_ops.scale_photo_samples(
                    samples, n_m, light_coeffs
                )

            def body_fixed(
                _, carry, v_m=v_m, n_m=n_m, ok=ok, samples=samples
            ):
                pose, err, inl = carry
                if geometric:
                    H, b, e, c = _pp_normal_eqs(
                        live, v_m, n_m, ok, pose, config
                    )
                else:
                    H = jnp.zeros((6, 6))
                    b = jnp.zeros((6,))
                    e = c = jnp.zeros(())
                if photo_here:
                    jc, rc, wc = color_rows_fixed(
                        live, samples, model, pose, config
                    )
                    Hc, bc, ec, cc = _fused_normal_eqs(jc, rc, wc)
                    H, b = H + Hc, b + bc
                    if mode == "color":
                        e, c = ec, cc
                delta = solve_gn(H, b, config.icp_damping)
                enough = c >= 6.0
                delta = jnp.where(enough, delta, jnp.zeros((6,)))
                new_pose = SE3.exp(delta) @ pose
                return new_pose, e / jnp.maximum(c, 1.0), c

            pose, err, inl = jax.lax.fori_loop(
                0, inner, body_fixed, (pose, err, inl)
            )
        lvl_err[level], lvl_inl[level] = jnp.sqrt(err), inl
        # Observability score for this level, at the final pose over the
        # LAST round's active correspondence set.  The geometric part is
        # rebuilt with LIVE normals (see _pp_normal_eqs: the model side's
        # voxel-staircase normals fake in-plane conditioning); the
        # photometric rows are included when present, since they are
        # exactly what rescues a plane-degenerate view (and their absence
        # must make the score drop).  One extra fused reduction per level
        # per frame -- not per GN iteration.  degen_min_eig == 0 compiles
        # the detector out (level_degen stays 1.0).
        if config.degen_min_eig <= 0.0:
            continue
        if geometric:
            H_det, _, _, _ = _pp_normal_eqs(
                live, v_m, n_m, ok, pose, config, live_normals=True
            )
        else:
            H_det = jnp.zeros((6, 6))
        if geometric and photo_here:
            # Geometric-only score BEFORE the photometric rows rescue it
            # (TrackResult.geo_degen: the auto-photo de-escalation
            # signal).  One extra 6x6 inverse-power estimate per photo
            # level per frame.
            lvl_deg_geo[level] = _min_eig_normalized(H_det)
        if photo_here:
            jc, rc, wc = color_rows_fixed(live, samples, model, pose, config)
            H_det = H_det + _fused_normal_eqs(jc, rc, wc)[0]
        lvl_deg[level] = _min_eig_normalized(H_det)
        if geometric and not photo_here:
            lvl_deg_geo[level] = lvl_deg[level]

    level_inliers = jnp.stack(lvl_inl).astype(jnp.int32)
    # Gate score: min over levels carrying every configured term (all
    # levels in depth/color mode; the photo_levels coarsest in
    # combined/light -- see TrackResult.min_degen).
    gate_scores = [
        lvl_deg[level]
        for level in range(config.pyramid_levels)
        if mode in ("depth", "color")
        or (config.pyramid_levels - level) <= config.photo_levels
    ]
    if not gate_scores:
        # combined/light with photo_levels=0 leaves no level carrying
        # every configured term; falling back to the geometric-only
        # scores keeps the degeneracy gate live in exactly the
        # pure-geometric configuration most exposed to the plane-slide
        # failure it was built for (round-4 advisor finding).
        gate_scores = lvl_deg
    min_degen = jnp.min(jnp.stack(gate_scores))
    # Per-level inlier floors: a level operating on 4^level fewer pixels
    # (and the finest on stride^2 fewer) needs proportionally fewer
    # inliers -- but a STARVED or diverged coarse level (near-zero
    # associations) must invalidate the whole track even if the finest
    # level later "re-converged" onto wrong geometry (round-1 weak 4 /
    # round-2 weak 1: health came only from the finest level).
    floors = []
    strides_cfg = config.icp_stride
    if isinstance(strides_cfg, int):
        strides_cfg = (strides_cfg,) + (1,) * (config.pyramid_levels - 1)
    for level in range(config.pyramid_levels):
        # Available pixels at this level relative to the finest:
        # 1/(4^level) of the image at 1/stride^2 sampling.
        rel = strides_cfg[0] ** 2 / (4 ** level * strides_cfg[level] ** 2)
        floors.append(max(6, int(config.icp_min_inliers * rel)))
    levels_ok = jnp.all(
        level_inliers >= jnp.asarray(floors, jnp.int32)
    )

    return TrackResult(
        pose=pose,
        error=jnp.sqrt(err),
        inliers=inl.astype(jnp.int32),
        valid=(inl >= float(config.icp_min_inliers)) & levels_ok,
        level_error=jnp.stack(lvl_err),
        level_inliers=level_inliers,
        level_degen=jnp.stack(lvl_deg),
        min_degen=min_degen,
        geo_degen=jnp.min(jnp.stack(lvl_deg_geo)),
    )
