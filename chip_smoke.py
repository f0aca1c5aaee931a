"""Smoke test of the online reconstruction step on one GPU.

    python chip_smoke.py

Runs in ONE process (a second JAX process could not get the card's
memory) at the production configuration -- ``Config()``: 65,536 voxel
blocks, a 262,144-slot hash, 8 mm voxels -- and a 640x480 sensor:

  1. device check: refuses anything but a GPU, prints JAX's view of it
     and the card's name and power limit (``nvidia-smi``);
  2. kernel checks, each on the GPU against a plain reference, with its
     max error and tolerance: bilateral filter and splat hole-fill vs
     float64 NumPy; surfel placement and the splat color-byte select
     (bf16 one-hot matmuls) vs ``take_along_axis``, bit-exact; one-hot
     vs flat integration gather, bit-exact; one frame of integration on
     the GPU vs the CPU; no f32 matrix product on the step without an
     explicit precision;
  3. pipeline: the CLI's ``run`` on a 60-frame synthetic orbit in the
     default ``combined`` mode and in ``depth`` mode (ATE, inliers,
     failures, overflow gauges, mesh), and ``step_seq`` vs a loop of
     ``step`` over 5 frames;
  4. information: compile time (set-up), ``memory_analysis`` of the
     step, peak device memory.

Any failure raises, so the process exits non-zero; only a run where
every phase passed prints the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
The check functions are shared with the CPU tests, which run them small.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax._src import source_info_util
from jax.extend import core as jex_core

from vulcan_tpu.config import Config
from vulcan_tpu.core.camera import PinholeCamera
from vulcan_tpu.core.frame import make_frame
from vulcan_tpu.io.synthetic import (
    add_depth_noise,
    orbit_poses,
    render_scene_depth,
)
from vulcan_tpu.ops import allocate, blocks, preprocess, sparse, splat
from vulcan_tpu.pipeline import fusion
from vulcan_tpu.utils.runtime import card_info, require_gpu, setup_cache

H, W = 480, 640
# The CLI's synthetic orbit: three spheres over a floor.
SPHERES = (
    ((0.0, 0.0, 0.0), 0.5),
    ((0.6, 0.3, 0.2), 0.25),
    ((-0.5, 0.4, -0.1), 0.3),
)


def cli_camera(width: int, height: int) -> PinholeCamera:
    """The intrinsics ``vulcan-tpu run --synthetic`` uses."""
    return PinholeCamera.create(
        0.8 * width, 0.8 * width, width / 2 - 0.5, height / 2 - 0.5
    )


def report(name: str, err: float, tol: float) -> None:
    """Print one check's max error beside its tolerance; raise if over."""
    ok = err <= tol
    print(f"check {name}: max_err={err:.3g} tol={tol:.3g} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise RuntimeError(f"check {name} failed: {err} > {tol}")


# --- 1. device ------------------------------------------------------------


def check_device():
    """Print JAX's view of the device and the card; raise unless a GPU."""
    print(f"jax {jax.__version__}", flush=True)
    devices = require_gpu()
    print(f"device_kind {devices[0].device_kind} count {len(devices)}")
    if os.environ.get("XLA_FLAGS"):
        print(f"XLA_FLAGS {os.environ['XLA_FLAGS']}")
    for name, power in card_info():
        print(f"{name}, {power}", flush=True)
    return devices


# --- 2. kernel references -------------------------------------------------


def _shift_np(a, dy, dx, fill):
    """out[y, x] = a[y+dy, x+dx], ``fill`` outside (NumPy)."""
    h, w = a.shape
    p = max(abs(dy), abs(dx))
    pad = np.pad(a, p, constant_values=fill)
    return pad[p + dy:p + dy + h, p + dx:p + dx + w]


def bilateral_reference(depth, config: Config) -> np.ndarray:
    """``preprocess.bilateral_filter`` in float64 NumPy."""
    d = np.asarray(depth, np.float64)
    r = config.bilateral_radius
    acc = np.zeros_like(d)
    wacc = np.zeros_like(d)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            n = _shift_np(d, dy, dx, 0.0)
            wt = math.exp(
                -(dy * dy + dx * dx) / (2.0 * config.bilateral_sigma_space**2)
            ) * np.exp(-((n - d) ** 2) / (2.0 * config.bilateral_sigma_depth**2))
            wt = np.where(n > 0.0, wt, 0.0)
            acc += wt * n
            wacc += wt
    out = np.where(wacc > 0.0, acc / np.maximum(wacc, 1e-12), 0.0)
    return np.where(d > 0.0, out, 0.0)


def fill_smooth_reference(d, config: Config) -> np.ndarray:
    """``splat._fill_and_smooth`` in NumPy: the fill copies float32
    values and compares them against float32 thresholds exactly as the
    device does; the smoothing average accumulates in float64."""
    d = np.asarray(d, np.float32)
    mu = config.trunc_dist
    nbrs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dy, dx) != (0, 0)]
    for _ in range(config.splat_fill_rounds):
        best = d.copy()
        worst = np.where(np.isfinite(d), d, -np.inf)
        for dy, dx in nbrs:
            n = _shift_np(d, dy, dx, np.inf)
            best = np.minimum(best, n)
            worst = np.maximum(worst, np.where(np.isfinite(n), n, -np.inf))
        with np.errstate(invalid="ignore"):
            consistent = (worst - best) < np.float32(2.0 * mu)
        d = np.where(np.isfinite(d) | ~consistent, d, best)
    fin = np.isfinite(d)
    acc = np.where(fin, d, 0.0).astype(np.float64)
    cnt = fin.astype(np.float64)
    for dy, dx in nbrs:
        n = _shift_np(d, dy, dx, np.inf)
        with np.errstate(invalid="ignore"):
            ok = np.isfinite(n) & (np.abs(n - d) < np.float32(0.5 * mu))
        acc += np.where(ok, n, 0.0)
        cnt += ok
    return np.where(fin, acc / np.maximum(cnt, 1.0), d)


def pack_surfels_reference(tsdf_rows, weight_rows, band: float, slots: int):
    """``blocks.pack_surfels`` with the slot placement done by
    ``take_along_axis`` instead of the one-hot matmul."""
    val, pos, count = blocks._surfel_slots(tsdf_rows, weight_rows, band, slots)
    n = val.shape[1]
    order = jnp.argsort(jnp.where(pos >= 0, pos, n), axis=1)[:, :slots]
    out = jnp.take_along_axis(val, order, axis=1)
    kept = jnp.minimum(count, slots)
    live = jnp.arange(slots)[None, :] < kept[:, None]
    return jnp.where(live, out, blocks.EMPTY_SURFEL), kept, count - kept


def select_voxel_rgb_reference(colorpack_rows, lidx):
    """``splat.select_voxel_rgb`` by ``take_along_axis``."""
    g = jnp.take_along_axis(colorpack_rows, lidx, axis=1)
    return jnp.stack([(g >> 16) & 0xFF, (g >> 8) & 0xFF, g & 0xFF], axis=-1)


def surfel_rows(n_rows: int, seed: int = 0):
    """Random TSDF/weight rows (n_rows, 512): ~half the voxels near the
    surface band, ~30% unobserved, so some rows overflow the slots."""
    rng = np.random.default_rng(seed)
    t = np.clip(rng.normal(0.0, 0.5, (n_rows, 512)), -1.0, 1.0)
    w = np.where(rng.random((n_rows, 512)) < 0.7, rng.integers(1, 100, (n_rows, 512)), 0)
    return jnp.asarray(t, jnp.float32), jnp.asarray(w, jnp.float32)


def pack_surfels_mismatches(n_rows: int, config: Config, seed: int = 0) -> int:
    """Entries where ``pack_surfels`` differs from its reference."""
    t, w = surfel_rows(n_rows, seed)
    band, slots = blocks.surfel_band(config), config.surfel_slots
    got = jax.jit(blocks.pack_surfels, static_argnums=(2, 3))(t, w, band, slots)
    ref = jax.jit(pack_surfels_reference, static_argnums=(2, 3))(
        t, w, band, slots
    )
    return int(sum(jnp.sum(a != b) for a, b in zip(got, ref)))


def select_rgb_mismatches(n_rows: int, n_slots: int, seed: int = 0) -> int:
    """Entries where ``splat.select_voxel_rgb`` differs from its reference."""
    rng = np.random.default_rng(seed)
    cp = jnp.asarray(rng.integers(0, 2**31 - 1, (n_rows, 512)), jnp.int32)
    lidx = jnp.asarray(rng.integers(0, 512, (n_rows, n_slots)), jnp.int32)
    got = jax.jit(splat.select_voxel_rgb)(cp, lidx)
    ref = jax.jit(select_voxel_rgb_reference)(cp, lidx)
    return int(jnp.sum(got != ref))


def _integrate_band(vol, frame, band_ids, n_band, config):
    return sparse.integrate_sparse(vol, frame, config, ids=band_ids, count=n_band)


integrate_band = jax.jit(_integrate_band, static_argnums=4)


def integrate_inputs(config: Config, camera, h, w, orbit_radius: float):
    """(volume, frame, band_ids, n_band) for ``integrate_band``: one frame
    of a 0.5 m sphere seen from ``orbit_radius``, with the volume already
    allocated for it."""
    pose = orbit_poses(1, (0.0, 0.0, 0.0), radius=orbit_radius, height=0.2)[0]
    depth, color = render_scene_depth(
        camera, pose, h, w, (((0.0, 0.0, 0.0), 0.5),)
    )
    frame = make_frame(depth, color, camera, pose)
    vol, band_ids, n_band = jax.jit(
        allocate.allocate_for_frame, static_argnums=4
    )(blocks.create_volume(config), frame.depth, camera, pose, config)
    return vol, frame, band_ids, n_band


EDGE_PX = 2e-3


def near_rounding_boundary(config: Config, vol, frame, band_ids, n_band):
    """(num_blocks, 512) mask of band voxels whose projection (float64)
    lies within ``EDGE_PX`` of a half-integer pixel coordinate, where
    nearest-pixel rounding can go either way in float32."""
    ids = np.asarray(band_ids)[: int(n_band)]
    ids = ids[ids > 0]
    local = np.stack(
        np.meshgrid(np.arange(8), np.arange(8), np.arange(8), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    coords = np.asarray(vol.block_coords)[ids].astype(np.float64)
    world = (coords[:, None, :] * 8 + local) * config.voxel_size
    rot = np.asarray(frame.pose.rotation, np.float64)
    cam = (world - np.asarray(frame.pose.translation, np.float64)) @ rot
    c = frame.camera
    u = float(c.fx) * cam[..., 0] / cam[..., 2] + float(c.cx)
    v = float(c.fy) * cam[..., 1] / cam[..., 2] + float(c.cy)
    near = (np.abs(u - np.floor(u) - 0.5) < EDGE_PX) | (
        np.abs(v - np.floor(v) - 0.5) < EDGE_PX
    )
    mask = np.zeros(vol.tsdf.shape, bool)
    mask[ids] = near
    return mask


def onehot_flat_mismatches(config: Config, camera, h, w, orbit_radius: float):
    """Voxel entries where the one-hot patch gather integrates differently
    from the flat gather.  At ``orbit_radius`` >= 2 m every block of the
    production config projects inside the mip-0 patch, where the two
    paths take the identical nearest sample."""
    args = integrate_inputs(config, camera, h, w, orbit_radius)
    va = integrate_band(*args, dataclasses.replace(config, integrate_gather="flat"))
    vb = integrate_band(*args, dataclasses.replace(config, integrate_gather="onehot"))
    observed = int(jnp.sum(va.weight > 0))
    diff = sum(
        int(jnp.sum(getattr(va, k) != getattr(vb, k)))
        for k in ("tsdf", "weight", "colorpack")
    )
    return diff, observed


def dots_without_precision(jaxpr) -> list[str]:
    """f32 ``dot_general`` equations (recursively) with no explicit
    precision: on the GPU they may run in TF32."""
    found = []

    def visit(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                dtypes = {v.aval.dtype for v in eqn.invars}
                prec = eqn.params.get("precision")
                if jnp.dtype("float32") in dtypes and (
                    prec is None or any(p is None for p in prec)
                ):
                    found.append(source_info_util.summarize(eqn.source_info))
            for param in eqn.params.values():
                for sub in param if isinstance(param, (tuple, list)) else (param,):
                    if isinstance(sub, jex_core.ClosedJaxpr):
                        visit(sub.jaxpr)
                    elif isinstance(sub, jex_core.Jaxpr):
                        visit(sub)

    visit(jaxpr.jaxpr)
    return found


# --- 3. pipeline ------------------------------------------------------------


def run_cli(argv) -> dict:
    """``vulcan_tpu.cli.main(argv)`` in this process; its JSON report."""
    from vulcan_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def check_cli_run(rep: dict, tag: str) -> None:
    print(f"cli {tag}: " + json.dumps(rep), flush=True)
    conds = {
        "ate_rmse_m < 0.02": rep["ate_rmse_m"] < 0.02,
        "track_inliers > 1000": rep["track_inliers"] > 1000,
        "track_failures == 0": rep["track_failures"] == 0,
        "alloc_overflow == 0": rep["alloc_overflow"] == 0,
        "visible_overflow == 0": rep["visible_overflow"] == 0,
        "mesh_triangles > 0": rep["mesh_triangles"] > 0,
    }
    bad = [k for k, v in conds.items() if not v]
    if bad:
        raise RuntimeError(f"cli {tag} failed: {bad}")
    print(f"check cli {tag}: ok ({', '.join(conds)})", flush=True)


def orbit_frames(camera, n: int):
    poses = orbit_poses(n, radius=1.6, height=0.35, span=n * 0.05)
    render = jax.jit(lambda p: render_scene_depth(camera, p, H, W, SPHERES, -0.6))
    return poses, [render(p) for p in poses]


def step_seq_vs_step(config: Config, camera, mode: str, n: int = 5):
    """Max |difference| between ``step_seq`` and a loop of ``step`` over
    ``n`` frames: per-frame translations, final TSDF, weights and model
    depth."""
    poses, frames = orbit_frames(camera, n + 1)
    s_a = fusion.init_state(config, camera, H, W, init_pose=poses[0])
    s_b = fusion.init_state(config, camera, H, W, init_pose=poses[0])
    tr_a = []
    for d, c in frames[1:]:
        s_a = fusion.step(s_a, d, c, config, mode)
        tr_a.append(np.asarray(s_a.pose.translation))
    ds = jnp.stack([d for d, _ in frames[1:]])
    cs = jnp.stack([c for _, c in frames[1:]])
    s_b, tr_b = fusion.step_seq(s_b, ds, cs, config, mode)
    ca, ta, wa = volume_by_block(s_a.volume)
    cb, tb, wb = volume_by_block(s_b.volume)
    common, ia, ib = np.intersect1d(ca, cb, return_indices=True)
    ta, tb, wa, wb = ta[ia], tb[ib], wa[ia], wb[ib]
    observed = (wa > 0) | (wb > 0)
    da, db = np.asarray(s_a.model.depth), np.asarray(s_b.model.depth)
    return {
        "translation_m": float(np.max(np.abs(np.asarray(tr_b) - np.stack(tr_a)))),
        "blocks": int(len(common)),
        "blocks_in_one_only": int(len(ca) + len(cb) - 2 * len(common)),
        "voxels_observed": int(observed.sum()),
        "voxels_tsdf_differ": int(np.sum(observed & (np.abs(ta - tb) > 1e-5))),
        "voxels_weight_differ": int(np.sum(wa != wb)),
        "tsdf_max_diff": float(np.max(np.abs(ta - tb))),
        "model_pixels_differ": int(np.sum(np.abs(da - db) > 1e-4)),
    }


def volume_by_block(vol):
    """(block codes, tsdf rows, weight rows) of the allocated blocks,
    sorted by block coordinate (slot order depends on allocation order)."""
    n = int(vol.free_count)
    c = np.asarray(vol.block_coords[1:n]).astype(np.int64) + blocks.COORD_BOUND
    codes = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
    order = np.argsort(codes)
    return (codes[order], np.asarray(vol.tsdf[1:n])[order],
            np.asarray(vol.weight[1:n])[order])


# --- main -------------------------------------------------------------------


def main() -> int:
    setup_cache()
    devices = check_device()
    config = Config()
    camera = cli_camera(W, H)
    t_start = time.perf_counter()

    # Kernels at real widths.
    rng = np.random.default_rng(0)
    pose = orbit_poses(3, radius=1.6, height=0.35, span=0.15)[1]
    depth, _ = render_scene_depth(camera, pose, H, W, SPHERES, -0.6)
    # A sensor reads nothing beyond its range (the floor runs to the
    # horizon); float32 spacing at 5 m is 4.8e-7 m.
    depth = np.where(np.asarray(depth) <= config.depth_max, np.asarray(depth), 0.0)
    noisy = jnp.asarray(add_depth_noise(depth, rng))
    if int(jnp.sum(noisy > 0)) < H * W // 4:
        raise RuntimeError("bilateral scene is mostly empty")
    got = jax.jit(preprocess.bilateral_filter, static_argnums=1)(noisy, config)
    report("bilateral_filter 640x480 vs float64",
           float(np.max(np.abs(np.asarray(got) - bilateral_reference(noisy, config)))),
           1e-5)

    holes = np.where(depth > 0, depth, np.inf)
    holes[rng.random(holes.shape) < 0.25] = np.inf
    holes = holes.astype(np.float32)
    got = np.asarray(jax.jit(splat._fill_and_smooth, static_argnums=1)(
        jnp.asarray(holes), config))
    ref = fill_smooth_reference(holes, config)
    report("fill_and_smooth 640x480: filled pixels differ",
           int(np.sum(np.isfinite(got) != np.isfinite(ref))), 0)
    fin = np.isfinite(ref)
    if fin.sum() < H * W // 4:
        raise RuntimeError(f"fill_and_smooth scene has {fin.sum()} pixels")
    report("fill_and_smooth 640x480 vs float64",
           float(np.max(np.abs(got[fin] - ref[fin]))), 1e-5)

    report("pack_surfels (1024 rows) vs take_along_axis",
           pack_surfels_mismatches(config.integrate_chunk, config), 0)
    report("splat rgb byte select (2048x96) vs take_along_axis",
           select_rgb_mismatches(2048, config.surfel_slots // 2), 0)

    diff, observed = onehot_flat_mismatches(config, camera, H, W, 2.0)
    if observed < 10000:
        raise RuntimeError(f"onehot/flat scene observed only {observed} voxels")
    report(f"integrate onehot vs flat ({observed} voxels observed)", diff, 0)

    # One frame of integration on the GPU and on the CPU.  Both round each
    # voxel's projection to its nearest pixel; where the projection lies
    # within float32 noise of a half pixel the two backends may pick
    # neighbouring pixels (their f32 products differ in the last bit), so
    # such voxels are told apart and every other voxel must agree.
    args = integrate_inputs(config, camera, H, W, 1.6)
    v_gpu = integrate_band(*args, config)
    v_cpu = integrate_band(*jax.device_put(args, jax.devices("cpu")[0]), config)
    t_gpu, t_cpu = np.asarray(v_gpu.tsdf), np.asarray(v_cpu.tsdf)
    w_gpu, w_cpu = np.asarray(v_gpu.weight), np.asarray(v_cpu.weight)
    differ = (w_gpu != w_cpu) | (np.abs(t_gpu - t_cpu) > 1e-5)
    edge = near_rounding_boundary(config, *args)
    print(f"integrate gpu vs cpu: {int(np.sum((w_gpu > 0) | (w_cpu > 0)))} "
          f"voxels observed, {int(differ.sum())} differ, "
          f"{int(edge.sum())} within {EDGE_PX} px of a rounding boundary")
    report("integrate_sparse gpu vs cpu: differing voxels off a rounding "
           "boundary", int(np.sum(differ & ~edge)), 0)
    report("integrate_sparse gpu vs cpu: tsdf off rounding boundaries",
           float(np.max(np.abs(t_gpu - t_cpu)[~edge])), 1e-5)
    report("integrate_sparse gpu vs cpu: weights off rounding boundaries",
           float(np.max(np.abs(w_gpu - w_cpu)[~edge])), 0)

    state0 = fusion.init_state(config, camera, H, W)
    d0 = jnp.zeros((H, W), jnp.float32)
    c0 = jnp.zeros((H, W, 3), jnp.float32)
    for mode in ("combined", "depth"):
        jaxpr = jax.make_jaxpr(
            lambda s, d, c: fusion._step_impl(s, d, c, config, mode)
        )(state0, d0, c0)
        loose = dots_without_precision(jaxpr)
        for where in loose:
            print(f"  f32 dot without precision: {where}")
        report(f"f32 dots without precision on the {mode} step", len(loose), 0)

    # Set-up: compile the production step ahead of time (the persistent
    # cache then serves the CLI's own compile of it).
    t0 = time.perf_counter()
    compiled = fusion.step.lower(state0, d0, c0, config, "combined").compile()
    print(f"setup: step compile (combined, {W}x{H}) "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"memory_analysis (combined step): {compiled.memory_analysis()}", flush=True)
    del compiled, state0

    # Pipeline through the CLI.
    with tempfile.TemporaryDirectory(prefix="vulcan_smoke_") as tmp:
        for mode in ("combined", "depth"):
            t0 = time.perf_counter()
            rep = run_cli([
                "run", "--synthetic", "60", "--width", str(W),
                "--height", str(H), "--eval-ate", "--profile",
                "--mesh-out", os.path.join(tmp, f"{mode}.ply"),
                "--mode", mode,
            ])
            print(f"cli {mode} wall (incl. compile) {time.perf_counter() - t0:.1f} s")
            check_cli_run(rep, mode)

    # Bit-exact on the CPU (tests/test_pipeline.py).  On the GPU the scan
    # body and the standalone step compile to different fusions, whose
    # float results may differ in the last bit; a last-bit pose change
    # then flips nearest-pixel rounding at a few voxels and pixels.
    d = step_seq_vs_step(config, camera, "combined")
    print(f"step_seq vs step x5 (combined): {json.dumps(d)}")
    report("step_seq vs step: translation (m)", d["translation_m"], 1e-6)
    report("step_seq vs step: share of blocks allocated in only one",
           d["blocks_in_one_only"] / max(d["blocks"], 1), 1e-3)
    report("step_seq vs step: share of voxels whose tsdf differs",
           d["voxels_tsdf_differ"] / max(d["voxels_observed"], 1), 1e-3)
    report("step_seq vs step: share of voxels whose weight differs",
           d["voxels_weight_differ"] / max(d["voxels_observed"], 1), 1e-3)
    report("step_seq vs step: share of model pixels that differ",
           d["model_pixels_differ"] / (H * W), 1e-3)

    stats = devices[0].memory_stats() or {}
    print(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    print(f"total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
