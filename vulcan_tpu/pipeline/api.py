"""Public five-class pipeline API: Volume, Integrator, Tracer, Tracker,
Extractor (+ the online Pipeline driver).

BASELINE.json names these five classes verbatim as the API surface to match
(SURVEY.md §1).  They are thin object wrappers over the pure-functional ops
(all real state is pytrees; every method is jit-backed), so users of the
CUDA reference find the same vocabulary while the JAX core stays
functional.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..core.camera import PinholeCamera
from ..core.frame import Frame, make_frame
from ..core.se3 import SE3
from ..ops import allocate as _allocate
from ..ops import blocks as B
from ..ops import icp as _icp
from ..ops import mcubes as _mcubes
from ..ops import raycast as _raycast
from ..ops import sparse as _sparse
from ..ops.preprocess import build_pyramid
from . import fusion


class Volume:
    """Sparse voxel-block TSDF volume (reference ``Volume``, component #14).

    Owns the voxel storage + hash table + visible list.  The reference's
    ``SetTruncationLength`` / voxel-size setters become constructor-time
    config (config is static under jit; changing it recompiles).
    """

    def __init__(self, config: Config = Config()):
        self.config = config
        self.state = B.create_volume(config)
        self.band = None  # (band_ids, n_band) of the last allocated frame

    # -- setters mirrored from the reference API --
    def _assert_empty(self, what: str) -> None:
        # Geometry constants are baked into already-fused TSDF values;
        # changing them under fused state would silently reinterpret every
        # voxel (round-1 advisor finding).
        if int(self.state.free_count) > 1:
            raise RuntimeError(
                f"cannot change {what} on a volume with fused data "
                f"({self.num_allocated} blocks allocated); create a new "
                "Volume with the desired config instead"
            )

    def set_truncation_length(self, mu: float) -> "Volume":
        self._assert_empty("truncation length")
        self.config = dataclasses.replace(self.config, trunc_dist=float(mu))
        return self

    def set_voxel_size(self, vs: float) -> "Volume":
        self._assert_empty("voxel size")
        self.config = dataclasses.replace(self.config, voxel_size=float(vs))
        return self

    @property
    def num_allocated(self) -> int:
        return int(self.state.free_count) - 1

    @property
    def num_visible(self) -> int:
        return int(self.state.num_visible)

    def allocate(self, frame: Frame) -> None:
        """Allocate blocks in the frame's truncation band + update the
        visible list (reference allocation + visibility passes).  The
        band list of the last allocated frame is kept on ``self.band``
        for the Integrator."""
        h, w = frame.depth.shape
        self.state, band_ids, n_band = _allocate.allocate_for_frame(
            self.state, frame.depth, frame.camera, frame.pose, self.config
        )
        self.band = (band_ids, n_band)
        self.state = _allocate.update_visibility(
            self.state, frame.camera, frame.pose, h, w, self.config
        )

    def update_visibility(self, camera, pose, height, width) -> None:
        self.state = _allocate.update_visibility(
            self.state, camera, pose, height, width, self.config
        )

    def visible_blocks(self):
        """(block_ids (N,), block_coords (N,3)) of the current visible set
        (the reference's ``Volume`` view of visible blocks)."""
        n = int(self.state.num_visible)
        ids = np.asarray(self.state.visible_ids[:n])
        return ids, np.asarray(self.state.block_coords[ids])

    def validate(self) -> dict:
        """Debug consistency pass (SURVEY.md §6 'race detection' row: the
        one racy construct in the reference -- hash insertion -- is
        deterministic here; this checks the resulting invariants).

        Returns a dict of findings; all-zero means healthy.
        """
        st = self.state
        codes = np.asarray(st.hash_codes)
        values = np.asarray(st.hash_values)
        free = int(st.free_count)
        occupied = codes != 0x7FFFFFFF
        report = {
            "hash_entries": int(occupied.sum()),
            "allocated_blocks": free - 1,
            # every occupied slot must map to a valid block index
            "bad_values": int(
                ((values[occupied] < 1) | (values[occupied] >= free)).sum()
            ),
            # block indices must be unique across the table
            "duplicate_values": int(
                len(values[occupied]) - len(np.unique(values[occupied]))
            ),
            # count must match: one hash entry per allocated block
            "count_mismatch": int(occupied.sum() != free - 1),
            "alloc_overflow": int(st.alloc_overflow),
            "visible_overflow": int(st.visible_overflow),
        }
        # Persistent surfel lists must mirror the TSDF they were packed
        # from (maintained incrementally by integration; a mismatch
        # means a block's TSDF changed outside integrate_sparse).
        from ..ops import blocks as _B

        surf, count, _ = _B.pack_surfels(
            st.tsdf, st.weight, _B.surfel_band(self.config),
            self.config.surfel_slots,
        )
        report["surfel_mismatch"] = int(
            (np.asarray(surf) != np.asarray(st.surfpack)).sum()
        )
        report["surfel_count_mismatch"] = int(
            (np.asarray(count) != np.asarray(st.surf_count)).sum()
        )
        return report

    # -- persistence (SURVEY.md §6 checkpoint/resume) --
    _SNAPSHOT_VERSION = 4  # v2: named per-field keys (packed int32
                           # color); v3: persistent surfel lists;
                           # v4: incremental-mesh dirty flags

    def save(self, path: str) -> None:
        """Snapshot the full volume state to one .npz file.

        Leaves are saved under their FIELD NAMES plus a format version:
        positional (arr_0..arr_N) snapshots from before a state-layout
        change would otherwise load silently misaligned (e.g. old f32
        color landing in the int32 colorpack slot)."""
        arrays = {
            f.name: np.asarray(getattr(self.state, f.name))
            for f in dataclasses.fields(self.state)
        }
        arrays["__snapshot_version__"] = np.asarray(self._SNAPSHOT_VERSION)
        np.savez_compressed(path, **arrays)

    def load(self, path: str) -> None:
        data = np.load(path)
        if "__snapshot_version__" not in data:
            raise ValueError(
                f"{path} is a legacy positional snapshot (no version key); "
                "it predates the packed-color volume layout and cannot be "
                "loaded safely -- re-run the reconstruction to regenerate it"
            )
        version = int(data["__snapshot_version__"])
        if version != self._SNAPSHOT_VERSION:
            raise ValueError(
                f"{path}: snapshot format v{version} does not match this "
                f"build's v{self._SNAPSHOT_VERSION}"
            )
        new_state = {}
        for f in dataclasses.fields(self.state):
            cur = getattr(self.state, f.name)
            if f.name not in data:
                raise ValueError(f"{path}: snapshot is missing '{f.name}'")
            arr = data[f.name]
            if arr.dtype != np.asarray(cur).dtype:
                raise ValueError(
                    f"{path}: '{f.name}' has dtype {arr.dtype}, "
                    f"expected {np.asarray(cur).dtype}"
                )
            if arr.shape != cur.shape:
                raise ValueError(
                    f"{path}: '{f.name}' has shape {arr.shape}, expected "
                    f"{cur.shape} (snapshot config differs: check "
                    "num_blocks/hash_size/max_visible)"
                )
            new_state[f.name] = jnp.asarray(arr)
        self.state = dataclasses.replace(self.state, **new_state)


class Integrator:
    """Depth + color TSDF fusion (reference ``Integrator``, component #15)."""

    def __init__(self, volume: Volume):
        self.volume = volume

    def integrate(self, frame: Frame) -> None:
        """Allocate, update visibility, and fuse one posed frame."""
        self.volume.allocate(frame)
        self.volume.state = _sparse.integrate_sparse(
            self.volume.state, frame, self.volume.config
        )


class Tracer:
    """Raycast renderer (reference ``Tracer``, component #16)."""

    def __init__(self, volume: Volume):
        self.volume = volume

    def trace(
        self,
        camera: PinholeCamera,
        pose: SE3,
        height: int,
        width: int,
        update_visibility: bool = True,
        normals: str = "cross",
    ) -> _raycast.Render:
        if update_visibility:
            self.volume.update_visibility(camera, pose, height, width)
        return _raycast.render(
            self.volume.state, camera, pose, height, width,
            self.volume.config, normals,
        )


class Tracker:
    """Frame-to-model ICP (reference ``Tracker``/``DepthTracker``/
    ``ColorTracker``/``LightTracker``, components #17 and #20).
    ``mode``: depth | color | combined | light.

    ``light`` is the JAX rebuild of the reference's recalled
    ``LightTracker`` (photometric tracking under a shading model,
    SURVEY.md component #20 [M] -- unverifiable against the empty
    reference mount, so the light model is redesigned rather than
    recalled: a 9-coefficient spherical-harmonics illumination gain
    field estimated per frame by one linear solve; see ops/light.py).
    """

    def __init__(self, config: Config = Config(), mode: str = "depth"):
        self.config = config
        self.mode = mode

    def track(
        self,
        model: _raycast.Render,
        live_frame: Frame,
        init_pose: SE3 | None = None,
    ) -> _icp.TrackResult:
        init = init_pose if init_pose is not None else model.pose
        live_pyr = build_pyramid(
            live_frame, self.config, with_intensity=(self.mode != "depth")
        )
        model_pyr = _icp.model_pyramid(
            model, self.config.pyramid_levels,
            with_intensity=(self.mode != "depth"),
        )
        return _icp.track(live_pyr, model_pyr, init, self.config, self.mode)


class DepthTracker(Tracker):
    """Geometric point-to-plane ICP (reference ``DepthTracker`` [M])."""

    def __init__(self, config: Config = Config()):
        super().__init__(config, mode="depth")


class ColorTracker(Tracker):
    """Photometric tracking (reference ``ColorTracker`` [M]); in practice
    use ``mode="combined"`` via the base class -- pure photometric
    tracking has no depth term to anchor scale-degenerate motion."""

    def __init__(self, config: Config = Config()):
        super().__init__(config, mode="color")


class LightTracker(Tracker):
    """Combined tracking with per-frame SH illumination-gain estimation
    (reference ``LightTracker`` [M], component #20; ops/light.py)."""

    def __init__(self, config: Config = Config()):
        super().__init__(config, mode="light")


class Extractor:
    """Colored marching-cubes mesher (reference ``Extractor``, #18)."""

    def __init__(self, volume: Volume):
        self.volume = volume

    def extract(self) -> _mcubes.Mesh:
        return _mcubes.extract_mesh(self.volume.state, self.volume.config)

    def export_ply(self, path: str, weld: bool = True) -> int:
        """Extract and write a PLY; returns the triangle count."""
        from ..io.ply import write_ply

        mesh = self.extract()
        count = int(mesh.count)
        write_ply(
            path,
            np.asarray(mesh.positions[:count]),
            np.asarray(mesh.colors[:count]),
            weld=weld,
        )
        return count


class Pipeline:
    """Full online loop: track + fuse + raycast per frame (L8).

    The hot path is ``fusion.step`` -- one donated jit call per frame.
    """

    def __init__(
        self,
        config: Config,
        camera: PinholeCamera,
        height: int,
        width: int,
        init_pose: SE3 | None = None,
        mode: str = "depth",
    ):
        self.config = config
        self.height = height
        self.width = width
        self.mode = mode
        self.state = fusion.init_state(config, camera, height, width, init_pose)

    def process(self, depth, color=None, pose: SE3 | None = None) -> None:
        """Feed one frame.  With ``pose`` given, runs fusion-only.

        uint16 depth (TUM raw) and uint8 color are uploaded as-is and
        converted on device (3.2x less host->device traffic)."""
        depth = jnp.asarray(depth)
        if depth.dtype not in (jnp.uint16, jnp.float32):
            depth = depth.astype(jnp.float32)
        if color is None:
            color = jnp.zeros(depth.shape + (3,), jnp.float32)
        color = jnp.asarray(color)
        if color.dtype not in (jnp.uint8, jnp.float32):
            color = color.astype(jnp.float32)
        if pose is not None:
            self.state = fusion.step_known_pose(
                self.state, depth, color, pose, self.config
            )
        else:
            self.state = fusion.step(
                self.state, depth, color, self.config, self.mode
            )

    @property
    def pose(self) -> SE3:
        return self.state.pose

    def diagnostics(self) -> dict:
        s = self.state
        return {
            "frame": int(s.frame_idx),
            "track_error": float(s.track_error),
            "track_inliers": int(s.track_inliers),
            "track_failures": int(s.track_failures),
            "track_level_error": [
                round(float(x), 6) for x in s.track_level_error
            ],
            "track_level_inliers": [
                int(x) for x in s.track_level_inliers
            ],
            "track_level_degen": [
                round(float(x), 6) for x in s.track_level_degen
            ],
            "track_degen_frames": int(s.track_degen_frames),
            "photo_armed_frames": int(s.photo_cnt),
            "allocated_blocks": int(s.volume.free_count) - 1,
            "visible_blocks": int(s.volume.num_visible),
            "alloc_overflow": int(s.volume.alloc_overflow),
            "visible_overflow": int(s.volume.visible_overflow),
        }

    def extract_mesh(self) -> _mcubes.Mesh:
        return _mcubes.extract_mesh(self.state.volume, self.config)

    def export_ply(self, path: str) -> int:
        from ..io.ply import write_ply

        mesh = self.extract_mesh()
        count = int(mesh.count)
        write_ply(
            path,
            np.asarray(mesh.positions[:count]),
            np.asarray(mesh.colors[:count]),
        )
        return count
