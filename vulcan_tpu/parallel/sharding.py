"""Multi-chip execution over a jax.sharding.Mesh.

The CUDA reference is strictly single-GPU (SURVEY.md §3: no NCCL/MPI; [B]
targets one GPU), so multi-device is an *extension* (pick a mesh,
annotate shardings, let XLA insert the collectives):

  * **Images are sharded by rows** over the ``pix`` axis: preprocessing,
    ICP residual rows, and the per-pixel raycast march are embarrassingly
    pixel-parallel; XLA inserts halo exchanges for the stencil ops
    (bilateral window, normal cross products, pyramid pooling) and a psum
    for the ICP 6x6 reduction -- exactly the collectives a hand-written
    multi-GPU KinectFusion would issue.
  * **The volume is replicated.**  The reasoned trade (not measured on
    several cards): replicating per-block integration duplicates work
    that is a modest share of the frame, while keeping the renderer's
    random-access volume gathers device-local; a block-sharded volume
    would turn every sample into a cross-device gather.  What is
    validated is the 8-virtual-CPU-device run (tests/test_parallel.py,
    tools/bench_multichip.py): the sharded program compiles and runs with
    the intended shardings; no scaling claim is made.
  * The pose update is a pure function of the psum'd 6x6 system, so every
    device computes the identical pose -- no broadcast needed.

``make_sharded_step`` returns a jitted step with these shardings bound;
``dryrun`` (used by __graft_entry__.dryrun_multichip) runs one tiny frame
on an N-device mesh to validate compile + execution.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Config
from ..core.camera import PinholeCamera
from ..pipeline import fusion


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise RuntimeError(
                    f"make_mesh({n_devices}) found only {len(devices)} "
                    f"devices on platform "
                    f"{devices[0].platform if devices else '?'}; for a "
                    "virtual multi-chip mesh set JAX_PLATFORMS=cpu and "
                    "XLA_FLAGS=--xla_force_host_platform_device_count=N "
                    "before JAX initializes (see dryrun)."
                )
            devices = devices[:n_devices]
    return Mesh(devices, axis_names=("pix",))


def state_sharding(mesh: Mesh, state: fusion.PipelineState):
    """Volume + scalars replicated; model maps sharded by image rows."""
    replicated = NamedSharding(mesh, P())
    rows = NamedSharding(mesh, P("pix"))

    def spec(path, leaf):
        # Model maps (H, W, ...) shard by rows; everything else replicates.
        names = [getattr(p, "name", "") for p in path]
        if "model" in names and leaf.ndim >= 2 and leaf.shape[0] % mesh.size == 0:
            return rows
        return replicated

    return jax.tree_util.tree_map_with_path(spec, state)


def make_sharded_step(config: Config, mesh: Mesh, height: int, width: int):
    """Jit the full online step with mesh shardings bound."""
    rows = NamedSharding(mesh, P("pix"))

    def run(state, depth, color):
        return fusion.step(state, depth, color, config)

    dummy = fusion.init_state(
        config, PinholeCamera.tum_default(), height, width
    )
    s_shard = state_sharding(mesh, dummy)
    return jax.jit(
        run,
        in_shardings=(s_shard, rows, rows),
        out_shardings=s_shard,
        donate_argnums=(0,),
    )


def dryrun(n_devices: int, height: int = 64, width: int = 128) -> None:
    """Compile + execute one sharded step on an n-device mesh (tiny shapes).

    Raises on any sharding/compile/runtime failure; returns None on success.
    """
    from ..config import TINY

    assert height % n_devices == 0, "row count must divide the mesh"
    mesh = make_mesh(n_devices)
    config = TINY
    camera = PinholeCamera.create(80.0, 80.0, width / 2 - 0.5, height / 2 - 0.5)
    state = fusion.init_state(config, camera, height, width)
    state = jax.device_put(state, state_sharding(mesh, state))

    step = make_sharded_step(config, mesh, height, width)
    rows = NamedSharding(mesh, P("pix"))
    # A sphere in front of the camera so every stage does real work.
    from ..io.synthetic import render_sphere_depth
    from ..core.se3 import SE3

    depth, color = render_sphere_depth(
        camera, SE3.identity(), height, width, (0.0, 0.0, 1.5), 0.5
    )
    depth = jax.device_put(depth, rows)
    color = jax.device_put(color, rows)

    state = step(state, depth, color)
    # Second step exercises the tracker against a real model render.
    depth2 = jax.device_put(depth, rows)
    color2 = jax.device_put(color, rows)
    state = step(state, depth2, color2)
    jax.block_until_ready(state)
    n_alloc = int(state.volume.free_count) - 1
    assert n_alloc > 0, "sharded step allocated no blocks"
    assert int(state.frame_idx) == 2
