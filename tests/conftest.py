"""Test configuration: run on CPU with 8 virtual devices.

Tests must be fast and deterministic; the GPU is for ``chip_smoke.py``,
``bench.py`` and the tests marked ``chip`` (which skip here).  Multi-chip
sharding tests use the 8 virtual CPU devices, as ``dryrun_multichip``
does.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# CLI tests call utils.runtime.setup_cache(); keep the persistent
# compilation cache off in tests (VULCAN_TPU_CACHE="" is its off-switch):
# CPU compiles are cheap.
os.environ.setdefault("VULCAN_TPU_CACHE", "")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled-executable state after each test module, so a
    worker's memory stays bounded over the whole suite; per-module
    recompiles are cheap on CPU."""
    yield
    import jax

    jax.clear_caches()


@pytest.fixture
def gpu():
    """JAX's GPU devices, for tests marked ``chip``; skips the test when
    the backend has none.  Decided here, at run time, never at import or
    collection: every xdist worker must collect the same tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (on the card: JAX_PLATFORMS=cuda)")
    return devices


# --- quick suite -----------------------------------------------------------
# ``pytest -m quick`` runs one representative test per subsystem, so
# iteration does not pay for the full suite.  Selected centrally here
# instead of scattering decorators: the list IS the definition of "one per
# subsystem".
_QUICK = {
    "test_se3.py::test_se3_exp_log_roundtrip",
    "test_camera.py::test_project_unproject_roundtrip",
    "test_hashing.py::test_insert_then_lookup",
    "test_preprocess.py::test_bilateral_matches_cpu_reference",
    "test_dense.py::test_single_frame_integration_matches_analytic_sdf",
    "test_sparse.py::test_sparse_matches_analytic_sdf",
    "test_sparse.py::test_onehot_patch_gather_matches_flat_exactly",
    "test_icp.py::test_icp_recovers_small_perturbation",
    "test_mcubes.py::test_sphere_mesh_geometry_and_color",
    "test_pipeline.py::test_step_seq_matches_step",
    "test_light.py::test_sh_estimation_recovers_coeffs",
    "test_parallel.py::test_dryrun_multichip_2",
    "test_cli.py::test_cli_requires_a_source",
    "test_stress.py::test_alloc_batch_overflow_counted",
    "test_utils.py::test_horn_align_recovers_rigid_transform",
    "test_native.py::test_native_ply_roundtrip",
}


def pytest_collection_modifyitems(items):
    for item in items:
        rel = "::".join(item.nodeid.split("/")[-1].split("::")[:2])
        if rel.split("[")[0] in _QUICK:
            item.add_marker(pytest.mark.quick)
