"""Runtime plumbing: compile-cache placement, the benchmark's trace
reduction, the smoke test's device check and the f32 precision audit."""
import jax
import jax.numpy as jnp
import pytest

from vulcan_tpu.utils import runtime

_CACHE_KEYS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_compile_time_secs",
    "jax_persistent_cache_min_entry_size_bytes",
)


@pytest.mark.parametrize("env_dir", [True, False])
def test_setup_cache_placement(env_dir, tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, setup_cache leaves the cache
    directory to JAX (that variable) and creates nothing else; without
    it, the cache goes to the fixed checkout directory."""
    default = tmp_path / "checkout_cache"
    monkeypatch.setattr(runtime, "_DEFAULT_CACHE", str(default))
    monkeypatch.delenv("VULCAN_TPU_CACHE", raising=False)
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        if env_dir:
            outside = str(tmp_path / "from_env")
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", outside)
            jax.config.update("jax_compilation_cache_dir", outside)
            runtime.setup_cache()
            assert jax.config.jax_compilation_cache_dir == outside
            assert not default.exists()
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            runtime.setup_cache()
            assert jax.config.jax_compilation_cache_dir == str(default)
            assert default.is_dir()
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.5
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def test_setup_cache_off_switch(tmp_path, monkeypatch):
    """VULCAN_TPU_CACHE="" (the CPU test suite's setting) leaves the
    cache off and creates no directory."""
    default = tmp_path / "checkout_cache"
    monkeypatch.setattr(runtime, "_DEFAULT_CACHE", str(default))
    monkeypatch.setenv("VULCAN_TPU_CACHE", "")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    runtime.setup_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert not default.exists()


def _xspace(planes):
    """Text-proto XSpace with ``planes`` = [(name, [[(start_ps, dur_ps)]
    per line])]; every event is named "kernel"."""
    out = []
    for pid, (name, lines) in enumerate(planes, 1):
        body = [f'id: {pid} name: "{name}"']
        for lid, events in enumerate(lines, 1):
            evs = " ".join(
                f"events {{ metadata_id: 1 offset_ps: {s} duration_ps: {d} }}"
                for s, d in events
            )
            body.append(
                f'lines {{ id: {lid} name: "Stream #{lid}" timestamp_ns: 0 '
                f"{evs} }}"
            )
        body.append('event_metadata { key: 1 value { id: 1 name: "kernel" } }')
        out.append("planes { " + " ".join(body) + " }")
    return jax.profiler.ProfileData.from_text_proto("\n".join(out))


@pytest.mark.parametrize("with_gpu_plane", [True, False])
def test_device_busy_reduction(with_gpu_plane):
    """bench.device_busy_ns reads only /device:GPU:* planes, merges
    overlapping kernels across streams, and raises on a trace with no
    GPU plane instead of reporting a time."""
    from bench import device_busy_ns

    host = ("/host:CPU", [[(0, 9_000_000_000)]])
    if not with_gpu_plane:
        with pytest.raises(RuntimeError, match="no GPU device plane"):
            device_busy_ns(_xspace([host]))
        return
    # Stream 1: [0, 4) and [10, 12) us; stream 2 overlaps: [3, 6) us.
    gpu = ("/device:GPU:0", [
        [(0, 4_000_000), (10_000_000, 2_000_000)],
        [(3_000_000, 3_000_000)],
    ])
    assert device_busy_ns(_xspace([host, gpu])) == pytest.approx(8_000.0)


def test_smoke_device_check_refuses_cpu(capsys):
    """chip_smoke's device check raises on the CPU backend and so never
    reaches the "ok" line."""
    import chip_smoke

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device()
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["depth", "combined"])
def test_step_has_no_f32_dot_without_precision(mode):
    """Every f32 matrix product on the online step names its precision:
    on the GPU an unspecified one may run in TF32 (chip_smoke.py repeats
    this audit at the production configuration)."""
    from chip_smoke import dots_without_precision
    from vulcan_tpu.config import TINY
    from vulcan_tpu.core.camera import PinholeCamera
    from vulcan_tpu.pipeline import fusion

    cam = PinholeCamera.create(100.0, 100.0, 79.5, 59.5)
    state = fusion.init_state(TINY, cam, 120, 160)
    jaxpr = jax.make_jaxpr(
        lambda s, d, c: fusion._step_impl(s, d, c, TINY, mode)
    )(state, jnp.zeros((120, 160)), jnp.zeros((120, 160, 3)))
    assert dots_without_precision(jaxpr) == []
    # The audit does see an unannotated f32 product.
    loose = jax.make_jaxpr(lambda x: jnp.dot(x, x))(jnp.ones(6))
    assert len(dots_without_precision(loose)) == 1


@pytest.mark.chip
def test_onehot_byte_gathers_exact_on_gpu(gpu):
    """The bf16 one-hot matmul gathers stay bit-exact when XLA compiles
    them for the GPU, at the production widths."""
    import chip_smoke
    from vulcan_tpu.config import Config

    config = Config()
    assert chip_smoke.pack_surfels_mismatches(config.integrate_chunk, config) == 0
    assert chip_smoke.select_rgb_mismatches(2048, config.surfel_slots // 2) == 0
