"""Runtime setup: persistent compilation cache and host->device prefetch.

Call ``setup_cache()`` before the first jit -- the CLI, bench and
``chip_smoke.py`` all do -- so the production step's multi-second compile
is paid once per cache directory.
"""
from __future__ import annotations

import os

_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))), ".jax_cache"
)


def setup_cache() -> None:
    """Enable JAX's persistent compilation cache.

    ``JAX_COMPILATION_CACHE_DIR``, when set, names the directory: JAX
    reads it itself and no other directory is set here.  Otherwise the
    cache lives at the fixed ``<checkout>/.jax_cache`` (a fixed path:
    the cache key includes it, so a moving directory would never hit).
    ``VULCAN_TPU_CACHE=""`` (empty) turns the cache off; the CPU test
    suite does, since its compiles are cheap."""
    import jax

    if os.environ.get("VULCAN_TPU_CACHE") == "":
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(_DEFAULT_CACHE, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def require_gpu():
    """JAX's devices, after checking that they are GPUs.

    Measurements and the chip smoke test never fall back to the CPU: a
    number taken there would say nothing about the card."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default devices are {devices[0].platform!r} "
            f"({devices[0].device_kind}); this needs a CUDA GPU"
        )
    return devices


def card_info() -> list[tuple[str, str]]:
    """``(name, power.limit)`` of every card, as ``nvidia-smi`` reports
    them.  Runs ``nvidia-smi`` as a child process (it does not touch the
    card's memory, unlike a second JAX process would)."""
    import subprocess

    out = subprocess.run(
        [
            "nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [
        tuple(field.strip() for field in line.split(",", 1))
        for line in out.strip().splitlines()
    ]


def device_record() -> dict:
    """The device a measurement ran on: JAX's view (platform, kind, count)
    and the card's name and power limit.  Raises without a GPU."""
    devices = require_gpu()
    name, power = card_info()[0]
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": name,
        "power_limit": power,
    }


def prefetch_to_device(iterator, lookahead: int = 2):
    """Yield items from ``iterator`` with their leading arrays already
    `jax.device_put` -- the async H2D upload of frame i+1..i+lookahead
    overlaps device compute of frame i, taking the host feed off the
    per-frame critical path.

    Items are tuples; array leaves are device_put, non-arrays pass
    through untouched.
    """
    import collections

    import jax
    import numpy as np

    def put(item):
        return tuple(
            jax.device_put(x)
            if isinstance(x, (np.ndarray, jax.Array))
            else x
            for x in item
        )

    queue = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(lookahead):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield out
