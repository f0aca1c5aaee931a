"""ctypes bindings for the native runtime (decode/prefetch/PLY).

Built with ``python -m vulcan_tpu.native.build`` (or lazily on first use)
from ``src/native.cpp`` into this package directory; needs g++ (C++17)
and the libpng/zlib development headers.  TUM PNG decoding requires it;
the PLY writer falls back to Python without it.  The prefetching loader
overlaps host-side IO with device compute (SURVEY.md §7: double-buffer
frame upload), matching the reference's C++ runtime with a C++ runtime.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_DIR = os.path.dirname(__file__)
_LIB_PATH = os.path.join(_DIR, "libvulcan_native.so")
_lib = None
_build_attempted = False


def build(verbose: bool = False) -> bool:
    """Compile the native library in-place. Returns success."""
    src = os.path.join(_DIR, "src", "native.cpp")
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        src, "-o", _LIB_PATH, "-lpng", "-lz", "-lpthread",
    ]
    try:
        res = subprocess.run(
            cmd, capture_output=True, text=True, timeout=300
        )
        if res.returncode != 0:
            if verbose:
                print(res.stderr, file=sys.stderr)
            return False
        return True
    except Exception:
        return False


def _load():
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build_attempted:
        _build_attempted = True
        build()
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.vt_png_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vt_png_probe.restype = ctypes.c_int
    lib.vt_decode_depth.argtypes = [
        ctypes.c_char_p, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    lib.vt_decode_depth.restype = ctypes.c_int
    lib.vt_decode_rgb.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    lib.vt_decode_rgb.restype = ctypes.c_int
    lib.vt_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.vt_loader_create.restype = ctypes.c_void_p
    lib.vt_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.vt_loader_next.restype = ctypes.c_int
    lib.vt_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.vt_ply_write.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_int, ctypes.c_float,
    ]
    lib.vt_ply_write.restype = ctypes.c_long
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def png_probe(path: str):
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.vt_png_probe(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"png probe failed: {path}")
    return w.value, h.value


def decode_depth(path: str, width: int, height: int, scale: float = 5000.0):
    import numpy as np

    lib = _load()
    out = np.empty((height, width), np.float32)
    rc = lib.vt_decode_depth(
        path.encode(), scale,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), width, height,
    )
    if rc != 0:
        raise IOError(f"depth decode failed ({rc}): {path}")
    return out


def decode_rgb(path: str, width: int, height: int):
    import numpy as np

    lib = _load()
    out = np.empty((height, width, 3), np.float32)
    rc = lib.vt_decode_rgb(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), width, height,
    )
    if rc != 0:
        raise IOError(f"rgb decode failed ({rc}): {path}")
    return out


class PrefetchLoader:
    """Background-thread frame decoder with a bounded ring buffer."""

    def __init__(
        self,
        depth_paths: list[str],
        rgb_paths: list[str | None],
        width: int,
        height: int,
        depth_scale: float = 5000.0,
        capacity: int = 4,
        n_threads: int = 2,
    ):
        import numpy as np

        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        n = len(depth_paths)
        self._dp = (ctypes.c_char_p * n)(
            *[p.encode() for p in depth_paths]
        )
        self._rp = (ctypes.c_char_p * n)(
            *[(p.encode() if p else None) for p in rgb_paths]
        )
        self.width = width
        self.height = height
        self.n = n
        self._handle = lib.vt_loader_create(
            self._dp, self._rp, n, width, height, depth_scale,
            capacity, n_threads,
        )
        self._lib = lib
        self._np = np

    def __iter__(self):
        np = self._np
        while True:
            depth = np.empty((self.height, self.width), np.float32)
            color = np.empty((self.height, self.width, 3), np.float32)
            rc = self._lib.vt_loader_next(
                self._handle,
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                color.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            if rc == 1:
                return
            if rc == 2:
                raise IOError("frame decode failed")
            yield depth, color

    def close(self):
        if self._handle:
            self._lib.vt_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def ply_write(
    path: str,
    positions,
    colors,
    weld: bool = True,
    weld_resolution: float = 1e-5,
) -> int:
    """Native PLY export; returns welded vertex count."""
    import numpy as np

    lib = _load()
    pos = np.ascontiguousarray(positions, np.float32)
    col = np.ascontiguousarray(colors, np.float32)
    n_tris = pos.size // 9
    rc = lib.vt_ply_write(
        path.encode(),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_tris, int(weld), weld_resolution,
    )
    if rc < 0:
        raise IOError(f"ply write failed: {path}")
    return int(rc)
