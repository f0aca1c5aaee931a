"""vulcan-tpu: dense RGB-D 3D reconstruction in JAX.

A JAX/XLA framework with the capabilities of the CUDA
reference pipeline mkaspr/Vulcan (InfiniTAM-style TSDF fusion; see
SURVEY.md): bilateral depth preprocessing, voxel-block-hashed TSDF+color
fusion, per-pixel raycast rendering, frame-to-model projective ICP, and
colored marching-cubes extraction -- exposed through the reference's
five-class API plus an online Pipeline driver.
"""

from .config import Config
from .core.camera import PinholeCamera
from .core.frame import Frame, make_frame
from .core.se3 import SE3
from .ops.light import Light
from .pipeline.api import (
    ColorTracker,
    DepthTracker,
    Extractor,
    Integrator,
    LightTracker,
    Pipeline,
    Tracer,
    Tracker,
    Volume,
)

__version__ = "0.1.0"

__all__ = [
    "Config",
    "PinholeCamera",
    "Frame",
    "make_frame",
    "SE3",
    "Volume",
    "Integrator",
    "Tracer",
    "Tracker",
    "DepthTracker",
    "ColorTracker",
    "LightTracker",
    "Light",
    "Extractor",
    "Pipeline",
]
