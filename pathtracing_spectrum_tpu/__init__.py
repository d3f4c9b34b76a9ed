"""Spectral path-tracing framework on JAX (CPU or GPU).

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
JCSaltFish/PathTracing-Spectrum (an interactive C++/OpenMP thermal-infrared
spectral path tracer): spectral materials with Planck blackbody emission,
four surface models, progressive Monte-Carlo rendering, scene files, and
ASCII spectral import/export — built wavefront-first for an accelerator.
"""

from .constants import EPS, INF, SCENE_FILE_VERSION, __version__
from .models.materials import Material, MaterialType, SpectrumMaterial
from .models.camera import Camera, camera_rays
from .scene import Scene, SceneData, SceneElement, SceneObject
from .engine import render_sample, trace_radiance
from .ops.wave import Wave

__all__ = [
    "EPS", "INF", "SCENE_FILE_VERSION", "__version__",
    "Material", "MaterialType", "SpectrumMaterial",
    "Camera", "camera_rays",
    "Scene", "SceneData", "SceneElement", "SceneObject",
    "render_sample", "trace_radiance",
    "Wave",
]
