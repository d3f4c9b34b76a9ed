"""Raster-preview analog: headlight-shaded preview render and picking.

The reference's interactive previewer draws the scene with a two-pass GL
pipeline (shaders.h:54-125): pass 0 shades with a headlight diffuse term
(``color * max(dot(n, l), 0)`` with the normal flipped toward the eye),
pass 1 writes (objectId, elementId) into a float attachment that mouse
picking reads back (main.cpp:3666-3691). Per element the shade color is the
material baseColor, overridden by the highlight color when the element is
highlighted, else the selection color when its object is selected
(main.cpp:3333-3338; defaults at main.cpp:136-138). Headless equivalent:
one primary-ray intersection pass produces

* ``preview_render`` — a grayscale headlight shading (the authoring view,
  independent of the spectral result), or an RGB image with the reference's
  baseColor/highlight/selection tinting when ``rgb=True``, and
* ``pick`` — object/element ids under a pixel.

Both run through the same compiled SceneData and intersection kernels as
the tracer (engine.make_intersector — dense sweep or BVH by scene
size), so previews of 100k+-triangle scenes stay
interactive and what you pick is exactly what you trace.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .engine import make_intersector
from .models.camera import camera_rays, tile_order
from .scene import Scene, SceneData

_AMBIENT = 0.3  # shading floor so unlit faces stay visible (ours, not ref)

# Reference default preview colors (main.cpp:136-138); the reference's
# settings panel can change them at runtime — pass overrides to
# preview_render for the same effect.
HIGHLIGHT_COLOR = (0.9, 0.9, 0.1)
SELECTION_COLOR = (0.1, 0.7, 0.9)
BG_COLOR = (0.0, 0.0, 0.0)


def _element_table(scene: Scene) -> np.ndarray:
    """[M, 2] (object_id, element_id) per flat material index."""
    rows = []
    for oi, obj in enumerate(scene.objects):
        for ei in range(len(obj.elements)):
            rows.append((oi, ei))
    if not rows:
        rows = [(-1, -1)]
    return np.asarray(rows, np.int32)


def _tint_table(scene: Scene, highlight_color, selection_color) -> np.ndarray:
    """[M, 3] per-material shade color with the reference's override order
    (element.highlight beats object.isSelected beats baseColor,
    main.cpp:3333-3338)."""
    rows = []
    for obj in scene.objects:
        for el in obj.elements:
            if el.highlight:
                rows.append(highlight_color)
            elif obj.is_selected:
                rows.append(selection_color)
            else:
                rows.append(tuple(el.material.base_color))
    if not rows:
        rows = [(0.0, 0.0, 0.0)]
    return np.asarray(rows, np.float32)


@functools.partial(jax.jit, static_argnames=("backend",))
def _preview_shade(scene_data: SceneData, ro, rd, tint, bg,
                   backend: str = "auto"):
    """One primary intersection + headlight shade; returns [N, 3] f32."""
    intersect, _ = make_intersector(scene_data, backend)
    hit, t, idx, _, _ = intersect(ro[:, 0], ro[:, 1], ro[:, 2],
                                  rd[:, 0], rd[:, 1], rd[:, 2])
    n = scene_data.tri_face_n[idx]
    # headlight: l = -view direction; the flipped normal makes dot >= 0
    shade = jnp.maximum(jnp.abs(jnp.sum(n * rd, axis=-1)), _AMBIENT)
    color = tint[scene_data.tri_material[idx]]          # [N, 3]
    img = jnp.where(hit[:, None], color * shade[:, None], bg[None, :])
    return img


def _primary_pass(scene: Scene, scene_data: Optional[SceneData], width: int,
                  height: int, tint: np.ndarray, bg):
    scene_data = scene_data if scene_data is not None else scene.compile()
    ro, rd = camera_rays(scene.camera(), width, height)
    # tile order keeps kernel ray blocks screen-coherent (block culling)
    perm, inv = tile_order(width, height)
    ro = jnp.asarray(np.asarray(ro)[perm])
    rd = jnp.asarray(np.asarray(rd)[perm])
    img = _preview_shade(scene_data, ro, rd, jnp.asarray(tint),
                         jnp.asarray(bg, jnp.float32))
    return np.asarray(img)[inv]


def preview_render(scene: Scene, width: int, height: int,
                   scene_data: SceneData = None, rgb: bool = False,
                   highlight_color=HIGHLIGHT_COLOR,
                   selection_color=SELECTION_COLOR,
                   bg_color=BG_COLOR) -> np.ndarray:
    """Headlight-diffuse preview image.

    ``rgb=False``: uint8 [H, W] grayscale (shading only, ignores tint).
    ``rgb=True``: uint8 [H, W, 3] with the reference's per-element
    baseColor/highlight/selection coloring (main.cpp:3333-3338).
    """
    if rgb:
        tint = _tint_table(scene, highlight_color, selection_color)
        img = _primary_pass(scene, scene_data, width, height, tint,
                            np.asarray(bg_color, np.float32))
        return (np.clip(img * 255.0, 0, 255).astype(np.uint8)
                .reshape(height, width, 3))
    tint = np.ones((max(1, _element_table(scene).shape[0]), 3), np.float32)
    img = _primary_pass(scene, scene_data, width, height, tint,
                        np.zeros(3, np.float32))
    return (np.clip(img[:, 0] * 255.0, 0, 255).astype(np.uint8)
            .reshape(height, width))


def pick(scene: Scene, width: int, height: int, x: int, y: int,
         scene_data: SceneData = None) -> Tuple[int, int]:
    """(object_id, element_id) under pixel (x, y); (-1, -1) on miss.

    Mirrors the reference's pick-attachment readback (ids offset by one so 0
    means background, main.cpp:3682-3691) but returns plain 0-based ids.
    Only the picked ray is traced (the reference rasterises the whole pick
    buffer; a single kernel call on one ray is the headless equivalent).
    """
    scene_data = scene_data if scene_data is not None else scene.compile()
    ro, rd = camera_rays(scene.camera(), width, height)
    pixel = y * width + x
    ro1 = jnp.asarray(np.asarray(ro)[pixel:pixel + 1])
    rd1 = jnp.asarray(np.asarray(rd)[pixel:pixel + 1])
    intersect, _ = make_intersector(scene_data, "auto")
    hit, t, idx, _, _ = intersect(ro1[:, 0], ro1[:, 1], ro1[:, 2],
                                  rd1[:, 0], rd1[:, 1], rd1[:, 2])
    if not bool(hit[0]):
        return (-1, -1)
    mat = int(scene_data.tri_material[idx[0]])
    table = _element_table(scene)
    if mat >= table.shape[0]:
        return (-1, -1)
    return int(table[mat, 0]), int(table[mat, 1])
