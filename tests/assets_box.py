"""Tiny generated assets used only by tests."""

import os
import tempfile

_CACHE = {}


def inward_box_obj() -> str:
    """A 4x4x4 box centred at origin with inward-facing normals."""
    if "inward_box" in _CACHE:
        return _CACHE["inward_box"]
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets"))
    from make_assets import box
    path = os.path.join(tempfile.gettempdir(), "pts_inward_box.obj")
    with open(path, "w") as f:
        f.write("g walls\n")
        box(f, (-2, -2, -2), (2, 2, 2), 1, outward=False)
    _CACHE["inward_box"] = path
    return path
