"""Packed per-triangle shading table.

After the closest-hit pass every ray needs ~15 per-triangle / per-material
attributes. Packing every attribute into ONE [T, F] float32 table turns
the whole fetch into a single row gather of the columns a configuration
reads (engine._fetch_attrs_t), instead of 12+ separate gathers per bounce.

Layout (F = BASE + 4*nw):
  v1[0:3] e1[3:6] e2[6:9] n1[9:12] n2[12:15] n3[15:18]
  uv1[18:20] uv2[20:22] uv3[22:24] face_n[24:27] tangent[27:30]
  bitangent[30:33] d00[33] d01[34] d11[35] inv_denom[36] smoothing[37]
  mat_type[38] rr_prob[39] roughness[40] normal_tex[41] roughness_tex[42]
  temp_grid[43] normal_tex_wh[44:46] roughness_tex_wh[46:48]
  temp_grid_wh[48:50] emissivity[50:50+nw] reflectivity[+nw] eps_curve[+nw]
  ior_curve[+nw] (per-wavelength Cauchy index, dispersion mode)

Texture sizes ride in the table so they arrive with the same row gather
instead of a separate per-ray ``sizes[tid]`` gather each.

Int-valued columns (type, texture ids, smoothing) are stored as float32 —
exact for the small ranges involved — and compared as floats in the engine.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

BASE = 50


def layout(nw: int) -> Dict[str, slice]:
    o = BASE
    return {
        "v1": slice(0, 3), "e1": slice(3, 6), "e2": slice(6, 9),
        "n1": slice(9, 12), "n2": slice(12, 15), "n3": slice(15, 18),
        "uv1": slice(18, 20), "uv2": slice(20, 22), "uv3": slice(22, 24),
        "face_n": slice(24, 27), "tangent": slice(27, 30),
        "bitangent": slice(30, 33),
        "d00": slice(33, 34), "d01": slice(34, 35), "d11": slice(35, 36),
        "inv_denom": slice(36, 37), "smoothing": slice(37, 38),
        "mat_type": slice(38, 39), "rr_prob": slice(39, 40),
        "roughness": slice(40, 41), "normal_tex": slice(41, 42),
        "roughness_tex": slice(42, 43), "temp_grid": slice(43, 44),
        "normal_tex_wh": slice(44, 46), "roughness_tex_wh": slice(46, 48),
        "temp_grid_wh": slice(48, 50),
        "emissivity": slice(o, o + nw),
        "reflectivity": slice(o + nw, o + 2 * nw),
        "eps_curve": slice(o + 2 * nw, o + 3 * nw),
        "ior_curve": slice(o + 3 * nw, o + 4 * nw),
    }


def pack_shade_table(soa, mat_type, mat_rr, mat_rough, mat_ntex, mat_rtex,
                     mat_grid, emis, refl, eps_curve, ior_curve,
                     tex_sizes, grid_sizes) -> np.ndarray:
    """Build the [T, BASE + 4*nw] table from the triangle SoA + material rows."""
    t = soa.count
    nw = emis.shape[1]
    f = BASE + 4 * nw
    out = np.zeros((t, f), np.float32)
    lay = layout(nw)
    mid = soa.material_id
    out[:, lay["v1"]] = soa.v1
    out[:, lay["e1"]] = soa.e1
    out[:, lay["e2"]] = soa.e2
    out[:, lay["n1"]] = soa.n1
    out[:, lay["n2"]] = soa.n2
    out[:, lay["n3"]] = soa.n3
    out[:, lay["uv1"]] = soa.uv1
    out[:, lay["uv2"]] = soa.uv2
    out[:, lay["uv3"]] = soa.uv3
    out[:, lay["face_n"]] = soa.face_n
    out[:, lay["tangent"]] = soa.tangent
    out[:, lay["bitangent"]] = soa.bitangent
    out[:, lay["d00"]] = soa.d00[:, None]
    out[:, lay["d01"]] = soa.d01[:, None]
    out[:, lay["d11"]] = soa.d11[:, None]
    out[:, lay["inv_denom"]] = soa.inv_denom[:, None]
    out[:, lay["smoothing"]] = soa.smoothing[:, None].astype(np.float32)
    out[:, lay["mat_type"]] = mat_type[mid][:, None].astype(np.float32)
    out[:, lay["rr_prob"]] = mat_rr[mid][:, None]
    out[:, lay["roughness"]] = mat_rough[mid][:, None]
    out[:, lay["normal_tex"]] = mat_ntex[mid][:, None].astype(np.float32)
    out[:, lay["roughness_tex"]] = mat_rtex[mid][:, None].astype(np.float32)
    out[:, lay["temp_grid"]] = mat_grid[mid][:, None].astype(np.float32)

    def wh(ids, sizes):
        safe = np.maximum(ids, 0)
        w = sizes[safe, 0] if sizes.shape[0] else np.zeros_like(safe)
        h = sizes[safe, 1] if sizes.shape[0] else np.zeros_like(safe)
        return np.stack([w, h], axis=1).astype(np.float32)

    out[:, lay["normal_tex_wh"]] = wh(mat_ntex[mid], tex_sizes)
    out[:, lay["roughness_tex_wh"]] = wh(mat_rtex[mid], tex_sizes)
    out[:, lay["temp_grid_wh"]] = wh(mat_grid[mid], grid_sizes)
    out[:, lay["emissivity"]] = emis[mid]
    out[:, lay["reflectivity"]] = refl[mid]
    out[:, lay["eps_curve"]] = eps_curve[mid]
    out[:, lay["ior_curve"]] = ior_curve[mid]
    return out
