"""Authoritative host-side scene graph and its device compilation.

This module plays the role of the reference's ``Previewer`` scene graph
(previewer.h:16-143 — objects, transforms, per-element materials, textures)
plus the tracer-side scene API (``PathTracer::SetMaterial/SetWaveLengths/
SetSpectrumMaterials/SetSky/InitializeSpectrumMaterials/BuildBVH``,
pathtracer.cpp:150-359). Where the reference *push-synchronises* the
previewer into the tracer by re-parsing every OBJ from disk on each render
start (previewer.cpp:707-738), this framework compiles the scene graph once
into a ``SceneData`` pytree of device arrays (with host-side OBJ caching) and
re-uses it until the scene changes.

Defaults follow the reference's ``ClearScene`` (main.cpp:342-365).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from .models.materials import Material, SpectrumMaterial
from .models import transforms
from .models.geometry import TriangleSoA, build_triangle_soa, empty_soa
from .models.camera import Camera
from .ops import planck
from .ops.texturing import build_texture_table
from .utils import obj_loader, image as image_util, tempdata


class SceneData(NamedTuple):
    """Device-resident compiled scene (a pytree of jnp arrays).

    Triangle SoA fields mirror models/geometry.TriangleSoA; material tables
    are indexed by the flat per-element material id.
    """

    # triangles [T, ...]
    tri_v1: jnp.ndarray
    tri_e1: jnp.ndarray
    tri_e2: jnp.ndarray
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_n3: jnp.ndarray
    tri_uv1: jnp.ndarray
    tri_uv2: jnp.ndarray
    tri_uv3: jnp.ndarray
    tri_face_n: jnp.ndarray
    tri_tangent: jnp.ndarray
    tri_bitangent: jnp.ndarray
    tri_d00: jnp.ndarray
    tri_d01: jnp.ndarray
    tri_d11: jnp.ndarray
    tri_inv_denom: jnp.ndarray
    tri_smoothing: jnp.ndarray   # [T] bool
    tri_material: jnp.ndarray    # [T] int32

    # intersection precompute (ops/intersect.py dot form)
    tri_k1: jnp.ndarray          # [T, 3]
    tri_k2: jnp.ndarray          # [T, 3]
    tri_k3: jnp.ndarray          # [T, 3]
    tri_consts: jnp.ndarray      # [T, 4] (v1.n, v2.K1, v1.K2, v1.K3)

    # packed per-triangle shading table (ops/shade_pack.py)
    tri_shade: jnp.ndarray       # [T, BASE + 4*nw]

    # scene root box (lo3; hi3) over all triangle vertices (reorder.py)
    root_aabb: jnp.ndarray       # [2, 3]

    # materials [M, ...]
    mat_type: jnp.ndarray        # [M] int32
    mat_rr_prob: jnp.ndarray     # [M] min(0.95, max(baseColor))
    mat_roughness: jnp.ndarray   # [M]
    mat_emissivity: jnp.ndarray  # [M, nw] baked BBP(T)*eps
    mat_reflectivity: jnp.ndarray  # [M, nw] baked BBP(T)*(1-eps)
    mat_eps_curve: jnp.ndarray   # [M, nw] raw eps_lambda (temp-map path)
    mat_normal_tex: jnp.ndarray  # [M] int32, -1 none
    mat_roughness_tex: jnp.ndarray  # [M] int32
    mat_temp_grid: jnp.ndarray   # [M] int32 index into temperature grids

    # texture tables
    textures: jnp.ndarray        # [K, Hm, Wm, 4]
    texture_sizes: jnp.ndarray   # [K, 2] (w, h)
    # static shape markers ([1] if any element binds that texture kind, else
    # [0]): jitted code skips the per-kind 2M-ray sample gather entirely when
    # nothing uses it (shape, not value, so it stays compile-time)
    normal_tex_any: jnp.ndarray
    roughness_tex_any: jnp.ndarray
    temp_grids: jnp.ndarray      # [K2, Hm2, Wm2]
    temp_grid_sizes: jnp.ndarray  # [K2, 2]

    # spectral
    wavenumbers: jnp.ndarray     # [nw]
    sky: jnp.ndarray             # [nw]

    # flat BVH (ops/bvh.py layout); single-node passthrough when unused
    bvh_node_min: jnp.ndarray    # [NN, 3]
    bvh_node_max: jnp.ndarray    # [NN, 3]
    bvh_node_skip: jnp.ndarray   # [NN] int32 miss/skip link
    bvh_node_first: jnp.ndarray  # [NN] int32 first triangle (leaves)
    bvh_node_count: jnp.ndarray  # [NN] int32 triangle count (0 = internal)

    @property
    def n_waves(self) -> int:
        return self.wavenumbers.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.tri_v1.shape[0]


@dataclasses.dataclass
class SceneElement:
    """One named sub-mesh with a material (reference previewer.h:29-63)."""

    name: str = ""
    material: Material = dataclasses.field(default_factory=Material)
    highlight: bool = False


@dataclasses.dataclass
class SceneObject:
    """One loaded OBJ instance (reference previewer.h:65-142)."""

    name: str
    filename: str
    elements: List[SceneElement] = dataclasses.field(default_factory=list)
    is_selected: bool = False
    is_scale_locked: bool = True

    _location: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    _rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    _scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))

    # -- transform accessors (previewer.cpp:644-705 semantics) --------------
    @property
    def location(self) -> np.ndarray:
        return self._location.copy()

    @property
    def rotation(self) -> np.ndarray:
        return self._rotation.copy()

    @property
    def scale(self) -> np.ndarray:
        return self._scale.copy()

    def set_location(self, v) -> None:
        self._location = np.asarray(v, np.float32).copy()

    def set_rotation(self, v) -> None:
        """Angles normalised to [0, 360) (previewer.cpp:651-667)."""
        self._rotation = np.asarray(
            transforms.normalize_rotation(tuple(np.asarray(v, np.float64))),
            np.float32)

    def set_scale(self, v, respect_lock: bool = True) -> None:
        """Clamped at 0.001; uniform-cascade when scale-locked, using the
        reference's exact first-changed-axis rule (previewer.cpp:669-705).

        ``respect_lock=False`` bypasses the lock — used by the scene loader,
        where the reference would otherwise mangle saved non-uniform scales
        (the lock flag is not persisted in .pts; parity bug not reproduced).
        """
        x, y, z = (max(float(c), 0.001) for c in v)
        if respect_lock and self.is_scale_locked:
            ox, oy, oz = (float(c) for c in self._scale)
            if ox != x:
                y = oy + oy / ox * (x - ox)
                z = oz + oz / ox * (x - ox)
            elif oy != y:
                x = ox + ox / oy * (y - oy)
                z = oz + oz / oy * (y - oy)
            elif oz != z:
                x = ox + ox / oz * (z - oz)
                y = oy + oy / oz * (z - oz)
        self._scale = np.asarray([x, y, z], np.float32)

    def model_matrix(self) -> np.ndarray:
        return transforms.model_matrix(self._location, self._rotation,
                                       self._scale)


class Scene:
    """The complete authorable scene (waves, materials, objects, camera)."""

    def __init__(self):
        self.wavelengths: List[float] = []      # wavenumbers in 1/cm
        self.spectrum_materials: List[SpectrumMaterial] = []
        self.sky_material_id: int = -1
        self.sky_temperature: float = 0.0       # deg C
        self.trace_depth: int = 3
        self.resolution: Tuple[int, int] = (1024, 768)
        self.auto_res: bool = False
        self.objects: List[SceneObject] = []
        self.camera_position: np.ndarray = np.array([0.0, 0.0, -10.0], np.float32)
        self.camera_rotation: np.ndarray = np.zeros(3, np.float32)  # deg
        self.camera_focal: float = 0.1
        self.camera_fovy: float = 90.0
        self.file_path: str = ""
        self.modified: bool = False
        self.version: int = 0  # bumped on every mutation (session resync key)
        self._mesh_cache: Dict[str, obj_loader.ObjMesh] = {}

    # -- camera (previewer.cpp:740-829) -------------------------------------
    def camera(self) -> Camera:
        d, u = transforms.camera_basis_from_rotation(self.camera_rotation)
        return Camera(tuple(self.camera_position.tolist()), tuple(d.tolist()),
                      tuple(u.tolist()), self.camera_focal, self.camera_fovy)

    def set_camera(self, position, rotation_deg=None) -> None:
        self.camera_position = np.asarray(position, np.float32).copy()
        if rotation_deg is not None:
            self.camera_rotation = np.asarray(
                transforms.normalize_rotation(tuple(rotation_deg)), np.float32)
        self.modified = True
        self.version += 1

    # -- object management (previewer.cpp:294-946) ---------------------------
    def load_object(self, path: str, name: Optional[str] = None) -> SceneObject:
        """Load an OBJ as a new scene object; elements = OBJ shapes.

        Object naming follows pathtracer.cpp:54-60 (basename sans extension).
        """
        mesh = self._load_mesh(path)
        if name is None:
            base = path.replace("\\", "/").rsplit("/", 1)[-1]
            name = base.rsplit(".", 1)[0] if "." in base else base
        obj = SceneObject(name=name, filename=path)
        for shape in mesh.shapes:
            obj.elements.append(SceneElement(name=shape.name))
        self.objects.append(obj)
        self.modified = True
        self.version += 1
        return obj

    def _load_mesh(self, path: str) -> obj_loader.ObjMesh:
        if path not in self._mesh_cache:
            mesh = obj_loader.load_obj(path)
            obj_loader.generate_smooth_normals(mesh)
            self._mesh_cache[path] = mesh
        return self._mesh_cache[path]

    def delete_selected_objects(self) -> None:
        self.objects = [o for o in self.objects if not o.is_selected]
        self.modified = True
        self.version += 1

    def replace_object(self, index: int, path: str) -> None:
        """Replace mesh, keep transform (previewer.cpp:895-911)."""
        old = self.objects[index]
        new = self.load_object(path)
        self.objects.pop()  # load_object appended; splice in place instead
        new._location, new._rotation, new._scale = (
            old._location, old._rotation, old._scale)
        self.objects[index] = new
        self.modified = True
        self.version += 1

    def rename_object(self, index: int, name: str) -> None:
        self.objects[index].name = name
        self.modified = True
        self.version += 1

    def rename_element(self, obj_id: int, element_id: int, name: str) -> None:
        """Reference SetName(objId, elementId, ...) (previewer.cpp:913-929)."""
        self.objects[obj_id].elements[element_id].name = name
        self.modified = True
        self.version += 1

    def set_highlight(self, obj_id: int, element_id: int,
                      highlight: bool) -> None:
        """Element highlight flag (previewer.cpp:842-878 GUI state)."""
        self.objects[obj_id].elements[element_id].highlight = highlight

    # -- spectrum-material library (reference left bar, main.cpp:2461-2692,
    #    import actions main.cpp:217-338) ------------------------------------
    def add_spectrum_material(self, name: Optional[str] = None,
                              emissivity: Optional[List[float]] = None) -> int:
        """Add a material to the library; returns its id.

        Defaults mirror the GUI's Add button (main.cpp:2489-2497): name
        ``Material <count>``, emissivity all zeros, one entry per wave.
        """
        if name is None:
            name = f"Material {len(self.spectrum_materials)}"
        if emissivity is None:
            emissivity = [0.0] * len(self.wavelengths)
        self.spectrum_materials.append(
            SpectrumMaterial(name, [float(e) for e in emissivity]))
        self.modified = True
        self.version += 1
        return len(self.spectrum_materials) - 1

    def delete_spectrum_materials(self, ids) -> None:
        """Remove materials by id, fixing every reference like the GUI's
        Delete action (``DeleteSelectedMaterials``, main.cpp:183-215): per
        removal, element/sky references to the removed id become -1 and
        higher ids shift down."""
        for i in sorted({int(i) for i in ids}, reverse=True):
            if not 0 <= i < len(self.spectrum_materials):
                continue
            for obj in self.objects:
                for el in obj.elements:
                    if el.material.spectrum_mat_id == i:
                        el.material.spectrum_mat_id = -1
                    elif el.material.spectrum_mat_id > i:
                        el.material.spectrum_mat_id -= 1
            if self.sky_material_id == i:
                self.sky_material_id = -1
            elif self.sky_material_id > i:
                self.sky_material_id -= 1
            del self.spectrum_materials[i]
        self.modified = True
        self.version += 1

    def rename_spectrum_material(self, i: int, name: str) -> None:
        self.spectrum_materials[i].name = name
        self.modified = True
        self.version += 1

    def set_spectrum_emissivity(self, i: int, values: List[float]) -> None:
        """Replace material ``i``'s emissivity curve (per-wave edit field,
        main.cpp:2599-2650). Values are padded/truncated to the wave count
        like the GUI's per-wave entries (one entry exists per wave)."""
        nw = len(self.wavelengths)
        vals = [float(v) for v in values][:nw]
        vals += [0.0] * (nw - len(vals))
        self.spectrum_materials[i].emissivity = vals
        self.modified = True
        self.version += 1

    def import_waves(self, waves: List[float]) -> None:
        """Replace the wavelength list with reset semantics
        (``LoadSpectrumWaves``, main.cpp:229-260): every spectrum material's
        emissivity curve is re-initialised to zeros of the new length —
        stale curves do NOT survive a wave re-import."""
        self.wavelengths = [float(w) for w in waves]
        for m in self.spectrum_materials:
            m.emissivity = [0.0] * len(self.wavelengths)
        self.modified = True
        self.version += 1

    def import_spectrum_materials(
            self, mats: List[SpectrumMaterial]) -> None:
        """Replace the material library (``LoadSpectrumMaterials``,
        main.cpp:270-338), reproducing the reference's reference-fixup loop
        *faithfully* (main.cpp:283-301): it iterates i over the old library
        applying the single-removal fixup (== i -> -1, > i -> shift down)
        M times WITHOUT removing as it goes, so an element bound to an even
        old id k ends at -1 but an odd k ends at (k-1)/2 — now pointing
        into the NEW library. A quirk, preserved for parity and documented
        here rather than silently "fixed"."""
        for i in range(len(self.spectrum_materials)):
            for obj in self.objects:
                for el in obj.elements:
                    if el.material.spectrum_mat_id == i:
                        el.material.spectrum_mat_id = -1
                    elif el.material.spectrum_mat_id > i:
                        el.material.spectrum_mat_id -= 1
            if self.sky_material_id == i:
                self.sky_material_id = -1
            elif self.sky_material_id > i:
                self.sky_material_id -= 1
        self.spectrum_materials = list(mats)
        self.modified = True
        self.version += 1

    def select_object(self, index: int, selected: bool = True) -> None:
        self.objects[index].is_selected = selected

    def set_material(self, obj_id: int, element_id: int, material: Material) -> None:
        """Assign material (reference SetMaterial, pathtracer.cpp:201-211).

        Quirk parity: the existing normal-texture binding survives material
        replacement (the reference copies ``normalTexId`` across,
        pathtracer.cpp:208); all other texture bindings travel with the
        material. Use ``set_normal_texture`` to change it.
        """
        if obj_id >= len(self.objects):
            return
        if element_id >= len(self.objects[obj_id].elements):
            return
        el = self.objects[obj_id].elements[element_id]
        keep_normal_tex = el.material.normal_tex_file
        el.material = material.copy()
        el.material.normal_tex_file = keep_normal_tex
        self.modified = True
        self.version += 1

    # -- texture binding (reference Set*TextureForElement,
    #    pathtracer.cpp:152-198, previewer push at previewer.cpp:707-738) ----
    def _element_material(self, obj_id: int, element_id: int):
        return self.objects[obj_id].elements[element_id].material

    def set_normal_texture(self, obj_id: int, element_id: int,
                           path: str) -> None:
        self._element_material(obj_id, element_id).normal_tex_file = path
        self.modified = True
        self.version += 1

    def set_roughness_texture(self, obj_id: int, element_id: int,
                              path: str) -> None:
        self._element_material(obj_id, element_id).roughness_tex_file = path
        self.modified = True
        self.version += 1

    def set_temperature_texture(self, obj_id: int, element_id: int,
                                path: str) -> None:
        """Parity: carried but never sampled by the tracer (the reference
        declares temperatureTexId and reads the ASCII grid instead)."""
        self._element_material(obj_id, element_id).temperature_tex_file = path
        self.modified = True
        self.version += 1

    def set_temperature_data(self, obj_id: int, element_id: int,
                             path: str) -> None:
        """ASCII temperature grid (reference SetTemperatureDataForElement,
        pathtracer.cpp:192-198)."""
        self._element_material(obj_id, element_id).temperature_data_file = path
        self.modified = True
        self.version += 1

    def clear(self) -> None:
        """Reset to defaults (main.cpp:342-365)."""
        self.__init__()

    def triangle_count(self) -> int:
        total = 0
        for obj in self.objects:
            try:
                mesh = self._load_mesh(obj.filename)
            except OSError:
                continue
            total += sum(s.v_idx.shape[0] for s in mesh.shapes)
        return total

    def content_digest(self) -> str:
        """Stable hash of everything that affects rendered pixels.

        Used to bind render checkpoints to the scene they came from: a
        checkpoint whose accumulator happens to match another scene's shapes
        must still refuse to resume (the reference cannot checkpoint at all,
        SURVEY §5, so this is new-framework policy, not parity). Hashes the
        authoring-level description — wavelengths, spectrum materials, sky,
        depth, per-element materials/textures, object sources + transforms,
        camera — rather than the compiled device arrays, so it is cheap and
        independent of compile-time layout choices.
        """
        import hashlib

        h = hashlib.sha1()

        def put(*parts):
            for p in parts:
                h.update(repr(p).encode())
                h.update(b"\x00")

        put("waves", [float(w) for w in self.wavelengths])
        for m in self.spectrum_materials:
            put("specmat", m.name, [float(e) for e in m.emissivity])
        put("sky", self.sky_material_id, float(self.sky_temperature))
        put("depth", self.trace_depth)
        put("cam", self.camera_position.tolist(),
            self.camera_rotation.tolist(),
            float(self.camera_focal), float(self.camera_fovy))
        for obj in self.objects:
            put("obj", obj.filename, obj._location.tolist(),
                obj._rotation.tolist(), obj._scale.tolist())
            for el in obj.elements:
                m = el.material
                put("el", int(m.type), tuple(m.base_color), float(m.roughness),
                    float(m.ior), float(m.dispersion_b), m.normal_tex_file,
                    m.roughness_tex_file, m.temperature_data_file,
                    float(m.temperature), int(m.spectrum_mat_id))
        return h.hexdigest()

    # -- compilation ---------------------------------------------------------
    def compile(self, build_bvh: bool = True, leaf_size: int = 4) -> SceneData:
        """Bake the scene into device arrays.

        Replaces SendObjectsToPathTracer + InitializeSpectrumMaterials +
        SetSky + BuildBVH (previewer.cpp:707-738, pathtracer.cpp:275-309,
        mesh.cpp:177-221) with a single host->device upload.
        """
        nw = len(self.wavelengths)
        wavenumbers = np.asarray(self.wavelengths, np.float32)

        # ---- flat material table (one row per object-element) ----
        mats: List[Material] = []
        mat_ids_per_obj: List[List[int]] = []
        for obj in self.objects:
            ids = []
            for el in obj.elements:
                ids.append(len(mats))
                mats.append(el.material)
            mat_ids_per_obj.append(ids)
        if not mats:
            mats = [Material()]
            mat_ids_per_obj = []

        m = len(mats)
        mat_type = np.array([int(mt.type) for mt in mats], np.int32)
        mat_rr = np.array(
            [min(0.95, max(mt.base_color)) for mt in mats], np.float32)
        mat_rough = np.array([mt.roughness for mt in mats], np.float32)

        eps_curve = np.zeros((m, nw), np.float32)
        emis = np.zeros((m, nw), np.float32)
        refl = np.zeros((m, nw), np.float32)
        for i, mt in enumerate(mats):
            sid = mt.spectrum_mat_id
            if sid < 0 or sid >= len(self.spectrum_materials) or nw == 0:
                continue  # stays zero (InitializeSpectrumMaterials else-branch)
            curve = np.zeros(nw, np.float32)
            src = self.spectrum_materials[sid].emissivity
            curve[:min(nw, len(src))] = np.asarray(src[:nw], np.float32)
            eps_curve[i] = curve
            t = mt.clamped_temperature()
            emis[i] = planck.bake_emissivity_np(curve, t, wavenumbers)
            refl[i] = planck.bake_reflectivity_np(curve, t, wavenumbers)

        # ---- textures & temperature grids ----
        tex_images: List[np.ndarray] = []
        tex_index: Dict[str, int] = {}
        grid_images: List[np.ndarray] = []
        grid_index: Dict[str, int] = {}

        def tex_id(path: str) -> int:
            if not path:
                return -1
            if path not in tex_index:
                img = image_util.load_rgba(path)
                if img is None:
                    tex_index[path] = -1
                else:
                    tex_index[path] = len(tex_images)
                    tex_images.append(img)
            return tex_index[path]

        def grid_id(path: str) -> int:
            if not path:
                return -1
            if path not in grid_index:
                g = tempdata.load_temperature_grid(path)
                if g is None:
                    grid_index[path] = -1
                else:
                    grid_index[path] = len(grid_images)
                    grid_images.append(g)
            return grid_index[path]

        mat_ntex = np.array([tex_id(mt.normal_tex_file) for mt in mats], np.int32)
        mat_rtex = np.array([tex_id(mt.roughness_tex_file) for mt in mats], np.int32)
        # Temperature-grid re-bake requires a spectrum material: the reference
        # would index mSpectrumMaterials[-1] (UB, pathtracer.cpp:525-527);
        # we disable the override instead.
        mat_grid = np.array(
            [grid_id(mt.temperature_data_file) if mt.spectrum_mat_id >= 0 else -1
             for mt in mats], np.int32)

        textures, tex_sizes = build_texture_table(tex_images, channels=4)
        grids, grid_sizes = build_texture_table(grid_images, channels=0)

        # ---- triangles ----
        parts: List[TriangleSoA] = []
        for obj, ids in zip(self.objects, mat_ids_per_obj):
            try:
                mesh = self._load_mesh(obj.filename)
            except OSError:
                continue  # fail-soft like the reference's parsers
            parts.append(build_triangle_soa(mesh, obj.model_matrix(), ids))
        soa = TriangleSoA.concatenate(parts) if parts else empty_soa()

        # ---- BVH ----
        from .ops import bvh as bvh_mod
        if build_bvh and soa.count > 0:
            flat = bvh_mod.build_bvh(soa, leaf_size=leaf_size)
            soa = soa.gather(flat.tri_order)
            node_min, node_max = flat.node_min, flat.node_max
            node_skip, node_first, node_count = (
                flat.node_skip, flat.node_first, flat.node_count)
        else:
            t = max(soa.count, 1)
            node_min = np.full((1, 3), -np.inf, np.float32)
            node_max = np.full((1, 3), np.inf, np.float32)
            node_skip = np.array([1], np.int32)
            node_first = np.array([0], np.int32)
            node_count = np.array([soa.count], np.int32)

        if soa.count == 0:  # keep shapes non-empty & static
            soa = _degenerate_tri_soa()

        # ---- sky (pathtracer.cpp:297-309) ----
        if (self.sky_material_id < 0
                or self.sky_material_id >= len(self.spectrum_materials)
                or nw == 0):
            sky = np.zeros(nw, np.float32)
        else:
            curve = np.zeros(nw, np.float32)
            src = self.spectrum_materials[self.sky_material_id].emissivity
            curve[:min(nw, len(src))] = np.asarray(src[:nw], np.float32)
            sky = planck.bake_emissivity_np(curve, self.sky_temperature,
                                            wavenumbers)

        # Intersection precompute (ops/intersect.py): per-triangle constant
        # vectors that turn the same-side tests into plain dots.
        from .ops.intersect import precompute_intersect_tables
        k1, k2, k3, consts = precompute_intersect_tables(
            soa.v1, soa.e1, soa.e2, soa.face_n)

        # Per-wavelength Cauchy IOR curve for dispersion mode:
        # n(v) = ior + B / lambda_um^2, lambda_um = 1e4 / v (v in 1/cm).
        with np.errstate(divide="ignore"):
            lam_um = np.where(wavenumbers > 0, 1e4 / np.where(
                wavenumbers > 0, wavenumbers, 1.0), np.inf)
        ior_curve = np.stack([
            np.full(nw, mt.ior, np.float32)
            + np.float32(mt.dispersion_b) / (lam_um * lam_um)
            for mt in mats]).astype(np.float32) if nw else np.zeros(
                (m, 0), np.float32)

        v1d = soa.v1.astype(np.float64)
        verts = np.concatenate([v1d, v1d + soa.e1, v1d + soa.e2])
        root_aabb = np.stack([verts.min(axis=0),
                              verts.max(axis=0)]).astype(np.float32)

        from .ops.shade_pack import pack_shade_table
        tri_shade = pack_shade_table(soa, mat_type, mat_rr, mat_rough,
                                     mat_ntex, mat_rtex, mat_grid,
                                     emis, refl, eps_curve, ior_curve,
                                     tex_sizes, grid_sizes)

        dev = np.asarray
        data = SceneData(
            tri_v1=dev(soa.v1), tri_e1=dev(soa.e1), tri_e2=dev(soa.e2),
            tri_n1=dev(soa.n1), tri_n2=dev(soa.n2), tri_n3=dev(soa.n3),
            tri_uv1=dev(soa.uv1), tri_uv2=dev(soa.uv2), tri_uv3=dev(soa.uv3),
            tri_face_n=dev(soa.face_n), tri_tangent=dev(soa.tangent),
            tri_bitangent=dev(soa.bitangent),
            tri_d00=dev(soa.d00), tri_d01=dev(soa.d01), tri_d11=dev(soa.d11),
            tri_inv_denom=dev(soa.inv_denom),
            tri_smoothing=dev(soa.smoothing),
            tri_material=dev(soa.material_id),
            tri_k1=dev(k1), tri_k2=dev(k2), tri_k3=dev(k3),
            tri_consts=dev(consts), tri_shade=dev(tri_shade),
            root_aabb=dev(root_aabb),
            mat_type=dev(mat_type), mat_rr_prob=dev(mat_rr),
            mat_roughness=dev(mat_rough),
            mat_emissivity=dev(emis), mat_reflectivity=dev(refl),
            mat_eps_curve=dev(eps_curve),
            mat_normal_tex=dev(mat_ntex), mat_roughness_tex=dev(mat_rtex),
            mat_temp_grid=dev(mat_grid),
            textures=dev(textures), texture_sizes=dev(tex_sizes),
            normal_tex_any=np.zeros((int((mat_ntex >= 0).any()),), np.float32),
            roughness_tex_any=np.zeros((int((mat_rtex >= 0).any()),),
                                       np.float32),
            temp_grids=dev(grids), temp_grid_sizes=dev(grid_sizes),
            wavenumbers=dev(wavenumbers), sky=dev(sky.astype(np.float32)),
            bvh_node_min=dev(node_min), bvh_node_max=dev(node_max),
            bvh_node_skip=dev(node_skip), bvh_node_first=dev(node_first),
            bvh_node_count=dev(node_count),
        )
        # Single host->device upload; keeping the whole build in numpy avoids
        # one eager device dispatch per op.
        import jax
        return jax.device_put(data)


def _degenerate_tri_soa() -> TriangleSoA:
    """A single zero-area triangle that can never be hit (denom == 0)."""
    z3 = np.zeros((1, 3), np.float32)
    z2 = np.zeros((1, 2), np.float32)
    z1 = np.zeros((1,), np.float32)
    return TriangleSoA(v1=z3, e1=z3, e2=z3, n1=z3, n2=z3, n3=z3,
                       uv1=z2, uv2=z2, uv3=z2, face_n=z3,
                       tangent=z3, bitangent=z3,
                       d00=z1, d01=z1, d11=z1, inv_denom=z1,
                       smoothing=np.zeros((1,), bool),
                       material_id=np.zeros((1,), np.int32))
