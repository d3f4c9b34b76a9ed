"""Generate the benchmark OBJ assets (deterministic; run from repo root).

The reference ships no scene assets (only an icon), so the benchmark scenes
named in BASELINE.json are authored here: a Cornell box, a dispersion prism
scene, and a mixed-material scene. Wall normals face inward; every wall is
its own OBJ group so it can carry its own material (element = OBJ shape,
matching tinyobj/pathtracer.cpp:63-67 semantics).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def quad(f, a, b, c, d, vbase, tbase=None):
    """Two CCW triangles for quad a-b-c-d (with unit-square UVs);
    returns new vertex base."""
    for v in (a, b, c, d):
        f.write(f"v {v[0]} {v[1]} {v[2]}\n")
    if tbase is None:
        tbase = vbase
    for uv in ((0, 0), (1, 0), (1, 1), (0, 1)):
        f.write(f"vt {uv[0]} {uv[1]}\n")
    f.write(f"f {vbase}/{tbase} {vbase+1}/{tbase+1} {vbase+2}/{tbase+2}\n")
    f.write(f"f {vbase}/{tbase} {vbase+2}/{tbase+2} {vbase+3}/{tbase+3}\n")
    return vbase + 4


def box(f, lo, hi, vbase, outward=True):
    """Axis-aligned box; outward-facing CCW faces."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    corners = [
        (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
        (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1),
    ]
    faces = [
        (0, 3, 2, 1),  # z = z0 (front, -z normal)
        (4, 5, 6, 7),  # z = z1 (back, +z)
        (0, 1, 5, 4),  # y = y0 (bottom, -y)
        (3, 7, 6, 2),  # y = y1 (top, +y)
        (0, 4, 7, 3),  # x = x0 (-x)
        (1, 2, 6, 5),  # x = x1 (+x)
    ]
    for v in corners:
        f.write(f"v {v[0]} {v[1]} {v[2]}\n")
    for face in faces:
        idx = [vbase + i for i in face]
        if not outward:
            idx = idx[::-1]
        f.write(f"f {idx[0]} {idx[1]} {idx[2]}\n")
        f.write(f"f {idx[0]} {idx[2]} {idx[3]}\n")
    return vbase + 8


def make_cornell(path):
    """Cornell box: 4x4x4 interior from z=2..6, open toward the camera at -z.

    Groups: floor, ceiling, back, left, right, light, tall_block, short_block.
    Camera at the origin looking +z sees the interior through the open face.
    """
    with open(path, "w") as f:
        f.write("# Cornell box for pathtracing_spectrum_tpu benchmarks\n")
        vb = 1
        f.write("g floor\n")
        vb = quad(f, (-2, -2, 2), (-2, -2, 6), (2, -2, 6), (2, -2, 2), vb)
        f.write("g ceiling\n")
        vb = quad(f, (-2, 2, 2), (2, 2, 2), (2, 2, 6), (-2, 2, 6), vb)
        f.write("g back\n")
        vb = quad(f, (-2, -2, 6), (-2, 2, 6), (2, 2, 6), (2, -2, 6), vb)
        f.write("g left\n")
        vb = quad(f, (-2, -2, 2), (-2, 2, 2), (-2, 2, 6), (-2, -2, 6), vb)
        f.write("g right\n")
        vb = quad(f, (2, -2, 2), (2, -2, 6), (2, 2, 6), (2, 2, 2), vb)
        f.write("g light\n")
        vb = quad(f, (-0.75, 1.999, 3.25), (0.75, 1.999, 3.25),
                  (0.75, 1.999, 4.75), (-0.75, 1.999, 4.75), vb)
        f.write("g tall_block\n")
        vb = box(f, (-1.4, -2.0, 4.2), (-0.2, 0.4, 5.4), vb)
        f.write("g short_block\n")
        vb = box(f, (0.2, -2.0, 2.8), (1.5, -0.8, 4.1), vb)


def make_prism(path):
    """Glass prism on a floor inside an enclosure (dispersion scene)."""
    with open(path, "w") as f:
        f.write("# Dispersion scene: glass wedge prism + enclosure\n")
        vb = 1
        f.write("g floor\n")
        vb = quad(f, (-4, -2, 0), (-4, -2, 8), (4, -2, 8), (4, -2, 0), vb)
        f.write("g back\n")
        vb = quad(f, (-4, -2, 8), (-4, 4, 8), (4, 4, 8), (4, -2, 8), vb)
        f.write("g emitter\n")
        vb = quad(f, (-3.5, 1.0, 1.0), (-3.5, 1.6, 1.0),
                  (-3.5, 1.6, 1.6), (-3.5, 1.0, 1.6), vb)
        # triangular prism (wedge), axis along z
        f.write("g prism\n")
        a0, b0, c0 = (-1, -2, 3), (1, -2, 3), (0, 1, 3)
        a1, b1, c1 = (-1, -2, 5), (1, -2, 5), (0, 1, 5)
        for v in (a0, b0, c0, a1, b1, c1):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        # ends
        f.write(f"f {vb} {vb+2} {vb+1}\n")
        f.write(f"f {vb+3} {vb+4} {vb+5}\n")
        # sides
        f.write(f"f {vb} {vb+1} {vb+4}\nf {vb} {vb+4} {vb+3}\n")
        f.write(f"f {vb+1} {vb+2} {vb+5}\nf {vb+1} {vb+5} {vb+4}\n")
        f.write(f"f {vb+2} {vb} {vb+3}\nf {vb+2} {vb+3} {vb+5}\n")


def make_sphere(path, n_theta=24, n_phi=48):
    """UV sphere with smooth normals (textured-mesh / glossy scenes)."""
    import math
    with open(path, "w") as f:
        f.write("# UV sphere, radius 1, smooth-shaded, with UVs\n")
        f.write("g sphere\ns 1\n")
        verts = []
        for i in range(n_theta + 1):
            th = math.pi * i / n_theta
            for j in range(n_phi + 1):
                ph = 2 * math.pi * j / n_phi
                x = math.sin(th) * math.cos(ph)
                y = math.cos(th)
                z = math.sin(th) * math.sin(ph)
                verts.append((x, y, z))
                f.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
                f.write(f"vn {x:.6f} {y:.6f} {z:.6f}\n")
                f.write(f"vt {j / n_phi:.6f} {1 - i / n_theta:.6f}\n")
        def vid(i, j):
            return i * (n_phi + 1) + j + 1
        for i in range(n_theta):
            for j in range(n_phi):
                a, b = vid(i, j), vid(i, j + 1)
                c, d = vid(i + 1, j + 1), vid(i + 1, j)
                if i != 0:
                    f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
                if i != n_theta - 1:
                    f.write(f"f {a}/{a}/{a} {c}/{c}/{c} {d}/{d}/{d}\n")


def make_terrain(path, grid=128, n_rocks=24, rock_sub=12, seed=7):
    """Large-scene stress asset: displaced heightfield + scattered UV-sphere
    rocks + an emitter panel. Triangle count ~= 2*grid^2 + n_rocks*2*rock_sub^2.

    grid=128, rocks 24x12  -> ~40k tris;   grid=160, rocks 48x24 -> ~106k
    grid=192, rocks 96x24  -> ~129k;       grid=256, rocks 96x32 -> ~327k
    Spatially structured (hills occlude valleys, rocks are compact clumps) so
    hierarchical culling has real work to do — unlike a random triangle soup.
    Deterministic: numpy PRNG with a fixed seed.
    """
    import math
    import numpy as np
    rng = np.random.default_rng(seed)
    ext = 8.0                      # terrain spans [-ext, ext]^2 in x/z
    with open(path, "w") as f:
        f.write("# Procedural terrain stress scene\n")
        f.write("g terrain\ns 1\n")
        xs = np.linspace(-ext, ext, grid + 1)
        zs = np.linspace(-ext, ext, grid + 1)
        X, Z = np.meshgrid(xs, zs, indexing="ij")
        H = (1.1 * np.sin(0.7 * X) * np.cos(0.9 * Z)
             + 0.5 * np.sin(1.9 * X + 1.3) * np.sin(1.7 * Z + 0.4)
             + 0.22 * np.sin(4.3 * X + 2.0) * np.cos(3.7 * Z + 1.1))
        for i in range(grid + 1):
            for j in range(grid + 1):
                f.write(f"v {X[i, j]:.5f} {H[i, j]:.5f} {Z[i, j]:.5f}\n")

        def vid(i, j):
            return i * (grid + 1) + j + 1
        for i in range(grid):
            for j in range(grid):
                a, b = vid(i, j), vid(i + 1, j)
                c, d = vid(i + 1, j + 1), vid(i, j + 1)
                f.write(f"f {a} {b} {c}\nf {a} {c} {d}\n")
        vb = (grid + 1) * (grid + 1) + 1

        f.write("g rocks\ns 1\n")
        nt, np_ = rock_sub, 2 * rock_sub
        for _ in range(n_rocks):
            cx, cz = rng.uniform(-ext * 0.85, ext * 0.85, 2)
            hx = (1.1 * math.sin(0.7 * cx) * math.cos(0.9 * cz)
                  + 0.5 * math.sin(1.9 * cx + 1.3) * math.sin(1.7 * cz + 0.4)
                  + 0.22 * math.sin(4.3 * cx + 2.0) * math.cos(3.7 * cz + 1.1))
            r = rng.uniform(0.25, 0.7)
            cy = hx + 0.55 * r
            sq = rng.uniform(0.7, 1.3, 3)       # squash per axis
            for i in range(nt + 1):
                th = math.pi * i / nt
                for j in range(np_ + 1):
                    ph = 2 * math.pi * j / np_
                    x = math.sin(th) * math.cos(ph)
                    y = math.cos(th)
                    z = math.sin(th) * math.sin(ph)
                    f.write(f"v {cx + r * sq[0] * x:.5f} "
                            f"{cy + r * sq[1] * y:.5f} "
                            f"{cz + r * sq[2] * z:.5f}\n")
            def svid(i, j, vb=vb):
                return vb + i * (np_ + 1) + j
            for i in range(nt):
                for j in range(np_):
                    a, b = svid(i, j), svid(i, j + 1)
                    c, d = svid(i + 1, j + 1), svid(i + 1, j)
                    if i != 0:
                        f.write(f"f {a} {b} {c}\n")
                    if i != nt - 1:
                        f.write(f"f {a} {c} {d}\n")
            vb += (nt + 1) * (np_ + 1)

        f.write("g light\n")
        quad(f, (-2.5, 6.0, -2.5), (2.5, 6.0, -2.5),
             (2.5, 6.0, 2.5), (-2.5, 6.0, 2.5), vb, tbase=1)


def checker_rgba(size=128, tiles=8):
    """uint8 [size, size, 4] checkerboard (roughness/normal-map test
    input)."""
    import numpy as np
    y, x = np.mgrid[0:size, 0:size]
    checker = (((x * tiles // size) + (y * tiles // size)) % 2).astype(np.uint8)
    img = np.stack([checker * 255, checker * 200 + 55, 255 - checker * 255,
                    np.full_like(checker, 255)], axis=-1)
    return img.astype(np.uint8)


def make_checker_png(path, size=128, tiles=8):
    """Checkerboard texture as an 8-bit RGBA PNG (standard-library codec)."""
    sys.path.insert(0, os.path.dirname(HERE))
    from pathtracing_spectrum_tpu.utils.png import write_png
    write_png(path, checker_rgba(size, tiles))


if __name__ == "__main__":
    make_cornell(os.path.join(HERE, "cornell_box.obj"))
    make_prism(os.path.join(HERE, "prism.obj"))
    make_sphere(os.path.join(HERE, "sphere.obj"))
    make_checker_png(os.path.join(HERE, "checker.png"))
    make_terrain(os.path.join(HERE, "terrain_10k.obj"),
                 grid=64, n_rocks=8, rock_sub=8)
    make_terrain(os.path.join(HERE, "terrain_52k.obj"),
                 grid=128, n_rocks=36, rock_sub=12)
    make_terrain(os.path.join(HERE, "terrain_200k.obj"),
                 grid=224, n_rocks=96, rock_sub=20)
    make_terrain(os.path.join(HERE, "terrain_1m.obj"),
                 grid=672, n_rocks=64, rock_sub=24)
    print("assets written")
