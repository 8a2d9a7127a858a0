# Frozen copy of scripts/gen_hall.py at commit eea2a64cd0196306bd927c9d58cc9bb86ca59de2,
# kept here so that later changes to the repository do not move the benchmark's hall.
"""Procedural concert-hall mesh generator for the north-star benchmark.

The reference ships no scene larger than vault (1,458 faces,
/root/reference/demo/assets/test_models/); the driver-set workload
(BASELINE.json config 4) needs a 100k+ triangle hall. This generates a
watertight hall:

  - a box of WIDTH x HEIGHT x DEPTH metres
  - every wall subdivided into a regular grid, vertices displaced along
    the wall normal by a smooth sum of sinusoids (acoustic diffusor
    relief); displacement is continuous and vanishes on wall edges, so
    adjacent walls stay stitched and the mesh stays closed
  - deterministic: same arguments, same file

Usage:
    python scripts/gen_hall.py out.obj --triangles 100000
"""

from __future__ import annotations

import argparse
import math
import os


WIDTH, HEIGHT, DEPTH = 40.0, 18.0, 28.0  # metres, a large concert hall
RELIEF = 0.6  # max displacement amplitude (m)


def _wall_grid(nu, nv, corner, eu, ev, normal, phase):
    """One subdivided wall: grid of (nu+1)x(nv+1) vertices spanning
    corner + u*eu + v*ev, displaced inward along `normal` by a smooth
    field that is zero on the boundary. Returns (verts, faces)."""
    verts = []
    for j in range(nv + 1):
        for i in range(nu + 1):
            u = i / nu
            v = j / nv
            # boundary-vanishing smooth relief: sin(pi u) sin(pi v) carrier
            # modulated by higher-frequency diffusor ripples
            envelope = math.sin(math.pi * u) * math.sin(math.pi * v)
            ripple = (
                0.55 * math.sin(2 * math.pi * (3 * u + phase))
                * math.cos(2 * math.pi * (2 * v - phase))
                + 0.3 * math.sin(2 * math.pi * (7 * u - 2 * v + 2 * phase))
                + 0.15 * math.cos(2 * math.pi * (5 * v + 3 * u + phase))
            )
            d = RELIEF * envelope * ripple
            x = corner[0] + u * eu[0] + v * ev[0] + d * normal[0]
            y = corner[1] + u * eu[1] + v * ev[1] + d * normal[1]
            z = corner[2] + u * eu[2] + v * ev[2] + d * normal[2]
            verts.append((x, y, z))
    faces = []
    for j in range(nv):
        for i in range(nu):
            a = j * (nu + 1) + i
            b = a + 1
            c = a + (nu + 1)
            d2 = c + 1
            faces.append((a, b, d2))
            faces.append((a, d2, c))
    return verts, faces


def generate(path: str, target_triangles: int = 100_000) -> int:
    """Write the hall OBJ; returns the actual triangle count."""
    # 6 walls, each nu x nv quads -> 2 tris; solve n for the target
    per_wall = target_triangles / 6
    n = max(2, int(math.sqrt(per_wall / 2.0) + 0.999))

    w, h, d = WIDTH, HEIGHT, DEPTH
    # (corner, eu, ev, inward normal, phase) per wall; windings give
    # outward-facing normals irrelevant to the tracer (two-sided tests)
    walls = [
        ((0, 0, 0), (w, 0, 0), (0, 0, d), (0, 1, 0), 0.00),   # floor
        ((0, h, 0), (w, 0, 0), (0, 0, d), (0, -1, 0), 0.13),  # ceiling
        ((0, 0, 0), (w, 0, 0), (0, h, 0), (0, 0, 1), 0.29),   # front z=0
        ((0, 0, d), (w, 0, 0), (0, h, 0), (0, 0, -1), 0.41),  # back z=d
        ((0, 0, 0), (0, 0, d), (0, h, 0), (1, 0, 0), 0.57),   # left x=0
        ((w, 0, 0), (0, 0, d), (0, h, 0), (-1, 0, 0), 0.71),  # right x=w
    ]

    all_verts = []
    all_faces = []
    for corner, eu, ev, normal, phase in walls:
        verts, faces = _wall_grid(n, n, corner, eu, ev, normal, phase)
        base = len(all_verts)
        all_verts.extend(verts)
        all_faces.extend(
            (a + base, b + base, c + base) for a, b, c in faces
        )

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "# procedural benchmark hall %.0fx%.0fx%.0f m, %d tris\n"
            % (WIDTH, HEIGHT, DEPTH, len(all_faces))
        )
        f.write("usemtl concrete\n")
        for x, y, z in all_verts:
            f.write(f"v {x:.5f} {y:.5f} {z:.5f}\n")
        for a, b, c in all_faces:
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")
    return len(all_faces)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out")
    ap.add_argument("--triangles", type=int, default=100_000)
    args = ap.parse_args()
    n = generate(args.out, args.triangles)
    print(f"{args.out}: {n} triangles")


if __name__ == "__main__":
    main()
