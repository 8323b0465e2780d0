"""The traffic's data: an analytic room and a handheld orbit through it,
made from the seed, and the organized depth scans a Kinect-class camera
takes along the orbit, ray-cast on the device in a few large calls.

Nothing here imports the program: the scans are the benchmark's own
inputs, handed to the program and to the reference alike.

A traffic file's ``scene`` block gives the room (a capped cylinder on the
ground and a fixed number of cubes and spheres) and its ``orbit`` block
the trajectory (radius, height, the jitter of a handheld camera). The
layout of the objects and the jitter of every pose are drawn once from
the file's ``layout_seed``; the run's seed turns the whole room and orbit
about the vertical axis and picks the pose the orbit starts from. So
every seed gives new data (each voxel sees other values) but nearly the
same work (the same views of the same room, on a grid the turn
misaligns). The configuration's ``sensor`` block gives the camera:
width, height, horizontal field of view, range.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Colour of each primitive kind (the camera's RGB); the reference ignores
# colour, the program integrates it.
_COLORS = {"ground": (127, 127, 127), "cylinder": (0, 200, 0),
           "cube": (200, 60, 40), "sphere": (40, 60, 200)}


def intrinsics(sensor):
    """(fx, fy, cx, cy) of the pinhole camera, the reference pixel
    convention: focal = W / (2 tan(fov/2)), principal point at W/2, H/2."""
    w, h = sensor["width"], sensor["height"]
    f = w / (2.0 * math.tan(math.radians(sensor["fov_deg"]) / 2.0))
    return (f, f, w / 2.0, h / 2.0)


def make_scene(scene, rng, turn):
    """Primitives as plain dicts: the cubes and spheres on the ground in
    the ring between the cylinder and the orbit, at places drawn from
    ``rng``, all turned by ``turn`` radians."""
    prims = [dict(kind="ground", z=0.0),
             dict(kind="cylinder", radius=scene["cylinder_radius"],
                  height=scene["cylinder_height"])]
    lo, hi = scene["object_ring"]
    for kind in ("cube", "sphere"):
        n = scene[f"{kind}s"]
        size = scene[f"{kind}_size"]
        ang = rng.uniform(0.0, 2 * math.pi, n) + turn
        rad = rng.uniform(lo, hi, n)
        for a, r in zip(ang, rad):
            c = (r * math.cos(a), r * math.sin(a))
            if kind == "cube":
                # Axis-aligned (the turn moves it, the grid keeps it square).
                prims.append(dict(kind="cube", center=(c[0], c[1], size / 2),
                                  half=size / 2))
            else:
                prims.append(dict(kind="sphere", center=(c[0], c[1], size),
                                  radius=size))
    return prims


def make_poses(orbit, rng, turn, start):
    """Camera poses (R [3,3], t [3]) as float64 numpy, camera z along the
    view and y down: ``poses`` evenly spaced angles, each jittered in
    position and view target by draws from ``rng``, the orbit turned by
    ``turn`` radians and begun at pose ``start``."""
    n = orbit["poses"]
    jit = orbit["jitter_m"]
    jitter = rng.uniform(-jit, jit, (n, 2, 3))
    out = []
    for k in range(n):
        i = (start + k) % n
        a = turn + 2 * math.pi * i / n
        c, s_ = math.cos(turn), math.sin(turn)
        turn_xy = np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
        pos = np.array([orbit["radius_m"] * math.cos(a),
                        orbit["radius_m"] * math.sin(a),
                        orbit["height_m"]]) + turn_xy @ jitter[i, 0]
        target = np.array([0.0, 0.0, orbit["target_height_m"]]) \
            + turn_xy @ jitter[i, 1]
        z = target - pos
        z /= np.linalg.norm(z)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        out.append((np.stack([x, y, z], 1), pos))
    return out


def _hit(prims, o, d):
    """Nearest positive hit along rays o + s d (o [3], d [N, 3] unit):
    (s [N], primitive index [N]); inf where nothing is hit."""
    n = d.shape[0]
    best = torch.full((n,), math.inf, dtype=d.dtype, device=d.device)
    who = torch.full((n,), -1, dtype=torch.int64, device=d.device)
    eps = 1e-6
    for k, p in enumerate(prims):
        if p["kind"] == "ground":
            s = (p["z"] - o[2]) / torch.where(d[:, 2].abs() < 1e-12, 1e-12,
                                             d[:, 2])
            s = torch.where(s > eps, s, math.inf)
        elif p["kind"] == "cylinder":
            r, hgt = p["radius"], p["height"]
            a = d[:, 0] ** 2 + d[:, 1] ** 2
            b = 2 * (o[0] * d[:, 0] + o[1] * d[:, 1])
            c = o[0] ** 2 + o[1] ** 2 - r * r
            disc = b * b - 4 * a * c
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            aa = torch.clamp(a, min=1e-12)
            s_side = math.inf * torch.ones_like(a)
            for sgn in (1.0, -1.0):  # near root last, so it wins
                s1 = (-b - sgn * sq) / (2 * aa)
                z1 = o[2] + s1 * d[:, 2]
                ok = (disc >= 0) & (s1 > eps) & (z1 >= 0) & (z1 <= hgt)
                s_side = torch.where(ok, s1, s_side)
            s_cap = (hgt - o[2]) / torch.where(d[:, 2].abs() < 1e-12, 1e-12,
                                              d[:, 2])
            xc = o[0] + s_cap * d[:, 0]
            yc = o[1] + s_cap * d[:, 1]
            cap_ok = (s_cap > eps) & (xc * xc + yc * yc <= r * r)
            s = torch.minimum(s_side, torch.where(cap_ok, s_cap, math.inf))
        elif p["kind"] == "cube":
            c = torch.tensor(p["center"], dtype=d.dtype, device=d.device)
            inv = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
            t0 = (c - p["half"] - o) * inv
            t1 = (c + p["half"] - o) * inv
            tn = torch.minimum(t0, t1).amax(1)
            tf = torch.maximum(t0, t1).amin(1)
            s = torch.where((tf >= tn) & (tn > eps), tn, math.inf)
        else:  # sphere
            c = torch.tensor(p["center"], dtype=d.dtype, device=d.device)
            oc = o - c
            b = (d * oc).sum(1)
            disc = b * b - (oc @ oc - p["radius"] ** 2)
            s = -b - torch.sqrt(torch.clamp(disc, min=0.0))
            s = torch.where((disc >= 0) & (s > eps), s, math.inf)
        take = s < best
        best = torch.where(take, s, best)
        who = torch.where(take, k, who)
    return best, who


def render_scans(prims, poses, sensor, device):
    """Organized camera-frame scans: a list of (R, t, points [H, W, 3],
    colours [H, W, 3]) float32 tensors on ``device``; a pixel without a
    return within ``max_range_m`` holds the zero point. Rays are cast in
    float64 and the points rounded once to float32."""
    w, h = sensor["width"], sensor["height"]
    fx, fy, cx, cy = intrinsics(sensor)
    f64 = dict(dtype=torch.float64, device=device)
    u = torch.arange(w, **f64) - cx
    v = torch.arange(h, **f64) - cy
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dirs_c = torch.stack([uu / fx, vv / fy, torch.ones_like(uu)], -1)
    dirs_c = (dirs_c / torch.linalg.norm(dirs_c, dim=-1, keepdim=True)
              ).reshape(-1, 3)
    palette = torch.tensor([_COLORS[p["kind"]] for p in prims], **f64)
    scans = []
    for R, t in poses:
        R_t = torch.tensor(R, **f64)
        o = torch.tensor(t, **f64)
        s, who = _hit(prims, o, dirs_c @ R_t.T)
        ok = s <= sensor["max_range_m"]
        pts = torch.where(ok[:, None], dirs_c * s[:, None], 0.0)
        cols = torch.where(ok[:, None], palette[who.clamp(min=0)], 0.0)
        f32 = torch.float32
        scans.append((R_t.to(f32), o.to(f32), pts.to(f32).reshape(h, w, 3),
                      cols.to(f32).reshape(h, w, 3)))
    return scans


def make_traffic_data(traffic, sensor, seed, device):
    """Scene, poses and scans of one run: the layout from the traffic
    file's ``layout_seed``, the turn and the start pose from ``seed``."""
    layout = np.random.Generator(np.random.PCG64(traffic["layout_seed"]))
    run = np.random.Generator(np.random.PCG64(seed))
    turn = float(run.uniform(0.0, 2 * math.pi))
    start = int(run.integers(0, traffic["orbit"]["poses"]))
    prims = make_scene(traffic["scene"], layout, turn)
    poses = make_poses(traffic["orbit"], layout, turn, start)
    return prims, render_scans(prims, poses, sensor, device)
