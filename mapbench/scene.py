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

A street for a vehicle's spinning LiDAR is made of the same parts. The
``sensor`` block's ``model`` is ``pinhole`` (the default) or
``spherical``: ``width`` columns over 360 degrees of azimuth and
``height`` beams evenly spaced over ``vfov_deg`` [lo, hi], in the
sensor frame x forward, y left, z up. The ``orbit`` block's ``mount``
is ``camera`` (the default, the handheld orbit above) or ``vehicle``:
the sensor at ``height_m`` on the circle of ``radius_m``, x along the
direction of travel, z up. The ``scene`` block may add ``buildings``,
parked ``cars`` and ``poles`` along a ring road (``road``); with
``cylinder_radius`` 0 there is no central cylinder. Each is placed from
the ``layout_seed`` and turned by the run's seed as the cubes are, and
each kind is ray-cast in one batched test, culled to what lies within
the sensor's range of the pose.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Colour of each primitive kind (the camera's RGB); the reference ignores
# colour, the program integrates it.
_COLORS = {"ground": (127, 127, 127), "cylinder": (0, 200, 0),
           "cube": (200, 60, 40), "sphere": (40, 60, 200),
           "building": (180, 170, 150), "car": (30, 40, 160),
           "pole": (90, 90, 90)}
# Kinds cast together, one batched test per kind (the others one by one):
# a building or car is a box [centre xyz, half xyz, yaw], a pole a
# vertical cylinder [centre x, y, radius, height] standing on the ground.
_BATCHED = ("building", "car", "pole")
_BATCHED_KEYS = ("buildings", "cars", "poles")  # their ``scene`` keys
_GROUP = 16  # primitives a batched test takes at once: bounds its temporaries


def intrinsics(sensor):
    """(fx, fy, cx, cy) of the pinhole camera, the reference pixel
    convention: focal = W / (2 tan(fov/2)), principal point at W/2, H/2."""
    w, h = sensor["width"], sensor["height"]
    f = w / (2.0 * math.tan(math.radians(sensor["fov_deg"]) / 2.0))
    return (f, f, w / 2.0, h / 2.0)


def make_scene(scene, rng, turn):
    """Primitives as plain dicts: the cubes and spheres on the ground in
    the ring between the cylinder and the orbit, at places drawn from
    ``rng``, then the street's buildings, cars and poles, all turned by
    ``turn`` radians."""
    prims = [dict(kind="ground", z=0.0)]
    if scene["cylinder_radius"] > 0:
        prims.append(dict(kind="cylinder", radius=scene["cylinder_radius"],
                          height=scene["cylinder_height"]))
    for kind in ("cube", "sphere"):
        n = scene.get(f"{kind}s", 0)
        if not n:
            continue
        lo, hi = scene["object_ring"]
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
    if any(k in scene for k in _BATCHED_KEYS):
        prims += street(scene, rng, turn)
    return prims


def _box(kind, radius, ang, along, across, height, turn):
    """A box standing on the ground, its centre at ``radius`` from the
    ring road's centre at angle ``ang``, ``along`` the road and ``across``
    it, faced to the road; the whole turned by ``turn``."""
    a = ang + turn
    return dict(kind=kind, center=(radius * math.cos(a), radius * math.sin(a),
                                   height / 2),
                half=(along / 2, across / 2, height / 2), yaw=a + math.pi / 2)


def street(scene, rng, turn):
    """The street's primitives along the ring road ``scene["road"]``
    (``radius_m``, ``half_width_m``), drawn from ``rng``:

    - ``buildings``: boxes on both sides, walked along each side's
      frontage: a ``frontage_m`` x ``depth_m`` x ``height_m`` box
      ``setback_m`` from the road's edge, then a ``gap_m`` (each a
      [lo, hi] range drawn anew);
    - ``cars``: ``count`` boxes of ``size_m`` parked at the kerb, inside
      the road's edge on a side and at an angle drawn at random;
    - ``poles``: ``count`` vertical cylinders of ``radius_m`` and
      ``height_m`` ([lo, hi]) at ``offset_m`` ([lo, hi]) beyond the
      road's edge, on a side and at an angle drawn at random."""
    road_r = scene["road"]["radius_m"]
    edge = scene["road"]["half_width_m"]
    out = []
    b = scene.get("buildings")
    if b:
        for side in (1.0, -1.0):
            ang = rng.uniform(0.0, 1.0) * b["gap_m"][1] / road_r
            while True:
                along = rng.uniform(*b["frontage_m"])
                across = rng.uniform(*b["depth_m"])
                height = rng.uniform(*b["height_m"])
                clear = edge + rng.uniform(*b["setback_m"])
                # Inside the ring a straight front comes nearer the road
                # at its ends: those keep the setback.
                front = (road_r + clear if side > 0 else math.sqrt(max(
                    (road_r - clear) ** 2 - (along / 2) ** 2, 1.0)))
                gap = rng.uniform(*b["gap_m"])
                end = ang + (along + gap) / front
                if end > 2 * math.pi:
                    break
                mid = ang + along / 2 / front
                out.append(_box("building", front + side * across / 2, mid,
                                along, across, height, turn))
                ang = end
    c = scene.get("cars")
    if c:
        ln, wd, ht = c["size_m"]
        for _ in range(c["count"]):
            side = 1.0 if rng.uniform() < 0.5 else -1.0
            out.append(_box("car", road_r + side * (edge - wd / 2 - 0.2),
                            rng.uniform(0.0, 2 * math.pi), ln, wd, ht, turn))
    p = scene.get("poles")
    if p:
        for _ in range(p["count"]):
            side = 1.0 if rng.uniform() < 0.5 else -1.0
            r = road_r + side * (edge + rng.uniform(*p["offset_m"]))
            a = rng.uniform(0.0, 2 * math.pi) + turn
            out.append(dict(kind="pole",
                            center=(r * math.cos(a), r * math.sin(a)),
                            radius=rng.uniform(*p["radius_m"]),
                            height=rng.uniform(*p["height_m"])))
    return out


def make_poses(orbit, rng, turn, start):
    """Sensor poses (R [3,3], t [3]) as float64 numpy: ``poses`` evenly
    spaced angles, each jittered by draws from ``rng``, the orbit turned
    by ``turn`` radians and begun at pose ``start``. With the ``camera``
    mount (the default) the camera looks at the orbit's centre, z along
    the view and y down, its position and view target jittered; with the
    ``vehicle`` mount the sensor rides the circle counter-clockwise, x
    along the direction of travel and z up, its position jittered."""
    n = orbit["poses"]
    jit = orbit["jitter_m"]
    jitter = rng.uniform(-jit, jit, (n, 2, 3))
    vehicle = orbit.get("mount", "camera") == "vehicle"
    out = []
    for k in range(n):
        i = (start + k) % n
        a = turn + 2 * math.pi * i / n
        c, s_ = math.cos(turn), math.sin(turn)
        turn_xy = np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
        pos = np.array([orbit["radius_m"] * math.cos(a),
                        orbit["radius_m"] * math.sin(a),
                        orbit["height_m"]]) + turn_xy @ jitter[i, 0]
        if vehicle:
            x = np.array([-math.sin(a), math.cos(a), 0.0])
            z = np.array([0.0, 0.0, 1.0])
            out.append((np.stack([x, np.cross(z, x), z], 1), pos))
            continue
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
        if p["kind"] in _BATCHED:
            continue
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


def _box_hits(P, o, d, eps):
    """Ray parameters [N, G] of the nearest positive hit of rays o + s d
    on boxes P [G, 7] (centre, half extents, yaw about z); inf on a miss.
    The slab test, in each box's own frame."""
    c, s = torch.cos(P[:, 6]), torch.sin(P[:, 6])
    rel = o[None, :] - P[:, :3]
    o_loc = (c * rel[:, 0] + s * rel[:, 1], -s * rel[:, 0] + c * rel[:, 1],
             rel[:, 2])
    d_loc = (d[:, :1] * c + d[:, 1:2] * s, -d[:, :1] * s + d[:, 1:2] * c,
             d[:, 2:3])
    near = far = None
    for a in range(3):
        inv = 1.0 / torch.where(d_loc[a].abs() < 1e-12, 1e-12, d_loc[a])
        t0 = (-P[:, 3 + a] - o_loc[a]) * inv
        t1 = (P[:, 3 + a] - o_loc[a]) * inv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    return torch.where((far >= near) & (near > eps), near, math.inf)


def _pole_hits(P, o, d, eps):
    """Ray parameters [N, G] of the nearest positive hit of rays o + s d
    on vertical cylinders P [G, 4] (centre x, y, radius, height) standing
    on the ground: the side or the top cap; inf on a miss."""
    ox, oy = o[0] - P[:, 0], o[1] - P[:, 1]
    dx, dy, dz = d[:, :1], d[:, 1:2], d[:, 2:3]
    a = torch.clamp(dx * dx + dy * dy, min=1e-12)
    b = 2 * (ox * dx + oy * dy)
    disc = b * b - 4 * a * (ox * ox + oy * oy - P[:, 2] ** 2)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    side = torch.full_like(b, math.inf)
    for sgn in (-1.0, 1.0):  # the near root, -b - sq, last, so it wins
        s1 = (-b - sgn * sq) / (2 * a)
        z1 = o[2] + s1 * dz
        ok = (disc >= 0) & (s1 > eps) & (z1 >= 0) & (z1 <= P[:, 3])
        side = torch.where(ok, s1, side)
    s_cap = (P[:, 3] - o[2]) / torch.where(dz.abs() < 1e-12, 1e-12, dz)
    xc, yc = ox + s_cap * dx, oy + s_cap * dy
    cap_ok = (s_cap > eps) & (xc * xc + yc * yc <= P[:, 2] ** 2)
    return torch.minimum(side, torch.where(cap_ok, s_cap, math.inf))


def _batched_groups(prims, f64):
    """Per batched kind: (its indices in ``prims``, parameter rows, centre
    and bounding radius of each) as float64 tensors."""
    out = []
    for kind in _BATCHED:
        idx = [k for k, p in enumerate(prims) if p["kind"] == kind]
        if not idx:
            continue
        ps = [prims[k] for k in idx]
        if kind == "pole":
            rows = [[*p["center"], p["radius"], p["height"]] for p in ps]
            ctr = [[*p["center"], p["height"] / 2] for p in ps]
            rad = [math.hypot(p["radius"], p["height"] / 2) for p in ps]
            test = _pole_hits
        else:
            rows = [[*p["center"], *p["half"], p["yaw"]] for p in ps]
            ctr = [p["center"] for p in ps]
            rad = [math.hypot(*p["half"]) for p in ps]
            test = _box_hits
        out.append((torch.tensor(idx, dtype=torch.int64, device=f64["device"]),
                    torch.tensor(rows, **f64), torch.tensor(ctr, **f64),
                    torch.tensor(rad, **f64), test))
    return out


def _hit_batched(groups, o, d, best, who, reach):
    """Fold the batched kinds' hits into (best, who) of ``_hit``: each
    kind's primitives whose bounding sphere comes within ``reach`` of the
    origin, a group at a time."""
    eps = 1e-6
    for idx, rows, ctr, rad, test in groups:
        near = torch.nonzero(torch.linalg.norm(ctr - o, dim=-1) - rad
                             <= reach).flatten()
        for lo in range(0, int(near.shape[0]), _GROUP):
            g = near[lo:lo + _GROUP]
            s, j = test(rows[g], o, d, eps).min(1)
            take = s < best
            best = torch.where(take, s, best)
            who = torch.where(take, idx[g][j], who)
    return best, who


def sensor_dirs(sensor, f64):
    """Unit ray directions [H * W, 3] in the sensor frame, row-major. A
    ``pinhole`` camera: z along the view, y down, the pixel centres of
    ``intrinsics``. A ``spherical`` LiDAR: x forward, y left, z up; row r
    the beam at elevation lo + r (hi - lo) / (H - 1) of ``vfov_deg``
    [lo, hi] (the lowest first), column c at azimuth -pi + (c + 1/2) 2
    pi / W, counter-clockwise from behind."""
    w, h = sensor["width"], sensor["height"]
    if sensor.get("model", "pinhole") == "spherical":
        lo, hi = sensor["vfov_deg"]
        el = torch.deg2rad(torch.linspace(lo, hi, h, **f64))
        az = -math.pi + (torch.arange(w, **f64) + 0.5) * (2 * math.pi / w)
        ee, aa = torch.meshgrid(el, az, indexing="ij")
        return torch.stack([torch.cos(ee) * torch.cos(aa),
                            torch.cos(ee) * torch.sin(aa), torch.sin(ee)],
                           -1).reshape(-1, 3)
    fx, fy, cx, cy = intrinsics(sensor)
    u = torch.arange(w, **f64) - cx
    v = torch.arange(h, **f64) - cy
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dirs_c = torch.stack([uu / fx, vv / fy, torch.ones_like(uu)], -1)
    return (dirs_c / torch.linalg.norm(dirs_c, dim=-1, keepdim=True)
            ).reshape(-1, 3)


def render_scans(prims, poses, sensor, device):
    """Organized sensor-frame scans: a list of (R, t, points [H, W, 3],
    colours [H, W, 3]) float32 tensors on ``device``; a pixel without a
    return within ``max_range_m`` holds the zero point. Rays are cast in
    float64 and the points rounded once to float32."""
    w, h = sensor["width"], sensor["height"]
    f64 = dict(dtype=torch.float64, device=device)
    dirs_c = sensor_dirs(sensor, f64)
    palette = torch.tensor([_COLORS[p["kind"]] for p in prims], **f64)
    groups = _batched_groups(prims, f64)
    scans = []
    for R, t in poses:
        R_t = torch.tensor(R, **f64)
        o = torch.tensor(t, **f64)
        d = dirs_c @ R_t.T
        s, who = _hit(prims, o, d)
        s, who = _hit_batched(groups, o, d, s, who, sensor["max_range_m"])
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
