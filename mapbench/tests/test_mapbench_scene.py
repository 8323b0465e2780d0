"""The traffic's data: the spinning LiDAR's rays against analytic
distances, the vehicle mount's frame, the street's placement, and the two
real cells' scans, bit for bit those of the harness before the LiDAR,
the vehicle and the street were added."""

import hashlib
import json
import math
import os

import numpy as np
import pytest
import torch

from mapbench import scene

from .tiny import REPO, ROLLING_TRAFFIC

F64 = dict(dtype=torch.float64, device=torch.device("cpu"))
LIDAR = {"model": "spherical", "width": 256, "height": 16,
         "vfov_deg": [-24.8, 2.0], "max_range_m": 120.0}
UP = np.eye(3)


def _scan(prims, sensor=LIDAR, t=(0.0, 0.0, 1.73)):
    """One scan from a sensor at ``t`` with its axes the world's."""
    (_, _, pts, _), = scene.render_scans(prims, [(UP, np.array(t))], sensor,
                                         torch.device("cpu"))
    return pts.double().reshape(-1, 3)


def _angles(sensor=LIDAR):
    w, h = sensor["width"], sensor["height"]
    lo, hi = sensor["vfov_deg"]
    el = np.radians(np.linspace(lo, hi, h))[:, None].repeat(w, 1)
    az = (-math.pi + (np.arange(w) + 0.5) * 2 * math.pi / w)[None].repeat(
        h, 0)
    return torch.tensor(el.reshape(-1)), torch.tensor(az.reshape(-1))


def test_spherical_rays_meet_the_ground_at_the_analytic_range():
    pts = _scan([dict(kind="ground", z=0.0)])
    el, az = _angles()
    r = torch.linalg.norm(pts, dim=-1)
    want = torch.where(el < 0, 1.73 / torch.sin(-el), 0.0)
    want = torch.where(want <= LIDAR["max_range_m"], want, 0.0)
    assert int((want > 0).sum()) == 14 * 256  # 14 beams reach the ground
    torch.testing.assert_close(r, want, rtol=1e-6, atol=1e-5)
    hit = r > 0
    torch.testing.assert_close(torch.atan2(pts[hit, 1], pts[hit, 0]),
                               az[hit], rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.asin(pts[hit, 2] / r[hit]), el[hit],
                               rtol=0, atol=1e-6)
    # Sensor frame: x forward, y left, z up; columns counter-clockwise
    # from behind, beams from the lowest.
    grid = pts.reshape(16, 256, 3)
    assert grid[0, 128, 0] > 0 and abs(grid[0, 128, 1]) < 0.1
    assert grid[0, 192, 1] > 0 and grid[0, 64, 1] < 0


@pytest.mark.parametrize("yaw", [0.0, math.pi / 2])
def test_spherical_rays_meet_a_box_face_at_the_analytic_range(yaw):
    # A wall whose near face is the plane x = 10, wide and tall enough for
    # every forward ray within 30 degrees of azimuth; turned by a quarter
    # its extents swap.
    half = (1.0, 30.0, 50.0) if yaw == 0.0 else (30.0, 1.0, 50.0)
    wall = dict(kind="building", center=(11.0, 0.0, 0.0), half=half,
                yaw=yaw)
    pts = _scan([wall])
    el, az = _angles()
    fwd = az.abs() < math.radians(30)
    want = 10.0 / (torch.cos(el[fwd]) * torch.cos(az[fwd]))
    torch.testing.assert_close(torch.linalg.norm(pts[fwd], dim=-1), want,
                               rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(pts[fwd, 0], torch.full_like(want, 10.0),
                               rtol=0, atol=1e-5)


def test_spherical_rays_meet_a_pole_at_the_analytic_range():
    d, rad = 6.0, 0.25
    pole = dict(kind="pole", center=(d, 0.0), radius=rad, height=8.0)
    pts = _scan([pole])
    el, az = _angles()
    r = torch.linalg.norm(pts, dim=-1)
    horiz = d * torch.cos(az) - torch.sqrt(
        torch.clamp(rad ** 2 - (d * torch.sin(az)) ** 2, min=0.0))
    z = 1.73 + horiz * torch.tan(el)
    hits = ((d * torch.sin(az).abs() < rad) & (az.abs() < 1.0) & (z >= 0)
            & (z <= 8.0))
    want = torch.where(hits, horiz / torch.cos(el), 0.0)
    assert int(hits.sum()) == 4 * 11  # four columns, the beams above z = 0
    torch.testing.assert_close(r, want, rtol=1e-6, atol=1e-5)


def test_returns_beyond_the_range_are_dropped():
    sensor = dict(LIDAR, max_range_m=10.0)
    pts = _scan([dict(kind="ground", z=0.0)], sensor)
    r = torch.linalg.norm(pts, dim=-1)
    el, _ = _angles(sensor)
    assert bool((r <= 10.0).all())
    assert bool((r[1.73 / torch.sin(-el) > 10.0] == 0).all())


def test_vehicle_mount_frame():
    orbit = dict(ROLLING_TRAFFIC["orbit"], jitter_m=0.0)
    rng = np.random.Generator(np.random.PCG64(1))
    poses = scene.make_poses(orbit, rng, 0.7, 3)
    n = orbit["poses"]
    assert len(poses) == n
    for k, (R, t) in enumerate(poses):
        np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-12)
        assert np.linalg.det(R) == pytest.approx(1.0)
        np.testing.assert_allclose(R[:, 2], [0.0, 0.0, 1.0])  # z up
        assert t[2] == pytest.approx(orbit["height_m"])
        assert math.hypot(t[0], t[1]) == pytest.approx(orbit["radius_m"])
        # x is the tangent, along the travel to the next pose; y left,
        # towards the loop's centre.
        assert float(R[:, 0] @ t) == pytest.approx(0.0, abs=1e-9)
        step = poses[(k + 1) % n][1] - t
        assert float(R[:, 0] @ step) > 0.99 * np.linalg.norm(step) * math.cos(
            math.pi / n)
        assert float(R[:, 1] @ t) < 0
    # The seed's start pose and turn are kept: pose 0 is angle 3 of n.
    a = 0.7 + 2 * math.pi * 3 / n
    np.testing.assert_allclose(poses[0][1][:2], orbit["radius_m"] * np.array(
        [math.cos(a), math.sin(a)]), atol=1e-9)


def _street(turn):
    rng = np.random.Generator(np.random.PCG64(ROLLING_TRAFFIC["layout_seed"]))
    return scene.make_scene(ROLLING_TRAFFIC["scene"], rng, turn)


def test_street_is_placed_from_the_layout_seed_and_turned_by_the_seed():
    a, b = _street(0.0), _street(1.1)
    kinds = [p["kind"] for p in a]
    assert kinds == [p["kind"] for p in b]
    assert kinds[0] == "ground" and "cylinder" not in kinds
    s = ROLLING_TRAFFIC["scene"]
    assert kinds.count("car") == s["cars"]["count"]
    assert kinds.count("pole") == s["poles"]["count"]
    assert kinds.count("building") >= 8
    c, sn = math.cos(1.1), math.sin(1.1)
    for p, q in zip(a[1:], b[1:]):
        x, y = p["center"][:2]
        np.testing.assert_allclose(q["center"][:2],
                                   [c * x - sn * y, sn * x + c * y],
                                   atol=1e-9)
        if p["kind"] == "pole":
            assert (q["radius"], q["height"]) == (p["radius"], p["height"])
        else:
            assert q["half"] == p["half"]
            assert q["yaw"] == pytest.approx(p["yaw"] + 1.1)
    # Another layout seed places another street.
    rng = np.random.Generator(np.random.PCG64(7))
    other = scene.make_scene(s, rng, 0.0)
    assert [p.get("center") for p in other] != [p.get("center") for p in a]


def test_street_keeps_the_road_clear():
    s = ROLLING_TRAFFIC["scene"]
    road, edge = s["road"]["radius_m"], s["road"]["half_width_m"]
    for p in _street(0.4)[1:]:
        if p["kind"] == "pole":
            off = abs(math.hypot(*p["center"]) - road) - p["radius"]
            assert off > edge
            continue
        c, sn = math.cos(p["yaw"]), math.sin(p["yaw"])
        hx, hy = p["half"][:2]
        corners = [math.hypot(p["center"][0] + c * u - sn * v,
                              p["center"][1] + sn * u + c * v) - road
                   for u in (-hx, hx) for v in (-hy, hy)]
        if p["kind"] == "building":
            assert min(abs(x) for x in corners) > edge
            assert len({x > 0 for x in corners}) == 1  # one side
        else:  # a car parked inside the kerb, off the vehicle's lane
            assert all(0.5 < abs(x) < edge for x in corners)


# sha256 over R, t, points and colours of every scan, computed with the
# harness as it was before the LiDAR, the vehicle and the street.
DIGESTS = {
    2147483659:
        "fda510d2c726044955c730cd36e5514a66826334cb0b337b448f573913448b9b",
    9000000001:
        "1f463373dabb1d5b2c0e9f0b8f4cd448ed3300680c2d8760fa84d44685819569",
}


@pytest.mark.parametrize("seed", sorted(DIGESTS))
@pytest.mark.parametrize("config", ["cow_and_lady.5cm.merged",
                                    "cow_and_lady.2cm.merged"])
def test_real_cells_scans_are_unchanged(config, seed):
    with open(os.path.join(REPO, "mapbench", "configs",
                           f"{config}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(REPO, "mapbench", "traffic",
                           "tsdf_only.json")) as f:
        traffic = json.load(f)
    _, scans = scene.make_traffic_data(traffic, cfg["sensor"], seed,
                                       torch.device("cpu"))
    h = hashlib.sha256()
    for s in scans:
        for x in s:
            h.update(x.contiguous().numpy().tobytes())
    assert len(scans) == 32 and h.hexdigest() == DIGESTS[seed]
