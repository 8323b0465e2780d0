"""tests/test_icp.py's yaw-and-translation case at a full camera size,
through both packages on the CPU with the JAX batch order: the pose
errors before and after ICP, and how far the two results lie apart.

Not a test (it takes ~20 s a package at 640x480, too long for the suite):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_icp_full_size.py \\
        [640x480]
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from voxblox_tpu.core import config as jcfg  # noqa: E402
from voxblox_tpu.ops import icp as jicp  # noqa: E402
from voxblox_tpu.sim import world as jsw  # noqa: E402
from voxblox_tpu.utils import lie as jlie  # noqa: E402
from voxblox_tpu_torch.core import config as tcfg  # noqa: E402
from voxblox_tpu_torch.core import layer as tlayer  # noqa: E402
from voxblox_tpu_torch.ops import icp as ticp  # noqa: E402

import torch_parity  # noqa: E402

R_TRUE = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                  np.float32)
T_TRUE = np.array([-3.0, 0.5, 1.0], np.float32)


def main():
    res = tuple(int(x) for x in (sys.argv[1] if len(sys.argv) > 1
                                 else "640x480").split("x"))
    w = jsw.SimulationWorld()
    w.add_cube((0.0, 0.0, 1.0), (1.5, 2.5, 2.0))
    w.add_sphere((2.0, -1.0, 1.0), 0.8)
    w.add_ground_level(0.0)
    objs = w.freeze()
    layer = jsw.generate_gt_layer(objs, "tsdf", 0.08, (-4.0, -4.0, -0.4),
                                  (4.0, 4.0, 3.5), max_dist=0.5, vps=8,
                                  max_blocks=4096)
    pose = (jnp.asarray(R_TRUE), jnp.asarray(T_TRUE))
    pts_G, _, valid = jsw.pointcloud_from_transform(objs, pose, res,
                                                    np.deg2rad(70.0), 8.0)
    pts_C = np.asarray(jsw.world_points_to_sensor(pose, pts_G, valid))
    a = np.deg2rad(2.0)
    Rz = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                   [0.0, 0.0, 1.0]], np.float32)
    R_bad = (Rz @ R_TRUE).astype(np.float32)
    t_bad = T_TRUE + np.array([0.05, -0.04, 0.03], np.float32)
    kw = dict(mini_batch_size=64, inital_translation_weighting=10.0,
              inital_rotation_weighting=10.0)
    t0 = time.perf_counter()
    ref = jicp.run_icp(layer, jnp.asarray(pts_C),
                       (jnp.asarray(R_bad), jnp.asarray(t_bad)),
                       jcfg.IcpConfig(**kw))
    jR, jt = np.asarray(ref.R), np.asarray(ref.t)
    j_s = time.perf_counter() - t0
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(0),
                                             len(pts_C)))
    tl = tlayer.layer_from_numpy(torch_parity.jax_layer_to_numpy(layer),
                                 "cpu")
    t0 = time.perf_counter()
    got = ticp.run_icp(tl, torch.as_tensor(pts_C),
                       (torch.as_tensor(R_bad), torch.as_tensor(t_bad)),
                       tcfg.IcpConfig(**kw), perm=torch.as_tensor(perm))
    t_s = time.perf_counter() - t0
    gR, gt = got.R.numpy(), got.t.numpy()

    def r_err(R):
        return float(np.linalg.norm(np.asarray(jlie.so3_log(
            jnp.asarray(R) @ jnp.asarray(R_TRUE).T))))

    tb = float(np.linalg.norm(t_bad - T_TRUE))
    print(f"{res[0]}x{res[1]}: {len(pts_C)} points; before: t "
          f"{tb:.6f} m, r {r_err(R_bad):.6f} rad")
    for name, (R, t, n, s) in (("jax", (jR, jt, ref.num_updates, j_s)),
                               ("port", (gR, gt, got.num_updates, t_s))):
        te = float(np.linalg.norm(t - T_TRUE))
        print(f"{name}: {int(n)} updates in {s:.1f} s; after: t {te:.6f} m "
              f"(ratio {te / tb:.4f}), r {r_err(R):.6f} rad")
    print(f"port - jax: R max {np.abs(gR - jR).max():.3e}, "
          f"t max {np.abs(gt - jt).max():.3e}")


if __name__ == "__main__":
    main()
