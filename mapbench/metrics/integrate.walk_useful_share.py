"""Share of the voxel walk's (step, lane) samples that lie inside a ray:
the program's counters ``integrate.walk_samples_useful`` over
``integrate.walk_samples`` (``ops/tsdf.integrate_pointcloud``). The
program's recorder (``voxblox_tpu_torch.utils.timing``) records while
torch.profiler collects, so its summary covers the traced window. None
where the program has no such recorder or counters."""

import sys


def read(ctx):
    timing = sys.modules.get("voxblox_tpu_torch.utils.timing")
    summary = getattr(timing, "summary", None)
    if summary is None:
        return None
    c = summary()["counters"]
    total = c.get("integrate.walk_samples")
    useful = c.get("integrate.walk_samples_useful")
    if not total or useful is None:
        return None
    return 100.0 * useful / total
