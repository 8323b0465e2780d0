"""Device time of the kernels under the TSDF step's span
``integrate.walk``, per scan: the voxel walk (``ops/raycast.cast_rays``:
every lane for the static step count). The span is a sibling of the
other stage spans directly under ``integrate_<method>``, so no kernel is
counted under two of them."""

SPAN = "integrate.walk"


def read(ctx):
    us = ctx["span_us"].get(SPAN)
    return None if us is None else us / 1e3 / ctx["scans"]
