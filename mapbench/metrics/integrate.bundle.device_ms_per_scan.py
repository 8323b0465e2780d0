"""Device time of the kernels under the TSDF step's span
``integrate.bundle``, per scan: the merged bundling
(``ops/tsdf._bundle_rays``: stable sorts by endpoint voxel, segment
sums). The span is a sibling of the other stage spans directly under
``integrate_<method>``, so no kernel is counted under two of them."""

SPAN = "integrate.bundle"


def read(ctx):
    us = ctx["span_us"].get(SPAN)
    return None if us is None else us / 1e3 / ctx["scans"]
