"""Device time of the kernels under the TSDF step's span
``integrate.lookup``, per scan: the block hash lookups of every walk
sample (``core/layer.global_voxel_to_flat``). The span is a sibling of
the other stage spans directly under ``integrate_<method>``, so no
kernel is counted under two of them."""

SPAN = "integrate.lookup"


def read(ctx):
    us = ctx["span_us"].get(SPAN)
    return None if us is None else us / 1e3 / ctx["scans"]
