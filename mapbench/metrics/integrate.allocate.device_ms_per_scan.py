"""Device time of the kernels under the TSDF step's span
``integrate.allocate``, per scan: the allocation
(``ops/tsdf.allocate_for_rays``: block DDA, dilation,
``core/layer.allocate_blocks``). The span is a sibling of the other
stage spans directly under ``integrate_<method>``, so no kernel is
counted under two of them."""

SPAN = "integrate.allocate"


def read(ctx):
    us = ctx["span_us"].get(SPAN)
    return None if us is None else us / 1e3 / ctx["scans"]
