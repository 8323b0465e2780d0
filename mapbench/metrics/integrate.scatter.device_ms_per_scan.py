"""Device time of the kernels under the TSDF step's span
``integrate.scatter``, per scan: the scatter-add into the pool
accumulators and the dirty mask (``ops/tsdf._accumulate_flat``). The
span is a sibling of the other stage spans directly under
``integrate_<method>``, so no kernel is counted under two of them."""

SPAN = "integrate.scatter"


def read(ctx):
    us = ctx["span_us"].get(SPAN)
    return None if us is None else us / 1e3 / ctx["scans"]
