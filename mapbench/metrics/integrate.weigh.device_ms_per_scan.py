"""Device time of the kernels under the TSDF step's span
``integrate.weigh``, per scan: the per-sample sdf and weight
(``ops/tsdf._per_sample_contributions``). The span is a sibling of the
other stage spans directly under ``integrate_<method>``, so no kernel is
counted under two of them."""

SPAN = "integrate.weigh"


def read(ctx):
    us = ctx["span_us"].get(SPAN)
    return None if us is None else us / 1e3 / ctx["scans"]
