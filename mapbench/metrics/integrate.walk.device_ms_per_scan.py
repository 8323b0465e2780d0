"""Device time of the kernels under the TSDF step's span
``integrate.walk``, per scan: on the card for ``simple`` and ``merged``
the per-ray set-up and the one walk-and-accumulate kernel, which also
weighs, looks up and scatters (``ops/tsdf_walk.py``); elsewhere the
voxel walk alone (``ops/raycast.cast_rays``). The span is a sibling of
the other stage spans directly under ``integrate_<method>``, so no
kernel is counted under two of them."""

SPAN = "integrate.walk"


def read(ctx):
    us = ctx["span_us"].get(SPAN)
    return None if us is None else us / 1e3 / ctx["scans"]
