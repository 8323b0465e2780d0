"""Device time of the kernels under the TSDF integrator's span, per scan:
``insert_pointcloud`` names it ``integrate_<method>`` (``merged``,
``simple``, ``fast``, ``projective``)."""

SPANS = ("integrate_merged", "integrate_simple", "integrate_fast",
         "integrate_projective")


def read(ctx):
    us = [ctx["span_us"][s] for s in SPANS if s in ctx["span_us"]]
    return sum(us) / 1e3 / ctx["scans"] if us else None
