"""Device time of a rolling map's removal per scan: the kernels in the
GPU-side extents of the program's span ``rolling.remove`` and of its
children ``rolling.remove.*`` (``TsdfServer``'s removal, after each scan,
of the blocks farther than ``max_block_distance_from_body`` from the
sensor: the selection, the keys' tombstones and a table rebuild when it
runs, the zeroing of the rows and of their mesh). The profiler ties a
kernel to its innermost label, and a label's extent runs from its first
kernel to its last, so the parent's extent alone misses what its children
launch; the removal launches nothing directly under the parent between
two children, so no kernel is counted twice. None where the program has
no such span."""

SPAN = "rolling.remove"


def read(ctx):
    us = [v for tag, v in ctx["span_us"].items()
          if tag == SPAN or tag.startswith(SPAN + ".")]
    return sum(us) / 1e3 / ctx["scans"] if us else None
