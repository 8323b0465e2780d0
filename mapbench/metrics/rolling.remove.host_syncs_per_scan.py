"""Host syncs of a rolling map's removal per scan: the ``syncs`` of the
program's span ``rolling.remove`` and of its children
(``rolling.remove.*``: each span's own syncs, less its children's, so
the sum counts each once) in the program's recorder
(``voxblox_tpu_torch.utils.timing``), which records while torch.profiler
collects, so its summary covers the traced window. None where the
program has no such recorder or span."""

import sys

SPAN = "rolling.remove"


def read(ctx):
    timing = sys.modules.get("voxblox_tpu_torch.utils.timing")
    summary = getattr(timing, "summary", None)
    if summary is None:
        return None
    syncs = [s["syncs"] for tag, s in summary()["spans"].items()
             if tag == SPAN or tag.startswith(SPAN + ".")]
    return sum(syncs) / ctx["scans"] if syncs else None
