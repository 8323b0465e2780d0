"""Hash-table probes per scan: the program's counter ``hash.probes``
(lanes x (probe bound + 1) of every ``core/hash.lookup``: the walk
samples' lookups and the allocation's). The program's recorder
(``voxblox_tpu_torch.utils.timing``) records while torch.profiler
collects, so its summary covers the traced window. None where the
program has no such recorder or counter."""

import sys


def read(ctx):
    timing = sys.modules.get("voxblox_tpu_torch.utils.timing")
    summary = getattr(timing, "summary", None)
    if summary is None:
        return None
    probes = summary()["counters"].get("hash.probes")
    return None if probes is None else probes / ctx["scans"]
