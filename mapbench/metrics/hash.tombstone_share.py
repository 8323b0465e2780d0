"""Share of the block hash table's cells that hold a tombstone (a removed
key) once a rolling map's removal is done, over the traced scans: the
program's counters ``hash.tombstone_cells`` over ``hash.table_cells``,
each added once a scan. The program's recorder
(``voxblox_tpu_torch.utils.timing``) records while torch.profiler
collects, so its summary covers the traced window. None where the
program has no such recorder or counters."""

import sys


def read(ctx):
    timing = sys.modules.get("voxblox_tpu_torch.utils.timing")
    summary = getattr(timing, "summary", None)
    if summary is None:
        return None
    c = summary()["counters"]
    cells = c.get("hash.table_cells")
    tombs = c.get("hash.tombstone_cells")
    if not cells or tombs is None:
        return None
    return 100.0 * tombs / cells
