"""The plain reference the benchmark holds the program to.

Plain PyTorch, importing nothing of the program. ``store`` keeps voxel
blocks keyed by their block index; ``merged`` integrates posed scans by
voxblox's merged ray-casting rule, ``tsdf`` by the projective rule the
program defines (min-pool or scatter binning, the HiZ-classified free
and mixed slabs) and folds a scan's samples into the weighted running
average; ``relax`` is a frozen copy of the plain ESDF relaxation, which
the yardstick (``mapbench/yardstick.py``) counts the work of. Every
integrator takes a ``dtype``: float32 is the reference, bfloat16 the
control.
"""
