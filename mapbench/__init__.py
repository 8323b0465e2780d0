"""The benchmark of the PyTorch/CUDA port (``voxblox_tpu_torch``): the
harness (``run.py``), its data files (``configs/``, ``traffic/``,
``limits/``), per-layer metric readers (``metrics/``), the plain
reference (``reference/``) and the frozen yardstick (``yardstick.py``).
"""
