"""voxblox_tpu_torch: the PyTorch/CUDA port of voxblox_tpu.

Mirrors the JAX package's module layout (core/, io/, models/, ops/,
parallel/, sim/, server/, utils/) on torch tensors. The ESDF relaxation
runs in a hand-written CUDA kernel (csrc/esdf_relax.cu) on the GPU and in
its plain PyTorch version on the CPU. Importing this package imports
torch and numpy only.
"""

__version__ = "0.1.0"

from .core import grid, hash, layer  # noqa: F401
from .core.layer import VoxelLayer, make_layer  # noqa: F401
