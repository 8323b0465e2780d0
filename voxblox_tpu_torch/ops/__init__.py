from . import (  # noqa: F401
    esdf,
    intensity,
    interp,
    marching_cubes,
    mesh,
    occupancy,
    raycast,
    render,
    tsdf,
)
