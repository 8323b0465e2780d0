"""Device selection and host-sync accounting shared by the port.

Every entry point takes an explicit ``device``; the default is CUDA and a
missing GPU raises instead of quietly running on the CPU.

Data-dependent loops (hash probe rounds, allocation rounds, the ESDF
outer sweep) are eager Python loops that read one device value per
iteration. On the GPU each read is a host sync: the ``host_*`` functions
and ``to_host`` (exports) are the only places the port reads a device
value on the host, and ``SYNCS`` counts them so a run can report syncs
per scan.
"""

from __future__ import annotations

import numpy as np
import torch

SYNCS = 0
_CONSTS: dict = {}


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port "
            "on the CPU"
        )
    return dev


def const(values, dtype, device) -> torch.Tensor:
    """A small constant tensor on ``device``, uploaded once and reused: a
    copy from pageable host memory synchronizes the stream, so per-call
    ``torch.tensor(..., device=cuda)`` constants would each cost a sync.
    Values round to ``dtype`` as ``torch.tensor`` rounds them."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    a = np.asarray(values, dtype=np_dtype)
    key = (a.tobytes(), a.shape, dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.from_numpy(a.copy()).to(device)
    return t


def host_bool(t) -> bool:
    """Read a device boolean to steer a Python loop (one host sync)."""
    global SYNCS
    SYNCS += 1
    return bool(t)


def host_int(t) -> int:
    """Read a device integer on the host (one host sync)."""
    global SYNCS
    SYNCS += 1
    return int(t)


def host_bools(ts) -> list:
    """Read several device booleans with one transfer (one host sync)."""
    global SYNCS
    if not ts:
        return []
    SYNCS += 1
    return [bool(x) for x in torch.stack([t.reshape(()) for t in ts]).cpu()]


def host_ints(ts) -> list:
    """Read several device integers with one transfer (one host sync)."""
    global SYNCS
    if not ts:
        return []
    SYNCS += 1
    return [int(x) for x in torch.stack(
        [t.reshape(()).to(torch.int64) for t in ts]).cpu()]


def to_host(t) -> np.ndarray:
    """Copy a device tensor to a numpy array (one host sync)."""
    global SYNCS
    SYNCS += 1
    return t.detach().cpu().numpy()
