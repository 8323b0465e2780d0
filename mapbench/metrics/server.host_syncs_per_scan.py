"""Host syncs the program makes per scan: its own counter
(``voxblox_tpu_torch._runtime.SYNCS``) read around the traced window.
The benchmark's closing ``torch.cuda.synchronize()`` after each scan
does not pass through that counter, so nothing is subtracted."""


def read(ctx):
    return ctx["host_syncs"] / ctx["scans"]
