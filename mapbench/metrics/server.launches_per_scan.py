"""Kernel launches in the traced window over the scans in it (the
profiler's kernel events; the server step's host enqueue)."""


def read(ctx):
    return ctx["launches"] / ctx["scans"] if ctx["launches"] else None
