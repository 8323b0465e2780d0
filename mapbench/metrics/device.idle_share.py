"""Share of the traced window in which no kernel, copy or fill ran on the
device: one less the union of their intervals over the window."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
