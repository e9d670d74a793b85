"""The card's idle share of the traced window, in %: one less the union of
its operations' intervals over the window."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return (1 - run.trace.busy_s / run.trace.window_s) * 100
