"""Device operations a request, copies included, as ``torch.profiler``
(CUPTI) recorded them on the card in the traced window."""


def read(run):
    if run.trace is None or not run.trace.device_ops or not run.done:
        return None
    return len(run.trace.device_ops) / len(run.done)
