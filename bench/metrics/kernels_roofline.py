"""The whole transform's share of its roofline, in %: the least time the
card could take for the window's requests (``bench/work/<name>.py``'s
bytes and operations over ``bench/peaks.py``'s rates, a request at a time)
over the device operations' summed time in the traced window."""

from bench.peaks import least_s


def read(run):
    if run.trace is None or not run.trace.device_ops or not run.done:
        return None
    least = sum(least_s(*run.work(n, b))[0] for n, b in (r.shape for r in run.done))
    return least / run.trace.op_s * 100
