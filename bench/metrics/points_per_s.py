"""Signal points transformed in the window (batch·n² over the requests
done) over the window's seconds, in millions a second."""


def read(run):
    if not run.done:
        return None
    return sum(b * n * n for n, b in (r.shape for r in run.done)) / run.window_s / 1e6
