"""The device memory one caller needs, in GiB: the allocator's peak over
the window (``torch.cuda.max_memory_allocated()``, reset at its start) less
what the harness held through it (every input it made, an answer a shape
kept for the check), plus the largest request's input, which a caller
holds.  So it is the program's own peak (its plans, working arrays and
answer) and one input."""


def read(run):
    if run.peak_bytes is None:
        return None
    return (run.peak_bytes - run.held_bytes + run.request_bytes) / 2 ** 30
