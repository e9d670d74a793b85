"""Mean host time a request inside the program's ``repro_torch.execute``
span that none of its inner ``repro_torch.*`` spans covers, in ms: the
API's own Python (the plan's checks, routing, reshapes, the answer's
view), read on the profiler's clock."""

from bench import program_spans


def read(run):
    return program_spans.self_ms(run, program_spans.EXECUTE)
