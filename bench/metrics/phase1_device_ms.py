"""Mean device time a request of the operations launched inside the
program's ``repro_torch.phase1`` span, in ms (``bench/program_spans.py``
pairs each launching call with its device operation)."""

from bench import program_spans


def read(run):
    return program_spans.device_ms(run, program_spans.PREFIX + "phase1")
