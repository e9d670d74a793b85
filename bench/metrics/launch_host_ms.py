"""Mean host time a request inside the program's ``repro_torch.launch``
spans, in ms: every CUDA kernel's launch (the library's load, the device
context, the stream, the foreign call), read on the profiler's clock."""

from bench import program_spans


def read(run):
    return program_spans.host_ms(run, program_spans.LAUNCH)
