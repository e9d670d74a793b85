"""Seconds from the process's start to the first request of the window:
imports, the kernel library's load (or build), the inputs, the plans and
the warm-up of every shape the window sends."""


def read(run):
    return run.setup_s
