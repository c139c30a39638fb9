"""Kernels on the card a step or frame in a CUDA-only trace, graph replays' kernels included (``launches.<cells>``)."""

from portbench import readers


def read(view):
    return readers.kernel_launches(view)
