"""Percent of a CUDA-only traced window in which no operation ran on the card (``idle_share.<cells>``)."""

from portbench import readers


def read(view):
    return readers.idle_share(view)
