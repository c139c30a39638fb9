"""Milliseconds of the window over the reconstruction steps completed in it (a scan call counts as its steps)."""

from portbench import readers


def read(view):
    return readers.window_ms(view)
