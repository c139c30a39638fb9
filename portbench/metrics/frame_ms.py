"""Milliseconds of the window over the animated frames completed in it."""

from portbench import readers


def read(view):
    return readers.window_ms(view)
