"""Percent of the card's f32 peak: the model FLOPs of the units the untraced window completed over its length
(``mfu.<cells>``)."""

from portbench import readers


def read(view):
    return readers.mfu(view)
