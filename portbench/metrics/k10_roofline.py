"""Percent of the HBM bound of both K10 kernels (all_gather_rows, reduce_scatter_rows) in a CUDA-only trace
(``k10_roofline.<cells>``)."""

from portbench import readers


def read(view):
    return readers.k10_roofline(view)
