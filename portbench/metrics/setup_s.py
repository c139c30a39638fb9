"""Seconds from the process's start to the window's: imports, builds, inputs, weights, warm-up."""

def read(view):
    return view.setup_s
