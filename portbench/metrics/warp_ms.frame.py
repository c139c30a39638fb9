"""Device ms a frame under the render's ``render.warp`` ranges (the kNN warp, K6), in the full trace. The warp's
kernels run on the one stream, so their durations' sum is the time they hold the card."""

from portbench import readers


def read(view):
    return readers.named_range_ms(view, "render.warp")
