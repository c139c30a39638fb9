"""Host ms a frame of the body's work in the benchmark's own spans, over the untraced window: the sequence's
transforms (``calc_local_trans``), a frame's share of each pass (the pass's time over the sequence's frames), and
the posed body's set-up (``WarpData.create``) of each frame."""


def read(view):
    passes = view.spans.seconds("body.sequence", since=view.window_start, until=view.window_end)
    frames = view.spans.seconds("body.frame", since=view.window_start, until=view.window_end)
    if not passes or not frames:
        return None
    return 1e3 * (sum(passes) / len(passes) / view.job.n_frames + sum(frames) / len(frames))
