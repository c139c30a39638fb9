"""A side-by-side GIF of two frame directories: port of the JAX package's
tools/make_sbs_gif.py, with its flags and its printed line.

Pairs the sorted frames matching ``--pattern`` of ``--left`` (e.g. the bare
render) and ``--right`` (the styled one), places each pair side by side
and writes one looping GIF at ``--fps``. The PNGs are read by
``utils/png.py::read_png`` and the GIF written by
``utils/gif.py::write_gif`` (no imageio). The tool computes on the host
only: it has no device and no ``--platform``.

Where the port differs from the JAX tool: the GIF's palette is the port's
median cut (``utils/gif.py``), so a decoded frame may sit up to one level
further from its PNGs than imageio's palette puts it; an RGBA frame loses
its alpha (GIF frames here are RGB).

    python -m avatarcraft_tpu_torch.tools.make_sbs_gif --left demo/bare --right demo/lava \\
        --pattern '*_body_*.png' --out stylize_lava_sbs.gif [--fps 15] [--max_frames 0]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from avatarcraft_tpu_torch.utils.gif import write_gif
from avatarcraft_tpu_torch.utils.png import read_png


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--left", required=True)
    ap.add_argument("--right", required=True)
    ap.add_argument("--pattern", default="*_body_*.png")
    ap.add_argument("--out", required=True)
    ap.add_argument("--fps", default=15, type=int)
    ap.add_argument("--max_frames", default=0, type=int, help="0 = all")
    return ap


def main(argv=None) -> int:
    """Write the GIF; returns its frame count."""
    opt = build_parser().parse_args(argv)
    lefts = sorted(glob.glob(os.path.join(opt.left, opt.pattern)))
    rights = sorted(glob.glob(os.path.join(opt.right, opt.pattern)))
    n = min(len(lefts), len(rights))
    if opt.max_frames:
        n = min(n, opt.max_frames)
    if n == 0:
        raise SystemExit(f"no frame pairs: {len(lefts)} left, {len(rights)} right")
    frames = []
    for lp, rp in zip(lefts[:n], rights[:n]):
        li, ri = read_png(lp), read_png(rp)
        if li.shape != ri.shape:
            raise SystemExit(f"shape mismatch {lp}{li.shape} vs {rp}{ri.shape}")
        frames.append(np.concatenate([li, ri], axis=1)[..., :3])
    os.makedirs(os.path.dirname(opt.out) or ".", exist_ok=True)
    write_gif(opt.out, frames, fps=opt.fps, loop=0)
    print(f"gif saved: {opt.out} ({n} frames)")
    return n


if __name__ == "__main__":
    main()
