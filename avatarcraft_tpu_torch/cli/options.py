"""Reference-compatible flag groups (the reference's options.py:57-96), a
copy of the JAX package's flag-group module: the flag names are kept so that
command lines written for the reference work as they are. ``--use_cuda``
selects the CUDA card; false = the CPU."""

from __future__ import annotations

import argparse
import os


def str2bool(v: str) -> bool:
    return str(v).lower() in ("true", "1", "yes", "y", "t")


def set_general_option(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("General")
    g.add_argument("--use_cuda", type=str2bool, default=True, help="run on the CUDA card; false = CPU")


def set_nerf_option(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("NeRF")
    g.add_argument("--nerf_depth", type=int, default=8)
    g.add_argument("--nerf_width", type=int, default=256)
    g.add_argument("--use_viewdirs", type=str2bool, default=True)
    g.add_argument("--specular_can", type=str2bool, default=True)


def set_pe_option(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("Positional Encoding")
    g.add_argument("--raw_pos_dim", type=int, default=3)
    g.add_argument("--pos_min_freq", type=int, default=0)
    g.add_argument("--pos_max_freq", type=int, default=9)
    g.add_argument("--pos_N_freqs", type=int, default=10)
    g.add_argument("--raw_dir_dim", type=int, default=3)
    g.add_argument("--dir_max_freq", type=int, default=3)
    g.add_argument("--dir_N_freqs", type=int, default=4)
    g.add_argument("--log_sampling", type=bool, default=True)
    g.add_argument("--include_input", type=bool, default=True)
    g.add_argument("--can_posenc", type=str, default="rotate")


def set_render_option(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("Rendering")
    g.add_argument("--rays_per_batch", default=2048, type=int)
    g.add_argument("--samples_per_ray", default=128, type=int)
    g.add_argument("--render_h", default=None, type=int)
    g.add_argument("--render_w", default=None, type=int)
    g.add_argument("--weights_path", required=False, default=None, type=str)
    g.add_argument("--white_bkg", type=str2bool, default=True, required=False)


def set_trajectory_option(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("Trajectory")
    g.add_argument("--trajectory_resolution", default=60, type=int)


def print_opt(opt, out_dir: str | None = None) -> None:
    """Dump sorted flags to stdout and (optionally) <exp>_args.txt
    (the reference's options.py:17-32)."""
    lines = [arg.rjust(25, " ") + "  " + str(getattr(opt, arg)) for arg in sorted(vars(opt))]
    print("\n".join(["-" * 60, "OPTIONS"] + lines + ["-" * 60]))
    exp = getattr(opt, "exp_name", None)
    if exp:
        d = out_dir or os.path.join("./style", "canonical_360", exp)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{exp}_args.txt"), "w") as fh:
            fh.write("\n".join(sorted(lines, key=lambda x: x.lstrip())) + "\n")


def note_unread_implicit_model(opt, cli: str) -> None:
    """Print one line where ``--implicit_model`` names another field than
    instant_nsr: the JAX package's ``cli`` parses the flag and never reads
    it (it always runs instant-NSR), and the port does the same."""
    if opt.implicit_model != "instant_nsr":
        print(f"[{cli}] --implicit_model {opt.implicit_model} has no effect here: {cli} runs the "
              "instant-NSR field, as the JAX package's does")
