"""What every job gives the harness."""

from __future__ import annotations

import dataclasses
import hashlib
import os

import torch

from portbench import compare


class Job:
    """A cell's work. ``warm()`` is set-up: the program's objects, the
    first steps or frames that the reference follows, every shape the
    window uses. ``run_one()`` is one call of the window's loop and returns
    the steps or frames it completed; ``finish()`` -> (attempted, failed)
    of the window; ``release()`` frees the program's state;
    ``reference(variant)`` runs the plain reference (``portbench/reference``:
    "f32", its lower-precision control "lower", or a planted fault in
    ``faults``) and returns its witness, which ``compare`` holds against
    another."""

    unit = "step"
    check_units = 0  # window calls that a --check reading makes after warm()
    faults: tuple = ()

    def __init__(self, ctx):
        self.ctx = ctx
        self.device = ctx.device
        self.seed = ctx.seed
        self.config = ctx.cell.config
        self.traffic = ctx.cell.traffic
        self.witness = None
        self.flops_per_unit = None
        self.k10_shape = None  # [rows, cols] of the table the K10 kernels move, where they run

    def counters(self) -> dict:
        """The program's own counters: the K10 kernels' launches."""
        from avatarcraft_tpu_torch.parallel import ring

        return dict(ring.launches)

    def compare(self, got, ref) -> dict:
        return compare.compare_training(got, ref)


def same_field(program_fcfg, group: dict) -> None:
    """Refuse a run whose program field differs from the configuration's."""
    def norm(d):
        return {k: (norm(v) if isinstance(v, dict) else list(v) if isinstance(v, (tuple, list)) else v)
                for k, v in d.items()}

    got = norm(dataclasses.asdict(program_fcfg))
    if got != norm(group):
        raise ValueError(f"the program's field {got} is not the configuration's {norm(group)}")


def table_shape(group: dict) -> tuple[int, int]:
    """[rows, cols] of the table that the fast trainers row-shard and K10
    gathers: the pyramid's finest grid."""
    if group["encoder"] != "tpu_pyramid":
        raise ValueError("the hash-grid trainers launch no K10 kernel")
    r = group["pyramid"]["grid_resolutions"][-1]
    return r**3, group["pyramid"]["grid_dim"]


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        for block in iter(lambda: fp.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def pinned_file(root: str, rel: str, sha256: str) -> str:
    """The path of ``rel`` under the checkout, refused unless its bytes are
    the ones the benchmark names: an input of the repository outside the
    benchmark's folder cannot change under it."""
    path = os.path.join(root, rel)
    if file_sha256(path) != sha256:
        raise ValueError(f"{rel} is not the file the benchmark names (sha256 {sha256})")
    return path


def lowered(variant: str) -> dict:
    """The reference's precisions: as the configuration states them, or for
    the control ("lower") each one step below: the tables' bfloat16 as
    float8 (e4m3), the warp's f32 geometry as bfloat16 (the harness turns
    TF32 on for the MLPs' f32 products)."""
    if variant == "lower":
        return {"table_dtype": torch.float8_e4m3fn, "warp_dtype": torch.bfloat16}
    return {"table_dtype": torch.bfloat16, "warp_dtype": torch.float64}
