"""Bake a reconstruction train state into the artifact that bench.py and the
render CLIs read: port of the JAX package's tools/bake_artifact.py, with
its flags, defaults, files and JSON line.

The state is the fast trainer's (``--save_state_every N``): an orbax
directory of either package (``state_latest``) or a port ``.pt`` file,
read through ``utils/checkpoint.py::load_train_state``. The tool writes

    <out>/bare_smpl_tpu.pth.tar              (fp16 encoder tables)
    <out>/bare_smpl_tpu.pth.tar.fieldcfg.json
    <out>/grid.npy                           (the 129^3 density grid)
    <out>/PROVENANCE.json                    (step, source, eval numbers)

The .pth.tar is the reference's torch state_dict format, so the artifact is
also a canonical-avatar checkpoint for stylize and render_warp. The state
is read onto the CUDA card unless ``--platform cpu`` (the JAX tool has no
such flag and reads on the CPU).

    python -m avatarcraft_tpu_torch.tools.bake_artifact --state recon/state_latest \\
        [--out artifacts/canonical] [--psnr_json eval.json] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.utils.checkpoint import load_train_state, save_params_with_config
from avatarcraft_tpu_torch.utils.device import tool_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", required=True, help="train state: an orbax directory or a port .pt file")
    ap.add_argument("--out", default="artifacts/canonical")
    ap.add_argument("--encoder", default="tpu_pyramid")
    ap.add_argument("--fp16_tables", default=True, type=lambda s: s.strip().lower() not in ("false", "0", "no"))
    ap.add_argument("--psnr_json", default=None, help="eval_psnr JSON output to embed as provenance")
    ap.add_argument("--normal_mode", default=None,
                    help="normal estimator the field was trained/evaluated with (fd4|fd7|analytic); recorded in "
                         "PROVENANCE.json and picked up by bench.py and the render CLIs")
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="where the state is read: default, the CUDA card; cpu, the CPU")
    return ap


def main(argv=None) -> dict:
    """Run the tool; returns the JSON result it prints."""
    opt = build_parser().parse_args(argv)
    device = tool_device(opt.platform)

    fcfg = nsr.FieldConfig(encoder=opt.encoder)
    state = load_train_state(opt.state, device)
    if state["grid"] is None:
        raise SystemExit(f"{opt.state} holds no density grid (not a fast trainer's state)")
    step = int(state["step"])
    print(f"loaded step {step} from {opt.state}", file=sys.stderr)

    os.makedirs(opt.out, exist_ok=True)
    ckpt = os.path.join(opt.out, "bare_smpl_tpu.pth.tar")
    save_params_with_config(state["params"], ckpt, fcfg, table_dtype=torch.float16 if opt.fp16_tables else None)
    np.save(os.path.join(opt.out, "grid.npy"), state["grid"].detach().cpu().numpy().astype(np.float32))

    prov = {"source_state": opt.state, "step": step, "encoder": opt.encoder, "fp16_tables": bool(opt.fp16_tables)}
    if opt.normal_mode:
        prov["normal_mode"] = opt.normal_mode
    if opt.psnr_json and os.path.exists(opt.psnr_json):
        with open(opt.psnr_json) as f:
            prov["eval"] = json.load(f)
    with open(os.path.join(opt.out, "PROVENANCE.json"), "w") as f:
        json.dump(prov, f, indent=2)
    sizes = {p: os.path.getsize(os.path.join(opt.out, p)) for p in os.listdir(opt.out)}
    result = {"out": opt.out, "step": step, "bytes": sizes}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
