"""Preflight a user-supplied Stable Diffusion checkpoint before a stylize
run: port of the JAX package's tools/preflight_sd.py, with its flags, JSON
line and exit codes (0 GO, 2 NO-GO), and ``--platform``.

1. **Key audit**: each converter (``models/sd.py``'s ``*_params_from_torch``)
   runs on a ``KeyAudit`` of its file's state dict; a missing key fails,
   and the keys no converter read are listed (a diffusers layout, era or
   config mismatch would otherwise load partly random weights). The two
   VAE halves share one file: a key is unconsumed only if neither read it.
2. **Shape audit**: each converted tree against ``init_*``'s tree, leaf by
   leaf (the path as ``jax.tree_util.keystr`` writes it, and the shape),
   the init drawn on the ``meta`` device (shapes, no memory). The text
   encoder's vocabulary comes from the checkpoint's embedding. The port's
   convolutions are OIHW where the JAX package's are HWIO, so a mismatch
   names the port's shapes.
3. **Smoke run**: one SDS image gradient at ``--smoke_res`` and a
   ``--smoke_steps`` PNDM txt2img, decoded; every output finite and the
   gradient not zero.

Files: ``unet.pt``, ``vae.pt``, ``text_encoder.pt`` (+ ``tokenizer/``), or a
diffusers snapshot (``unet/diffusion_pytorch_model.safetensors`` or
``.bin``, ``vae/...``, ``text_encoder/model.safetensors`` or
``pytorch_model.bin``); ``.safetensors`` through the port's own reader
(``utils/safetensors.py``). The converted leaves keep the JAX tool's
dtypes: a file's float16 or bfloat16 stays so (``--cast none``), as the
JAX tool's numpy reader keeps them (bfloat16 through ml_dtypes, which JAX
brings).

Where the port differs from the JAX tool, on purpose:

* ``--platform`` defaults to ``default``, the CUDA card (the JAX tool has
  no flag and runs where JAX's default device is); ``cpu`` runs on the CPU.
* The smoke's image, depth, timestep, noise and initial latents come from
  a ``torch.Generator`` seeded 1 on the device, where the JAX tool draws
  from ``PRNGKey(1)`` to ``PRNGKey(4)``: the flags are compared, not the
  numbers.
* ``--version 2.0``'s txt2img is conditioned on the smoke's depth (resized
  and normalised as the SDS step conditions it); the JAX tool feeds the
  depth UNet 4 channels where it takes 5 and raises.
* ``--cast bfloat16`` (or ``none`` on a float16 file) keeps the parameters
  in that dtype on the device and widens them to float32 at each module
  call (the modules compute in full f32); the JAX tool hands mixed dtypes
  to ``lax.conv_general_dilated``, which raises.

    python -m avatarcraft_tpu_torch.tools.preflight_sd --weights /path/to/dir [--version 2.0] \\
        [--no_smoke] [--platform cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from avatarcraft_tpu_torch.models import sd
from avatarcraft_tpu_torch.models.diffusion import GuidanceModules, SDSGuidance, resize_cubic
from avatarcraft_tpu_torch.utils.checkpoint import leaves, map_leaves, sorted_leaf_paths, sorted_leaves
from avatarcraft_tpu_torch.utils.device import tool_device
from avatarcraft_tpu_torch.utils.safetensors import load_file

SMOKE_SEED = 1
FIXED_TOKEN = 49406  # CLIP's start token, the ids without a tokenizer

_FLAT = {
    "unet": ("unet.pt",),
    "vae": ("vae.pt",),
    "text_encoder": ("text_encoder.pt",),
}
_DIFFUSERS = {
    "unet": ("unet/diffusion_pytorch_model.safetensors", "unet/diffusion_pytorch_model.bin"),
    "vae": ("vae/diffusion_pytorch_model.safetensors", "vae/diffusion_pytorch_model.bin"),
    "text_encoder": ("text_encoder/model.safetensors", "text_encoder/pytorch_model.bin"),
}
_CASTS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def find_module_files(root: str) -> dict[str, str | None]:
    """{module: the first of its flat or diffusers files present, or None}."""
    out: dict[str, str | None] = {}
    for mod in ("unet", "vae", "text_encoder"):
        out[mod] = next((os.path.join(root, rel) for rel in _FLAT[mod] + _DIFFUSERS[mod]
                         if os.path.exists(os.path.join(root, rel))), None)
    return out


def load_state_dict(path: str) -> dict:
    """A state dict file: ``.safetensors`` through the port's reader, else
    ``torch.load`` (``models/sd.py``); CPU tensors in the file's dtypes."""
    return load_file(path) if path.endswith(".safetensors") else sd._load_state_dict(path)


def leaf_shapes(tree) -> dict[str, tuple]:
    """{keystr path: shape} of every leaf."""
    return {p: tuple(leaf.shape) for p, leaf in zip(sorted_leaf_paths(tree), sorted_leaves(tree))}


def audit_one(name: str, state: dict, converter, init_shapes: dict) -> dict:
    """One converter under a KeyAudit: its findings and converted tree."""
    res = {"file_keys": len(state), "missing": [], "unconsumed": [], "shape_mismatches": [], "params": None}
    audited = sd.KeyAudit(state)
    try:
        with sd.source_dtypes():
            res["params"] = converter(audited)
    except KeyError as e:
        res["missing"].append(str(e.args[0]))
        return res
    res["consumed"] = len(audited.consumed)
    res["unconsumed"] = audited.unconsumed()
    got = leaf_shapes(res["params"])
    for path in sorted(set(init_shapes) | set(got)):
        e, g = init_shapes.get(path), got.get(path)
        if e != g:
            res["shape_mismatches"].append(f"{name}{path}: expected {e}, converted {g}")
    return res


def _widened(tree: dict) -> dict:
    """The tree with every leaf float32 (the modules compute in full f32)."""
    return map_leaves(tree, lambda t: t if t.dtype == torch.float32 else t.float())


def preflight(
    weights: str,
    version: str = "1.5",
    smoke: bool = True,
    smoke_res: int = 128,
    smoke_steps: int = 5,
    cast: str = "float32",
    unet_config=None,
    vae_config=None,
    clip_config=None,
    log=print,
    device="cuda",
) -> dict:
    """The full preflight on ``device``; returns the report (``report['go']``
    is the verdict)."""
    ucfg0, vcfg0, tcfg0 = sd.stable_diffusion_configs(version)
    ucfg, vcfg, tcfg = unet_config or ucfg0, vae_config or vcfg0, clip_config or tcfg0

    report: dict = {"weights": weights, "version": version, "modules": {}, "go": True}
    files = find_module_files(weights)
    for mod, path in files.items():
        if path is None:
            report["modules"][mod] = {"error": "file not found"}
            report["go"] = False
            log(f"[preflight] {mod}: NO file found under {weights} (looked for {_FLAT[mod] + _DIFFUSERS[mod]})")
    if not report["go"]:
        return report

    meta = sd.MetaGenerator()
    plan = [
        ("unet", lambda s: sd.unet_params_from_torch(s, ucfg, "cpu"), lambda c: sd.init_unet_params(meta, ucfg)),
        ("vae.encoder", lambda s: sd.vae_encoder_params_from_torch(s, vcfg, "cpu"),
         lambda c: sd.init_vae_encoder_params(meta, vcfg)),
        ("vae.decoder", lambda s: sd.vae_decoder_params_from_torch(s, vcfg, "cpu"),
         lambda c: sd.init_vae_decoder_params(meta, vcfg)),
        ("text_encoder", lambda s: sd.clip_text_params_from_torch(s, tcfg, "cpu"),
         lambda c: sd.init_clip_text_params(meta, c)),
    ]
    loaded = {mod: load_state_dict(p) for mod, p in files.items()}
    converted: dict = {}
    for name, conv, init in plan:
        state = loaded[name.split(".")[0]]
        init_cfg = tcfg
        if name == "text_encoder":
            # the vocabulary rides with the checkpoint, not the config
            emb = state.get("text_model.embeddings.token_embedding.weight",
                            state.get("embeddings.token_embedding.weight"))
            if emb is not None and hasattr(emb, "shape"):
                init_cfg = dataclasses.replace(tcfg, vocab_size=int(emb.shape[0]))
        res = audit_one(name, state, conv, leaf_shapes(init(init_cfg)))
        converted[name] = res.pop("params")
        report["modules"][name] = res
    del loaded

    # the two VAE halves share one file: a key is unconsumed only if
    # neither half's converter read it
    enc, dec = report["modules"]["vae.encoder"], report["modules"]["vae.decoder"]
    if not enc["missing"] and not dec["missing"]:
        enc["unconsumed"] = dec["unconsumed"] = sorted(set(enc["unconsumed"]) & set(dec["unconsumed"]))

    for name, res in report["modules"].items():
        n_param = sum(t.numel() for t in leaves(converted[name])) if converted.get(name) is not None else 0
        res["params_M"] = round(n_param / 1e6, 1)
        ok = not (res["missing"] or res["unconsumed"] or res["shape_mismatches"])
        log(f"[preflight] {name}: {'OK' if ok else 'FAIL'} ({res['file_keys']} file keys, {res['params_M']}M params"
            + (f", missing={res['missing'][:3]}" if res["missing"] else "")
            + (f", unconsumed={len(res['unconsumed'])} e.g. {res['unconsumed'][:3]}" if res["unconsumed"] else "")
            + (f", shape_mismatches={res['shape_mismatches'][:3]}" if res["shape_mismatches"] else "")
            + ")")
        if not ok:
            report["go"] = False

    if not report["go"] or not smoke:
        report["smoke"] = None
        return report
    report["smoke"] = smoke_run(converted, (ucfg, vcfg, tcfg), weights, version, smoke_res, smoke_steps, cast,
                                device, log)
    if not all(report["smoke"][k] for k in ("text_embeds_finite", "sds_grad_finite", "sds_grad_nonzero",
                                             "txt2img_decoded_finite")):
        report["go"] = False
    return report


def smoke_run(converted: dict, configs: tuple, weights: str, version: str, smoke_res: int, smoke_steps: int,
              cast: str, device, log) -> dict:
    """Text embeddings, one SDS image gradient and a short PNDM txt2img on
    ``device`` from the converted trees (cast to ``cast``; ``none`` keeps
    their dtypes); returns the smoke's flags."""
    from avatarcraft_tpu_torch.models.clip_tokenizer import CLIPTokenizer

    ucfg, vcfg, tcfg = configs
    dt = _CASTS.get(cast)
    on_device = {name: map_leaves(tree, lambda t: t.to(device=device, dtype=dt or t.dtype))
                 for name, tree in converted.items()}
    unet_p, enc_p, dec_p, clip_p = (on_device[k] for k in ("unet", "vae.encoder", "vae.decoder", "text_encoder"))

    tok_dir = os.path.join(weights, "tokenizer")
    tokenizer = CLIPTokenizer.from_pretrained(tok_dir) if os.path.exists(os.path.join(tok_dir, "merges.txt")) \
        else None

    def text_encode(prompts):
        if tokenizer is None:
            # no tokenizer assets: fixed ids (the weights are under test, not the BPE)
            ids = torch.full((len(prompts), tcfg.max_len), FIXED_TOKEN % tcfg.vocab_size, dtype=torch.int64,
                             device=device)
        else:
            ids = torch.as_tensor(tokenizer(list(prompts), max_length=tcfg.max_len), dtype=torch.int64,
                                  device=device)
        return sd.clip_text_apply(_widened(clip_p), tcfg, ids)

    mods = GuidanceModules(
        unet=lambda l, t, c: sd.unet_apply(_widened(unet_p), ucfg, l, t, c),
        vae_encode=lambda im: sd.vae_encode_apply(_widened(enc_p), vcfg, im),
        text_encode=text_encode,
        latent_scale=2 ** (len(vcfg.block_out_channels) - 1),
        latent_channels=vcfg.latent_channels,
        image_size=smoke_res,
        vae_decode=lambda lat: sd.vae_decode_apply(_widened(dec_p), vcfg, lat),
        tokenizer=tokenizer,
        use_depth=version == "2.0",
    )
    g = SDSGuidance(mods)
    log(f"[preflight] smoke: text_encode + SDS grad + {smoke_steps}-step PNDM txt2img at {smoke_res}^2 (the first "
        f"call builds what it needs; full-size timing is sds_scale_probe's job)")
    gen = torch.Generator(device).manual_seed(SMOKE_SEED)
    with torch.no_grad():
        emb = g.get_text_embeds(["a DSLR photo of a bronze statue"])
    img = torch.clamp(torch.rand((1, 3, smoke_res, smoke_res), generator=gen, device=device), 0.0, 1.0)
    depth = torch.rand((1, 1, smoke_res, smoke_res), generator=gen, device=device) if mods.use_depth else None
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    grad = g.sds_image_grad(emb, img, 100.0, pred_depth=depth, generator=gen).cpu().numpy()
    sds_s = time.perf_counter() - t0
    if mods.use_depth:
        # SD 2.0-depth: every txt2img step conditioned on the smoke's depth
        side = smoke_res // mods.latent_scale
        d = resize_cubic(depth, (side, side))
        d = 2.0 * (d - d.min()) / (d.max() - d.min() + 1e-12) - 1.0
        g = SDSGuidance(dataclasses.replace(
            mods, unet=lambda l, t, c: mods.unet(torch.cat([l, d.expand(l.shape[0], -1, -1, -1)], dim=1), t, c)))
    lat = g.produce_latents(emb, height=smoke_res, width=smoke_res, num_inference_steps=smoke_steps, generator=gen)
    with torch.no_grad():
        dec = mods.vae_decode(lat).cpu().numpy()
    out = {
        "text_embeds_finite": bool(torch.isfinite(emb).all()),
        "sds_grad_finite": bool(np.isfinite(grad).all()),
        "sds_grad_nonzero": bool(np.abs(grad).sum() > 0),
        "sds_first_call_s": round(sds_s, 1),
        "txt2img_decoded_finite": bool(np.isfinite(dec).all()),
        "tokenizer": "real" if tokenizer is not None else "absent (fixed ids)",
    }
    log(f"[preflight] smoke: {out}")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True,
                    help="directory holding the checkpoint (flat unet.pt/vae.pt/text_encoder.pt or a diffusers "
                         "snapshot)")
    ap.add_argument("--version", default="1.5", choices=["1.5", "2.0"])
    ap.add_argument("--no_smoke", action="store_true", help="audit keys/shapes only (no device execution)")
    ap.add_argument("--smoke_res", default=128, type=int)
    ap.add_argument("--smoke_steps", default=5, type=int)
    ap.add_argument("--cast", default="float32", choices=["float32", "bfloat16", "none"],
                    help="cast converted params before the smoke run")
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="default: the CUDA card; cpu: the CPU")
    return ap


def report_json(report: dict) -> dict:
    """The printed report: every module's findings without its tree."""
    return {k: v for k, v in report.items() if k != "modules"} | {
        "modules": {m: {k: v for k, v in r.items() if k != "params"} for m, r in report["modules"].items()}}


def main(argv=None) -> int:
    """Run the tool; returns its exit code (0 GO, 2 NO-GO)."""
    opt = build_parser().parse_args(argv)
    device = tool_device(opt.platform)
    report = preflight(opt.weights, version=opt.version, smoke=not opt.no_smoke, smoke_res=opt.smoke_res,
                       smoke_steps=opt.smoke_steps, cast=opt.cast, device=device)
    print(json.dumps(report_json(report)))
    print(f"[preflight] verdict: {'GO' if report['go'] else 'NO-GO'}", file=sys.stderr)
    return 0 if report["go"] else 2


if __name__ == "__main__":
    raise SystemExit(main())
