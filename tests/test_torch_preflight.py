"""The port's Stable Diffusion preflight (``avatarcraft_tpu_torch/tools/
preflight_sd.py``) against the JAX package's root ``tools/preflight_sd.py``,
and the port's safetensors reader and writer (``utils/safetensors.py``), on
the CPU at the tiny configs of tests/test_sd_modules.py, with the files
written as tests/test_torch_sd.py's ``_write_sd_files`` writes them. Each
JAX preflight runs once, in the module fixture ``jax_reports``; the port's
runs with ``device="cpu"`` (``--platform cpu`` through ``main``).

Tolerances:
* the printed reports equal JAX's but for the smoke's ``sds_first_call_s``
  (a timing): the audit's findings, the parameter counts, the verdict and
  the smoke's flags; except that a ``shape_mismatches`` string names the
  port's shapes (OIHW convolutions where JAX's are HWIO), so for those the
  count and the module each names are compared;
* ``--no_smoke`` through both tools' ``main``: the printed JSON line equal,
  the exit codes equal (0 GO, 2 NO-GO);
* ``--version 2.0``: the audit equal to JAX's ``--no_smoke`` report; the
  JAX tool's smoke raises there (its txt2img feeds the depth UNet 4
  channels for 5), so the port's smoke, conditioned on the depth, is held
  to its own flags;
* converted leaves: the same dtypes as the JAX tool's reader and
  converters give on the same file (float16 and bfloat16 kept);
* the reader: every tensor bit for bit what was written, in each of the ten
  dtypes, against hand-built bytes and against the ``safetensors`` package
  (present in the test environment; the port does not import it); each
  malformed file refused with a ValueError.
"""

import contextlib
import dataclasses
import io
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models import sd as jsd
from avatarcraft_tpu_torch.models import sd
from avatarcraft_tpu_torch.tools import preflight_sd
from avatarcraft_tpu_torch.utils.checkpoint import leaves, sorted_leaf_paths, sorted_leaves
from avatarcraft_tpu_torch.utils import safetensors as st
from tests.test_torch_sd import _write_sd_files
from tools import preflight_sd as jpreflight

SMOKE = dict(smoke_res=16, smoke_steps=2)
QUIET = dict(log=lambda *a, **k: None)
DIFFUSERS_FILES = {"unet": "unet/diffusion_pytorch_model.safetensors",
                   "vae": "vae/diffusion_pytorch_model.safetensors",
                   "text_encoder": "text_encoder/model.safetensors"}
STRAY_KEY = "down_blocks.0.attentions.1.proj_in.weight"
MISSING_KEY = "mid_block.resnets.1.conv2.weight"
TRUNCATED_KEY = "encoder.down_blocks.0.resnets.0.conv1.weight"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work (tier-1 runs six
    pytest workers on the machine's cores). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_configs(jcfgs):
    return tuple(cls(**dataclasses.asdict(c)) for cls, c in zip((sd.UNetConfig, sd.VAEConfig, sd.CLIPTextConfig), jcfgs))


def _kw(jcfgs, port: bool) -> dict:
    cfgs = _port_configs(jcfgs) if port else jcfgs
    return dict(unet_config=cfgs[0], vae_config=cfgs[1], clip_config=cfgs[2])


def _edit(path, fn):
    state = torch.load(path, weights_only=True)
    fn(state)
    torch.save(state, path)


def _to_snapshot(root):
    """The flat .pt files moved into a diffusers snapshot of .safetensors
    written by the port's writer."""
    for mod, rel in DIFFUSERS_FILES.items():
        state = torch.load(os.path.join(root, f"{mod}.pt"), weights_only=True)
        os.remove(os.path.join(root, f"{mod}.pt"))
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        st.save_file(state, os.path.join(root, rel))


def _write_cases(root):
    """{case: (directory, JAX configs, version)} for every case."""
    cases = {}

    def new(name, version="1.5"):
        path = root / name
        path.mkdir()
        cases[name] = (str(path), _write_sd_files(path, version), version)
        return path

    new("good")
    _edit(new("stray") / "unet.pt", lambda s: s.__setitem__(STRAY_KEY, torch.zeros(2, 2)))
    os.remove(new("missing_file") / "vae.pt")
    _edit(new("missing_key") / "unet.pt", lambda s: s.pop(MISSING_KEY))
    _edit(new("truncated") / "vae.pt", lambda s: s.__setitem__(TRUNCATED_KEY, s[TRUNCATED_KEY][:-1].clone()))
    new("depth", "2.0")
    snapshot = new("snapshot")
    _to_snapshot(snapshot)
    return cases


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return _write_cases(tmp_path_factory.mktemp("preflight"))


def _printed(report: dict) -> dict:
    return json.loads(json.dumps(preflight_sd.report_json(report)))


def _jax_printed(report: dict) -> dict:
    return {k: v for k, v in report.items() if k != "modules"} | {
        "modules": {m: {k: v for k, v in r.items() if k != "params"} for m, r in report["modules"].items()}}


@pytest.fixture(scope="module")
def jax_reports(cases):
    """The JAX tool once per case: with the smoke on the good directory,
    without it elsewhere (its smoke raises at 2.0)."""
    out = {}
    for name, (path, jcfgs, version) in cases.items():
        if name == "snapshot":
            continue
        out[name] = _jax_printed(jpreflight.preflight(path, version=version, smoke=name == "good",
                                                      **_kw(jcfgs, False), **SMOKE, **QUIET))
    return out


def _port_report(cases, name: str, smoke: bool = False) -> dict:
    path, jcfgs, version = cases[name]
    return _printed(preflight_sd.preflight(path, version=version, smoke=smoke, **_kw(jcfgs, True), **SMOKE,
                                           **QUIET, device="cpu"))


def _without_timing(report: dict) -> dict:
    out = json.loads(json.dumps(report))
    if out.get("smoke"):
        out["smoke"].pop("sds_first_call_s")
    return out


def _shapes_apart(report: dict) -> tuple[dict, dict]:
    """(the report without its shape strings, {module: [module named by
    each string]})."""
    out, named = json.loads(json.dumps(report)), {}
    for mod, res in out["modules"].items():
        named[mod] = [s.split("[", 1)[0] for s in res.pop("shape_mismatches", [])]
    return out, named


def test_good_directory_is_go_and_matches_jax(cases, jax_reports):
    """A good flat directory: GO with every smoke flag true in both
    packages, the reports equal but for the smoke's timing."""
    mine = _port_report(cases, "good", smoke=True)
    assert mine["go"] and mine["smoke"]["tokenizer"] == "real"
    assert _without_timing(mine) == _without_timing(jax_reports["good"])


@pytest.mark.parametrize("name", ["stray", "missing_file", "missing_key"])
def test_no_go_reports_match_jax(cases, jax_reports, name):
    """A stray UNet key (the same ``unconsumed``), a missing file and a
    missing key: NO-GO, the reports equal."""
    mine = _port_report(cases, name)
    assert not mine["go"]
    assert mine == jax_reports[name]
    if name == "stray":
        assert mine["modules"]["unet"]["unconsumed"] == [STRAY_KEY]
    if name == "missing_key":
        assert mine["modules"]["unet"]["missing"] == [MISSING_KEY]


def test_truncated_tensor_names_the_same_module(cases, jax_reports):
    """A tensor one row short: NO-GO, as many shape mismatches as JAX's,
    each naming the same module; the rest of the report equal."""
    mine, named = _shapes_apart(_port_report(cases, "truncated"))
    want, want_named = _shapes_apart(jax_reports["truncated"])
    assert not mine["go"] and mine == want
    assert named == want_named and named["vae.encoder"] == ["vae.encoder"]


def test_no_smoke_main_matches_jax(cases, capsys):
    """``--no_smoke`` through both tools' main: the printed JSON line and
    the exit code equal, GO on the good directory and NO-GO on the stray
    key's."""
    for name, rc in (("good", 0), ("stray", 2)):
        path, jcfgs, _ = cases[name]
        with pytest.MonkeyPatch.context() as m:  # the tiny configs stand in for the published ones
            m.setattr(jsd, "UNetConfig", lambda: jcfgs[0])
            m.setattr(jsd, "VAEConfig", lambda: jcfgs[1])
            m.setattr(jsd, "CLIPTextConfig", lambda: jcfgs[2])
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                want_rc = jpreflight.main(["--weights", path, "--no_smoke"])
            m.setattr(sd, "stable_diffusion_configs", lambda version: _port_configs(jcfgs))
            got_rc = preflight_sd.main(["--weights", path, "--no_smoke", "--platform", "cpu"])
        got = capsys.readouterr().out.strip().splitlines()[-1]
        assert (got_rc, want_rc) == (rc, rc)
        assert json.loads(got) == json.loads(out.getvalue().strip().splitlines()[-1])


def test_version_2_audit_matches_jax_and_smoke_is_depth_conditioned(cases, jax_reports):
    """``--version 2.0``: the audit equal to JAX's; the port's smoke (the
    SDS step and every txt2img step conditioned on the depth) GO with
    every flag true. The JAX tool's smoke raises at 2.0."""
    mine = _port_report(cases, "depth", smoke=True)
    assert mine["go"] and all(mine["smoke"][k] for k in ("text_embeds_finite", "sds_grad_finite",
                                                         "sds_grad_nonzero", "txt2img_decoded_finite"))
    assert {k: v for k, v in mine.items() if k != "smoke"} == {k: v for k, v in jax_reports["depth"].items()
                                                                if k != "smoke"}
    path, jcfgs, _ = cases["depth"]
    with pytest.raises(ValueError, match="4 // 1 != 5"):
        jpreflight.preflight(path, version="2.0", **_kw(jcfgs, False), **SMOKE, **QUIET)


def test_diffusers_snapshot_report_equals_the_pt_copy(cases, jax_reports):
    """The same tensors as a diffusers snapshot of .safetensors (the port's
    writer): the port's report equals its report of the .pt files, and
    the JAX tool's of the snapshot (read by the safetensors package)."""
    mine = _port_report(cases, "snapshot")
    path, jcfgs, _ = cases["snapshot"]
    want = _jax_printed(jpreflight.preflight(path, smoke=False, **_kw(jcfgs, False), **QUIET))
    assert mine == want
    good = dict(_port_report(cases, "good"), weights=path)
    assert mine == good


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_converted_leaves_keep_jax_dtypes(tmp_path, dtype):
    """A .safetensors UNet in float16 or bfloat16 converts to leaves of that
    dtype, leaf for leaf as the JAX tool's reader (numpy, bfloat16 through
    ml_dtypes) and converter give them; the leaves a converter makes up
    are float32 in both."""
    jcfgs = _write_sd_files(tmp_path, "1.5")
    state = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in torch.load(tmp_path / "unet.pt", weights_only=True).items()}
    path = str(tmp_path / "unet.safetensors")
    st.save_file(state, path)
    with sd.source_dtypes():
        mine = sd.unet_params_from_torch(preflight_sd.load_state_dict(path), _port_configs(jcfgs)[0], "cpu")
    want = jsd.unet_params_from_torch(jpreflight._load_sd(path), jcfgs[0])
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    want_dtypes = {jax.tree_util.keystr(p): str(np.dtype(x.dtype)) for p, x in flat}
    got_dtypes = {p: str(t.dtype).replace("torch.", "")
                  for p, t in zip(sorted_leaf_paths(mine), sorted_leaves(mine))}
    assert got_dtypes == want_dtypes
    assert set(got_dtypes.values()) == {str(dtype).replace("torch.", ""), "float32"}
    # outside the preflight every converted leaf is float32, as the loader wants
    assert {t.dtype for t in leaves(sd.unet_params_from_torch(
        preflight_sd.load_state_dict(path), _port_configs(jcfgs)[0], "cpu"))} == {torch.float32}


# ---------------------------------------------------------------------------
# the safetensors reader and writer
# ---------------------------------------------------------------------------

# (format name, numpy dtype of the stored bytes, values)
DTYPE_CASES = [
    ("F64", "<f8", [1.5, -2.25e300, np.pi]),
    ("F32", "<f4", [0.1, -3.4e38, 1e-45]),
    ("F16", "<f2", [0.5, 65504.0, -5.96e-8]),
    ("BF16", "<u2", [0x3F80, 0xC2F7, 0x0001, 0x7F80]),  # 1.0, -123.5, the least subnormal, inf
    ("I64", "<i8", [-(2**63), 2**63 - 1, 7]),
    ("I32", "<i4", [-(2**31), 2**31 - 1]),
    ("I16", "<i2", [-32768, 32767, 5]),
    ("I8", "i1", [-128, 127]),
    ("U8", "u1", [0, 255, 9]),
    ("BOOL", "?", [True, False, True]),
]


def _hand_written(path, entries, data: bytes, pad: int = 0, header_len=None):
    """A file of ``entries`` ({name: header entry}) and ``data``, the header
    padded with ``pad`` spaces, built byte by byte."""
    text = json.dumps(entries).encode() + b" " * pad
    with open(path, "wb") as fp:
        fp.write(struct.pack("<Q", len(text) if header_len is None else header_len) + text + data)


def test_reader_reads_every_dtype_bit_for_bit(tmp_path):
    """One hand-built file holding a tensor of each of the ten dtypes (with
    unaligned spans: the items follow each other byte for byte) and
    ``__metadata__``: each read back bit for bit, bf16 as torch.bfloat16,
    and as the safetensors package reads the same file."""
    from safetensors.torch import load_file as package_load

    entries, data, want = {"__metadata__": {"format": "pt"}}, b"", {}
    for i, (name, np_dtype, values) in enumerate(DTYPE_CASES):
        arr = np.asarray(values, dtype=np_dtype).reshape(-1, 1) if i % 2 else np.asarray(values, dtype=np_dtype)
        raw = arr.tobytes()
        entries[f"t{i}_{name}"] = {"dtype": name, "shape": list(arr.shape), "data_offsets": [len(data), len(data)
                                                                                             + len(raw)]}
        data += raw
        want[f"t{i}_{name}"] = (name, arr)
    path = str(tmp_path / "all.safetensors")
    _hand_written(path, entries, data, pad=3)
    got, ref = st.load_file(path), package_load(path)
    assert list(got) == [k for k in entries if k != "__metadata__"]
    for key, (name, arr) in want.items():
        t = got[key]
        if name == "BF16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view("<u2"), arr)
        else:
            assert t.numpy().dtype == arr.dtype and t.numpy().tobytes() == arr.tobytes()
            assert tuple(t.shape) == arr.shape
        assert ref[key].dtype == t.dtype and torch.equal(ref[key].view(torch.uint8) if t.dtype != torch.bool
                                                         else ref[key], t.view(torch.uint8) if t.dtype != torch.bool
                                                         else t)


def test_writer_round_trips_through_both_readers(tmp_path):
    """The port's writer: the port's reader and the safetensors package read
    every tensor back bit for bit, in every dtype, empty ones included."""
    from safetensors.torch import load_file as package_load

    g = torch.Generator().manual_seed(0)
    tensors = {"f64": torch.randn(3, 2, generator=g, dtype=torch.float64), "bf16": torch.randn(5, generator=g)
               .to(torch.bfloat16), "f16": torch.randn(2, 3, generator=g).half(), "f32": torch.randn(4, generator=g),
               "i64": torch.arange(-3, 3), "i32": torch.arange(5, dtype=torch.int32),
               "i16": torch.arange(3, dtype=torch.int16), "i8": torch.tensor([-128, 5], dtype=torch.int8),
               "u8": torch.tensor([0, 255], dtype=torch.uint8), "bool": torch.tensor([True, False]),
               "empty": torch.zeros(0, 3)}
    path = str(tmp_path / "w.safetensors")
    st.save_file(tensors, path, {"format": "pt"})
    for got in (st.load_file(path), package_load(path)):
        assert set(got) == set(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    with open(path, "rb") as fp:
        (n,) = struct.unpack("<Q", fp.read(8))
    assert n % 8 == 0


def _spans_file(tmp_path, offsets, data_len: int = 16, **kw):
    entries = {f"t{i}": {"dtype": "F32", "shape": [(e - b) // 4], "data_offsets": [b, e]}
               for i, (b, e) in enumerate(offsets)}
    path = str(tmp_path / "bad.safetensors")
    _hand_written(path, entries, bytes(range(data_len)), **kw)
    return path


@pytest.mark.parametrize("kind, match", [
    ("outside", "outside"), ("overlap", "overlaps"), ("gap", "belong to no tensor"),
    ("short", "end at data byte"), ("trailing", "end at data byte"), ("shape", "not its F32 shape"),
    ("dtype", "malformed entry"), ("not_json", "not JSON"), ("header_past_end", "past the end"),
    ("no_length", "header's length field"),
])
def test_reader_refuses_malformed_files(tmp_path, kind, match):
    """Spans outside the data, overlapping, leaving a gap, ending before
    the data does or with bytes after it, a size that is not the shape's,
    an unknown dtype, a header that is not JSON or runs past the file, a
    file shorter than the length field: each a ValueError."""
    path = str(tmp_path / "bad.safetensors")
    if kind == "outside":
        path = _spans_file(tmp_path, [(0, 8), (8, 24)])
    elif kind == "overlap":
        path = _spans_file(tmp_path, [(0, 8), (4, 12), (12, 16)])
    elif kind == "gap":
        path = _spans_file(tmp_path, [(0, 4), (8, 16)])
    elif kind == "short":
        path = _spans_file(tmp_path, [(0, 8)])
    elif kind == "trailing":
        path = _spans_file(tmp_path, [(0, 16)], data_len=20)
    elif kind == "shape":
        _hand_written(path, {"t": {"dtype": "F32", "shape": [3], "data_offsets": [0, 16]}}, bytes(16))
    elif kind == "dtype":
        _hand_written(path, {"t": {"dtype": "F8_E4M3", "shape": [16], "data_offsets": [0, 16]}}, bytes(16))
    elif kind == "not_json":
        with open(path, "wb") as fp:
            fp.write(struct.pack("<Q", 5) + b"{oops" + bytes(8))
    elif kind == "header_past_end":
        _hand_written(path, {"t": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"", header_len=4096)
    else:
        with open(path, "wb") as fp:
            fp.write(b"\x01\x02")
    with pytest.raises(ValueError, match=match):
        st.load_file(path)
