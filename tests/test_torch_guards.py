"""Guards for what the card's machine needs of the PyTorch port: it imports
without JAX, the JAX package, imageio, cv2, PIL, regex, transformers,
diffusers, orbax, tensorstore or zstandard (the modules of every slice
reached); entry points default to the card; a scan of
train steps on the card never runs its steps eagerly; chip_smoke.py fails loudly
without a card or without the package; kernels build for sm_90a into a
directory git ignores; the wrapper never falls back to the CPU."""

import os
import re
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import avatarcraft_tpu_torch
from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.utils import cuda_build
from avatarcraft_tpu_torch.utils.metrics import integerify_img
from avatarcraft_tpu_torch.utils.png import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(avatarcraft_tpu_torch.__file__))
BLOCKED = ("jax", "jaxlib", "imageio", "cv2", "PIL", "avatarcraft_tpu", "regex", "transformers", "diffusers",
           "orbax", "tensorstore", "zstandard")
KERNELS = (ring.KERNEL, ring.RS_KERNEL)
# modules of the training slice, which the import guard must reach
TRAIN_MODULES = (
    "avatarcraft_tpu_torch.ops.sampling",
    "avatarcraft_tpu_torch.ops.occupancy",
    "avatarcraft_tpu_torch.parallel.table_mp",
    "avatarcraft_tpu_torch.workloads.reconstruct",
    "avatarcraft_tpu_torch.profile_train",
)
# modules of the animate / reshape slice
WARP_MODULES = (
    "avatarcraft_tpu_torch.models.smpl",
    "avatarcraft_tpu_torch.data.amass",
    "avatarcraft_tpu_torch.data.smpl_dataset",
    "avatarcraft_tpu_torch.warp.warp",
    "avatarcraft_tpu_torch.workloads.warp_render",
    "avatarcraft_tpu_torch.cli.render_warp_cli",
    "avatarcraft_tpu_torch.utils.style_delta",
)
# modules of the stylize slice
STYLIZE_MODULES = (
    "avatarcraft_tpu_torch.models.sd",
    "avatarcraft_tpu_torch.models.diffusion",
    "avatarcraft_tpu_torch.models.toy_guidance",
    "avatarcraft_tpu_torch.utils.background",
    "avatarcraft_tpu_torch.workloads.stylize",
    "avatarcraft_tpu_torch.cli.options",
    "avatarcraft_tpu_torch.cli.stylize_cli",
)
# modules of the Stable Diffusion guidance slice
SD_MODULES = (
    "avatarcraft_tpu_torch.models.clip_tokenizer",
)
# modules of the reconstruction slice
RECON_MODULES = (
    "avatarcraft_tpu_torch.ops.hash_encoder",
    "avatarcraft_tpu_torch.cli.reconstruct_cli",
    "avatarcraft_tpu_torch.utils.marching_cubes",
    "avatarcraft_tpu_torch.utils.mesh_export",
    "avatarcraft_tpu_torch.utils.metrics",
)
# modules of the multi-prompt slice and the native mesh extractor
MULTI_MODULES = (
    "avatarcraft_tpu_torch.workloads.multi_stylize",
    "avatarcraft_tpu_torch.tools.run_multi_stylize",
    "avatarcraft_tpu_torch.utils.native",
)
# modules of the mesh slice (several ranks)
MESH_MODULES = (
    "avatarcraft_tpu_torch.parallel.mesh",
    "avatarcraft_tpu_torch.parallel.dryrun",
)
# modules of the scan trainer and the outputs slice
OUTPUT_MODULES = (
    "avatarcraft_tpu_torch.utils.gif",
    "avatarcraft_tpu_torch.utils.profiling",
    "avatarcraft_tpu_torch.utils.overlay",
    "avatarcraft_tpu_torch.utils.misc",
    "avatarcraft_tpu_torch.cli.render_canonical_cli",
)
# modules of the legacy-model and orbax-reader slice
LEGACY_MODULES = (
    "avatarcraft_tpu_torch.ops.freq_encoder",
    "avatarcraft_tpu_torch.ops.sh_encoder",
    "avatarcraft_tpu_torch.models.neus",
    "avatarcraft_tpu_torch.models.nerf",
    "avatarcraft_tpu_torch.workloads.hybrid",
    "avatarcraft_tpu_torch.utils.orbax",
)


def _env_without_repo():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_imports_without_jax_imageio_cv2():
    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
sys.path.insert(0, {REPO!r})
import avatarcraft_tpu_torch
for m in pkgutil.walk_packages(avatarcraft_tpu_torch.__path__, "avatarcraft_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
missing = [m for m in {TRAIN_MODULES + WARP_MODULES + STYLIZE_MODULES + SD_MODULES + RECON_MODULES + MULTI_MODULES
                      + OUTPUT_MODULES + MESH_MODULES + LEGACY_MODULES!r}
           if m not in sys.modules]
print("imports ok" if not missing else f"not imported: {{missing}}")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=_env_without_repo())
    assert res.returncode == 0, res.stderr
    assert "imports ok" in res.stdout


def test_nothing_turns_tf32_on():
    """The warp's nearest-vertex distances cancel badly under TF32, so no
    source of the port or chip_smoke.py may turn TF32 matrix products on
    (chip_smoke.py turns them off and checks it around the warp path), and
    a warp frame leaves the flags as it found them."""
    sources = list(_port_sources()) + [os.path.join(REPO, "chip_smoke.py")]
    for path in sources:
        with open(path) as fp:
            text = fp.read()
        assert not re.search(r"allow_tf32\s*=\s*True", text), path
        assert "set_float32_matmul_precision" not in text and "fp32_precision" not in text, path
    with open(os.path.join(REPO, "chip_smoke.py")) as fp:
        smoke = fp.read()
    assert "torch.backends.cuda.matmul.allow_tf32 = False" in smoke
    assert '_require_full_f32("after the warp path")' in smoke

    from avatarcraft_tpu_torch.models import instant_nsr as nsr
    from avatarcraft_tpu_torch.models.smpl import synthetic_smpl_params
    from avatarcraft_tpu_torch.warp import WarpData
    from avatarcraft_tpu_torch.workloads import warp_render

    model = synthetic_smpl_params(0, n_verts=40, n_joints=6)
    wv, Ts, _ = warp_render.calc_local_trans(model, render_type="interp_shape", max_frames=1)
    fcfg = nsr.FieldConfig(encoder="tpu_pyramid", packed_dtype="float32",
                           pyramid=nsr.PyramidSpec(grid_resolutions=(4,), grid_dim=2, plane_resolutions=(9,),
                                                   plane_dim=2))
    params = nsr.init_field_params(torch.Generator().manual_seed(0), fcfg)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    render = warp_render.make_warp_frame_renderer_fast(params, fcfg, warp_render.WarpRenderSettings(), 0)
    o = torch.tensor([[0.0, 0.0, 2.0]]).expand(8, 3).contiguous()
    rgb = render(o, torch.tensor([[0.0, 0.0, -1.0]]).expand(8, 3).contiguous(),
                 WarpData.create(wv[0], model.faces, Ts[0], "cpu"))
    assert rgb.shape == (8, 3) and torch.isfinite(rgb).all()
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == before
    assert before[0] is False and before[2] == "highest"


def _port_sources():
    for root, _, files in os.walk(PKG):
        if "_build" in root or "__pycache__" in root:
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)


def test_port_never_names_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 15
    for path in sources:
        with open(path) as fp:
            text = fp.read()
        assert not re.search(r"avatarcraft_tpu(?!_torch)", text), path
        assert not re.search(r"^\s*(import|from)\s+(jax|imageio|cv2|regex|transformers|diffusers|orbax|tensorstore"
                             r"|zstandard)\b", text, re.M), path


def test_chip_smoke_without_card_fails():
    res = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=_env_without_repo())
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "is_available() is false" in res.stdout + res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env=_env_without_repo())
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "avatarcraft_tpu_torch" in res.stderr


@pytest.mark.parametrize("name", KERNELS)
def test_nvcc_command_targets_sm90a(name):
    cmd = cuda_build.nvcc_command(name, "/x/lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-fPIC" in cmd and "-O3" in cmd
    assert cmd[-1] == cuda_build.source_path(name) and os.path.isfile(cmd[-1])
    assert not any(part.startswith("-I") for part in cmd)  # no PyTorch headers


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_source_names_what_it_replaces(name):
    with open(cuda_build.source_path(name)) as fp:
        src = fp.read()
    assert "parallel/ring.py:27" in src and "_ring_all_gather_kernel" in src
    assert 'extern "C"' in src and "cudaGetLastError" in src
    assert f"{name}_error_string" in src
    assert "#include <torch" not in src and "#include <ATen" not in src


@pytest.mark.parametrize("wrapper,plain", [
    (ring.all_gather_rows, "all_gather_rows_plain"), (ring.reduce_scatter_rows, "reduce_scatter_rows_plain"),
])
def test_wrapper_takes_plain_version_only_on_cpu(wrapper, plain):
    """By inspection of the dispatch: the plain version is called once, as
    the body of the ``device.type == "cpu"`` branch; past it a tensor that
    is not on the CPU launches the kernel (other devices were refused by
    the checks before)."""
    import inspect

    lines = [ln.strip() for ln in inspect.getsource(wrapper).splitlines()]
    calls = [i for i, ln in enumerate(lines) if f"{plain}(" in ln]
    assert len(calls) == 1
    assert lines[calls[0] - 1] == 'if first.device.type == "cpu":'
    assert lines[calls[0]].startswith("return ")
    assert any("launch" in ln for ln in lines[calls[0] + 1 :])
    with pytest.raises(ValueError, match="cpu or cuda"):
        wrapper([torch.zeros(4, 2, device="meta")], *([2] if plain.startswith("reduce") else []))


@pytest.mark.parametrize("wrapper,plain,arg", [
    (ring.ring_all_gather, "ring_all_gather_plain", "shard"), (ring.ring_reduce_scatter, "ring_reduce_scatter_plain", "ct"),
    (ring.ring_all_reduce, "ring_all_reduce_plain", "x"),
])
def test_cross_rank_wrappers_take_plain_version_only_on_cpu(wrapper, plain, arg):
    """The cross-rank wrappers, by inspection of the dispatch: past the
    one-rank branch (the one-card kernels) and the checks, the plain
    version is called once, as the body of the ``device.type == "cpu"``
    branch; a CUDA tensor goes on to the peer kernel's launch, which counts
    it. A tensor on another device is refused."""
    import inspect

    from avatarcraft_tpu_torch.parallel.mesh import Mesh

    lines = [ln.strip() for ln in inspect.getsource(wrapper).splitlines()]
    calls = [i for i, ln in enumerate(lines) if f"{plain}(" in ln]
    assert len(calls) == 1
    assert lines[calls[0] - 1] == f'if {arg}.device.type == "cpu":'
    assert lines[calls[0]].startswith("return ")
    name = {"ring_all_gather_plain": "PEER_GATHER", "ring_reduce_scatter_plain": "PEER_RS",
            "ring_all_reduce_plain": "PEER_AR"}[plain]
    assert any(f"_launch_peer({name}," in ln for ln in lines[calls[0] + 1 :])
    launcher = inspect.getsource(ring._launch_peer)
    assert "ring_peer_" in launcher and "launches[name] += 1" in launcher
    mesh = Mesh(2, 0, torch.device("cpu"), None)
    with pytest.raises(ValueError, match="cpu or cuda"):
        wrapper(torch.zeros(4, 2, device="meta"), mesh)


def test_cross_rank_kernel_source_names_what_it_replaces():
    with open(cuda_build.source_path(ring.PEER_LIB)) as fp:
        src = fp.read()
    assert "parallel/ring.py:27" in src and "_ring_all_gather_kernel" in src and "psum_scatter" in src
    assert 'extern "C"' in src and "cudaGetLastError" in src and "ring_peer_error_string" in src
    assert "ld.acquire.sys" in src and "st.release.sys" in src and "%globaltimer" in src
    assert "#include <torch" not in src and "#include <ATen" not in src
    assert "arch=compute_90a,code=sm_90a" in cuda_build.nvcc_command(ring.PEER_LIB, "/x/lib.so")


def test_cross_rank_calls_take_no_host_sequence_number_and_no_sync():
    """Each cross-rank call of csrc/ring_peer.cu is one launch of its
    kernel, and no function of its C interface synchronises: a CUDA graph
    can hold a call. The sequence number lives in the buffer on the card:
    neither the C calls nor ring.py's wrappers pass one."""
    import inspect

    with open(cuda_build.source_path(ring.PEER_LIB)) as fp:
        src = fp.read()
    assert "cudaStreamSynchronize" not in src and src.count("<<<") == 1
    extern = src[src.index('extern "C" {'):]
    for fn in ("ring_peer_all_gather", "ring_peer_reduce_scatter", "ring_peer_all_reduce"):
        signature = re.search(rf"int {fn}\(([^)]*)\)", extern).group(1)
        assert "seq" not in signature and "unsigned long long" not in signature, fn
        body = extern[extern.index(f"int {fn}("):]
        body = body[: body.index("\n}\n")]
        assert body.count("launch(") == 1 and "Synchronize" not in body, fn
    assert "unsigned long long calls" in src and "h->calls" not in src  # the count: the buffer's header
    module = inspect.getsource(ring)
    assert "c_ulonglong" not in module and ".seq" not in module and not hasattr(ring.PeerBuffer, "seq")


def test_card_mesh_sums_through_the_peer_kernel_never_gloo(monkeypatch):
    """On a CUDA mesh, psum and all_reduce_grads go to ring_all_reduce (the
    peer kernel's wrapper), the gradients written into the all-reduce's
    buffer, and never to gloo's dist.all_reduce: both patched, the calls
    recorded."""
    import torch.distributed as dist

    from avatarcraft_tpu_torch.parallel import mesh as mesh_lib

    card_mesh = mesh_lib.Mesh(2, 0, torch.device("cuda", 0), None)
    summed, made = [], []

    def gloo(*args, **kwargs):
        raise AssertionError("dist.all_reduce called on a CUDA mesh")

    def peer(x, mesh):  # two ranks with equal inputs
        assert mesh is card_mesh
        summed.append(x.numel())
        return x * 2

    class Buffer:
        def view(self, numel):
            return torch.full((numel,), float("nan"))

    monkeypatch.setattr(dist, "all_reduce", gloo)
    monkeypatch.setattr(ring, "ring_all_reduce", peer)
    monkeypatch.setattr(ring, "check_peer_error", lambda: None)
    monkeypatch.setattr(ring, "peer_buffer", lambda mesh, kind, nbytes: made.append((kind, nbytes)) or Buffer())
    x = torch.tensor(3.0, requires_grad=True)
    y = mesh_lib.psum(x, card_mesh)
    y.backward()
    assert float(y.detach()) == 6.0 and float(x.grad) == 1.0
    params = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2, 2))]
    params[0].grad = torch.arange(3.0)
    mesh_lib.all_reduce_grads(params, card_mesh)
    assert summed == [1, 7] and made == [(ring.PEER_AR, ring.all_reduce_bytes(7, 2))]
    assert torch.equal(params[0].grad, 2 * torch.arange(3.0)) and torch.equal(params[1].grad, torch.zeros(2, 2))
    with pytest.raises(ValueError, match="float32"):
        mesh_lib.all_reduce_grads([torch.nn.Parameter(torch.ones(3, dtype=torch.float64))], card_mesh)


def test_mesh_on_the_card_takes_the_graphed_scan():
    """A mesh of several ranks on the card no longer refuses the graphed
    scan: make_train_scan_fast builds its scan, which captures its step on
    that device (``reconstruct.graphed``); the refusal is gone."""
    from avatarcraft_tpu_torch.parallel.mesh import Mesh
    from avatarcraft_tpu_torch.workloads import reconstruct

    card_mesh = Mesh(2, 0, torch.device("cuda", 0), None)
    assert not hasattr(reconstruct, "refuse_graphed_mesh") and not hasattr(reconstruct, "GRAPHED_MESH_ITEM")
    assert callable(reconstruct.make_train_scan_fast(None, None, None, None, 0.1, "raw", True, None, mesh=card_mesh))
    assert reconstruct.graphed(card_mesh.device)


def test_build_dir_is_ignored_by_git():
    assert cuda_build.BUILD_DIR == os.path.join(REPO, "avatarcraft_tpu_torch", "_build")
    lib = os.path.relpath(cuda_build.library_path("all_gather_rows"), REPO)
    inside = subprocess.run(["git", "rev-parse", "--is-inside-work-tree"], cwd=REPO,
                            capture_output=True, text=True, timeout=30)
    if inside.returncode == 0:
        res = subprocess.run(["git", "check-ignore", "-q", lib], cwd=REPO, timeout=30)
        assert res.returncode == 0, f"{lib} is not ignored by git"
    else:  # a checkout without git metadata: read the rule itself
        with open(os.path.join(REPO, ".gitignore")) as fp:
            assert "avatarcraft_tpu_torch/_build/" in fp.read().split()


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    if os.path.isfile(cuda_build.nvcc_path()):
        pytest.skip("nvcc is installed here; the missing-compiler path cannot be shown")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(list(KERNELS))


def test_stylize_entry_points_default_to_cuda():
    """Every entry point of the stylize slice that puts tensors on a device
    takes it explicitly and defaults to ``cuda``; the trainer runs where its
    parameters are; the CLI runs on the card unless --use_cuda false. The
    stylize CLI and the two render CLIs default to the JAX CLIs' sampler,
    parity."""
    import inspect

    from avatarcraft_tpu_torch.cli import render_canonical_cli, render_warp_cli, stylize_cli
    from avatarcraft_tpu_torch.models import diffusion, sd, toy_guidance
    from avatarcraft_tpu_torch.utils import background

    for fn in (diffusion.make_dummy_modules, toy_guidance.load_toy_guidance, background.select_background,
               sd.load_stable_diffusion_modules, sd.unet_params_from_torch, sd.vae_encoder_params_from_torch,
               sd.vae_decoder_params_from_torch, sd.clip_text_params_from_torch, sd.params_from_jax):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    opt = stylize_cli.build_parser().parse_args([])
    assert opt.use_cuda is True and opt.sampler == "parity"
    for render_cli in (render_canonical_cli, render_warp_cli):
        opt = render_cli.build_parser().parse_args(["--weights_path", "w"])
        assert opt.use_cuda is True and opt.sampler == "parity", render_cli.__name__


def test_reconstruct_entry_points_default_to_cuda():
    """The reconstruction slice's entry points take their device explicitly
    and default to ``cuda``; the CLI runs on the card unless --use_cuda
    false, at the JAX CLI's default sampler."""
    import inspect

    from avatarcraft_tpu_torch.cli import reconstruct_cli
    from avatarcraft_tpu_torch.data import SMPLMultiviewDataset
    from avatarcraft_tpu_torch.utils import checkpoint
    from avatarcraft_tpu_torch.workloads import reconstruct

    for fn in (reconstruct.setup, reconstruct.train, reconstruct.train_fast, checkpoint.load_train_state,
               SMPLMultiviewDataset.gen_rays_at, SMPLMultiviewDataset.gen_random_rays_at,
               SMPLMultiviewDataset.gen_rays_silhouettes):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    opt = reconstruct_cli.build_parser().parse_args([])
    assert opt.use_cuda is True and opt.sampler == "parity" and opt.batch_size == 1600


def test_scan_on_the_card_never_steps_eagerly(monkeypatch):
    """train_fast(scan_steps > 0) on a CUDA device captures its step into a
    CUDA graph (``reconstruct.graphed``); a capture that fails raises out
    of train_fast, and no step runs eagerly in its place. Shown on the CPU
    with the card's path chosen and a capture that raises."""
    from avatarcraft_tpu_torch.models import instant_nsr as nsr
    from avatarcraft_tpu_torch.workloads import reconstruct

    assert reconstruct.graphed("cuda") and reconstruct.graphed(torch.device("cuda", 0))
    assert not reconstruct.graphed("cpu")

    def failed_capture(step, optimizer):
        raise RuntimeError("capture failed")

    eager_steps, called = [], []
    monkeypatch.setattr(reconstruct, "graphed", lambda device: True)
    monkeypatch.setattr(reconstruct, "capture_step", failed_capture)
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: eager_steps.append(1))
    fcfg = nsr.FieldConfig(encoder="tpu_pyramid", packed_dtype="float32",
                           pyramid=nsr.PyramidSpec(grid_resolutions=(4,), grid_dim=2, plane_resolutions=(9,),
                                                   plane_dim=2))
    K = np.array([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 2.5
    ds = reconstruct.ImageSet(K=K, poses=pose[None], images=np.zeros((1, 8, 8, 3), np.float32),
                              masks=np.ones((1, 8, 8), np.float32))
    with pytest.raises(RuntimeError, match="capture failed"):
        reconstruct.train_fast(ds, fcfg, nsr.FastRenderConfig(n_probes=8, k_samples=4),
                               reconstruct.ReconstructConfig(batch_size=16), scan_steps=2, max_steps=4,
                               grid_resolution=9, callbacks={"on_step": lambda *a: called.append(a)}, device="cpu")
    assert eager_steps == [] and called == []


def test_multi_stylize_defaults_to_cuda():
    """The multi-prompt tool runs on the card unless --use_cuda false, and
    refuses to start without one."""
    from avatarcraft_tpu_torch.tools import run_multi_stylize

    assert run_multi_stylize.build_parser().parse_args([]).use_cuda is True
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA card"):
            run_multi_stylize.main([])


def test_bench_refuses_cpu():
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.run(device="cpu")


def _read_png(path):
    with open(path, "rb") as fp:
        data = fp.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + n
    w, h, depth, color, *_ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    ch = 3 if color == 2 else 1
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * ch)
    assert (raw[:, 0] == 0).all() and depth == 8
    return raw[:, 1:].reshape(h, w, ch) if ch == 3 else raw[:, 1:].reshape(h, w)


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6)])
def test_png_round_trip(tmp_path, rng, shape):
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(_read_png(path), img)
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.float32))


def test_integerify_img():
    np.testing.assert_array_equal(
        integerify_img(np.asarray([-0.5, 0.0, 0.5, 1.0, 2.0])), np.asarray([0, 0, 127, 255, 255], np.uint8)
    )
