"""Rules of the PyTorch port that hold whatever the numbers:
- the package and ``chip_smoke.py`` import no ``jax``, ``flax`` or
  ``ivideogpt_tpu`` (AST scan), and nothing the card's machine lacks
  (``cv2``, ``yaml``, ``safetensors``, ``transformers``, ``imageio``,
  ``scipy``, ``dm_env``, ``termcolor``, ``tensorboard``, ``PIL``)
  anywhere: image files are written by ``utils/image_io.py``, JPEG frames
  read by ``data/jpeg.py``, FVD's matrix root is taken with numpy; ``metaworld`` and ``mujoco`` only inside
  ``mbrl/metaworld_env.make``;
- no port file names the JAX package's ``native/libsegment_ops.so``: the
  fused crop-resize is built from ``csrc/segment_ops.cpp``;
- entry points run on CUDA unless asked for the CPU, and raise when CUDA is
  absent;
- nothing builds or imports a GPU toolchain at import time.
"""

import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ivideogpt_tpu_torch")
FORBIDDEN = ("jax", "flax", "ivideogpt_tpu")
# not on the card's machine, so imported nowhere
ABSENT = ("cv2", "yaml", "safetensors", "transformers", "imageio", "scipy",
          "dm_env", "termcolor", "tensorboard", "PIL")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def _imports_by_function(path):
    """(enclosing top-level function name or None, imported module) for
    every import of the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        where = (node.name if isinstance(node, (ast.FunctionDef,
                                                ast.AsyncFunctionDef))
                 else None)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Import):
                yield from ((where, a.name) for a in sub.names)
            elif isinstance(sub, ast.ImportFrom) and sub.module:
                yield where, sub.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_nothing_the_card_lacks(path):
    for where, mod in _imports_by_function(path):
        assert mod.split(".")[0] not in ABSENT, (
            f"{path} imports {mod}"
            + (f" in {where}" if where else " at module level"))


def test_gif_writer_imports_imageio_lazily():
    """The image writers of the predict CLI, the GPT trainer and the
    tokenizer trainer are ``utils/image_io.py``'s: no port file imports
    ``imageio``, in a function or at module level."""
    for path in _port_files():
        mods = {m.split(".")[0] for _, m in _imports_by_function(path)}
        assert "imageio" not in mods, path
    for rel, name in (("inference/predict.py", "write_gif"),
                      ("train_tokenizer.py", "write_png")):
        with open(os.path.join(PKG, rel)) as f:
            assert f"image_io import {name}" in f.read(), rel


def test_metaworld_and_mujoco_imported_only_inside_make():
    """A real Metaworld task needs ``metaworld`` and ``mujoco``, which
    neither machine has: only ``mbrl/metaworld_env.make`` imports them, so
    the fake env and every other module import without them."""
    for path in _port_files():
        for where, mod in _imports_by_function(path):
            if mod.split(".")[0] in ("metaworld", "mujoco"):
                assert (os.path.relpath(path, PKG),
                        where) == ("mbrl/metaworld_env.py", "make"), (
                    f"{path} imports {mod} in {where}")
    with open(os.path.join(PKG, "mbrl", "metaworld_env.py")) as f:
        assert "import mujoco" in f.read()


def test_scan_sees_the_whole_package():
    rels = {os.path.relpath(p, PKG) for p in _port_files()}
    for must in ("rollout.py", "generation.py", "ops/vq.py",
                 "ops/decode_attention.py", "ops/flash_attention.py",
                 "models/llama.py", "models/discriminator.py",
                 "models/lpips.py", "train/gpt_trainer.py",
                 "train/tokenizer_trainer.py", "train/optim.py",
                 "mbrl/video_predictor.py", "mbrl/drqv2.py",
                 "mbrl/utils.py", "utils/safetensors.py",
                 "utils/checkpoint.py", "train/lora.py",
                 "data/npz_dataset.py", "data/augment.py",
                 "inference/utils.py", "inference/predict.py",
                 "vp/interface.py", "train_gpt.py", "ops/philox.py",
                 "data/dataset_mixes.py", "utils/loggers.py",
                 "utils/provenance.py", "utils/image_io.py",
                 "train_tokenizer.py", "models/i3d.py",
                 "utils/video_metric.py", "mbrl_train.py", "mbrl/mbpo.py",
                 "mbrl/drq_workspace.py", "mbrl/replay_buffer.py",
                 "mbrl/metaworld_env.py", "mbrl/fake_env.py",
                 "mbrl/logger.py", "mbrl/video.py", "data/native.py",
                 "data/jpeg.py", "data/sthsth_dataset.py"):
        assert must in rels
    for src in ("vq_argmin", "vq_argmin_tiled", "decode_attention",
                "flash_attention_sm90", "flash_attention_tf32"):
        assert os.path.exists(os.path.join(PKG, "csrc", f"{src}.cu"))
    for header in ("philox.cuh", "sm90.cuh"):
        assert os.path.exists(os.path.join(PKG, "csrc", header))
    for src in ("jpeg_decode", "segment_ops"):
        assert os.path.exists(os.path.join(PKG, "csrc", f"{src}.cpp"))


def test_port_never_names_the_jax_packages_native_library():
    """The fused crop-resize is built from ``csrc/segment_ops.cpp`` by
    ``_build``; no file of the port or ``chip_smoke.py`` names the JAX
    tests' build product ``native/libsegment_ops.so``."""
    build = os.path.join(PKG, "csrc", "build")
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, f) for root, _, files in os.walk(PKG)
        if not root.startswith(build) and "__pycache__" not in root
        for f in files]
    for path in paths:
        with open(path, "rb") as f:
            assert b"libsegment_ops" not in f.read(), path


def test_trainer_cli_wants_cuda(tmp_path):
    """``python -m ivideogpt_tpu_torch.train_gpt`` runs on CUDA unless
    ``--device`` says otherwise, and refuses before it writes a file."""
    from ivideogpt_tpu_torch import train_gpt
    args = train_gpt.parse_args(["--pretrained_model_name_or_path", "hub"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        return
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA"):
        train_gpt.main(["--pretrained_model_name_or_path", "hub",
                        "--output_dir", str(out)])
    assert not out.exists()


def test_entry_point_wants_cuda():
    from ivideogpt_tpu_torch.configs import (LLAMA_BASE, TOKENIZER_64,
                                             ActionModelConfig)
    from ivideogpt_tpu_torch.mbrl.video_predictor import VideoPredictor
    from ivideogpt_tpu_torch.rollout import build_models
    from ivideogpt_tpu_torch.train.gpt_trainer import build_train_models
    from ivideogpt_tpu_torch.inference.predict import load_models, parse_args
    from ivideogpt_tpu_torch.rollout import load_hub_models
    from ivideogpt_tpu_torch.train.tokenizer_trainer import (
        build_tokenizer_train_models)
    from ivideogpt_tpu_torch.utils.platform import resolve_device
    from ivideogpt_tpu_torch.vp.interface import IVideoGPTPredictor
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_models()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_train_models()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_tokenizer_train_models()
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoPredictor(TOKENIZER_64, LLAMA_BASE,
                       ActionModelConfig(reward_prediction=True))
    # the checkpoint entry points refuse before they read a file
    with pytest.raises(RuntimeError, match="CUDA"):
        load_models(parse_args(["--pretrained_model_name_or_path", "hub",
                                "--input_path", "x.npz",
                                "--dataset_name", "bair"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        IVideoGPTPredictor(pretrained_vqgan_name_or_path="hub/tokenizer",
                           pretrained_transformer_path="hub/transformer")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_hub_models("hub", context_length=1, segment_length=16)
    assert resolve_device("cpu").type == "cpu"


def test_wrappers_raise_on_non_cuda_accelerator_tensors():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    sent to the plain version."""
    from ivideogpt_tpu_torch.ops import decode_attention as tda
    from ivideogpt_tpu_torch.ops import flash_attention as tfa
    from ivideogpt_tpu_torch.ops import vq as tvq
    z = torch.zeros((4, 8), device="meta")
    for argmin in (tvq.vq_argmin, tvq.vq_argmin_tiled):
        with pytest.raises(ValueError):
            argmin(z, torch.zeros((16, 8), device="meta"))
    q = torch.zeros((1, 1, 64), device="meta", dtype=torch.bfloat16)
    kv = torch.zeros((1, 4, 1, 64), device="meta", dtype=torch.int8)
    s = torch.zeros((1, 4, 1), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tda.decode_attention(q, kv, s, kv, s, 2)
    qkv = torch.zeros((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError):
        tfa.causal_attention(qkv, qkv, qkv, torch.float32)
    with pytest.raises(ValueError):
        tfa.causal_attention(qkv, qkv, qkv, torch.float32, (0.1, 0, 0))
