"""The port's I3D (``ivideogpt_tpu_torch/models/i3d.py``) against
``ivideogpt_tpu/models/i3d.py`` on the CPU, the JAX parameters carried
across by ``utils/checkpoint.i3d_state_dict``:

- the logits at T = 4, 9 and 16 frames of 64 px without the resize: TF
  "SAME" pads asymmetric at stride 2 (Conv3d_1a (2, 3) at T = 16, (3, 3)
  at T = 9; the (1,3,3)/(1,2,2) pools (0, 1); the (2,2,2)/2 pool (0, 1) in
  T at T = 4), pools padded with -inf;
- the resize against ``jax.image.resize(..., "bilinear")`` up (64 -> 224)
  and down (256 -> 224, antialiased), and the whole model from 256 px;
- ``load_torch_i3d`` on a piergiaj-named file the test writes, strictly,
  against the JAX loader on the same file; a missing file raises (the JAX
  loader keeps the random weights);
- I3D features fed in chunks equal one call over all the clips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu.models import i3d as ji
from ivideogpt_tpu_torch.models import i3d as ti
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from ivideogpt_tpu_torch.utils.video_metric import Evaluator


def _random_params(model, x, seed):
    """A Flax I3D tree from numpy, without compiling ``init``: He-normal
    kernels (activations stay O(1) through the 20 layers), biases and BN
    statistics away from their initial values."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), x)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(s.shape[:-1])
            v = rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)
        elif name in ("bn_var", "bn_scale"):
            v = np.abs(rng.normal(size=s.shape)) + 0.5
        else:   # conv bias, bn_bias, bn_mean
            v = 0.1 * rng.normal(size=s.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _pair(x, seed=0, **kw):
    """(JAX logits, the port's I3D loaded strictly from the same tree)."""
    jm = ji.I3D(**kw)
    params = _random_params(jm, jnp.asarray(x), seed)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    port = ti.I3D(**kw)
    port.load_state_dict(ckpt.i3d_state_dict(params), strict=True)
    return want, port.eval()


@pytest.mark.parametrize("T", [4, 9, 16])
def test_logits_match_jax_at_64px(T):
    x = np.random.default_rng(T).random((1, T, 64, 64, 3)).astype(np.float32)
    want, port = _pair(x, seed=T, resize=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 400)
    # float32 convs summed in another order through 20 layers: 1e-5 of
    # the logits' scale
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_same_pads_are_tf_same():
    # (shape, kernel, stride) -> F.pad order (W, H, T), each (before, after)
    assert ti.same_pads((16, 224, 224), (7, 7, 7), (2, 2, 2)) == (
        2, 3, 2, 3, 2, 3)
    assert ti.same_pads((9, 64, 64), (7, 7, 7), (2, 2, 2)) == (
        2, 3, 2, 3, 3, 3)
    assert ti.same_pads((8, 112, 112), (1, 3, 3), (1, 2, 2)) == (
        0, 1, 0, 1, 0, 0)
    assert ti.same_pads((8, 28, 28), (3, 3, 3), (2, 2, 2)) == (
        0, 1, 0, 1, 0, 1)
    assert ti.same_pads((4, 2, 2), (2, 2, 2), (2, 2, 2)) == (0, 0, 0, 0, 0, 0)
    assert ti.same_pads((1, 7, 7), (2, 2, 2), (2, 2, 2)) == (0, 1, 0, 1, 0, 1)


@pytest.mark.parametrize("size", [64, 256], ids=["up_64", "down_256"])
def test_resize_matches_jax_image_resize(size):
    x = np.random.default_rng(size).random(
        (2, 3, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 224, 224, 3),
                                       "bilinear"))
    got = ti.resize_224(torch.from_numpy(x)).numpy()
    # the same weights, normalised the same way: float32 rounding
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_logits_match_jax_from_256px():
    x = np.random.default_rng(7).random((1, 4, 256, 256, 3)).astype(np.float32)
    want, port = _pair(x, seed=7)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_loader_is_strict_and_refuses_a_missing_file(tmp_path):
    """A piergiaj-named state dict (as the reference's TorchScript I3D's
    ``.state_dict()``) loads strictly, and the JAX loader reads the same
    file into the same logits. A missing file raises; the JAX loader
    returns its random weights (``tests/test_checkpoint.py:314``)."""
    x = np.random.default_rng(8).random((1, 4, 64, 64, 3)).astype(np.float32)
    jm = ji.I3D(resize=False)
    params = _random_params(jm, jnp.asarray(x), 8)
    sd = ckpt.i3d_state_dict(params)
    assert {"Conv3d_1a_7x7.conv3d.weight", "Mixed_3b.b1b.bn.running_var",
            "logits.conv3d.bias"} <= set(sd)
    assert sd["Conv3d_1a_7x7.conv3d.weight"].shape == (64, 3, 7, 7, 7)
    path = tmp_path / "i3d_torch.pt"
    torch.save(sd, str(path))
    port = ti.I3D(resize=False)
    assert ti.load_torch_i3d(port, str(path))
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    loaded, ok = ji.load_torch_i3d(
        jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x)), str(path))
    assert ok
    want = np.asarray(jax.jit(jm.apply)(loaded, jnp.asarray(x)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())

    assert not ti.load_torch_i3d(port, None)
    with pytest.raises(FileNotFoundError, match="nope.pt"):
        ti.load_torch_i3d(port, str(tmp_path / "nope.pt"))
    kept, ok = ji.load_torch_i3d(params, str(tmp_path / "nope.pt"))
    assert not ok and kept is params
    del sd["Mixed_5c.b3b.bn.running_mean"]
    torch.save(sd, str(path))
    with pytest.raises(RuntimeError, match="Missing key"):
        ti.load_torch_i3d(ti.I3D(resize=False), str(path))


def test_chunked_features_equal_one_call():
    """The evaluation feeds I3D ``--eval_max_batchsize`` clips at a time,
    where the JAX driver passes all t*B at once (``train_gpt.py:367-371``):
    a clip's features do not depend on its chunk."""
    torch.manual_seed(0)
    model = ti.I3D(resize=False).eval()
    clips = torch.rand(5, 4, 64, 64, 3,
                       generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        whole = model(clips).numpy()
        for n in (1, 2, 5, 8):
            got = Evaluator(i3d_fn=model, max_batchsize=n).i3d_features(clips)
            assert got.shape == (5, 400) and got.dtype == np.float32
            # the CPU's convs may block a batch of another size otherwise
            np.testing.assert_allclose(got, whole, rtol=1e-5,
                                       atol=1e-6 * np.abs(whole).max())
    with pytest.raises(ValueError, match="no I3D"):
        Evaluator().i3d_features(clips)
