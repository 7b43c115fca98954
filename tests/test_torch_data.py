"""The port's data pipeline (``ivideogpt_tpu_torch/data``, without ``cv2`` or
``yaml``) against the JAX package's, on the CPU:

- the ``DATASET.yaml`` reader against ``yaml.safe_load``, and its refusals;
- the mix tables, ``resolve_mix`` and ``resolve_eval_dataset_name``;
- the crop and jitter draws (equal, and the Generator left in the same
  state) and the pixels of every augmentation, within the resize tolerance
  of ``tests/test_torch_inference.py`` (1e-5: the same float32 taps in
  another order; cv2's HSV formulas in another order for the hue);
- samples of ``RoboticDataset`` in every segment mode, of
  ``MixRoboticDataset``, ``EvalDataset`` and batches of
  ``InfiniteDataLoader`` (one worker) and ``EvalDataLoader``, with the same
  seeds, on synthetic npz episodes.
"""

import numpy as np
import pytest
import yaml

from ivideogpt_tpu.data import augment as jaug
from ivideogpt_tpu.data import dataset_mixes as jmix
from ivideogpt_tpu.data import npz_dataset as jnpz
from ivideogpt_tpu_torch.data import augment as taug
from ivideogpt_tpu_torch.data import dataset_mixes as tmix
from ivideogpt_tpu_torch.data import npz_dataset as tnpz

ATOL = 1e-5


# ----------------------------------------------------------------------
# the registry


def test_registry_reader_matches_yaml_on_the_repositorys_file():
    assert tnpz.read_registry("DATASET.yaml") == yaml.safe_load(
        open("DATASET.yaml"))


def test_registry_reader_matches_yaml_on_flat_files(tmp_path):
    text = ("# a comment\n\nbair_train_dataset: /x/bair train\n"
            "b: 'quoted # not a comment'   # a comment\nc: \"dq\"\n"
            "d.e-f: rel/path-1\n")
    (tmp_path / "r.yaml").write_text(text)
    assert tnpz.read_registry(str(tmp_path / "r.yaml")) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  b: c\n", "- a\n", "a: [1, 2]\n", "a: {b: c}\n", "a: 12\n",
    "a: true\n", "a: null\n", "a: x\na: y\n", " a: b\n", "a: 'it''s'\n",
    "a: &x b\n", "a:\n", "a: b: c\n"])
def test_registry_reader_refuses_anything_but_flat_strings(tmp_path, text):
    (tmp_path / "r.yaml").write_text(text)
    with pytest.raises(ValueError):
        tnpz.read_registry(str(tmp_path / "r.yaml"))


# ----------------------------------------------------------------------
# the mixes


def test_mix_tables_and_resolvers_match(tmp_path):
    assert tmix.DATASET_NAMED_MIXES == jmix.DATASET_NAMED_MIXES
    for name in ("OXE_SELECT", "OXE_MAGIC_SOUP", "RT_X_MIX", "OXE_FRANKA_MIX",
                 "OXE_SELECT_STHSTH", "BRIDGE_MIX"):
        assert getattr(tmix, name) == getattr(jmix, name), name
    for name in jmix.DATASET_NAMED_MIXES:
        assert tmix.resolve_mix(name) == jmix.resolve_mix(name)
        assert (tmix.resolve_eval_dataset_name(name)
                == jmix.resolve_eval_dataset_name(name))
    (tmp_path / "my_robot").mkdir()
    assert tmix.resolve_mix("my_robot", str(tmp_path)) == [("my_robot", 1.0)]
    for mod in (tmix, jmix):
        with pytest.raises(KeyError):
            mod.resolve_mix("nothing", str(tmp_path))


# ----------------------------------------------------------------------
# augmentation


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("hw,scale,ratio", [((64, 64), (0.8, 1.0), (0.9, 1.1)),
                                            ((48, 80), (0.3, 1.0), (0.5, 2.0)),
                                            ((30, 30), (1.5, 2.0), (4.0, 5.0))])
def test_crop_and_jitter_draws_match(seed, hw, scale, ratio):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    assert (taug.get_crop_params(*hw, scale, ratio, a)
            == jaug.get_crop_params(*hw, scale, ratio, b))
    ranges = ((0.6, 1.4), (0.7, 1.3), None, (-0.1, 0.1))
    t, j = taug.jitter_params(*ranges, a), jaug.jitter_params(*ranges, b)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1:] == j[1:]
    assert a.bit_generator.state == b.bit_generator.state


def _image(seed, h=37, w=53):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3), dtype=np.float32)
    img[0, :4] = 0.5                       # grey: saturation 0
    img[1, :4] = (0.2, 0.2, 0.7)           # ties in the max
    img[2, :4] = (0.9, 0.9, 0.1)
    img[3, :4] = 0.0                       # black: value 0
    return img


@pytest.mark.parametrize("fn,f", [("adjust_brightness", 1.3),
                                  ("adjust_contrast", 0.6),
                                  ("adjust_saturation", 1.8),
                                  ("adjust_hue", -0.5), ("adjust_hue", -0.23),
                                  ("adjust_hue", 0.07), ("adjust_hue", 0.49)])
def test_colour_adjustments_match(fn, f):
    img = _image(int(100 * abs(f)))
    np.testing.assert_allclose(getattr(taug, fn)(img, f),
                               getattr(jaug, fn)(img, f), rtol=0, atol=ATOL)


def test_resized_crop_matches():
    img = _image(1, 64, 64)
    for i, j, h, w, size in ((0, 0, 64, 64, 64), (3, 5, 57, 51, 64),
                             (10, 2, 20, 33, 48), (0, 0, 64, 64, 32)):
        np.testing.assert_allclose(taug.resized_crop(img, i, j, h, w, size),
                                   jaug.resized_crop(img, i, j, h, w, size),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("jitter", [(None, None, None, None),
                                    ((0.6, 1.4), (0.7, 1.3), (0.5, 1.5),
                                     (-0.1, 0.1))])
def test_augment_segment_matches(jitter):
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (5, 72, 80, 3), dtype=np.uint8)
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    ours = taug.augment_segment(images, 64, (0.8, 1.0), (0.9, 1.1), *jitter,
                                a)
    theirs = jaug.augment_segment(images, 64, (0.8, 1.0), (0.9, 1.1),
                                  *jitter, b)
    assert ours.dtype == np.float32 and ours.shape == (5, 64, 64, 3)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=ATOL)
    assert a.bit_generator.state == b.bit_generator.state


# ----------------------------------------------------------------------
# datasets


def _episodes(root, name, n, frames, hw=(64, 64), key="image", seed=0,
              action_dim=4):
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for e in range(n):
        t = frames if isinstance(frames, int) else frames[e % len(frames)]
        np.savez(d / f"episode_{e:03d}.npz",
                 **{key: rng.integers(0, 256, (t, *hw, 3), dtype=np.uint8),
                    "action": rng.normal(size=(t, action_dim))
                    .astype(np.float32)})
    return d


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("npz")
    _episodes(root, "cmu_stretch", 6, (24, 9), seed=1)
    _episodes(root, "bridge", 5, (20, 30), hw=(48, 64), seed=2)
    _episodes(root, "bair_test", 3, 12, key="aux1_image", seed=3)
    _episodes(root, "robosuite/validation", 2, 20, seed=4, action_dim=5)
    reg = root / "DATASET.yaml"
    reg.write_text(f"bair_test_dataset: {root / 'bair_test'}\n"
                   f"robosuite_dataset: {root / 'robosuite'}\n")
    return root


def _same_sample(ours, theirs):
    if isinstance(theirs, tuple):
        assert isinstance(ours, tuple) and len(ours) == len(theirs)
        for o, t in zip(ours, theirs):
            _same_sample(o, t)
        return
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=ATOL)


MODES = [dict(), dict(random_selection=True, segment_horizon=12),
         dict(goal_conditioned=True), dict(random_shuffle=True,
                                           segment_horizon=10),
         dict(no_aug=True), dict(stepsize=3)]


# goal-conditioned and shuffled segments carry no actions in either package
CASES = [(m, a) for m in MODES for a in (False, True)
         if not (a and ("goal_conditioned" in m or "random_shuffle" in m))]


@pytest.mark.parametrize("mode,load_action", CASES,
                         ids=lambda x: (",".join(x) or "plain")
                         if isinstance(x, dict) else str(x))
def test_robotic_dataset_samples_match(data_root, mode, load_action):
    kw = dict(segment_length=8, context_length=2, seed=5,
              random_resized_crop_scale=(0.8, 1.0),
              random_resized_crop_ratio=(0.9, 1.1), brightness=(0.8, 1.2),
              hue=(-0.05, 0.05), load_action=load_action, **mode)
    ours = tnpz.RoboticDataset(str(data_root), "cmu_stretch", **kw)
    theirs = jnpz.RoboticDataset(str(data_root), "cmu_stretch", **kw)
    assert ours.filenames == theirs.filenames and ours.size == 5
    for _ in range(4):
        _same_sample(ours.sample(), theirs.sample())
    assert ours.rng.bit_generator.state == theirs.rng.bit_generator.state


def test_mix_dataset_samples_match(data_root):
    mix = [("cmu_stretch", 1.0), ("bridge", 3.0)]
    kw = dict(segment_length=6, context_length=2, seed=11, stepsize=2,
              random_resized_crop_scale=(0.8, 1.0),
              random_resized_crop_ratio=(0.9, 1.1), load_action=True)
    ours = tnpz.MixRoboticDataset(str(data_root), mix, **kw)
    theirs = jnpz.MixRoboticDataset(str(data_root), mix, **kw)
    assert [d.stepsize for d in ours.datasets] == \
        [d.stepsize for d in theirs.datasets]
    for _ in range(6):
        _same_sample(ours.sample(), theirs.sample())


def test_infinite_loader_batches_match(data_root):
    kw = dict(batch_size=3, num_workers=1, stepsize=1, seed=42,
              segment_length=8, context_length=2,
              random_resized_crop_scale=(0.8, 1.0),
              random_resized_crop_ratio=(0.9, 1.1), load_action=True)
    ours = tnpz.InfiniteDataLoader(str(data_root), [("cmu_stretch", 1.0)],
                                   **kw)
    theirs = jnpz.InfiniteDataLoader(str(data_root), [("cmu_stretch", 1.0)],
                                     **kw)
    try:
        for _ in range(3):
            o, t = next(ours), next(theirs)
            assert o[0].shape == (3, 8, 64, 64, 3) and o[1].shape == (3, 8, 4)
            _same_sample(o, t)
        assert ours.wait_s >= 0.0
    finally:
        ours.close()
        theirs.close()
    assert not any(t.is_alive() for t in ours.threads)


@pytest.mark.parametrize("name,load_action", [("bair_robot_pushing", True),
                                              ("vp2_robosuite", False)])
def test_eval_dataset_and_loader_match(data_root, name, load_action):
    kw = dict(load_action=load_action,
              registry_path=str(data_root / "DATASET.yaml"))
    ours = tnpz.EvalDataset(name, 8, 64, seed=7, **kw)
    theirs = jnpz.EvalDataset(name, 8, 64, seed=7, **kw)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        _same_sample(ours[i], theirs[i])
    ours = tnpz.EvalDataLoader(name, 8, 64, batch_size=2, drop_last=True, **kw)
    theirs = jnpz.EvalDataLoader(name, 8, 64, batch_size=2, drop_last=True,
                                 **kw)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        _same_sample(o, t)
