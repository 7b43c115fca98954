"""The port's Something-Something v2 reader
(``ivideogpt_tpu_torch/data/sthsth_dataset.py``, frames decoded by
``data/jpeg.py``) against the JAX package's (PIL), on the CPU, over a
synthetic frame folder of SSv2's 427 x 240 frames (smooth content with
noise, written with PIL) and its list files:

- ``SomethingV2Dataset``: the list-file filter, both ``get_segment``
  branches, ``maxsize``, the val split, ``manual_labels=False`` and a
  stepsize, at the same seeds: the same videos, decoded frames equal bit
  for bit, ``sample()`` within ``ATOL`` (the resize tolerance of
  ``tests/test_torch_data.py``: the same float32 taps as cv2 in another
  order), and the ``rng`` states equal afterwards;
- ``MixRoboticDataset`` over ``[("cmu_stretch", 0.5), ("sthsth", 0.5)]``
  and ``InfiniteDataLoader`` (one worker) against the JAX package's;
- a root of None: the port refuses it when the mixture is built, naming
  ``--sthsth_root_path`` (the JAX mixture builds and fails later, in
  ``sample``, with a TypeError);
- the tokenizer CLI on the CPU over the ``sthsth`` mix (every batch from
  the SSv2 folder) and the ``select_sthsth`` mix (OXE_SELECT's 38 datasets
  beside it), 2 steps and a validation each, finite losses; the GPT CLI
  still refuses both mixes.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from ivideogpt_tpu.data import npz_dataset as jnpz
from ivideogpt_tpu.data import sthsth_dataset as jss
from ivideogpt_tpu_torch.data import npz_dataset as tnpz
from ivideogpt_tpu_torch.data import sthsth_dataset as tss
from ivideogpt_tpu_torch.data.dataset_mixes import OXE_SELECT, resolve_mix
from tests.test_tokenizer_resume import MICRO_CFG

ATOL = 1e-5
HW = (240, 427)
# (video id, frames, label): selected labels, an excluded label ("2"), one
# too short for the segments below
VIDEOS = [("30001", 26, "86"), ("30002", 20, "1"), ("30003", 18, "2"),
          ("30004", 5, "86"), ("30005", 31, "13")]


def _frame(rng, t, phase):
    y, x = np.mgrid[0:HW[0], 0:HW[1]].astype(np.float64)
    img = np.stack([120 + 70 * np.sin(x / 29.0 + 0.4 * t + p[0])
                    * np.cos(y / 19.0 - 0.3 * t + p[1]) for p in phase], -1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def write_sthsth(root, videos=VIDEOS, seed=0, val=("30002", "30005")):
    """Frame folders under ``root/frames`` and the list files under
    ``root/datasets/somethingv2`` (the reader's default ``list_dir``,
    relative to the working directory)."""
    rng = np.random.default_rng(seed)
    frames = root / "frames"
    lists = root / "datasets" / "somethingv2"
    lists.mkdir(parents=True, exist_ok=True)
    rows = {}
    for vid, n, label in videos:
        d = frames / vid
        d.mkdir(parents=True, exist_ok=True)
        phase = rng.uniform(0, 2 * np.pi, (3, 2))
        for i in range(n):
            Image.fromarray(_frame(rng, i, phase)).save(
                d / f"{i + 1:06d}.jpg", quality=85)
        rows[vid] = f"{vid} {n} {label}"
    (lists / "train_video_folder.txt").write_text(
        "\n".join(rows.values()) + "\n")
    (lists / "val_video_folder.txt").write_text(
        "\n".join(rows[v] for v in val) + "\n")
    return frames, lists


@pytest.fixture(scope="module")
def sthsth(tmp_path_factory):
    root = tmp_path_factory.mktemp("sthsth")
    frames, lists = write_sthsth(root)
    return root, frames, lists


READERS = {
    "contiguous": dict(segment_length=8),
    "random_selection": dict(segment_length=6, context_length=2,
                             segment_horizon=12, random_selection=True),
    "maxsize": dict(segment_length=4, maxsize=5),
    "val": dict(segment_length=8, train=False),
    "all_labels": dict(segment_length=8, manual_labels=False),
    "stepsize": dict(segment_length=6, stepsize=2),
    "random_selection_stepsize": dict(segment_length=4, context_length=1,
                                      segment_horizon=15,
                                      random_selection=True, stepsize=2),
}


@pytest.mark.parametrize("case", list(READERS))
def test_reader_matches_jax(sthsth, case):
    _, frames, lists = sthsth
    kw = dict(READERS[case], image_size=32, list_dir=str(lists), seed=7)
    ours = tss.SomethingV2Dataset(str(frames), **kw)
    theirs = jss.SomethingV2Dataset(str(frames), **kw)
    assert ([(v.path, v.num_frames, v.label) for v in ours.video_list]
            == [(v.path, v.num_frames, v.label) for v in theirs.video_list])
    for video in ours.video_list[:3]:
        a, b = ours.get_segment(video), theirs.get_segment(video)
        assert len(a) == len(b) == kw["segment_length"]
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.uint8 and x.shape == (*HW, 3)
            np.testing.assert_array_equal(x, y)
    for _ in range(3):
        x, y = ours.sample(), theirs.sample()
        assert x.dtype == y.dtype == np.float32
        assert x.shape == y.shape == (kw["segment_length"], 32, 32, 3)
        np.testing.assert_allclose(x, y, rtol=0, atol=ATOL)
    assert ours.rng.bit_generator.state == theirs.rng.bit_generator.state


def test_list_filter_and_template(sthsth):
    _, frames, lists = sthsth
    ds = tss.SomethingV2Dataset(str(frames), segment_length=8,
                                list_dir=str(lists))
    assert [v.path for v in ds.video_list] == ["30001", "30002", "30005"]
    assert ds.image_tmpl.format(0 + 1) == "000001.jpg"
    assert tss.MANUALLY_SELECTED_LABELS == jss.MANUALLY_SELECTED_LABELS
    with pytest.raises(ValueError, match="no SSv2 videos"):
        tss.SomethingV2Dataset(str(frames), segment_length=40,
                               list_dir=str(lists))


def _episodes(root, name, n, frames, seed, size=32):
    rng = np.random.default_rng(seed)
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    key = tnpz.get_display_key(name)
    for i in range(n):
        np.savez(d / f"episode_{i:03d}.npz",
                 **{key: rng.integers(0, 256, (frames, size, size, 3),
                                      dtype=np.uint8)})


def _same(ours, theirs):
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=ATOL)


MIX = [("cmu_stretch", 0.5), ("sthsth", 0.5)]


@pytest.fixture(scope="module")
def mix_root(sthsth):
    root, _, _ = sthsth
    _episodes(root / "npz", "cmu_stretch", 4, 24, seed=1, size=48)
    return root


def test_mixture_matches_jax(mix_root, monkeypatch):
    monkeypatch.chdir(mix_root)
    kw = dict(segment_length=6, context_length=2, segment_horizon=12,
              random_selection=True, stepsize=2, seed=13, image_size=32,
              random_resized_crop_scale=(0.8, 1.0),
              random_resized_crop_ratio=(0.9, 1.1),
              sthsth_root_path=str(mix_root / "frames"))
    ours = tnpz.MixRoboticDataset(str(mix_root / "npz"), MIX, **kw)
    theirs = jnpz.MixRoboticDataset(str(mix_root / "npz"), MIX, **kw)
    assert isinstance(ours.datasets[1], tss.SomethingV2Dataset)
    assert ours.datasets[1].stepsize == theirs.datasets[1].stepsize == 1
    for _ in range(8):
        _same(ours.sample(), theirs.sample())
    for a, b in zip([ours, *ours.datasets], [theirs, *theirs.datasets]):
        assert a.rng.bit_generator.state == b.rng.bit_generator.state


def test_infinite_loader_matches_jax(mix_root, monkeypatch):
    monkeypatch.chdir(mix_root)
    kw = dict(batch_size=3, num_workers=1, stepsize=1, seed=42,
              segment_length=5, context_length=1, segment_horizon=10,
              random_selection=True, image_size=32,
              random_resized_crop_scale=(0.8, 1.0),
              random_resized_crop_ratio=(0.9, 1.1),
              sthsth_root_path=str(mix_root / "frames"))
    ours = tnpz.InfiniteDataLoader(str(mix_root / "npz"), MIX, **kw)
    theirs = jnpz.InfiniteDataLoader(str(mix_root / "npz"), MIX, **kw)
    try:
        for _ in range(3):
            _same(next(ours), next(theirs))
    finally:
        ours.close()
        theirs.close()


def test_a_root_of_none_is_refused_when_the_mixture_is_built(mix_root,
                                                            monkeypatch):
    monkeypatch.chdir(mix_root)
    with pytest.raises(ValueError, match="--sthsth_root_path"):
        tnpz.MixRoboticDataset(str(mix_root / "npz"), MIX, segment_length=4,
                               seed=1)
    with pytest.raises(ValueError, match="--sthsth_root_path"):
        tss.SomethingV2Dataset(None, segment_length=4)
    # the JAX mixture builds, and fails only when it draws an SSv2 sample
    theirs = jnpz.MixRoboticDataset(str(mix_root / "npz"),
                                    [("sthsth", 1.0)], segment_length=4,
                                    seed=1)
    with pytest.raises(TypeError):
        theirs.sample()


# ----------------------------------------------------------------------
# the CLIs


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """A small SSv2 tree and two 32 px episodes for each of OXE_SELECT's
    datasets (episode 0 is the eval split's)."""
    root = tmp_path_factory.mktemp("sthsth_cli")
    write_sthsth(root, videos=[("40001", 12, "86"), ("40002", 10, "1"),
                               ("40003", 9, "13")], seed=3,
                 val=("40002",))
    for k, (name, _) in enumerate(OXE_SELECT):
        _episodes(root / "oxe", name, 2, 6, seed=100 + k)
    (root / "cfg.json").write_text(json.dumps(
        dict(MICRO_CFG, cross_attn_dropout=0.0)))
    return root


def _cli_argv(root, out, mix):
    return ["--model_config", str(root / "cfg.json"), "--resolution", "32",
            "--context_length", "1", "--segment_length", "3",
            "--batch_size", "2", "--dataset_name", mix,
            "--dataset_path", str(root / "oxe"),
            "--sthsth_root_path", str(root / "frames"),
            "--dataloader_num_workers", "1", "--random_selection",
            "--segment_horizon", "6", "--max_train_steps", "2",
            "--log_steps", "2", "--log_image_steps", "0",
            "--validation_steps", "2", "--checkpointing_steps", "100000",
            "--learning_rate", "1e-4", "--lr_warmup_steps", "0",
            "--seed", "5", "--device", "cpu", "--output_dir",
            str(root / out)]


@pytest.mark.parametrize("mix", ["sthsth", "select_sthsth"])
def test_tokenizer_cli_trains_on_the_sthsth_mixes(cli_root, monkeypatch,
                                                  mix):
    from ivideogpt_tpu_torch import train_tokenizer as tt
    monkeypatch.chdir(cli_root)
    read = []
    real = tss.read_jpeg

    def counted(path):
        read.append(path)
        return real(path)
    monkeypatch.setattr(tss, "read_jpeg", counted)
    samples = {"ssv2": 0, "npz": 0}
    for cls, key in ((tss.SomethingV2Dataset, "ssv2"),
                     (tnpz.RoboticDataset, "npz")):
        def wrap(self, _real=cls.sample, _key=key):
            samples[_key] += 1
            return _real(self)
        monkeypatch.setattr(cls, "sample", wrap)
    built = []
    real_init = tss.SomethingV2Dataset.__init__

    def init(self, *a, **kw):
        built.append(a[0])
        real_init(self, *a, **kw)
    monkeypatch.setattr(tss.SomethingV2Dataset, "__init__", init)
    tt.main(_cli_argv(cli_root, f"run_{mix}", mix))
    with open(cli_root / f"run_{mix}" / "metrics.jsonl") as f:
        metrics = [json.loads(line) for line in f]
    train = [m for m in metrics if "gen_loss" in m]
    val = [m for m in metrics if "validation_seconds" in m]
    assert len(train) == 1 and len(val) == 1
    for m in metrics:
        for k, v in m.items():
            assert not isinstance(v, float) or np.isfinite(v), (k, v)
    # every worker's mixture of both loaders holds the SSv2 reader
    assert built == [str(cli_root / "frames")] * 2
    assert all(p.startswith(str(cli_root / "frames")) for p in read)
    if mix == "sthsth":
        # nothing else to draw from: every batch came from the SSv2 folder
        assert read and samples["ssv2"] >= 2 * 2 + 4 * 2
        assert samples["npz"] == 0
    else:
        assert samples["npz"] > 0


def test_tokenizer_cli_without_a_root_raises(cli_root, monkeypatch):
    from ivideogpt_tpu_torch import train_tokenizer as tt
    monkeypatch.chdir(cli_root)
    argv = _cli_argv(cli_root, "run_none", "sthsth")
    i = argv.index("--sthsth_root_path")
    del argv[i:i + 2]
    with pytest.raises(ValueError, match="--sthsth_root_path"):
        tt.main(argv)


@pytest.mark.parametrize("mix", ["sthsth", "select_sthsth"])
def test_gpt_cli_refuses_the_sthsth_mixes(cli_root, mix):
    from ivideogpt_tpu_torch import train_gpt
    assert any(n == "sthsth" for n, _ in resolve_mix(mix))
    with pytest.raises(NotImplementedError, match="sthsth"):
        train_gpt.main(["--pretrained_model_name_or_path", "hub",
                        "--dataset_name", mix, "--device", "cpu",
                        "--output_dir", str(cli_root / "gpt_none")])
    assert not (cli_root / "gpt_none").exists()
