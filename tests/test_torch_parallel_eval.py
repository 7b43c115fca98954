"""``train_gpt --eval_only`` on 2 data ranks over gloo, CPU
(``tests/torch_parallel_worker.py``): the ranks split the BAIR eval
split's batches (batch n on rank n mod 2; each rank loads only its own)
and gather the per-batch losses, frame metrics and I3D features once, in
batch order, so the loss, the frame metrics and FVD equal one process's
exactly. The JAX driver instead reads the whole split on every process and
gathers N copies of it (``ivideogpt_tpu/data/npz_dataset.py:449-475``,
``train_gpt.py:369-374``). FVD is held to 1e-9 of itself: its matrix
root's last bits follow the thread count."""

import numpy as np

from ivideogpt_tpu_torch import train_gpt
from ivideogpt_tpu_torch.data.npz_dataset import EvalDataLoader
from tests import torch_parallel_worker as W
from tests.test_torch_train_gpt import _eval_argv, eval_root  # noqa: F401


def test_eval_only_on_two_ranks_equals_one(eval_root, tmp_path,  # noqa: F811
                                           monkeypatch):
    monkeypatch.chdir(eval_root)
    one = train_gpt.main(_eval_argv(eval_root, tmp_path / "one", "--device",
                                    "cpu"))
    ranks = W.run_ranks("cli", 2, tmp_path / "w", {"runs": [
        {"cli": "gpt", "chdir": str(eval_root),
         "argv": _eval_argv(eval_root, tmp_path / "two", "--device",
                            "cpu")}]}, timeout=240)
    assert sorted(one) == ["eval_loss", "fvd", "generated", "lpips", "mse",
                           "perplexity", "psnr", "ssim"]
    assert one["generated"] == 8
    for rank in ranks:
        got = dict(rank["runs"][0]["result"])
        # FVD's matrix root (numpy's eigh) runs on another thread count in
        # the ranks than here: its last bits differ, its inputs do not
        np.testing.assert_allclose(got.pop("fvd"), one["fvd"], rtol=1e-9)
        assert got == {k: v for k, v in one.items() if k != "fvd"}


def test_eval_loader_shards_load_only_their_batches(eval_root,  # noqa: F811
                                                    monkeypatch):
    monkeypatch.chdir(eval_root)
    loader = EvalDataLoader("bair_robot_pushing", 4, 64, batch_size=2,
                            load_action=True)
    whole = list(loader)
    loads = []
    real = loader.dataset.__class__.__getitem__
    monkeypatch.setattr(loader.dataset.__class__, "__getitem__",
                        lambda self, i: loads.append(i) or real(self, i))
    for index in (0, 1):
        part = list(loader.shard(index, 2))
        assert [n for n, _ in part] == [index]
        for (n, batch) in part:
            for got, want in zip(batch, whole[n]):
                np.testing.assert_array_equal(got, want)
    assert sorted(loads) == [0, 1, 2, 3]
