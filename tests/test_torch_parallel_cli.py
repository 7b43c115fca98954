"""The port's trainer CLIs on 2 ranks over gloo, CPU, through the
JAX-spelled flags (``--coordinator_address --num_processes --process_id``)
and ``--dist_backend gloo`` (``tests/torch_parallel_worker.py``):

- ``train_gpt`` at DP=2: 2 steps and a checkpoint, a resume bit-equal to
  the live state on both ranks, both ranks bit-identical, every file
  written by rank 0 alone;
- the layout-free checkpoint: a TP=2 run's checkpoint resumed by one
  process, and one process's resumed at TP=2, each bit-equal to the
  writer's full state (parameters and AdamW moments);
- ``train_tokenizer`` at DP=2: a G and a D step, a checkpoint, a resume
  bit-equal on both ranks, rank 0 alone writing;
- the flags still parse to the JAX CLIs' defaults, and more processes
  than a group holds raise.
"""

import os

import numpy as np
import pytest
import torch

from ivideogpt_tpu_torch import train_gpt, train_tokenizer
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from tests import torch_parallel_worker as W
from tests.test_torch_train_gpt import _argv, _metrics, root  # noqa: F401
from tests.test_torch_train_tokenizer import _argv as _tok_argv
from tests.test_torch_train_tokenizer import work  # noqa: F401


def _full(state):
    sd = state.state_dict()
    return {"model": sd["model"], "optimizer": sd["optimizer"]}


def _same_full(a, b):
    for name, t in a["model"].items():
        assert torch.equal(t, b["model"][name]), name
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sorted(sa) == sorted(sb)
    for i, entry in sa.items():
        for k, v in entry.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb[i][k])), (i, k)


def _written_under(paths, root_dir):
    root_dir = os.path.abspath(str(root_dir))
    return [p for p in paths if p.startswith(root_dir)]


def test_gpt_cli_dp_checkpoints_and_resumes_bit_equal(root, tmp_path):
    out = tmp_path / "run"
    argv = _argv(root, out, "--learning_rate", "1e-3", "--max_train_steps",
                 "2", "--checkpointing_steps", "2",
                 "--no_validation_generation")
    ranks = W.run_ranks("cli", 2, tmp_path / "w", {"runs": [
        {"cli": "gpt", "argv": argv},
        {"cli": "gpt", "argv": argv + ["--resume_from_checkpoint",
                                       "latest"]}]})
    for rank in ranks:
        live, resumed = rank["runs"]
        assert live["step"] == resumed["step"] == 2
        assert live["digest"] == resumed["digest"]
    assert ranks[0]["runs"][0]["digest"] == ranks[1]["runs"][0]["digest"]
    assert _written_under(ranks[1]["writes"], out) == []
    mine = _written_under(ranks[0]["writes"], out)
    assert any("checkpoint-2" in p for p in mine)
    assert any(p.endswith(ckpt.TRANSFORMER_FILE) for p in mine)
    train = [m for m in _metrics(out) if "loss" in m]
    assert [m["step"] for m in train] == [1, 2]
    # the global batch: 2 ranks x --batch_size 2
    assert all(np.isfinite(m["loss"]) for m in train)


def test_checkpoints_resume_at_another_layout(root, tmp_path):
    common = ("--learning_rate", "1e-3", "--checkpointing_steps", "2",
              "--no_validation_generation", "--max_train_steps", "2")
    one, two = tmp_path / "one", tmp_path / "two"
    written_by_one = _full(train_gpt.main(_argv(root, one, *common)))
    ranks = W.run_ranks("cli", 2, tmp_path / "w", {"runs": [
        {"cli": "gpt", "gather": 2,
         "argv": _argv(root, one, *common, "--n_model", "2",
                       "--resume_from_checkpoint", "latest")},
        {"cli": "gpt", "gather": 2,
         "argv": _argv(root, two, *common, "--n_model", "2")}]})
    resumed_at_tp, written_at_tp = (r["full"] for r in ranks[0]["runs"])
    _same_full(written_by_one, resumed_at_tp)
    _same_full(ranks[1]["runs"][1]["full"], written_at_tp)
    resumed_by_one = train_gpt.main(_argv(
        root, two, *common, "--resume_from_checkpoint", "latest"))
    assert resumed_by_one.step == 2
    _same_full(written_at_tp, _full(resumed_by_one))
    # the TP ranks hold other shards of the same model
    assert ranks[0]["runs"][1]["digest"] != ranks[1]["runs"][1]["digest"]


def test_tokenizer_cli_dp_checkpoints_and_resumes_bit_equal(work,  # noqa: F811
                                                            tmp_path):
    out = tmp_path / "run"
    argv = _tok_argv(work, out, 2, "--device", "cpu", "--max_train_steps",
                     "2", "--checkpointing_steps", "2")
    ranks = W.run_ranks("cli", 2, tmp_path / "w", {"runs": [
        {"cli": "tokenizer", "argv": argv},
        {"cli": "tokenizer",
         "argv": argv + ["--resume_from_checkpoint", "latest"]}]})
    for rank in ranks:
        live, resumed = rank["runs"]
        assert live["step"] == resumed["step"] == 2
        assert live["digest"] == resumed["digest"]
    assert ranks[0]["runs"][0]["digest"] == ranks[1]["runs"][0]["digest"]
    assert _written_under(ranks[1]["writes"], out) == []
    assert any("checkpoint-2" in p
               for p in _written_under(ranks[0]["writes"], out))


def test_flags_parse_and_refuse_what_no_group_holds(root, tmp_path):
    for cli in (train_gpt, train_tokenizer):
        extra = (["--pretrained_model_name_or_path", "x"]
                 if cli is train_gpt else [])
        args = cli.parse_args(extra)
        assert (args.n_model, args.coordinator_address, args.num_processes,
                args.process_id, args.dist_backend) == (1, None, None, None,
                                                        None)
    with pytest.raises(ValueError, match="num_processes"):
        train_gpt.main(_argv(root, tmp_path / "a", "--num_processes", "2"))
    with pytest.raises(ValueError, match="tensor-parallel groups"):
        train_gpt.main(_argv(root, tmp_path / "b", "--n_model", "2"))
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()
