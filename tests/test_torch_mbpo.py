"""The port's MBPO and DrQ-v2 workspaces and the ``mbrl_train`` CLI on the
CPU at tiny widths (TINY's 32 px tokenizer, a 2-layer LM, a 16 / 32-wide
agent), mirroring ``tests/test_mbpo_workspace.py`` and
``tests/test_drq_workspace.py``, with the JAX package as the reference
where there is one:

- ``MBPOConfig``, ``DrQConfig``, ``TASK_PRESETS`` and ``apply_task_preset``
  equal to JAX's field for field; the CLI's parser equal to the root
  ``mbrl_train.py``'s apart from ``--device``, explicit flags beating a
  preset;
- the pretrained world model from a tiny hub (``load_internal_llm`` true
  and false, and a context re-slice) holding the weights the JAX loaders
  give;
- the loops in-process with ``device="cpu"``: step counts, buffers,
  ``gen_pipeline``'s deferral, ``gen_rounds``' batching, ``_gen_starts``
  kept across a snapshot, the GIFs, the demo error, a resume restoring the
  agent and the world model bit for bit, with the next agent update equal
  to one without the restore, and a resume mid-run making the world-model
  calls of an uninterrupted run;
- the GIFs' frames equal to JAX's outside the reward box.
"""

import argparse
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from ivideogpt_tpu.mbrl import drq_workspace as jdrqws
from ivideogpt_tpu.mbrl import mbpo as jmbpo
from ivideogpt_tpu.mbrl import video as jvideo
from ivideogpt_tpu.utils import checkpoint as jax_ckpt
from ivideogpt_tpu_torch import mbrl_train
from ivideogpt_tpu_torch.configs import ActionModelConfig
from ivideogpt_tpu_torch.mbrl import mbpo as tmbpo
from ivideogpt_tpu_torch.mbrl import video as tvideo
from ivideogpt_tpu_torch.mbrl.drq_workspace import (DrQConfig, DrQWorkspace,
                                                    has_snapshot)
from ivideogpt_tpu_torch.mbrl.fake_env import make_fake
from ivideogpt_tpu_torch.mbrl.video_predictor import VideoPredictor
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from ivideogpt_tpu_torch.utils.image_io import quantize
from tests.test_tokenizer_model import TINY
from tests.test_torch_checkpoint import LM_TINY, port_config

torch.set_num_threads(2)

TOK, LM = port_config(TINY), port_config(LM_TINY)
RES = TINY.resolution


def make_env(seed):
    return make_fake("x", 3, 2, seed, duration=12, size=RES)


def _cfg(cls=tmbpo.MBPOConfig, **kw):
    base = dict(
        num_train_frames=80, num_seed_frames=40, num_expl_steps=20,
        action_repeat=2, eval_every_frames=10**9, batch_size=8,
        real_ratio=0.5, nstep=1, duration=12, save_video=False,
        save_snapshot=True, use_tb=False, replay_buffer_num_workers=1,
        init_update_gen_steps=2, init_gen_times=1, gen_every_steps=20,
        gen_batch=2, gen_horizon=2, update_gen_every_step=10,
        agent_update_times=1, start_mbpo=44,
        wm_context_length=2, wm_segment_length=4, wm_batch_size=2,
        wm_max_target_frames=2, stddev_schedule="0.2",
        feature_dim=16, hidden_dim=32)
    base.update(kw)
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in base.items() if k in fields})


def _workspace(tmp_path, name="run", **kw):
    return tmbpo.Workspace(_cfg(**kw), work_dir=str(tmp_path / name),
                           env_fn=make_env, tok_cfg=TOK, lm_cfg=LM,
                           device="cpu")


def _seed_episode(ws):
    ts = ws.train_env.reset()
    ws.replay_storage.add(ts)
    while not ts.last():
        ts = ws.train_env.step(ws.train_env.action_spec().generate_value())
        ws.replay_storage.add(ts)


# ----------------------------------------------------------------------
# configs and the CLI


def test_configs_and_presets_equal_to_jax():
    for ours, theirs in ((tmbpo.MBPOConfig, jmbpo.MBPOConfig),
                         (DrQConfig, jdrqws.DrQConfig)):
        assert [(f.name, f.type, f.default) for f in
                dataclasses.fields(ours)] == [
            (f.name, f.type, f.default) for f in dataclasses.fields(theirs)]
        assert json.loads(ours().to_json()) == json.loads(theirs().to_json())
    assert tmbpo.TASK_PRESETS == jmbpo.TASK_PRESETS
    assert tmbpo.DIFFICULTY_PRESETS == jmbpo.DIFFICULTY_PRESETS
    for preset in sorted(jmbpo.TASK_PRESETS) + ["coffee-push"]:
        for skip in (None, {"num_train_frames", "task_name"}):
            got = tmbpo.apply_task_preset(
                tmbpo.MBPOConfig(num_train_frames=7), preset, skip)
            want = jmbpo.apply_task_preset(
                jmbpo.MBPOConfig(num_train_frames=7), preset, skip)
            assert json.loads(got.to_json()) == json.loads(want.to_json())
    with pytest.raises(KeyError):
        tmbpo.apply_task_preset(tmbpo.MBPOConfig(), "nope")


def _root_parser(monkeypatch):
    """The root ``mbrl_train.py``'s parser, caught at its parse_args (the
    JAX settings it would make are skipped)."""
    import mbrl_train as root

    class Caught(Exception):
        pass

    def catch(self, *a, **kw):
        raise Caught(self)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        m.setattr(jax.config, "update", lambda *a, **kw: None)
        m.setattr("ivideogpt_tpu.utils.platform.honor_jax_platforms_env",
                  lambda: None)
        with pytest.raises(Caught) as e:
            root.main()
    return e.value.args[0]


def test_cli_parser_equal_to_the_root_cli(monkeypatch):
    root = _root_parser(monkeypatch)
    ours = {}

    def catch(self, *a, **kw):
        ours["p"] = self
        return argparse.Namespace()
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        mbrl_train.parse_args([])
    port = ours["p"]
    assert root.allow_abbrev is False and port.allow_abbrev is False

    def described(p):
        out = {}
        for a in p._actions:
            if not a.option_strings or a.dest == "help":
                continue
            typed = None
            if a.type is not None:
                typed = tuple(
                    a.type(v) if v is not None else None
                    for v in (("false", "False", "true", "1")
                              if a.type not in (int, float) else ("3",)))
            out[tuple(a.option_strings)] = (a.dest, a.default, a.nargs,
                                            a.const, typed)
        return out
    mine, theirs = described(port), described(root)
    assert mine.pop(("--device",)) == ("device", "cuda", None, None,
                                       ("false", "False", "true", "1"))
    assert mine == theirs


def test_cli_explicit_flags_beat_the_preset():
    args, cfg = mbrl_train.load_config(
        ["--task_preset", "coffee_push", "--num_train_frames", "7",
         "--seed=3"])
    assert isinstance(cfg, tmbpo.MBPOConfig)
    assert cfg.num_train_frames == 7 and cfg.seed == 3
    assert cfg.eval_every_frames == 2000 and cfg.task_name == "coffee-push"
    args, cfg = mbrl_train.load_config(["--drq_only", "--task_name",
                                        "door_lock", "--use_tb", "false"])
    assert isinstance(cfg, DrQConfig)
    assert cfg.task_name == "door-lock" and cfg.use_tb is False
    assert args.device == "cuda"
    with pytest.raises(SystemExit):
        mbrl_train.parse_args(["--num_train", "5"])


def test_cli_wants_cuda(tmp_path):
    if torch.cuda.is_available():
        return
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA"):
        mbrl_train.main(["--fake_env", "--work_dir", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmbpo.Workspace(_cfg(), work_dir=str(tmp_path / "ws"),
                        env_fn=make_env, tok_cfg=TOK, lm_cfg=LM)


# ----------------------------------------------------------------------
# the world model from a hub


@pytest.fixture(scope="module")
def hub(tmp_path_factory):
    """A tiny hub written by the port's exporter from a world model with
    the reward head."""
    head = ActionModelConfig(action_dim=4, context_length=2,
                             segment_length=4,
                             tokens_per_context=TOK.ctx_tokens_per_frame,
                             tokens_per_dyna=TOK.dyn_tokens_per_frame,
                             reward_prediction=True)
    donor = VideoPredictor(TOK, LM, head, seed=123, device="cpu",
                           compute_dtype=torch.float32)
    root = str(tmp_path_factory.mktemp("hub"))
    ckpt.export_hub(root, donor.tokenizer, donor.model)
    return root, donor


def _same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert torch.equal(ours[k].cpu(), theirs[k]), k


@pytest.mark.parametrize("load_internal_llm", [True, False])
def test_pretrained_world_model_holds_the_jax_loaders_weights(
        hub, tmp_path, load_internal_llm):
    root, donor = hub
    ws = _workspace(tmp_path, pretrained_model_path=root,
                    load_internal_llm=load_internal_llm)
    vp = ws.video_predictor
    tok_dir = os.path.join(root, "tokenizer")
    tf_dir = os.path.join(root, "transformer")
    jtok, jcfg = jax_ckpt.load_tokenizer_for_context(tok_dir, 2)
    _same(vp.tokenizer.state_dict(), ckpt.tokenizer_state_dict(jtok))
    assert vp.tok_cfg == port_config(jcfg)
    if load_internal_llm:
        _same(vp.model.llm.state_dict(), ckpt.llama_state_dict(
            jax_ckpt.load_llm_only_safetensors(tf_dir)))
        # the heads start from random weights
        assert not torch.equal(vp.model.reward_linear.weight,
                               donor.model.reward_linear.weight)
    else:
        _same(vp.model.state_dict(), ckpt.action_model_state_dict(
            jax_ckpt.load_action_model_safetensors(tf_dir)))
    ws.close()


def test_pretrained_tokenizer_resliced_to_the_context(hub, tmp_path):
    root, _ = hub
    ws = _workspace(tmp_path, pretrained_model_path=root,
                    wm_context_length=1, wm_segment_length=3)
    vp = ws.video_predictor
    assert vp.tok_cfg.context_length == 1
    jtok, _ = jax_ckpt.load_tokenizer_for_context(
        os.path.join(root, "tokenizer"), 1)
    _same(vp.tokenizer.state_dict(), ckpt.tokenizer_state_dict(jtok))
    px = torch.linspace(0, 1, 2 * 3 * RES * RES * 3).reshape(2, 3, RES,
                                                             RES, 3)
    with torch.no_grad():
        ids, _ = vp.tokenizer.tokenize(px, 1)
    assert torch.isfinite(ids.float()).all()
    ws.close()


# ----------------------------------------------------------------------
# the loops


def test_mbpo_workspace_smoke(tmp_path):
    ws = _workspace(tmp_path, save_video=True)
    ws.train()
    run = tmp_path / "run"
    assert ws.global_step == 40
    assert len(list((run / "buffer").glob("*.npz"))) >= 2
    assert ws.imag_replay_storage._num_episodes >= 1
    assert (run / "model_init").is_dir() and (run / "tokenizer_init").is_dir()
    assert list((run / "validate_gif").glob("*.gif"))
    with open(run / "train.csv") as f:
        assert "critic_loss" in f.readline()
    ws.close()


def test_generate_pipeline_defers_one_round(tmp_path):
    ws = _workspace(tmp_path, start_mbpo=0)
    _seed_episode(ws)
    assert ws.imag_replay_storage._num_episodes == 0
    m1 = ws.generate()
    assert ws.imag_replay_storage._num_episodes == 0
    assert "gen/reward_mean" not in m1
    m2 = ws.generate()
    assert ws.imag_replay_storage._num_episodes == ws.cfg.gen_batch
    assert "gen/reward_mean" in m2
    ws.save_snapshot()
    assert ws.imag_replay_storage._num_episodes == 2 * ws.cfg.gen_batch
    assert ws._pending_gen is None
    ws.close()

    ws2 = _workspace(tmp_path, "sync", start_mbpo=0, gen_pipeline=False)
    _seed_episode(ws2)
    m = ws2.generate()
    assert ws2.imag_replay_storage._num_episodes == ws2.cfg.gen_batch
    assert "gen/reward_mean" in m
    ws2.close()


def test_generate_rounds_batch_into_one_rollout(tmp_path):
    ws = _workspace(tmp_path, start_mbpo=0, gen_rounds=2, gen_pipeline=False)
    _seed_episode(ws)
    batches = []
    real = ws.video_predictor.rollout_async

    def spy(obs, *a, **kw):
        batches.append(len(obs))
        return real(obs, *a, **kw)
    ws.video_predictor.rollout_async = spy
    ws.generate()
    assert ws.imag_replay_storage._num_episodes == 0
    assert len(ws._gen_starts) == 1 and not batches
    ws.generate()
    assert len(ws._gen_starts) == 0 and batches == [2 * ws.cfg.gen_batch]
    assert ws.imag_replay_storage._num_episodes == 2 * ws.cfg.gen_batch
    ws.close()


def _agent_state(agent):
    out = {f"w/{k}": v.clone() for k, v in agent.state_dict().items()}
    for name, state in agent.train_states().items():
        for i, p in enumerate(state.params):
            for k, v in state.optimizer.state.get(p, {}).items():
                out[f"{name}/{i}/{k}"] = v.clone()
    return out


def _wm_state(vp):
    out = {}
    for name, state in (("model", vp.model_state), ("tok", vp.tok_state)):
        sd = state.state_dict()
        out.update({f"{name}/w/{k}": v.clone() for k, v in sd["model"].items()})
        for i, entry in sd["optimizer"]["state"].items():
            out.update({f"{name}/{i}/{k}": torch.as_tensor(v).clone()
                        for k, v in entry.items()})
        out[f"{name}/updates"] = torch.tensor(sd["updates"])
    return out


def _equal_states(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_snapshot_resume_restores_everything(tmp_path):
    """``_gen_starts`` gathered under gen_rounds stay unrolled across a
    snapshot; the resumed workspace has the counters, the agent (weights,
    AdamW moments, target, updated_steps) and the world model (both train
    states) bit for bit, and its next agent update equals the live one's. A
    world-model snapshot of another step than the agent's is refused."""
    ws = _workspace(tmp_path, start_mbpo=0, gen_rounds=2, gen_pipeline=False)
    _seed_episode(ws)
    for step in range(2):
        ws.agent.update(ws.mixed_batch(), step)
    ws.video_predictor.train(next(ws.seg_iter))
    ws.generate()
    ws._global_step, ws._global_episode = 17, 3
    ws._init_model = True
    ws.save_snapshot()
    assert ws.imag_replay_storage._num_episodes == 0
    assert len(ws._gen_starts) == 1 and has_snapshot(ws.work_dir)

    ws2 = _workspace(tmp_path, start_mbpo=0, gen_rounds=2,
                     gen_pipeline=False)
    ws2.load_snapshot()
    assert (ws2.global_step, ws2._global_episode) == (17, 3)
    assert (ws2._init_model, ws2._init_gen) == (True, False)
    assert ws2.agent.updated_steps == ws.agent.updated_steps == 2
    np.testing.assert_array_equal(ws2._gen_starts[0], ws._gen_starts[0])
    _equal_states(_agent_state(ws2.agent), _agent_state(ws.agent))
    _equal_states(_wm_state(ws2.video_predictor),
                  _wm_state(ws.video_predictor))
    batch = ws.mixed_batch()
    metrics = []
    for w in (ws, ws2):
        np.random.seed(5)
        metrics.append(w.agent.update(batch, 18))
    assert metrics[0] == metrics[1] and "actor_loss" in metrics[0]
    _equal_states(_agent_state(ws2.agent), _agent_state(ws.agent))
    ws2.generate()
    assert ws2.imag_replay_storage._num_episodes == 2 * ws.cfg.gen_batch
    ws2.close()
    # a world model of another step than the agent's is refused
    ws.video_predictor.save_snapshot(str(ws.work_dir), 18)
    ws.close()
    ws3 = _workspace(tmp_path)
    with pytest.raises(ValueError, match="of step 18, the agent's of step 17"):
        ws3.load_snapshot()
    ws3.close()


def _calls(ws):
    """Record the global step of each world-model ``train()`` and each
    ``generate`` of ``ws``."""
    calls = []
    train, generate = ws.video_predictor.train, ws.generate

    def spy_train(*a, **kw):
        calls.append(("train", ws.global_step))
        return train(*a, **kw)

    def spy_generate():
        calls.append(("generate", ws.global_step))
        return generate()
    ws.video_predictor.train, ws.generate = spy_train, spy_generate
    return calls


def test_resume_mid_run_trains_as_an_uninterrupted_run(tmp_path):
    """A run resumed at step 30 of 40, after the world model's initial
    training (step 20) and the first imagination round (step 22), makes
    the world-model ``train()`` and ``generate`` calls of an uninterrupted
    run's steps 30-39: no second initial training, no second
    ``init_gen_times`` rounds."""
    whole = _workspace(tmp_path, "whole")
    want = _calls(whole)
    whole.train()
    whole.close()
    assert ("train", 20) in want and ("generate", 22) in want

    first = _workspace(tmp_path, num_train_frames=60)
    first.train()
    first.save_snapshot()
    first.close()
    resumed = _workspace(tmp_path)
    resumed.load_snapshot()
    assert resumed._init_model and resumed._init_gen
    got = _calls(resumed)
    resumed.train()
    resumed.close()
    assert resumed.global_step == 40
    assert got == [c for c in want if c[1] >= 30]
    assert any(c[0] == "train" for c in got)


def _frames(path):
    return [np.asarray(f.convert("RGB"))
            for f in ImageSequence.Iterator(Image.open(path))]


def test_gif_oracles_written(tmp_path):
    ws = _workspace(tmp_path, start_mbpo=0, save_video=True,
                    gen_pipeline=False)
    _seed_episode(ws)
    ws.generate()
    gifs = list((tmp_path / "run" / "imag_gif").glob("*.gif"))
    assert len(gifs) == 1
    frames = _frames(gifs[0])
    assert len(frames) == ws.cfg.gen_horizon + 1
    assert frames[0].shape[:2] == (RES, RES)
    m = ws.validate(global_frame=0)
    assert np.isfinite(m["val/obs_mse"]) and np.isfinite(m["val/reward_mse"])
    val = list((tmp_path / "run" / "validate_gif").glob("val-sample-0-*.gif"))
    assert len(val) == ws.cfg.wm_batch_size
    assert _frames(val[0])[0].shape == (RES, 3 * RES, 3)
    ws.close()


def test_demo_true_without_prefix_raises(tmp_path):
    with pytest.raises(ValueError, match="demo_path_prefix"):
        _workspace(tmp_path, demo=True)


def test_drq_workspace_smoke_and_resume(tmp_path):
    cfg = _cfg(DrQConfig, num_eval_episodes=1)
    ws = DrQWorkspace(cfg, work_dir=str(tmp_path), env_fn=make_env,
                      device="cpu")
    ws.train()
    assert ws.global_step == 40
    assert len(list((tmp_path / "buffer").glob("*.npz"))) >= 2
    assert has_snapshot(tmp_path)
    ws2 = DrQWorkspace(cfg, work_dir=str(tmp_path), env_fn=make_env,
                       device="cpu")
    ws2.load_snapshot()
    assert 0 < ws2.global_step <= ws.global_step
    assert ws2._global_episode == ws._global_episode
    ws2.eval()
    assert (tmp_path / "eval.csv").exists()
    ws.close()
    ws2.close()


def test_cli_runs_both_loops_and_resumes(tmp_path, monkeypatch, capsys):
    """``mbrl_train.main`` in-process on the fake env at 64 px with
    ``--device cpu``: the DrQ-v2 baseline, a resume that goes on from its
    snapshot, and MBPO with the world model's configs cut to TINY's widths
    at 64 px."""
    small = ["--fake_env", "--device", "cpu", "--num_seed_frames", "20",
             "--num_expl_steps", "10", "--eval_every_frames", "1000000000",
             "--batch_size", "8", "--nstep", "1", "--duration", "8",
             "--save_video", "false", "--use_tb", "false",
             "--agent_update_times", "1", "--stddev_schedule", "0.2",
             "--feature_dim", "16", "--hidden_dim", "32"]
    drq = str(tmp_path / "drq")
    ws = mbrl_train.main(small + ["--drq_only", "--work_dir", drq,
                                  "--num_train_frames", "40"])
    assert isinstance(ws, DrQWorkspace) and ws.global_step == 20
    ws.close()
    for name in ("config.json", "cmd.json"):
        assert os.path.exists(os.path.join(drq, name))
    assert json.load(open(os.path.join(drq, "cmd.json")))["device"] == "cpu"
    ws = mbrl_train.main(small + ["--drq_only", "--work_dir", drq,
                                  "--num_train_frames", "60"])
    assert "resuming" in capsys.readouterr().out
    # resumed at the snapshot of step 16 (episode 2), on to step 30
    assert ws.global_step == 30 and ws._global_episode == 3
    ws.close()

    monkeypatch.setattr(tmbpo, "TOKENIZER_64", TOK.replace(resolution=64))
    monkeypatch.setattr(tmbpo, "LLAMA_BASE", LM)
    ws = mbrl_train.main(small + [
        "--work_dir", str(tmp_path / "mbpo"), "--num_train_frames", "48",
        "--init_update_gen_steps", "1", "--init_gen_times", "1",
        "--gen_batch", "2", "--gen_horizon", "2", "--start_mbpo", "24",
        "--gen_every_steps", "8", "--wm_segment_length", "4",
        "--wm_batch_size", "2", "--wm_max_target_frames", "2"])
    assert isinstance(ws, tmbpo.Workspace) and ws.global_step == 24
    assert ws.imag_replay_storage._num_episodes >= 2
    ws.close()


# ----------------------------------------------------------------------
# the GIFs' frames


def _jax_frames(monkeypatch, fn, *args):
    import imageio
    got = {}
    monkeypatch.setattr(imageio, "mimsave",
                        lambda path, frames, **kw: got.update(frames=frames))
    fn("unused.gif", *args)
    return got["frames"]


def _outside_box(frame):
    keep = np.ones(frame.shape[:2], bool)
    keep[tvideo.REWARD_BOX] = False
    return frame[keep]


@pytest.mark.parametrize("size", [32, 64])
def test_gif_frames_equal_to_jax_outside_the_reward_box(monkeypatch, size,
                                                        tmp_path):
    rng = np.random.default_rng(size)
    T = 4
    obs = rng.integers(0, 256, (T, size, size, 9)).astype(np.uint8)
    pred = rng.integers(0, 256, (T, size, size, 9)).astype(np.uint8)
    rewards = np.array([0.0, -0.875, 12.5, -1234.5678], np.float32)
    reward_pred = rewards[::-1].copy()
    for ours, theirs in (
            (tvideo.imagination_frames(obs, rewards),
             _jax_frames(monkeypatch, jvideo.save_imagination_gif, obs,
                         rewards)),
            (tvideo.validate_frames(obs, pred, rewards, reward_pred),
             _jax_frames(monkeypatch, jvideo.save_validate_gif, obs, pred,
                         rewards, reward_pred))):
        assert len(ours) == len(theirs) == T
        for a, b in zip(ours, theirs):
            assert a.shape == b.shape and a.dtype == b.dtype
            panels = a.shape[1] // size
            for i in range(panels):
                pa = a[:, i * size:(i + 1) * size]
                pb = b[:, i * size:(i + 1) * size]
                np.testing.assert_array_equal(_outside_box(pa),
                                              _outside_box(pb))
    # cv2's text lies inside the box, and so does the port's
    plain = np.zeros((size, size, 3), np.uint8)
    for r in rewards:
        for drawn in (jvideo._overlay_reward(plain, float(r)),
                      tvideo.overlay_reward(plain, float(r))):
            assert not _outside_box(drawn).any()
            assert drawn[tvideo.REWARD_BOX].any()
    # the GIF decodes to the frames on the writer's palette
    path = tmp_path / "x.gif"
    tvideo.save_imagination_gif(path, obs, rewards)
    for got, want in zip(_frames(path), tvideo.imagination_frames(obs,
                                                                  rewards)):
        np.testing.assert_array_equal(got, quantize(want))


def test_eval_and_train_recorders(tmp_path):
    env = make_fake("x", 3, 2, 0, duration=3, size=16)
    rec = tvideo.VideoRecorder(tmp_path)
    rec.init(env)
    rec.record(env, 0.5)
    rec.save("0.gif")
    assert len(_frames(tmp_path / "eval_video" / "0.gif")) == 2
    train = tvideo.TrainVideoRecorder(tmp_path, render_size=24)
    obs = env.reset().observation
    train.init(obs)
    train.save("1.gif")
    (frame,) = _frames(tmp_path / "train_video" / "1.gif")
    assert frame.shape == (24, 24, 3)
    # bicubic with cv2's kernel: within a level of cv2's INTER_CUBIC
    import cv2
    want = cv2.resize(obs[..., -3:], (24, 24), interpolation=cv2.INTER_CUBIC)
    got = tvideo.resize_cubic(obs[..., -3:], 24)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
