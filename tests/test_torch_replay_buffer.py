"""The port's replay buffers, env wrappers, fake env and logger against the
JAX package's (the MBRL loop's host side, no model):

- the fake task and the wrapper stack step equal to JAX's from one seed
  (observations, rewards, step types, actions as scaled), and the specs
  agree field for field;
- episodes written by either package's storage read by the other's buffer;
  the n-step and segment samples bit-equal over the same files and seed,
  also through the thread loaders, with eviction at ``max_size``; the
  channel-first demo layout transposed alike;
- the logger's CSV rows and console lines equal for the same calls.
"""

import csv
import shutil

import numpy as np
import pytest

from ivideogpt_tpu.mbrl import fake_env as jfake
from ivideogpt_tpu.mbrl import logger as jlog
from ivideogpt_tpu.mbrl import metaworld_env as jenv
from ivideogpt_tpu.mbrl import replay_buffer as jrb
from ivideogpt_tpu_torch.mbrl import fake_env as tfake
from ivideogpt_tpu_torch.mbrl import logger as tlog
from ivideogpt_tpu_torch.mbrl import metaworld_env as tenv
from ivideogpt_tpu_torch.mbrl import replay_buffer as trb
from ivideogpt_tpu_torch.mbrl.drq_workspace import data_specs


def _same_spec(ours, theirs):
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert ours.name == theirs.name
    if hasattr(theirs, "minimum"):
        np.testing.assert_array_equal(ours.minimum, theirs.minimum)
        np.testing.assert_array_equal(ours.maximum, theirs.maximum)
        assert ours.minimum.dtype == theirs.minimum.dtype
        np.testing.assert_array_equal(ours.generate_value(),
                                      theirs.generate_value())


@pytest.mark.parametrize("size,frame_stack", [(64, 3), (32, 2)])
def test_fake_env_and_wrappers_step_equal_to_jax(size, frame_stack):
    ours = tfake.make_fake("x", frame_stack, 2, seed=5, duration=7, size=size)
    theirs = jfake.make_fake("x", frame_stack, 2, seed=5, duration=7,
                             size=size)
    _same_spec(ours.observation_spec(), theirs.observation_spec())
    _same_spec(ours.action_spec(), theirs.action_spec())
    a, b = ours.reset(), theirs.reset()
    rng = np.random.default_rng(0)
    for step in range(2 * 7 + 1):
        assert int(a.step_type) == int(b.step_type)
        assert (a.first(), a.mid(), a.last()) == (b.first(), b.mid(),
                                                  b.last())
        np.testing.assert_array_equal(a.observation, b.observation)
        assert a.observation.shape == (size, size, 3 * frame_stack)
        for key in ("reward", "discount", "success"):
            assert a[key] == b[key], key
        np.testing.assert_array_equal(a.action, b.action)
        assert a.action.dtype == b.action.dtype
        if a.last():
            a, b = ours.reset(), theirs.reset()
            continue
        act = rng.uniform(-1, 1, 4).astype(np.float32)
        a, b = ours.step(act), theirs.step(act)
    frame = ours.render()
    assert frame.shape == (size, size, 3)
    np.testing.assert_array_equal(frame, theirs.render())


def test_spec_replace_and_errors_match_dm_env():
    from dm_env import specs
    ours = tenv.BoundedArray((4,), np.float32, -2.0, 2.0, "action")
    theirs = specs.BoundedArray((4,), np.float32, -2.0, 2.0, "action")
    _same_spec(ours.replace(minimum=np.float32(-1)),
               theirs.replace(minimum=np.float32(-1)))
    _same_spec(tenv.Array((1,), np.float32, "reward"),
               specs.Array((1,), np.float32, "reward"))
    with pytest.raises(ValueError):
        tenv.BoundedArray((2,), np.float32, 1.0, 0.0)
    with pytest.raises(ValueError):
        tenv.BoundedArray((2,), np.float32, np.zeros(3), 1.0)
    assert [int(s) for s in tenv.StepType] == [int(s) for s in
                                               jenv.StepType]


def _episode(n, seed, hw=8, stack=3, act_dim=4):
    rng = np.random.default_rng(seed)
    return {"observation": rng.integers(0, 255, (n + 1, hw, hw, 3 * stack)
                                        ).astype(np.uint8),
            "action": rng.uniform(-1, 1, (n + 1, act_dim)).astype(np.float32),
            "reward": rng.normal(size=(n + 1, 1)).astype(np.float32),
            "discount": rng.uniform(0.5, 1, (n + 1, 1)).astype(np.float32)}


def _fill(storage_mod, env_mod, env_specs, root, episodes, seed):
    """Write ``episodes`` episodes of random lengths through a package's
    ReplayBufferStorage."""
    storage = storage_mod.ReplayBufferStorage(env_specs, root)
    rng = np.random.default_rng(seed)
    for _ in range(episodes):
        n = int(rng.integers(6, 14))
        ep = _episode(n, int(rng.integers(1 << 30)))
        for t in range(n + 1):
            kind = (env_mod.StepType.FIRST if t == 0 else
                    env_mod.StepType.LAST if t == n else
                    env_mod.StepType.MID)
            storage.add(env_mod.ExtendedTimeStep(
                step_type=kind, reward=ep["reward"][t],
                discount=ep["discount"][t], observation=ep["observation"][t],
                action=ep["action"][t], success=0.0))
    return storage


def _specs(env_mod):
    env = env_mod
    return (env.BoundedArray((8, 8, 9), np.uint8, 0, 255, "observation"),
            env.BoundedArray((4,), np.float32, -1, 1, "action"),
            env.Array((1,), np.float32, "reward"),
            env.Array((1,), np.float32, "discount"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_samples_bit_equal_over_the_same_files(writer, tmp_path):
    """Episodes written by one package; both packages' buffers read them and
    draw the same n-step and segment samples from the same seed."""
    root = tmp_path / "buffer"
    if writer == "port":
        storage = _fill(trb, tenv, _specs(tenv), root, 5, seed=1)
    else:
        from dm_env import specs
        jspecs = (specs.BoundedArray((8, 8, 9), np.uint8, 0, 255,
                                     "observation"),
                  specs.BoundedArray((4,), np.float32, -1, 1, "action"),
                  specs.Array((1,), np.float32, "reward"),
                  specs.Array((1,), np.float32, "discount"))
        storage = _fill(jrb, jenv, jspecs, root, 5, seed=1)
    assert len(list(root.glob("*.npz"))) == 5 == storage._num_episodes
    assert len(trb.ReplayBufferStorage(_specs(tenv), root)) == len(storage)
    for kind in ("nstep", "segment"):
        bufs = []
        for mod in (trb, jrb):
            if kind == "nstep":
                bufs.append(mod.ReplayBuffer(root, 1000, nstep=3,
                                             discount=0.9, seed=7))
            else:
                bufs.append(mod.ReplaySegmentBuffer(
                    root, 1000, nstep=3, discount=0.9, seed=7,
                    segment_length=4))
        for _ in range(40):
            for a, b in zip(bufs[0].sample(), bufs[1].sample()):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_eviction_direct_store_and_loaders_match_jax(tmp_path):
    root = tmp_path / "buffer"
    _fill(trb, tenv, _specs(tenv), root, 6, seed=3)
    # max_size below the episodes' total: both evict (and delete) the same
    # files, each in its own copy of the directory
    shutil.copytree(root, tmp_path / "copy")
    ours = trb.ReplayBuffer(root, 40, nstep=2, discount=0.99, seed=2)
    theirs = jrb.ReplayBuffer(tmp_path / "copy", 40, nstep=2, discount=0.99,
                              seed=2)
    for i in range(3):
        ep = _episode(9, 100 + i)
        ours.add_direct(ep)
        theirs.add_direct(ep)
    for _ in range(30):
        for a, b in zip(ours.sample(), theirs.sample()):
            np.testing.assert_array_equal(a, b)
    assert ours._size == theirs._size <= 40
    assert len(ours._episode_fns) == len(theirs._episode_fns)
    assert sorted(p.name for p in root.glob("*.npz")) == sorted(
        p.name for p in (tmp_path / "copy").glob("*.npz"))
    shutil.rmtree(root)
    _fill(trb, tenv, _specs(tenv), root, 3, seed=4)
    # the thread loaders stack batches of the sampler's draws
    _, it = trb.make_replay_loader(root, 1000, 4, 1, True, 3, 0.99, seed=9)
    _, jit = jrb.make_replay_loader(root, 1000, 4, 1, True, 3, 0.99, seed=9)
    for a, b in zip(next(it), next(jit)):
        assert a.shape[0] == 4
        np.testing.assert_array_equal(a, b)
    it.close()
    jit.close()


def test_demo_layout_and_cross_package_files(tmp_path):
    ep = _episode(10, 0, hw=12)
    chw = dict(ep, observation=np.transpose(ep["observation"], (0, 3, 1, 2)))
    for name, data in (("nchw", chw), ("nhwc", ep)):
        path = tmp_path / f"{name}.npz"
        trb.save_episode(data, path)
        ours, theirs = trb.load_episode(path), jrb.load_episode(path)
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])
        np.testing.assert_array_equal(ours["observation"], ep["observation"])
        jpath = tmp_path / f"{name}_jax.npz"
        jrb.save_episode(data, jpath)
        assert jpath.read_bytes()[:2] == path.read_bytes()[:2] == b"PK"
        np.testing.assert_array_equal(trb.load_episode(jpath)["observation"],
                                      ep["observation"])
    assert trb.episode_len(ep) == jrb.episode_len(ep) == 10
    assert trb._obs_to_nhwc(np.zeros((3, 24, 24, 36))).shape == (3, 24, 24,
                                                                  36)


def test_storage_specs_from_the_env():
    env = tfake.make_fake("x", 3, 2, seed=0, size=16)
    specs = data_specs(env)
    assert [s.name for s in specs] == ["observation", "action", "reward",
                                       "discount"]
    assert specs[0].shape == (16, 16, 9) and specs[2].shape == (1,)


def test_logger_rows_and_console_equal_to_jax(tmp_path, capsys):
    logs = {}
    for name, mod in (("port", tlog), ("jax", jlog)):
        d = tmp_path / name
        d.mkdir()
        log = mod.Logger(d, use_tb=False)
        log.log_metrics({"critic_loss": 1.5, "actor_loss": -2.0}, 10,
                        ty="train")
        log.log_metrics({"critic_loss": 2.5, "actor_loss": -1.0}, 12,
                        ty="train")
        with log.log_and_dump_ctx(20, ty="train") as ctx:
            ctx("fps", 12.5)
            ctx("total_time", 65.2)
            ctx("episode_reward", 3.25)
            ctx("episode", 2)
        with log.log_and_dump_ctx(20, ty="eval") as ctx:
            ctx("episode_reward", 1.0)
            ctx("episode_success", 0.5)
        log.log_metrics({"val/obs_mse": 0.02}, 30, ty="eval")
        log.dump(30)
        logs[name] = capsys.readouterr().out
    for kind in ("train", "eval"):
        rows = [list(csv.reader(open(tmp_path / n / f"{kind}.csv")))
                for n in ("port", "jax")]
        assert rows[0] == rows[1] and len(rows[0]) >= 2, kind
    # the same lines; the JAX console tag may carry termcolor's escapes
    strip = [line.replace("\x1b[33m", "").replace("\x1b[32m", "")
             .replace("\x1b[0m", "") for line in logs["jax"].splitlines()]
    assert logs["port"].splitlines() == strip
    assert tlog.TRAIN_FORMAT == jlog.TRAIN_FORMAT
    assert tlog.EVAL_FORMAT == jlog.EVAL_FORMAT


def test_logger_says_once_when_tensorboard_is_missing(tmp_path, capsys,
                                                      monkeypatch):
    import builtins
    real = builtins.__import__

    def no_tb(name, *a, **kw):
        if name == "torch.utils.tensorboard":
            raise ImportError("no tensorboard here")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_tb)
    log = tlog.Logger(tmp_path, use_tb=True)
    log.log("train/x", 1.0, 0)
    out = capsys.readouterr().out
    assert out.count("TensorBoard is not available") == 1
    assert log._sw is None
