"""Replay buffers for MBPO, the port's copy of the pure-numpy
``ivideogpt_tpu/mbrl/replay_buffer.py``: episodes stored as
``np.savez_compressed`` files (the same format, so either package reads the
other's), the n-step transition sampler, the segment sampler for the world
model, the in-memory store for imagined episodes, and a thread prefetcher
over them. Observations are NHWC, frame-stacked on the channel axis.
"""

from __future__ import annotations

import datetime
import glob
import io
import os
import threading
import queue as queue_lib
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def episode_len(episode: Dict[str, np.ndarray]) -> int:
    # -1 for the dummy first transition
    return next(iter(episode.values())).shape[0] - 1


def save_episode(episode: Dict[str, np.ndarray], fn: Path):
    with io.BytesIO() as bs:
        np.savez_compressed(bs, **episode)
        bs.seek(0)
        with fn.open("wb") as f:
            f.write(bs.read())


def _obs_to_nhwc(obs: np.ndarray) -> np.ndarray:
    """Accept channel-first (L, C, H, W) demonstration episodes.

    Frame-stacked observations are stored channel-LAST (L, H, W, C); the
    published demonstrations are channel-FIRST with C = 3*frame_stack.
    Detect by which axis looks like a channel axis (small multiple of 3)
    and transpose, so the same demo files seed either layout."""
    if obs.ndim != 4:
        return obs
    s1, s2, s3 = obs.shape[1], obs.shape[2], obs.shape[3]

    def chan(c):  # plausible stacked-channel count: 3*k, k<=10
        return c % 3 == 0 and c <= 30

    # Demo frames are SQUARE (the published demos are 84x84); requiring the
    # spatial pair to be equal is what disambiguates a channel-plausible
    # spatial size (e.g. NHWC (L,24,24,36): 24 looks like a channel count
    # but the square pair 24==24 sits in the NHWC spatial slots). The two
    # conditions are mutually exclusive (s1==s2==s3 fails s1!=s3). Data
    # that fits neither envelope passes through unchanged as NHWC.
    if chan(s1) and s2 == s3 and s1 != s3:
        return np.transpose(obs, (0, 2, 3, 1))    # NCHW demo
    return obs


def load_episode(fn: Path) -> Dict[str, np.ndarray]:
    with fn.open("rb") as f:
        ep = np.load(f)
        out = {k: ep[k] for k in ep.keys()}
    if "observation" in out:
        out["observation"] = _obs_to_nhwc(out["observation"])
    return out


class ReplayBufferStorage:
    """Accumulates env timesteps into per-episode npz files."""

    def __init__(self, data_specs, replay_dir: Path):
        self._data_specs = data_specs
        self._replay_dir = Path(replay_dir)
        self._replay_dir.mkdir(exist_ok=True, parents=True)
        self._current = defaultdict(list)
        self._preload()

    def __len__(self):
        return self._num_transitions

    def add(self, time_step):
        for spec in self._data_specs:
            value = time_step[spec.name] if not hasattr(time_step, spec.name) \
                else getattr(time_step, spec.name)
            if np.isscalar(value):
                value = np.full(spec.shape, value, spec.dtype)
            value = np.asarray(value, spec.dtype)
            assert spec.shape == value.shape, \
                (spec.name, spec.shape, value.shape)
            self._current[spec.name].append(value)
        if time_step.last():
            episode = {spec.name: np.array(self._current[spec.name],
                                           spec.dtype)
                       for spec in self._data_specs}
            self._current = defaultdict(list)
            self._store_episode(episode)
            return episode

    def _preload(self):
        self._num_episodes = 0
        self._num_transitions = 0
        for fn in self._replay_dir.glob("*.npz"):
            _, _, n = fn.stem.split("_")
            self._num_episodes += 1
            self._num_transitions += int(n)

    def _store_episode(self, episode):
        n = episode_len(episode)
        ts = datetime.datetime.now().strftime("%Y%m%dT%H%M%S")
        fn = self._replay_dir / f"{ts}_{self._num_episodes}_{n}.npz"
        self._num_episodes += 1
        self._num_transitions += n
        save_episode(episode, fn)
        return fn


class ReplayBuffer:
    """Lazily-fetching episode cache + n-step transition sampler.
    Thread-safe enough for the single-producer prefetch loaders below."""

    def __init__(self, replay_dir: Path, max_size: int, nstep: int,
                 discount: float, fetch_every: int = 1000,
                 save_snapshot: bool = True,
                 demo_path: Optional[str] = None, seed: int = 0):
        self._replay_dir = Path(replay_dir)
        self._size = 0
        self._max_size = max_size
        self._episode_fns: List = []
        self._episodes: Dict = {}
        self._nstep = nstep
        self._discount = discount
        self._fetch_every = fetch_every
        self._since_fetch = fetch_every
        self._save_snapshot = save_snapshot
        self._num_direct = 0
        self._rng = np.random.default_rng(seed)

        if demo_path is not None:
            files = sorted(glob.glob(os.path.join(demo_path, "*.npz")))
            assert files, f"no demos under {demo_path}"
            for f in files:
                assert self._store_episode(Path(f)), f

    def add_direct(self, episode):
        """In-memory store for imagined episodes."""
        n = episode_len(episode)
        ts = datetime.datetime.now().strftime("%Y%m%dT%H%M%S")
        fn = f"{ts}_{self._num_direct}_{n}"
        self._num_direct += 1
        while n + self._size > self._max_size and self._episode_fns:
            early = self._episode_fns.pop(0)
            self._size -= episode_len(self._episodes.pop(early))
        self._episode_fns.append(fn)
        self._episodes[fn] = episode
        self._size += n

    def _store_episode(self, fn: Path) -> bool:
        try:
            episode = load_episode(fn)
        except Exception:
            return False
        n = episode_len(episode)
        while n + self._size > self._max_size and self._episode_fns:
            early = self._episode_fns.pop(0)
            self._size -= episode_len(self._episodes.pop(early))
            if isinstance(early, Path):
                early.unlink(missing_ok=True)
        self._episode_fns.append(fn)
        self._episode_fns.sort(key=str)
        self._episodes[fn] = episode
        self._size += n
        if not self._save_snapshot:
            fn.unlink(missing_ok=True)
        return True

    def _try_fetch(self):
        if self._since_fetch < self._fetch_every:
            return
        self._since_fetch = 0
        fns = sorted(self._replay_dir.glob("*.npz"), reverse=True)
        fetched = 0
        for fn in fns:
            _, n = (int(x) for x in fn.stem.split("_")[1:])
            if fn in self._episodes:
                break
            if fetched + n > self._max_size:
                break
            fetched += n
            if not self._store_episode(fn):
                break

    def _sample_episode(self):
        fn = self._episode_fns[int(self._rng.integers(len(self._episode_fns)))]
        return self._episodes[fn]

    def sample(self):
        """(obs, action, n-step reward, discount, next_obs)."""
        if not self._episode_fns:
            # empty cache: don't wait out the fetch_every window
            self._since_fetch = self._fetch_every
        try:
            self._try_fetch()
        except Exception:
            pass  # a failed fetch leaves the cache as it is
        self._since_fetch += 1
        ep = self._sample_episode()
        idx = int(self._rng.integers(0, episode_len(ep) - self._nstep + 1)) + 1
        obs = ep["observation"][idx - 1]
        action = ep["action"][idx]
        next_obs = ep["observation"][idx + self._nstep - 1]
        reward = np.zeros_like(ep["reward"][idx])
        discount = np.ones_like(ep["discount"][idx])
        for i in range(self._nstep):
            reward = reward + discount * ep["reward"][idx + i]
            discount = discount * ep["discount"][idx + i] * self._discount
        return obs, action, reward, discount, next_obs


class ReplaySegmentBuffer(ReplayBuffer):
    """(obs, action, reward) segments for world-model training."""

    def __init__(self, *args, segment_length: int, **kw):
        super().__init__(*args, **kw)
        self._segment_length = segment_length

    def sample(self):
        if not self._episode_fns:
            self._since_fetch = self._fetch_every
        try:
            self._try_fetch()
        except Exception:
            pass
        self._since_fetch += 1
        ep = self._sample_episode()
        L = self._segment_length
        idx = int(self._rng.integers(1, episode_len(ep) - L))
        obs = ep["observation"][idx - 1: idx + L - 1, ..., -3:]  # last frame of stack
        action = ep["action"][idx: idx + L]
        reward = ep["reward"][idx: idx + L]
        return obs, action, reward


class _BatchIterator:
    """Thread prefetch of stacked batches from a sampler."""

    def __init__(self, sampler, batch_size: int, num_workers: int = 2,
                 prefetch: int = 4):
        self._sampler = sampler
        self._batch = batch_size
        self._q = queue_lib.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(num_workers)]
        for t in self._threads:
            t.start()

    def _work(self):
        import time as _time
        import traceback
        while not self._stop.is_set():
            try:
                with self._lock:
                    items = [self._sampler.sample()
                             for _ in range(self._batch)]
            except Exception:
                # buffer may be empty early in training (the loaders start
                # before the first episode lands); retry instead of dying,
                # but keep the error for the consumer's timeout diagnostics
                self._last_error = traceback.format_exc(limit=3)
                _time.sleep(0.2)
                continue
            batch = tuple(np.stack(x) for x in zip(*items))
            try:
                self._q.put(batch, timeout=5.0)
            except queue_lib.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        # bounded wait with liveness diagnostics: a silent infinite q.get()
        # turns loader bugs into undebuggable hangs
        waited = 0.0
        while True:
            try:
                return self._q.get(timeout=30.0)
            except queue_lib.Empty:
                waited += 30.0
                if not any(t.is_alive() for t in self._threads):
                    raise RuntimeError("replay loader workers died")
                if waited >= 600.0:
                    replay_dir = getattr(self._sampler, "_replay_dir", None)
                    files = (len(list(replay_dir.glob("*.npz")))
                             if replay_dir else "?")
                    cached = len(getattr(self._sampler, "_episode_fns", []))
                    raise TimeoutError(
                        f"replay loader produced no batch for 10 minutes "
                        f"(dir={replay_dir}, files_on_disk={files}, "
                        f"episodes_cached={cached}); last sampler error:\n"
                        f"{getattr(self, '_last_error', None)}")

    def close(self):
        self._stop.set()


def make_replay_loader(replay_dir, max_size, batch_size, num_workers,
                       save_snapshot, nstep, discount, demo_path=None,
                       seed: int = 0):
    buf = ReplayBuffer(Path(replay_dir), max_size, nstep, discount,
                       save_snapshot=save_snapshot, demo_path=demo_path,
                       seed=seed)
    return buf, _BatchIterator(buf, batch_size, max(1, num_workers))


def make_segment_replay_loader(replay_dir, max_size, batch_size, num_workers,
                               save_snapshot, nstep, discount, segment_length,
                               demo_path=None, seed: int = 0):
    buf = ReplaySegmentBuffer(Path(replay_dir), max_size, nstep, discount,
                              save_snapshot=save_snapshot,
                              demo_path=demo_path, seed=seed,
                              segment_length=segment_length)
    return buf, _BatchIterator(buf, batch_size, max(1, num_workers))
