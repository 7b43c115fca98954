"""The MBRL training entry point, the port of the root ``mbrl_train.py``:
MBPO with the iVideoGPT world model by default, the model-free DrQ-v2
baseline with ``--drq_only``.

    python -m ivideogpt_tpu_torch.mbrl_train --task_name coffee-push \\
        --work_dir log_mbrl/run1
    python -m ivideogpt_tpu_torch.mbrl_train --drq_only --work_dir log_drq
    python -m ivideogpt_tpu_torch.mbrl_train --fake_env --device cpu \\
        --work_dir log_fake     # the random-pixel env, no MuJoCo

Every ``MBPOConfig`` field is a flag; ``--task_preset`` lays a task's
budget over them, and flags given explicitly win over it (abbreviated
flags are refused, so none escapes that rule). A run resumes from the
snapshot in ``--work_dir`` when there is one (``mbrl/drq_workspace.py``),
and writes ``config.json`` and its provenance (``cmd.json``,
``src_diff.patch``) there. ``--device``: CUDA unless it names another
device; raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    from ivideogpt_tpu_torch.mbrl.mbpo import MBPOConfig
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--work_dir", type=str, default="log_mbrl/run")
    p.add_argument("--task_preset", type=str, default=None,
                   help="reference task budget in one flag (mirrors "
                   "mbrl/cfgs/task/*.yaml): coffee_push, hammer, door_lock, "
                   "plate_slide, handle_pull_side, "
                   "button_press_topdown_wall, or easy/medium/hard. "
                   "Explicit CLI flags override preset values.")
    p.add_argument("--fake_env", action="store_true",
                   help="random-pixel env instead of Metaworld (smoke runs "
                        "without MuJoCo)")
    p.add_argument("--drq_only", action="store_true",
                   help="model-free DrQ-v2 baseline, no world model "
                        "(reference mbrl/train_metaworld_drq.py)")
    for f in dataclasses.fields(MBPOConfig):
        if f.default is None or f.type in ("Optional[str]",):
            p.add_argument(f"--{f.name}", type=str, default=f.default)
        elif isinstance(f.default, bool):
            p.add_argument(f"--{f.name}", type=lambda s: s.lower() != "false",
                           default=f.default)
        elif isinstance(f.default, int):
            p.add_argument(f"--{f.name}", type=int, default=f.default)
        elif isinstance(f.default, float):
            p.add_argument(f"--{f.name}", type=float, default=f.default)
        else:
            p.add_argument(f"--{f.name}", type=str, default=f.default)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_config(argv: List[str]):
    """(args, the workspace's config): ``DrQConfig`` with ``--drq_only``,
    else ``MBPOConfig``, from the flags, with ``--task_preset`` laid over
    the fields not given explicitly, and the task name hyphenated."""
    from ivideogpt_tpu_torch.mbrl.drq_workspace import DrQConfig
    from ivideogpt_tpu_torch.mbrl.mbpo import MBPOConfig, apply_task_preset
    args = parse_args(argv)
    cfg_cls = DrQConfig if args.drq_only else MBPOConfig
    cfg_fields = {f.name for f in dataclasses.fields(cfg_cls)}
    cfg = cfg_cls(**{k: v for k, v in vars(args).items()
                     if k in cfg_fields})
    if args.task_preset:
        # the flags given explicitly win over the preset
        explicit = {a[2:].split("=")[0] for a in argv if a.startswith("--")}
        cfg = apply_task_preset(cfg, args.task_preset,
                                skip=explicit & cfg_fields)
    # Metaworld's task names take hyphens
    return args, cfg.replace(task_name="-".join(cfg.task_name.split("_")))


def main(argv: Optional[List[str]] = None):
    """Build the workspace, resume it where a snapshot is, train it; returns
    the workspace."""
    from ivideogpt_tpu_torch.mbrl.drq_workspace import (DrQWorkspace,
                                                        has_snapshot)
    from ivideogpt_tpu_torch.mbrl.mbpo import Workspace
    from ivideogpt_tpu_torch.utils.platform import resolve_device
    from ivideogpt_tpu_torch.utils.provenance import write_provenance

    args, cfg = load_config(sys.argv[1:] if argv is None else list(argv))
    device = resolve_device(args.device)
    ws_cls = DrQWorkspace if args.drq_only else Workspace
    os.makedirs(args.work_dir, exist_ok=True)
    with open(os.path.join(args.work_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    write_provenance(args.work_dir, args)

    env_fn = None
    if args.fake_env:
        from ivideogpt_tpu_torch.mbrl.fake_env import make_fake
        env_fn = lambda seed: make_fake(  # noqa: E731
            cfg.task_name, cfg.frame_stack, cfg.action_repeat, seed,
            cfg.camera, cfg.duration, cfg.succ_bonus,
            action_dim=getattr(cfg, "wm_action_dim", 4))
    ws = ws_cls(cfg, work_dir=args.work_dir, env_fn=env_fn, device=device)
    if has_snapshot(args.work_dir):
        print(f"resuming: {os.path.join(args.work_dir, 'snapshot')}")
        ws.load_snapshot()
    ws.train()
    return ws


if __name__ == "__main__":
    main()
