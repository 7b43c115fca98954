"""Model-based RL, the port of ``ivideogpt_tpu/mbrl``: the world model's
imagination rollout and online finetuning (``video_predictor``), the DrQ-v2
agent (``drqv2``), the MBPO loop (``mbpo``) and the model-free DrQ-v2
baseline (``drq_workspace``) with their replay buffers (``replay_buffer``),
environments (``metaworld_env``, ``fake_env``), logger (``logger``), GIF
recorders (``video``) and helpers (``utils``); the CLI is
``ivideogpt_tpu_torch.mbrl_train``."""
