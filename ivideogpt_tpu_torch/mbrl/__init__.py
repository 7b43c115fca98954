"""Model-based RL, the port of ``ivideogpt_tpu/mbrl``: the world model's
imagination rollout and online finetuning (``video_predictor``), the DrQ-v2
policy that acts inside the rollout (``drqv2``) and their helpers
(``utils``)."""
