"""PyTorch/CUDA port of iVideoGPT-TPU for NVIDIA Hopper.

A second package beside ``ivideogpt_tpu`` (the JAX reference, which it
never imports). Module names mirror the JAX package's. The main path is
``rollout.rollout``: context tokenize -> int8-KV generate -> detokenize,
with two hand-written CUDA kernels behind it (``csrc/``): the VQ argmin
(``ops/vq.py``) and the int8 decode attention (``ops/decode_attention.py``).
The published checkpoints load through ``utils/checkpoint.py``; the
inference entry points are ``inference/predict.py`` and
``vp/interface.py``.
"""

from ivideogpt_tpu_torch.configs import (  # noqa: F401
    LLAMA_BASE,
    LLAMA_MEDIUM,
    TOKENIZER_64,
    ActionModelConfig,
    CompressiveVQConfig,
    TransformerConfig,
)
