"""Config dataclasses for the PyTorch port.

The port's own copy of the fields, derived quantities and JSON form of
``ivideogpt_tpu/configs.py`` (CompressiveVQConfig, TransformerConfig,
ActionModelConfig, DiscriminatorConfig, TokenizerTrainConfig,
GPTTrainConfig and the published TOKENIZER_64 / TOKENIZER_256 /
LLAMA_BASE / LLAMA_MEDIUM presets), so a config serialised by either package
loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


class _JsonMixin:
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str):
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        # lists -> tuples: configs stay hashable
        clean = {k: (tuple(v) if isinstance(v, list) else v)
                 for k, v in d.items() if k in known}
        return cls(**clean)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CompressiveVQConfig(_JsonMixin):
    """Conditional ("compressive") VQGAN tokenizer config."""

    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512)
    layers_per_block: int = 2
    act_fn: str = "silu"
    latent_channels: int = 64
    num_vq_embeddings: int = 8192
    num_dyn_embeddings: int = 8192
    norm_num_groups: int = 32
    vq_embed_dim: Optional[int] = None
    # mid-block self-attention for the *unconditional* encoder/decoder (the
    # conditional branches always use mid attention)
    mid_block_add_attention: bool = False
    context_length: int = 2
    max_att_resolution: int = 16
    resolution: int = 64
    patch_size: int = 4
    dropout: float = 0.0
    cross_attn_heads: int = 4
    cross_attn_dropout: float = 0.1
    remat: bool = False

    @property
    def embed_dim(self) -> int:
        return self.vq_embed_dim if self.vq_embed_dim is not None else self.latent_channels

    @property
    def num_down(self) -> int:
        return len(self.block_out_channels) - 1  # final block has no downsample

    @property
    def latent_resolution(self) -> int:
        return self.resolution // (2 ** self.num_down)

    @property
    def ctx_tokens_per_frame(self) -> int:
        r = self.latent_resolution
        return r * r  # 16x16 = 256 at 64px

    @property
    def dyn_resolution(self) -> int:
        return self.latent_resolution // self.patch_size

    @property
    def dyn_tokens_per_frame(self) -> int:
        r = self.dyn_resolution
        return r * r  # 4x4 = 16 at 64px

    @property
    def scf_token(self) -> int:
        """Start-of-context-frame separator id."""
        return self.num_vq_embeddings + self.num_dyn_embeddings

    @property
    def sdf_token(self) -> int:
        """Start-of-dynamics-frame separator id."""
        return self.num_vq_embeddings + self.num_dyn_embeddings + 1

    @property
    def vocab_size(self) -> int:
        return self.num_vq_embeddings + self.num_dyn_embeddings + 2


@dataclass(frozen=True)
class TransformerConfig(_JsonMixin):
    """LLaMA-architecture causal LM config (HF LlamaConfig fields)."""

    vocab_size: int = 16386
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_key_value_heads: int = 12
    max_position_embeddings: int = 1024
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    attention_dropout: float = 0.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    remat: bool = False
    remat_policy: str = "none"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class ActionModelConfig(_JsonMixin):
    """Action-conditioned LM head config."""

    action_dim: int = 4
    context_length: int = 2
    segment_length: int = 16
    tokens_per_context: int = 256
    tokens_per_dyna: int = 16
    reward_prediction: bool = False
    action_recon: Optional[float] = None  # aux loss weight, None disables

    @property
    def prelude_tokens_num(self) -> int:
        return (self.tokens_per_context + 1) * self.context_length - 1


@dataclass(frozen=True)
class DiscriminatorConfig(_JsonMixin):
    """PatchGAN-style discriminator of the tokenizer's GAN loss."""

    in_channels: int = 3
    hidden_channels: int = 512
    depth: int = 6


@dataclass(frozen=True)
class TokenizerTrainConfig(_JsonMixin):
    """Tokenizer (VQGAN) trainer knobs, with the JAX package's defaults (the
    reference 64px pretrain recipe: lr 5e-4, wd 1e-4, clip 1.0, balanced
    L1 + LPIPS losses, GAN weight 0.1)."""

    batch_size: int = 16
    segment_length: int = 8
    context_length: int = 2
    video_stepsize: int = 1
    learning_rate: float = 5e-4
    disc_learning_rate: float = 5e-4
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 1000
    max_train_steps: int = 1_000_000
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    recon_weight: float = 1.0
    perc_weight: float = 1.0
    disc_weight: float = 0.1
    disc_start: int = 0
    balanced_loss: bool = True
    vae_loss: str = "l1"
    use_ema: bool = False
    ema_decay: float = 0.9999
    weight_decay: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    checkpointing_steps: int = 10_000
    validation_steps: int = 2_500
    log_steps: int = 50
    seed: Optional[int] = 42
    mixed_precision: str = "bf16"


@dataclass(frozen=True)
class GPTTrainConfig(_JsonMixin):
    """Token-LM trainer knobs: the optimiser and scheduler fields of the JAX
    package's GPTTrainConfig, with its defaults (the reference LM pretrain
    recipe). A JAX config's JSON loads here; its other fields (batch
    geometry, checkpointing, validation, eval generation) are the trainer
    CLI's flags (``train_gpt.py``), and ``from_json`` drops them."""

    learning_rate: float = 1e-4
    lr_scheduler: str = "cosine"
    lr_warmup_steps: int = 5000
    max_train_steps: int = 1_000_000
    gradient_accumulation_steps: int = 1
    max_grad_norm: Optional[float] = 1.0
    weight_decay: float = 0.01
    embed_no_wd: bool = True
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8


# 64x64 tokenizer, 114M params
TOKENIZER_64 = CompressiveVQConfig(
    block_out_channels=(128, 256, 512),
    latent_channels=64,
    num_vq_embeddings=8192,
    num_dyn_embeddings=8192,
    mid_block_add_attention=False,
    context_length=2,
    resolution=64,
    max_att_resolution=16,
)

# 256x256 tokenizer, 310M params, its conv blocks rematerialised in the
# backward
TOKENIZER_256 = CompressiveVQConfig(
    block_out_channels=(128, 256, 256, 512, 768),
    latent_channels=64,
    num_vq_embeddings=8192,
    num_dyn_embeddings=8192,
    mid_block_add_attention=False,
    context_length=2,
    resolution=256,
    max_att_resolution=32,
    remat=True,
)

# 138M LLaMA
LLAMA_BASE = TransformerConfig(
    vocab_size=16386,
    hidden_size=768,
    intermediate_size=3072,
    num_hidden_layers=12,
    num_attention_heads=12,
    num_key_value_heads=12,
)

# 436M LLaMA
LLAMA_MEDIUM = TransformerConfig(
    vocab_size=16386,
    hidden_size=1024,
    intermediate_size=4096,
    num_hidden_layers=24,
    num_attention_heads=16,
    num_key_value_heads=16,
)
