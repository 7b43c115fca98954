"""VP2 visual-planning predictor: the batch callable a CEM planner queries
each planning step, the port of ``ivideogpt_tpu/vp/interface.py``.

    predictor = IVideoGPTPredictor(
        pretrained_vqgan_name_or_path="hub/tokenizer",
        pretrained_transformer_path="hub/transformer", action_dim=5)
    out = predictor({"video": video, "actions": actions})
    # video [B, 2, H, W, C] in [0, 1], actions [B, T, A]
    # -> out["rgb"] [B, 11, 64, 64, 3] float32, numpy

The kwargs are those the VP2 harness passes from ``vp/ivideogpt.yaml``;
the contract is ctx=2, seg=12. A query runs in chunks of ``max_batch``
candidates (``generate_max_batchsize`` by default): the context is encoded
once where every candidate of the chunk shares it, the chunk's futures are
generated over a bf16 KV cache from a generator seeded ``seed + calls``,
and detokenized in chunks of ``decode_max_batchsize``; frame slot 0 is
dropped and the pixels clipped on the card. Each render is copied to
pinned host memory without waiting, and at most ``max_pending_chunks``
renders stay on the card: the copy of one overlaps the work of the next.
Weights are fp32 and every fp32 step runs with TF32 off, as in the JAX
package.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ivideogpt_tpu_torch import generation, rollout, tokens
from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.train import lora as lora_lib
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from ivideogpt_tpu_torch.utils import safetensors
from ivideogpt_tpu_torch.utils.platform import (full_fp32, resolve_device,
                                                to_device)


def _load_from_checkpoints(vqgan_path: str, transformer_path: str,
                           config_name: Optional[str], *, action_dim: int,
                           context_length: int, segment_length: int,
                           lora: bool, lora_r: int, lora_alpha: float,
                           allow_missing_lora: bool = False, device=None):
    """(tokenizer, model) in fp32 on ``device`` from hub-layout dirs
    (``ivideogpt_tpu/vp/interface.py:24-130``).

    vqgan_path: the tokenizer's ``config.json`` and weights, re-sliced to
      ``context_length`` where its own is longer.
    transformer_path: the HeadModelWithAction weights (every
      ``*.safetensors`` there but ``lora.safetensors``). A peft-wrapped file
      needs ``lora=True`` and is folded at lora_alpha / lora_r; otherwise,
      with ``lora=True``, ``lora.safetensors`` there is folded, and its
      absence raises unless ``allow_missing_lora``.
    config_name: a LLaMA config json; the transformer dir's by default.
    """
    dev = resolve_device(device)
    tok_sd, tok_cfg = ckpt.load_tokenizer_for_context(vqgan_path,
                                                      context_length)
    if tok_cfg is None:
        raise FileNotFoundError(f"{vqgan_path} has no config.json")
    tokenizer = CompressiveVQModel(tok_cfg)
    tokenizer.load_state_dict(tok_sd)
    lm_cfg = ckpt.llama_config_from_hub(
        ckpt.read_json(config_name
                       or os.path.join(transformer_path, "config.json")),
        vocab_size=tok_cfg.vocab_size)
    raw = safetensors.load(transformer_path, skip=(ckpt.LORA_FILE,))
    peft_wrapped = ckpt.is_peft_state_dict(raw)
    if peft_wrapped and not lora:
        # the fold needs alpha/r, which the file does not record
        raise ValueError(
            f"{transformer_path} holds a peft-wrapped (LoRA-finetuned) "
            "state_dict but lora=False; pass lora=True with the lora_r/"
            "lora_alpha it was finetuned with")
    sd = ckpt.action_model_names(
        raw, lora_alpha if peft_wrapped else None,
        lora_r if peft_wrapped else None)
    model = HeadModelWithAction(lm_cfg, ckpt.action_head_config(
        sd, tok_cfg, action_dim=action_dim, context_length=context_length,
        segment_length=segment_length))
    model.load_state_dict(sd)
    if lora and not peft_wrapped:
        lora_path = os.path.join(transformer_path, ckpt.LORA_FILE)
        if os.path.exists(lora_path):
            lora_lib.merge(model, safetensors.load_file(lora_path),
                           alpha=lora_alpha, rank=lora_r)
        elif allow_missing_lora:
            print(f"[warn] lora=True but {lora_path} not found; "
                  "using base weights (allow_missing_lora=True)")
        else:
            raise FileNotFoundError(
                f"lora=True but {lora_path} does not exist; pass "
                "allow_missing_lora=True to run with base weights")
    return tokenizer.to(dev).eval(), model.to(dev).eval()


class _Render(NamedTuple):
    """A detokenized chunk on its way to the host."""
    device: torch.Tensor              # kept alive until fetched
    host: torch.Tensor                # pinned (or the device tensor on CPU)
    done: Optional[torch.cuda.Event]  # the copy's completion


class IVideoGPTPredictor:
    num_context = 2
    base_prediction_modality = "rgb"

    def __init__(self, tokenizer: Optional[CompressiveVQModel] = None,
                 model: Optional[HeadModelWithAction] = None, *,
                 context_length: int = 2, segment_length: int = 12,
                 max_batch: Optional[int] = None, top_k: int = 100,
                 temperature: float = 1.0, seed: Optional[int] = 0,
                 config_name: Optional[str] = None,
                 vqgan_type: str = "ctx_vqgan",
                 pretrained_vqgan_name_or_path: Optional[str] = None,
                 pretrained_transformer_path: Optional[str] = None,
                 action_dim: int = 5,
                 generate_max_batchsize: Optional[int] = 100,
                 decode_max_batchsize: Optional[int] = 67,
                 action_recon: bool = False,
                 lora: bool = False, lora_r: int = 8,
                 lora_alpha: float = 32.0, lora_dropout: float = 0.0,
                 epoch=None, u8_transfer: Optional[bool] = None,
                 allow_missing_lora: bool = False,
                 max_pending_chunks: int = 2,
                 int8_detok: bool = False, device=None):
        """Prebuilt ``tokenizer`` and ``model`` on ``device``, or the
        yaml's checkpoint paths. ``action_recon``, ``lora_dropout`` and
        ``epoch`` are accepted for the harness and unused, as in the JAX
        package. ``u8_transfer`` ships renders to the host as
        round(px * 255) in uint8 (a 1/510 pixel error; off by default).
        ``int8_detok`` renders with int8 convs (``ops.qconv.int8_convs``,
        dynamic scales; kernel Q1 on the card): other pixels, the same
        token ids; off by default."""
        if context_length != 2 or segment_length != 12:
            raise ValueError("Only support context_length=2 and "
                             "segment_length=12.")
        self.device = resolve_device(device)
        if tokenizer is None or model is None:
            if not (pretrained_vqgan_name_or_path
                    and pretrained_transformer_path):
                raise ValueError("pass prebuilt models or checkpoint paths "
                                 "(yaml mode)")
            if vqgan_type != "ctx_vqgan":
                raise ValueError(f"vqgan_type {vqgan_type!r}: only "
                                 f"'ctx_vqgan' is supported")
            tokenizer, model = _load_from_checkpoints(
                pretrained_vqgan_name_or_path, pretrained_transformer_path,
                config_name, action_dim=action_dim,
                context_length=context_length,
                segment_length=segment_length, lora=lora, lora_r=lora_r,
                lora_alpha=lora_alpha, allow_missing_lora=allow_missing_lora,
                device=self.device)
            if max_batch is None:
                max_batch = generate_max_batchsize
        for m in (tokenizer, model):
            dev = next(m.parameters()).device
            if dev.type != self.device.type or (
                    self.device.index is not None
                    and dev.index != self.device.index):
                raise ValueError(f"the models are on {dev}, not on "
                                 f"{self.device}")
        self.tokenizer, self.model = tokenizer, model
        self.ctx, self.seg = context_length, segment_length
        self.max_batch = max_batch
        self.decode_max_batch = decode_max_batchsize
        self.top_k, self.temperature = top_k, temperature
        self._seed = seed or 0
        self._calls = 0
        self.max_pending_chunks = max(1, int(max_pending_chunks))
        self._u8 = bool(u8_transfer)
        self._int8 = bool(int8_detok)

    def close(self):
        pass

    def _stage(self, px: torch.Tensor) -> _Render:
        """Queue the render's copy to pinned host memory; no wait."""
        if px.device.type != "cuda":
            return _Render(px, px, None)
        host = torch.empty(px.shape, dtype=px.dtype, pin_memory=True)
        host.copy_(px, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return _Render(px, host, done)

    def _fetch(self, r: _Render) -> np.ndarray:
        if r.done is not None:
            r.done.synchronize()
        h = r.host.numpy()
        if self._u8:
            return h.astype(np.float32) / 255.0
        return h.astype(np.float32, copy=False)

    def _dispatch_chunk(self, context_frames: np.ndarray,
                        actions: np.ndarray) -> List[_Render]:
        """Generate and detokenize one chunk of candidates; returns its
        renders on their way to the host."""
        dev, cfg, T = self.device, self.tokenizer.config, self.seg
        B = context_frames.shape[0]
        # a CEM population shares one context: encode it once and tile
        shared = B > 1 and bool((context_frames == context_frames[:1]).all())
        enc_in = context_frames[:1] if shared else context_frames
        idx_c = self.tokenizer.encode_context(to_device(enc_in, dev))
        if shared:
            idx_c = idx_c.expand(B, -1, -1)
        prelude = tokens.make_prelude(idx_c, cfg.num_vq_embeddings,
                                      cfg.num_dyn_embeddings)
        act = to_device(actions, dev)
        if act.shape[1] < T:   # generation reads actions ctx-1 .. T-2
            act = torch.cat([act, act.new_zeros(
                (B, T - act.shape[1], act.shape[2]))], dim=1)
        act = act[:, :T]

        self._calls += 1
        gen = torch.Generator(device=dev).manual_seed(self._seed
                                                      + self._calls)
        res = generation.generate(
            self.model, prelude, segment_length=T, context_length=self.ctx,
            generator=gen, action=act,
            tokens_per_dyna=cfg.dyn_tokens_per_frame, top_k=self.top_k,
            temperature=self.temperature)
        db = self.decode_max_batch or B
        out = []
        for j in range(0, B, db):
            px = rollout.detokenize(self.tokenizer, res.tokens[j:j + db],
                                    self.ctx, chunk=db,
                                    int8_detok="1" if self._int8 else "0")
            px = px.clamp(0.0, 1.0)[:, 1:]
            if self._u8:
                px = torch.round(px.float() * 255.0).to(torch.uint8)
            out.append(self._stage(px))
        return out

    @torch.inference_mode()
    def __call__(self, batch):
        """batch: {"video": [B, 2, H, W, C] in [0, 1], "actions": [B, T, A]}
        -> {"rgb": [B, seg - 1, H, W, C]} float32."""
        video = np.asarray(batch["video"], np.float32)
        actions = np.asarray(batch["actions"], np.float32)
        B = video.shape[0]
        mb = self.max_batch or B
        pending: List[_Render] = []
        outs = []
        with full_fp32():
            for i in range(0, B, mb):
                pending.extend(self._dispatch_chunk(video[i:i + mb],
                                                    actions[i:i + mb]))
                while len(pending) > self.max_pending_chunks:
                    outs.append(self._fetch(pending.pop(0)))
        outs.extend(self._fetch(r) for r in pending)
        return {"rgb": outs[0] if len(outs) == 1
                else np.concatenate(outs, axis=0)}
