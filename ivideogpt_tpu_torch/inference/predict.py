"""Video-prediction inference CLI, the port of ``inference/predict.py``: load
a tokenizer and a transformer from the published hub layout
(``{model}/tokenizer``, ``{model}/transformer``), tokenize a clip, sample
``repeat_times`` futures from its context, detokenize them and write
ground-truth-beside-prediction GIFs.

    python -m ivideogpt_tpu_torch.inference.predict \\
        --pretrained_model_name_or_path /path/to/hub \\
        --input_path inference/samples/synthetic_sample.npz \\
        --dataset_name bair --action_conditioned [--device cpu]

It runs on CUDA unless ``--device`` names another device, and raises when
CUDA is absent. The weights stay fp32 as in the JAX package, and every
fp32 step runs with TF32 off (``utils.platform.full_fp32``): the token ids
are those of an IEEE fp32 tokenizer. Writing GIFs needs ``imageio``,
imported only by :func:`write_gifs`.
"""

from __future__ import annotations

import argparse
import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ivideogpt_tpu_torch import generation, tokens
from ivideogpt_tpu_torch.inference.utils import NPZParser
from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.utils import checkpoint as ckpt
from ivideogpt_tpu_torch.utils.platform import full_fp32, resolve_device


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True)
    p.add_argument("--input_path", type=str, required=True)
    p.add_argument("--dataset_name", type=str, required=True)
    p.add_argument("--output_path", type=str, default="outputs")
    p.add_argument("--context_length", type=int, default=2)
    p.add_argument("--segment_length", type=int, default=16)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--goal_conditioned", action="store_true")
    p.add_argument("--action_conditioned", action="store_true")
    p.add_argument("--action_dim", type=int, default=4)
    p.add_argument("--repeat_times", type=int, default=5)
    p.add_argument("--top_k", type=int, default=100)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_models(args):
    """(tokenizer, model) in fp32 on ``args.device`` from the hub dir
    ``args.pretrained_model_name_or_path`` (``inference/predict.py:46-109``).
    The context length must be the tokenizer's own. An action-conditioned
    run loads the HeadModelWithAction file; an action-free one takes the
    LLaMA of either a bare-LLaMA file or a HeadModelWithAction export."""
    dev = resolve_device(args.device)
    root = args.pretrained_model_name_or_path
    tok_dir = os.path.join(root, "tokenizer")
    tf_dir = os.path.join(root, "transformer")
    tok_cfg = ckpt.tokenizer_config_from_hub(
        ckpt.read_json(os.path.join(tok_dir, "config.json")))
    if args.context_length != tok_cfg.context_length:
        raise ValueError(f"context_length {args.context_length} != the "
                         f"pretrained tokenizer's {tok_cfg.context_length}")
    tokenizer = CompressiveVQModel(tok_cfg)
    tokenizer.load_state_dict(ckpt.load_tokenizer_safetensors(tok_dir))
    lm_cfg = ckpt.llama_config_from_hub(
        ckpt.read_json(os.path.join(tf_dir, "config.json")),
        vocab_size=tok_cfg.vocab_size)
    if args.action_conditioned:
        sd = ckpt.load_action_model_safetensors(tf_dir)
    else:
        sd = {f"llm.{k}": v
              for k, v in ckpt.load_llm_only_safetensors(tf_dir).items()}
    model = HeadModelWithAction(lm_cfg, ckpt.action_head_config(
        sd, tok_cfg, action_dim=args.action_dim,
        context_length=args.context_length,
        segment_length=args.segment_length))
    if args.action_conditioned:
        model.load_state_dict(sd)
    else:
        model.llm.load_state_dict({k[len("llm."):]: v for k, v in sd.items()})
    return tokenizer.to(dev).eval(), model.to(dev).eval()


class PredictResult(NamedTuple):
    tokens: torch.Tensor  # [repeat_times, seq_len] on the models' device
    frames: np.ndarray    # [repeat_times, T, H, W, C] float32 in [0, 1]


@torch.inference_mode()
def predict(args, tokenizer: CompressiveVQModel, model: HeadModelWithAction,
            pixels: np.ndarray, actions: Optional[np.ndarray],
            generator: Optional[torch.Generator] = None) -> PredictResult:
    """pixels [T, H, W, C] (and actions [T, A]) -> ``repeat_times`` sampled
    futures of the clip's context (``inference/predict.py:112-137``): all T
    frames tokenized in fp32, the prelude (context tokens and the first
    sdf) tiled, generated over a bf16 KV cache from ``generator`` (seeded
    ``args.seed`` when None), detokenized and clipped to [0, 1]."""
    dev = next(model.parameters()).device
    ctx, T, R = args.context_length, args.segment_length, args.repeat_times
    cfg = tokenizer.config
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(args.seed)
    with full_fp32():
        indices, _ = tokenizer.tokenize(
            torch.from_numpy(np.ascontiguousarray(pixels))[None].to(dev), ctx)
        P1 = tokens.prelude_len(ctx, cfg.ctx_tokens_per_frame) + 1
        prelude = indices[:, :P1].repeat(R, 1)
        act = (torch.from_numpy(np.asarray(actions, np.float32))[None]
               .to(dev).repeat(R, 1, 1) if actions is not None else None)
        res = generation.generate(
            model, prelude, segment_length=T, context_length=ctx,
            generator=generator, action=act,
            tokens_per_dyna=cfg.dyn_tokens_per_frame, top_k=args.top_k,
            temperature=args.temperature)
        frames = tokenizer.detokenize(res.tokens, ctx).clamp(0.0, 1.0)
    return PredictResult(res.tokens, frames.cpu().numpy())


def gif_strips(pixels: np.ndarray, frames: np.ndarray
               ) -> List[List[np.ndarray]]:
    """One strip a sample: each frame [H, 2W, C] uint8, the ground truth
    left of the prediction (``inference/predict.py:155-162``)."""
    gt = (pixels * 255).astype(np.uint8)
    return [[np.concatenate([gt[i], (pred[i] * 255).astype(np.uint8)],
                            axis=1) for i in range(len(gt))]
            for pred in frames]


def write_gifs(strips: List[List[np.ndarray]], output_path: str,
               name: str = "pred-samples-{j}.gif"):
    """One GIF a strip, named ``name`` with the strip's index for ``j``, 4
    frames/s (250 ms a frame: imageio's pillow writer takes ``duration`` in
    ms and ignores ``fps``), looping."""
    import imageio
    os.makedirs(output_path, exist_ok=True)
    for j, strip in enumerate(strips):
        imageio.mimsave(os.path.join(output_path, name.format(j=j)),
                        strip, duration=250, loop=0)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    tokenizer, model = load_models(args)
    parser = NPZParser(args.segment_length, args.resolution)
    pixels, actions = parser.parse(args.input_path, args.dataset_name,
                                   load_action=args.action_conditioned)
    if args.goal_conditioned:
        pixels = np.concatenate([pixels[-1:], pixels[:-1]], axis=0)
    res = predict(args, tokenizer, model, pixels, actions)
    write_gifs(gif_strips(pixels, res.frames), args.output_path)
    print(f"wrote {args.repeat_times} GIFs to {args.output_path}")


if __name__ == "__main__":
    main()
