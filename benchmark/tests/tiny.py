"""Tiny configurations and mixes for the CPU tests: the repository's tiny
tokenizer (16/32/32 channels, 64 codes a codebook) and a two-layer LLaMA
of head size 64, a segment of 5 frames, batches of a few rows."""

import copy
import json
import os
import time

import torch

from benchmark import harness

REPO = harness.ROOT


def config(action: bool = True) -> dict:
    with open(os.path.join(REPO, "configs", "tiny", "tokenizer.json")) as f:
        tok = json.load(f)
    lm = dict(harness.config("ivg64-base")["transformer"], hidden_size=128,
              intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=2, num_key_value_heads=2,
              vocab_size=tok["num_vq_embeddings"]
              + tok["num_dyn_embeddings"] + 2)
    return {"name": "tiny", "tokenizer": tok, "transformer": lm,
            "action_conditioned": action, "action_dim": 4,
            "context_length": 2, "segment_length": 5}


def rollout_mix() -> dict:
    return dict(harness.traffic("rollout-b256"), batch=4, top_k=5,
                check_rows=4, detok_chunk=3)


def train_mix(name: str) -> dict:
    mix = copy.deepcopy(harness.traffic(name))
    mix.update(batch=2, loader_threads=2, episodes=4)
    mix["recipe"]["warmup_steps"] = 2
    return mix


def run(name, cfg, mix, seed=2 ** 33 + 5, seconds=0.5, trace=False):
    from benchmark.run import Run
    return Run(name, cfg, mix, seed, seconds, trace, torch.device("cpu"),
               time.time())
