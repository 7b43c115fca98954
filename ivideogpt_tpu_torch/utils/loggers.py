"""Trainer-side metric logging, the port's own copy of
``ivideogpt_tpu/utils/loggers.py`` without its TensorBoard writer: each
``log`` appends one JSON line to ``{output_dir}/metrics.jsonl`` and echoes
it to stdout.
"""

from __future__ import annotations

import json
import os
from typing import Dict


class TrainLogger:
    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")

    def log(self, metrics: Dict, step: int, echo: bool = True):
        payload = {"step": step}
        for k, v in metrics.items():
            try:
                payload[k] = round(float(v), 6)
            except (TypeError, ValueError):
                payload[k] = v
        self._jsonl.write(json.dumps(payload) + "\n")
        self._jsonl.flush()
        if echo:
            print(json.dumps(payload))

    def close(self):
        self._jsonl.close()
