"""MBRL metric logging, the port of ``ivideogpt_tpu/mbrl/logger.py``:
averaged meter groups written as CSV rows and console lines in the same
formats (``TRAIN_FORMAT``, ``EVAL_FORMAT``), and TensorBoard scalars where
``torch.utils.tensorboard`` imports. The console tag is plain text; where
TensorBoard is asked for and does not import, the logger says so once.
"""

from __future__ import annotations

import csv
import datetime
from collections import defaultdict
from pathlib import Path

TRAIN_FORMAT = [("frame", "F", "int"), ("step", "S", "int"),
                ("episode", "E", "int"), ("episode_length", "L", "int"),
                ("episode_reward", "R", "float"),
                ("episode_success", "SS", "float"),
                ("buffer_size", "BS", "int"), ("fps", "FPS", "float"),
                ("total_time", "T", "time")]

EVAL_FORMAT = [("frame", "F", "int"), ("step", "S", "int"),
               ("episode", "E", "int"), ("episode_length", "L", "int"),
               ("episode_reward", "R", "float"),
               ("episode_success", "SS", "float"),
               ("total_time", "T", "time")]


class AverageMeter:
    def __init__(self):
        self._sum, self._count = 0.0, 0

    def update(self, value, n=1):
        self._sum += value
        self._count += n

    def value(self):
        return self._sum / max(1, self._count)


class MetersGroup:
    def __init__(self, csv_path: Path, formating, prefix: str):
        self._csv_path = csv_path
        self._formating = formating
        self._prefix = prefix
        self._meters = defaultdict(AverageMeter)
        self._csv_writer = None
        self._csv_file = None

    def log(self, key, value, n=1):
        self._meters[key].update(value, n)

    def _prime(self):
        data = {}
        for key, meter in self._meters.items():
            for p in ("train/", "eval/"):
                if key.startswith(p):
                    key = key[len(p):]
                    break
            data[key.replace("/", "_")] = meter.value()
        return data

    def _dump_csv(self, data):
        if self._csv_writer is None:
            self._csv_file = self._csv_path.open("a")
            self._csv_writer = csv.DictWriter(
                self._csv_file, fieldnames=sorted(data.keys()), restval=0.0)
            if self._csv_path.stat().st_size == 0:
                self._csv_writer.writeheader()
        self._csv_writer.writerow({k: data.get(k, 0.0)
                                   for k in self._csv_writer.fieldnames})
        self._csv_file.flush()

    @staticmethod
    def _format(key, value, ty):
        if ty == "int":
            return f"{key}: {int(value)}"
        if ty == "float":
            return f"{key}: {value:.4f}"
        if ty == "time":
            return f"{key}: {datetime.timedelta(seconds=int(value))}"
        raise ValueError(ty)

    def _dump_console(self, data, prefix):
        pieces = [f"| {prefix.ljust(6)}"]
        for key, disp, ty in self._formating:
            pieces.append(self._format(disp, data.get(key, 0), ty))
        print(" | ".join(pieces))

    def dump(self, step, prefix):
        if not self._meters:
            return
        data = self._prime()
        data["frame"] = step
        self._dump_csv(data)
        self._dump_console(data, prefix)
        self._meters.clear()


class Logger:
    def __init__(self, log_dir, use_tb: bool = True):
        self._log_dir = Path(log_dir)
        self._train = MetersGroup(self._log_dir / "train.csv", TRAIN_FORMAT,
                                  "train")
        self._eval = MetersGroup(self._log_dir / "eval.csv", EVAL_FORMAT,
                                 "eval")
        self._sw = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"[warn] use_tb: TensorBoard is not available ({e}); "
                      f"the scalars go to the CSV files only")
            else:
                self._sw = SummaryWriter(str(self._log_dir / "tb"))

    def _try_sw_log(self, key, value, step):
        if self._sw is not None:
            self._sw.add_scalar(key, value, step)

    def log(self, key, value, step):
        assert key.startswith("train") or key.startswith("eval"), key
        self._try_sw_log(key, float(value), step)
        mg = self._train if key.startswith("train") else self._eval
        mg.log(key, float(value))

    def log_metrics(self, metrics, step, ty):
        for key, value in metrics.items():
            self.log(f"{ty}/{key}", value, step)

    def dump(self, step, ty=None):
        if ty is None or ty == "train":
            self._train.dump(step, "train")
        if ty is None or ty == "eval":
            self._eval.dump(step, "eval")

    def log_and_dump_ctx(self, step, ty):
        return _LogAndDumpCtx(self, step, ty)


class _LogAndDumpCtx:
    def __init__(self, logger, step, ty):
        self._logger, self._step, self._ty = logger, step, ty

    def __enter__(self):
        return self

    def __call__(self, key, value):
        self._logger.log(f"{self._ty}/{key}", value, self._step)

    def __exit__(self, *args):
        self._logger.dump(self._step, self._ty)
