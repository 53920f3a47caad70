"""Training log (port of ``vqvae_tpu/train/metrics.py``): one JSON
record per logged step in ``<out>/log.jsonl`` (the reference's metric
names) and a console table.  No TensorBoard and no plot."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable


class MetricsLogger:
    def __init__(self, out_dir: str,
                 print_keys: Iterable[str] = ("loss", "loss1", "loss2",
                                              "loss3", "codebook_usage")):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "log.jsonl")
        self._f = open(self.path, "a")
        self.print_keys = list(print_keys)
        self._header = None

    def log(self, step: int, metrics: Dict[str, float],
            echo: bool = True) -> None:
        rec = {"iteration": int(step),
               **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if echo:
            keys = ["iteration"] + [k for k in self.print_keys if k in rec]
            keys += [k for k in ("steps_per_sec",) if k in rec]
            if keys != self._header:
                print("  ".join(f"{k:>14s}" for k in keys))
                self._header = keys
            print("  ".join(f"{rec[k]:14d}" if k == "iteration"
                            else f"{rec[k]:14.5f}" for k in keys),
                  flush=True)

    def close(self) -> None:
        self._f.close()
