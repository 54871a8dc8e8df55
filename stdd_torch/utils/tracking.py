"""Experiment tracking shim: Weights & Biases when installed, JSONL always.

The reference integrates wandb in its sweep/variability tooling
(``batch_eval.py:210``, ``ds.py:186``). This wrapper keeps the same call
shape (init / log / log_table / finish) but degrades to local JSONL files so
runs are reproducible without network or the wandb package.

Port of ``stdd_tpu/utils/tracking.py``: the same files. The card's machine
has no wandb, so there the JSONL/CSV path is the whole of it; wandb is used
only where it imports and its run starts.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, Optional, Sequence


class RunTracker:
    def __init__(self, project: str, name: Optional[str] = None,
                 config: Optional[Dict] = None, out_dir: str = "runs",
                 use_wandb: bool = True):
        self.project = project
        self.name = name or time.strftime("%Y%m%d_%H%M%S")
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(project=project, name=self.name,
                                         config=config or {})
            except Exception:   # no package, no login or no network: files only
                self._wandb = None
        self.dir = os.path.join(out_dir, project, self.name)
        os.makedirs(self.dir, exist_ok=True)
        self._f = open(os.path.join(self.dir, "events.jsonl"), "a")
        if config:
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                json.dump(config, f, indent=1, default=str)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        row = {"_t": time.time(), **({"_step": step} if step is not None else {}),
               **metrics}
        self._f.write(json.dumps(row, default=float) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_table(self, key: str, columns: Sequence[str], rows: Iterable[Sequence]) -> None:
        path = os.path.join(self.dir, f"{key}.csv")
        import csv

        rows = [list(r) for r in rows]   # rows may be a one-shot iterable
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(columns)
            w.writerows(rows)
        if self._wandb is not None:
            import wandb  # type: ignore

            self._wandb.log({key: wandb.Table(columns=list(columns),
                                              data=[list(r) for r in rows])})

    def finish(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
