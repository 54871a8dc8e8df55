"""Training/eval meters (the reference's ``slowfast/utils/meters.py``).

Own copy of ``stdd_tpu/utils/meters.py`` (``TrainMeter`` :63, ``ValMeter``
:127): deque-windowed scalar smoothing, iteration timing, ETA estimation and
epoch-level stat aggregation, logged as the same ``json_stats`` lines."""

from __future__ import annotations

import datetime
import time
from collections import deque
from typing import Any, Deque, Dict, Optional

from .logging import log_json_stats


class ScalarMeter:
    """Windowed scalar (meters.py ScalarMeter): median/avg over the last N."""

    def __init__(self, window_size: int = 10):
        self.deque: Deque[float] = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self) -> None:
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value: float) -> None:
        self.deque.append(float(value))
        self.total += float(value)
        self.count += 1

    def get_win_median(self) -> float:
        s = sorted(self.deque)
        return s[len(s) // 2] if s else 0.0

    def get_win_avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    def get_global_avg(self) -> float:
        return self.total / max(self.count, 1)


class Timer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = time.perf_counter()
        self.seconds = 0.0

    def pause(self) -> None:
        self.seconds += time.perf_counter() - self._start

    def resume(self) -> None:
        self._start = time.perf_counter()


def eta_str(seconds: float) -> str:
    return str(datetime.timedelta(seconds=int(seconds)))


class TrainMeter:
    """Per-epoch training meter with windowed loss/LR and ETA
    (meters.py TrainMeter)."""

    def __init__(self, epoch_iters: int, max_epoch: int, window_size: int = 10,
                 log_period: int = 10):
        self.epoch_iters = epoch_iters
        self.max_iters = epoch_iters * max_epoch
        self.log_period = log_period
        self.iter_timer = Timer()
        self.loss = ScalarMeter(window_size)
        self.extras: Dict[str, ScalarMeter] = {}
        self.lr = 0.0
        self.num_samples = 0
        self.window_size = window_size

    def iter_tic(self) -> None:
        self.iter_timer.reset()

    def iter_toc(self) -> None:
        self.iter_timer.pause()

    def update_stats(self, loss: float, lr: float, mb_size: int, **extra: float) -> None:
        self.loss.add_value(loss)
        self.lr = lr
        self.num_samples += mb_size
        for k, v in extra.items():
            self.extras.setdefault(k, ScalarMeter(self.window_size)).add_value(v)

    def log_iter_stats(self, cur_epoch: int, cur_iter: int) -> Optional[Dict[str, Any]]:
        if (cur_iter + 1) % self.log_period != 0:
            return None
        iters_done = cur_epoch * self.epoch_iters + cur_iter + 1
        eta = self.iter_timer.seconds * (self.max_iters - iters_done)
        stats = {
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "time_diff": self.iter_timer.seconds,
            "eta": eta_str(eta),
            "loss": self.loss.get_win_median(),
            "lr": self.lr,
        }
        stats.update({k: m.get_win_median() for k, m in self.extras.items()})
        log_json_stats(stats)
        return stats

    def log_epoch_stats(self, cur_epoch: int) -> Dict[str, Any]:
        stats = {
            "_type": "train_epoch",
            "epoch": f"{cur_epoch + 1}",
            "loss": self.loss.get_global_avg(),
            "lr": self.lr,
            "samples": self.num_samples,
        }
        stats.update({k: m.get_global_avg() for k, m in self.extras.items()})
        log_json_stats(stats)
        self.loss.reset()
        for m in self.extras.values():
            m.reset()
        self.num_samples = 0
        return stats


class ValMeter:
    """Validation meter tracking the best metric seen (meters.py ValMeter)."""

    def __init__(self, maximize: bool = True):
        self.maximize = maximize
        self.best = float("-inf") if maximize else float("inf")
        self.best_epoch = -1
        self.history = []

    def update(self, value: float, epoch: int) -> bool:
        self.history.append({"epoch": epoch, "value": value})
        improved = value > self.best if self.maximize else value < self.best
        if improved:
            self.best = value
            self.best_epoch = epoch
        log_json_stats({
            "_type": "val_epoch", "epoch": epoch, "value": value,
            "best": self.best, "best_epoch": self.best_epoch,
        })
        return improved
