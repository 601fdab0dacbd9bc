"""Wall-clock section timing + metric accumulation.

Counterpart of ``theanompi_tpu/utils/recorder.py``: per-iteration section
timers, images/sec, train cost/error and val top-1/top-5 accumulation,
printing every ``printFreq`` iterations, and per-epoch dumps that a
resumed run loads back.  The reference reported "time per 5120 images",
so the bucket names and that unit are kept.  With telemetry on
(``utils/telemetry.py``; the worker points :attr:`Recorder.telemetry` at
the live registry) every ``end(section)`` feeds one ``phase.<section>``
histogram sample and one ``phase`` event, and every printed train or
validation record becomes a ``train_record`` or ``val_record`` event.

Train metrics arrive as device scalars and are read back (``float`` of a
tensor) only at print cadence, so the card's queue stays full between
prints.  Images/sec is measured on the host's wall clock between prints.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from . import telemetry

IMAGES_PER_REPORT = 5120

SECTIONS = telemetry.PHASES
RECORD_KEYS = tuple("t_" + s for s in SECTIONS if s != "val")


class Recorder:
    # the process-wide telemetry registry (the worker points this at the
    # live one); the inert default costs one attribute check a bracket
    telemetry = telemetry.DISABLED

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.verbose: bool = config.get("verbose", True)
        self.rank: int = config.get("rank", 0)
        self.size: int = config.get("size", 1)
        self.printFreq: int = config.get("printFreq", 40)
        self.record_dir: str = config.get("record_dir", "./inc")

        self._t0: Optional[float] = None
        self.t_sec: Dict[str, float] = defaultdict(float)  # since last print
        self.t_sec_total: Dict[str, float] = defaultdict(float)

        self._train_cost: List = []
        self._train_error: List = []
        self._val_cost: List[float] = []
        self._val_error: List[float] = []
        self._val_error_top5: List[float] = []

        self.n_images: int = 0
        self.n_images_total: int = 0
        self.epoch_records: List[dict] = []
        self._all_records: List[dict] = []
        self._wall_start = time.time()
        self._last_print_wall = self._wall_start

    # -- timing ------------------------------------------------------------

    def start(self) -> None:
        self._t0 = time.time()

    def end(self, section: str) -> float:
        assert self._t0 is not None, "Recorder.end() without start()"
        dt = time.time() - self._t0
        self.t_sec[section] += dt
        self.t_sec_total[section] += dt
        self._t0 = None
        if self.telemetry.enabled:
            self.telemetry.phase(section, dt)
        return dt

    def reset_rate(self) -> None:
        """Start the next images/sec window now (after compile or warm-up,
        which must not count as training time)."""
        self.n_images = 0
        self._last_print_wall = time.time()

    # -- metric accumulation ----------------------------------------------

    def train_error(self, count: int, cost, error, n_images: int = 0) -> None:
        """``cost``/``error`` may be host floats or device scalars."""
        self._train_cost.append(cost)
        self._train_error.append(error)
        self.n_images += n_images
        self.n_images_total += n_images

    def val_error(self, count: int, cost: float, error: float,
                  error_top5: float = 0.0) -> None:
        self._val_cost.append(float(cost))
        self._val_error.append(float(error))
        self._val_error_top5.append(float(error_top5))

    # -- reporting ---------------------------------------------------------

    def images_per_sec(self) -> float:
        t = time.time() - self._last_print_wall
        return self.n_images / t if t > 0 else 0.0

    def time_per_5120(self) -> float:
        ips = self.images_per_sec()
        return IMAGES_PER_REPORT / ips if ips > 0 else float("inf")

    def print_train_info(self, count: int, stride: int = 1) -> Optional[dict]:
        """Read back the recent metrics (this waits for the card to finish
        them), print, and return the record; None between prints.
        ``stride`` = steps per ``train_iter`` call (``steps_per_call``):
        ``count`` then visits only its multiples, and the gate fires once
        every ``ceil(printFreq / stride)`` calls, at least ``printFreq``
        steps apart; the average is over that many call entries (the JAX
        package's gate)."""
        k = max(1, -(-self.printFreq // stride))      # ceil division
        if (count // stride) % k != 0:
            return None
        cost = float(np.mean([float(c) for c in self._train_cost[-k:]])) \
            if self._train_cost else float("nan")
        err = float(np.mean([float(e) for e in self._train_error[-k:]])) \
            if self._train_error else float("nan")
        rec = {"iter": count, "cost": cost, "error": err}
        for key, s in zip(RECORD_KEYS, (s for s in SECTIONS if s != "val")):
            rec[key] = self.t_sec[s]
        ips = self.images_per_sec()
        rec.update(images_per_sec=ips,
                   images_per_sec_per_chip=ips / max(self.size, 1),
                   time_per_5120=self.time_per_5120(),
                   wall=time.time() - self._wall_start)
        self._all_records.append(rec)
        if self.telemetry.enabled:
            self.telemetry.event("train_record", **rec)
        if self.verbose and self.rank == 0:
            print(f"iter {count}: cost {cost:.4f} err {err:.4f} | "
                  f"train {rec['t_train']:.3f}s comm {rec['t_comm']:.3f}s "
                  f"wait {rec['t_wait']:.3f}s load {rec['t_load']:.3f}s "
                  f"stage {rec['t_stage']:.3f}s"
                  + (f" compile {rec['t_compile']:.3f}s"
                     if rec['t_compile'] > 0 else "") + " | "
                  f"{ips:.1f} img/s ({rec['images_per_sec_per_chip']:.1f}"
                  f"/chip, {rec['time_per_5120']:.2f}s per 5120)",
                  flush=True)
        for s in SECTIONS:
            self.t_sec[s] = 0.0
        self.n_images = 0
        self._last_print_wall = time.time()
        return rec

    def print_val_info(self, count: int) -> dict:
        rec = {
            "iter": count,
            "val_cost": float(np.mean(self._val_cost))
            if self._val_cost else float("nan"),
            "val_error": float(np.mean(self._val_error))
            if self._val_error else float("nan"),
            "val_error_top5": float(np.mean(self._val_error_top5))
            if self._val_error_top5 else float("nan"),
            "t_val": self.t_sec_total["val"],
            "t_compile": self.t_sec_total["compile"],
        }
        self.epoch_records.append(rec)
        if self.telemetry.enabled:
            self.telemetry.event("val_record", **rec)
        if self.verbose and self.rank == 0:
            print(f"validation @ iter {count}: cost {rec['val_cost']:.4f} "
                  f"top-1 err {rec['val_error']:.4f} "
                  f"top-5 err {rec['val_error_top5']:.4f}", flush=True)
        self._val_cost, self._val_error, self._val_error_top5 = [], [], []
        return rec

    @property
    def train_records(self) -> List[dict]:
        return list(self._all_records)

    def save(self, record_dir: Optional[str] = None) -> None:
        d = record_dir or self.record_dir
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"inforec_rank{self.rank}.jsonl"), "w") as f:
            for rec in self._all_records + self.epoch_records:
                f.write(json.dumps(rec) + "\n")

    def load(self, record_dir: Optional[str] = None) -> None:
        """Restore both record lists from the JSONL :meth:`save` wrote (epoch
        records are the ones with ``val_cost``), so a resumed run's next
        save keeps the lines from before the resume; a truncated last line
        (a kill mid-save) is skipped."""
        d = record_dir or self.record_dir
        path = os.path.join(d, f"inforec_rank{self.rank}.jsonl")
        if not os.path.exists(path):
            return
        train: List[dict] = []
        epoch: List[dict] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                (epoch if "val_cost" in rec else train).append(rec)
        self._all_records, self.epoch_records = train, epoch
