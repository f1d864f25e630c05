"""Run-directory artifacts: logging, config dump, CSV results, TensorBoard,
image grids and loss plots. Counterpart of ``fmri_tpu/utils/runlog.py``,
with the same layout::

    <out_root>[/debug]/<family>/<family>_<timestamp>/
        config.json
        train.log
        results.csv
        checkpoints/ckpt_<epoch:05d>/
        images/valid/epoch_<n>.png (+ _original, _generated)
        plots/{GD_loss,ER_loss}.png     (where matplotlib imports)
        tb/                             (where tensorboard imports)

PNGs are written by a small stdlib encoder (8-bit RGB, ``zlib`` +
``struct``), so a machine without PIL writes them too; the loss plots need
matplotlib and are skipped with a log line without it (``results.csv``
holds the same numbers). Nothing here touches the device.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import struct
import time
import zlib
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np


def create_run_dir(out_root: str, family: str, *, debug: bool = False,
                   timestamp: Optional[str] = None) -> str:
    """Timestamped run dir ``<root>[/debug]/<family>/<family>_<ts>/``
    (reference ``train_vgan_stage1.py:126-134``)."""
    ts = timestamp or time.strftime("%Y%m%d-%H%M%S")
    parts = [out_root] + (["debug"] if debug else []) + [family, f"{family}_{ts}"]
    run_dir = os.path.join(*parts)
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def setup_logging(run_dir: str, name: str = "train") -> logging.Logger:
    """A logger ``fmri_tpu_torch.<name>.<run_dir>`` writing to
    ``<run_dir>/<name>.log`` and to stderr."""
    logger = logging.getLogger(f"fmri_tpu_torch.{name}.{run_dir}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(os.path.join(run_dir, f"{name}.log"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(sh)
    return logger


def dump_config(run_dir: str, cfg, extra: Optional[Mapping] = None) -> None:
    """The resolved config as ``config.json`` (the reference dumps its args
    to ``config.txt``, ``train_vgan_stage1.py:137-138``)."""
    payload = json.loads(cfg.to_json()) if hasattr(cfg, "to_json") else dict(cfg)
    if extra:
        payload["run"] = dict(extra)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(payload, f, indent=2, default=str)


class ResultsCSV:
    """The per-epoch results table (reference ``train_vgan_stage1.py:601-618``).
    The columns are the first row's; a row with new columns rewrites the
    file with their union. An existing file is read back, so a resumed run
    appends to it. ``path=None`` keeps the rows in memory (a mesh's ranks
    other than rank 0)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.rows: List[Dict[str, float]] = []
        self.fields: Optional[List[str]] = None
        if path is not None and os.path.exists(path):
            with open(path) as f:
                reader = csv.DictReader(f)
                self.fields = list(reader.fieldnames or [])
                for row in reader:
                    self.rows.append({k: float(v) if v not in ("", None) else float("nan")
                                      for k, v in row.items()})

    @property
    def last_epoch(self) -> int:
        return int(self.rows[-1]["epoch"]) if self.rows else -1

    def append(self, row: Mapping[str, float]) -> None:
        row = {k: float(v) for k, v in row.items()}
        self.rows.append(row)
        if self.fields is None:
            self.fields = list(row.keys())
        new_cols = [k for k in row if k not in self.fields]
        if self.path is None:
            self.fields = self.fields + new_cols
            return
        if new_cols:
            self.fields = self.fields + new_cols
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self.fields)
                w.writeheader()
                for r in self.rows:
                    w.writerow({k: r.get(k, "") for k in self.fields})
            return
        write_header = not os.path.exists(self.path)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.fields, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow({k: row.get(k, "") for k in self.fields})

    def column(self, key: str) -> List[float]:
        return [r.get(key, float("nan")) for r in self.rows]


class TensorBoard:
    """Optional ``torch.utils.tensorboard`` writer under ``<run_dir>/tb``
    (the reference's writers, ``train_vgan_stage1.py:226-229``); every call
    is a no-op where the ``tensorboard`` package is not installed."""

    def __init__(self, run_dir: str, enabled: bool = True):
        self._w = None
        if enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._w = SummaryWriter(os.path.join(run_dir, "tb"))

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def image_grid(self, tag: str, images: np.ndarray, step: int,
                   nrow: int = 8) -> None:
        if self._w is not None:
            self._w.add_image(tag, make_grid(images, nrow=nrow).transpose(2, 0, 1), step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """Tile [N, H, W, C] images in [0, 1] into one HWC grid with a white
    ``pad`` border (the torchvision ``make_grid`` pattern,
    ``train_vgan_stage1.py:475-483``)."""
    images = np.clip(np.asarray(images, np.float32), 0.0, 1.0)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nr = (n + ncol - 1) // ncol
    grid = np.ones((nr * (h + pad) + pad, ncol * (w + pad) + pad, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of a uint8 [H, W, 3] array: signature, IHDR, one
    zlib IDAT of filter-0 scanlines, IEND."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8) -> None:
    """A PNG of the image grid (the reference's matplotlib panels,
    ``train_vgan_stage1.py:465-485``), pixels (x * 255 + 0.5) as uint8."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    grid = make_grid(images, nrow=nrow)
    if grid.shape[2] == 1:
        grid = np.repeat(grid, 3, axis=2)
    with open(path, "wb") as f:
        f.write(encode_png((grid * 255.0 + 0.5).astype(np.uint8)))


def save_loss_plots(results: ResultsCSV, run_dir: str,
                    logger: Optional[logging.Logger] = None) -> None:
    """G/D and E/R loss plots (the reference's ``finally`` block,
    ``train_vgan_stage1.py:625-651``) where matplotlib imports; otherwise
    one log line says so."""
    try:
        import matplotlib
    except ImportError:
        (logger or logging.getLogger(__name__)).info(
            "matplotlib is not installed: no loss plots (results.csv has the losses)")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plots_dir = os.path.join(run_dir, "plots")
    os.makedirs(plots_dir, exist_ok=True)

    def plot(keys_labels: Sequence, title: str, fname: str) -> None:
        fig = plt.figure(figsize=(10, 5))
        plt.title(title)
        any_data = False
        for key, label in keys_labels:
            ys = results.column(key)
            if ys and not all(np.isnan(ys)):
                plt.plot(ys, label=label)
                any_data = True
        plt.xlabel("epochs")
        plt.ylabel("loss")
        if any_data:
            plt.legend()
        fig.savefig(os.path.join(plots_dir, fname))
        plt.close(fig)

    plot([("loss_decoder", "G"), ("loss_discriminator", "D")],
         "Generator and Discriminator Loss During Training", "GD_loss.png")
    plot([("loss_encoder", "E"), ("loss_reconstruction", "R")],
         "Encoder and Reconstruction Loss During Training", "ER_loss.png")
