"""Run logging: JSONL scalar metrics + image dumps, pluggable remote backend.

The port's copy of garmentnets_tpu/core/logging.py.

Replaces Weights & Biases (reference logs scalars/images/3D objects to wandb,
SURVEY.md §5 "Metrics/logging") with local artifacts of the same content:
- metrics.jsonl: one JSON object per log call {step, ...scalars},
- media/: PNG image dumps (written with zlib, no PIL),
- summary.json written on close.

The interface mirrors the wandb subset the harness uses (`Logger` protocol);
`make_logger` selects the backend from the config's `logger:` block
(reference train_pointnet2.py:30 builds a WandbLogger there). The wandb
adapter is import-guarded — where the package is absent the local
backend is the only one constructible, and the local artifacts are written
in BOTH cases so a run dir is self-contained regardless of backend.
"""
from __future__ import annotations

import json
import pathlib
import struct
import time
import zlib
from typing import Optional, Protocol, runtime_checkable

import numpy as np


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB or RGBA image [H, W, 3|4] uint8 as PNG bytes (the
    standard library's zlib; the images need no PIL)."""
    h, w, c = img.shape
    if img.dtype != np.uint8 or c not in (3, 4):
        raise ValueError(f"png_bytes needs uint8 [H, W, 3|4], got "
                         f"{img.dtype} {img.shape}")

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),          # filter 0
                           np.ascontiguousarray(img).reshape(h, w * c)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


@runtime_checkable
class Logger(Protocol):
    """The logging surface the harness uses (wandb-subset shaped)."""

    name: str
    summary: dict

    def log(self, data: dict, step: Optional[int] = None) -> None: ...

    def log_image(self, name: str, img: np.ndarray,
                  step: Optional[int] = None) -> None: ...

    def close(self) -> None: ...


class RunLogger:
    def __init__(self, run_dir, name: Optional[str] = None):
        self.run_dir = pathlib.Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.media_dir = self.run_dir / "media"
        self._metrics_f = (self.run_dir / "metrics.jsonl").open("a")
        self.name = name or self.run_dir.name
        self.summary: dict = {}
        self._t0 = time.time()

    def log(self, data: dict, step: Optional[int] = None):
        rec = {"_step": step, "_t": round(time.time() - self._t0, 3)}
        for k, v in data.items():
            if isinstance(v, (int, float, str, bool)) or v is None:
                rec[k] = v
            elif np.isscalar(v) or (hasattr(v, "ndim") and v.ndim == 0):
                rec[k] = float(v)
        self._metrics_f.write(json.dumps(rec) + "\n")
        self._metrics_f.flush()

    def log_image(self, name: str, img: np.ndarray,
                  step: Optional[int] = None):
        """img: HxWx{3,4} float [0,1] or uint8."""
        self.media_dir.mkdir(exist_ok=True)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        tag = f"{name}_{step}" if step is not None else name
        (self.media_dir / f"{tag}.png").write_bytes(png_bytes(img))

    def close(self):
        with (self.run_dir / "summary.json").open("w") as f:
            json.dump(self.summary, f, indent=2, default=float)
        self._metrics_f.close()


class WandbLogger:
    """Remote adapter: mirrors every call to wandb AND to a local RunLogger
    (the run dir stays self-contained — eval reads predict's local snapshot
    either way). Construction fails with a clear message when the wandb
    package is absent; `make_logger` only builds this on explicit
    `backend: wandb` config, so the default local path never imports it.

    Config keys follow the reference's logger block
    (train_pointnet2.py:28-37): mode/offline, name, tags, project.
    """

    def __init__(self, run_dir, name: Optional[str] = None,
                 project: str = "garmentnets_tpu", tags=(),
                 offline: bool = True, **init_kwargs):
        try:
            import wandb  # noqa: F401  (optional dependency)
        except ImportError as e:  # pragma: no cover - exercised via fake
            raise ImportError(
                "logger.backend='wandb' requires the wandb package; "
                "use backend='local' (default) in this environment") from e
        self._local = RunLogger(run_dir, name=name)
        self.name = self._local.name
        self._run = wandb.init(
            project=project, name=self.name, tags=list(tags or ()),
            mode="offline" if offline else "online",
            dir=str(self._local.run_dir), **init_kwargs)

    @property
    def summary(self) -> dict:
        return self._local.summary

    def log(self, data: dict, step: Optional[int] = None):
        self._local.log(data, step=step)
        self._run.log(dict(data), step=step)

    def log_image(self, name: str, img: np.ndarray,
                  step: Optional[int] = None):
        self._local.log_image(name, img, step=step)
        import wandb
        self._run.log({name: wandb.Image(img)}, step=step)

    def close(self):
        for k, v in self._local.summary.items():
            self._run.summary[k] = v
        self._run.finish()
        self._local.close()


def make_logger(run_dir, logger_cfg: Optional[dict] = None,
                name: Optional[str] = None) -> Logger:
    """Build the run logger from the config's `logger:` block.

    backend: 'local' (default) -> RunLogger; 'wandb' -> WandbLogger.
    The reference's existing keys (mode/offline, name, tags) pass through;
    unknown blocks fall back to local so old configs keep working.
    """
    cfg = dict(logger_cfg or {})
    backend = str(cfg.pop("backend", "local") or "local").lower()
    name = cfg.pop("name", None) or name
    if backend == "local":
        return RunLogger(run_dir, name=name)
    if backend == "wandb":
        mode = cfg.pop("mode", None)
        offline = bool(cfg.pop("offline", mode != "online"))
        return WandbLogger(run_dir, name=name, offline=offline, **cfg)
    raise ValueError(
        f"unknown logger.backend {backend!r}; expected 'local' or 'wandb'")
