"""Batched inference server (torch port of garmentnets_tpu/harness/serve.py).

A resident process that keeps the engine and its weights on the card and
groups concurrent requests into device batches. It serves the full predict
path (PointNet++ NOCS -> WNF -> marching cubes -> warp field) over plain
HTTP with an npz wire format; numpy is the only client dependency, and the
wire contract is the JAX server's, so its clients work unchanged.

Design:
- requests enqueue garments; one dispatcher thread groups them into
  fixed-shape batches (zero-padded when traffic is sparse) after a short
  batching window, so concurrent clients share device work. All torch work
  runs on that thread: HTTP threads only decode npz and enqueue
  (`core.device.full_f32` sets a process-global matmul precision, which
  concurrent torch work would race with).
- the dispatcher pipelines device and host work: encode(i+1) is queued
  before batch i's host marching cubes, and warp results are collected one
  batch later (depth 2). The engine's prefetch events let the host wait for
  exactly the batch it reads (harness/predict_engine.py).
- clouds arriving with != num_points points are resampled server-side:
  a seeded uniform choice without replacement when oversized, repeat
  padding when undersized (the dataset's convention).

Endpoints:
  GET  /healthz          -> JSON {status, batch_size, num_points, ...stats}
  POST /predict          -> body: npz{x [B,N,3] f32 rgb, pos [B,N,3] f32}
                            response: npz with per-garment keys
                            ok_i, verts_i, faces_i, normals_i,
                            warp_field_i, volume_value_i, verts_ggm_i,
                            pred_nocs_i, pred_nocs_confidence_i
                            (i = 0..B-1; ok_i=0 marks a garment without a
                            surface) and count

Client helper: `predict_remote(url, x, pos)` returns the decoded
per-garment dicts. CLI (reads configs/serve_default.yaml, dotted
overrides; needs pyyaml):

    python -m garmentnets_tpu_torch.harness.serve \\
        main.checkpoint_path=<pipeline.ckpt>
"""
from __future__ import annotations

import collections
import io
import json
import pathlib
import queue
import sys
import threading
import time

import numpy as np


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------
def encode_npz(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def decode_npz(data: bytes) -> dict:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def _normalize_cloud(x, pos, n_points: int, seed: int = 0):
    """Resample one garment's cloud to exactly n_points (uniform choice
    without replacement when oversized, repeat-pad when undersized)."""
    n = len(pos)
    if n == n_points:
        return x, pos
    rs = np.random.RandomState(seed)
    if n > n_points:
        idx = rs.choice(n, size=n_points, replace=False)
    else:
        idx = np.concatenate(
            [np.arange(n), rs.choice(n, size=n_points - n, replace=True)])
    return x[idx], pos[idx]


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------
class _Job:
    __slots__ = ("x", "pos", "event", "result")

    def __init__(self, x, pos):
        self.x = x
        self.pos = pos
        self.event = threading.Event()
        self.result = None


class PredictService:
    """Owns the engine and the batching dispatcher thread."""

    def __init__(self, checkpoint_path, batch_size: int = 8,
                 num_points: int = 6000, volume_size: int = 128,
                 batch_window_ms: float = 20.0,
                 engine_kwargs: dict | None = None, device="cuda"):
        from garmentnets_tpu_torch.core.checkpoint import (
            load_pipeline_checkpoint)
        from garmentnets_tpu_torch.harness.predict_engine import (
            PredictEngine)
        cfg, state_dict = load_pipeline_checkpoint(checkpoint_path)
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.num_points = int(num_points)
        self.batch_window_s = float(batch_window_ms) / 1000.0
        self.engine = PredictEngine(
            cfg, state_dict, volume_size=int(volume_size), device=device,
            num_points=self.num_points, points_key="server.num_points",
            **(engine_kwargs or {}))
        self._queue: "queue.Queue[_Job]" = queue.Queue()
        self._stop = threading.Event()
        self._pending_state = None   # hot-reload staging (lock-guarded)
        self._reload_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # mc_overlapped: batches whose host marching cubes began while the
        # next batch's encode was still running on the device
        self.stats = {"requests": 0, "garments": 0, "batches": 0,
                      "reloads": 0, "mc_overlapped": 0,
                      "started": time.time()}
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True, name="gn-dispatcher")
        self._thread.start()

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def reload_checkpoint(self, checkpoint_path) -> None:
        """Hot-swap the model weights without restarting the service.

        The new checkpoint must build the same PipelineConfig. The
        dispatcher applies the swap between device batches, with nothing
        in flight, so every batch runs its encode and its warp on the same
        weights."""
        from garmentnets_tpu_torch.core.checkpoint import (
            load_pipeline_checkpoint)
        cfg, state_dict = load_pipeline_checkpoint(checkpoint_path)
        if cfg != self.cfg:
            raise ValueError(
                "hot-reload requires an architecture-identical checkpoint "
                f"(got {cfg} vs serving {self.cfg}); restart the service "
                "for architecture changes")
        with self._reload_lock:
            self._pending_state = state_dict

    def _maybe_apply_reload(self) -> None:
        with self._reload_lock:
            pending, self._pending_state = self._pending_state, None
        if pending is not None:
            self.engine.load_state_dict(pending)
            self._count("reloads")

    # -- client-facing ---------------------------------------------------
    def submit(self, x: np.ndarray, pos: np.ndarray, timeout: float = 300.0
               ) -> list:
        """x, pos: [B, N, 3]; blocks until the batch's garments are done.
        Returns per-garment result dicts."""
        x = np.asarray(x, np.float32)
        pos = np.asarray(pos, np.float32)
        if x.ndim != 3 or x.shape[-1] != 3 or pos.shape != x.shape:
            raise ValueError(f"x and pos must both be [B, N, 3], got "
                             f"{x.shape} and {pos.shape}")
        jobs = []
        for b in range(len(x)):
            xb, pb = _normalize_cloud(x[b], pos[b], self.num_points, seed=b)
            job = _Job(xb, pb)
            jobs.append(job)
            self._queue.put(job)
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["garments"] += len(jobs)
        out = []
        for job in jobs:
            if not job.event.wait(timeout):
                raise TimeoutError("predict service timed out")
            out.append(job.result)
        return out

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
        self.engine.close()

    # -- dispatcher ------------------------------------------------------
    def _take_batch(self) -> list:
        """Collect up to batch_size jobs; after the first arrives, wait at
        most batch_window_s for more so sparse traffic isn't stalled."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        jobs = [first]
        deadline = time.time() + self.batch_window_s
        while len(jobs) < self.batch_size:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                jobs.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return jobs

    def _encode_jobs(self, jobs) -> dict:
        """Queue one zero-padded fixed-shape batch on the device and the
        copies of what the host will read."""
        x = np.zeros((self.batch_size, self.num_points, 3), np.float32)
        pos = np.zeros((self.batch_size, self.num_points, 3), np.float32)
        for i, job in enumerate(jobs):
            x[i] = job.x
            pos[i] = job.pos
        enc = self.engine.encode(x, pos)
        self.engine.prefetch(
            enc, extra_keys=("pred_nocs", "pred_nocs_confidence"))
        return enc

    def _dispatch_loop(self) -> None:
        # encode(i+1) is queued before batch i's host marching cubes, and
        # warp results are collected one batch later (depth 2). When
        # traffic pauses (take_batch comes back empty) everything in flight
        # is drained, so an idle arrival waits for one batch, not two.
        # A failing batch reports an error result to its own waiters and
        # the dispatcher keeps serving.
        pending = None                  # (enc, jobs) awaiting extract+warp
        inflight = collections.deque()  # (handle, jobs, enc, meshes)
        while not self._stop.is_set():
            jobs = self._take_batch()
            if self._pending_state is not None:
                # swap weights only with an empty pipeline; checked after
                # take_batch so a reload staged while the dispatcher waits
                # applies before the batch that arrived with it
                if pending is not None:
                    self._finalize_safe(*pending)
                    pending = None
                while inflight:
                    self._collect_safe(*inflight.popleft())
                self._maybe_apply_reload()
            nxt = None
            if jobs:
                try:
                    nxt = (self._encode_jobs(jobs), jobs)
                except Exception as e:  # noqa: BLE001
                    self._fail_jobs(jobs, e)
            if pending is not None:
                enc, pjobs = pending
                try:
                    self.engine.host_outputs(enc)    # batch i on the host
                    overlapped = nxt is not None and not (
                        self.engine.encode_done(nxt[0]))
                    meshes = self.engine.extract_meshes(enc)
                    if overlapped:
                        self._count("mc_overlapped")
                    handle = self.engine.warp_dispatch(enc, meshes)
                    inflight.append((handle, pjobs, enc, meshes))
                except Exception as e:  # noqa: BLE001
                    self._fail_jobs(pjobs, e)
                while len(inflight) > 1:
                    self._collect_safe(*inflight.popleft())
            pending = nxt
            if nxt is None:
                while inflight:      # traffic pause: don't sit on results
                    self._collect_safe(*inflight.popleft())
        if pending is not None:
            self._finalize_safe(*pending)
        while inflight:
            self._collect_safe(*inflight.popleft())

    def _collect_safe(self, handle, jobs, enc, meshes) -> None:
        try:
            warps = self.engine.warp_collect(handle)
            self._publish(enc, jobs, meshes, warps)
        except Exception as e:  # noqa: BLE001
            self._fail_jobs(jobs, e)

    def _finalize_safe(self, enc, jobs) -> None:
        try:
            meshes = self.engine.extract_meshes(enc)
            warps = self.engine.warp_batch(enc, meshes)
            self._publish(enc, jobs, meshes, warps)
        except Exception as e:  # noqa: BLE001
            self._fail_jobs(jobs, e)

    @staticmethod
    def _fail_jobs(jobs, exc) -> None:
        for job in jobs:
            if not job.event.is_set():
                job.result = {"ok": np.int32(0),
                              "error": np.bytes_(repr(exc).encode())}
                job.event.set()

    def _publish(self, enc, jobs, meshes, warps) -> None:
        host = self.engine.host_outputs(enc)
        pred_nocs = host["pred_nocs"].numpy()
        pred_conf = host["pred_nocs_confidence"].numpy()
        self._count("batches")
        for i, job in enumerate(jobs):
            m, w = meshes[i], warps[i]
            if m is None or w is None:
                job.result = {"ok": np.int32(0)}     # no surface
            else:
                verts, faces, values, normals = m
                if normals is None:     # device normals ride the warp
                    normals = w["normals"]
                job.result = {
                    "ok": np.int32(1),
                    "verts": verts.astype(np.float32),
                    "faces": faces.astype(np.int32),
                    "normals": normals.astype(np.float32),
                    "volume_value": values.astype(np.float32),
                    "warp_field": w["warp_field"].astype(np.float32),
                    "verts_ggm": w["verts_ggm"].astype(np.float32),
                }
            # copies: the host buffers are pinned memory
            job.result["pred_nocs"] = np.array(pred_nocs[i], np.float32)
            job.result["pred_nocs_confidence"] = np.array(pred_conf[i],
                                                          np.float32)
            job.event.set()


# ---------------------------------------------------------------------------
# HTTP layer (stdlib)
# ---------------------------------------------------------------------------
def make_http_server(service: PredictService, host: str = "127.0.0.1",
                     port: int = 8777):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, b"not found", "text/plain")
                return
            with service._stats_lock:
                info = dict(service.stats)
            info.update({
                "status": "ok",
                "uptime_sec": round(time.time() - info.pop("started"), 1),
                "batch_size": service.batch_size,
                "num_points": service.num_points,
                "volume_size": service.engine.volume_size,
                "device": str(service.engine.device),
            })
            self._send(200, json.dumps(info).encode(), "application/json")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = decode_npz(self.rfile.read(n))
                results = service.submit(req["x"], req["pos"])
                flat = {}
                for i, r in enumerate(results):
                    for k, v in r.items():
                        flat[f"{k}_{i}"] = v
                flat["count"] = np.int32(len(results))
                self._send(200, encode_npz(flat), "application/octet-stream")
            except Exception as e:  # noqa: BLE001 — per-request isolation
                self._send(400, json.dumps(
                    {"error": repr(e)}).encode(), "application/json")

    return ThreadingHTTPServer((host, port), Handler)


def predict_remote(url: str, x: np.ndarray, pos: np.ndarray) -> list:
    """Client helper: POST one request, return per-garment result dicts."""
    from urllib.request import Request, urlopen
    body = encode_npz({"x": np.asarray(x, np.float32),
                       "pos": np.asarray(pos, np.float32)})
    req = Request(url.rstrip("/") + "/predict", data=body,
                  headers={"Content-Type": "application/octet-stream"})
    with urlopen(req) as resp:
        flat = decode_npz(resp.read())
    out = [dict() for _ in range(int(flat["count"]))]
    for k, v in flat.items():
        if k == "count":
            continue
        # exact index parse (a suffix test would conflate item 1 with
        # item 11 in batches of more than ten garments)
        name, idx = k.rsplit("_", 1)
        out[int(idx)][name] = v
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(cfg: dict) -> None:
    """Serve until interrupted. `server.device` picks the device (the card
    unless it says cpu); `prediction.decode_precision` picks the dense
    decode's tier ('high' when unset, as in the JAX server);
    `prediction.device_normals=true` takes the mesh normals from the warp
    (off when unset, as the JAX server without its environment switch)."""
    from garmentnets_tpu_torch.core.config import optional_flag
    server_cfg = cfg.get("server", {})
    pred_cfg = cfg.get("prediction", {})
    service = PredictService(
        pathlib.Path(cfg["main"]["checkpoint_path"]).expanduser(),
        batch_size=server_cfg.get("batch_size", 8),
        num_points=server_cfg.get("num_points", 6000),
        volume_size=pred_cfg.get("volume_size", 128),
        batch_window_ms=server_cfg.get("batch_window_ms", 20.0),
        device=server_cfg.get("device", "cuda"),
        engine_kwargs={
            "gradient_sigma": pred_cfg.get("gradient_sigma", 0.5),
            "iso_level": pred_cfg.get("iso_surface_level", 0.5),
            "gradient_direction": pred_cfg.get("gradient_direction",
                                               "ascent"),
            "decode_precision": pred_cfg.get("decode_precision", "high"),
            "device_normals": optional_flag(cfg, "prediction.device_normals"),
        })
    host = server_cfg.get("host", "127.0.0.1")
    port = int(server_cfg.get("port", 8777))
    httpd = make_http_server(service, host, port)
    print(f"garmentnets predict server (PyTorch port) on "
          f"http://{host}:{port} (batch {service.batch_size}, "
          f"{service.num_points} pts, {service.engine.volume_size}^3 WNF, "
          f"{service.engine.device})", file=sys.stderr)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        service.close()


def cli() -> None:
    from garmentnets_tpu_torch.core.config import load_config, parse_cli
    main(load_config("serve_default", parse_cli(sys.argv[1:])))


if __name__ == "__main__":
    cli()
