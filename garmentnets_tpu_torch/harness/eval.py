"""Eval CLI: metrics over prediction.zarr (the port's copy of
garmentnets_tpu/harness/eval.py; reference `eval.py` main).

    python -m garmentnets_tpu_torch.harness.eval \
        main.prediction_output_dir=<predict run dir>

reads configs/eval_default.yaml with dotted overrides. Reads the predict
run's config snapshot, filters null samples (NaN-sentinel marching-cubes
failures), fans the per-sample metric functions out over a worker pool with
per-item exception capture, writes per-sample arrays + nanmean aggregates
into prediction.zarr/summary, and emits all_metrics.csv, all_metrics_agg.csv
and summary.json, the same bytes as the JAX eval on the same
prediction.zarr. Supports the reference's value-threshold indirection (a
zarr path dereferenced at runtime, eval.py:984-989). Host code only
(numpy, scipy, pandas and the C++ Hausdorff helper); the seconds each
metric function took go to the run's timings.json.
"""
from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np
import pandas as pd

from garmentnets_tpu_torch.core import config as config_mod
from garmentnets_tpu_torch.core.logging import make_logger
from garmentnets_tpu_torch.data import zarrlite
from garmentnets_tpu_torch.harness import metrics as metrics_mod
from garmentnets_tpu_torch.harness.parallel_util import parallel_map

METRIC_FUNC_DICT = {
    "compute_optimal_gradient_treshold":
        metrics_mod.compute_optimal_gradient_treshold,
    "compute_pc_metrics": metrics_mod.compute_pc_metrics,
    "compute_grip_point_metrics": metrics_mod.compute_grip_point_metrics,
    "compute_chamfer": metrics_mod.compute_chamfer,
    "compute_hybrid_chamfer": metrics_mod.compute_hybrid_chamfer,
    "compute_geodesic": metrics_mod.compute_geodesic,
    "compute_hausdorff": metrics_mod.compute_hausdorff,
}
NO_OVERRIDE_KEYS = ("compute_optimal_gradient_treshold",
                    "compute_pc_metrics")
DEREFERENCE_KEYS = ("value_threshold",)
# what cli() re-executes: this module, never the JAX package's CLI
MODULE = "garmentnets_tpu_torch.harness.eval"


def is_null(sample_key, samples_group,
            null_key="marching_cubes_mesh/verts") -> bool:
    """Null-sample filter (reference eval.py:939-948)."""
    sample_group = samples_group[sample_key]
    if null_key not in sample_group:
        return True
    arr = sample_group[null_key][:]
    if len(arr) == 0:
        return True
    return bool(np.isnan(arr.flatten()[0]))


def main(cfg, run_dir=None) -> pathlib.Path:
    run_dir = config_mod.make_run_dir(run_dir=run_dir)
    pred_output_dir = pathlib.Path(
        cfg["main"]["prediction_output_dir"]).expanduser()
    pred_config_all = config_mod.load_yaml(pred_output_dir / "config.yaml")

    config_mod.dump_config(cfg, run_dir, extra={
        "prediction_config": dict(pred_config_all),
        "meta": {"script_path": __file__}})

    pred_root = zarrlite.open(str(pred_output_dir / "prediction.zarr"), "r+")
    samples_group = pred_root["samples"]
    summary_group = pred_root.require_group("summary")
    metrics_group = summary_group.require_group("metrics")
    per_sample_group = metrics_group.require_group("per_sample")
    agg_group = metrics_group.require_group("aggregate")

    all_sample_keys = [k for k, _ in samples_group.groups()]
    sample_keys_series = pd.Series(all_sample_keys)
    per_sample_group.array(
        "sample_keys", np.asarray(all_sample_keys), compressor=None)

    # AABBs from the input dataset referenced by the predict config
    input_root = zarrlite.open(
        pred_config_all["config"]["datamodule"]["zarr_path"], "r")
    input_samples_group = input_root["samples"]
    nocs_aabb = input_root["summary/cloth_canonical_aabb_union"][:]
    sim_aabb = input_root["summary/cloth_aabb_union"][:]

    if cfg["eval"]["compute_hausdorff"]["enabled"]:
        # build the C++ helper once, before any worker is forked
        from garmentnets_tpu_torch.ops.geometry import hausdorff_lib
        hausdorff_lib()

    num_workers = cfg["main"]["num_workers"]
    timings = {}
    t_start = time.perf_counter()
    null_key = "marching_cubes_mesh/volume_gradient_magnitude"
    null_df = parallel_map(
        lambda k: is_null(k, samples_group, null_key=null_key),
        sample_keys_series, num_workers=num_workers)
    is_sample_null = null_df.result.astype(bool)
    not_null_keys = sample_keys_series.loc[~is_sample_null]

    cfg_override_all = dict(cfg["override_all"])
    all_metrics = {}
    for func_key, func in METRIC_FUNC_DICT.items():
        metric_args = dict(cfg["eval"][func_key])
        if not metric_args.pop("enabled"):
            continue
        if func_key not in NO_OVERRIDE_KEYS:
            for key, value in cfg_override_all.items():
                if key in DEREFERENCE_KEYS and isinstance(value, str):
                    value = float(np.asarray(pred_root[value]))
                metric_args[key] = value
        print(f"Running {func_key}: {metric_args}")
        t0 = time.perf_counter()
        result_df = parallel_map(
            lambda k: func(
                sample_key=k, samples_group=samples_group,
                input_samples_group=input_samples_group,
                nocs_aabb=nocs_aabb, sim_aabb=sim_aabb, **metric_args),
            not_null_keys, num_workers=num_workers)
        timings[func_key] = time.perf_counter() - t0
        errors = result_df.loc[result_df.error.notnull()]
        if len(errors):
            print(f"Errors in {func_key}:")
            for idx, row in errors.iterrows():
                print(f"  sample {idx}: {row.error}")

        result_dict = {}
        for key in sample_keys_series.index:
            data = {}
            if key in result_df.index:
                value = result_df.result.loc[key]
                if value is not None:
                    data = value
            result_dict[key] = data
        this_df = pd.DataFrame(list(result_dict.values()),
                               index=sample_keys_series.index)
        for column in this_df:
            all_metrics[column] = this_df[column]
            value = np.asarray(this_df[column], np.float64)
            # reference eval.py:910 uses the same Blosc-zstd compressor
            per_sample_group.array(name=column, data=value,
                                   compressor="blosc")
            # an all-NaN column (every sample null for this metric) is a
            # legitimate aggregate of NaN — take it without numpy's noisy
            # "Mean of empty slice" RuntimeWarning
            agg_group[column] = (np.nanmean(value)
                                 if np.isfinite(value).any() else np.nan)
    timings["metrics_total"] = time.perf_counter() - t_start

    all_metrics_df = pd.DataFrame(all_metrics,
                                  index=sample_keys_series.index)
    all_metrics_df["null_percentage"] = is_sample_null.astype(np.float32)
    all_metrics_agg = all_metrics_df.mean()
    print(all_metrics_agg)

    all_metrics_df.to_csv(run_dir / "all_metrics.csv")
    all_metrics_df.describe().to_csv(run_dir / "all_metrics_agg.csv")
    with (run_dir / "summary.json").open("w") as f:
        json.dump({k: float(v) for k, v in all_metrics_agg.items()},
                  f, indent=2)

    # pluggable metrics backend (reference logs the eval summary to wandb,
    # eval.py:885,1041-1046): the local JSONL/summary artifacts are written
    # either way; `logger.backend: wandb` mirrors the aggregates remotely
    logger = make_logger(run_dir, cfg.get("logger"))
    logger.log({k: float(v) for k, v in all_metrics_agg.items()}, step=0)
    logger.summary.update(
        {k: float(v) for k, v in all_metrics_agg.items()})

    # best/worst/regular 3D visualizations (reference eval.py:1052-1096;
    # PLY files instead of wandb.Object3D)
    vis_cfg = dict(cfg.get("vis", {}))
    samples_per_instance = vis_cfg.get("samples_per_instance", 0)
    if samples_per_instance > 0:
        from garmentnets_tpu_torch.harness.eval_vis import (
            VIS_FUNC_DICT, write_ply_points)
        vis_dir = run_dir / "vis"
        vis_dir.mkdir(exist_ok=True)
        rank_metric = vis_cfg.get("rank_metric")
        vis_idx_dict = {}
        if rank_metric in all_metrics_df:
            ranked = all_metrics_df[rank_metric].sort_values()
            for i, idx in enumerate(ranked.index[:vis_cfg.get("num_best",
                                                              2)]):
                vis_idx_dict[idx] = f"best_{i:02d}"
            for i, idx in enumerate(
                    ranked.index[-vis_cfg.get("num_worst", 2):][::-1]):
                vis_idx_dict[idx] = f"worst_{i:02d}"
        for i, idx in enumerate(
                np.arange(vis_cfg.get("num_normal", 10))
                * samples_per_instance):
            if idx < len(sample_keys_series):
                vis_idx_dict.setdefault(int(idx), f"regular_{i:02d}")
        common_args = dict(cfg_override_all)
        for key in DEREFERENCE_KEYS:
            v = common_args.get(key)
            if isinstance(v, str):
                common_args[key] = float(np.asarray(pred_root[v]))
        for idx, tag in vis_idx_dict.items():
            if is_sample_null.get(idx, True):
                continue
            sample_key = sample_keys_series.loc[idx]
            for func_key, func in VIS_FUNC_DICT.items():
                # per-function args (offsets etc., reference
                # config/eval_default.yaml vis block) + global overrides
                metric_args = dict(vis_cfg.get(func_key, {}))
                metric_args.update(common_args)
                pts = func(sample_key, samples_group, **metric_args)
                write_ply_points(
                    vis_dir / f"{func_key}_{tag}.ply", pts)
    logger.close()
    timings["total"] = time.perf_counter() - t_start
    timings["samples"] = len(sample_keys_series)
    timings["null_samples"] = int(is_sample_null.sum())
    with (run_dir / "timings.json").open("w") as f:
        json.dump(timings, f, indent=2)
    return run_dir


def cli():
    # BLAS pin (reference eval.py:3-10): P metric workers on P cores must
    # not each spawn a full BLAS pool. BLAS reads these at library load, so
    # re-exec this module once with the env set rather than pinning at
    # import time (which would silently single-thread any process that
    # merely imports this module).
    blas_vars = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                 "MKL_NUM_THREADS", "VECLIB_MAXIMUM_THREADS",
                 "NUMEXPR_NUM_THREADS")
    if (os.environ.get("_GARMENTNETS_BLAS_PINNED") != "1"
            and any(v not in os.environ for v in blas_vars)):
        env = dict(os.environ, _GARMENTNETS_BLAS_PINNED="1")
        for v in blas_vars:
            env.setdefault(v, "1")
        os.execve(sys.executable,
                  [sys.executable, "-m", MODULE] + sys.argv[1:], env)
    overrides = config_mod.parse_cli(sys.argv[1:])
    cfg = config_mod.load_config("eval_default", overrides)
    print(main(cfg))


if __name__ == "__main__":
    cli()
