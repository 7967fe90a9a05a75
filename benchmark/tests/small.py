"""Cells cut to a size a CPU test can hold: the real configuration and
traffic files with their sizes made small, everything else as shipped."""
from __future__ import annotations

import copy

from benchmark.harness import manifest


def small_cell(name: str) -> dict:
    """kwargs for harness.cell.run: the cell's config, traffic and limits
    cut to CPU size, on the CPU, without the look for a card."""
    bench = manifest.load()
    cell_ = manifest.cell(bench, name)
    cfg = copy.deepcopy(manifest.config_of(bench, cell_))
    tr = copy.deepcopy(manifest.traffic_of(cell_))
    cfg["datamodule"].update(batch_size=2, num_pc_sample=512)
    if cfg["datamodule"]["num_volume_sample"]:
        cfg["datamodule"].update(num_volume_sample=256,
                                 num_surface_sample=256)
    tr.update(batches=4, warm_steps=1)
    return {"config": cfg, "traffic": tr,
            "limits": manifest.limits_of(cell_), "device": "cpu",
            "require_cuda": False}
