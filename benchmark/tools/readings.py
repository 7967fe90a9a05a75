"""The readings that a cell's correctness limits are set from, many seeds
in one process (the benchmark's own runs never run this):

- the program: whole runs of the cell (set-up, a short window at the
  cell's own load, the check), one seed after the other;
- the control: the plain reference put in the program's place at the
  nearest precision below the configuration's (TF32 for float32 with
  TF32 off), judged as the program is;
- planted faults in the reference put in the program's place: half of the
  batch left out (the mean taken over the rest), a step that returns its
  state unchanged, every update run backwards, the BatchNorm running
  statistics left unchanged, one module's update run backwards.

Every reading prints every number the check works out, and whether the
cell's limits, by the harness's own decision, call it correct.

    python3 benchmark/tools/readings.py --workload train1-b8 \
        --seeds 11,12,13 [--seconds 3] [--control-seeds 21,22,23]

Prints one JSON line a reading.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def _floats(d: dict) -> dict:
    return {k: v for k, v in d.items() if isinstance(v, float)}


TRAIN_FAULTS = {       # planted in the reference put in the program's place
    "control_tf32": {"tf32": True},
    "fault_half_batch": {"rows": "half"},
    "fault_state_unchanged": {"lr_scale": 0.0},
    "fault_update_reversed": {"lr_scale": -1.0},
    "fault_stats_frozen": {"freeze_stats": True},
    "fault_module_reversed": {"flip": "module"},
}
FLIPPED_MODULE = {1: "fp1_module.", 2: "surface_decoder."}


def control_train(config, traffic, seed, device) -> dict:
    """{kind: every number judge gives} for the TF32 control and each
    planted fault of TRAIN_FAULTS."""
    from benchmark.drivers import train
    from benchmark.harness import weights
    from benchmark.reference import train as ref_train
    ctx = types.SimpleNamespace(config=config, traffic=traffic, seed=seed,
                                device=device)
    train.plan(ctx)
    init = weights.seeded_state(ctx.spec, seed, device)
    stage = traffic["stage"]
    stage1_ref = train.reference_stage1(ctx) if stage == 2 else None
    bins = config["model"]["nocs_bins"]
    own = train.reference_steps(ctx)
    out = {}
    for name, kw in TRAIN_FAULTS.items():
        kw = dict(kw)
        if kw.get("rows") == "half":
            kw["rows"] = slice(0, ctx.batch_size // 2)
        if kw.get("flip") == "module":
            kw["flip"] = FLIPPED_MODULE[stage]
        got = train.reference_steps(ctx, **kw)
        if "rows" in kw:          # judged on the rows it kept
            part = stage1_ref and [{k: v[kw["rows"]] for k, v in r.items()}
                                   for r in stage1_ref]
            out[name] = ref_train.judge(init, own, got, part, bins)
        elif kw.get("tf32") and stage == 2:  # stage 2 follows its answers
            ref = train.reference_steps(ctx, stage1_in=got["stage1"])
            out[name] = ref_train.judge(init, ref, got, stage1_ref, bins)
        else:
            out[name] = ref_train.judge(init, own, got, stage1_ref, bins)
        for k in ("grad_worst", "change_worst", "left_out"):
            out[name].pop(k, None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell, manifest
    bench = manifest.load(ROOT)
    cell_ = manifest.cell(bench, args.workload)
    limits = manifest.limits_of(cell_)
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = {}
        res = cell.run(bench, args.workload, seed, args.seconds, False, t0,
                       numbers_out=numbers)
        print(json.dumps({"seed": seed, "kind": "program",
                          "correct": res["correct"],
                          "numbers": _floats(numbers),
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()}}), flush=True)
    config = manifest.config_of(bench, cell_)
    traffic = manifest.traffic_of(cell_)
    for seed in args.control_seeds:
        out = control_train(config, traffic, seed, "cuda")
        for kind, nums in out.items():
            # judged as the program is, by the harness's own decision
            print(json.dumps({"seed": seed, "kind": kind,
                              "correct": cell.decide(nums, limits)[1],
                              "numbers": _floats(nums)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
