"""tools/readings.py for the cells of the residual U-Net
(drivers/train_residual.py): the program's runs as readings.py makes
them, then readings.py's control and planted faults with the residual
reference in the program's place, judged by the residual driver (its
`unet_grad_error` included), and three readings of the residual U-Net's
own:

- control_tf32_stage2: TF32 in stage 2 alone, from the f32 reference's
  frozen stage-1 answers (readings.py's control runs stage 1 in TF32
  too, and its stage-1 numbers then fail it whatever the U-Net does);
- fault_residual_left_out: the last decoder's block (at the full grid)
  leaves its residual sum out;
- fault_upsample_reversed: the updates of the four transposed
  convolutions run backwards (readings.py's module-reversed kind pointed
  at `decoders.{i}.upsampling.`).

    python3 benchmark/tools/readings_residual.py \\
        --workload train2-resunet-b24 --seeds 11,12 --control-seeds 21,22

Prints one JSON line a reading, as readings.py.
"""
import argparse
import json
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[2]


def faults(config) -> dict:
    """readings.py's control and faults, then this file's three, as
    keyword arguments of train_residual.reference_steps ("rows": "half"
    and "flip": "module" as readings.py resolves them)."""
    from benchmark.tools import readings
    levels = config["conv_implicit_model"]["unet3d_params"]["num_levels"]
    return {
        **readings.TRAIN_FAULTS,
        "control_tf32_stage2": {"tf32": True, "stage1_in": "f32"},
        "fault_residual_left_out": {"residual_left_out": levels - 2},
        "fault_upsample_reversed": {"flip": tuple(
            f"unet_3d.abstract_3d_unet.decoders.{i}.upsampling."
            for i in range(levels - 1))},
    }


def control_train(config, traffic, seed, device) -> dict:
    """{kind: every number train_residual.judge gives} for each of
    faults(config), readings.control_train's way: a run that keeps half
    the rows is judged on them; the TF32 control's stage 2 against the
    reference's stage 2 from the control's own stage-1 answers."""
    from benchmark.drivers import train, train_residual
    from benchmark.harness import weights
    from benchmark.tools import readings
    ctx = types.SimpleNamespace(config=config, traffic=traffic, seed=seed,
                                device=device)
    train.plan(ctx)
    init = weights.seeded_state(ctx.spec, seed, device)
    stage1_ref = train.reference_stage1(ctx)
    bins = config["model"]["nocs_bins"]
    own = train_residual.reference_steps(ctx)
    out = {}
    for name, kw in faults(config).items():
        kw, ref, part = dict(kw), own, stage1_ref
        if kw.get("rows") == "half":
            kw["rows"] = slice(0, ctx.batch_size // 2)
            part = [{k: v[kw["rows"]] for k, v in r.items()}
                    for r in stage1_ref]
        if kw.get("flip") == "module":
            kw["flip"] = readings.FLIPPED_MODULE[2]
        if kw.get("stage1_in") == "f32":
            kw["stage1_in"] = own["stage1"]
        got = train_residual.reference_steps(ctx, **kw)
        if kw.get("tf32") and "stage1_in" not in kw:
            ref = train_residual.reference_steps(ctx,
                                                 stage1_in=got["stage1"])
        out[name] = train_residual.judge(init, ref, got, part, bins)
        for k in ("grad_worst", "change_worst", "left_out"):
            out[name].pop(k, None)
    return out


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell, manifest
    from benchmark.tools import readings
    args = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", type=readings._ints, default=[])
    known, rest = ap.parse_known_args(args)
    readings.main(["--workload", known.workload] + rest)
    bench = manifest.load(ROOT)
    cell_ = manifest.cell(bench, known.workload)
    limits = manifest.limits_of(cell_)
    config = manifest.config_of(bench, cell_)
    traffic = manifest.traffic_of(cell_)
    for seed in known.control_seeds:
        for kind, nums in control_train(config, traffic, seed,
                                        "cuda").items():
            print(json.dumps({"seed": seed, "kind": kind,
                              "correct": cell.decide(nums, limits)[1],
                              "numbers": readings._floats(nums)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
