"""BENCHMARK.json against the naming and wiring rules, and every file it
names."""
from benchmark.harness import manifest


def test_manifest_has_no_problems():
    assert manifest.problems(manifest.load()) == []


def test_every_cell_reports_setup_and_a_per_layer_metric():
    bench = manifest.load()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = manifest.metrics_of(bench, w["name"], True)
        assert layer
        assert {m["moves"] for m in layer} <= e2e


def test_problems_catches_a_bad_name_and_a_wrong_move():
    bench = manifest.load()
    one = bench["workloads"][0]["name"]
    bench["end_to_end"].append(dict(bench["end_to_end"][0], name="only_one",
                                    workloads=[one]))
    bench["per_layer"] = [dict(bench["per_layer"][0], name="bad name"),
                          dict(bench["per_layer"][0], moves="only_one")]
    found = manifest.problems(bench)
    assert any("bad name" in p for p in found)
    assert any("does not report only_one" in p for p in found)


def test_every_metric_has_a_reader():
    bench = manifest.load()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_every_cell_has_limits_on_the_numbers_its_check_gives():
    bench = manifest.load()
    for w in bench["workloads"]:
        limits = manifest.limits_of(w)
        assert limits and all(isinstance(v, float) and v >= 0
                              for v in limits.values())
