"""``BENCHMARK.json`` against the rules every later check holds it to, and
the files its names lead to."""

import importlib.util
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _text(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_text(w) for w in BENCH["command"])
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_run_seconds_fits_a_full_check_of_24_cells():
    seconds = BENCH["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    runs = 2 + 14 * 24
    assert runs * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", list(KEYS))
def test_entries_have_their_keys_and_allowed_names(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(set(names)) == len(names)
    for entry in BENCH[group]:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(entry) <= KEYS[group] | extra, entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert _text(entry[key]), (entry["name"], key)


def test_metric_names_no_two_alike_across_groups():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


def test_configs_are_used_and_their_files_lie_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for config in BENCH["configs"]:
        assert config["name"] in used
        assert any(config["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(config["reduced"]) <= 16 and all(NAME.match(k) for k in config["reduced"])
        data = json.load(open(os.path.join(ROOT, config["file"])))
        assert data["name"] == config["name"] and data["source"] == config["source"]
        assert data["reduced"] == config["reduced"]
        assert os.path.exists(os.path.join(ROOT, os.path.splitext(config["file"])[0] + ".py"))


def test_cells():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(ROOT, "port_bench", "traffic", f"{w['name']}.json"))


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def test_end_to_end_metrics():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers: dict = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in [w["name"] for w in BENCH["workloads"] if _reports(m, w["name"])]:
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, w["name"]) for m in BENCH["per_layer"])


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        path = os.path.join(ROOT, "port_bench", "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location("m", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert callable(module.read)


def test_traffic_files_give_every_call_spec_a_limit_and_a_direction():
    for w in BENCH["workloads"]:
        traffic = json.load(open(os.path.join(ROOT, "port_bench", "traffic", f"{w['name']}.json")))
        assert _text(traffic["why"])
        for call in traffic["calls"]:
            assert call["direction"] in ("forward", "backward")
            assert 0 < call["limit"] < 1
            assert call["batch"] >= 1 and all(n >= 1 for n in call["lengths"])


def test_the_harness_imports_nothing_of_the_jax_package_or_the_builders_scripts():
    banned = re.compile(r"^\s*(import|from)\s+(jax|portfft_tpu(\s|\.|$)|bench\b|chip_)")
    for dirpath, _, files in os.walk(os.path.join(ROOT, "port_bench")):
        for f in files:
            if f.endswith(".py"):
                for line in open(os.path.join(dirpath, f)):
                    assert not banned.match(line), (f, line)
