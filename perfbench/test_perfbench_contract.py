"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name: a configuration, a mix, a reader for each
per-layer metric, a reference family and the limits of each cell."""

import importlib
import json
import re
from pathlib import Path

import pytest

from perfbench import check, traffic

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits: 2 + 14 × 24 runs
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs_files_and_reductions():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["name"] in used
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key)
            assert cfg["model"][key] != cfg["published"][key]
            assert not key.endswith(("_dim", "_rank")) and key not in (
                "d_model", "d_ff", "n_heads", "n_kv_heads", "head_dim",
                "ssm_state", "ssm_expand", "experts_per_token")
        for key, value in cfg["published"].items():
            if key not in c["reduced"]:
                assert cfg["model"][key] == value, key
        assert (ROOT / "perfbench" / "reference"
                / f"{cfg['reference']}.py").exists()
        # a family brings all the harness asks of it in its own file
        fam = importlib.import_module(f"perfbench.reference."
                                      f"{cfg['reference']}")
        for fn in ("layout", "loss", "model_flops"):
            assert callable(getattr(fam, fn, None)), (cfg["reference"], fn)


def test_workloads_mixes_and_limits():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= \
        max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        mix = json.loads((ROOT / "perfbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        traffic.check(mix)
        limits = json.loads((ROOT / "perfbench" / "limits"
                             / f"{w['name']}.json").read_text())
        assert limits and set(limits) <= set(check.NUMBERS)
        for k, v in limits.items():
            assert v["lower"] < v["limit"] < v["upper"], k
            # more room above the lower reading than below the upper
            assert v["limit"] / v["lower"] >= 2
            assert v["upper"] / v["limit"] >= 1.5


def test_metrics():
    e2e = BENCH["end_to_end"]
    per = BENCH["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert "setup_s" in names and 1 <= len(e2e) <= 16
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {x["name"] for x in e2e}
        assert _line(m["layer"]) and set(m["workloads"]) <= cells
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline_pct.train") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in per)
        assert any(m["name"] != "setup_s" and cell in m.get("workloads",
                                                            cells)
                   for m in e2e)


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (ROOT / "perfbench" / "metrics").glob("*.py")))
def test_every_reader_is_named_in_the_benchmark(name):
    assert name in {m["name"] for m in BENCH["per_layer"]}
