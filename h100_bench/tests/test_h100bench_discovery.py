"""Cells, configurations, traffic mixes, limits and per-layer metrics are
found by name, and a new cell is added by files alone."""

import json
import os
import shutil

import pytest

from h100_bench import cells


def test_every_cell_resolves():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        cell = cells.cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["mode"] in ("train", "play")
        assert cell.config["reduced"] == []
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_every_metric_has_a_reader():
    bench = cells.benchmark()
    for m in bench["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))
        assert cells.metric_reader(m["name"])({}) is None   # nothing to read: no value


def test_configs_name_their_files():
    bench = cells.benchmark()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))
        assert cells.config(c["name"])["name"] == c["name"]


def test_a_new_cell_by_files_alone(tmp_path):
    here = tmp_path / "h100_bench"
    for d in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(cells.HERE, d), here / d)
    (here / "traffic" / "play_1024.yaml").write_text(
        (here / "traffic" / "play_4096.yaml").read_text().replace("envs: 4096", "envs: 1024"))
    (here / "metrics" / "games_per_s.play.py").write_text(
        "def read(record):\n    w = record.get('window') or {}\n"
        "    return w['games'] / w['wall_s'] if w.get('games') else None\n")
    bench = cells.benchmark()
    bench["workloads"].append({"name": "ase_llc.play_1024", "config": "ase_llc_sword_shield_getup",
                               "traffic": "play_1024", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "games_per_s.play", "unit": "1/s", "better": "higher",
                               "source": "program_counter", "layer": "players",
                               "moves": "peak_mem_gib",
                               "workloads": ["ase_llc.play_1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.cell("ase_llc.play_1024", here=str(here))
    assert cell.traffic["envs"] == 1024
    names = [m["name"] for m in cell.per_layer]
    assert "games_per_s.play" in names and "update_share.train" not in names
    read = cells.metric_reader("games_per_s.play", here=str(here))
    assert read({"window": {"games": 30, "wall_s": 10.0}}) == pytest.approx(3.0)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.cell("no.such_cell")
