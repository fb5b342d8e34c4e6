"""Discovery by name and the shape of ``BENCHMARK.json`` (CPU): every name
it holds finds its file, every cell reports what the contract asks, and a new
configuration, mix, metric or cell is files plus an entry."""
import json
import re
import shutil

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"]) and m["better"] in (
            "lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_finds_its_files_by_name(workload):
    cell = spec.Cell(BENCH, workload)
    assert cell.cfg["name"] == cell.entry["config"]
    assert cell.traffic["kind"] and cell.limits["numbers"]
    assert hasattr(cell.driver(), "setup")
    assert hasattr(cell.reference(), "param_specs")
    readers = cell.metric_readers()
    assert readers and all(hasattr(r, "read") for r in readers.values())
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e - {"setup_s"}:
        assert (spec.HERE / "metrics" / f"{m}.py").is_file()
    for m in cell.per_layer():
        assert m["moves"] in e2e, (workload, m["name"])


def test_every_configuration_is_used_and_names_its_file_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert (spec.HERE / "reference" / f"{cfg['family']}.py").is_file()


def test_an_added_cell_needs_only_files_and_an_entry(tmp_path):
    """Open questions' third cell (phi-3-vision, one prompt of 16,384
    tokens): a traffic mix, a limits file and an entry, found without a
    change to any existing file."""
    shutil.copytree(spec.HERE, tmp_path / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    here = tmp_path / spec.HERE.name
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "phi3v-prefill-16k", "config": "phi-3-vision-4.2b",
                               "traffic": "prefill-16k", "chips": 1, "why": "x"})
    with pytest.raises(FileNotFoundError):  # its mix is its own file
        spec.Cell(bench, "phi3v-prefill-16k", root=tmp_path)
    mix = dict(spec.load_json(here / "traffic" / "prefill-mix.json"), batch=1, lengths=[16384])
    (here / "traffic" / "prefill-16k.json").write_text(json.dumps(mix))
    with pytest.raises(FileNotFoundError):  # and so are its limits
        spec.Cell(bench, "phi3v-prefill-16k", root=tmp_path)
    (here / "limits" / "phi3v-prefill-16k.json").write_text(
        json.dumps({"numbers": {"logits_err": {"limit": 0.05}}}))
    cell = spec.Cell(bench, "phi3v-prefill-16k", root=tmp_path)
    assert cell.driver().__file__.endswith("serve_prefill.py")
    assert cell.reference().__name__.endswith(".vlm")
    assert cell.traffic["lengths"] == [16384]
    assert set(cell.metric_readers()) == {m["name"] for m in cell.per_layer()}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_the_configuration_files_match_the_programs_configs():
    from portbench import port

    for c in BENCH["configs"]:
        cfg = dict(spec.load_json(spec.ROOT / c["file"]), name=c["name"])
        assert port.model_config(cfg).name == cfg["arch"]
        with pytest.raises(ValueError, match="differs"):
            port.model_config(dict(cfg, d_ff=cfg["d_ff"] + 1))
