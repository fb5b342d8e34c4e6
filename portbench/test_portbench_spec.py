"""Discovery by name and the shape of ``BENCHMARK.json`` (CPU): every name
it holds finds its file, every cell reports what the contract asks, and a new
configuration, mix, metric or cell is files plus an entry."""
import json
import re
import shutil

import pytest

from portbench import spec
from portbench.smoke import program_cfg

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


#: hymba-1.5b's K/V groups: adjacent window layers in pairs (the paper's
#: cross-layer sharing), 16-18 as one where 16-30 leaves an odd count (assumed)
HYMBA_GROUPS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [16, 17, 18],
                [19, 20], [21, 22], [23, 24], [25, 26], [27, 28], [29, 30]]


def _hymba_file() -> dict:
    """hymba-1.5b as released: its widths, 128 meta tokens, K/V groups."""
    cfg = {k: v for k, v in program_cfg("hymba-1.5b", "hymba-1.5b", smoke=False).items()
           if k not in ("name", "meta_tokens", "kv_groups")}
    return dict(cfg, source="https://huggingface.co/nvidia/Hymba-1.5B-Base", meta_tokens=128,
                kv_groups=HYMBA_GROUPS, reduced=[])


def test_an_added_hybrid_cell_with_meta_tokens_needs_only_files_and_entries(tmp_path):
    """Open questions' first cell, hymba-prefill-mix: hymba-1.5b as released
    under the prefill mix. A configuration file, a limits file and entries
    (the cell's name in the prefill metrics' lists, the SSM's readers) find
    the hybrid reference, the prefill driver and the readers, with no change
    to any existing file."""
    shutil.copytree(spec.HERE, tmp_path / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    here = tmp_path / spec.HERE.name
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    (here / "configs" / "hymba-1.5b.json").write_text(json.dumps(_hymba_file()))
    (here / "limits" / "hymba-prefill-mix.json").write_text(
        json.dumps({"numbers": {n: {"limit": 0.1} for n in ("logits_err", "token_gap",
                                                            "kv_err", "ssm_err")}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "hymba-1.5b", "source": _hymba_file()["source"],
                             "file": "portbench/configs/hymba-1.5b.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "hymba-prefill-mix", "config": "hymba-1.5b",
                               "traffic": "prefill-mix", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("prefill_tokens_per_s", "ttft_p95_ms", "mfu.prefill"):
            m["workloads"].append("hymba-prefill-mix")
    bench["per_layer"] += [
        {"name": n, "unit": u, "better": b, "source": "device_trace", "layer": layer,
         "moves": "prefill_tokens_per_s", "workloads": ["hymba-prefill-mix"]}
        for n, u, b, layer in (("ssm_ms.prefill", "ms", "lower", "model: SSM"),
                               ("selective_scan_roofline", "%", "higher", "kernels"))]
    cell = spec.Cell(bench, "hymba-prefill-mix", root=tmp_path)
    assert cell.driver().__file__.endswith("serve_prefill.py")
    assert cell.reference().__name__ == "portbench.reference.hybrid"
    assert {m["name"] for m in cell.end_to_end()} == {"prefill_tokens_per_s", "ttft_p95_ms",
                                                      "setup_s"}
    assert set(cell.metric_readers()) == {"ssm_ms.prefill", "selective_scan_roofline",
                                          "mfu.prefill"}
    names = {n for n, _, _ in cell.reference().param_specs(cell.cfg)}
    assert "meta_tokens" in names and "layers.2.attn.wk.w" not in names
    assert all(p.read_bytes() == b for p, b in before.items())

    from portbench import port
    from repro_torch.configs import get_config

    pc = get_config("hymba-1.5b")
    if (getattr(pc, "meta_tokens", 0), [list(g) for g in getattr(pc, "kv_groups", ())]) == (
            128, HYMBA_GROUPS):  # a program with hymba's meta tokens and K/V groups
        assert port.model_config(cell.cfg).name == "hymba-1.5b"
    else:
        with pytest.raises(ValueError, match="differs"):
            port.model_config(cell.cfg)


@pytest.mark.parametrize("key", [None, "meta_tokens", "kv_groups"])
def test_meta_tokens_and_kv_groups_are_compared_with_the_program(key):
    """A file as the program has them matches; one that adds meta tokens or
    a K/V group it lacks differs."""
    from portbench import port

    cfg = program_cfg("hymba-1.5b", "hymba-1.5b", smoke=False)
    if key == "meta_tokens":
        cfg["meta_tokens"] = cfg.get("meta_tokens", 0) + 128
    elif key == "kv_groups":
        cfg["kv_groups"] = cfg.get("kv_groups", []) + [[40, 41]]
    if key is None:
        assert port.model_config(cfg).name == "hymba-1.5b"
    else:
        with pytest.raises(ValueError, match="differs"):
            port.model_config(cfg)


def test_the_configuration_files_match_the_programs_configs():
    from portbench import port

    for c in BENCH["configs"]:
        cfg = dict(spec.load_json(spec.ROOT / c["file"]), name=c["name"])
        assert port.model_config(cfg).name == cfg["arch"]
        with pytest.raises(ValueError, match="differs"):
            port.model_config(dict(cfg, d_ff=cfg["d_ff"] + 1))
