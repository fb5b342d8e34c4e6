"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's
contract (``tests/test_dryrun_contract.py``): the production mesh shapes,
allocation-free input stand-ins (meta tensors here, ``ShapeDtypeStruct``
there), the skip rule, and one real cell (llama3.2-1b decode_32k on 16x16)
priced with the reference's record keys. The reference builds its 512-device
mesh in a subprocess; the port's mesh is an ``AbstractMesh`` in process,
and the CLI runs in a subprocess where ``jax`` cannot be imported.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import tree as T
from repro_torch.analysis import flops as F
from repro_torch.analysis import report
from repro_torch.configs import ARCH_IDS, get_config, get_shape, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh, production_shape

REPO = Path(__file__).resolve().parents[1]
#: the reference's record keys (src/repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "kind", "multi_pod", "mesh", "transport", "kv_partition",
            "moe_dispatch", "lower_s", "compile_s", "memory", "cost_analysis", "roofline",
            "skipped"}
REF_MEMORY = {"argument_bytes", "output_bytes", "alias_bytes", "temp_bytes",
              "per_device_total", "fits_16GB"}
REF_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant", "flops_per_dev",
                "bytes_per_dev", "coll_bytes_per_dev", "dcn_bytes_per_dev", "model_flops",
                "hlo_useful_ratio", "step_time_s", "mfu"}


class TestMeshContract:
    def test_production_mesh_shapes(self):
        m1 = AbstractMesh(production_shape())
        m2 = AbstractMesh(production_shape(multi_pod=True))
        assert m1.axis_names == ("data", "model") and tuple(m1.shape.values()) == (16, 16)
        assert m2.axis_names == ("pod", "data", "model")
        assert tuple(m2.shape.values()) == (2, 16, 16) and m2.size == 512
        last = AbstractMesh(production_shape(multi_pod=True), rank=511)
        assert last.coords == {"pod": 1, "data": 15, "model": 15}
        with pytest.raises(RuntimeError, match="torch.distributed"):
            make_production_mesh(device="cpu")  # the real mesh needs its 256 ranks

    def test_input_specs_are_meta_tensors(self):
        specs = dryrun.input_specs("llama3.2-1b", "train_4k")
        leaves = [l for l in T.leaves(specs) if isinstance(l, torch.Tensor)]
        assert leaves and all(l.device.type == "meta" for l in leaves)
        assert specs["tokens"].shape == (256, 4096)

        dec = dryrun.input_specs("llama3.2-1b", "decode_32k")
        assert all(l.device.type == "meta" for l in T.leaves(dec)
                   if isinstance(l, torch.Tensor))
        assert dec["batch"]["tokens"].shape == (128, 1)
        assert dec["cache"]["k"].shape[2] == 32768  # cache of seq_len

    def test_skip_rule(self):
        ok, _ = shape_applicable(get_config("qwen2-7b"), get_shape("long_500k"))
        assert not ok
        ok, _ = shape_applicable(get_config("hymba-1.5b"), get_shape("long_500k"))
        assert ok
        ok, _ = shape_applicable(get_config("xlstm-125m"), get_shape("long_500k"))
        assert ok

    def test_untrained_families_skip_train_with_reason(self):
        """The five archs whose train_4k cell was skipped before their
        families trained (the name is from then) are priced now, on the 16x16
        mesh; ``long_500k`` of a full-attention arch is still skipped with its
        reason."""
        families = ("vlm", "moe", "ssm", "audio")
        newly = [a for a in ARCH_IDS if get_config(a).family in families]
        assert len(newly) == 5
        for arch in newly:
            rec = dryrun.lower_cell(arch, "train_4k", multi_pod=False)
            assert not rec.get("skipped") and "error" not in rec, rec
            assert rec["cost_analysis"]["flops"] > 0 and rec["memory"]["fits_device"], arch
            assert rec["roofline"]["collective_s"] > 0, arch
        rec = dryrun.lower_cell("qwen2-7b", "long_500k", multi_pod=True)
        assert rec["skipped"] and "long_500k" in rec["reason"]


class TestOneCellPriced:
    def test_llama_decode_cell(self):
        """One real cell priced on the 16x16 mesh, with the reference's keys."""
        rec = dryrun.lower_cell("llama3.2-1b", "decode_32k", multi_pod=False)
        assert not rec.get("skipped") and "error" not in rec
        assert REF_KEYS <= set(rec) and REF_MEMORY <= set(rec["memory"])
        assert REF_ROOFLINE <= set(rec["roofline"])
        assert rec["memory"]["fits_16GB"] and rec["memory"]["fits_device"]
        assert rec["roofline"]["collective_s"] >= 0
        # 8 KV heads do not split over 16: flash-decode over the sequence
        assert rec["mesh"] == {"data": 16, "model": 16} and rec["kv_partition"] == "sequence"
        for key in ("lower_s", "compile_s"):
            assert rec[key] is None and rec["null_reasons"][key]
        assert rec["memory"]["temp_bytes"] is None and rec["null_reasons"]["memory.temp_bytes"]
        assert rec["cost_analysis"]["bytes accessed"] is None
        assert rec["cost_analysis"]["flops"] > 0 and rec["count"]["rows"] == 8
        layers, rows, heads, hd, d, vocab = 16, 8, 32, 64, 2048, 128256
        assert rec["collectives"] == {  # each layer's combine: max, then the sum
            "all_reduce_max@model": layers * int(2 * 15 / 16 * rows * heads * 4),
            "all_reduce@model": layers * int(2 * 15 / 16 * rows * heads * (hd + 1) * 4),
            # and the MLP's row product summed over model (the compute split;
            # sequence mode keeps the attention whole)
            "sum_partials@model": layers * int(2 * 15 / 16 * rows * d * 4),
            # the vocabulary split: the rank's rows of the table looked up and
            # summed (bfloat16), the rank's columns of the logits gathered
            "embed_sum@model": int(2 * 15 / 16 * rows * d * 2),
            "gather_logits@model": 15 * rows * (vocab // 16) * 2}

    def test_prefill_count_near_the_analytic_share(self):
        """FlopCounterMode's count of one rank's llama prefill_32k (its 2 of
        32 rows, chunked attention over the full S_kv) is within 15% of
        the analytic forward's share for those rows."""
        rec = dryrun.lower_cell("llama3.2-1b", "prefill_32k", multi_pod=False)
        shape = get_shape("prefill_32k")
        share = sum(F.fwd_flops_layerwise(get_config("llama3.2-1b"), shape, "prefill")) \
            * rec["count"]["rows"] / shape.global_batch
        assert 0.85 < rec["cost_analysis"]["flops"] / share < 1.15


def test_cli_writes_the_record_without_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape
    decode_32k --single-pod`` with ``jax`` and ``repro`` unimportable; the
    report renders the record."""
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            f"sys.argv = ['dryrun', '--arch', 'llama3.2-1b', '--shape', 'decode_32k', "
            f"'--single-pod', '--out', {str(tmp_path)!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "llama3.2-1b__decode_32k__1pod.json").read_text())
    assert REF_KEYS <= set(rec) and not rec["skipped"]
    text = report.roofline_table(report.load(tmp_path)) + report.dryrun_summary(
        report.load(tmp_path))
    assert "| llama3.2-1b | decode_32k | memory |" in text and "priced OK: 1" in text
