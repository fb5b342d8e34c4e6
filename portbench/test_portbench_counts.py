"""The frozen counts against the program's analysis and PERF.md's kernel
bounds, at the cells' shapes and at the hybrid family's (CPU, no card)."""
import itertools

import pytest
import torch

from portbench import spec
from portbench.counts import kernels
from portbench.counts.flops import fwd_flops, layer_windows
from portbench.smoke import program_cfg

PHI3V = spec.load_json(spec.HERE / "configs" / "phi-3-vision-4.2b.json")
HYMBA = program_cfg("hymba-1.5b", "hymba-1.5b", smoke=False)
SHAPES = [(PHI3V, "prefill", 4, S) for S in (1024, 2048, 4096)] + [
    (PHI3V, "train", 4, 1024), (HYMBA, "prefill", 4, 4096), (HYMBA, "train", 8, 128)]


@pytest.mark.parametrize("cfg,kind,B,S", SHAPES,
                         ids=[f"{c['arch']}-{k}-{B}x{S}" for c, k, B, S in SHAPES])
def test_frozen_flops_are_the_programs_analysis_over_the_unmasked_pairs(cfg, kind, B, S):
    """The program's count with its attention scores over the full S_kv
    replaced by the pairs the masks leave, and its scan by the kernel's
    count: the two differences and nothing else."""
    from repro_torch.analysis.flops import fwd_flops_layerwise
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig

    layers, head = fwd_flops_layerwise(get_config(cfg["arch"]), ShapeConfig("x", S, B, kind),
                                       kind)
    H, hd, L = cfg["num_heads"], cfg["head_dim"], cfg["num_layers"]
    full = L * 4 * B * S * S * H * hd
    masked = sum(4 * B * H * hd * kernels.attention_pairs(S, S, True, w)
                 for w in layer_windows(cfg))
    scan = 0
    if cfg["family"] == "hybrid":
        s = cfg["ssm"]
        d_in = s["expand"] * cfg["d_model"]
        scan = L * (12 * B * S * d_in * s["state_dim"] - kernels.selective_scan(
            B, S, d_in, s["state_dim"], cfg["dtypes"])[0])
    assert fwd_flops(cfg, B, S, kind) == layers + head - full + masked - scan
    assert masked < full


def test_layer_windows_follow_the_global_layers():
    w = layer_windows(HYMBA)
    assert [i for i, x in enumerate(w) if x is None] == [0, 15, 31]
    assert set(w) - {None} == {1024}
    assert layer_windows(PHI3V) == [None] * 32


def test_selective_scan_bytes_are_perfs_bound_at_the_declared_dtypes():
    # PERF.md §6, B4 at hymba's prefill: 264,524,288 bytes, bytes-bound
    ops, nbytes, dtype = kernels.selective_scan(4, 2048, 3200, 16, HYMBA["dtypes"])
    assert nbytes == 264_524_288 and dtype == "float32"
    assert kernels.least_seconds(ops, nbytes, dtype) == nbytes / 3.35e12


@pytest.mark.parametrize("q,kv,window,ms", [
    ((4, 2048, 25, 64), (4, 2048, 5, 64), 1024, 0.0407),  # hymba's window layers
    ((4, 2048, 32, 96), (4, 2048, 32, 96), None, 0.1043)])  # phi-3-vision, MHA, causal
def test_flash_attention_bound_is_perfs(q, kv, window, ms):
    # PERF.md §6's B3 bounds, operations-bound
    args = (q, kv, True, window, {"compute": "bfloat16"})
    assert kernels.least_seconds(*kernels.flash_attention(*args)) == pytest.approx(ms * 1e-3,
                                                                                 rel=1e-3)


@pytest.mark.parametrize("S,window", itertools.product([1, 7, 64, 100], [None, 1, 8, 64, 200]))
def test_attention_pairs_count_what_the_masks_leave(S, window):
    q = torch.arange(S)[:, None]
    k = torch.arange(S)[None, :]
    ok = k <= q
    if window is not None:
        ok &= q - k < window
    assert kernels.attention_pairs(S, S, True, window) == int(ok.sum())
    assert kernels.attention_pairs(S, 3, False, None) == 3 * S
