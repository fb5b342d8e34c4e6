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
#: hymba-1.5b's widths without meta tokens or K/V groups, whatever the
#: program's configuration holds
HYMBA = {k: v for k, v in program_cfg("hymba-1.5b", "hymba-1.5b", smoke=False).items()
         if k not in ("meta_tokens", "kv_groups")}
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

    pc = get_config(cfg["arch"])  # as HYMBA: no meta tokens, no K/V groups
    pc = pc.replace(**{k: v for k, v in (("meta_tokens", 0), ("kv_groups", ()))
                       if hasattr(pc, k)})
    layers, head = fwd_flops_layerwise(pc, ShapeConfig("x", S, B, kind), kind)
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


@pytest.mark.parametrize("S,window,prefix", itertools.product(
    [1, 7, 64, 100], [None, 1, 8, 64, 200], [0, 1, 5, 40, 128]))
def test_attention_pairs_with_a_prefix_count_what_the_mask_leaves(S, window, prefix):
    q = torch.arange(S)[:, None]
    k = torch.arange(S)[None, :]
    ok = k <= q
    if window is not None:
        ok &= (q - k < window) | (k < prefix)
    assert kernels.attention_pairs(S, S, True, window, prefix) == int(ok.sum())
    if prefix:
        with pytest.raises(ValueError):
            kernels.attention_pairs(S, S, False, None, prefix)


#: ``fwd_flops`` as it read before meta tokens and K/V groups were counted
FLOPS_WITHOUT_META = [
    (PHI3V, "prefill", 4, 1024, 30513040982016.0), (PHI3V, "prefill", 4, 2048, 62674561400832.0),
    (PHI3V, "prefill", 4, 4096, 131945404563456.0), (PHI3V, "train", 4, 1024, 31319169957888.0),
    (HYMBA, "prefill", 4, 1024, 13238891328000.0), (HYMBA, "prefill", 4, 2048, 26946754982400.0),
    (HYMBA, "prefill", 4, 4096, 54604074201600.0), (HYMBA, "train", 8, 128, 3320528896000.0)]


@pytest.mark.parametrize("cfg,kind,B,S,flops", FLOPS_WITHOUT_META,
                         ids=[f"{c['arch']}-{k}-{B}x{S}" for c, k, B, S, _ in FLOPS_WITHOUT_META])
def test_fwd_flops_without_meta_tokens_or_groups_are_as_before(cfg, kind, B, S, flops):
    assert fwd_flops(cfg, B, S, kind) == flops
    assert fwd_flops(dict(cfg, meta_tokens=0, kv_groups=[]), B, S, kind) == flops


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_fwd_flops_with_meta_tokens_and_groups_is_the_hand_sum(kind):
    """hymba-1.5b's widths, 128 meta tokens, layers (1, 2) and (3, 4) sharing
    K/V: every layer over M + S positions, K/V projected in 30 layers."""
    B, S, M = 4, 4096, 128
    cfg = dict(HYMBA, meta_tokens=M, kv_groups=[[1, 2], [3, 4]])
    D, H, KH, hd, F, V = 1600, 25, 5, 64, 5504, 32001
    d_in, r, N, K = 3200, 100, 16, 4
    T = B * (M + S)
    q_o = 2 * T * D * H * hd * 2  # wq and wo, every layer
    kv = 2 * T * D * 2 * KH * hd  # wk and wv, in the 30 layers that own them
    n = M + S  # window layers: min(p + 1, 1024) keys, and the meta keys left of that
    window_pairs = sum(min(p + 1, 1024) + max(0, min(M, p - 1023)) for p in range(n))
    global_pairs = n * (n + 1) // 2
    scores = 4 * B * H * hd * (29 * window_pairs + 3 * global_pairs)
    mlp = 32 * 6 * T * D * F
    ssm = 32 * (2 * T * D * 2 * d_in + 2 * T * d_in * (r + 2 * N) + 2 * T * r * d_in
                + 2 * T * d_in * D + 2 * T * K * d_in + 7 * T * d_in * N + 2 * T * d_in)
    head = 2 * B * D * V if kind == "prefill" else 2 * B * S * D * V
    want = 32 * q_o + 30 * kv + scores + mlp + ssm + head
    assert fwd_flops(cfg, B, S, kind) == pytest.approx(want, rel=1e-12)
