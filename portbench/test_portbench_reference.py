"""The plain references against the program at its smoke configs, on the CPU:
same weights (``weights.Weights``), same inputs; the program computes its
products in bfloat16, so the tolerances are bfloat16's over a few layers, far
under what a wrong equation gives."""
import pytest
import torch

from portbench import compare, spec
from portbench.reference import adamw as ref_adamw
from portbench.reference import common, hybrid, vlm
from portbench.smoke import program_cfg
from portbench.weights import Weights

SEED = 3_000_000_019
PREFILL = spec.load_module(spec.HERE / "drivers" / "serve_prefill.py", "driver")


def _port(arch, cfg, **replace):
    from portbench import port
    from repro_torch.models import registry

    pc = port.model_config(cfg, smoke=True, **replace)
    model = registry.model_class(pc)(pc, device=torch.device("cpu"))
    Weights(REFS[cfg["family"]].param_specs(cfg), SEED, "cpu").fill(
        dict(model.named_parameters()))
    return model


REFS = {"hybrid": hybrid, "vlm": vlm}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "phi-3-vision-4.2b"])
def test_param_specs_are_the_programs_parameters_at_full_size(arch):
    from portbench import port, spec
    from repro_torch.models import registry

    if arch == "phi-3-vision-4.2b":  # the cells' configuration file
        cfg = dict(spec.load_json(spec.HERE / "configs" / f"{arch}.json"), name=arch)
    else:  # the hybrid reference, kept for a hybrid cell (PERF.md, Open questions)
        cfg = program_cfg(arch, arch, smoke=False)
    pc = port.model_config(cfg)
    model = registry.model_class(pc)(pc, device=torch.device("meta"))
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(s) for n, s, _ in REFS[cfg["family"]].param_specs(cfg)} == want


def test_hybrid_prefill_matches_the_program():
    """Through the driver's comparison, which lays the reference out as the
    program's cache, meta tokens and K/V groups included where the program's
    smoke config has them."""
    cfg = program_cfg("hymba-1.5b")
    model = _port("hymba-1.5b", cfg, attn_impl="pallas").prepare()
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 24), generator=g)
    cache, logits = model.prefill(tokens)
    w = Weights(hybrid.param_specs(cfg), SEED, "cpu").make()
    ref = hybrid.prefill(w, cfg, tokens)
    got = PREFILL.compare_prefill(cfg, (logits, logits.argmax(-1), cache), ref)
    for name in ("logits_err", "kv_err", "ssm_err"):
        assert got[name] < 0.05, got


#: the hybrid smoke config with meta tokens and a K/V group (layers 1, 2 are
#: window layers; 0 and 3 global)
META, GROUPS = 4, [[1, 2]]


def _meta_cfg(**over) -> dict:
    base = {k: v for k, v in program_cfg("hymba-1.5b").items()
            if k not in ("meta_tokens", "kv_groups")}
    return {**base, "meta_tokens": META, "kv_groups": GROUPS, **over}


def _tokens(cfg, B=2, S=40, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg["vocab_size"], (B, S), generator=g)


@pytest.mark.parametrize("S,W,P", [(40, 8, 4), (40, 8, 0), (40, None, 4), (9, 16, 3),
                                   (33, 5, 12), (20, 20, 2), (64, 7, 70), (1, 3, 1)])
def test_attention_with_a_prefix_is_a_dense_softmax_under_the_mask(S, W, P):
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, S, h, 8, generator=g, dtype=torch.float64) for h in (4, 2, 2))
    qp, kp = torch.arange(S)[:, None], torch.arange(S)[None, :]
    ok = kp <= qp
    if W is not None:
        ok &= (qp - kp < W) | (kp < P)
    kk, vv = (t.repeat_interleave(2, dim=2).transpose(1, 2) for t in (k, v))
    s = (q.transpose(1, 2) @ kk.transpose(-1, -2)) / 8 ** 0.5
    want = (torch.softmax(s.masked_fill(~ok, float("-inf")), -1) @ vv).transpose(1, 2)
    got = common.attention(q, k, v, window=W, prefix=P, block=8)
    torch.testing.assert_close(got, want.float(), rtol=1e-5, atol=1e-6)


def test_no_meta_tokens_and_no_groups_are_the_keys_left_out():
    cfg = _meta_cfg(meta_tokens=0, kv_groups=[])
    bare = {k: v for k, v in cfg.items() if k not in ("meta_tokens", "kv_groups")}
    assert hybrid.param_specs(cfg) == hybrid.param_specs(bare)
    w = Weights(hybrid.param_specs(bare), SEED, "cpu").make()
    tokens = _tokens(cfg)
    a, b = hybrid.prefill(w, cfg, tokens), hybrid.prefill(w, bare, tokens)
    assert torch.equal(a["logits"], b["logits"])
    for x, y in zip(a["layers"], b["layers"]):
        assert x.keys() == y.keys() == {"k", "v", "ssm_h", "ssm_conv"}
        assert all(torch.equal(x[n], y[n]) for n in x)


def test_meta_tokens_draw_last_and_leave_every_other_leaf_as_it_was():
    cfg = _meta_cfg(kv_groups=[])
    without = Weights(hybrid.param_specs(dict(cfg, meta_tokens=0)), SEED, "cpu").make()
    with_meta = Weights(hybrid.param_specs(cfg), SEED, "cpu").make()
    assert list(with_meta)[-1] == "meta_tokens" and set(with_meta) - set(without) == {
        "meta_tokens"}
    assert with_meta["meta_tokens"].shape == (META, cfg["d_model"])
    assert all(torch.equal(with_meta[n], t) for n, t in without.items())


def test_a_groups_later_layers_have_no_kv_projection_and_no_cache():
    cfg = _meta_cfg()
    names = {n for n, _, _ in hybrid.param_specs(cfg)}
    for i in range(cfg["num_layers"]):
        assert (f"layers.{i}.attn.wk.w" in names) == (i != 2)
        assert (f"layers.{i}.attn.wv.w" in names) == (i != 2)
    out = hybrid.prefill(Weights(hybrid.param_specs(cfg), SEED, "cpu").make(), cfg,
                         _tokens(cfg))
    assert [set(c) for c in out["layers"]] == [
        {"k", "v", "ssm_h", "ssm_conv"}, {"k", "v", "ssm_h", "ssm_conv"},
        {"ssm_h", "ssm_conv"}, {"k", "v", "ssm_h", "ssm_conv"}]
    assert out["layers"][0]["k"].shape[1] == META + 40


def test_the_meta_positions_kv_precede_the_prompt():
    """The same for every row and for other prompts of another length."""
    cfg = _meta_cfg()
    w = Weights(hybrid.param_specs(cfg), SEED, "cpu").make()
    a = hybrid.prefill(w, cfg, _tokens(cfg, B=3, S=40, seed=7))
    b = hybrid.prefill(w, cfg, _tokens(cfg, B=1, S=17, seed=8))
    for x, y in zip(a["layers"], b["layers"]):
        for n in set(x) & {"k", "v"}:
            meta = x[n][:, :META]
            torch.testing.assert_close(meta, meta[:1].expand_as(meta), rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(y[n][:, :META], meta[:1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("prefix_seen", [True, False])
def test_meta_tokens_are_seen_beyond_the_window(prefix_seen, monkeypatch):
    """With S > W + M, every layer a window layer and the SSM branch's output
    zeroed, only the window layers' prefix carries the meta tokens to the
    last position (4 layers reach 4 (W - 1) = 28 < 40 positions back):
    changing them changes its logits, and does not where the prefix is
    taken away."""
    cfg = _meta_cfg(global_layers=[])
    ssm_branch = hybrid.ssm_branch

    def quiet_ssm(*a):
        s, h, tail = ssm_branch(*a)
        return torch.zeros_like(s), h, tail

    monkeypatch.setattr(hybrid, "ssm_branch", quiet_ssm)
    if not prefix_seen:
        attention = hybrid.attention
        monkeypatch.setattr(hybrid, "attention", lambda *a, prefix, **k: attention(*a, **k))
    w = Weights(hybrid.param_specs(cfg), SEED, "cpu").make()
    tokens = _tokens(cfg)
    a = hybrid.prefill(w, cfg, tokens)["logits"]
    w["meta_tokens"] = w["meta_tokens"].flip(0) * 3
    b = hybrid.prefill(w, cfg, tokens)["logits"]
    assert (compare.rel_err(b, a) > 1e-3) == prefix_seen


@pytest.mark.parametrize("groups,message", [
    ([[1, 2], [2]], "overlaps"), ([[1, 1]], "overlaps"), ([[2, 1]], "before its owner"),
    ([[0, 1]], "mixes window and global"), ([[1, 4]], "outside")])
def test_kv_groups_that_cannot_be_are_refused(groups, message):
    cfg = _meta_cfg(kv_groups=groups)
    with pytest.raises(ValueError, match=message):
        hybrid.param_specs(cfg)


def test_kv_owners_name_each_groups_first_layer():
    cfg = _meta_cfg(num_layers=8, global_layers=[0, 7], kv_groups=[[1, 2, 3], [5, 6]])
    assert common.kv_owners(cfg) == [0, 1, 1, 1, 4, 5, 5, 7]


def test_chunked_scan_equals_the_one_step_recurrence():
    g = torch.Generator().manual_seed(0)
    S, d, N = 150, 6, 4
    dt = torch.rand(S, d, generator=g, dtype=torch.float64) * 0.2
    x, Bm, Cm = (torch.randn(S, k, generator=g, dtype=torch.float64) for k in (d, N, N))
    A = -torch.rand(d, N, generator=g, dtype=torch.float64) * 4
    D, h0 = torch.randn(d, generator=g, dtype=torch.float64), torch.randn(d, N, generator=g,
                                                                           dtype=torch.float64)
    y, h = hybrid.selective_scan(dt, x, Bm, Cm, A, D, h0.clone(), chunk=16)
    hh, ys = h0, []
    for t in range(S):
        hh = torch.exp(dt[t, :, None] * A) * hh + (dt[t] * x[t])[:, None] * Bm[t]
        ys.append((hh * Cm[t]).sum(-1) + D * x[t])
    torch.testing.assert_close(y, torch.stack(ys), rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(h, hh, rtol=1e-10, atol=1e-10)


def _vlm_batch(cfg, B=2, S=16):
    g = torch.Generator().manual_seed(2)
    seq = torch.randint(0, cfg["vocab_size"], (B, S + 1), generator=g)
    patches = torch.randn(B, cfg["patch_positions"], cfg["patch_dim"],
                          generator=g).to(torch.bfloat16).float()
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:], "patches": patches}


def test_vlm_loss_and_gradients_match_the_program():
    cfg = program_cfg("phi-3-vision-4.2b")
    model = _port("phi-3-vision-4.2b", cfg).release()
    batch = _vlm_batch(cfg)
    loss = model.loss(batch)
    loss.backward()
    loss = loss.detach()
    w = Weights(vlm.param_specs(cfg), SEED, "cpu").make()
    for p in w.values():
        p.requires_grad_(True)
    ref = vlm.loss(w, cfg, batch)
    ref.backward()
    ref = ref.detach()
    assert float(loss) == pytest.approx(float(ref), rel=1e-3)
    got = {n: float(p.grad.norm()) for n, p in model.named_parameters()}
    want = {n: float(p.grad.norm()) for n, p in w.items()}
    assert compare.norm_gap(got, want) < 0.02


def test_vlm_prefill_matches_the_program():
    cfg = program_cfg("phi-3-vision-4.2b")
    model = _port("phi-3-vision-4.2b", cfg, attn_impl="pallas").prepare()
    batch = _vlm_batch(cfg)
    cache, logits = model.prefill(batch["tokens"], batch["patches"].to(torch.bfloat16))
    ref = vlm.prefill(Weights(vlm.param_specs(cfg), SEED, "cpu").make(), cfg, batch["tokens"],
                      batch["patches"])
    V = cfg["vocab_size"]
    assert compare.rel_err(logits[:, :V].float(), ref["logits"][:, :V]) < 0.05
    for i, layer in enumerate(ref["layers"]):
        assert compare.rel_err(cache["k"][i], layer["k"]) < 0.05


def test_adamw_matches_the_programs_update():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw

    g = torch.Generator().manual_seed(3)
    opt = {"learning_rate": 3e-4, "weight_decay": 0.1, "beta1": 0.9, "beta2": 0.95,
           "eps": 1e-8, "grad_clip": 1.0, "warmup_steps": 10, "total_steps": 100,
           "moment_dtype": "bfloat16"}
    tcfg = TrainConfig(opt_dtype="bfloat16", **{k: v for k, v in opt.items()
                                                if k != "moment_dtype"})
    p = {"a": torch.randn(64, 8, generator=g), "b": torch.randn(8, generator=g)}
    mine = {k: v.clone() for k, v in p.items()}
    zeros = lambda: {k: torch.zeros(v.shape, dtype=torch.bfloat16)  # noqa: E731
                     for k, v in p.items()}
    state, moments, lr = adamw.AdamWState(zeros(), zeros(), 0), {}, adamw.lr_schedule(tcfg)
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in p.items()}
        _, state, metrics = adamw.update({k: v.clone() for k, v in grads.items()}, state, mine,
                                         lr(step), tcfg)
        norm = ref_adamw.step(p, grads, moments, opt, step + 1)
        assert float(norm) == pytest.approx(float(metrics["grad_norm"]), rel=1e-6)
        assert ref_adamw.learning_rate(opt, step) == pytest.approx(lr(step), rel=1e-6)
        for k in p:
            torch.testing.assert_close(mine[k], p[k], rtol=1e-6, atol=1e-7)


def test_fp8_products_round_both_operands():
    g = torch.Generator().manual_seed(4)
    a, b = torch.randn(8, 16, generator=g), torch.randn(16, 4, generator=g)
    exact = common.mm(a, b)
    low = common.mm(a, b, "fp8")
    assert 1e-3 < compare.rel_err(low, exact) < 0.2
    a.requires_grad_(True)
    common.mm(a, b, "fp8").sum().backward()
    assert compare.rel_err(a.grad, torch.ones(8, 4) @ b.T) < 0.2
    with pytest.raises(ValueError):
        common.mm(a, b, "fp4")


@pytest.mark.cuda
def test_hybrid_prefill_takes_hymbas_prefill_mix_on_the_card(capsys):
    """hymba-1.5b as released (128 meta tokens, its K/V groups) through the
    reference at its published widths, one batch of each length of the
    prefill mix, 4 x 4096 the longest: what a hybrid cell's check costs. Its
    seconds and peak memory are printed; it has to fit on the card the model
    was freed from."""
    import json
    import time

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.test_portbench_spec import _hymba_file

    cfg, dev = _hymba_file(), torch.device("cuda", 0)
    common.no_tf32()
    w = Weights(hybrid.param_specs(cfg), SEED, dev).make()
    torch.cuda.reset_peak_memory_stats(dev)  # the peak from here counts the weights
    seconds = {}
    for S in (1024, 2048, 4096):
        tokens = torch.randint(0, cfg["vocab_size"], (4, S), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(S))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = hybrid.prefill(w, cfg, tokens)
        torch.cuda.synchronize(dev)
        seconds[S] = time.perf_counter() - t0
        assert torch.isfinite(out["logits"][:, :cfg["vocab_size"]]).all()
        assert out["layers"][0]["k"].shape[1] == 128 + S and "k" not in out["layers"][2]
        del out
    peak = torch.cuda.max_memory_allocated(dev)
    with capsys.disabled():
        print(json.dumps({"hybrid_prefill_s": seconds, "peak_bytes": peak,
                          "card": torch.cuda.get_device_name(dev)}))
    assert peak < 40 * 2**30
