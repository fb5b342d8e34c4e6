"""The plain references against the program at its smoke configs, on the CPU:
same weights (``weights.Weights``), same inputs; the program computes its
products in bfloat16, so the tolerances are bfloat16's over a few layers, far
under what a wrong equation gives."""
import pytest
import torch

from portbench import compare
from portbench.reference import adamw as ref_adamw
from portbench.reference import common, hybrid, vlm
from portbench.smoke import program_cfg
from portbench.weights import Weights

SEED = 3_000_000_019


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
    cfg = program_cfg("hymba-1.5b")
    model = _port("hymba-1.5b", cfg, attn_impl="pallas").prepare()
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 24), generator=g)
    cache, logits = model.prefill(tokens)
    w = Weights(hybrid.param_specs(cfg), SEED, "cpu").make()
    ref = hybrid.prefill(w, cfg, tokens)
    V = cfg["vocab_size"]
    assert compare.rel_err(logits[:, :V].float(), ref["logits"][:, :V]) < 0.05
    W = cfg["sliding_window"]
    for i, (mine, want) in enumerate(zip(cache["layers"], ref["layers"])):
        k, v = want["k"], want["v"]
        if i not in cfg["global_layers"]:  # the ring: the last W positions, p % W at slot j
            k, v = (torch.roll(t[:, -W:], (24 - W) % W, dims=1) for t in (k, v))
        for got, exp in ((mine["k"], k), (mine["v"], v), (mine["ssm_h"], want["ssm_h"]),
                         (mine["ssm_conv"], want["ssm_conv"])):
            assert compare.rel_err(got, exp) < 0.05, i


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
