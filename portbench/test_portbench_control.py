"""The comparison that decides ``correct`` fails where it must, at the
program's smoke configs on the CPU: the control (the reference computed with
fp8 products in the program's place) and each fault a cell can have, planted
under the timed path of a whole run (``run.measure``, the look for a card
skipped). A sound run passes.

The limits here are the smoke size's own, set between its sound readings
(prefill: logits, K/V and SSM errors 0.015-0.022, token gap 0; training:
loss gap 1e-4, gradient-norm gaps 2e-3 to 3e-3, change 7e-4) and its
control's (0.16-0.20; 1.6e-3, 6e-3 to 1.6e-2, 7e-3): a cell's own limits
are set at its full size on the card (``limits/<workload>.json``).
"""
import pytest
import torch

from portbench import compare, spec
from portbench.run import measure
from portbench.smoke import program_cfg
from portbench.weights import Weights

CPU = torch.device("cpu")
SEED = 2_147_483_661
PREFILL_LIMITS = {"numbers": {"logits_err": {"limit": 0.06}, "token_gap": {"limit": 0.05},
                              "kv_err": {"limit": 0.06}}}
HYBRID_LIMITS = {"numbers": dict(PREFILL_LIMITS["numbers"], ssm_err={"limit": 0.06})}
PREFILL = spec.load_module(spec.HERE / "drivers" / "serve_prefill.py", "driver")
TRAIN_LIMITS = {"numbers": {"loss_gap": {"limit": 5e-4}, "grad_norm_gap": {"limit": 5e-3},
                            "grad_gap": {"limit": 8e-3}, "change_gap": {"limit": 3e-3}}}


def _cell(workload, arch, traffic, limits):
    cell = spec.Cell(spec.benchmark(), workload)
    cell.cfg = program_cfg(arch, cell.cfg["name"])
    cell.traffic = dict(cell.traffic, **traffic)
    cell.limits = limits
    return cell


def prefill_cell():
    return _cell("phi3v-prefill-mix", "phi-3-vision-4.2b", {"lengths": [16, 32, 48], "pool": 2},
                 PREFILL_LIMITS)


def train_cell():
    return _cell("phi3v-train-4x1024", "phi-3-vision-4.2b", {"seq": 32, "pool": 4},
                 TRAIN_LIMITS)


def _run(cell, seconds=0.3):
    return measure(cell, SEED, seconds, False, CPU, smoke=True)[0]


def test_a_sound_prefill_run_is_correct():
    result = _run(prefill_cell())
    assert result["correct"], result["check"]
    assert list(result)[-1] == "check" and result["attempted"] > 0
    assert set(result["metrics"]) == {"prefill_tokens_per_s", "ttft_p95_ms", "setup_s"}


def test_a_sound_training_run_is_correct():
    result = _run(train_cell(), seconds=0.5)
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("make", [prefill_cell, train_cell])
def test_the_fp8_control_is_not_correct(make):
    cell = make()
    from types import SimpleNamespace

    ctx = SimpleNamespace(cfg=cell.cfg, traffic=cell.traffic, seed=SEED, device=CPU,
                          hooks=None, reference=cell.reference(), smoke=True)
    session = cell.driver().setup(ctx)
    session.window(0.2)
    session.release()
    assert compare.judge(session.readings(), cell.limits)[0]
    correct, table, _ = compare.judge(session.readings("fp8"), cell.limits)
    assert not correct, table


def _altered_token(prefill):
    def broken(self, tokens, *a, **k):
        cache, logits = prefill(self, tokens, *a, **k)
        logits = logits.clone()
        top = logits.argmax(-1)
        other = (top + 1) % self.cfg.vocab_size
        logits[torch.arange(len(top)), other] = logits.max() + 1
        return cache, logits
    return broken


def _map_cache(cache: dict, fn) -> dict:
    """``fn(tensor, batch_axis)`` over a cache's tensors: the hybrid
    family's per-layer dicts (batch first) or K/V stacked over layers."""
    if "layers" in cache:
        return dict(cache, layers=[{n: fn(t, 0) for n, t in c.items()}
                                   for c in cache["layers"]])
    return dict(cache, k=fn(cache["k"], 1), v=fn(cache["v"], 1))


def _state_unchanged(prefill):
    def broken(self, tokens, *a, **k):
        cache, logits = prefill(self, tokens, *a, **k)
        return _map_cache(cache, lambda t, _: torch.zeros_like(t)), logits
    return broken


def _half_batch(prefill):
    def broken(self, tokens, *a, **k):
        half = tokens.shape[0] // 2
        a = tuple(x[:half] if torch.is_tensor(x) else x for x in a)
        k = {n: x[:half] if torch.is_tensor(x) else x for n, x in k.items()}
        cache, logits = prefill(self, tokens[:half], *a, **k)
        return (_map_cache(cache, lambda t, axis: torch.cat([t, t], axis)),
                torch.cat([logits, logits], 0))
    return broken


FAULTS = [_altered_token, _state_unchanged, _half_batch]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_prefill_fault_is_not_correct(fault, monkeypatch):
    from repro_torch.models.transformer import VlmLM

    monkeypatch.setattr(VlmLM, "prefill", fault(VlmLM.prefill))
    result = _run(prefill_cell())
    assert not result["correct"], result["check"]


def hybrid_cell():
    """The hybrid family under the prefill mix at its smoke config: the
    driver's SSM state comparison, kept for a hybrid cell (PERF.md, Open
    questions)."""
    return _cell("phi3v-prefill-mix", "hymba-1.5b", {"lengths": [16, 32, 48], "pool": 2},
                 HYBRID_LIMITS)


def test_a_sound_hybrid_prefill_run_is_correct():
    result = _run(hybrid_cell())
    assert result["correct"], result["check"]
    assert set(result["check"]) == {"logits_err", "token_gap", "kv_err", "ssm_err"}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_hybrid_prefill_fault_is_not_correct(fault, monkeypatch):
    from repro_torch.models.hymba import HymbaLM

    monkeypatch.setattr(HymbaLM, "prefill", fault(HymbaLM.prefill))
    result = _run(hybrid_cell())
    assert not result["correct"], result["check"]


def test_a_training_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(grads, state, params, lr, cfg, shards=None):
        norm = adamw.global_norm({k: g.float() for k, g in grads.items()})
        return params, adamw.AdamWState(state.m, state.v, state.count + 1), {"grad_norm": norm}

    monkeypatch.setattr(adamw, "update", unchanged)
    result = _run(train_cell(), seconds=0.3)
    assert not result["correct"], result["check"]
    assert result["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_training_step_on_half_the_batch_is_not_correct(monkeypatch):
    from repro_torch.models import registry

    loss = registry.loss
    monkeypatch.setattr(registry, "loss", lambda model, batch, **k: loss(
        model, {n: t[: t.shape[0] // 2] for n, t in batch.items()}, **k))
    result = _run(train_cell(), seconds=0.3)
    assert not result["correct"], result["check"]


def _meta_case(S=40):
    """The hybrid smoke config with 4 meta tokens and layers 1, 2 (window
    layers, W 8) sharing K/V; its weights, prompts of S tokens and the
    reference's prefill of them."""
    from portbench.reference import hybrid

    cfg = {**{k: v for k, v in program_cfg("hymba-1.5b").items()
              if k not in ("meta_tokens", "kv_groups")}, "meta_tokens": 4, "kv_groups": [[1, 2]]}
    w = Weights(hybrid.param_specs(cfg), SEED, CPU).make()
    tokens = torch.randint(0, cfg["vocab_size"], (2, S), generator=torch.Generator().manual_seed(9))
    return cfg, w, tokens, hybrid.prefill(w, cfg, tokens)


def test_the_reference_in_the_programs_layout_reads_0():
    cfg, _, tokens, want = _meta_case()
    logits, tok, cache = PREFILL.as_program(cfg, want, tokens.shape[1])
    zero = {"logits_err": 0.0, "token_gap": 0.0, "kv_err": 0.0, "ssm_err": 0.0}
    assert "k" not in cache["layers"][2]
    assert PREFILL.compare_prefill(cfg, (logits, tok, cache), want) == zero
    owner = cache["layers"][1]  # the consumer may hold its owner's very tensors
    cache["layers"][2] = dict(cache["layers"][2], k=owner["k"], v=owner["v"])
    assert PREFILL.compare_prefill(cfg, (logits, tok, cache), want) == zero


def _meta_dropped(cfg, w, tokens, want):
    from portbench.reference import hybrid

    bare = dict(cfg, meta_tokens=0)
    return PREFILL.as_program(bare, hybrid.prefill(w, bare, tokens), tokens.shape[1])


def _consumer_recomputes(cfg, w, tokens, want):
    """Layer 2 projects its own normed input with its owner's wk and wv."""
    from portbench.reference import hybrid

    alone = dict(cfg, kv_groups=[])
    w = dict(w, **{f"layers.2.attn.{n}.w": w[f"layers.1.attn.{n}.w"] for n in ("wk", "wv")})
    return PREFILL.as_program(alone, hybrid.prefill(w, alone, tokens), tokens.shape[1])


def _consumer_holds_a_copy(cfg, w, tokens, want):
    logits, tok, cache = PREFILL.as_program(cfg, want, tokens.shape[1])
    owner = cache["layers"][1]
    cache["layers"][2] = dict(cache["layers"][2], k=owner["k"].clone(), v=owner["v"].clone())
    return logits, tok, cache


def _ring_over_sequence_positions(cfg, w, tokens, want):
    """The window layers' ring laid out by sequence position p = M + t."""
    M, S, W = cfg["meta_tokens"], tokens.shape[1], cfg["sliding_window"]
    logits, tok, cache = PREFILL.as_program(cfg, want, S)
    for i, c in enumerate(want["layers"]):
        if "k" in c and i not in cfg["global_layers"]:
            cache["layers"][i] = dict(cache["layers"][i], **{n: torch.cat(
                [c[n][:, :M], PREFILL.ring(c[n], M + S, min(W, S))], dim=1) for n in ("k", "v")})
    return logits, tok, cache


def _nan_in_a_later_row(cfg, w, tokens, want):
    logits, tok, cache = PREFILL.as_program(cfg, want, tokens.shape[1])
    logits = logits.clone()
    logits[1, 0] = float("nan")
    return logits, tok, cache


@pytest.mark.parametrize("fault", [_meta_dropped, _consumer_recomputes, _consumer_holds_a_copy,
                                   _ring_over_sequence_positions, _nan_in_a_later_row])
def test_the_prefill_comparison_fails_a_meta_token_or_kv_group_fault(fault):
    cfg, w, tokens, want = _meta_case()
    readings = PREFILL.compare_prefill(cfg, fault(cfg, w, tokens, want), want)
    correct, table, _ = compare.judge(readings, HYBRID_LIMITS)
    assert not correct, table
