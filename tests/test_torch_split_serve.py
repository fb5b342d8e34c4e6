"""Serving the moe, audio and ssm families on the compute split over
``model`` (``repro_torch.models.pshard``), and the bytes every split step
sends, on gloo ranks.

- Serving on (data 1, model 2) in heads mode, from seed 0: ``seamless-smoke``
  (a prompt of 8 tokens over a source of 2 frames: both residuals split),
  ``qwen3-moe-smoke`` under ``grouped`` (the rank's experts) and
  ``xlstm-smoke`` (the mLSTM by heads, the sLSTM by channels, the
  vocabulary). The greedy tokens of a prefill and four decode steps equal
  the one-rank port's, and each step's logits are within
  ``test_torch_serve_sharded.py``'s ATOL/RTOL of it; the split's working
  copies of the attention weights are the rank's heads.
- The mesh dispatches on the rank's positions (``positions=True``) at the
  smoke config's capacity factor: ``alltoall``'s output is
  ``dispatch_grouped`` of the rank's tokens at their own capacity,
  ``allgather``'s the rank's block of ``dispatch_grouped`` of its data
  row's tokens, each element within one bfloat16 rounding of the largest.
- Bytes on (data 2, model 2): each rank's ``SENT`` by ``op@axis`` equals
  ``analysis.roofline``'s count for the train step of qwen3-moe (each
  dispatch), seamless and xlstm, and for the prefill and a decode step of
  qwen3-moe (``alltoall`` and ``grouped``, heads mode), seamless (heads and
  sequence mode) and xlstm. On those counts: moe training under a mesh
  dispatch sends no ``grad_all_gather@model`` (no bank's experts, no rows'
  slice); no heads-mode decode all-gathers the attention's output; audio's
  heads-mode decode sends no ``gather_cache@model`` (its cross caches are
  the rank's KV heads), its sequence-mode decode gathers them (they are cut
  by source position there); xlstm's decode sends no ``gather_cache@model``
  either (its state is the rank's heads and channels) but its ``wo`` sums.
"""
import traceback
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.comm.moe_dispatch import configure
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig, ShardingConfig, TrainConfig
from repro_torch.launch.mesh import AbstractMesh, spawn

MOE, AUDIO, SSM = "qwen3-moe-235b-a22b", "seamless-m4t-medium", "xlstm-125m"
ATOL, RTOL = 6e-2, 2e-2
#: serving on (data 1, model 2)
ROWS1, PROMPT1, CAP1, GEN = 2, 8, 16, 4
SERVED = {"audio": (AUDIO, None), "moe grouped": (MOE, "grouped"), "ssm": (SSM, None)}
#: bytes on (data 2, model 2)
TRAIN = ShapeConfig("t", 16, 4, "train")
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50)
PROMPT, CAPACITY, ROWS = 24, 64, 4
TRAINED = {"moe alltoall": (MOE, "alltoall"), "moe allgather": (MOE, "allgather"),
           "moe grouped": (MOE, "grouped"), "audio": (AUDIO, None), "ssm": (SSM, None)}
#: name -> (arch, moe dispatch, KV partition)
SERVE_BYTES = {"moe alltoall heads": (MOE, "alltoall", "heads"),
               "moe grouped heads": (MOE, "grouped", "heads"),
               "audio heads": (AUDIO, None, "heads"),
               "audio sequence": (AUDIO, None, "sequence"),
               "ssm": (SSM, None, "auto")}


def _cfg(arch, dispatch=None):
    cfg = get_smoke_config(arch)
    return configure(cfg, dispatch) if dispatch else cfg


def _prompt(cfg, rows: int, prompt: int) -> dict:
    """The seeded prompt batch (with the audio family's frames)."""
    rng = np.random.default_rng(3)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, prompt))).long()}
    if cfg.family == "audio":
        frames = rng.standard_normal((rows, prompt // cfg.encdec.src_ratio,
                                      cfg.frontend.embed_dim))
        out["frames"] = torch.from_numpy(frames).to(torch.bfloat16)
    return out


def _greedy_one_rank(cfg) -> tuple:
    """The one-rank port's greedy tokens and logits of the serve case."""
    from repro_torch.models import registry
    from repro_torch.serving import steps as S_

    model = registry.build(cfg, device="cpu", seed=0)
    cache, logits = model.prefill(**_prompt(cfg, ROWS1, PROMPT1))
    cache = S_.fit_cache(cache, registry.cache_shapes(cfg, ShapeConfig("s", CAP1, ROWS1,
                                                                       "decode")))
    toks, out = [logits.argmax(-1, keepdim=True)], [logits.float().numpy()]
    for _ in range(GEN):
        cache, logits = model.decode_step(cache, toks[-1])
        toks.append(logits.argmax(-1, keepdim=True))
        out.append(logits.float().numpy())
    return torch.cat(toks, 1).numpy(), out


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _greedy(case, mesh) -> dict:
    from repro_torch.models import registry
    from repro_torch.serving import steps as S_

    cfg = _cfg(*SERVED[case])
    model = registry.build(cfg, device="cpu", seed=0, mesh=mesh)
    steps = S_.ServeSteps(model, mesh, ShardingConfig(), ShapeConfig("serve", CAP1, ROWS1,
                                                                     "decode"))
    cache, logits = steps.prefill(_prompt(cfg, ROWS1, PROMPT1))
    toks, out = [logits.argmax(-1, keepdim=True)], [logits.float().numpy()]
    for _ in range(GEN):
        cache, logits = steps.decode(cache, toks[-1])
        toks.append(logits.argmax(-1, keepdim=True))
        out.append(logits.float().numpy())
    wq = next((m.wq.w16 for n, m in model.named_modules() if n.endswith("attn")), None)
    return {"tokens": torch.cat(toks, 1).numpy(), "logits": out, "split": repr(steps.split),
            "mode": steps.mode, "wq": None if wq is None else tuple(wq.shape)}


@torch.no_grad()
def _dispatches(mesh) -> dict:
    """The mesh dispatches on this rank's positions against
    ``dispatch_grouped`` on the same tokens."""
    from repro_torch.comm import collectives
    from repro_torch.models import moe as tmoe
    from repro_torch.models import registry

    cfg = get_smoke_config(MOE)
    p = registry.build(cfg, device="cpu", seed=0).layers[0].moe
    m, r = mesh.shape["model"], mesh.coords["model"]
    xs = torch.randn(m, 2, 8, cfg.d_model, generator=torch.Generator().manual_seed(9))
    x = xs[r].to(torch.bfloat16)
    out = {}
    y, _ = tmoe.dispatch_alltoall(p, x, cfg, mesh, positions=True)
    want, _ = tmoe.dispatch_grouped(p, x.reshape(-1, cfg.d_model), cfg)
    out["alltoall"] = (y.float().numpy(), want.reshape(y.shape).float().numpy())
    y, _ = tmoe.dispatch_allgather(p, x, cfg, mesh, positions=True)
    row = collectives.all_gather(x, mesh, "model").reshape(-1, cfg.d_model)
    want, _ = tmoe.dispatch_grouped(p, row, cfg)
    own = want.reshape(m, *y.shape)[r]
    out["allgather"] = (y.float().numpy(), own.float().numpy())
    return out


def _rank_two() -> dict:
    """(data 1, model 2): the serve cases and the dispatches (spawn target)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    out = {"rank": dist.get_rank()}
    cases = {f"serve {c}": (lambda c=c: _greedy(c, mesh)) for c in SERVED}
    cases["dispatches"] = lambda: _dispatches(mesh)
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = traceback.format_exc()
    return out


def _train_bytes(case, mesh) -> dict:
    from repro_torch.comm import collectives
    from repro_torch.data.synthetic import batches_for
    from repro_torch.train.trainer import HostSpec, ReconfigurableTrainer

    cfg = _cfg(*TRAINED[case])
    tr = ReconfigurableTrainer(cfg, TRAIN, mesh, tcfg=TCFG, transport="xla",
                               hosts=[HostSpec(0, ["xla"])])
    state = tr.init_state(0)
    collectives.SENT.clear()
    tr.step_fn(state, batches_for(cfg, TRAIN)(0))
    return dict(collectives.SENT)


def _serve_bytes(case, mesh) -> dict:
    from repro_torch.comm import collectives
    from repro_torch.serving import steps as S_

    arch, dispatch, kv = SERVE_BYTES[case]
    cfg = _cfg(arch, dispatch)
    sh = ShardingConfig(kv_partition=kv)
    model = S_.build_sharded(cfg, mesh, sh, seed=0)
    steps = S_.ServeSteps(model, mesh, sh, ShapeConfig("serve", CAPACITY, ROWS, "decode"))
    collectives.SENT.clear()
    cache, logits = steps.prefill(_prompt(cfg, ROWS, PROMPT))
    out = {"prefill": dict(collectives.SENT)}
    collectives.SENT.clear()
    steps.decode(cache, logits.argmax(dim=-1, keepdim=True))
    out["decode"] = dict(collectives.SENT)
    return out


def _rank_four() -> dict:
    """(data 2, model 2): every train step's and serve step's bytes (spawn
    target)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"rank": dist.get_rank()}
    cases = {f"train {c}": (lambda c=c: _train_bytes(c, mesh)) for c in TRAINED}
    cases.update({f"serve {c}": (lambda c=c: _serve_bytes(c, mesh)) for c in SERVE_BYTES})
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = traceback.format_exc()
    return out


def _spawned(target: str, world: int) -> list:
    out = spawn(f"test_torch_split_serve:{target}", world, backend="gloo", threads=1,
                timeout_s=600.0)
    for r in out:
        for key, val in r.items():
            assert not isinstance(val, str), f"rank {r['rank']}, {key}:\n{val}"
    return out


@pytest.fixture(scope="module")
def two_ranks():
    return _spawned("_rank_two", 2)


@pytest.fixture(scope="module")
def four_ranks():
    return _spawned("_rank_four", 4)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(SERVED))
def test_split_serve_greedy_tokens_equal_one_rank(two_ranks, case):
    cfg = _cfg(*SERVED[case])
    want_toks, want = _greedy_one_rank(cfg)
    for r in two_ranks:
        rec = r[f"serve {case}"]
        assert "vocab=slice(" in rec["split"]
        if cfg.family == "ssm":  # the mLSTM's heads, the sLSTM's channels
            assert rec["split"].startswith("Split(heads=Heads") and "seq=None" in rec["split"]
            assert "channels=slice(" in rec["split"]
        else:
            assert rec["mode"] == "heads" and rec["split"].startswith("Split(heads=Heads")
            # the working copy of wq: the rank's query heads
            assert rec["wq"] == (cfg.d_model, cfg.num_heads // 2 * cfg.head_dim_)
        np.testing.assert_array_equal(rec["tokens"], want_toks)
        for got, w in zip(rec["logits"], want):
            np.testing.assert_allclose(got, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["alltoall", "allgather"])
def test_mesh_dispatch_on_the_positions_is_grouped_on_its_tokens(two_ranks, impl):
    for r in two_ranks:
        got, want = r["dispatches"][impl]
        assert got.shape == (2, 8, get_smoke_config(MOE).d_model)
        np.testing.assert_allclose(got, want, rtol=0, atol=np.exp2(-7) * np.abs(want).max())


def _predicted(kind: str, case: str, rank: int) -> dict:
    from repro_torch.analysis import roofline

    mesh = AbstractMesh({"data": 2, "model": 2}, rank=rank)
    if kind == "train":
        return {"train": roofline.step_collectives(_cfg(*TRAINED[case]), TRAIN, mesh,
                                                   tcfg=TCFG)}
    arch, dispatch, kv = SERVE_BYTES[case]
    cfg, sh = _cfg(arch, dispatch), ShardingConfig(kv_partition=kv)
    return {"prefill": roofline.step_collectives(cfg, ShapeConfig("p", PROMPT, ROWS, "prefill"),
                                                 mesh, sh=sh),
            "decode": roofline.step_collectives(cfg, ShapeConfig("d", CAPACITY, ROWS, "decode"),
                                                mesh, sh=sh)}


@pytest.mark.parametrize("case", [f"train {c}" for c in TRAINED] +
                         [f"serve {c}" for c in SERVE_BYTES])
def test_sent_equals_the_roofline_count(four_ranks, case):
    kind, name = case.split(" ", 1)
    for r in four_ranks:
        measured = r[case] if kind == "serve" else {"train": r[case]}
        predicted = _predicted(kind, name, r["rank"])
        assert set(measured) == set(predicted)
        for phase, sent in measured.items():
            assert Counter(sent) == predicted[phase], (r["rank"], phase)


def test_what_the_split_steps_do_not_send(four_ranks):
    for r in four_ranks:
        for case in ("moe alltoall", "moe allgather"):
            sent = r[f"train {case}"]
            assert "grad_all_gather@model" not in sent
            assert sent["grad_gather_seq@model"] > 0
        for case in ("moe alltoall heads", "moe grouped heads", "audio heads"):
            decode = r[f"serve {case}"]["decode"]
            assert "all_gather@model" not in decode and decode["sum_partials@model"] > 0
        assert "gather_cache@model" not in r["serve audio heads"]["decode"]
        assert r["serve audio sequence"]["decode"]["gather_cache@model"] > 0
        # the encoder's output gathered once a prefill, over its source
        assert r["serve audio heads"]["prefill"]["gather_seq@model"] > 0
        ssm = r["serve ssm"]
        assert ssm["decode"]["embed_sum@model"] > 0 and "gather_seq@model" not in ssm["prefill"]
        assert "gather_cache@model" not in ssm["decode"] and ssm["decode"]["sum_partials@model"] > 0
        assert ssm["decode"]["gather_channels@model"] > 0
