"""The MoE expert-parallel dispatches on four gloo ranks, held to the
reference's on a four-device CPU mesh.

On (data 2, model 2), ``qwen3-moe-smoke``'s MoE layer (8 experts, top 2, its
capacity factor of 1.25: each rank's 16 tokens get 5 slots an expert, so
tokens are dropped, as in the reference) from the reference's
``moe_mlp_init(PRNGKey(0))``, a batch of 4 rows of 16 positions:

- ``dispatch_alltoall`` and ``dispatch_allgather`` (``moe_ffn`` with the
  dispatch configured), each rank given its 2 rows, with the banks whole on
  every rank and laid out as ``serving.steps.lay_out`` leaves them (the
  float32 parameters the rank's ``Layout`` blocks, experts over ``model``
  and d_model over ``data``, beside whole bfloat16 serving banks): y of the
  rank's rows and aux against the reference's ``moe_ffn`` on the same
  global batch, y within 2e-2 (bfloat16 expert products, as
  ``test_torch_moe.py``), aux within 1e-6; the two bank layouts equal bit
  for bit; all-to-all bytes only under ``alltoall``, and no parameter
  gathered (the rank's experts are slices of its serving banks);
- the Select's conditions: decode (one position a row) resolves both to
  ``grouped`` over the global batch's tokens, and so does a batch of 3 rows
  (which the two data ranks cannot split), each against the reference's
  ``moe_ffn`` on the mesh, which resolves the same way.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import dataclasses
import traceback

import numpy as np
import pytest
import torch

from repro_torch.comm.moe_dispatch import configure
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import spawn
from repro_torch.models import moe as tmoe

ARCH = "qwen3-moe-235b-a22b"
DISPATCHES = ("alltoall", "allgather")
LAYOUTS = ("full", "blocks")
B, S = 4, 16
#: name -> (rows, positions, rows dealt over data)
CASES = {"prefill": (B, S, True), "decode": (B, 1, True), "odd_batch": (3, S, False)}


def x_np(rows, positions):
    d = get_smoke_config(ARCH).d_model
    return np.random.default_rng(rows * 100 + positions).standard_normal(
        (rows, positions, d)).astype(np.float32)


def _moe_mlp(params, cfg, mesh, layout):
    from repro_torch.models.sharding import NamedSharding, P

    m = tmoe.MoeMLP(cfg).requires_grad_(False)
    with torch.no_grad():
        m.router.w.copy_(torch.from_numpy(np.array(params["router"]["w"])))
        for name in ("gate", "up", "down"):
            getattr(m, name).copy_(torch.from_numpy(np.array(params[name])))
    m.prepare()
    if layout == "blocks":  # as lay_out leaves it: float32 blocks, whole serving banks
        specs = {"gate": P("model", "data", None), "up": P("model", "data", None),
                 "down": P("model", None, "data")}
        for n, spec in specs.items():
            getattr(m, n).data = NamedSharding(mesh, spec).local(getattr(m, n).data).clone()
    return m


def _rank_cases(params) -> dict:
    from repro_torch.comm import collectives
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    d = mesh.coords["data"]
    out = {"coords": dict(mesh.coords)}
    for impl in DISPATCHES:
        cfg = configure(get_smoke_config(ARCH), impl)
        for layout in LAYOUTS:
            try:
                m = _moe_mlp(params, cfg, mesh, layout)
                for case, (rows, positions, dealt) in CASES.items():
                    x = torch.from_numpy(x_np(rows, positions)).to(torch.bfloat16)
                    if dealt:
                        x = x[2 * d:2 * d + 2]
                    sent0 = dict(collectives.SENT)
                    y, aux = tmoe.moe_ffn(m, x, cfg, mesh, batch_split=2 if dealt else 1)
                    sent = {k for k, v in collectives.SENT.items() if v > sent0.get(k, 0)}
                    out[(impl, layout, case)] = (y.float().numpy(), float(aux), sent)
            except Exception:
                out[(impl, layout)] = traceback.format_exc()
    return out


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def params(jax):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import moe as rmoe

    return jax.tree.map(np.asarray, rmoe.moe_mlp_init(jax.random.PRNGKey(0), ref_smoke(ARCH)))


@pytest.fixture(scope="module")
def four_ranks(params):
    ranks = spawn("test_torch_moe_sharded:_rank_cases", 4, backend="gloo", args=(params,),
                  timeout_s=300.0)
    for r, out in enumerate(ranks):
        for key, val in out.items():
            assert not isinstance(val, str), f"rank {r}, {key}:\n{val}"
    return ranks


@pytest.fixture(scope="module")
def reference(jax, params):
    """The reference's ``moe_ffn`` on a (data 2, model 2) CPU mesh: (y, aux)
    by (dispatch, case)."""
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as ref_smoke
    from repro.launch.mesh import make_test_mesh
    from repro.models import moe as rmoe

    mesh = make_test_mesh((2, 2), ("data", "model"))
    p = jax.tree.map(jnp.asarray, params)
    out = {}
    for impl in DISPATCHES:
        cfg = ref_smoke(ARCH)
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=impl))
        fn = jax.jit(lambda p_, x_, cfg=cfg: rmoe.moe_ffn(p_, x_, cfg, mesh))
        for case, (rows, positions, _) in CASES.items():
            x = jnp.asarray(x_np(rows, positions)).astype(jnp.bfloat16)
            y, aux = fn(p, x)
            out[(impl, case)] = (np.asarray(y, np.float32), float(aux))
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("impl", DISPATCHES)
def test_dispatch_matches_reference(four_ranks, reference, impl, layout, case):
    want_y, want_aux = reference[(impl, case)]
    dealt = CASES[case][2]
    for r in four_ranks:
        y, aux, _ = r[(impl, layout, case)]
        d = r["coords"]["data"]
        rows = slice(2 * d, 2 * d + 2) if dealt else slice(None)
        assert y.shape == want_y[rows].shape
        np.testing.assert_allclose(y, want_y[rows], atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(aux, want_aux, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("impl", DISPATCHES)
def test_bank_layouts_agree(four_ranks, impl, case):
    """Whole banks, and the ``Layout`` blocks beside whole serving banks:
    the same numbers (the dispatch reads the serving banks only)."""
    for r in four_ranks:
        np.testing.assert_array_equal(r[(impl, "full", case)][0], r[(impl, "blocks", case)][0])


@pytest.mark.parametrize("impl", DISPATCHES)
def test_schedules(four_ranks, impl):
    """``alltoall`` moves its capacity buffers by all-to-all over ``model``,
    ``allgather`` the tokens by all-gather and the outputs by an all-reduce;
    neither gathers a parameter; decode and the odd batch run ``grouped``:
    no all-to-all, and the decode gathers the global batch's rows over
    ``data``."""
    for r in four_ranks:
        sent = r[(impl, "blocks", "prefill")][2]
        assert ("all_to_all@model" in sent) == (impl == "alltoall")
        assert not any(k.startswith("gather_param") for k in sent)
        if impl == "allgather":
            assert {"all_gather@model", "all_reduce@model"} <= sent
        assert "all_to_all@model" not in r[(impl, "blocks", "decode")][2]
        assert r[(impl, "blocks", "decode")][2] == {"all_gather@data"}
        assert r[(impl, "blocks", "odd_batch")][2] == set()


def test_prefill_drops_tokens(params):
    """The case is one that drops: some expert gets more than its 5 slots
    from one rank's 16 tokens (2 rows x 8 positions)."""
    cfg = get_smoke_config(ARCH)
    m = tmoe.MoeMLP(cfg).requires_grad_(False)
    with torch.no_grad():
        m.router.w.copy_(torch.from_numpy(np.array(params["router"]["w"])))
    x = torch.from_numpy(x_np(B, S)).to(torch.bfloat16)[:2, :S // 2].reshape(-1, cfg.d_model)
    _, ids, _ = tmoe.route(m.router.w, x, cfg)
    C = tmoe.capacity(x.shape[0], cfg)
    assert C == 5
    _, keep = tmoe._positions_in_expert(ids, cfg.moe.num_experts, C)
    assert not bool(keep.all())
