"""The port's KV-partition chunnels (``repro_torch.comm.kvshard``) against
the reference's (``repro.comm.kvshard``).

- ``flash_decode_local``: (o, l, m) against the reference's on the same
  inputs, over GQA groups 1, 2 and 4, no window and a window of 8, an int
  and a per-row ``kv_len``, and a shard wholly past ``kv_len`` (l = 0 and
  o = 0 there). Both take bfloat16 products of float32 inputs: o and l
  within 2e-2 (a bfloat16 step of the scores moves exp by 2**-8 relative,
  and P·V rounds to bfloat16), m within 1e-2 (a bfloat16 score).
- ``make_seq_sharded_decode`` on 2 ranks (the ``model`` axis of a (data 2,
  model 2) mesh) and on 4 (``model`` 4), each rank holding its S/n
  positions: against the reference's ``decode_attention_local`` on the whole
  cache and the reference's own ``make_seq_sharded_decode`` on a 2- and a
  4-device CPU mesh, within ``test_comm.py::TestFlashDecode``'s 2e-2.
- the heads branch on (data 2, model 2): each rank holding its KV heads,
  against the reference's ``decode_attention_local`` (the reference's
  branch is layout-only), within 1e-5 (the same float32 attention per head).
- the collectives it adds: ``all_reduce_max`` and ``all_to_all`` over
  ``model`` (block j of rank i's tensor arrives at rank j as block i), and
  their bytes in ``SENT``.
- ``pick_kv_chunnel`` and the chunnels' capabilities.

One ``spawn`` of four gloo ranks computes every sharded case; inputs are
drawn with numpy from seeds, alike on both packages.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.comm import kvshard
from repro_torch.configs import get_config
from repro_torch.configs.base import ShardingConfig
from repro_torch.launch.mesh import spawn

B, H, HD, S = 3, 8, 16, 32
GROUPS = (1, 2, 4)
WINDOWS = (None, 8)
KV_LENS = ("int", "rows")
RANKS = (2, 4)


def case_id(group, window, kv_len) -> str:
    return f"g{group}-w{window}-{kv_len}"


CASES = [(g, w, n) for g in GROUPS for w in WINDOWS for n in KV_LENS]


def inputs(group, window, kv_len):
    """q (B,1,H,hd), k/v (B,S,H/group,hd) float32 and kv_len, from a seed
    of the case."""
    rng = np.random.default_rng(100 * group + (window or 0) + (kv_len == "rows"))
    kh = H // group
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, kh, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, kh, HD)).astype(np.float32)
    n = 29 if kv_len == "int" else np.array([5, 20, 32], np.int32)
    return q, k, v, n


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rank_cases() -> dict:
    """Every sharded case on this rank (spawn target)."""
    from repro_torch.comm import collectives
    from repro_torch.launch.mesh import make_mesh

    out = {}
    mesh2 = make_mesh((2, 2), ("data", "model"), device="cpu")
    mesh4 = make_mesh((4,), ("model",), device="cpu")
    for mesh, n in ((mesh2, 2), (mesh4, 4)):
        seq = kvshard.make_seq_sharded_decode(mesh, "model")
        r = mesh.coords["model"]
        for g, w, kv in CASES:
            q, k, v, n_valid = inputs(g, w, kv)
            s_loc = S // n
            k_loc, v_loc = (_t(a[:, r * s_loc:(r + 1) * s_loc]) for a in (k, v))
            nv = n_valid if isinstance(n_valid, int) else _t(n_valid)
            out[("seq", n, g, w, kv)] = seq(_t(q), k_loc, v_loc, nv, w).numpy()
            assert seq.capacity(k_loc) == S
    heads = kvshard.make_head_sharded_decode(mesh2, "model")
    r = mesh2.coords["model"]
    for g, w, kv in CASES:
        q, k, v, n_valid = inputs(g, w, kv)
        kh = k.shape[2] // 2
        k_loc, v_loc = (_t(a[:, :, r * kh:(r + 1) * kh]) for a in (k, v))
        nv = n_valid if isinstance(n_valid, int) else _t(n_valid)
        out[("heads", 2, g, w, kv)] = heads(_t(q), k_loc, v_loc, nv, w).numpy()
    # the writes: only the owner of a position, only the rank's heads
    cache = torch.zeros(1, S // 2, 4, 2)
    new = torch.arange(8.0).reshape(1, 1, 4, 2) + 1
    kvshard.make_seq_sharded_decode(mesh2).write(cache, new, S // 2 + 3)
    out["seq_write"] = cache.numpy()
    cache = torch.zeros(1, S, 2, 2)
    heads.write(cache, new, 7)
    out["heads_write"] = cache.numpy()
    # the collectives, and their bytes
    sent0 = dict(collectives.SENT)
    i = mesh4.coords["model"]
    x = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3) + 100 * i
    out["a2a"] = collectives.all_to_all(x, mesh4, "model").numpy()
    out["max"] = collectives.all_reduce_max(torch.tensor([float(i), -float(i)]), mesh4,
                                            "model").numpy()
    out["sent"] = {k: v - sent0.get(k, 0) for k, v in collectives.SENT.items()
                   if v - sent0.get(k, 0)}
    out["model_index"] = i
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn("test_torch_kvshard:_rank_cases", 4, backend="gloo", threads=1,
                 timeout_s=300.0)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro.comm import kvshard as rk

    return rk


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("group,window,kv_len", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_flash_decode_local_matches_reference(ref, group, window, kv_len):
    import jax.numpy as jnp

    q, k, v, n = inputs(group, window, kv_len)
    start = 8  # the second of four shards of 8
    k, v = k[:, start:start + 8], v[:, start:start + 8]
    o, l, m = kvshard.flash_decode_local(_t(q), _t(k), _t(v), start,
                                         n if isinstance(n, int) else _t(n), window)
    ro, rl, rm = ref.flash_decode_local(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), start,
                                        jnp.asarray(n), window)
    assert o.shape == (B, H, HD) and l.shape == m.shape == (B, H)
    assert o.dtype == l.dtype == m.dtype == torch.float32
    close(o, ro, 2e-2)
    close(l, rl, 2e-2)
    close(m, rm, 1e-2)


def test_flash_decode_local_shard_past_kv_len(ref):
    """A shard that starts at or after ``kv_len``: every position masked,
    l = 0 and o = 0 (p zeroed, not exp(0)), m the mask value; the
    reference's the same."""
    import jax.numpy as jnp

    q, k, v, _ = inputs(2, None, "int")
    o, l, m = kvshard.flash_decode_local(_t(q), _t(k[:, :8]), _t(v[:, :8]), 24, 20)
    assert float(l.abs().max()) == 0.0 and float(o.abs().max()) == 0.0
    assert bool((m == kvshard.NEG_INF).all())
    ro, rl, rm = ref.flash_decode_local(jnp.asarray(q), jnp.asarray(k[:, :8]),
                                        jnp.asarray(v[:, :8]), 24, 20)
    close(l, rl, 0)
    close(o, ro, 0)
    close(m, rm, 0)


@pytest.mark.parametrize("n_ranks", RANKS)
@pytest.mark.parametrize("group,window,kv_len", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_seq_sharded_decode_matches_reference(ranks, ref, n_ranks, group, window, kv_len):
    """Every rank's combined output equals the reference's local decode over
    the whole cache and the reference's own flash-decode on a CPU mesh of
    ``n_ranks`` devices, within 2e-2; all ranks agree exactly."""
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import make_test_mesh
    from repro.models.attention import decode_attention_local

    q, k, v, n = inputs(group, window, kv_len)
    local = decode_attention_local(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(n), window=window)
    attn_fn = ref.make_seq_sharded_decode(make_test_mesh((1, n_ranks), ("data", "model")))
    sharded = jax.jit(lambda *a: attn_fn(*a, window))(jnp.asarray(q), jnp.asarray(k),
                                                       jnp.asarray(v), jnp.asarray(n))
    got = [r[("seq", n_ranks, group, window, kv_len)] for r in ranks]
    assert got[0].shape == (B, 1, H, HD)
    for g in got:
        np.testing.assert_array_equal(g, got[0])
    close(got[0], local, 2e-2)
    close(got[0], sharded, 2e-2)


@pytest.mark.parametrize("group,window,kv_len", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_head_sharded_decode_matches_reference(ranks, ref, group, window, kv_len):
    import jax.numpy as jnp
    from repro.models.attention import decode_attention_local

    q, k, v, n = inputs(group, window, kv_len)
    want = decode_attention_local(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(n), window=window)
    for r in ranks:
        close(r[("heads", 2, group, window, kv_len)], want, 1e-5)


def test_partitioned_writes(ranks):
    """Position S/2 + 3 lands on the rank at model index 1, at its slot 3;
    the heads branch writes the rank's two of four heads."""
    new = np.arange(8.0).reshape(1, 1, 4, 2) + 1
    for rank, r in enumerate(ranks):
        idx = rank % 2  # ranks 1 and 3 sit at model index 1 of (data 2, model 2)
        assert np.flatnonzero(r["heads_write"].reshape(S, -1).any(axis=1)).tolist() == [7]
        written = np.flatnonzero(r["seq_write"].reshape(S // 2, -1).any(axis=1)).tolist()
        assert written == ([3] if idx == 1 else [])
        if idx == 1:
            np.testing.assert_array_equal(r["seq_write"][0, 3], new[0, 0])
        np.testing.assert_array_equal(r["heads_write"][0, 7], new[0, 0, 2 * idx:2 * idx + 2])


def test_all_to_all_and_max(ranks):
    """Block j of the rank at model index i arrives at rank j as block i;
    the max over four ranks; each rank's bytes: three blocks of 12 bytes,
    and 2(n-1)/n of the max's 8."""
    for r in ranks:
        j = r["model_index"]
        want = np.stack([np.arange(12.0).reshape(4, 3)[j] + 100 * i for i in range(4)])
        np.testing.assert_array_equal(r["a2a"], want)
        np.testing.assert_array_equal(r["max"], [3.0, 0.0])
        assert r["sent"] == {"all_to_all@model": 36, "all_reduce_max@model": 12}


@pytest.mark.parametrize("arch,model,mode", [
    ("llama3.2-1b", 2, "heads"), ("llama3.2-1b", 16, "sequence"),
    ("hymba-1.5b", 2, "sequence"), ("phi-3-vision-4.2b", 16, "heads"),
    ("granite-34b", 4, "sequence")])
def test_pick_kv_chunnel(ref, arch, model, mode):
    """``auto`` picks heads where the KV heads divide ``model``, else
    sequence, as the reference does; a forced partition is kept. The
    capabilities are the reference's compositional labels."""
    from repro.configs import get_config as ref_config
    from repro.configs.base import ShardingConfig as RefSharding

    mesh = SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": model})
    ch = kvshard.pick_kv_chunnel(get_config(arch), mesh, ShardingConfig())
    rch = ref.pick_kv_chunnel(ref_config(arch), mesh, RefSharding())
    assert ch.name == rch.name == {"heads": "KVHeadSharded", "sequence": "KVSeqSharded"}[mode]
    assert ({(c.label, c.mode) for c in ch.capabilities()}
            == {(c.label, c.mode) for c in rch.capabilities()}
            == {(f"kvshard:{mode}@model", "compose")})
    other = "sequence" if mode == "heads" else "heads"
    forced = kvshard.pick_kv_chunnel(get_config(arch), mesh, ShardingConfig(kv_partition=other))
    assert isinstance(forced, kvshard.KVHeadSharded if other == "heads" else kvshard.KVSeqSharded)
    assert forced.apply("tree", "state", {}) == ("tree", "state")
