"""AdamW's two kernels a leaf (``kernels/adamw``) and ``update``'s routing.

On the CPU, ``update`` takes the plain route (``global_norm``,
``clip_by_global_norm`` and ``_leaf_update``) for every leaf, a
non-contiguous view among them, counts each in ``route_leaves["plain"]``,
and gives what those functions give; ``rows`` finds the layout the kernels
take (rows of contiguous elements a fixed stride apart); the wrappers raise
on what they do not take before any library is loaded.

Tests marked ``cuda`` hold the kernels to the plain version on the card and
skip without one. ``adamw_step`` rounds each operation where PyTorch does
(the clip's product, the moments' bf16, ``t / c`` as ``t * f32(1/c)``), so
it is ``torch.equal`` to ``g.mul_(scale)`` then ``_leaf_update`` over three
steps, at any start and on a block narrowed past its first dim (ZeRO-1's). ``sumsq`` sums in double, in another
order than ``torch.sum``: its norm is held to ``global_norm`` within rtol
1e-6 (a float32 sum of a few million squares is good to about 1e-7). On
the card every leaf takes the kernels, and a leaf they do not take raises.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.adamw import adamw as fused
from repro_torch.optim import adamw

CFG = TrainConfig(learning_rate=3e-4, weight_decay=0.1, beta1=0.9, beta2=0.95, eps=1e-8,
                  grad_clip=1.0)
#: leaf sizes: under one vector, 8, a tail of 7, a norm scale, a tail of 3
SIZES = [1, 7, 8, 3072, 1000003]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def draw(n: int, seed: int, device="cpu"):
    """p, g, m, v of one leaf: g spans six decades so that the clip, the
    squares and the bf16 roundings all matter; v nonnegative."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n) * 0.02
    g = rng.standard_normal(n) * 10.0 ** rng.uniform(-5, 1, n)
    m = rng.standard_normal(n) * 1e-3
    v = np.abs(rng.standard_normal(n)) * 1e-6
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return f(p), f(g), f(m).to(torch.bfloat16), f(v).to(torch.bfloat16)


def bias(count: int):
    c1 = float(1 - adamw._f32(CFG.beta1) ** adamw._f32(count))
    c2 = float(1 - adamw._f32(CFG.beta2) ** adamw._f32(count))
    return c1, c2


def plain_tree(device="cpu"):
    """A small tree: a matrix, a transposed view (parameter and gradient not
    contiguous), a vector, a scalar-sized leaf."""
    w = draw(24 * 40, 1, device)
    vec = draw(40, 2, device)
    one = draw(1, 3, device)
    params = {"w": w[0].view(24, 40), "wt": draw(24 * 40, 4, device)[0].view(40, 24).t(),
              "vec": vec[0], "one": one[0]}
    grads = {"w": w[1].view(24, 40), "wt": draw(24 * 40, 5, device)[1].view(40, 24).t(),
             "vec": vec[1], "one": one[1]}
    state = adamw.AdamWState(m=zeros_bf16(params), v=zeros_bf16(params), count=2)
    return params, grads, state


def zeros_bf16(tree):
    return T.map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device), tree)


def sharded(params, device):
    """LeafShards on a one-rank (pod, model) mesh: "wt" and "vec" split over
    model, "w" with ZeRO-1 moments on dim 0, "one" on no axis."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 1), ("pod", "model"), device=device)
    return {"w": adamw.LeafShard(mesh, (), zero1_dim=0),
            "wt": adamw.LeafShard(mesh, ("model",)), "vec": adamw.LeafShard(mesh, ("model",)),
            "one": adamw.LeafShard(mesh)}


def clone(tree):
    return T.map(lambda t: t.clone(), tree)


class TestCpuRoute:
    @pytest.mark.parametrize("clip", [1.0, 0.0])
    def test_update_takes_the_plain_route(self, clip):
        cfg = TrainConfig(learning_rate=1e-2, weight_decay=0.1, grad_clip=clip)
        params, grads, state = plain_tree()
        assert not params["wt"].is_contiguous()
        want_p, want_g = clone(params), clone(grads)
        want_m, want_v = clone(state.m), clone(state.v)
        if clip > 0:
            want_g, want_norm = adamw.clip_by_global_norm(want_g, clip)
        else:
            want_norm = adamw.global_norm(want_g)
        c1 = float(1 - adamw._f32(cfg.beta1) ** adamw._f32(3))
        c2 = float(1 - adamw._f32(cfg.beta2) ** adamw._f32(3))
        for k in params:
            adamw._leaf_update(want_p[k], want_g[k], want_m[k], want_v[k], 1e-2, c1, c2, cfg)
        before = dict(fused.route_leaves)
        p, s, met = adamw.update(grads, state, params, 1e-2, cfg)
        assert fused.route_leaves["plain"] - before.get("plain", 0) == 4
        assert fused.route_leaves["kernel"] == before.get("kernel", 0)
        assert s.count == 3 and torch.equal(met["grad_norm"], want_norm)
        for k in params:
            assert p[k] is params[k]
            for got, want in ((p[k], want_p[k]), (s.m[k], want_m[k]), (s.v[k], want_v[k])):
                assert torch.equal(got, want), k

    def test_sharded_norm_sums_groups_in_order(self):
        """``global_norm`` with shards: each group of leaves split over the
        same axes summed in leaf order, the groups added in sorted order of
        their axes (what ``_card_norm`` groups the kernels' slots by)."""
        params, grads, _ = plain_tree()
        shards = sharded(params, "cpu")
        sq = {k: torch.sum(torch.square(g)) for k, g in grads.items()}
        by_axes = {(): sq["w"] + sq["one"], ("model",): sq["wt"] + sq["vec"]}
        want = torch.sqrt(by_axes[()] + by_axes[("model",)])
        assert torch.equal(adamw.global_norm(grads, shards), want)

    def test_cpu_leaves_do_not_fit(self):
        """Contiguous leaves at 16-byte boundaries, which the kernels would
        take on the card, take the plain route on the CPU."""
        params, grads = {"a": draw(64, 0)[0], "b": draw(24, 1)[0]}, {"a": draw(64, 2)[1],
                                                                    "b": draw(24, 3)[1]}
        state = adamw.AdamWState(m=zeros_bf16(params), v=zeros_bf16(params), count=0)
        before = dict(fused.route_leaves)
        adamw.update(grads, state, params, 3e-4, CFG)
        assert fused.route_leaves["plain"] - before.get("plain", 0) == 2
        assert fused.route_leaves["kernel"] == before.get("kernel", 0)

    @pytest.mark.parametrize("view, want", [
        (lambda t: t, (1, 24 * 40 * 6, 24 * 40 * 6)),
        (lambda t: t[3:5], (1, 2 * 40 * 6, 2 * 40 * 6)),
        (lambda t: t.narrow(1, 10, 20), (24, 20 * 6, 40 * 6)),
        (lambda t: t.narrow(2, 2, 3), (24 * 40, 3, 6)),
        (lambda t: t[:, :1], (24, 6, 40 * 6)),
        (lambda t: t[5:6, 3:7], (1, 4 * 6, 4 * 6)),
        (lambda t: t.transpose(0, 1), None),
        (lambda t: t[:, ::2], (24 * 20, 6, 12)),
        (lambda t: t.view(-1).as_strided((4, 6), (3, 1)), None),
        (lambda t: t[:0], (0, 0, 0)),
    ])
    def test_rows_finds_the_kernels_layout(self, view, want):
        """``rows``: a contiguous block is one row at any offset, a narrow
        or a step on a later dim is rows of one stride, a transpose or rows
        that overlap are no layout the kernels take; the rows enumerate the
        elements in order."""
        t = torch.arange(24 * 40 * 6, dtype=torch.float32).view(24, 40, 6)
        x = view(t)
        got = fused.rows(x)
        assert got == want
        if got is not None and got[0] > 0:
            n, cols, ld = got
            flat = t.view(-1)[x.storage_offset():]
            rebuilt = torch.cat([flat[r * ld:r * ld + cols] for r in range(n)])
            assert torch.equal(rebuilt, x.reshape(-1))


class TestWrappersRaise:
    def test_adamw_step_wrong_dtype(self):
        p, g, m, v = draw(64, 0)
        for args in ((p, g, m.float(), v.float()), (p, g, m.half(), v), (p.double(), g, m, v)):
            with pytest.raises(ValueError, match="bfloat16 m and v"):
                fused.adamw_step(*args, None, lr=1e-3, c1=0.1, c2=0.05, beta1=0.9,
                                 beta2=0.95, eps=1e-8, weight_decay=0.1)

    def test_adamw_step_wrong_device(self):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fused.adamw_step(*draw(64, 0), None, lr=1e-3, c1=0.1, c2=0.05, beta1=0.9,
                             beta2=0.95, eps=1e-8, weight_decay=0.1)

    def test_sumsq_and_norm_scale_wrong_device(self):
        g = torch.ones(16)
        with pytest.raises(ValueError, match="CUDA tensors"):
            fused.sumsq(g, torch.zeros(1))
        with pytest.raises(ValueError, match="float32"):
            fused.sumsq(g.double(), torch.zeros(1))
        with pytest.raises(ValueError, match="CUDA tensors"):
            fused.norm_scale(torch.ones(3), 1.0)


def step_both(p, g, m, v, want, count, clip, cuda):
    """One ``adamw_step`` on ``p, g, m, v`` and one ``_leaf_update`` on
    ``want`` (copies of p, m, v) with the same scale; then the two are held
    equal."""
    c1, c2 = bias(count)
    scale = {"on": torch.tensor(0.3125 + 1e-3 * count, device=cuda),
             "off": None, "one": torch.tensor(1.0, device=cuda)}[clip]
    gp = g.clone()
    if scale is not None:
        gp.mul_(scale)
    adamw._leaf_update(want[0], gp, want[1], want[2], 3e-4, c1, c2, CFG)
    fused.adamw_step(p, g, m, v, scale, lr=3e-4, c1=c1, c2=c2, beta1=CFG.beta1,
                     beta2=CFG.beta2, eps=CFG.eps, weight_decay=CFG.weight_decay)
    torch.cuda.synchronize()
    for got, exp, name in zip((p, m, v), want, "pmv"):
        assert torch.equal(got, exp), (name, count, (got != exp).sum().item())


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("clip", ["on", "off", "one"])
    def test_adamw_step_equals_leaf_update(self, cuda, n, clip):
        p, g, m, v = draw(n, n, cuda)
        want = [t.clone() for t in (p, m, v)]
        n0 = fused.adamw_step.launches
        for count in (1, 2, 3):
            step_both(p, g * (0.37 + count), m, v, want, count, clip, cuda)
        assert fused.adamw_step.launches == n0 + 3

    @pytest.mark.parametrize("offset", [1, 2, 3, 4, 7, 8])
    def test_unaligned_views_take_the_kernel(self, cuda, offset):
        """Views that start off a 16-byte boundary (the kernel's loop of one
        element at a time; at offset 8 every tensor is back on a boundary):
        bit-equal to the plain version, and ``update`` sends them to the
        kernel."""
        n = 4099
        p, g, m, v = (t[offset:offset + n] for t in draw(n + offset, 11, cuda))
        want = [t.clone() for t in (p, m, v)]
        for count in (1, 2):
            step_both(p, g, m, v, want, count, "on", cuda)
        params, grads = {"a": p, "b": draw(64, 12, cuda)[0]}, {"a": g, "b": draw(64, 13, cuda)[1]}
        state = adamw.AdamWState(m={"a": m, "b": torch.zeros(64, dtype=torch.bfloat16,
                                                             device=cuda)},
                                 v={"a": v, "b": torch.zeros(64, dtype=torch.bfloat16,
                                                             device=cuda)}, count=0)
        before = dict(fused.route_leaves)
        adamw.update(grads, state, params, 3e-4, CFG)
        assert fused.route_leaves["kernel"] - before.get("kernel", 0) == 2
        assert fused.route_leaves["plain"] == before.get("plain", 0)

    @pytest.mark.parametrize("dim, start, per", [(1, 8, 8), (2, 8, 16), (2, 5, 20)])
    def test_narrowed_block_equals_leaf_update(self, cuda, dim, start, per):
        """A ZeRO-1 block narrowed out of parameter and gradient on a dim
        past the first (rows of one stride: at 16-byte boundaries in the
        first two cases, not in the third), moments contiguous: bit-equal
        to the plain version, the elements outside the block untouched."""
        shape = (6, 16, 40)
        n = 6 * 16 * 40
        p, g, _, _ = draw(n, 21, cuda)
        p, g = p.view(shape), g.view(shape)
        pv, gv = p.narrow(dim, start, per), g.narrow(dim, start, per)
        assert not pv.is_contiguous() and fused.rows(pv)[0] > 1
        _, _, m, v = draw(pv.numel(), 22, cuda)
        m, v = m.view(pv.shape), v.view(pv.shape)
        outside = p.clone()
        want = [pv.clone(), m.clone(), v.clone()]
        for count in (1, 2, 3):
            step_both(pv, gv, m, v, want, count, "on", cuda)
        mask = torch.ones(shape, dtype=torch.bool, device=cuda)
        mask.narrow(dim, start, per).fill_(False)
        assert torch.equal(p[mask], outside[mask])

    @pytest.mark.parametrize("sizes", [[3072], [1, 7, 1000003], [25_165_824, 3072, 13]])
    @pytest.mark.parametrize("offset", [0, 1])
    def test_sumsq_matches_global_norm(self, cuda, sizes, offset):
        grads = {f"l{i}": draw(n + offset, i, cuda)[1][offset:] for i, n in enumerate(sizes)}
        grads["narrowed"] = draw(48 * 40, 9, cuda)[1].view(48, 40)[:, offset:offset + 24]
        slots = torch.empty(len(grads), dtype=torch.float32, device=cuda)
        n0 = fused.sumsq.launches + fused.norm_scale.launches
        for i, g in enumerate(grads.values()):
            fused.sumsq(g, slots[i])
        out = fused.norm_scale(slots, 1.0)
        torch.cuda.synchronize()
        assert fused.sumsq.launches + fused.norm_scale.launches == n0 + len(grads) + 1
        want = adamw.global_norm(grads)
        torch.testing.assert_close(out[0], want, rtol=1e-6, atol=0)
        for i, g in enumerate(grads.values()):
            torch.testing.assert_close(slots[i].double(), g.double().square().sum(),
                                       rtol=1e-6, atol=0)
        scale = torch.clamp(1.0 / torch.clamp(out[0], min=1e-12), max=1.0)
        assert torch.equal(out[1], scale)

    def test_update_on_a_llama_tree(self, cuda):
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import registry

        model = registry.build(get_smoke_config("llama3.2-1b"), device=cuda)
        params = {n: p.detach().float().clone() for n, p in model.named_parameters()}
        gen = torch.Generator(device=cuda).manual_seed(5)
        grads = {n: torch.randn(p.shape, generator=gen, device=cuda) * 0.05
                 for n, p in params.items()}
        state = adamw.AdamWState(m=zeros_bf16(params), v=zeros_bf16(params), count=0)
        want_p, want_m, want_v = clone(params), clone(state.m), clone(state.v)
        before = dict(fused.route_leaves)
        p, s, met = adamw.update(clone(grads), state, params, 3e-4, CFG)
        assert fused.route_leaves["kernel"] - before.get("kernel", 0) == len(params)
        assert fused.route_leaves["plain"] == before.get("plain", 0)
        norm = adamw.global_norm(grads)
        torch.testing.assert_close(met["grad_norm"], norm, rtol=1e-6, atol=0)
        scale = torch.clamp(CFG.grad_clip / torch.clamp(met["grad_norm"], min=1e-12), max=1.0)
        c1, c2 = bias(1)
        for k in params:
            g = grads[k].clone().mul_(scale)
            adamw._leaf_update(want_p[k], g, want_m[k], want_v[k], 3e-4, c1, c2, CFG)
            for got, exp, name in ((p[k], want_p[k], "p"), (s.m[k], want_m[k], "m"),
                                   (s.v[k], want_v[k], "v")):
                assert torch.equal(got, exp), (k, name)

    def test_sharded_update_on_card(self, cuda):
        """With LeafShards (groups over model, ZeRO-1 moments over a pod of
        1): the norm within rtol 1e-6 of ``global_norm`` with the same
        shards, every leaf on "kernel" (the narrowed "wt" as rows of one
        stride), every leaf bit-equal to the plain route at the card's
        scale."""
        params, grads, state = plain_tree(cuda)
        params["wt"] = draw(24 * 80, 4, cuda)[0].view(24, 80)[:, 20:60]
        grads["wt"] = draw(24 * 80, 5, cuda)[1].view(24, 80)[:, 20:60]
        shards = sharded(params, cuda)
        want_p, want_m, want_v = clone(params), clone(state.m), clone(state.v)
        before = dict(fused.route_leaves)
        p, s, met = adamw.update(clone(grads), state, params, 3e-4, CFG, shards)
        assert fused.route_leaves["kernel"] - before.get("kernel", 0) == 4
        assert fused.route_leaves["plain"] == before.get("plain", 0)
        torch.testing.assert_close(met["grad_norm"], adamw.global_norm(grads, shards),
                                   rtol=1e-6, atol=0)
        scale = torch.clamp(CFG.grad_clip / torch.clamp(met["grad_norm"], min=1e-12), max=1.0)
        c1, c2 = bias(3)
        for k in params:
            g = grads[k].clone().mul_(scale)
            adamw._leaf_update(want_p[k], g, want_m[k], want_v[k], 3e-4, c1, c2, CFG)
            for got, exp, name in ((p[k], want_p[k], "p"), (s.m[k], want_m[k], "m"),
                                   (s.v[k], want_v[k], "v")):
                assert torch.equal(got, exp), (k, name)

    def test_update_raises_on_a_leaf_the_kernels_do_not_take(self, cuda):
        """A transposed CUDA leaf is no layout of the kernels: ``update``
        raises (no second route on the card)."""
        params, grads, state = plain_tree(cuda)
        assert fused.rows(grads["wt"]) is None
        with pytest.raises(ValueError, match="rows of one stride"):
            adamw.update(grads, state, params, 3e-4, CFG)

    def test_wrappers_raise_on_card(self, cuda):
        p, g, m, v = draw(64, 0, cuda)
        with pytest.raises(ValueError, match="bfloat16 m and v"):
            fused.adamw_step(p, g, m, v.float(), None, lr=1e-3, c1=0.1, c2=0.05, beta1=0.9,
                             beta2=0.95, eps=1e-8, weight_decay=0.1)
        with pytest.raises(ValueError, match="one device"):
            fused.adamw_step(p, g.cpu(), m, v, None, lr=1e-3, c1=0.1, c2=0.05, beta1=0.9,
                             beta2=0.95, eps=1e-8, weight_decay=0.1)
        with pytest.raises(ValueError, match="float32"):
            fused.sumsq(g.half(), torch.zeros(1, device=cuda))
        with pytest.raises(ValueError, match="one layout"):
            fused.adamw_step(p.view(8, 8)[:, :4], g[:32], m[:32], v.view(16, 4)[:, :2], None,
                             lr=1e-3, c1=0.1, c2=0.05, beta1=0.9, beta2=0.95, eps=1e-8,
                             weight_decay=0.1)
