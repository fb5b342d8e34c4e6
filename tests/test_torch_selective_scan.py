"""The port's fused selective scan against the reference's SSM scan.

``selective_scan_ref`` (the plain version of the Hopper kernel
``selective_scan``) is held to the reference's computation of the same
function as ``src/repro/models/ssm.py::ssm_apply`` runs it: ``a = exp(dt A)``
and ``bx = dt x B`` over the padded sequence, ``_scan_chunk`` (an associative
scan) chunk by chunk with the state carried, the contraction with C by
``einsum("cbdn,cbn->cbd")``, then ``+ D x``. Inputs come from numpy with a
seed at hymba-smoke's widths (d_in 128, N 4) and at N 16, x and B, C in
bfloat16 as the model hands them over, and both get the same values.

Tolerance: atol = rtol = 1e-5, the reference's own for its scan kernel
(``tests/test_kernels.py``). The associative scan and the einsum take their
products and sums in another order than the step-by-step scan and the
contraction in n order; the largest gap seen is 2e-6 at |y| up to 13.

Between two runs of the port itself (a state carried over two calls, half
the channels, another chunk length, the wrapper on CPU tensors) the results
are bit-equal: the plain version runs the same float32 steps in the same
order whatever the split.

Tests marked ``cuda`` hold the kernel to the plain version on the card and
skip without one; the kernel rounds every product and sum in the plain
version's order, and the card's torch.exp is its expf, so they agree bit for
bit. They import nothing of JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssm_scan.ssm_scan import selective_scan, selective_scan_ref

TOL = dict(atol=1e-5, rtol=1e-5)
RANK = 4  # dt_rank of hymba-smoke: the columns of x_proj's output before B
LENGTHS = [1, 37, 256, 300]
WIDTHS = [(128, 4), (64, 16)]  # (d_in, N): hymba-smoke's, and N 16


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import _scan_chunk

    def run(dt, x, Bm, Cm, A, h0, D, chunk=256):
        """``repro.models.ssm.ssm_apply``'s scan and contraction (its lines
        from ``a = jnp.exp(...)`` to ``+ p["D"] * xs``), on numpy inputs."""
        f32 = jnp.float32
        dt, A, h0, D = (jnp.asarray(t) for t in (dt, A, h0, D))
        x, Bm, Cm = (jnp.asarray(t).astype(jnp.bfloat16) for t in (x, Bm, Cm))
        B, S, d_in = dt.shape
        N = A.shape[1]
        a = jnp.exp(dt[..., None] * A)
        bx = (dt * x.astype(f32))[..., None] * Bm.astype(f32)[..., None, :]
        pad = (-S) % chunk
        if pad:
            a = jnp.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0)), constant_values=1.0)
            bx = jnp.pad(bx, ((0, 0), (0, pad), (0, 0), (0, 0)))
            Cm = jnp.pad(Cm, ((0, 0), (0, pad), (0, 0)))
        n = a.shape[1] // chunk
        a_ch = a.reshape(B, n, chunk, d_in, N).transpose(1, 2, 0, 3, 4)
        bx_ch = bx.reshape(B, n, chunk, d_in, N).transpose(1, 2, 0, 3, 4)
        C_ch = Cm.astype(f32).reshape(B, n, chunk, N).transpose(1, 2, 0, 3)

        def body(h, inputs):
            a_c, bx_c, C_c = inputs
            h_all, h_last = _scan_chunk(a_c, bx_c, h)
            return h_last, jnp.einsum("cbdn,cbn->cbd", h_all, C_c)

        h, y_seq = jax.lax.scan(body, h0, (a_ch, bx_ch, C_ch))
        y = y_seq.transpose(2, 0, 1, 3).reshape(B, n * chunk, d_in)[:, :S]
        return np.asarray(y + D * x.astype(f32)), np.asarray(h)

    return run


def make_inputs(S, d_in, N, seed, batch=2, h0_scale=0.1, bc_dtype=torch.bfloat16):
    """As ``ssm_apply`` hands them over: dt = softplus of a normal below 0,
    x bf16, B and C column views of an x_proj-like (batch, S, RANK + 2N)
    output, A = -(1..N) times a jitter, h0 normal times ``h0_scale``, D
    normal."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((batch, S, d_in)) - 3.0)).astype(np.float32)
    x = rng.standard_normal((batch, S, d_in)).astype(np.float32)
    proj = rng.standard_normal((batch, S, RANK + 2 * N)).astype(np.float32)
    A = -(np.arange(1, N + 1) * (1 + 0.1 * rng.random((d_in, N)))).astype(np.float32)
    h0 = (rng.standard_normal((batch, d_in, N)) * h0_scale).astype(np.float32)
    D = rng.standard_normal(d_in).astype(np.float32)
    proj_t = torch.from_numpy(proj).to(bc_dtype)
    return (torch.from_numpy(dt), torch.from_numpy(x).bfloat16(), proj_t[..., RANK:RANK + N],
            proj_t[..., RANK + N:], torch.from_numpy(A), torch.from_numpy(h0),
            torch.from_numpy(D))


def as_numpy(args):
    return [t.float().numpy() for t in args]


def same(got, want) -> None:
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert torch.equal(g, w)


@pytest.mark.parametrize("d_in,N", WIDTHS, ids=[f"N{n}" for _, n in WIDTHS])
@pytest.mark.parametrize("S", LENGTHS)
def test_plain_version_matches_reference(jax_ref, S, d_in, N):
    args = make_inputs(S, d_in, N, seed=S + N)
    y, h = selective_scan_ref(*args)
    ry, rh = jax_ref(*as_numpy(args))
    assert tuple(y.shape) == ry.shape == (2, S, d_in) and tuple(h.shape) == rh.shape
    np.testing.assert_allclose(y.numpy(), ry, **TOL)
    np.testing.assert_allclose(h.numpy(), rh, **TOL)


@pytest.mark.parametrize("split", [1, 100, 256])
def test_state_carried_over_two_calls(jax_ref, split):
    """The first ``split`` steps, then the rest from their state: the one
    call's y and state, bit for bit, and the reference's within TOL."""
    dt, x, Bm, Cm, A, h0, D = make_inputs(300, 128, 4, seed=7)
    y, h = selective_scan_ref(dt, x, Bm, Cm, A, h0, D)
    y1, h1 = selective_scan_ref(dt[:, :split], x[:, :split], Bm[:, :split], Cm[:, :split],
                                A, h0, D)
    y2, h2 = selective_scan_ref(dt[:, split:], x[:, split:], Bm[:, split:], Cm[:, split:],
                                A, h1, D)
    same((torch.cat([y1, y2], dim=1), h2), (y, h))
    ry, rh = jax_ref(*as_numpy((dt[:, split:], x[:, split:], Bm[:, split:], Cm[:, split:],
                                A, h1, D)))
    np.testing.assert_allclose(y2.numpy(), ry, **TOL)
    np.testing.assert_allclose(h2.numpy(), rh, **TOL)


@pytest.mark.parametrize("half", [0, 1])
def test_a_ranks_half_of_the_channels(jax_ref, half):
    """A rank of hymba split over model 2 scans its d_in / 2 channels with
    its A, dt, x and D, and the whole B and C: its half of the whole call."""
    dt, x, Bm, Cm, A, h0, D = make_inputs(37, 128, 4, seed=11)
    y, h = selective_scan_ref(dt, x, Bm, Cm, A, h0, D)
    c = slice(64 * half, 64 * (half + 1))
    part = (dt[..., c], x[..., c], Bm, Cm, A[c], h0[:, c], D[c])
    yr, hr = selective_scan_ref(*part)
    same((yr, hr), (y[..., c], h[:, c]))
    ry, rh = jax_ref(*as_numpy(part))
    np.testing.assert_allclose(yr.numpy(), ry, **TOL)
    np.testing.assert_allclose(hr.numpy(), rh, **TOL)


@pytest.mark.parametrize("chunk", [1, 8, 36, 300])
def test_chunk_moves_no_rounding(chunk):
    args = make_inputs(37, 64, 16, seed=3)
    same(selective_scan_ref(*args, chunk=chunk), selective_scan_ref(*args))


def test_meta_tensors_give_shapes():
    """launch.dryrun's FLOP count builds the model on the meta device: the
    plain version returns the shapes without running its loop."""
    args = [t.to("meta") for t in make_inputs(2048, 128, 4, seed=0)]
    y, h = selective_scan_ref(*args)
    assert y.device.type == h.device.type == "meta"
    assert tuple(y.shape) == (2, 2048, 128) and tuple(h.shape) == (2, 128, 4)
    assert y.dtype == h.dtype == torch.float32


def test_wrapper_on_cpu_runs_the_plain_version():
    args = make_inputs(37, 128, 4, seed=1, bc_dtype=torch.float32)
    before = selective_scan.launches
    same(selective_scan(*args), selective_scan_ref(*args))
    assert selective_scan.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    dt, x, Bm, Cm, A, h0, D = make_inputs(8, 16, 4, seed=2)
    with pytest.raises(ValueError, match="x bfloat16"):
        selective_scan(dt, x.float(), Bm, Cm, A, h0, D)
    with pytest.raises(ValueError, match="float32"):
        selective_scan(dt.bfloat16(), x, Bm, Cm, A, h0, D)
    with pytest.raises(ValueError, match="alike"):
        selective_scan(dt, x, Bm, Cm.float(), A, h0, D)
    with pytest.raises(ValueError, match="do not fit"):
        selective_scan(dt, x, Bm, Cm, A[:8], h0, D)
    with pytest.raises(ValueError, match="alike"):
        selective_scan(dt, x[:, :4], Bm, Cm, A, h0, D)
    with pytest.raises(ValueError, match="nonempty"):
        selective_scan(dt[:, :0], x[:, :0], Bm[:, :0], Cm[:, :0], A, h0, D)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        selective_scan(*(t.to("meta") for t in (dt, x, Bm, Cm, A, h0, D)))


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bc", ["bfloat16", "float32"])
@pytest.mark.parametrize("d_in,N", [(128, 4), (96, 8), (3200, 16)], ids=["N4", "N8", "N16"])
@pytest.mark.parametrize("S", [1, 37, 300])
def test_kernel_is_bit_equal_to_plain_version(cuda, S, d_in, N, bc):
    args = [t.to(cuda) for t in make_inputs(S, d_in, N, seed=S, bc_dtype=getattr(torch, bc))]
    n0 = selective_scan.launches
    got = selective_scan(*args)
    assert selective_scan.launches == n0 + 1
    torch.cuda.synchronize()
    same(got, selective_scan_ref(*args))


@pytest.mark.cuda
def test_kernel_on_a_partial_block_of_channels(cuda):
    """d_in 300: the last block of 32 channels is partly past d_in."""
    args = [t.to(cuda) for t in make_inputs(300, 300, 16, seed=9, batch=3)]
    got = selective_scan(*args)
    torch.cuda.synchronize()
    same(got, selective_scan_ref(*args))


@pytest.mark.cuda
def test_kernel_decode_steps_carry_the_state(cuda):
    """Decode: one step at a time from the carried state, each the very
    output of the plain version's step and of one call over all steps."""
    dt, x, Bm, Cm, A, h0, D = (t.to(cuda) for t in make_inputs(5, 128, 4, seed=4))
    y, h = selective_scan(dt, x, Bm, Cm, A, h0, D)
    hs, ys = h0, []
    for t in range(5):
        step = (dt[:, t:t + 1], x[:, t:t + 1], Bm[:, t:t + 1], Cm[:, t:t + 1], A)
        yt, hn = selective_scan(*step, hs, D)
        same((yt, hn), selective_scan_ref(*step, hs, D))
        ys.append(yt)
        hs = hn
    same((torch.cat(ys, dim=1), hs), (y, h))


@pytest.mark.cuda
def test_kernel_reads_strided_views_and_rejects_other_widths(cuda):
    dt, x, Bm, Cm, A, h0, D = (t.to(cuda) for t in make_inputs(40, 64, 4, seed=6))
    # every input a non-contiguous view: the kernel reads through strides
    views = (dt.transpose(0, 1).contiguous().transpose(0, 1), x[:, ::1], Bm, Cm,
             A.t().contiguous().t(), h0.transpose(1, 2).contiguous().transpose(1, 2), D)
    assert not views[0].is_contiguous() and not views[4].is_contiguous()
    same(selective_scan(*views), selective_scan_ref(dt, x, Bm, Cm, A, h0, D))
    wide = [t.to(cuda) for t in make_inputs(4, 32, 5, seed=0)]
    with pytest.raises(ValueError, match="N in"):
        selective_scan(*wide)
