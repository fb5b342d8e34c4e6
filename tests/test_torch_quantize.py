"""The port's int8 block quantizer against the reference wire.

The plain PyTorch versions (``quantize_pack_ref``/``unpack_dequant_ref``,
reached through the wrappers on CPU tensors) must give exactly the bytes of
``repro.comm.wire._fused_encode`` — with ``use_kernel=True`` (the Pallas
kernel in interpret mode) and ``False`` (the jnp oracle) — and decode bit
for bit like ``_fused_decode``. Tolerance: none; decode is one multiply.

Tests marked ``cuda`` hold the Hopper kernels to the plain versions on the
card and skip without one. The reference is imported inside a fixture, so
this file also collects where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.quantize.quantize import (
    INV127,
    VECTOR_BLOCKS,
    packed_nbytes,
    quantize_pack,
    quantize_pack_ref,
    route,
    unpack_dequant,
    unpack_dequant_ref,
    unpack_dequant_sum,
    unpack_dequant_sum_ref,
)


@pytest.fixture(scope="module")
def ref_wire():
    return pytest.importorskip("repro.comm.wire")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_rows(n_blocks, block, scale, seed):
    """Seeded rows with a zero block and a row of exact .5 ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_blocks, block)) * scale).astype(np.float32)
    if n_blocks > 1:
        x[0] = 0.0
    if n_blocks > 2 and block >= 6:
        # amax = 127 * 2^k makes the scale exactly 2^k, so x / s lands on .5
        p = np.float32(2.0 ** np.round(np.log2(scale)))
        x[1] = 0.0
        x[1, :6] = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5], np.float32) * p
    return x


def reference_bytes(ref_wire, x, block, use_kernel):
    import jax.numpy as jnp

    return np.asarray(ref_wire._fused_encode(jnp.asarray(x), block=block,
                                             use_kernel=use_kernel))


def as_bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


class TestAgainstReference:
    @pytest.mark.parametrize("scale", [1e-3, 3.0, 1e4])
    @pytest.mark.parametrize("n_blocks", [1, 7, 128, 300])
    @pytest.mark.parametrize("block", [4, 64, 128, 256, 1024])
    def test_encode_bytes_and_decode_bits(self, ref_wire, block, n_blocks, scale):
        import jax.numpy as jnp

        x = make_rows(n_blocks, block, scale, seed=block * 1000 + n_blocks)
        got = quantize_pack(torch.from_numpy(x)).numpy()
        for use_kernel in (True, False):
            np.testing.assert_array_equal(
                got, reference_bytes(ref_wire, x, block, use_kernel))
        y = unpack_dequant(torch.from_numpy(got), n_blocks, block).numpy()
        for use_kernel in (True, False):
            y_ref = np.asarray(ref_wire._fused_decode(
                jnp.asarray(got), n_blocks=n_blocks, block=block,
                use_kernel=use_kernel))
            np.testing.assert_array_equal(as_bits(y), as_bits(y_ref))

    def test_ties_round_half_to_even(self):
        x = make_rows(3, 64, 1.0, seed=0)
        packed = quantize_pack(torch.from_numpy(x)).numpy()
        codes = packed[: 3 * 64].view(np.int8).reshape(3, 64)
        assert packed[3 * 64 + 4:3 * 64 + 8].view(np.float32)[0] == 1.0
        np.testing.assert_array_equal(codes[1, :6], [127, 0, 2, 2, -2, 0])

    def test_zero_block_scale_one_codes_zero(self):
        x = np.zeros((4, 64), np.float32)
        packed = quantize_pack(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(packed[:256], 0)
        np.testing.assert_array_equal(packed[256:].view(np.float32), 1.0)
        y = unpack_dequant(torch.from_numpy(packed), 4, 64).numpy()
        np.testing.assert_array_equal(y, 0.0)

    def test_true_division_scale_would_break_parity(self, ref_wire):
        """The reference's jitted wire carries amax * f32(1/127), not
        amax / 127: a port that divides differs in scale bytes."""
        x = make_rows(300, 64, 3.0, seed=5)
        want = reference_bytes(ref_wire, x, 64, use_kernel=False)
        t = torch.from_numpy(x)
        amax = t.abs().amax(dim=1)
        s_div = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        s_mul = torch.where(amax > 0, amax * INV127, torch.ones_like(amax))
        assert not torch.equal(s_div, s_mul)
        q = torch.clamp(torch.round(t / s_div[:, None]), -127, 127).to(torch.int8)
        divided = torch.cat([q.reshape(-1).view(torch.uint8), s_div.view(torch.uint8)])
        assert (divided.numpy() != want).any()
        np.testing.assert_array_equal(quantize_pack(t).numpy(), want)

    @pytest.mark.parametrize("block", [3, 65, 100])
    def test_unaligned_scales(self, ref_wire, block):
        """n_blocks * block need not be a multiple of 4: scales start at an
        odd byte and still decode."""
        x = make_rows(5, block, 2.0, seed=block)
        got = quantize_pack(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, reference_bytes(ref_wire, x, block, False))
        y = unpack_dequant(torch.from_numpy(got), 5, block).numpy()
        np.testing.assert_array_equal(
            as_bits(y), as_bits(unpack_dequant_ref(torch.from_numpy(got), 5, block)))


class TestCompressFunctions:
    """repro_torch.comm.compress against repro.comm.compress run under
    jax.jit, as the reference runs it inside a step."""

    @pytest.mark.parametrize("shape", [(1000,), (3, 5, 7), (256, 256)])
    def test_quantize_dequantize_error_match_jitted_reference(self, ref_wire, shape):
        import jax

        from repro.comm import compress as ref
        from repro_torch.comm import compress

        x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32) * 2
        q, s = compress.quantize_int8(torch.from_numpy(x), block=128)
        q_ref, s_ref = jax.jit(lambda a: ref.quantize_int8(a, block=128))(x)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        np.testing.assert_array_equal(as_bits(s.numpy()), as_bits(s_ref))
        y = compress.dequantize_int8(q, s, shape, block=128)
        y_ref = ref.dequantize_int8(q_ref, s_ref, shape, block=128)
        assert tuple(y.shape) == shape
        np.testing.assert_array_equal(as_bits(y.numpy()), as_bits(y_ref))
        e = compress.quantize_error(torch.from_numpy(x), block=128).numpy()
        np.testing.assert_array_equal(as_bits(e), as_bits(x - np.asarray(y_ref)))
        # jitted, XLA fuses x - q*s into one fused multiply-add, which rounds
        # once where x - fl(q*s) rounds twice: at most half an ulp of q*s apart
        e_ref = np.asarray(jax.jit(lambda a: ref.quantize_error(a, block=128))(x))
        assert (np.abs(e - e_ref) <= np.spacing(np.abs(np.asarray(y_ref)))).all()
        assert compress.int8_wire_ratio(128) == ref.int8_wire_ratio(128)


class TestWrapperContract:
    def test_cpu_runs_plain_and_counts_no_launch(self):
        before = (quantize_pack.launches, unpack_dequant.launches)
        x = torch.ones(2, 64)
        packed = quantize_pack(x)
        assert packed.shape == (packed_nbytes(2, 64),)
        unpack_dequant(packed, 2, 64)
        assert (quantize_pack.launches, unpack_dequant.launches) == before

    @pytest.mark.parametrize("bad", [
        torch.ones(2, 64, dtype=torch.float64),
        torch.ones(128),
        torch.ones(0, 64),
        torch.ones(64, 2).t(),
        torch.ones(2, 64, device="meta"),
    ], ids=["float64", "1d", "empty", "strided", "meta"])
    def test_quantize_pack_rejects(self, bad):
        with pytest.raises(ValueError):
            quantize_pack(bad)

    @pytest.mark.parametrize("args", [
        (torch.zeros(10, dtype=torch.int8), 1, 6),
        (torch.zeros(11, dtype=torch.uint8), 1, 6),
        (torch.zeros(0, dtype=torch.uint8), 0, 6),
        (torch.zeros(10, dtype=torch.uint8, device="meta"), 1, 6),
    ], ids=["int8", "length", "empty", "meta"])
    def test_unpack_dequant_rejects(self, args):
        with pytest.raises(ValueError):
            unpack_dequant(*args)


def offset(t, nbytes):
    """A view of ``t``'s values that starts ``nbytes`` past a fresh
    allocation's (16-byte aligned) start."""
    k = nbytes // t.element_size()
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    view = buf[k:].view(t.shape)
    view.copy_(t)
    return view


class TestRouteChoice:
    """The wrappers pick a kernel's route from the block and the pointers
    alone, before the launch: the same rule on every device."""

    @pytest.mark.parametrize("block", sorted(VECTOR_BLOCKS))
    def test_aligned_power_of_two_takes_vector(self, block):
        x = torch.zeros(5, block)
        packed = torch.empty(packed_nbytes(5, block), dtype=torch.uint8)
        assert x.data_ptr() % 16 == 0 == packed.data_ptr() % 16
        assert route(block, x, packed) == "vector"

    @pytest.mark.parametrize("block", [3, 65, 100, 101])
    def test_other_blocks_take_scalar(self, block):
        x = torch.zeros(5, block)
        packed = torch.empty(packed_nbytes(5, block), dtype=torch.uint8)
        assert route(block, x, packed) == "scalar"

    @pytest.mark.parametrize("block", [4, 64, 256, 1024])
    def test_float_input_offset_by_one_float_takes_scalar(self, block):
        x = offset(torch.zeros(5, block), 4)
        packed = torch.empty(packed_nbytes(5, block), dtype=torch.uint8)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
        assert route(block, x, packed) == "scalar"

    @pytest.mark.parametrize("block", [4, 64, 256, 1024])
    def test_packed_buffer_offset_by_one_byte_takes_scalar(self, block):
        packed = offset(torch.zeros(packed_nbytes(5, block), dtype=torch.uint8), 1)
        out = torch.empty(5 * block)
        assert packed.is_contiguous() and packed.data_ptr() % 16 == 1
        assert route(block, packed, out) == "scalar"

    def test_vector_blocks_are_the_powers_of_two_from_4_to_1024(self):
        assert VECTOR_BLOCKS == {4, 8, 16, 32, 64, 128, 256, 512, 1024}


@pytest.mark.cuda
class TestKernelAgainstPlain:
    @pytest.mark.parametrize("block", [3, 4, 16, 64, 100, 128, 256, 512, 1024])
    @pytest.mark.parametrize("n_blocks", [1, 7, 300, 4099])
    def test_kernels_equal_plain_on_card(self, cuda, block, n_blocks):
        x = torch.from_numpy(make_rows(n_blocks, block, 3.0, seed=n_blocks)).to(cuda)
        n0 = (quantize_pack.launches, unpack_dequant.launches)
        packed = quantize_pack(x)
        assert torch.equal(packed, quantize_pack_ref(x))
        y = unpack_dequant(packed, n_blocks, block)
        assert torch.equal(y.view(torch.int32),
                           unpack_dequant_ref(packed, n_blocks, block).view(torch.int32))
        assert y.device.type == "cuda"
        assert (quantize_pack.launches, unpack_dequant.launches) == (n0[0] + 1, n0[1] + 1)

    @pytest.mark.parametrize("block", [64, 256])
    def test_aligned_call_is_one_vector_launch(self, cuda, block):
        x = torch.from_numpy(make_rows(300, block, 3.0, seed=block)).to(cuda)
        n0 = (quantize_pack.route_launches.copy(), unpack_dequant.route_launches.copy())
        unpack_dequant(quantize_pack(x), 300, block)
        for wrapper, before in zip((quantize_pack, unpack_dequant), n0):
            assert wrapper.route_launches - before == {("vector", block): 1}

    def test_float_input_offset_by_one_float_takes_scalar(self, cuda):
        x = torch.from_numpy(make_rows(300, 64, 3.0, seed=2)).to(cuda)
        x_off = offset(x, 4)
        assert x_off.data_ptr() % 16 == 4
        n0 = quantize_pack.route_launches.copy()
        packed = quantize_pack(x_off)
        assert quantize_pack.route_launches - n0 == {("scalar", 64): 1}
        assert torch.equal(packed, quantize_pack_ref(x))

    def test_packed_buffer_offset_by_one_byte_takes_scalar(self, cuda):
        x = torch.from_numpy(make_rows(300, 64, 3.0, seed=3)).to(cuda)
        packed = quantize_pack_ref(x)
        packed_off = offset(packed, 1)
        assert packed_off.data_ptr() % 16 == 1
        n0 = unpack_dequant.route_launches.copy()
        y = unpack_dequant(packed_off, 300, 64)
        assert unpack_dequant.route_launches - n0 == {("scalar", 64): 1}
        assert torch.equal(y.view(torch.int32),
                           unpack_dequant_ref(packed, 300, 64).view(torch.int32))

    @pytest.mark.parametrize("block", [64, 256])
    def test_ties_and_zero_rows_on_vector_route(self, cuda, block):
        x = torch.from_numpy(make_rows(300, block, 1.0, seed=block)).to(cuda)
        n0 = quantize_pack.route_launches.copy()
        packed = quantize_pack(x)
        assert quantize_pack.route_launches - n0 == {("vector", block): 1}
        assert torch.equal(packed, quantize_pack_ref(x))
        codes = packed[:300 * block].view(torch.int8).view(300, block).cpu()
        scales = packed[300 * block:].view(torch.float32).cpu()
        assert scales[0] == 1.0 and (codes[0] == 0).all()  # the zero row
        assert scales[1] == 1.0  # the row of ties: amax 127, scale exactly 1
        assert codes[1, :6].tolist() == [127, 0, 2, 2, -2, 0]
        y = unpack_dequant(packed, 300, block)
        assert (y[:block] == 0).all()
        assert torch.equal(y.view(torch.int32),
                           unpack_dequant_ref(packed, 300, block).view(torch.int32))

    def test_kernel_bytes_equal_cpu_bytes(self, cuda):
        x = make_rows(300, 256, 1e4, seed=1)
        on_card = quantize_pack(torch.from_numpy(x).to(cuda)).cpu()
        assert torch.equal(on_card, quantize_pack(torch.from_numpy(x)))


class TestLaunchCountLock:
    """A wire may encode in one thread while another decodes (the WAN
    gateway decodes in its own thread), so the wrappers' launch counts are
    bumped under a lock: two threads counting N launches each leave exactly
    2N, in total and by route and block."""

    @pytest.mark.parametrize("wrapper", [quantize_pack, unpack_dequant],
                             ids=["quantize_pack", "unpack_dequant"])
    def test_two_threads_lose_no_count(self, wrapper):
        import sys
        import threading

        from repro_torch.kernels.quantize.quantize import count_launch

        n = 20_000
        saved = wrapper.launches, wrapper.route_launches.copy()
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)  # switch threads as often as it can
        try:
            wrapper.launches = 0
            wrapper.route_launches.clear()
            start = threading.Barrier(2)

            def bump():
                start.wait()
                for _ in range(n):
                    count_launch(wrapper, "vector", 256)

            threads = [threading.Thread(target=bump) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert wrapper.launches == 2 * n
            assert wrapper.route_launches == {("vector", 256): 2 * n}
        finally:
            sys.setswitchinterval(interval)
            wrapper.launches = saved[0]
            wrapper.route_launches.clear()
            wrapper.route_launches.update(saved[1])

    def test_count_waits_for_the_lock(self):
        """The count is taken under the wrappers' lock: while another holder
        has it, a launch's count waits."""
        import threading

        from repro_torch.kernels.quantize import quantize as q

        saved = q.quantize_pack.launches, q.quantize_pack.route_launches.copy()
        try:
            q.quantize_pack.launches = 0
            with q._COUNT_LOCK:
                t = threading.Thread(target=q.count_launch, args=(q.quantize_pack, "scalar", 101))
                t.start()
                t.join(timeout=0.2)
                assert t.is_alive() and q.quantize_pack.launches == 0
            t.join()
            assert q.quantize_pack.launches == 1
        finally:
            q.quantize_pack.launches = saved[0]
            q.quantize_pack.route_launches.clear()
            q.quantize_pack.route_launches.update(saved[1])


def gathered(n, n_blocks, block, device, seed=0):
    """Codes (n, n_blocks, block) and scales (n, n_blocks) of n quantized
    ranks, as an all-gather leaves them."""
    packed = [quantize_pack(torch.from_numpy(make_rows(n_blocks, block, 3.0, seed + k)).to(device))
              for k in range(n)]
    nq = n_blocks * block
    return (torch.stack([p[:nq].view(torch.int8).view(n_blocks, block) for p in packed]),
            torch.stack([p[nq:].clone().view(torch.float32) for p in packed]))


@pytest.mark.cuda
class TestUnpackDequantSumOnCard:
    """``unpack_dequant_sum`` against its plain version on the card: bit-equal
    (the same products and sums in the same order, no FMA)."""

    @pytest.mark.parametrize("block", [4, 64, 101, 256, 1024])
    @pytest.mark.parametrize("n", [1, 2, 4])
    @pytest.mark.parametrize("n_blocks", [1, 7, 4099])
    def test_equals_plain(self, cuda, n, block, n_blocks):
        codes, scales = gathered(n, n_blocks, block, cuda, seed=n_blocks)
        n0 = unpack_dequant_sum.route_launches.copy()
        got = unpack_dequant_sum(codes, scales)
        want = unpack_dequant_sum_ref(codes, scales)
        torch.cuda.synchronize()
        assert got.device.type == "cuda" and got.shape == (n_blocks * block,)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        which = "vector" if block in VECTOR_BLOCKS else "scalar"
        assert unpack_dequant_sum.route_launches - n0 == {(which, block): 1}

    def test_offset_views_take_scalar_and_agree(self, cuda):
        codes, scales = gathered(2, 300, 256, cuda)
        codes_off = offset(codes, 1)
        assert codes_off.data_ptr() % 16 == 1
        n0 = unpack_dequant_sum.route_launches.copy()
        got = unpack_dequant_sum(codes_off, scales)
        assert unpack_dequant_sum.route_launches - n0 == {("scalar", 256): 1}
        assert torch.equal(got.view(torch.int32),
                           unpack_dequant_sum_ref(codes, scales).view(torch.int32))

    def test_one_rank_equals_unpack_dequant(self, cuda):
        x = torch.from_numpy(make_rows(300, 256, 3.0, seed=4)).to(cuda)
        packed = quantize_pack(x)
        codes = packed[:300 * 256].view(torch.int8).view(1, 300, 256)
        scales = packed[300 * 256:].clone().view(torch.float32).view(1, 300)
        assert torch.equal(unpack_dequant_sum(codes, scales).view(torch.int32),
                           unpack_dequant(packed, 300, 256).view(torch.int32))
