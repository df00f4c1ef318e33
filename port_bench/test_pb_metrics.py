import statistics
from types import SimpleNamespace

import numpy as np
import pytest

from port_bench import quant, roofline
from port_bench.conftest import TINY_MOE
from port_bench.driver import Done
from port_bench.ref import mixtral
from port_bench.run import clipped_tokens, end_to_end


def test_window_rate_moves_with_a_stall():
    steady = [(t, 1.0, 100) for t in range(1, 11)]
    stalled = steady[:4] + [(8.0, 4.0, 100)] + [(t + 4, 1.0, 100) for t in range(5, 7)]
    assert clipped_tokens(steady, 0, 10) / 10 == pytest.approx(100.0)
    assert clipped_tokens(stalled, 0, 10) / 10 == pytest.approx(70.0)
    # a harvested window straddling an edge counts by its share inside
    assert clipped_tokens([(2.0, 2.0, 100)], 1.5, 3.0) == pytest.approx(25.0)


def test_p95_is_over_every_request_of_the_window():
    done = [Done(0, i, [1], [2], 10.0, 10.0 + (i + 1) / 1e3) for i in range(200)]
    done += [Done(0, 999, [1], [2], 0.0, 50.0)]            # finished after the window
    res = SimpleNamespace(t_open=10.0, t_close=11.0, done=done, harvests=[(10.5, 0.5, 10)])
    out = end_to_end(res, {"gen_tok_s", "latency_p95_ms"})
    lat = [i + 1.0 for i in range(200)]
    assert out["latency_p95_ms"]["value"] == pytest.approx(statistics.quantiles(lat, n=20)[18])
    assert out["gen_tok_s"]["value"] == pytest.approx(10.0)


@pytest.mark.parametrize("qtype,row", [("Q4_K", 16 * 144), ("Q5_K", 16 * 176),
                                       ("Q6_K", 16 * 210), ("Q8_0", 128 * 34)])
def test_bytes_and_ops_by_hand(qtype, row):
    assert quant.row_bytes(qtype, 4096) == row
    # a 4096 x 4096 matrix at T = 1: its wire bytes and 2 x 4096 bf16 activations
    want = (4096 * row + 2 * 4096 * 2) / 3.35e12
    assert roofline.matrix_least_s(4096, 4096, qtype, 1) == pytest.approx(want)
    # at T = 4096 the operations bound it: 2 N K T at 1,979 TOP/s
    assert roofline.matrix_least_s(4096, 4096, qtype, 4096) == pytest.approx(
        2 * 4096 ** 3 / 1979e12)


def test_expert_stack_counts_the_routed_experts():
    one = roofline.matrix_least_s(14336, 4096, "Q4_K", 1, experts=8, U=2)
    assert one == pytest.approx((2 * 14336 * quant.row_bytes("Q4_K", 4096)
                                 + 2 * (14336 + 4096) * 2) / 3.35e12)
    assert roofline.expected_experts(8, 2, 1) == pytest.approx(2.0)
    assert roofline.expected_experts(8, 2, 32) == pytest.approx(8 * (1 - 0.75 ** 32))
    assert 7.99 < roofline.expected_experts(8, 2, 32) < 8.0


def test_expected_experts_against_the_references_routing():
    """The formula takes the routing as uniform, which touches the most
    experts: groups of T rows of the tiny reference's own routing touch no
    more, and the formula is exact at T = 1."""
    routes = []
    rng = np.random.default_rng(3)
    seqs = [(rng.integers(1, 512, 256).tolist(), [5, 6])]
    mixtral.logits(TINY_MOE, 11, seqs, "cpu", routes=routes)
    for T in (1, 2, 8, 32):
        seen = roofline.routed_experts(routes, T, rng)
        assert seen <= roofline.expected_experts(8, 2, T) + 0.05
    assert roofline.routed_experts(routes, 1, rng) == 2.0


def test_qmm_kernel_names():
    for name in ("void small_kernel<QK45<false>, 8>(float const*, ...)",
                 "void kernel<Q4KI8, 64>(XOps<8>, ...)", "void tree_kernel<Q6K>(...)",
                 "void quant_x_kernel<XQ4K, float>(...)"):
        assert roofline.is_qmm_kernel(name)
    for name in ("void fwd_kernel<__nv_bfloat16, false, 16>(...)", "void combine_kernel(...)",
                 "void at::native::vectorized_elementwise_kernel<4, ...>"):
        assert not roofline.is_qmm_kernel(name)
