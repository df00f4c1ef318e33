import pytest
import torch

from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor, dequant
from ggml_gfx906_tpu_torch.quant.types import GGMLType
from port_bench import quant


@pytest.mark.parametrize("qtype", sorted(quant.BLOCK))
def test_frozen_dequant_equals_the_port(qtype):
    raw = quant.make_blocks(qtype, 48, 1024, quant.generator(2**33 + 3, qtype, "cpu"), "cpu")
    assert raw.shape == (48, quant.row_bytes(qtype, 1024))
    ours = quant.dequantize(qtype, raw, 1024)
    port = dequant(QuantTensor.from_wire(GGMLType[qtype], raw, (48, 1024), "cpu"))
    assert torch.equal(ours, port)
    assert bool(torch.isfinite(ours).all())
    assert abs(float(ours.std()) - 0.02) < 0.002 and abs(float(ours.mean())) < 0.002


def test_a_tensor_is_the_same_whoever_makes_it():
    a = quant.wire(7, "blk.0.attn_q.weight", "Q4_K", 8, 256, "cpu")
    b = quant.wire(7, "blk.0.attn_q.weight", "Q4_K", 8, 256, "cpu")
    c = quant.wire(7, "blk.1.attn_q.weight", "Q4_K", 8, 256, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert quant.tensor_seed(2**40 + 1, "x") != quant.tensor_seed(2**40 + 2, "x")


def test_scale_packing_round_trips():
    sc = torch.randint(0, 64, (5, 8))
    m = torch.randint(0, 64, (5, 8))
    back = quant.unpack_scale_min_k4(quant.pack_scale_min_k4(sc, m))
    assert torch.equal(back[0].long(), sc) and torch.equal(back[1].long(), m)
