"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same numpy inputs go through the JAX package and its PyTorch port."""
import numpy as np
import torch

from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.ops.quantized import QuantTensor as JQuantTensor
from ggml_gfx906_tpu.quant.types import GGMLType


def nmse(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(((got - ref) ** 2).mean() / max((ref ** 2).mean(), 1e-30))


def jax_params_to_numpy(params: dict) -> dict:
    """The JAX llama params pytree with numpy leaves; each QuantTensor as
    {"qtype", "shape", "layout", "fields"} (models/llama.params_from_numpy)."""
    def conv(leaf):
        if isinstance(leaf, JQuantTensor):
            return {"qtype": int(leaf.qtype), "shape": tuple(leaf.shape),
                    "layout": leaf.layout,
                    "fields": {k: np.asarray(v) for k, v in leaf.fields.items()}}
        return np.asarray(leaf)

    out = {k: conv(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: conv(v) for k, v in b.items()} for b in params["blocks"]]
    return out


def tiny_cfg(n_ctx: int = 128):
    """Tiny GQA llama whose matrix widths are multiples of 256 (Q4_K)."""
    return jllama.LlamaConfig(n_vocab=256, n_ctx=n_ctx, n_embd=256, n_head=4,
                              n_kv_head=2, n_layer=2, n_ff=512)


def port_cfg(jcfg):
    from ggml_gfx906_tpu_torch.models import llama as tllama

    return tllama.LlamaConfig(
        n_vocab=jcfg.n_vocab, n_ctx=jcfg.n_ctx, n_embd=jcfg.n_embd,
        n_head=jcfg.n_head, n_kv_head=jcfg.n_kv_head, n_layer=jcfg.n_layer,
        n_ff=jcfg.n_ff, rms_eps=jcfg.rms_eps, rope_base=jcfg.rope_base,
        rope_dims=jcfg.rope_dims, rope_freq_scale=jcfg.rope_freq_scale,
        compute_dtype=torch.float32)


def tiny_models(qtype=GGMLType.Q4_K, seed: int = 0, n_ctx: int = 128):
    """(jax cfg, jax params, port cfg, port params on the CPU)."""
    from ggml_gfx906_tpu_torch.models import llama as tllama

    jcfg = tiny_cfg(n_ctx)
    jp = jllama.random_params(jcfg, seed=seed, qtype=qtype)
    tp = tllama.params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    return jcfg, jp, port_cfg(jcfg), tp
