"""The port stands alone: it imports neither jax, nor transformers, nor the
JAX package, and its entry points run on the card unless device="cpu" is
asked for."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "transformers", "orbax") or top == "ggml_gfx906_tpu":
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
""")


def _run(body: str) -> str:
    code = _BLOCKED + textwrap.dedent(body)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_port_imports_no_jax_and_runs_a_cpu_forward():
    out = _run("""
        import importlib, pkgutil
        import numpy as np, torch
        from ggml_gfx906_tpu_torch.quant.types import GGMLType as GGMLTypeQ
        import ggml_gfx906_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for n in names:
            importlib.import_module(n)
        for n in ("utils.autotune", "utils.perf", "ops.cuda.dma_copy", "models.tokenizer",
                  "models.cli", "models.speculative", "models.perplexity", "ops.act_quant",
                  "quant.numerics", "quant.blocks", "quant.legacy", "quant.kquants",
                  "quant.modern", "quant.iquants", "quant.registry", "models.convert",
                  "models.quantize_cli", "models.imatrix", "models.moe", "models.gpt2",
                  "models.gptj", "models.offload", "ops.recurrent", "ops.cuda.iq_search",
                  "models.yolo", "models.sam", "models.magika", "gguf.pytree", "ops.conv",
                  "training.opt", "training.dataset", "training.fit", "training.checkpoint",
                  "models.mnist", "models.mnist_cli", "parallel.mesh", "parallel.tp",
                  "parallel.ep", "parallel.sp", "parallel.pp"):
            assert pkg.__name__ + "." + n in names, n
        from ggml_gfx906_tpu_torch.quant import registry
        assert registry.dequantize(GGMLTypeQ.IQ2_XXS, bytes(66), 256).shape == (1, 256)
        import chip_smoke   # the smoke script imports nothing of JAX either
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "ggml_gfx906_tpu", "transformers",
                                           "orbax") for m in sys.modules)
        from ggml_gfx906_tpu_torch.models import llama
        from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
        from ggml_gfx906_tpu_torch.quant.types import BLOCK_Q4_K, GGMLType
        from ggml_gfx906_tpu_torch.quant.kquants import pack_scale_min_k4
        rng = np.random.default_rng(0)
        def q4k(n, k):
            b = np.zeros((n, k // 256), BLOCK_Q4_K)
            b["d"] = np.float16(0.001); b["dmin"] = np.float16(0.004)
            b["scales"] = pack_scale_min_k4(rng.integers(0, 64, (1, 8)),
                                            rng.integers(0, 64, (1, 8)))[0]
            b["qs"] = rng.integers(0, 256, (n, k // 256, 128), dtype=np.uint8)
            return QuantTensor.from_blocks(GGMLType.Q4_K, b, "cpu")
        cfg = llama.LlamaConfig(n_vocab=256, n_ctx=64, n_embd=256, n_head=4,
                                n_kv_head=2, n_layer=1, n_ff=512)
        one = torch.ones(256)
        p = {"wte": q4k(256, 256), "out_norm": one, "blocks": [dict(
            attn_norm=one, ffn_norm=one, wq=q4k(256, 256), wk=q4k(128, 256),
            wv=q4k(128, 256), wo=q4k(256, 256), w_gate=q4k(512, 256),
            w_up=q4k(512, 256), w_down=q4k(256, 512))]}
        logits, kv = llama.forward(cfg, p, torch.tensor([1, 2, 3]),
                                   llama.make_cache(cfg, 64, device="cpu"), 0)
        assert logits.shape == (3, 256) and torch.isfinite(logits).all()
        print("modules", len(names))
    """)
    assert "modules" in out


def test_entry_points_want_the_card(tmp_path):
    """Without device=, load/Engine/generate run on cuda — and raise here,
    where there is none, instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    from ggml_gfx906_tpu_torch.models import llama
    from ggml_gfx906_tpu_torch.runtime.engine import Engine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.load(tmp_path / "absent.gguf")
    cfg = llama.LlamaConfig(n_vocab=8, n_ctx=8, n_embd=8, n_head=1,
                            n_kv_head=1, n_layer=1, n_ff=8)
    params = {"out_norm": torch.ones(8), "blocks": []}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(llama, cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.generate(cfg, params, [1], 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.params_from_numpy({"out_norm": [1.0], "blocks": []})


def test_tool_entry_points_want_the_card(tmp_path):
    """The CLI (generate and serve), perplexity's command and function and
    both speculative decoders run on cuda unless asked for the CPU, and
    raise here, before reading any file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    from ggml_gfx906_tpu_torch.models import cli, llama, perplexity, speculative

    absent = str(tmp_path / "absent.gguf")
    for call in (lambda: cli.main(["-m", absent, "-p", "hi"]),
                 lambda: cli.main(["serve", "-m", absent, "--prompts", absent]),
                 lambda: perplexity.main(["--model", absent, "--text", absent])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    cfg = llama.LlamaConfig(n_vocab=8, n_ctx=8, n_embd=8, n_head=1,
                            n_kv_head=1, n_layer=1, n_ff=8)
    params = {"out_norm": torch.ones(8), "blocks": []}
    for call in (lambda: speculative.spec_generate(cfg, params, [1, 2], 2),
                 lambda: speculative.model_spec_generate(cfg, params, [1, 2], 2),
                 lambda: perplexity.perplexity_llama(cfg, params, [1, 2, 3])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_quantize_tools_want_the_card(tmp_path):
    """quantize_gguf, collect_llama, QuantTensor.quantize, random_params and
    the quantize and imatrix commands (--device cuda by default) run on the
    card unless asked for the CPU, and raise here before reading any file;
    the codecs run wherever their tensors are."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    from ggml_gfx906_tpu_torch.models import imatrix, llama, quantize_cli
    from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
    from ggml_gfx906_tpu_torch.quant import GGMLType, quantize

    absent = str(tmp_path / "absent.gguf")
    cfg = llama.LlamaConfig(n_vocab=8, n_ctx=8, n_embd=8, n_head=1,
                            n_kv_head=1, n_layer=1, n_ff=8)
    params = {"out_norm": torch.ones(8), "blocks": []}
    for call in (lambda: quantize_cli.main([absent, absent, "q4_K"]),
                 lambda: quantize_cli.quantize_gguf(absent, absent, GGMLType.Q4_K),
                 lambda: imatrix.main(["--model", absent, "--text", absent, "-o", absent]),
                 lambda: imatrix.collect_llama(cfg, params, [[1, 2]]),
                 lambda: QuantTensor.quantize(GGMLType.Q8_0, torch.zeros(1, 32)),
                 lambda: llama.random_params(cfg, qtype=GGMLType.Q8_0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert quantize(GGMLType.Q8_0, torch.zeros(1, 32)).device.type == "cpu"


def test_family_entry_points_want_the_card(tmp_path):
    """gpt2, gptj and the expert llama: load, random_params, generate and
    params_from_numpy run on cuda unless asked for the CPU, and raise here
    before reading any file; so do OffloadSplit.build (its device side) and
    auto_split."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    from ggml_gfx906_tpu_torch.models import gpt2, gptj, llama, moe, offload

    absent = tmp_path / "absent.gguf"
    gcfg = gpt2.GPT2Config(n_vocab=8, n_ctx=8, n_embd=8, n_head=1, n_layer=1)
    jcfg = gptj.GPTJConfig(n_vocab=8, n_ctx=8, n_embd=8, n_head=1, n_layer=1, n_rot=4)
    mcfg = moe.MoEConfig(n_vocab=8, n_ctx=8, n_embd=8, n_head=1, n_kv_head=1, n_layer=1,
                         n_ff=8, n_expert=2, n_expert_used=1)
    lcfg = llama.LlamaConfig(n_vocab=8, n_ctx=8, n_embd=8, n_head=1, n_kv_head=1, n_layer=1,
                             n_ff=8)
    one = torch.ones(8)
    calls = [lambda mod=mod: mod.load(absent) for mod in (gpt2, gptj, moe)]
    calls += [lambda: gpt2.random_params(gcfg), lambda: moe.random_params(mcfg),
              lambda: gpt2.generate(gcfg, {"ln_f_g": one, "blocks": []}, [1], 1),
              lambda: gptj.generate(jcfg, {"ln_f_g": one, "blocks": []}, [1], 1),
              lambda: moe.generate(mcfg, {"out_norm": one, "blocks": []}, [1], 1),
              lambda: gpt2.params_from_numpy({"ln_f_g": [1.0], "blocks": []}),
              lambda: offload.OffloadSplit.build(lcfg, {"wte": one, "out_norm": one,
                                                        "lm_head": one, "blocks": []}, 1),
              lambda: offload.auto_split(lcfg, {"wte": one, "blocks": []}, 8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_vision_entry_points_want_the_card(tmp_path):
    """yolo.load, magika.load, sam.load_gguf, sam.from_hf, pytree.load_pytree
    and the models' params_from_numpy run on cuda unless asked for the CPU,
    and raise here before reading any file; with device="cpu" they run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    import numpy as np

    import chip_smoke
    from ggml_gfx906_tpu_torch.gguf import pytree
    from ggml_gfx906_tpu_torch.models import magika, sam, yolo

    absent = tmp_path / "absent.gguf"
    sd = chip_smoke.sam_state(32, 1, 2, 64)
    for call in (lambda: yolo.load(absent), lambda: magika.load(absent),
                 lambda: sam.load_gguf(absent), lambda: pytree.load_pytree(absent),
                 lambda: sam.from_hf(sd, n_layer=1),
                 lambda: yolo.params_from_numpy([{"w": np.zeros(1)}]),
                 lambda: magika.params_from_numpy({"dense_b": np.zeros(1)}),
                 lambda: sam.params_from_numpy({"enc": {"patch_b": np.zeros(1)}})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    cfg, params = sam.from_hf(sd, n_layer=1, device="cpu")
    sam.save_gguf(tmp_path / "sam.gguf", cfg, params)
    cfg2, back = sam.load_gguf(tmp_path / "sam.gguf", device="cpu")
    assert cfg2 == cfg and back["enc"]["patch_w"].device.type == "cpu"
    tree, kv = pytree.load_pytree(tmp_path / "sam.gguf", device="cpu")
    assert kv["general.architecture"] == "sam" and len(tree["enc"]["blocks"]) == 1
    chip_smoke.yolo_gguf(tmp_path / "yolo.gguf", np.random.default_rng(0))
    assert yolo.load(tmp_path / "yolo.gguf", device="cpu")[12]["w"].shape == (255, 256, 1, 1)
    chip_smoke.magika_gguf(tmp_path / "magika.gguf")
    probs = magika.classify_bytes(magika.load(tmp_path / "magika.gguf", device="cpu"), b"hi")
    assert probs.shape == (113,) and abs(probs.sum() - 1) < 1e-5


def test_training_entry_points_want_the_card(tmp_path):
    """mnist.init_fc, init_cnn, train, load_gguf, params_from_numpy and the
    MNIST CLI (--device cuda by default) run on the card unless asked for
    the CPU, and raise here before reading any file; with device="cpu" /
    --device cpu they run; fit runs where the params live."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    import numpy as np

    from ggml_gfx906_tpu_torch.models import mnist, mnist_cli

    absent = str(tmp_path / "absent.gguf")
    x, y = mnist.synthetic_mnist(200, seed=0)
    for call in (lambda: mnist.init_fc(), lambda: mnist.init_cnn(),
                 lambda: mnist.train("fc", x, y, n_epochs=1),
                 lambda: mnist.load_gguf(absent),
                 lambda: mnist.params_from_numpy({"fc1_b": np.zeros(3)}),
                 lambda: mnist_cli.main(["eval", "-m", absent]),
                 lambda: mnist_cli.main(["train", "-o", absent, "--images", absent,
                                         "--labels", absent])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params, result = mnist.train("cnn", x, y, n_epochs=1, batch_size=100, verbose=False,
                                 device="cpu")
    assert params["conv1_k"].device.type == "cpu" and len(result.train_loss) == 1
    out = str(tmp_path / "cnn.gguf")
    assert mnist_cli.main(["train", "--arch", "fc", "--epochs", "1", "--synthetic-n", "200",
                           "--batch-size", "100", "-o", out, "--device", "cpu"]) == 0
    arch, back = mnist.load_gguf(out, device="cpu")
    assert arch == "fc" and back["fc1_w"].device.type == "cpu"
    assert mnist.init_fc(device="cpu")["fc1_w"].shape == (500, 784)


def test_mesh_entry_points_want_the_card(tmp_path):
    """make_mesh, make_ep_mesh and make_pp_mesh build their groups on the
    card (NCCL) unless asked for the CPU, and raise here, where there is no
    card; with device="cpu" they build gloo meshes. In a child process,
    with jax and the JAX package blocked, on a one-rank gloo world."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    out = _run(f"""
        import torch.distributed as dist
        from ggml_gfx906_tpu_torch.parallel import make_mesh
        from ggml_gfx906_tpu_torch.parallel.ep import make_ep_mesh
        from ggml_gfx906_tpu_torch.parallel.pp import make_pp_mesh
        dist.init_process_group("gloo", init_method="file://{tmp_path / 'init'}", rank=0,
                                world_size=1)
        for call in (make_mesh, lambda: make_ep_mesh(1), lambda: make_pp_mesh(1)):
            try:
                call()
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
            else:
                raise AssertionError("a mesh was made without a card")
        meshes = [make_mesh(device="cpu"), make_ep_mesh(1, device="cpu"),
                  make_pp_mesh(1, device="cpu")]
        assert [m.backend for m in meshes] == ["gloo"] * 3
        assert [m.device.type for m in meshes] == ["cpu"] * 3
        assert meshes[1].shape == {{"dp": 1, "ep": 1}} and not meshes[0].capturable
        dist.destroy_process_group()
        print("meshes ok")
    """)
    assert "meshes ok" in out
