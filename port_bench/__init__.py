"""The benchmark of the PyTorch and CUDA port (`ggml_gfx906_tpu_torch`):
`python port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`, driven by `BENCHMARK.json` and the files of this folder
(README.md)."""
