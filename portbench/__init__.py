"""The benchmark of deflate_compression_tpu_torch: `python3 -m portbench.run`
(see run.py), driven by BENCHMARK.json at the root of the checkout."""
