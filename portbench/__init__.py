"""The port bench: BENCHMARK.json's harness for rayverb_tpu_torch on CUDA."""
