"""PyTorch/CUDA port of serverless-learn-tpu for one NVIDIA H100.

The JAX package ``serverless_learn_tpu`` stays the reference; this package
imports nothing of it and nothing of JAX. Ported so far: serving a Llama
model (``models/``, ``inference/``) with the weight-only int8 matmul as a
hand-written Hopper kernel (``ops/quant_matmul.py``), and training one on a
single card (``training/``, ``data/``, ``config.py``) with flash attention
forward and backward as hand-written Hopper kernels
(``ops/flash_attention.py``); the kernels' sources are in ``csrc/``. Entry
point: ``python -m serverless_learn_tpu_torch train|serve|generate``.
"""
