"""PyTorch/CUDA port of ``multimodal_embedding_tpu`` for one NVIDIA H100.

The same benchmark (dense retrieval over COCO-style data, Recall@K with
bootstrap confidence intervals, failure analysis, QPS) with hand-written
Hopper kernels in ``csrc/`` for the TPU package's Pallas kernels: fused
attention (``ops/attention_cuda.py``) and PIL-exact preprocessing
(``ops/preprocess_cuda.py``). Module names mirror the JAX package. The port
imports torch and numpy, never jax and never the JAX package.

Entry point: ``python -m multimodal_embedding_tpu_torch.cli.main``.
"""

__version__ = "0.1.0"
