"""The plain reference that decides ``correct``: the HF equations of the
CLIP and SigLIP towers, the HF image processor's resize, crop and
normalize, the word tokenizer, dense scoring with top-k, the bootstrap's
rank counts, and the intervals and failure analysis after it, in plain
PyTorch and NumPy.

It imports neither JAX nor anything of the port, and takes only what the
benchmark made: the HF-layout weights, the raw uint8 images, the captions,
the embeddings and the seeds. Every product runs in the precision it is
given (``numerics.py``): "f32" with TF32 off is the reference; "tf32" and
"fp8" are the controls, the nearest precisions below f32 and bf16.
"""
