"""UBIS on PyTorch and CUDA: the port of the JAX package ``repro``.

The port mirrors ``repro``'s layout module by module and holds itself to
it: the same inputs give the same ids, the same tie order and the same
live multiset, with scores within fp32 tolerance.  It imports neither
``jax`` nor ``repro``.

fp32 matmuls here must run in full fp32 (the reference accumulates in
fp32 everywhere), so importing the package turns TF32 off for matmuls
and cuDNN: ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
