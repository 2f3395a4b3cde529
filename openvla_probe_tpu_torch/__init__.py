"""openvla_probe_tpu_torch — the PyTorch/CUDA port of ``openvla_probe_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference; this package keeps its module
layout and function names, imports neither JAX nor anything of the JAX
package, and replaces each Pallas TPU kernel on its path with a CUDA kernel
written for ``sm_90a`` (``ops/csrc``). Ported so far: serving through
``models.vla.predict_action_from_image`` on every tier and weight form, over
Llama and Mixtral (sparse-MoE) trunks; the Phi-2 trunk; the base VLM's
generation and candidate scoring (``models.generate``), the eval harness
(``eval``), training, loading, multi-LoRA and the command line.

Entry points run on ``device="cuda"`` unless the caller passes ``"cpu"``; on
the CPU every kernel wrapper takes its plain PyTorch version.
"""

import torch

# Numerics the port relies on, set for the whole process at import:
# - fp32 matmuls and convolutions in full fp32, never TF32 (the JAX package
#   runs its fp32 products at Precision.HIGHEST);
# - bf16 matmuls reduce split-K partial sums in fp32: by default cuBLAS may
#   reduce them in bf16, which XLA never does on this path.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
