"""expann_tpu_torch — the PyTorch / CUDA port of expann_tpu for NVIDIA Hopper.

Same engines and the same index format as ``expann_tpu``; the JAX package
is the reference this one is tested against.  Plain tensor code is
PyTorch; the kernels of the serving path are hand-written CUDA C++ under
``csrc/`` (fused graph traversal and flat top-k over bf16 or s8 codes, the
per-iteration block scorer), built with ``nvcc`` at first use
(``ops/_kernels.py``).  On CPU tensors every kernel wrapper runs its plain
PyTorch version instead.

The build and the exact rerank are float32: TF32 is switched off for
matmuls and cuDNN here, so ``precision="default"`` and ``"highest"``
both mean full fp32 (TF32 would change the graph the build produces).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from expann_tpu_torch.models.antitopo import AntitopoConfig, AntitopoEngine  # noqa: E402
from expann_tpu_torch.models.brute_force import BruteForceEngine  # noqa: E402

__all__ = ["AntitopoConfig", "AntitopoEngine", "BruteForceEngine", "__version__"]
