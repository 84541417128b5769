"""orb_slam2_tpu_torch — the PyTorch/CUDA port of the SLAM engine.

The JAX package `orb_slam2_tpu` is the reference this package is held
against; this one imports torch and numpy only. Each hot kernel is a
hand-written CUDA kernel for Hopper (`csrc/`), with a plain-PyTorch twin
beside its wrapper (`ops/cuda_extract.py`, `ops/cuda_match.py`,
`ops/cuda_pose.py`): a CPU tensor runs the twin, a CUDA tensor runs the
kernel.

Numerics: the engine's matmuls and convolutions are geometry, where TF32's
10-bit mantissa injects ~0.1%-relative noise into every product (the JAX
package pins float32 matmuls for the same reason). Pin full float32 here:
cuBLAS TF32 is off by default, cuDNN TF32 is on by default and would put any
convolution twin in TF32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
