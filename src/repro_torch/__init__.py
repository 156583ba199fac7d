"""repro_torch — the PyTorch / CUDA port of the ultrasound pipelines.

A second package beside the JAX reference (``repro``); it imports
nothing from it. Plain tensor code is PyTorch; the reference's Pallas
kernels on the serving path are hand-written CUDA kernels for Hopper
(``repro_torch.kernels``). Entry points run on the card unless the
caller passes ``device="cpu"``.

Determinism: float32 matmuls and cuDNN convolutions (the Doppler
smoothing is an ``F.conv2d``) run in full float32, never TF32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
