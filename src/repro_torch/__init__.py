"""PyTorch / CUDA port of the FedDec trainer (the flat buffer and the
tree engine), its sweep lattice, the paper's experiments and the model
zoo's prefill.

The JAX package ``repro`` is the reference this package is tested
against; ``repro_torch`` mirrors its layout (configs, core, optim, models,
data, kernels, launch) and imports only torch, numpy and the standard
library.  Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

import torch

# The reference contracts and mixes in full f32 (Precision.HIGHEST in
# repro/core/engine.py and repro/core/gossip.py).  TF32 keeps about three
# decimal digits, so both switches stay off for every f32 matmul and
# convolution the port runs; this is the one place they are set.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
