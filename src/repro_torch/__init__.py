"""PyTorch + CUDA port of the COMQ system (`src/repro/` is the JAX
reference it is held against).

It runs the dense GQA transformer and the MoE family: calibration walk,
blocked COMQ solve (every expert of a layer at once), packing, decoding
from the packed codes, and serving from a paged, optionally quantized KV
pool, with hand-written Hopper kernels for the five TPU kernels
(`kernels/comq_panel.py`, `kernels/flash_attention.py`,
`kernels/quant_matmul.py`, `kernels/paged_attention.py`; sources under
`csrc/`).

Every entry point runs on CUDA unless the caller passes `device="cpu"`;
asking for CUDA where there is none raises (`repro_torch.device`).
"""
