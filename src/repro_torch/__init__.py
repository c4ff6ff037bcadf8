"""PyTorch + CUDA port of the COMQ system (`src/repro/` is the JAX
reference it is held against).

Slice 1 covers the dense quantize-then-decode path: calibration walk,
blocked COMQ solve, packing, and decoding from the packed codes, with
hand-written Hopper kernels for the three TPU kernels on that path
(`kernels/comq_panel.py`, `kernels/flash_attention.py`,
`kernels/quant_matmul.py`; sources under `csrc/`).

Every entry point runs on CUDA unless the caller passes `device="cpu"`;
asking for CUDA where there is none raises (`repro_torch.device`).
"""
