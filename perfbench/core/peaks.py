"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A card set to a
lower limit runs below them; every result records the card's name and
`power.limit` beside its numbers."""

BF16_FLOPS = 989e12      # bf16 / fp16 on the tensor cores
F32_FLOPS = 67e12        # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
