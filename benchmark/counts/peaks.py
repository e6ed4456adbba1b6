"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12      # device memory bandwidth
BF16_OPS_PER_S = 989e12        # bf16 tensor cores, dense
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
