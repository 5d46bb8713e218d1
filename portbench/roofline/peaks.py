"""Published peaks of one NVIDIA H100 SXM5 (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W limit), and of its host link."""

BF16_FLOPS = 989e12          # tensor cores, bf16 in, f32 accumulate
F32_FLOPS = 67e12            # CUDA cores, f32
HBM_BYTES_S = 3.35e12        # HBM3
PCIE5_X16_BYTES_S = 64e9     # PCIe Gen5 x16, one direction (128 GB/s both)

FLOPS_OF = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}
