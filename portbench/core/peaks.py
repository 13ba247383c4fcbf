"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W power limit)."""

PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12,
              "float32": 67e12}                    # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
