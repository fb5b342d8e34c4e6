"""The peaks of one NVIDIA H100 SXM5 80GB, copied from ``repro_torch.launch.mesh.HW``
(NVIDIA's H100 data sheet: dense tensor-core and FP32 rates, HBM3 bandwidth).
The rates assume the card's full 700 W power limit."""

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
