"""The H100 SXM's peaks (NVIDIA's datasheet), from which every bound of the
port's benches and chip_smoke.py is computed: HBM bytes a second, and
float32 operations a second outside the tensor cores (the rate taken for
32-bit integer operations)."""
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
