"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""

HBM_BYTES_S = 3.35e12
#: tensor-core peak by input dtype, and float32 outside the tensor cores
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float8": 1979e12,
            "int8": 1979e12, "tf32": 495e12, "float32": 67e12}


def bound_s(nbytes: float, ops: float, dtype: str = "bfloat16"):
    """(least seconds, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
