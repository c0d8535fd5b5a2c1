from repro_torch.kernels.rglru_scan.ops import (linear_scan,
                                                linear_scan_decode_step)

__all__ = ["linear_scan", "linear_scan_decode_step"]
