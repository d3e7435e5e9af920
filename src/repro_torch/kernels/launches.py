"""The kernels' launch counts, read and reset together.

Each wrapper adds one to its count where it launches its kernel and
nowhere else (a CPU tensor takes the plain version and counts nothing),
so a process that starts at zero and reads :func:`launch_counts` at its
end knows which kernels its work ran on."""

from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.im2col import im2col_cuda
from repro_torch.kernels.qmm import qmm_matmul
from repro_torch.kernels.ssd import ssd_cuda
from repro_torch.kernels.tiled_mm import tiled_matmul
from repro_torch.kernels.vpu_mm import vpu_matmul

__all__ = ["KERNELS", "launch_counts", "reset_launches"]

#: kernel name -> its checked wrapper
KERNELS = {"tiled_mm": tiled_matmul, "vpu_mm": vpu_matmul, "qmm": qmm_matmul,
           "flash_attention": flash_attention_cuda, "ssd": ssd_cuda,
           "im2col": im2col_cuda}


def launch_counts() -> dict[str, int]:
    """Each kernel's launches since the process started or the last
    :func:`reset_launches`."""
    return {name: w.launches for name, w in KERNELS.items()}


def reset_launches() -> None:
    """Set every count to 0, the per-path counts too."""
    for w in KERNELS.values():
        w.launches = 0
        by_path = getattr(w, "launches_by_path", None)
        if by_path is not None:
            by_path.update(dict.fromkeys(by_path, 0))
