"""Argument checks shared by the kernels' wrappers: a wrapper takes CUDA
tensors of the layout its kernel reads and raises on anything else (it
never hands a tensor to the plain version)."""
from __future__ import annotations

import torch


def check_tensor(kernel: str, name: str, t, ndim: int, dtype=None,
                 contiguous: bool = True) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor")
    if t.dim() != ndim:
        raise ValueError(f"{kernel}: {name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def check_one_device(kernel: str, *tensors) -> None:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: tensors on several devices {devices}")


def check_launch(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")


def check_cp_async_rows(kernel: str, name: str, t) -> None:
    """The kernel copies each row of the last dimension into shared memory
    in 16-byte pieces (``cp.async``), so the tensor's base address and its
    other strides must be multiples of 16 bytes (the stride of a
    dimension of size 1 is never used). Raises ValueError naming the
    constraint otherwise; any device."""
    item = t.element_size()
    strides = [s * item for s in t.stride()[:-1]]
    if t.data_ptr() % 16 or any(s % 16 for s, n in zip(strides, t.shape) if n > 1):
        raise ValueError(
            f"{kernel}: {name} rows must be 16-byte aligned for the "
            f"kernel's 16-byte cp.async copies; got base address % 16 = "
            f"{t.data_ptr() % 16} and strides of {strides} bytes")
