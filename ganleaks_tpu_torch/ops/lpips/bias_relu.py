"""The LPIPS tower's pass after each convolution: the bias add, the ReLU
and, where a 2x2 max pool follows, the pool, in one pass over the
convolution's output — the hand-written CUDA kernel
``csrc/bias_relu_pool.cu`` and its plain PyTorch version.

No TPU kernel is replaced: XLA fuses the JAX tower's bias and ReLU into
its convolution. On the card the tower's convolution is cuDNN's with no
bias (``F.conv2d(..., None)``); :func:`bias_relu_pool` then writes
``relu(x + b)`` over its output in place and, with ``pool``, returns the
2x2, stride-2, floor-mode max pool of that beside it. The kernel runs the
same float operations as ``F.relu(x + b)`` and ``F.max_pool2d(y, 2, 2)``
on the card (the add in float, rounded once; NaN kept by the ReLU; the
pool's running maximum in float), so its bits are theirs.

Bound on an H100: bytes — each element read once and written once, and
each pooled element written once: a 64-px image's 13 VGG16 convolution
outputs are 1,105,920 elements and its four pools 122,880, 4.67 MB in
bf16, so a 1,024-image block is 4.78 GB, ~1.43 ms at 3.35 TB/s.

:func:`bias_relu_pool` takes a channels-last contiguous (N, C, H, W)
tensor, float32 or bfloat16, with C a multiple of 4 (float32) or 8
(bfloat16), and the bias in its dtype, and pools only where there are two
rows and two columns; it refuses anything else on every device. CUDA
tensors launch the kernel (counted in ``bias_relu_pool.launches``); CPU
tensors take the plain version. It never falls back: a failed build or
launch raises.

The tower counts its convolution outputs by route in :data:`tower_counts`
under :data:`TOWER_COUNTERS` (``backbones.Tower``); a streamed search
reports what its featurisation added (``ops/knn._stream_search``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LANES = {torch.float32: 4, torch.bfloat16: 8}  # channels in 16 bytes

# the tower's ReLU-following convolution outputs whose bias and ReLU ran
# in the kernel, and those that went through the PyTorch ops
TOWER_COUNTERS = ("tower_epilogue_kernel_convs",
                  "tower_epilogue_plain_convs")
tower_counts = dict.fromkeys(TOWER_COUNTERS, 0)


def bias_relu_pool_plain(x: torch.Tensor, bias: torch.Tensor, pool: bool
                         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(F.relu(x + b), F.max_pool2d(that, 2, 2) or None)``: the PyTorch
    ops the kernel takes the place of."""
    y = F.relu(x + bias.view(1, -1, 1, 1))
    return y, F.max_pool2d(y, 2, 2) if pool else None


def _check(x: torch.Tensor, bias: torch.Tensor, pool: bool) -> None:
    """Raise unless ``x`` and ``bias`` are what the kernel takes (and,
    with ``pool``, what ``F.max_pool2d(x, 2, 2)`` takes: two rows and two
    columns at least)."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"bias_relu_pool takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"bias_relu_pool takes a channels-last contiguous "
                         f"(N, C, H, W) tensor, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    c = x.shape[1]
    if c % _LANES[x.dtype]:
        raise ValueError(f"bias_relu_pool takes {x.dtype} channels in "
                         f"multiples of {_LANES[x.dtype]}, got {c}")
    if (bias.shape != (c,) or bias.dtype != x.dtype
            or bias.device != x.device or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous ({c},) {x.dtype} "
                         f"tensor on {x.device}, got {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    if pool and min(x.shape[2:]) < 2:
        raise ValueError(f"a 2x2 pool needs two rows and two columns, got "
                         f"{tuple(x.shape[2:])}")


def _library():
    """The loaded ``csrc/bias_relu_pool.cu`` with its entry typed."""
    from ganleaks_tpu_torch.ops.cuda_build import load_library

    lib = load_library("bias_relu_pool")
    if not getattr(lib, "_ganleaks_typed", False):
        lib.bias_relu_pool_launch.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p])
        lib.bias_relu_pool_launch.restype = ctypes.c_int
        lib._ganleaks_typed = True
    return lib


def _launch(x: torch.Tensor, bias: torch.Tensor, pool: bool
            ) -> torch.Tensor | None:
    """One launch on CUDA tensors that :func:`_check` passed: ``relu(x +
    b)`` into ``x``; returns the pooled tensor (channels last) or None."""
    if x.device.type != "cuda":
        raise ValueError(f"the bias_relu_pool kernel runs on CUDA tensors, "
                         f"got {x.device}")
    n, c, h, w = x.shape
    pooled = torch.empty((n, c, h // 2, w // 2), dtype=x.dtype,
                         device=x.device,
                         memory_format=torch.channels_last) if pool else None
    if x.numel() == 0:
        return pooled
    for t in (x, bias) if pooled is None else (x, bias, pooled):
        if t.data_ptr() % 16:
            raise ValueError("bias_relu_pool's tensors must start on 16 "
                             "bytes")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().bias_relu_pool_launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), bias.data_ptr(), n, h, w, c,
            None if pooled is None else pooled.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bias_relu_pool kernel launch failed with CUDA "
                           f"error {err} (N={n}, C={c}, H={h}, W={w}, "
                           f"{x.dtype}, pool={pool})")
    bias_relu_pool.launches += 1
    return pooled


def bias_relu_pool(x: torch.Tensor, bias: torch.Tensor, pool: bool
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(relu(x + b), its 2x2 max pool or None)`` of one convolution
    output ``x`` (N, C, H, W), channels last and contiguous, and its
    ``bias`` (C,) in ``x``'s dtype. On CUDA the kernel writes ``relu(x +
    b)`` into ``x`` itself and returns ``x``; on the CPU the plain version
    returns new tensors. Anything else raises."""
    _check(x, bias, pool)
    if x.device.type == "cpu":
        return bias_relu_pool_plain(x, bias, pool)
    return x, _launch(x, bias, pool)


bias_relu_pool.launches = 0
