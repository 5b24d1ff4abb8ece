"""The LPIPS tap epilogue in one pass: the hand-written CUDA kernel
``csrc/tap_epilogue.cu`` and its plain PyTorch version.

Replaces ``ganleaks_tpu/ops/lpips/epilogue_pallas.py::tap_epilogue``. For
one raw VGG tap of shape (N, P, C) or (N, H, W, C) — read through its
strides, so the tower's channels-last ``permute`` views go in without a
copy — it computes per (image, position)

    phi = x / (sqrt(sum_c x^2) + 1e-10) * scale,

rounds phi to the embed dtype, then int8-quantises it
(:func:`~ganleaks_tpu_torch.ops.distance.quantize_int8`) or casts it to the
output dtype, and returns the part with the per-image float32 sum of the
squared rounded values (taken before the int8 step; summed in float64 and
rounded once, so the kernel's and the plain version's agree to one unit in
the last place whatever their order). Parts keep the tap's (P, C)
channels-last layout: no TPU lane packing.

The channel sum has one fixed order in both versions, which is also the
order XLA's CPU backend uses for 64..1024 channels: each 32-channel chunk
summed left to right, then the chunk sums left to right
(:func:`channel_sumsq`). With correctly rounded sqrt and division and the
op order above, the kernel's parts equal the plain version's bit for bit,
and the plain version's equal the JAX package's.

Bound on an H100: bytes — one read of the tap and one write of the part
per element (a 2,048-image block of the five 64-px VGG16 taps is ~3.07 GB
in bf16 -> int8, ~0.92 ms at 3.35 TB/s; ~8.2 GB in float32, ~2.4 ms).
The kernel reaches the same bits as the plain version through exact
bit-level identities in place of the slow conversions; its header lists
them and ``tests/test_torch_epilogue_bits.py`` emulates each one.

:func:`tap_epilogue` launches the kernel for CUDA tensors (counted in
``tap_epilogue.launches``) and takes the plain version only for tensors on
the CPU; a failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

EPS_NORM = 1e-10  # util.normalize_tensor eps (util/util.py:70)
CHUNK = 32        # channels per chunk of the channel sum

_IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _seq_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis strictly left to right."""
    acc = a[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i]
    return acc


def channel_sumsq(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of squares over the last axis in the epilogue's order:
    squares, then each 32-channel chunk (zero-padded) left to right, then
    the chunk sums left to right; up to 32 channels, left to right."""
    sq = x * x
    c = x.shape[-1]
    if c <= CHUNK:
        return _seq_sum(sq)
    pad = (-c) % CHUNK
    if pad:
        sq = torch.nn.functional.pad(sq, (0, pad))
    return _seq_sum(_seq_sum(sq.unflatten(-1, (-1, CHUNK))))


def tap_phi(fl: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x / (sqrt(sum_c x^2) + eps) * scale`` in float32, channels last."""
    x = fl.float()
    norm = torch.sqrt(channel_sumsq(x)).unsqueeze(-1)
    return x / (norm + EPS_NORM) * scale


def _as_scale(scale, c: int, device: torch.device) -> torch.Tensor:
    if not isinstance(scale, torch.Tensor):
        scale = torch.from_numpy(np.asarray(scale, np.float32))
    if scale.shape != (c,):
        raise ValueError(f"scale must have shape ({c},), got "
                         f"{tuple(scale.shape)}")
    return scale.to(device=device, dtype=torch.float32).contiguous()


def tap_epilogue_plain(fl: torch.Tensor, scale, *, embed_dtype: torch.dtype,
                       out_dtype: torch.dtype,
                       quant_bound: float | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (part (N, P, C), rn (N,) float32); the part
    is int8 when ``quant_bound`` is set, else ``out_dtype``."""
    from ganleaks_tpu_torch.ops.distance import quantize_int8

    n, c = fl.shape[0], fl.shape[-1]
    phi = tap_phi(fl.reshape(n, -1, c), _as_scale(scale, c, fl.device))
    b = phi.to(embed_dtype)
    rn = torch.sum(torch.square(b.double()), dim=(1, 2)).float()
    out = quantize_int8(b, quant_bound) if quant_bound is not None \
        else b.to(out_dtype)
    return out, rn


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``tap_epilogue_launch``'s C signature on a loaded library."""
    if not getattr(lib, "_ganleaks_typed", False):
        lib.tap_epilogue_launch.argtypes = (
            [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_float, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_void_p])
        lib.tap_epilogue_launch.restype = ctypes.c_int
        lib._ganleaks_typed = True
    return lib


def _library():
    from ganleaks_tpu_torch.ops.cuda_build import load_library

    return bind(load_library("tap_epilogue"))


def launch_on(lib: ctypes.CDLL, fl4: torch.Tensor, sc: torch.Tensor,
              embed_dtype: torch.dtype, qscale: float, out: torch.Tensor,
              rn: torch.Tensor) -> int:
    """One launch of ``lib``'s kernel on CUDA tensors already checked by
    :func:`tap_epilogue`; returns the CUDA error code (0 on success)."""
    n, h, w, c = fl4.shape
    strides = (ctypes.c_int64 * 4)(*fl4.stride())
    with torch.cuda.device(fl4.device):
        stream = torch.cuda.current_stream(fl4.device).cuda_stream
        return lib.tap_epilogue_launch(
            _IN_CODES[fl4.dtype], fl4.data_ptr(), n, h, w, c,
            ctypes.cast(strides, ctypes.c_void_p),
            sc.data_ptr(), int(embed_dtype == torch.bfloat16),
            _OUT_CODES[out.dtype], qscale, out.data_ptr(), out.stride(0),
            rn.data_ptr(), stream)


def tap_epilogue(fl: torch.Tensor, scale, *, embed_dtype: torch.dtype,
                 out_dtype: torch.dtype, quant_bound: float | None = None,
                 out: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused epilogue of one raw tap ``fl`` (N, P, C) or (N, H, W, C),
    float32 or bfloat16, any strides. Returns (part (N, P, C), rn (N,)
    float32).

    ``embed_dtype``: float32 or bfloat16, the rounding of phi;
    ``out_dtype``: float32 or bfloat16, or int8 via ``quant_bound``
    (the part's static elementwise bound). ``out``: an (N, P*C) tensor of
    the part's dtype whose rows are contiguous (any row stride, e.g. a
    column slice of the engine's (N, K) embedding buffer); the part is
    written there and returned as its (N, P, C) view."""
    if fl.dim() not in (3, 4):
        raise ValueError(f"expected a tap (N, P, C) or (N, H, W, C), got "
                         f"{tuple(fl.shape)}")
    if fl.dtype not in _IN_CODES:
        raise ValueError(f"tap dtype must be float32 or bfloat16, got "
                         f"{fl.dtype}")
    if embed_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"embed_dtype must be float32 or bfloat16, got "
                         f"{embed_dtype}")
    res_dtype = torch.int8 if quant_bound is not None else out_dtype
    if res_dtype not in _OUT_CODES:
        raise ValueError(f"unsupported output dtype {res_dtype}")
    fl4 = fl.unsqueeze(2) if fl.dim() == 3 else fl
    n, h, w, c = fl4.shape
    p = h * w
    if out is None:
        out = torch.empty((n, p * c), dtype=res_dtype, device=fl.device)
    elif (out.shape != (n, p * c) or out.dtype != res_dtype
          or out.device != fl.device or (p * c > 1 and out.stride(1) != 1)):
        raise ValueError(f"out must be ({n}, {p * c}) {res_dtype} on "
                         f"{fl.device} with contiguous rows, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    if fl.device.type == "cpu":
        part, rn = tap_epilogue_plain(fl, scale, embed_dtype=embed_dtype,
                                      out_dtype=out_dtype,
                                      quant_bound=quant_bound)
        out.copy_(part.reshape(n, p * c))
        return out.unflatten(1, (p, c)), rn
    if fl.device.type != "cuda":
        raise ValueError(f"unsupported device {fl.device}")
    if n == 0 or p * c == 0:
        return out.unflatten(1, (p, c)), torch.zeros(
            n, dtype=torch.float32, device=fl.device)
    sc = _as_scale(scale, c, fl.device)
    rn = torch.empty(n, dtype=torch.float32, device=fl.device)
    qscale = 127.0 / quant_bound if quant_bound is not None else 0.0
    err = launch_on(_library(), fl4, sc, embed_dtype, qscale, out, rn)
    if err != 0:
        raise RuntimeError(f"tap_epilogue kernel launch failed with CUDA "
                           f"error {err} (N={n}, P={p}, C={c}, {fl.dtype} "
                           f"-> {res_dtype})")
    tap_epilogue.launches += 1
    return out.unflatten(1, (p, c)), rn


tap_epilogue.launches = 0
