"""Parameter files shared with the JAX package, read and written with numpy
(and msgpack, imported where a ``.msgpack`` file is read).

* npz (``ganleaks_tpu.utils.checkpoint.save_params_npz``): one array per
  leaf of the nested parameter dict, keyed by its path joined with ``/``
  (``params/Mixed_5b/branch1x1/conv``); list entries are keyed by their
  index.
* msgpack (``flax.serialization.to_bytes``, what the JAX trainers write):
  nested maps whose array leaves are msgpack ext type 1, the packed tuple
  ``(shape, dtype name, C-order bytes)``; ext 2 is a native complex
  ``(real, imag)`` and ext 3 a numpy scalar packed like an array. Arrays
  over 1 GiB are split into ``__msgpack_chunked_array__`` maps.
"""

from __future__ import annotations

import os

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple))
             else None)
    if items is None:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def save_params_npz(path: str, params) -> None:
    """Write a nested dict (or list) of arrays as a path-keyed npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(params))


def load_params_npz(path: str) -> dict:
    """Inverse of :func:`save_params_npz`: the nested dict of arrays."""
    tree: dict = {}
    with np.load(path) as flat:
        for name in flat.files:
            parts = name.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[name]
    return tree


def _ndarray_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported; save the "
                         "parameters as float32")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(
        shape, order="C").copy()


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def load_params_msgpack(path: str) -> dict:
    """A flax ``to_bytes`` msgpack file as a nested dict of numpy arrays."""
    try:
        import msgpack
    except ImportError:
        raise ImportError(
            f"reading {path} needs the msgpack package; without it, save "
            f"the parameters as .npz (save_params_npz in either package) "
            f"and pass that file instead") from None

    def ext_hook(code: int, data: bytes):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(msgpack, data)
        if code == _EXT_COMPLEX:
            real, imag = msgpack.unpackb(data)
            return complex(real, imag)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(msgpack, data)[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


def load_variables(path: str) -> dict:
    """Parameters from an ``.npz`` (path-keyed arrays) or a flax msgpack
    file (anything else)."""
    if path.endswith(".npz"):
        return load_params_npz(path)
    return load_params_msgpack(path)
