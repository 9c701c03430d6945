"""Atomic, restartable step checkpoints in the JAX package's layout
(the port's own copy of ``repro.train.checkpoint``).

Layout:  ``<dir>/step_<N:08d>/{manifest.json, shard_0.npz}``, the leaves
``leaf_<i>`` in ``jax.tree_util.tree_flatten``'s order (dict keys sorted:
``optimizer.tree_leaves``).  A save writes into ``step_<N>.tmp0`` and moves
it with ``os.replace``, so a crash mid-save never leaves a
``step_<N>`` without its manifest; :func:`latest_step` reads only complete
directories.  One host: shard 0 holds every leaf.

bf16 leaves (the default AdamW moments) are stored as the JAX package
stores them: NumPy has no bf16, and ``np.savez`` of a JAX bf16 array
writes its two-byte elements as raw void (``V2``) records, the bf16 bits.
The port writes and reads those bits through ``uint16`` (the card's host
needs no ``ml_dtypes``).  The archive is written one leaf at a time (the
next leaf's copy to the host overlapping this one's write), so a save
holds two leaves on the host, not the state; a restore reads each stored
member straight from its offset in the archive into its array, the
archive's CRC left unchecked (``np.load``, and so the JAX package, checks
it).
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import struct
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.train.optimizer import tree_leaves, tree_map

_BF16_BITS = np.dtype("V2")


def _host(x) -> np.ndarray:
    """A leaf as the NumPy array the JAX package would write."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            bits = x.view(torch.int16).cpu().numpy().view(np.uint16)
            return bits.view(_BF16_BITS)
        return x.cpu().numpy()
    return np.asarray(x)


def _leaf(arr: np.ndarray, like) -> torch.Tensor | np.ndarray:
    """A stored leaf as ``like``'s type and device."""
    if not isinstance(like, torch.Tensor):
        return arr
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr)
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "Vu":
            raise ValueError(f"a bf16 leaf stored as {arr.dtype}")
        bits = arr.view(np.uint16).view(np.int16)
        out = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        out = torch.from_numpy(arr).to(like.dtype)
    if tuple(out.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {tuple(out.shape)} against "
                         f"{tuple(like.shape)}")
    return out.to(like.device)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    leaves = tree_leaves(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp0"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(os.path.join(tmp, "shard_0.npz"), mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(_host, leaves[0]) if leaves else None
        for i in range(len(leaves)):
            arr = nxt.result()
            if i + 1 < len(leaves):
                nxt = pool.submit(_host, leaves[i + 1])
            with zf.open(f"leaf_{i}.npy", mode="w", force_zip64=True) as f:
                _write_npy(f, arr)
    manifest = {"step": step, "n_leaves": len(leaves), "n_shards": 1}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)
    return final


_CHUNK = 1 << 26


def _write_npy(f, arr: np.ndarray) -> None:
    """``arr`` in the ``.npy`` format (version 1.0, as ``np.savez`` writes
    it), its bytes written from the array's memory in large slices."""
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    np.lib.format.write_array_header_1_0(
        f, np.lib.format.header_data_from_array_1_0(arr))
    buf = memoryview(arr.reshape(-1).view(np.uint8))
    for off in range(0, len(buf), _CHUNK):
        f.write(buf[off:off + _CHUNK])


def _read_members(path: str, names: list[str]) -> dict:
    """The arrays of the stored ``.npy`` members ``names`` of the archive
    at ``path``, each read from its offset with ``np.fromfile``; members
    that are compressed (not written by either package) through
    ``np.load``."""
    with zipfile.ZipFile(path) as zf:
        infos = {info.filename: info for info in zf.infolist()}
    out = {}
    with open(path, "rb") as f:
        for name in names:
            info = infos[f"{name}.npy"]
            if info.compress_type != zipfile.ZIP_STORED:
                with np.load(path) as data:
                    out[name] = data[name]
                continue
            f.seek(info.header_offset)
            local = f.read(30)
            n_name, n_extra = struct.unpack("<HH", local[26:30])
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            count = int(np.prod(shape, dtype=np.int64))
            arr = np.fromfile(f, dtype=dtype, count=count)
            if arr.size != count:
                raise ValueError(f"{path}: {name} is cut short")
            out[name] = (arr.reshape(shape[::-1]).T if fortran
                         else arr.reshape(shape))
    return out


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (values replaced; each leaf
    in ``like``'s type, on its device)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    n = len(tree_leaves(like))
    if manifest["n_leaves"] != n:
        raise ValueError(f"checkpoint/tree mismatch: {manifest['n_leaves']} "
                         f"leaves against {n}")
    index = {id(x): i for i, x in enumerate(tree_leaves(like))}
    data = _read_members(os.path.join(path, "shard_0.npz"),
                         [f"leaf_{i}" for i in range(n)])
    return tree_map(lambda x: _leaf(data.pop(f"leaf_{index[id(x)]}"), x),
                    like)
