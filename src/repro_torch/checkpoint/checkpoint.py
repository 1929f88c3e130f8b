"""Atomic checkpoints with keep-k GC, in the JAX package's on-disk format.

The port of the JAX package's ``checkpoint/checkpoint.py``.  Layout per
step, the same bytes either package writes, so each restores the other's:

  <dir>/step_<N>.tmp/       — staging (crash-safe: never half-visible)
  <dir>/step_<N>/
    manifest.json           — step, each leaf's shape and dtype, extras
    arrays.npz              — one entry per leaf, keyed by its tree path
                              joined with "/" (``params/embed/tok``):
                              np.savez's stored zip of .npy members

npz has no bfloat16: a bf16 leaf is stored as its uint16 bits, the
manifest records ``bfloat16``, and the restore views the bits back
(``torch.from_numpy(...).view(torch.bfloat16)``: no ``ml_dtypes``).
A tree is nested dicts of tensors (0-d ones included).

A checkpoint of a full-width model and its AdamW state is tens of GB, so
both directions stream one leaf at a time (the host holds one leaf, not
the tree): a CUDA leaf goes through a pinned staging buffer (a pageable
copy runs at a fraction of the link's rate), and the restore reads a
stored member's bytes straight into it while a second thread checks the
zip's CRC32 of what was read so far.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.prepare import resolve_device

_CHUNK = 1 << 26
# The name and extra-field lengths among a zip local header's fields
# (``zipfile.structFileHeader``).
_FH_NAME_LEN, _FH_EXTRA_LEN = 10, 11


def _flatten_with_paths(tree, prefix=()) -> Dict[str, Any]:
    """{"/"-joined key path: leaf} in JAX's flattening order (sorted
    keys)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def _unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node, parts = tree, key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return tree


class _Staging:
    """The host side of a CUDA leaf: the first bytes of one pinned buffer,
    grown to the largest leaf (each copy through it is synchronous, so the
    next leaf may reuse it)."""

    def __init__(self):
        self.buf = None

    def take(self, n: int) -> torch.Tensor:
        if self.buf is None or self.buf.numel() < n:
            self.buf = None
            self.buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return self.buf[:n]


def _bytes_view(a: np.ndarray) -> memoryview:
    return memoryview(a.reshape(-1).view(np.uint8))


def save_checkpoint(directory: str, step: int, tree: Any,
                    extras: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` under ``directory`` (staged in
    ``step_<N>.tmp``, then renamed; an existing step is kept), then remove
    all but the newest ``keep`` steps.  Returns the step's path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves, stage = {}, _Staging()
    with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                         zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, leaf in _flatten_with_paths(tree).items():
            t = torch.as_tensor(leaf).detach()
            h = (stage.take(t.numel() * t.element_size()).view(t.dtype)
                 .view(t.shape).copy_(t) if t.device.type == "cuda"
                 else t.contiguous())
            if t.dtype == torch.bfloat16:
                a, name = h.view(torch.int16).numpy().view(np.uint16), \
                    "bfloat16"
            else:
                a = h.numpy()
                name = a.dtype.name
            leaves[key] = {"shape": list(a.shape), "dtype": name}
            # np.save's bytes (a version 1.0 header, then the data).
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(a))
                f.write(_bytes_view(a))
    manifest = {"step": step, "leaves": leaves, "extras": extras or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, final)

    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for old in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, old))
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step under ``directory`` (``.tmp`` staging
    ignored), or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


_HEADER_READERS = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}


def _read_member(raw, info: zipfile.ZipInfo, stage: _Staging, device,
                 pool: ThreadPoolExecutor) -> np.ndarray:
    """A stored .npy member (C order, a version 1 or 2 header: what
    np.savez and ``save_checkpoint`` write) read straight into the staging
    buffer (or a fresh array on the CPU), its CRC32 computed on ``pool``
    chunk by chunk while the next chunk is read.  Raises ``ValueError``
    for any other member and on a checksum or size mismatch."""
    raw.seek(info.header_offset)
    fields = struct.unpack(zipfile.structFileHeader,
                           raw.read(zipfile.sizeFileHeader))
    start = (info.header_offset + zipfile.sizeFileHeader
             + fields[_FH_NAME_LEN] + fields[_FH_EXTRA_LEN])
    raw.seek(start)
    version = np.lib.format.read_magic(raw)
    if info.compress_type != zipfile.ZIP_STORED or \
            version not in _HEADER_READERS:
        raise ValueError(f"{info.filename}: not a stored .npy of version "
                         f"1 or 2")
    shape, fortran, dtype = _HEADER_READERS[version](raw)
    if fortran or dtype.hasobject:
        raise ValueError(f"{info.filename}: Fortran order or objects")
    head = raw.tell() - start
    raw.seek(start)
    crc = zlib.crc32(raw.read(head))
    n = int(np.prod(shape)) * dtype.itemsize
    a = (stage.take(n).numpy().view(dtype).reshape(shape)
         if device.type == "cuda" else np.empty(shape, dtype))
    mv, pending = _bytes_view(a), None
    for off in range(0, len(mv), _CHUNK):
        part = mv[off:off + _CHUNK]
        got = 0
        while got < len(part):
            k = raw.readinto(part[got:])
            if not k:
                raise ValueError(f"{info.filename}: truncated")
            got += k
        if pending is not None:
            crc = pending.result()
        pending = pool.submit(zlib.crc32, part, crc)
    if pending is not None:
        crc = pending.result()
    if crc != info.CRC or head + len(mv) != info.file_size:
        raise ValueError(f"{info.filename}: CRC or size mismatch")
    return a


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None, device=None):
    """Restore into the structure of ``template`` (nested dicts whose
    leaves have ``shape`` and ``dtype``: tensors, meta tensors among them)
    as fresh tensors on ``device`` (default ``"cuda"``; raises without a
    GPU).  The newest step unless ``step`` is given.  Raises
    ``ValueError`` when a leaf's shape or dtype is not the template's, or
    its bytes fail the zip's CRC32.

    Returns (tree, extras, step)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out, stage = {}, _Staging()
    npz = os.path.join(path, "arrays.npz")
    with zipfile.ZipFile(npz) as zf, open(npz, "rb", buffering=0) as raw, \
            ThreadPoolExecutor(1) as pool:
        for key, want in _flatten_with_paths(template).items():
            a = _read_member(raw, zf.getinfo(key + ".npy"), stage, dev,
                             pool)
            bf16 = manifest["leaves"][key]["dtype"] == "bfloat16"
            t = torch.from_numpy(a.view(np.int16) if bf16 else a)
            if bf16:
                t = t.view(torch.bfloat16)
            if dev.type == "cuda":
                t = t.to(dev, copy=True)
            if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
                raise ValueError(f"{key}: {tuple(t.shape)} {t.dtype}, "
                                 f"template {tuple(want.shape)} "
                                 f"{want.dtype}")
            out[key] = t
    return _unflatten(out), manifest["extras"], step
