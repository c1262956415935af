"""Checkpointing: atomic, asynchronous, retention-managed (the port of
``repro.checkpoint.checkpointer``, in the same on-disk format).

Layout:  <dir>/step_<N>/
           meta.msgpack.zlib — step, codec, sorted path keys, a description
                               of the tree, shapes and dtypes
           arrays.npz        — the leaves as "{i:06d}" entries in sorted
                               path-key order

Path keys join dict keys with "/" (``params/blocks/attn/wq``,
``opt/step``), as the reference's ``tree_flatten_with_path`` writes them,
so a checkpoint written by either package restores in the other. The
manifest is MessagePack (``msgpack_lite``, the subset the manifest uses)
compressed with stdlib zlib; a manifest compressed with zstd
(``meta.msgpack.zst``, written by the reference where ``zstandard`` is
installed) raises a clear error. numpy has no bfloat16: a bfloat16 leaf
is written as its 16-bit patterns, an ``|V2`` entry of the npz with
"bfloat16" in the manifest's ``dtypes``, as the reference's ``np.savez``
of an ``ml_dtypes`` bfloat16 array writes it; ``restore`` turns such an
entry (``|V2`` or uint16) back into a ``torch.bfloat16`` tensor, bit for
bit.

Atomicity: everything is written into ``<dir>/.tmp_<N>`` and
``os.replace``d into place, so a crash mid-save never corrupts the latest
checkpoint and restore never sees a partial step.

Async: ``save()`` copies the leaves to host numpy synchronously (the
training step updates parameters in place, so the snapshot must be a copy),
then writes on a background thread; ``wait()`` drains.

Elastic restore: checkpoints hold full logical arrays keyed by tree path,
so any mesh whose shards tile the dims can load any checkpoint:
``restore_placed`` restores the full arrays on the host, then places each
leaf on the caller's mesh, every rank slicing its own shard
(``sharding.shard_tree``; ``runtime.elastic.elastic_restore``).
"""
from __future__ import annotations

import os
import re
import shutil
import threading
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite
from repro_torch.tree import leaves_with_paths, map_tree

_STEP_RE = re.compile(r"^step_(\d+)$")
_META_BASENAME = "meta.msgpack"
_CODEC_EXT = {"zstd": ".zst", "zlib": ".zlib"}
_CODEC = "zlib"


def _decompress_meta(data: bytes, codec: str) -> bytes:
    if codec == "zlib":
        return zlib.decompress(data)
    if codec == "zstd":
        raise ValueError("checkpoint manifest is zstd-compressed; the port "
                         "reads only zlib manifests (re-save it without the "
                         "'zstandard' package installed)")
    raise ValueError(f"unknown checkpoint manifest codec {codec!r}")


def _find_meta(path: str) -> Tuple[str, str]:
    """→ (manifest path, codec) for a step directory, any known codec."""
    for codec, ext in _CODEC_EXT.items():
        cand = os.path.join(path, _META_BASENAME + ext)
        if os.path.exists(cand):
            return cand, codec
    raise FileNotFoundError(f"no checkpoint manifest in {path}")


_BF16 = "bfloat16"
_BF16_NPZ = np.dtype("V2")      # what np.savez writes for a bfloat16 array


def _host(leaf) -> np.ndarray:
    """A host numpy copy of a leaf (tensor, numpy array or scalar); a
    bfloat16 tensor's bits as a ``|V2`` array."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(_BF16_NPZ)
        return host.numpy()
    return np.array(leaf, copy=True)


def _dtype_name(a: np.ndarray) -> str:
    return _BF16 if a.dtype == _BF16_NPZ else str(a.dtype)


def _leaf(a: np.ndarray, dtype_name: str):
    """A restored npz entry: a bfloat16 leaf (its 16-bit patterns, ``|V2``
    or uint16) as a ``torch.bfloat16`` tensor, anything else as it is."""
    if dtype_name == _BF16 and a.dtype.itemsize == 2 and a.dtype.kind in "Vu":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return a


def _describe(tree: Any) -> str:
    """The tree's structure as the reference's treedef prints it."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({walk(tree)})"


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Future] = []
        self._lock = threading.Lock()

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False) -> Future:
        host_tree = map_tree(_host, tree)
        fut = self._pool.submit(self._write, step, host_tree)
        with self._lock:
            self._pending = [f for f in self._pending if not f.done()] + [fut]
        if blocking:
            fut.result()
        return fut

    def _write(self, step: int, host_tree):
        flat = dict(leaves_with_paths(host_tree))
        tmp = os.path.join(self.dir, f".tmp_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        ordered = {f"{i:06d}": v for i, (_, v) in enumerate(sorted(flat.items()))}
        np.savez(os.path.join(tmp, "arrays.npz"), **ordered)
        meta = {
            "step": step,
            "codec": _CODEC,
            "keys": sorted(flat.keys()),
            "treedef": _describe(host_tree),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
        }
        blob = zlib.compress(msgpack_lite.packb(meta), 6)
        with open(os.path.join(tmp, _META_BASENAME + _CODEC_EXT[_CODEC]), "wb") as f:
            f.write(blob)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._retain()
        return step

    def _retain(self):
        steps = self.list_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    def wait(self):
        with self._lock:
            pending = list(self._pending)
        for f in pending:
            f.result()

    # -- restore ---------------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: Optional[int] = None):
        """→ (step, a tree shaped like ``tree_like`` of host numpy arrays
        and, for bfloat16 leaves, CPU ``torch.bfloat16`` tensors)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        meta_path, codec = _find_meta(path)
        with open(meta_path, "rb") as f:
            meta = msgpack_lite.unpackb(_decompress_meta(f.read(), codec))
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays: Dict[str, np.ndarray] = {meta["keys"][int(k)]: z[k] for k in z.files}
        want = sorted(p for p, _ in leaves_with_paths(tree_like))
        if want != meta["keys"]:
            missing = set(meta["keys"]) ^ set(want)
            raise ValueError(f"checkpoint/model tree mismatch: {sorted(missing)[:5]}")

        def fill(t, prefix=""):
            if isinstance(t, dict):
                return {k: fill(v, f"{prefix}/{k}" if prefix else str(k))
                        for k, v in t.items()}
            return _leaf(arrays[prefix], meta["dtypes"][prefix])
        return step, fill(tree_like)

    def restore_placed(self, tree_like, placements_tree, step: Optional[int] = None):
        """Restore the full arrays, then place each leaf on a mesh: → (step,
        tree of DTensors). ``placements_tree`` matches ``tree_like`` with a
        ``(mesh, P)`` pair a leaf (``runtime.elastic.elastic_restore``
        builds it from a spec tree); each rank keeps only its own shard, on
        the mesh's device."""
        from repro_torch.sharding.specs import place
        step, host = self.restore(tree_like, step)
        return step, map_tree(lambda a, mp: place(a, mp[1], mp[0]), host,
                              placements_tree)
