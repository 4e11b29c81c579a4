"""Checkpointing: sharded, compressed, atomic, retention-managed.

The port's copy of ``repro.checkpoint.manager``, with the same layout on
disk:

    <dir>/step_<n>/manifest.json        tree structure + leaf metadata
    <dir>/step_<n>/shard_<h>.bin.zst    compressed leaf payloads
    <dir>/LATEST                        committed step marker (atomic rename)

Writes go to ``step_<n>.tmp`` and are renamed only after every shard and the
manifest are flushed, so a crash mid-save never corrupts the previous
checkpoint.  Payloads are zstd-compressed where ``zstandard`` is installed
and zlib-compressed otherwise; the manifest records the codec, so either
side reads both.  A leaf is a tensor (any device; bf16 stored as its raw
16-bit words under the dtype name ``bfloat16``, as the reference's
ml_dtypes arrays are) or a numpy array; paths are ``jax.tree_util.keystr``'s
(:func:`repro_torch.tree.leaves_with_path`).  Restored leaves are tensors,
on the device of the template's leaf where that is a tensor.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree

try:
    import zstandard
except ImportError:          # pragma: no cover - depends on environment
    zstandard = None         # fall back to stdlib zlib (codec recorded in
                             # the manifest, so either side can read both)

SHARD_LEAVES = 64  # leaves per shard file


def _host_array(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array (a copy for a tensor); bf16 as its raw
    16-bit words, a uint16 array."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def _dtype_name(leaf: Any, arr: np.ndarray) -> str:
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _from_bytes(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.frombuffer(raw, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(
        np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 compression_level: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.level = compression_level

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[dict] = None) -> str:
        leaves = tree.leaves_with_path(state)
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        codec = "zstd" if zstandard is not None else "zlib"
        manifest: dict[str, Any] = {"step": step, "extra": extra or {},
                                    "codec": codec, "leaves": []}
        if zstandard is not None:
            compress = zstandard.ZstdCompressor(level=self.level).compress
        else:
            # zstd accepts levels up to 22; zlib caps at 9.
            compress = lambda b: zlib.compress(b, min(self.level, 9))  # noqa: E731
        shard_id, buf, buf_items = 0, [], []

        def flush():
            nonlocal shard_id, buf, buf_items
            if not buf:
                return
            with open(tmp / f"shard_{shard_id}.bin.zst", "wb") as f:
                f.write(compress(b"".join(buf)))
            offset = 0
            for item, nbytes in buf_items:
                item["shard"] = shard_id
                item["offset"] = offset
                item["nbytes"] = nbytes
                offset += nbytes
                manifest["leaves"].append(item)
            shard_id += 1
            buf, buf_items = [], []

        for path, leaf in leaves:
            arr = _host_array(leaf)
            raw = arr.tobytes()
            buf.append(raw)
            buf_items.append(({"path": path, "dtype": _dtype_name(leaf, arr),
                               "shape": list(arr.shape)}, len(raw)))
            if len(buf_items) >= SHARD_LEAVES:
                flush()
        flush()

        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(self.dir / "LATEST.tmp", "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.rename(self.dir / "LATEST.tmp", self.dir / "LATEST")
        self._gc()
        return str(final)

    # -- restore ----------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        marker = self.dir / "LATEST"
        if not marker.exists():
            return None
        return int(marker.read_text().strip())

    def restore(self, target: Any,
                step: Optional[int] = None) -> tuple[Any, dict]:
        """Restore into the structure of ``target`` (a tree template)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        base = self.dir / f"step_{step}"
        with open(base / "manifest.json") as f:
            manifest = json.load(f)
        codec = manifest.get("codec", "zstd")
        if codec == "zstd":
            if zstandard is None:
                raise RuntimeError(
                    "checkpoint was written with zstd but zstandard is not "
                    "installed")
            decompress = zstandard.ZstdDecompressor().decompress
        else:
            decompress = zlib.decompress
        shards: dict[int, bytes] = {}

        def shard_bytes(sid: int) -> bytes:
            if sid not in shards:
                with open(base / f"shard_{sid}.bin.zst", "rb") as f:
                    shards[sid] = decompress(f.read())
            return shards[sid]

        by_path = {item["path"]: item for item in manifest["leaves"]}
        out = []
        for path, leaf in tree.leaves_with_path(target):
            item = by_path.get(path)
            if item is None:
                raise KeyError(f"checkpoint missing leaf {path}")
            raw = shard_bytes(item["shard"])[
                item["offset"]: item["offset"] + item["nbytes"]]
            t = _from_bytes(raw, item["dtype"], item["shape"])
            out.append(t.to(leaf.device) if torch.is_tensor(leaf) else t)
        _, treedef = tree.flatten(target)
        return tree.unflatten(treedef, out), manifest["extra"]

    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
