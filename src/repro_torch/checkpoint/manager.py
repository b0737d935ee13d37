"""Async, atomic checkpointing with JAX's on-disk layout (port of
`repro/checkpoint/manager.py`).

Layout, byte for byte the JAX package's, so each package reads the
other's checkpoints:
    <dir>/step_000000100/
        manifest.json       {"step", "treedef", "leaves": [{"shape", "dtype"}]}
        leaf_00000.npy ...  one file per tree leaf, in JAX's leaf order
                            (dict keys sorted, NamedTuple fields in order)
    <dir>/LATEST            atomic pointer file

A leaf whose dtype numpy lacks (bfloat16, the fp8 types) is stored as its
raw bytes (a flat uint8 array) beside its dtype's name in the manifest, as
JAX's `_to_disk` stores it, and read back through torch (JAX reads it
through `ml_dtypes`).

Properties (as in JAX):
  - atomicity: a step is staged under `.tmp_step_*` and renamed when
    complete; a crash mid-save never corrupts LATEST;
  - async, double-buffered: the device-to-host copy happens in `save()`
    (the caller may update its tensors in place the moment it returns: the
    copy is the staging buffer); file IO runs on a background thread; up
    to `max_inflight` saves are in flight, and a save beyond them joins the
    oldest;
  - typed failure: a failed write is re-raised as `CheckpointError` from
    the next `save()` / `wait()` / `restore()`, never from the thread;
  - LATEST is monotonic under out-of-order completion;
  - restore onto any device: leaves are stored whole (`restore(...,
    device=)`; `runtime/elastic.py` restores onto a new mesh);
  - GC: `keep_last_k` bounds the disk.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

from ..core import tree as tree_util


class CheckpointError(RuntimeError):
    """An async checkpoint write failed.  Raised from the save() / wait()
    AFTER the failure (never from the background thread), carrying the
    failed step; the original exception rides as `cause`."""

    def __init__(self, step: int, cause: BaseException):
        super().__init__(f"checkpoint save for step {step} failed: {cause!r}")
        self.step = step
        self.cause = cause


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


# torch dtypes numpy cannot hold: stored as raw bytes, named in the manifest
_RAW_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)


def _to_host(x) -> np.ndarray:
    """A leaf's host copy in the form it is written (a new buffer: the
    caller may update `x` in place once save() returns)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype in _RAW_DTYPES:
            return t.contiguous().reshape(-1).view(torch.uint8).numpy(), t
        return t.numpy(), t
    a = np.array(x)
    return a, a


def _from_disk(raw: np.ndarray, dtype_name: str, shape) -> torch.Tensor:
    if raw.dtype == np.uint8 and dtype_name != "uint8":
        if raw.size == 0:
            return torch.empty(shape, dtype=getattr(torch, dtype_name))
        return torch.frombuffer(bytearray(raw.tobytes()),
                                dtype=getattr(torch, dtype_name)).reshape(shape)
    return torch.from_numpy(np.ascontiguousarray(raw).reshape(shape))


class CheckpointManager:
    def __init__(self, directory, keep_last_k: int = 3, max_inflight: int = 2):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last_k = keep_last_k
        self.max_inflight = max(1, max_inflight)  # 2 = double buffering
        self._inflight: List[threading.Thread] = []
        self._errors: List[CheckpointError] = []
        self._lock = threading.Lock()  # _errors + LATEST / _gc serialization
        self._latest_written = self._read_latest_pointer()

    def _read_latest_pointer(self) -> int:
        f = self.dir / "LATEST"
        try:
            return int(f.read_text().strip()) if f.exists() else -1
        except ValueError:
            return -1

    def _raise_pending(self):
        with self._lock:
            if not self._errors:
                return
            err, self._errors = self._errors[0], []
        raise err

    def _reap(self):
        self._inflight = [t for t in self._inflight if t.is_alive()]

    # ----------------- save -----------------

    def save(self, step: int, tree: Any, *, blocking: bool = False):
        """Snapshot `tree` (tensors, numpy arrays, numbers) for `step`.

        The host copy is taken now; the files are written on a background
        thread (inline with `blocking`).  A previously failed write
        surfaces here as `CheckpointError` before the new save starts."""
        self._reap()
        self._raise_pending()
        staged = [_to_host(x) for x in tree_util.leaves(tree)]
        host_leaves = [s[0] for s in staged]
        manifest = {
            "step": step,
            "treedef": tree_util.structure(tree),
            "leaves": [{"shape": list(t.shape),
                        "dtype": _dtype_name(t.dtype) if isinstance(t, torch.Tensor)
                        else str(t.dtype)} for _, t in staged],
        }
        del staged

        def _write():
            try:
                tmp = self.dir / f".tmp_step_{step:09d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                self._write_leaves(tmp, host_leaves)
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                final = self.dir / f"step_{step:09d}"
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)
                with self._lock:
                    # monotonic LATEST: concurrent saves may finish out of
                    # order; never point at an older step than published
                    if step > self._latest_written:
                        latest_tmp = self.dir / ".LATEST.tmp"
                        latest_tmp.write_text(str(step))
                        os.replace(latest_tmp, self.dir / "LATEST")
                        self._latest_written = step
                    self._gc()
            except BaseException as e:  # noqa: BLE001 -- surfaced next call
                with self._lock:
                    self._errors.append(CheckpointError(step, e))

        if blocking:
            _write()
            self._raise_pending()
        else:
            if len(self._inflight) >= self.max_inflight:
                self._inflight.pop(0).join()  # the oldest buffer drains first
                self._raise_pending()
            t = threading.Thread(target=_write, daemon=True)
            self._inflight.append(t)
            t.start()

    def _write_leaves(self, tmp: Path, host_leaves) -> None:
        """One file per leaf (tests replace this to gate or fail the IO)."""
        for i, a in enumerate(host_leaves):
            with open(tmp / f"leaf_{i:05d}.npy", "wb") as f:
                np.save(f, a)
                f.flush()
                os.fsync(f.fileno())

    def wait(self):
        """Join every in-flight write; re-raise the first pending failure."""
        while self._inflight:
            self._inflight.pop(0).join()
        self._raise_pending()

    @property
    def inflight_saves(self) -> int:
        self._reap()
        return len(self._inflight)

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_last_k]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ----------------- restore -----------------

    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if (p / "manifest.json").exists()]

    def latest_step(self) -> Optional[int]:
        f = self.dir / "LATEST"
        if f.exists():
            s = int(f.read_text().strip())
            if (self.dir / f"step_{s:09d}" / "manifest.json").exists():
                return s
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None, device=None) -> Any:
        """The latest (or `step`) checkpoint in the structure of
        `tree_like`, every leaf a tensor in its stored dtype: on `device`
        when given, else on the matching leaf's device (a "meta" or
        non-tensor leaf: the CPU)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step:09d}"
        refs = tree_util.leaves(tree_like)
        manifest = json.loads((d / "manifest.json").read_text())
        if len(manifest["leaves"]) != len(refs):
            raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, the tree "
                             f"{len(refs)}")
        out = []
        for i, (m, ref) in enumerate(zip(manifest["leaves"], refs)):
            h = _from_disk(np.load(d / f"leaf_{i:05d}.npy"), m["dtype"], m["shape"])
            ref_shape = getattr(ref, "shape", None)
            if ref_shape is not None and tuple(h.shape) != tuple(ref_shape):
                raise ValueError(f"leaf {i}: checkpoint shape {tuple(h.shape)} != expected "
                                 f"{tuple(ref_shape)}")
            dev = device
            if dev is None:
                dev = (ref.device if isinstance(ref, torch.Tensor) and ref.device.type != "meta"
                       else "cpu")
            out.append(h.to(dev))
        return tree_util.unflatten(tree_like, out)
