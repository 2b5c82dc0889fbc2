"""Atomic, restart-safe checkpoint store.

Counterpart of ``repro.checkpoint.store``, with the same on-disk format:
a ``step_N`` directory of ``leaf_XXXXX.npy`` files and a
``manifest.json`` with the same keys (``step``, ``time``, ``extra``,
``leaves``: ``name``, ``file``, ``shape``, ``dtype``, ``bytes``,
``crc32``), the same leaf names and the same bytes, so a checkpoint
written by either package loads in the other.

Protocol (crash-safe at every point):
  1. write all array leaves + manifest into ``<dir>/tmp_step_N.XXXX``,
  2. fsync each file and the directory, then ``os.rename`` to
     ``<dir>/step_N`` (atomic on POSIX),
  3. GC old steps beyond ``keep``.

A checkpoint is *valid* iff its ``manifest.json`` exists and every leaf
file it lists is present with the right byte size AND the recorded CRC32
of its bytes: half-written directories are ignored by ``latest_step`` and
reaped by GC, and a bit-flipped leaf is rejected rather than restored, so
a job killed mid-write (or fed a corrupted disk) restarts from the newest
*verified* step.

Leaf names.  The reference names each leaf by its JAX tree path; this
module walks the same trees without JAX and gives the same names: dict
keys in sorted order, list and tuple indices, NamedTuple field names, and
the index of each child of a ``Factorization`` (U, s, V, iterations,
breakdown) or a ``RankEstimate``, which the reference registers as pytree
nodes with unnamed children (``"fact/0"`` is U).
``None`` holds no leaf.

Leaf bytes.  A tensor is copied to the host and saved C-contiguous, as
the reference's ``np.asarray`` of a JAX array is.  A bfloat16 tensor is
written as float32 (exact), since the reference cannot load a bfloat16
leaf: numpy saves it as raw ``<V2`` bytes, which ``np.load`` returns as
void and ``jax.device_put`` refuses.  Reading, the port takes a ``<V2``
leaf whose manifest dtype is ``bfloat16`` (what the reference writes) as
bfloat16 bit for bit.  Neither path needs ``ml_dtypes``.

Placement.  ``load_checkpoint`` puts every leaf on ``device``: by default
the CUDA card (:func:`repro_torch._device.resolve_device`, which raises
without one); the CPU only when asked.  The reference's ``sharding_fn``
has no counterpart here: on a mesh, ``runtime.Trainer`` restores the
whole state and its ``state_sharding_fn`` keeps each rank's blocks.

Fault injection: the ``checkpoint.write`` failpoint
(``repro_torch.runtime.faults``) fires at the start of the protocol and
``corrupt``-mode specs mangle leaf bytes after their CRC is recorded.

Async: ``CheckpointManager.save`` copies every tensor to the host
synchronously and runs the disk protocol on a daemon thread; ``wait()``
joins it before the next save or shutdown.
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
import tempfile
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.runtime import faults as _fp

Tree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")

# the result types the reference registers as pytree nodes, with their
# children in its flatten order (``repro.api.results``)
_NODE_FIELDS = {"Factorization": ("U", "s", "V", "iterations", "breakdown"),
                "RankEstimate": ("rank", "iterations", "eigenvalues")}


def _children(node) -> Optional[list]:
    """(key name, child) pairs of a tree node in the reference's flatten
    order, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    fields = _NODE_FIELDS.get(type(node).__name__)
    if fields is not None and hasattr(node, "method"):
        return [(str(i), getattr(node, f)) for i, f in enumerate(fields)]
    return None


def _rebuild(node, children: list):
    """``node``'s container type around new ``children`` (same order as
    :func:`_children`)."""
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, (list, tuple)):
        return type(node)(children)
    return type(node)(*children, method=node.method)


def _walk(tree: Tree, fn, path: str = ""):
    """``tree`` with every leaf replaced by ``fn(name, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    return _rebuild(tree, [_walk(x, fn, f"{path}/{k}" if path else k)
                           for k, x in kids])


def _named_leaves(tree: Tree) -> list:
    out = []
    _walk(tree, lambda name, leaf: out.append((name, leaf)))
    return out


def _to_host(x) -> np.ndarray:
    """A leaf as a C-contiguous numpy array (bfloat16 widened to float32,
    which the reference can load)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        x = x.cpu().numpy()
    return np.asarray(x, order="C")


def _host_copy(x):
    """The synchronous snapshot of an async save: tensors copied to the
    host (a CPU tensor copied too, so later in-place writes miss it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


def _leaf_parts(arr: np.ndarray) -> tuple[bytes, memoryview]:
    """One C-contiguous leaf's .npy bytes as ``np.save`` writes them, in
    two parts: the header, and the array's own buffer (not copied).  The
    CRC is computed over exactly the bytes that hit disk, header
    included."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, np.lib.format.header_data_from_array_1_0(arr))
    return buf.getvalue(), memoryview(arr).cast("B")


def _leaf_tensor(raw: bytearray, dtype: str) -> torch.Tensor:
    """The tensor a leaf's .npy bytes hold, over ``raw``'s own memory; a
    ``<V2`` leaf recorded as ``bfloat16`` (the reference's bf16 leaves) as
    bfloat16 bit for bit."""
    head = io.BytesIO(raw)
    version = np.lib.format.read_magic(head)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    shape, fortran, dt = read(head)
    arr = np.frombuffer(raw, dtype=dt, count=int(np.prod(shape)),
                        offset=head.tell())
    arr = (arr.reshape(shape[::-1]).T if fortran else arr.reshape(shape))
    if dtype == "bfloat16" and arr.dtype.kind == "V" and arr.itemsize == 2:
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, tree: Tree,
                    extra: Optional[dict] = None) -> str:
    """Synchronous atomic save. Returns the final path.

    Every leaf carries its CRC32 in the manifest; every file (leaves and
    manifest) is fsynced, and so is the checkpoint directory around the
    atomic rename — a crash at any instant leaves either the previous
    valid step or this one, never a same-size-but-truncated hybrid.
    """
    return _write_checkpoint(directory, step, tree, extra)[0]


def _write_checkpoint(directory: str, step: int, tree: Tree,
                      extra: Optional[dict] = None) -> tuple[str, bool]:
    """:func:`save_checkpoint`, and whether every leaf on disk is exactly
    the bytes its CRC was taken over: False once the ``checkpoint.write``
    failpoint was armed at a leaf, since its corrupt mode may have
    mangled the bytes after the CRC."""
    _fp.fire(_fp.CHECKPOINT_WRITE)
    exact = True
    os.makedirs(directory, exist_ok=True)
    leaves = [(name, _to_host(x)) for name, x in _named_leaves(tree)]
    tmp = tempfile.mkdtemp(prefix=f"tmp_step_{step}.", dir=directory)
    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "leaves": []}
    try:
        for i, (name, arr) in enumerate(leaves):
            fname = f"leaf_{i:05d}.npy"
            parts = _leaf_parts(arr)
            crc = zlib.crc32(parts[1], zlib.crc32(parts[0]))
            if _fp.armed(_fp.CHECKPOINT_WRITE):
                # the corrupt-mode failpoint mangles bytes *after* the CRC
                # is recorded — simulated bit-rot that _is_valid must catch
                exact = False
                parts = (_fp.corrupt(_fp.CHECKPOINT_WRITE,
                                     parts[0] + bytes(parts[1])),)
            with open(os.path.join(tmp, fname), "wb") as f:
                for part in parts:
                    f.write(part)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"].append(
                {"name": name, "file": fname, "shape": list(arr.shape),
                 "dtype": str(arr.dtype),
                 "bytes": sum(len(part) if isinstance(part, bytes)
                              else part.nbytes for part in parts),
                 "crc32": crc})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # fsync the tmp dir so its entries are durable before the rename
        # publishes them
        _fsync_dir(tmp)
        final = os.path.join(directory, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(directory)
        return final, exact
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:          # platforms without directory fds
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _is_valid(path: str, *, verify_crc: bool = True) -> bool:
    """Structural + integrity check: the manifest parses, every listed
    leaf exists at the recorded size, and (when the manifest records one)
    the leaf bytes hash to the recorded CRC32."""
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for leaf in manifest["leaves"]:
            fp = os.path.join(path, leaf["file"])
            if not os.path.exists(fp) or os.path.getsize(fp) != leaf["bytes"]:
                return False
            if verify_crc and "crc32" in leaf:
                with open(fp, "rb") as lf:
                    if zlib.crc32(lf.read()) != leaf["crc32"]:
                        return False
        return True
    except (json.JSONDecodeError, KeyError, OSError):
        return False


def valid_steps(directory: str) -> list[int]:
    """Every step number with a *verified* checkpoint, newest first."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and _is_valid(os.path.join(directory, name)):
            steps.append(int(m.group(1)))
    return sorted(steps, reverse=True)


def latest_step(directory: str) -> Optional[int]:
    """Largest step with a *valid, checksum-verified* checkpoint, or
    None.  Steps are verified newest first, up to the first that checks
    out."""
    if not os.path.isdir(directory):
        return None
    steps = sorted((int(m.group(1)) for m in map(_STEP_RE.match,
                                                 os.listdir(directory))
                    if m), reverse=True)
    return next((s for s in steps
                 if _is_valid(os.path.join(directory, f"step_{s}"))), None)


def load_checkpoint(directory: str, step: int, template: Tree,
                    device=None) -> tuple[Tree, dict]:
    """Restore into ``template``'s tree structure, every leaf a tensor on
    ``device`` (default: the CUDA card; pass ``"cpu"`` for the host).
    Returns (tree, manifest_extra)."""
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}

    def load(name, leaf):
        if name not in by_name:
            raise KeyError(f"checkpoint {path} missing leaf {name!r}")
        entry = by_name[name]
        fname = os.path.join(path, entry["file"])
        raw = bytearray(os.path.getsize(fname))
        with open(fname, "rb") as lf:
            lf.readinto(raw)
        if "crc32" in entry and zlib.crc32(raw) != entry["crc32"]:
            # read-time integrity: rot between the _is_valid scan and the
            # load still fails loudly instead of restoring garbage
            raise ValueError(
                f"checkpoint {path}: leaf {name!r} fails its CRC32 check "
                "(bit-rot or torn write); restore from an older step")
        t = _leaf_tensor(raw, entry.get("dtype", ""))
        expect = tuple(leaf.shape) if hasattr(leaf, "shape") \
            else tuple(np.shape(leaf))
        if tuple(t.shape) != expect:
            raise ValueError(
                f"leaf {name!r}: checkpoint shape {tuple(t.shape)} != "
                f"{expect}")
        return t.to(dev)

    return _walk(template, load), manifest["extra"]


def _gc(directory: str, keep: int, fresh: Optional[str] = None) -> None:
    """Drop the verified steps older than the newest ``keep`` verified
    ones, and stale tmp dirs.  ``fresh`` is a path that
    :func:`_write_checkpoint` has just written with every leaf exactly the
    bytes it checksummed, taken as valid without reading it back; every
    other step is verified."""
    if not os.path.isdir(directory):
        return
    valid = sorted(
        (int(m.group(1)), name)
        for name in os.listdir(directory)
        for m in [_STEP_RE.match(name)]
        if m and (os.path.join(directory, name) == fresh
                  or _is_valid(os.path.join(directory, name))))
    for _, name in valid[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    # reap stale tmp dirs (crashed writers)
    for name in os.listdir(directory):
        if name.startswith("tmp_step_"):
            full = os.path.join(directory, name)
            if time.time() - os.path.getmtime(full) > 300:
                shutil.rmtree(full, ignore_errors=True)


# ---------------------------------------------------------------------------
# Session state (repro_torch.api.session): previous factorization + spec
# ---------------------------------------------------------------------------
# A Factorization flattens to exactly these children; the manifest stores
# them as indexed leaves, so a template can be rebuilt from shapes alone.
_FACT_FIELDS = _NODE_FIELDS["Factorization"]


def save_session_state(directory: str, step: int, session,
                       keep: int = 0) -> str:
    """Atomic save of a ``repro_torch.api.session.Session``'s tracking
    state: the previous :class:`Factorization` through the leaf protocol,
    the spec, policy knobs and history in the manifest ``extra``.
    ``keep > 0`` prunes to the newest ``keep`` valid session states."""
    path, exact = _write_checkpoint(directory, step, {"fact": session.fact},
                                    extra={"session": session.meta()})
    if keep > 0:
        _gc(directory, keep, fresh=path if exact else None)
    return path


def load_session_state(directory: str, step: int, device=None):
    """Load (factorization, session_meta) written by
    :func:`save_session_state` (either package's), the factorization on
    ``device`` (default: the CUDA card).  The template is rebuilt from
    the manifest's shapes, so no geometry needs to be supplied; returns
    ``(None, meta)`` for a pre-first-solve session."""
    from repro_torch.api.results import Factorization
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    meta = manifest["extra"]["session"]
    if not manifest["leaves"]:
        return None, meta
    shapes = [np.empty(leaf["shape"], dtype=np.uint8)
              for leaf in manifest["leaves"]]
    if len(shapes) != len(_FACT_FIELDS):
        raise ValueError(
            f"session checkpoint {path} has {len(shapes)} leaves; "
            f"expected {len(_FACT_FIELDS)} (a Factorization)")
    template = {"fact": Factorization(*shapes,
                                      method=meta.get("method", "fsvd"))}
    tree, _ = load_checkpoint(directory, step, template, device=device)
    return tree["fact"], meta


class CheckpointManager:
    """Keep-N, optionally-async checkpoint writer."""

    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Tree,
             extra: Optional[dict] = None) -> None:
        self.wait()
        # synchronous device -> host snapshot; disk I/O may be deferred
        host_tree = _walk(tree, lambda _, x: _host_copy(x))

        def work():
            try:
                path, exact = _write_checkpoint(self.directory, step,
                                                host_tree, extra)
                _gc(self.directory, self.keep,
                    fresh=path if exact else None)
            except BaseException as e:       # surfaced on next wait()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def restore_latest(self, template: Tree, device=None
                       ) -> Optional[tuple[int, Tree, dict]]:
        step = latest_step(self.directory)
        if step is None:
            return None
        tree, extra = load_checkpoint(self.directory, step, template,
                                      device=device)
        return step, tree, extra
