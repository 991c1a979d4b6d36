"""Hardened checkpoints of one process (counterpart of the single-process
part of `paddle_tpu/distributed/checkpoint.py`, :222-481).

Layout under a checkpoint root::

    root/step_12/        committed (COMMIT manifest present)
    root/step_17.tmp/    in flight or torn: never resumed from

Commit protocol: the payload goes into ``step_N.tmp``; then the COMMIT
manifest (format version, step, per-tensor shape, dtype and crc32, and
the data loader's position) is written and fsynced inside it, and one
atomic rename makes it ``step_N``.  A crash at any point leaves either a
committed checkpoint or a ``.tmp`` that `find_latest_valid` skips.

The payload is the port's own format (the reference's orbax tree is not
read): ``state.bin``, every tensor's bytes one after another (bf16 and
fp16 as their 16-bit patterns), and ``tree.pkl``, the pickled shape of
the state dict -- nested dicts, lists and plain values as they are, each
tensor replaced by its name and byte range.  A load copies each tensor
into the live one at the same place in the given state dict (same
shape) or, where there is none, puts a new tensor there; a caller then
hands the optimizer's part to `Optimizer.load_state_dict`, since a fresh
optimizer's state holds no moments yet.

`save_state_dict` / `load_state_dict` write and read one checkpoint
directory in this process.  Over process groups (sharded tensors, a
commit barrier across ranks) they come with `distributed/` (ROADMAP
Queue 1, item 17); a `process_group` raises NotImplementedError.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import shutil
import time
import zlib

import numpy as np
import torch

from ..fault import injection as _inj
from ..fault import watchdog as _wd
from ..framework import core as _core

logger = logging.getLogger("paddle_tpu_torch")

COMMIT_FILE = "COMMIT"
PAYLOAD_FILE = "state.bin"
TREE_FILE = "tree.pkl"
_STEP_RE = re.compile(r"^step_(\d+)$")

# v1 (the reference's first) had no version field and no data position;
# v2 adds both
MANIFEST_VERSION = 2

# 16-bit float payloads are stored as their bit patterns
_BITS = {torch.bfloat16: torch.int16, torch.float16: torch.int16}
_ALIGN = 64  # byte alignment of every tensor in the payload


class CheckpointCorruption(RuntimeError):
    """A committed checkpoint failed validation (torn write, bit rot)."""


class _Ref:
    """A tensor's place in the saved tree: its name in the payload index."""

    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key

    def __reduce__(self):
        return (_Ref, (self.key,))


def _is_array(v):
    return isinstance(v, (torch.Tensor, np.ndarray))


def _skeleton(obj, leaves, path=()):
    """`obj` with every tensor or numpy array replaced by a _Ref named by
    its "/"-joined path; the (name, array) pairs go into `leaves`."""
    if _is_array(obj):
        key = "/".join(map(str, path))
        leaves.append((key, obj))
        return _Ref(key)
    if isinstance(obj, dict):
        return {k: _skeleton(v, leaves, path + (k,)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        items = [_skeleton(v, leaves, path + (i,)) for i, v in enumerate(obj)]
        return items if isinstance(obj, list) else tuple(items)
    return obj


def _flat(state_dict):
    leaves = []
    _skeleton(state_dict, leaves)
    return dict(leaves)


def _host_bytes(v):
    """(host numpy view of v's bytes, dtype name, shape)."""
    if isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v)
        return a, f"numpy.{a.dtype.name}", list(a.shape)
    t = v.detach().contiguous()
    name = str(t.dtype)
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.cpu().numpy(), name, list(v.shape)


def _crc32(buf):
    return zlib.crc32(memoryview(buf).cast("B")) & 0xFFFFFFFF


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # e.g. a filesystem whose directories cannot be fsynced


def step_dir(root, step):
    return os.path.join(root, f"step_{int(step)}")


def save_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    async_save=False):
    """Write `state_dict` (nested dicts / lists of tensors, numpy arrays
    and plain values) into the directory `path`: the payload and the tree.
    Returns {name: {"shape", "dtype", "crc32"}} of every tensor, the
    manifest's "arrays"."""
    if process_group is not None or async_save:
        raise NotImplementedError(
            "save_state_dict over a process group, or asynchronously, comes "
            "with distributed/ (ROADMAP Queue 1, item 17)")
    _inj.inject("checkpoint.save", context=path)
    os.makedirs(path, exist_ok=True)
    leaves = []
    tree = _skeleton(state_dict, leaves)
    index, arrays, offset = {}, {}, 0
    with open(os.path.join(path, PAYLOAD_FILE), "wb") as f:
        for key, v in leaves:
            pad = -offset % _ALIGN  # every tensor starts aligned
            f.write(b"\0" * pad)
            offset += pad
            buf, dtype, shape = _host_bytes(v)
            f.write(memoryview(buf).cast("B"))
            index[key] = {"offset": offset, "nbytes": buf.nbytes,
                          "dtype": dtype, "shape": shape}
            arrays[key] = {"shape": shape, "dtype": dtype, "crc32": _crc32(buf)}
            offset += buf.nbytes
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(path, TREE_FILE), "wb") as f:
        pickle.dump({"tree": tree, "index": index}, f, protocol=4)
        f.flush()
        os.fsync(f.fileno())
    return arrays


def _torch_dtype(name):
    return getattr(torch, name.split(".", 1)[1])


def _read_payload(path, arrays=None):
    """(tree, {key: host array or tensor}) of the checkpoint at `path`,
    read through a copy-on-write memory map.  With `arrays` (a manifest's),
    every tensor's bytes are checked against its crc32 first: a mismatch
    raises CheckpointCorruption before anything is restored."""
    with open(os.path.join(path, TREE_FILE), "rb") as f:
        doc = pickle.load(f)
    index = doc["index"]
    size = os.path.getsize(os.path.join(path, PAYLOAD_FILE))
    mm = (np.memmap(os.path.join(path, PAYLOAD_FILE), dtype=np.uint8, mode="c")
          if size else np.zeros(0, np.uint8))
    out = {}
    for key, ent in index.items():
        end = ent["offset"] + ent["nbytes"]
        if end > size:
            raise CheckpointCorruption(f"checkpoint {path!r}: {key!r} lies past "
                                       "the end of the payload")
        raw = mm[ent["offset"]:end]
        meta = (arrays or {}).get(key)
        if meta is not None and meta.get("crc32") is not None \
                and _crc32(raw) != meta["crc32"]:
            raise CheckpointCorruption(
                f"checkpoint {path!r}: {key!r} checksum mismatch")
        dtype, shape = ent["dtype"], ent["shape"]
        if dtype.startswith("numpy."):
            out[key] = raw.view(np.dtype(dtype[6:])).reshape(shape)
            continue
        out[key] = torch.from_numpy(raw).view(_torch_dtype(dtype)).reshape(shape)
    return doc["tree"], out


def _first_device(obj):
    if isinstance(obj, torch.Tensor):
        return obj.device
    items = obj.values() if isinstance(obj, dict) else (
        obj if isinstance(obj, (list, tuple)) else ())
    for v in items:
        d = _first_device(v)
        if d is not None:
            return d
    return None


def _merge(skel, live, payload, device):
    """The restored value at one place of the tree: live tensors of the
    saved shape are copied into, live containers filled in place, anything
    else replaced."""
    if isinstance(skel, _Ref):
        src = payload[skel.key]
        if isinstance(src, np.ndarray):
            return np.array(src)
        if isinstance(live, torch.Tensor) and tuple(live.shape) == tuple(src.shape):
            with torch.no_grad():
                live.copy_(src)
            return live
        return src.to(device, copy=True)
    if isinstance(skel, dict):
        target = live if isinstance(live, dict) else {}
        for k, v in skel.items():
            target[k] = _merge(v, target.get(k), payload, device)
        return target
    if isinstance(skel, (list, tuple)):
        old = live if isinstance(live, (list, tuple)) else ()
        items = [_merge(v, old[i] if i < len(old) else None, payload, device)
                 for i, v in enumerate(skel)]
        return items if isinstance(skel, list) else tuple(items)
    return skel


def load_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    offload=False, device=None, arrays=None):
    """Restore the checkpoint directory `path` into `state_dict` IN PLACE
    (see the module docstring); new tensors go to `device` (default: the
    device of the first tensor in `state_dict`, else the CPU).  With
    `arrays` (a manifest's), checksums are verified before anything is
    restored.  Returns `state_dict`."""
    if process_group is not None:
        raise NotImplementedError(
            "load_state_dict over a process group comes with distributed/ "
            "(ROADMAP Queue 1, item 17)")
    _inj.inject("checkpoint.load", context=path)
    if not os.path.exists(os.path.join(path, PAYLOAD_FILE)):
        raise FileNotFoundError(f"no checkpoint found under {path!r}")
    tree, payload = _read_payload(path, arrays)
    if device is None:
        device = _first_device(state_dict) or torch.device("cpu")
    _merge(tree, state_dict, payload, torch.device(device))
    return state_dict


def save_checkpoint(state_dict, root, step, keep_last_n=None, retries=None,
                    backoff=None, data_loader=None):
    """Atomically commit `state_dict` as `root/step_<step>`.

    `data_loader` (anything with ``state_dict()``, typically `io.DataLoader`)
    puts the data position into the COMMIT manifest, so that
    `load_latest(..., data_loader=)` resumes on the exact next batch.
    Failed attempts (I/O errors, injected faults) are retried with
    exponential backoff (FLAGS_checkpoint_save_retries,
    FLAGS_checkpoint_retry_backoff) before raising.  `keep_last_n` prunes
    older committed checkpoints and stale `.tmp` leftovers after the
    commit.  The save runs in the default watchdog's `checkpoint.save`
    region.  Synchronous: the COMMIT marker asserts durable bytes.
    Returns the committed path."""
    if retries is None:
        retries = int(_core.flag("FLAGS_checkpoint_save_retries"))
    if backoff is None:
        backoff = float(_core.flag("FLAGS_checkpoint_retry_backoff"))
    os.makedirs(root, exist_ok=True)
    final = step_dir(root, step)
    tmp = final + ".tmp"
    attempt = 0
    while True:
        try:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)  # debris of an earlier torn attempt
            with _wd.arm("checkpoint.save", context=tmp):
                arrays = save_state_dict(state_dict, tmp)
            break
        except Exception as e:
            attempt += 1
            if attempt > retries:
                raise RuntimeError(f"checkpoint save for step {step} failed "
                                   f"after {attempt} attempt(s): {e}") from e
            delay = backoff * (2 ** (attempt - 1))
            logger.warning("checkpoint save attempt %d/%d failed (%s); "
                           "retrying in %.2fs", attempt, retries + 1, e, delay)
            time.sleep(delay)

    manifest = {"format_version": MANIFEST_VERSION, "step": int(step),
                "time": time.time(), "arrays": arrays}
    if data_loader is not None and hasattr(data_loader, "state_dict"):
        manifest["data_state"] = data_loader.state_dict()
    # chaos point: payload durable, marker absent -- the torn state
    _inj.inject("checkpoint.commit", context=tmp)
    with open(os.path.join(tmp, COMMIT_FILE), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.isdir(final):
        shutil.rmtree(final)  # re-saving a step replaces it
    os.rename(tmp, final)
    _fsync_dir(root)
    if keep_last_n:
        _prune(root, keep_last_n, current_step=int(step))
    return final


def _prune(root, keep_last_n, current_step=None):
    steps = sorted((s for s, _ in _committed_steps(root)), reverse=True)
    for s in steps[int(keep_last_n):]:
        shutil.rmtree(step_dir(root, s), ignore_errors=True)
    for name in os.listdir(root):
        m = _STEP_RE.match(name[:-4]) if name.endswith(".tmp") else None
        if m and (current_step is None or int(m.group(1)) != current_step):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def _committed_steps(root):
    """[(step, path)] of the directories that pass the light check: a
    committed name, a parseable COMMIT manifest, the payload present."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        m = _STEP_RE.match(name)
        if m and read_commit_manifest(os.path.join(root, name)) is not None:
            out.append((int(m.group(1)), os.path.join(root, name)))
    return out


def read_commit_manifest(path):
    """The COMMIT manifest of a checkpoint directory, or None if it is
    missing or unparseable or the payload is absent (a torn checkpoint)."""
    try:
        with open(os.path.join(path, COMMIT_FILE)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(manifest, dict):
        return None
    manifest.setdefault("format_version", 1)  # version-less: v1
    if int(manifest["format_version"]) > MANIFEST_VERSION:
        logger.warning("checkpoint %s: manifest format_version %s is newer than "
                       "this reader (%d); known fields are honoured", path,
                       manifest["format_version"], MANIFEST_VERSION)
    if not all(os.path.exists(os.path.join(path, n))
               for n in (PAYLOAD_FILE, TREE_FILE)):
        return None
    return manifest


def find_latest_valid(root):
    """The newest committed checkpoint under `root` as (step, path), or
    None; torn and in-flight saves are skipped."""
    steps = _committed_steps(root)
    return max(steps, key=lambda sp: sp[0]) if steps else None


def verify_checkpoint(state_dict, path):
    """Hold the live tensors of `state_dict` against the COMMIT manifest's
    crc32s (a tensor the manifest names and the dict lacks is skipped).
    Raises CheckpointCorruption on a mismatch."""
    manifest = read_commit_manifest(path)
    if manifest is None:
        raise CheckpointCorruption(f"no valid COMMIT manifest under {path!r}")
    flat = _flat(state_dict)
    for k, meta in manifest.get("arrays", {}).items():
        want, v = meta.get("crc32"), flat.get(k)
        if want is None or v is None:
            continue
        got = _crc32(_host_bytes(v)[0])
        if got != want:
            raise CheckpointCorruption(f"checkpoint {path!r}: array {k!r} "
                                       f"checksum mismatch (manifest {want}, "
                                       f"restored {got})")


def load_latest(state_dict, root=None, verify=True, data_loader=None, device=None):
    """Resume from the newest VALID checkpoint under `root` (default:
    $PADDLE_CKPT_DIR).  Committed checkpoints are tried newest first; one
    that fails to read or (with `verify`) whose bytes fail their crc32 is
    logged and skipped for the next older, so a torn or corrupt latest
    checkpoint costs steps, never the job.  Checksums are held on the
    bytes read, before anything is restored.  `data_loader`: its position
    is restored from the manifest (``set_state_dict``), so the epoch
    continues on the exact next batch.  The restore runs in the default
    watchdog's `checkpoint.load` region.  Returns the resumed step, or None
    when nothing valid exists."""
    root = root or os.environ.get("PADDLE_CKPT_DIR") or ""
    if not root:
        return None
    candidates = sorted(_committed_steps(root), key=lambda sp: sp[0], reverse=True)
    for step, path in candidates:
        try:
            manifest = read_commit_manifest(path) or {}
            with _wd.arm("checkpoint.load", context=path):
                load_state_dict(state_dict, path, device=device,
                                arrays=manifest.get("arrays") if verify else None)
            data_state = manifest.get("data_state")
            if data_loader is not None and data_state \
                    and hasattr(data_loader, "set_state_dict"):
                data_loader.set_state_dict(data_state)
                logger.info("restored data position: epoch %s, %s batches "
                            "consumed", data_state.get("epoch"),
                            data_state.get("batches_consumed"))
            logger.info("resumed from checkpoint step %d (%s)", step, path)
            return step
        except Exception as e:
            logger.warning("checkpoint %s unusable (%s); falling back to an "
                           "older one", path, e)
    logger.warning("no usable checkpoint under %r; starting fresh", root)
    return None
