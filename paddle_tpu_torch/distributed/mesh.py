"""The device mesh of the PyTorch/CUDA port: the counterpart of
`paddle_tpu/distributed/mesh.py`, cut to the axes whose ranks run in one
process.

The reference's mesh is a named `jax.sharding.Mesh` over devices, with one
axis per kind of parallelism.  Here three axes run, each with its ranks in
one process, taking turns on their device:

- `sep` (ring attention, Ulysses): R ranks on one explicit device; the
  reference's transport (`ppermute`, `all_gather`, `psum_scatter`) becomes
  moves between the ranks' tensors there.
- `mp` (tensor-parallel serving): one explicit torch device per rank.  A
  device list may name one device several times: those ranks share it.
  Without a list the visible CUDA devices are used, each once, so tp=4 on
  a one-card machine raises `ShardingError`, as the reference raises on
  too few devices; ranks are stacked on one card only when the caller names
  that card for several ranks.  The row-parallel all-reduce (`reduce`) and
  the all-gather (`all_gather`) are explicit operations over the ranks'
  tensors: ranks on one device are summed and concatenated there.
- `cp` beside `mp` (tensor x context parallel serving, the reference's
  ('cp', 'mp') serving mesh): the mesh records the degree; every mp
  rank's page arena splits into cp page shards on the rank's own device,
  walked by one K5 launch per rank (`paged_decode_cp_tp`), so the cp
  shards need no devices of their own.  cp alone needs no mesh: the
  context-parallel engine keeps its page shards without one.

Ranks on distinct devices, cp without mp, and any other axis of degree >
1, raise NotImplementedError: the cross-card transport (NCCL) is ROADMAP
Queue 1 item 17.
"""
from __future__ import annotations

import torch

from ..framework.core import resolve_device
from .sharding import ShardingError, visible_devices

AXIS_ORDER = ("pp", "dp", "sharding", "sep", "ep", "cp", "mp")


class Mesh:
    """A mesh of the port: `shape` maps every axis of AXIS_ORDER to its
    degree (`{a: n for a, n in shape.items() if n > 1}` is the reference's
    /healthz `mesh_shape`), `device` is where the ranks run and `devices`
    lists the 'mp' ranks' devices (rank r on devices[r]; one entry when mp
    is 1).  A 'cp' degree beside 'mp' is each rank's page shard count."""

    def __init__(self, shape, device, devices=None):
        self.axis_names = AXIS_ORDER
        self.shape = dict(shape)
        self.device = device
        self.devices = list(devices) if devices is not None else [device]

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items() if n > 1)
        return f"Mesh({axes or 'single'}, device={self.device})"

    @property
    def mp(self):
        return self.shape["mp"]

    def reduce(self, parts):
        """The row-parallel all-reduce: the sum of the ranks' partial
        tensors (rank order), accumulated in float32 and rounded once to
        the parts' dtype.  A float32 sum of the partials stays closest to
        the one-rank product: summing N 16-bit partials in their own dtype
        would add a rounding per rank."""
        if len(parts) == 1:
            return parts[0]
        acc = parts[0].to(torch.float32, copy=True)
        for p in parts[1:]:
            acc += p
        return acc.to(parts[0].dtype)

    def all_gather(self, parts, dim=-1):
        """The ranks' shards joined along `dim`, in rank order."""
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


_global_mesh = None


def _rank_devices(n, devices):
    """The 'mp' axis's devices: `devices` (one per rank, resolved; its
    first n entries, as the reference takes the first n devices) or the
    visible CUDA devices, each once.  Raises ShardingError when fewer than n
    are given, NotImplementedError when the ranks span distinct devices."""
    devs = visible_devices() if devices is None else [resolve_device(d) for d in devices]
    if len(devs) < n:
        raise ShardingError(
            f"the 'mp' mesh axis of {n} ranks needs {n} devices, found "
            f"{len(devs)} (name one device per rank, e.g. devices=['cuda:0'] "
            f"* {n} to stack the ranks on one card)"
        )
    devs = devs[:n]
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"'mp' ranks on distinct devices {sorted(map(str, set(devs)))} are "
            "not ported to paddle_tpu_torch yet (ROADMAP Queue 1: item 17, the "
            "cross-card transport and a StepGraph spanning devices); name one "
            "device for every rank"
        )
    return devs


def build_mesh(dp=1, mp=1, pp=1, sharding=1, sep=1, ep=1, cp=1, device=None,
               devices=None):
    """Create and install the global mesh: the `sep` axis of `sep` ranks on
    `device` (None: the CUDA card; pass device="cpu" for the plain
    versions), or the `mp` axis of `mp` ranks on `devices`, with `cp` page
    shards on each rank's device (see the module docstring).  Every other
    degree must be 1, `cp` needs `mp` > 1, and `sep` and `mp` do not
    combine."""
    global _global_mesh
    degrees = {"pp": pp, "dp": dp, "sharding": sharding, "sep": sep, "ep": ep,
               "cp": cp, "mp": mp}
    for name, n in degrees.items():
        if int(n) < 1:
            raise ValueError(f"build_mesh: {name} must be >= 1, got {n}")
        degrees[name] = int(n)
    for name, n in degrees.items():
        if name == "cp" and degrees["mp"] > 1:
            continue  # the page shards of every mp rank, on its device
        if name not in ("sep", "mp") and n != 1:
            raise NotImplementedError(
                f"build_mesh: {name}={n} is not ported; only the sep and mp "
                "axes run (their ranks in one process), the cross-card forms "
                "are ROADMAP Queue 1 item 17"
            )
    if degrees["sep"] > 1 and degrees["mp"] > 1:
        raise NotImplementedError(
            "build_mesh: sep with mp is not ported (ROADMAP Queue 1 item 17)")
    if degrees["mp"] > 1:
        devs = _rank_devices(degrees["mp"], devices)
        _global_mesh = Mesh(degrees, devs[0], devs)
    else:
        _global_mesh = Mesh(degrees, resolve_device(
            device if devices is None else list(devices)[0]))
    return _global_mesh


def serving_mesh(tp, cp=1, devices=None):
    """Build and install a serving mesh (reference: mesh.py:51-75): the
    'mp' axis of `tp` ranks on `devices` (one torch device per rank; a
    device named several times holds several ranks) or on the visible CUDA
    devices, each once, and with tp > 1 a 'cp' degree of `cp` page shards
    on every rank's device (the reference's ('cp', 'mp') mesh, whose cp
    shards are devices of their own).  Raises ShardingError when there are
    fewer than tp devices, NotImplementedError for cp > 1 at tp 1 (the
    context-parallel engine's page shards need no mesh; cp shards on
    devices of their own are ROADMAP item 17)."""
    cp = int(cp) if cp else 1
    return build_mesh(mp=int(tp), cp=cp, devices=devices)


def set_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh
    return mesh


def get_mesh():
    return _global_mesh


def axis_size(name):
    m = _global_mesh
    if m is None or name not in m.axis_names:
        return 1
    return m.shape[name]
