"""The device mesh of the PyTorch/CUDA port: the counterpart of
`paddle_tpu/distributed/mesh.py`, cut to what ring attention needs.

The reference's mesh is a named `jax.sharding.Mesh` over devices, with one
axis per kind of parallelism.  Here a mesh is the `sep` axis alone: its R
ranks run in one process on one explicit device, taking turns there, and
the reference's transport (`ppermute`, `all_gather`, `psum_scatter`)
becomes moves between the ranks' tensors on that device.  Nothing of the
ring's math changes.  Any other axis of degree > 1 raises
NotImplementedError: the cross-card forms (NCCL) are ROADMAP Queue 1
item 17.
"""

from __future__ import annotations

from ..framework.core import resolve_device

AXIS_ORDER = ("pp", "dp", "sharding", "sep", "ep", "cp", "mp")


class Mesh:
    """A mesh of the port: `shape` maps every axis of AXIS_ORDER to its
    degree (1 but for `sep`), `device` is where the ranks run."""

    def __init__(self, shape, device):
        self.axis_names = AXIS_ORDER
        self.shape = dict(shape)
        self.device = device

    def __repr__(self):
        return f"Mesh(sep={self.shape['sep']}, device={self.device})"


_global_mesh = None


def build_mesh(dp=1, mp=1, pp=1, sharding=1, sep=1, ep=1, cp=1, device=None):
    """Create and install the global mesh: the `sep` axis of `sep` ranks on
    `device` (None: the CUDA card; pass device="cpu" for the plain
    versions).  Every other degree must be 1."""
    global _global_mesh
    degrees = {"pp": pp, "dp": dp, "sharding": sharding, "sep": sep, "ep": ep,
               "cp": cp, "mp": mp}
    for name, n in degrees.items():
        if name != "sep" and n != 1:
            raise NotImplementedError(
                f"build_mesh: {name}={n} is not ported; only the sep axis runs "
                "(its ranks in one process on one device), the cross-card "
                "forms are ROADMAP Queue 1 item 17"
            )
    if int(sep) < 1:
        raise ValueError(f"build_mesh: sep must be >= 1, got {sep}")
    degrees["sep"] = int(sep)
    _global_mesh = Mesh(degrees, resolve_device(device))
    return _global_mesh


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
