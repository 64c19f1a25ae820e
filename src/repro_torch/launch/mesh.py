"""Production meshes (port of the JAX package's ``launch/mesh.py``).

Functions over ``torch.distributed.device_mesh.init_device_mesh``, so
importing this module touches no process group.  The caller starts the
group first (``torch.distributed.init_process_group`` with its address,
world size and rank: nothing on the machine tells a program of a
cluster); the dry run starts a fake one of 256 or 512 ranks.  The axes
are plain mesh dims, which every ``constrain`` may name (the reference
builds them with ``jax.make_mesh``, whose axes are now Explicit, so its
``with_sharding_constraint`` refuses them; see ``ROADMAP.md``).
"""
from __future__ import annotations


def _mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16x16 = 256 ranks ("data", "model").
    Multi-pod: 2 pods x 256 = 512 ranks ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(device_type: str = "cuda"):
    """A 1x1 ("data", "model") mesh over a group of one rank: the
    sharding plumbing on one card (or the CPU, ``device_type="cpu"``)."""
    return _mesh(device_type, (1, 1), ("data", "model"))


def make_mesh(shape, axes=("data", "model"), device_type: str = "cuda"):
    """A mesh of any shape over the current group (whose world size is
    the product of ``shape``)."""
    return _mesh(device_type, shape, tuple(axes))
