"""Device-mesh parallelism: the mesh authority, sharded steps, multi-host.

Only :mod:`.mesh` loads eagerly — it is the leaf module the ``ops/``
kernels import their ``mesh_pjit`` surface from, and an eager
``.distributed`` import here would close the cycle
``ops -> parallel -> distributed -> models.pipeline -> ops``.  The other
package-level names resolve lazily (PEP 562).
"""

from .mesh import SHARD_AXIS, global_mesh, make_mesh, mesh_pjit

_LAZY = {
    "distributed_annotate_step": ".distributed",
    "reshard_by_owner": ".distributed",
    "init_multihost": ".multihost",
    "multihost_env": ".multihost",
    "process_info": ".multihost",
}

__all__ = [
    "make_mesh", "mesh_pjit", "global_mesh", "SHARD_AXIS",
    "distributed_annotate_step",
    "reshard_by_owner", "init_multihost", "multihost_env", "process_info",
]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(mod, __name__), name)
