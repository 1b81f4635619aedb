"""Distributed plugins: string-addressable DDP/FSDP/TP/CP bundles.

thunder_tpu/parallel/plugins.py for the port (reference
thunder/plugins/distributed.py:13,58, mesh-aware stacking at :118-155).
``resolve_plugin("fsdp")`` and its siblings give these; ``apply_to(tmodule)``
applies the strategy to a jitted module. Without a mesh a plugin lays one
axis over every rank of the process group (one rank outside a group)."""
from __future__ import annotations

from typing import Optional, Sequence

from ..plugins import Plugin, register_plugin
from .mesh import DP_AXIS, FSDP_AXIS, SP_AXIS, TP_AXIS, make_mesh


class _MeshPlugin(Plugin):
    def __init__(self, mesh=None, n_devices: Optional[int] = None):
        self._mesh = mesh
        self._n = n_devices

    def mesh(self, axis: str):
        if self._mesh is not None:
            return self._mesh
        from .multiprocess import process_count

        return make_mesh({axis: self._n or process_count()})


class DDP(_MeshPlugin):
    """plugins=["ddp"]: replicate the parameters over every rank."""

    def apply_to(self, tmodule):
        from .transforms import ddp

        return ddp(tmodule, self.mesh(DP_AXIS))


class FSDP(_MeshPlugin):
    """plugins=["fsdp"]: ZeRO-3 over every rank; a mesh with a 'dp' axis
    beside 'fsdp' makes it hybrid (replicated over dp, sharded over fsdp;
    reference plugins/distributed.py:118)."""

    def apply_to(self, tmodule):
        from .transforms import ddp, fsdp

        mesh = self.mesh(FSDP_AXIS)
        if DP_AXIS in mesh.axis_names:
            ddp(tmodule, mesh)
        return fsdp(tmodule, mesh)


class TensorParallel(_MeshPlugin):
    """plugins=[TensorParallel(column=[...], row=[...])] ("tp"): the named
    Linear modules column- and row-parallel over 'tp'."""

    def __init__(self, column: Sequence[str] = (), row: Sequence[str] = (), **kw):
        super().__init__(**kw)
        self.column = list(column)
        self.row = list(row)

    def apply_to(self, tmodule):
        from .tensor_parallel import column_parallel, row_parallel

        mesh = self.mesh(TP_AXIS)
        if self.column:
            column_parallel(tmodule, mesh, self.column)
        if self.row:
            row_parallel(tmodule, mesh, self.row)
        return tmodule


class ContextParallel(_MeshPlugin):
    """plugins=["cp"]: ring-attention context parallelism over 'sp'."""

    def apply_to(self, tmodule):
        from .context_parallel import context_parallel

        return context_parallel(tmodule, self.mesh(SP_AXIS))


register_plugin("ddp", DDP)
register_plugin("fsdp", FSDP)
register_plugin("tp", TensorParallel)
register_plugin("cp", ContextParallel)
