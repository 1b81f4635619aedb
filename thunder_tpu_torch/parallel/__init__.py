"""Distributed subsystem: mesh, collective prims, strategy transforms.

thunder_tpu/parallel/ for the port, limited to what is ported: the mesh
over torch.distributed process groups, the collective prims, replicated
data parallelism (``ddp``) and ring-attention context parallelism
(``context_parallel``), which a ``TrainStep`` runs one process per rank.
FSDP, tensor, expert and pipeline parallelism, the GSPMD road, gradient
bucketing, overlap options and sharded checkpoints are not ported yet
(ROADMAP A3b)."""
from .mesh import (
    DP_AXIS,
    EP_AXIS,
    FSDP_AXIS,
    PP_AXIS,
    SP_AXIS,
    TP_AXIS,
    Mesh,
    axis_size,
    make_mesh,
    single_device_mesh,
)
from . import multiprocess, prims
from .context_parallel import ContextParallelTransform, context_parallel
from .transforms import DDPTransform, DistPlan, ParamStrategy, ddp
