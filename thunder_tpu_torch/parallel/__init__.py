"""Distributed subsystem: mesh, collective prims, strategy transforms.

thunder_tpu/parallel/ for the port: the mesh over torch.distributed process
groups, the collective prims (all_reduce, all_gather, reduce_scatter,
all_to_all, broadcast, the DDP and tensor-parallel syncs, ppermute and the
ring step), replicated data parallelism (``ddp``, with gradient bucketing),
ZeRO-2/3 sharded data parallelism with padded shards (``fsdp``; ``ddp``
then ``fsdp`` on a dp × fsdp mesh is hybrid), Megatron column/row tensor
parallelism (``column_parallel``, ``row_parallel``), expert parallelism
over ``all_to_all`` (``moe_ep_forward``) and ring-attention context
parallelism (``context_parallel``); a ``TrainStep`` runs them one process
per rank, ``TrainStep.micro_step`` and ``ThunderModule.no_sync`` accumulate
gradients under DDP and FSDP. The distributed plugins (``ddp``, ``fsdp``,
``tp``, ``cp``) are in plugins.py. The GSPMD road and overlap options, the
sharded checkpoint layout, peer preemption and the desync checks are not
ported yet (ROADMAP A3c)."""
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
from .bucketing import GradBucketingTransform
from .context_parallel import ContextParallelTransform, context_parallel
from .expert_parallel import moe_ep_forward
from .tensor_parallel import ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding, column_parallel, row_parallel
from .transforms import DDPTransform, DistPlan, FSDPTransform, ParamStrategy, ddp, fsdp
