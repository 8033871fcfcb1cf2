"""``paddle.distributed`` of the port: the collective API over
``torch.distributed`` (``collective``), the parallel environment, spawn and
``DataParallel`` (``parallel``), the launcher (``launch``), ``fleet`` in
collective mode, ZeRO (``sharding``), the asynchronous checkpointing and
resume loop (``checkpoint``) and the parameter-server tables (``ps``). One
process per rank, as Paddle and torch run; see ``collective`` for the
backends."""
from . import checkpoint, collective, fleet, ps  # noqa: F401
from .collective import (  # noqa: F401
    Group,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    alltoall,
    alltoall_single,
    barrier,
    broadcast,
    destroy_process_group,
    get_group,
    irecv,
    is_initialized,
    isend,
    new_group,
    ppermute,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    shift,
    wait,
)
from .parallel import (  # noqa: F401
    DataParallel,
    ParallelEnv,
    get_rank,
    get_world_size,
    init_parallel_env,
    spawn,
)
from .compat import (  # noqa: F401
    ParallelMode,
    gloo_barrier,
    gloo_init_parallel_env,
    gloo_release,
)
from . import launch, sharding, utils  # noqa: F401,E402


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True, weight_attr=None,
          bias_attr=None, name=None):
    """reference: collective.py:1483 paddle.distributed.split — as the JAX
    function does, the tensor-parallel layer for ``operation`` over the
    installed mp degree: "linear" with ``axis`` 0 a RowParallelLinear, else
    a ColumnParallelLinear (``gather_out``), "embedding" a
    VocabParallelEmbedding; ``size`` is the global weight shape."""
    from .fleet import meta_parallel as mp

    if operation == "linear":
        if axis == 0:
            return mp.RowParallelLinear(size[0], size[1], input_is_parallel=False)
        return mp.ColumnParallelLinear(size[0], size[1], gather_output=gather_out)
    if operation == "embedding":
        return mp.VocabParallelEmbedding(size[0], size[1])
    raise ValueError(f"unsupported split operation {operation!r}")
