"""More than one device: one process per GPU over a torch.distributed
group (`mesh`), the global batch and state across processes
(`multihost`), point-sharded pooling (`sharded_pool`) and every
collective the port makes, with the collective-size audit
(`collective_audit`)."""

from wireframe_tpu_torch.parallel.mesh import (  # noqa: F401
    Layout,
    broadcast_params,
    init_distributed,
    local_rows,
    resolve_layout,
)
