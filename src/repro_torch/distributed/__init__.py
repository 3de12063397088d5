from repro_torch.distributed.context import (  # noqa: F401
    MeshContext,
    get_mesh_context,
    set_mesh_context,
    mesh_context,
    data_axes,
    model_axis,
)
